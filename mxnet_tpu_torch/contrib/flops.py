"""Analytic FLOP accounting for symbolic graphs (port of
``mxnet_tpu/contrib/flops.py``: pure shape inference, so its counts equal
the JAX package's exactly).

Counts the multiply-accumulate work of the compute-dominant ops
(Convolution, FullyConnected, Deconvolution, dot/batch_dot, RNN) from
the graph's inferred shapes, in the literature convention 1 MAC = 2
FLOPs.  This is *model* FLOPs — the numerator of MFU as defined in the
PaLM/scaling-book accounting — NOT a count of the arithmetic the
kernels execute (which also bills recomputation, backward-pass
elementwise work, etc.).

Training cost uses the standard 3x-forward rule: the backward pass
computes both an input-gradient and a weight-gradient contraction per
layer, each the size of the forward one.

Usage::

    fwd = model_flops(sym, data=(32, 3, 224, 224))
    train = 3 * fwd
"""
from __future__ import annotations

import json

__all__ = ["model_flops"]


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def model_flops(sym, **input_shapes):
    """Forward-pass FLOPs of ``sym`` at the given input shapes.

    Walks the graph with per-node output shapes from
    ``get_internals().infer_shape`` and sums 2*MACs for the matmul-class
    ops; elementwise/norm/pool ops are not billed (their FLOPs are noise
    next to the contractions and are excluded from standard MFU
    accounting).
    """
    internals = sym.get_internals()
    out_names = internals.list_outputs()
    arg_shapes, shapes, _ = internals.infer_shape_partial(**input_shapes)
    shape_of = dict(zip(out_names, shapes))

    graph = json.loads(sym.tojson())
    nodes = graph["nodes"]

    def node_out_shape(nid, k=0):
        name = nodes[nid]["name"]
        key = name + "_output" if name + "_output" in shape_of else name
        if k:
            key = "%s_output%d" % (name, k)
        return shape_of.get(key)

    def in_shape(node, k):
        src, src_k = node["inputs"][k][0], node["inputs"][k][1]
        src_node = nodes[src]
        if src_node["op"] == "null":
            return shape_of.get(src_node["name"])
        return node_out_shape(src, src_k)

    total = 0
    for nid, node in enumerate(nodes):
        op = node["op"]
        attrs = node.get("attrs", node.get("param", {})) or {}
        if op == "Convolution":
            out = node_out_shape(nid)
            data = in_shape(node, 0)
            wshape = in_shape(node, 1)
            if not (out and data and wshape):
                continue
            # MACs = out_positions * (Cin/groups * prod(kernel)) per
            # output channel; weight shape is exactly
            # (Cout, Cin/groups, *kernel) so prod(w)/Cout is the
            # per-output-pixel contraction length
            macs = _prod(out) * (_prod(wshape) // wshape[0])
            bias = 0 if attrs.get("no_bias", "False") in ("True", "1") \
                else _prod(out)
            total += 2 * macs + bias
        elif op == "Deconvolution":
            data = in_shape(node, 0)
            wshape = in_shape(node, 1)
            if not (data and wshape):
                continue
            # transpose conv: contraction happens at every INPUT position
            macs = _prod(data) // data[1] * _prod(wshape)
            total += 2 * macs
        elif op == "FullyConnected":
            data = in_shape(node, 0)
            wshape = in_shape(node, 1)
            if not (data and wshape):
                continue
            rows = _prod(data) // data[-1]
            macs = rows * _prod(wshape)
            bias = 0 if attrs.get("no_bias", "False") in ("True", "1") \
                else rows * wshape[0]
            total += 2 * macs + bias
        elif op in ("dot", "batch_dot"):
            a = in_shape(node, 0)
            out = node_out_shape(nid)
            if not (a and out):
                continue
            ta = attrs.get("transpose_a", "False") in ("True", "1")
            contraction = a[-2] if ta else a[-1]
            total += 2 * _prod(out) * int(contraction)
        elif op == "RNN":
            # fused RNN: every weight matrix is applied once per
            # (timestep, batch element), so MACs ~= T * N * n_params
            data = in_shape(node, 0)   # (T, N, I)
            w = in_shape(node, 1)      # flat parameter vector
            if not (data and w):
                continue
            total += 2 * data[0] * data[1] * _prod(w)
    return int(total)
