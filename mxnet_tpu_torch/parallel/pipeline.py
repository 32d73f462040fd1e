"""Pipeline parallelism over the ``pp`` axis of a mesh inside one process
(port of ``mxnet_tpu/parallel/pipeline.py``).

S homogeneous stages hold their parameters stacked on a leading axis
sharded over ``pp`` (:func:`stack_stage_params`); every position runs the
same schedule (``compat.shard_map``), processes one microbatch a tick and
passes its activation to the next stage with ``collectives.ppermute``.  A
batch of M microbatches drains in M + S - 1 ticks, the pipeline bubble;
the last stage's outputs are replicated to every position by a psum, as
in the JAX package.  The schedule is differentiable: each tick's
ppermute is one autograd node over every stage, whose backward sends the
gradients the other way round the ring.

A tick whose stage holds no microbatch yet (or any more) skips its
``fn`` call: the JAX scan computes it and throws it away.
"""
from __future__ import annotations

import torch

from . import collectives as C

__all__ = ["pipeline_apply", "stack_stage_params"]


def stack_stage_params(per_stage_params):
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    axis (shard it with ``P('pp', ...)``; :func:`pipeline_apply` does)."""
    return C.tree_map(lambda *leaves: torch.stack(
        [torch.as_tensor(leaf) for leaf in leaves]), *per_stage_params)


def pipeline_apply(fn, stage_params, x, mesh, axis_name="pp",
                   n_microbatch=None):
    """Run ``x`` through S pipelined stages of ``fn``.

    fn(params_of_one_stage, act) -> act         (shape-preserving)
    stage_params: tree, leaves (S, ...) (or ``Sharded`` by ``P('pp')``)
    x: (B, ...) replicated batch; B must divide by n_microbatch
    returns: (B, ...) result of stage S-1 o ... o stage 0
    """
    from .compat import shard_map

    n_stages = mesh.shape[axis_name]
    leaves = []
    C.tree_map(leaves.append, stage_params)
    n_given = leaves[0].shape[0]
    if n_given != n_stages:
        raise ValueError(
            "stage_params stack %d stages but mesh axis %r has %d devices "
            "(one stage per device; for more layers than devices, fold "
            "several layers into one stage fn)"
            % (n_given, axis_name, n_stages))
    M = n_microbatch or n_stages
    B = x.shape[0]
    if B % M != 0:
        raise ValueError(
            "n_microbatch %d must divide the batch %d" % (M, B))
    mb = B // M
    x = torch.as_tensor(x)
    micro = x.reshape((M, mb) + tuple(x.shape[1:]))
    param_specs = C.tree_map(
        lambda leaf: C.P(axis_name, *([None] * (len(leaf.shape) - 1))),
        stage_params)
    fwd_perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def local_fn(params, micro_local):
        # params leaves: (1, ...) -- this position's stage
        params = C.tree_map(lambda leaf: leaf[0], params)
        idx = C.axis_index(axis_name)
        state = torch.zeros_like(micro_local[0])
        outs = []
        for t in range(M + n_stages - 1):
            # stage idx holds microbatch t - idx at tick t
            live = 0 <= t - idx < M
            x_in = micro_local[t] if idx == 0 and live else state
            y = fn(params, x_in) if live else torch.zeros_like(state)
            if idx == n_stages - 1 and live:
                outs.append(y)
            state = C.ppermute(y, axis_name, fwd_perm)
        out = torch.stack(outs) if outs else torch.zeros_like(micro_local)
        # replicate the last stage's collected outputs to every position
        return C.psum(out, axis_name)

    out = shard_map(local_fn, mesh, (param_specs, C.P()), C.P())(
        stage_params, micro)
    return out.reshape((B,) + tuple(x.shape[1:]))
