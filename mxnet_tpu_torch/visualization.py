"""Network visualization (port of ``mxnet_tpu/visualization.py``;
reference python/mxnet/visualization.py): ``print_summary`` table, the
same text as the JAX package's, and graphviz ``plot_network``
(``graphviz`` imported at call time)."""
from __future__ import annotations

from .base import MXNetError
from .symbol import Symbol

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Print a layer-by-layer summary with output shapes and param counts
    (reference visualization.py:print_summary)."""
    if not isinstance(symbol, Symbol):
        raise MXNetError("symbol must be a Symbol")
    if positions is None:
        positions = [0.44, 0.64, 0.74, 1.0]
    show_shape = shape is not None
    shape_dict = {}
    if show_shape:
        arg_shapes, _, _ = symbol.infer_shape(**shape)
        shape_dict = dict(zip(symbol.list_arguments(), arg_shapes))

    nodes = list(symbol._nodes())
    positions = [int(line_length * p) for p in positions]
    to_display = ["Layer (type)", "Output Shape", "Param #",
                  "Previous Layer"]

    def print_row(fields, positions):
        line = ""
        for field, pos in zip(fields, positions):
            line += str(field)
            line = line[:pos - 1]
            line += " " * (pos - len(line))
        print(line)

    print("_" * line_length)
    print_row(to_display, positions)
    print("=" * line_length)

    total_params = 0
    # per-node output shape via whole-graph inference
    out_shape_by_node = {}
    if show_shape:
        try:
            internals = symbol.get_internals()
            _, out_shapes, _ = internals.infer_shape(**shape)
            for (node, idx), s in zip(internals._outputs, out_shapes):
                out_shape_by_node.setdefault(id(node), {})[idx] = s
        except Exception:
            pass

    for node in nodes:
        if node.is_variable:
            continue
        name = node.name
        op_name = node.op.name if node.op is not None else "null"
        pre = [src.name for src, _ in node.inputs
               if not (src.is_variable and src.name.startswith(name))]
        cur_param = 0
        for src, _ in node.inputs:
            if src.is_variable and src.name in shape_dict and \
                    src.name != "data" and not src.name.endswith("label"):
                n = 1
                for d in shape_dict[src.name]:
                    n *= d
                cur_param += n
        out_s = ""
        if show_shape:
            s = out_shape_by_node.get(id(node), {}).get(0)
            if s is not None:
                out_s = "x".join(map(str, s))
        fields = ["%s(%s)" % (name, op_name), out_s, cur_param,
                  ",".join(pre[:3])]
        print_row(fields, positions)
        total_params += cur_param
    print("=" * line_length)
    print("Total params: {params}".format(params=total_params))
    print("_" * line_length)
    return total_params


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Build a graphviz digraph of the network (reference
    visualization.py:plot_network).  Requires the ``graphviz`` package."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise MXNetError("plot_network requires the graphviz python package")
    if not isinstance(symbol, Symbol):
        raise MXNetError("symbol must be a Symbol")
    node_attrs = node_attrs or {}
    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs)
    dot = Digraph(name=title, format=save_format)

    fill = {
        "FullyConnected": "#fb8072", "Convolution": "#fb8072",
        "Deconvolution": "#fb8072", "Activation": "#ffffb3",
        "LeakyReLU": "#ffffb3", "BatchNorm": "#bebada",
        "Pooling": "#80b1d3", "Concat": "#fdb462", "Flatten": "#fdb462",
        "Reshape": "#fdb462", "SoftmaxOutput": "#b3de69",
    }
    for node in symbol._nodes():
        name = node.name
        if node.is_variable:
            if hide_weights and name != "data" and \
                    not name.endswith("label"):
                continue
            dot.node(name, label=name, shape="oval", style="filled",
                     fillcolor="#8dd3c7")
            continue
        op_name = node.op.name
        label = op_name
        attrs = node.op_attrs()
        if op_name == "Convolution":
            label = "Convolution\n%s/%s, %s" % (
                attrs.get("kernel", "?"), attrs.get("stride", "1"),
                attrs.get("num_filter", "?"))
        elif op_name == "FullyConnected":
            label = "FullyConnected\n%s" % attrs.get("num_hidden", "?")
        elif op_name == "Activation":
            label = "Activation\n%s" % attrs.get("act_type", "?")
        elif op_name == "Pooling":
            label = "Pooling\n%s, %s/%s" % (
                attrs.get("pool_type", "?"), attrs.get("kernel", "?"),
                attrs.get("stride", "1"))
        dot.node(name, label=label,
                 fillcolor=fill.get(op_name, "#fccde5"), **node_attr)
        for src, _idx in node.inputs:
            if src.is_variable and hide_weights and \
                    src.name != "data" and not src.name.endswith("label"):
                continue
            dot.edge(src.name, name)
    return dot
