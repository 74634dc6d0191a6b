"""mx.viz — the port of ``mxtpu/visualization.py`` (reference
``python/mxnet/visualization.py``): the ``print_summary`` table and
``plot_network`` for Symbols. ``plot_network`` returns Graphviz DOT
source (the reference returned a ``graphviz.Digraph``; write the text
out and render it with Graphviz); ``print_summary`` needs nothing else.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["print_summary", "plot_network"]

# graph-role heuristic shared by both views: vars with these suffixes
# are parameters/statistics; everything else (data, labels) is an input
_PARAM_SUFFIXES = ("weight", "bias", "gamma", "beta", "moving_mean",
                   "moving_var", "running_mean", "running_var",
                   "_quantized", "mlm_bias")


def _is_param_var(name: str) -> bool:
    return name.endswith(_PARAM_SUFFIXES)


def print_summary(symbol, shape: Optional[Dict] = None,
                  line_length: int = 120, positions=(0.44, 0.64, 0.74, 1.0)):
    """Layer-by-layer summary with output shapes and parameter counts
    (reference ``mx.viz.print_summary``)."""
    entry_shapes = {}
    if shape is not None:
        structs = symbol._infer_structs(**shape)
        if structs is not None:
            entry_structs, var_structs = structs
            entry_shapes = {k: tuple(v.shape)
                            for k, v in entry_structs.items()}
            entry_shapes.update({("var", n): tuple(v.shape)
                                 for n, v in var_structs.items()})
    nodes = symbol._topo()
    if positions[-1] <= 1:        # fractional form (reference guard)
        positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(vals):
        line = ""
        for i, v in enumerate(vals):
            line += str(v)
            line = line[:positions[i] - 1]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(fields)
    print("=" * line_length)
    total = 0
    var_shape = {}
    for node in nodes:
        if node.is_var():
            var_shape[node.name] = entry_shapes.get(("var", node.name), ())
    import numpy as _np
    for node in nodes:
        if node.is_var():
            continue
        out_shape = entry_shapes.get((id(node), 0), "?")
        params = 0
        prevs = []
        for p, _ in node.inputs:
            prevs.append(p.name)
            if p.is_var() and _is_param_var(p.name) and \
                    p.name in var_shape:
                shp = var_shape[p.name]
                if shp:
                    params += int(_np.prod(shp))
        total += params
        print_row([f"{node.name} ({node.op})", out_shape, params,
                   ", ".join(prevs)])
    print("=" * line_length)
    print(f"Total params: {total}")
    print("_" * line_length)
    return total


_OP_COLORS = {
    "Convolution": "cadetblue1", "FullyConnected": "brown1",
    "BatchNorm": "darkseagreen1", "Activation": "salmon",
    "Pooling": "gold", "softmax": "plum", "SoftmaxOutput": "plum",
    "Concat": "lightsteelblue", "RNN": "orchid1",
}


def plot_network(symbol, title: str = "plot", shape: Optional[Dict] = None,
                 node_attrs=None, save_format: str = "dot",
                 hide_weights: bool = True):
    """Return Graphviz DOT source for the symbol graph (reference
    ``mx.viz.plot_network`` returned a graphviz.Digraph; without a
    graphviz runtime this emits the same DOT text)."""
    if save_format != "dot":
        import warnings
        warnings.warn(f"save_format={save_format!r} needs a graphviz "
                      "runtime (not installed); emitting DOT source")

    def q(s):   # DOT-quote (names/values may hold spaces or quotes)
        return '"' + str(s).replace('"', '\\"') + '"'

    base_attrs = {"shape": "box", "style": "filled", "fixedsize": "false"}
    base_attrs.update(node_attrs or {})
    attr_str = ", ".join(f"{k}={q(v)}" for k, v in base_attrs.items())
    lines = [f'digraph {q(title)} {{',
             f"  node [{attr_str}];"]
    nodes = symbol._topo()
    # optional edge shape labels (reference behavior with shape=...)
    edge_shapes = {}
    if shape is not None:
        structs = symbol._infer_structs(**shape)
        if structs is not None:
            entry_structs, var_structs = structs
            edge_shapes = {k: tuple(v.shape)
                           for k, v in entry_structs.items()}
            edge_shapes.update({("var", n): tuple(v.shape)
                                for n, v in var_structs.items()})

    def shown(var_node):
        return not hide_weights or not _is_param_var(var_node.name)

    for node in nodes:
        if node.is_var():
            if not shown(node):
                continue
            lines.append(
                f'  {q(node.name)} [label={q(node.name)}, '
                f'fillcolor=white];')
        else:
            color = _OP_COLORS.get(node.op, "azure")
            label = f"{node.name}\\n({node.op})"
            lines.append(
                f'  {q(node.name)} [label={q(label)}, '
                f'fillcolor={q(color)}];')
    for node in nodes:
        if node.is_var():
            continue
        for p, idx in node.inputs:
            if not p.is_var() or shown(p):
                eshape = edge_shapes.get(
                    ("var", p.name) if p.is_var() else (id(p), idx))
                lbl = f" [label={q(eshape)}]" if eshape else ""
                lines.append(
                    f'  {q(p.name)} -> {q(node.name)}{lbl};')
    lines.append("}")
    return "\n".join(lines)
