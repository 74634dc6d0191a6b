"""ONNX interchange for mxtpu_torch, the port of ``mxtpu.contrib.onnx``:
export Symbol/HybridBlock graphs to ONNX and import ONNX models back.

The ONNX IR schema ships with the package (``onnx.proto``, the
reference's, and ``onnx_pb2.py`` generated from it) over the protobuf
runtime; the ``onnx`` pip package is not needed. The converter tables
are the reference's, so both packages write the same bytes for one
graph and its parameters, and each imports the other's files.

Public surface (mirrors the reference):
- ``export_model(sym, params, input_shapes, onnx_file)`` → path
- ``import_model(model_file, ctx=None)`` → (sym, arg_params, aux_params)
- ``import_to_gluon(model_file, ctx=None)`` → SymbolBlock
- ``get_model_metadata(model_file)`` → input/output shapes

``ctx`` None means the innermost ``with ctx:`` scope, else the card.
"""
from __future__ import annotations

from typing import Any, Dict

from . import onnx_pb2
from ._export import export_graph, make_tensor, tensor_to_np
from ._import import import_graph

__all__ = ["export_model", "import_model", "import_to_gluon",
           "get_model_metadata", "onnx_pb2"]


def _normalize_shapes(sym, params, input_shapes):
    """Accept dict or positional list of shapes for the graph inputs."""
    if input_shapes is None:
        return None
    if isinstance(input_shapes, dict):
        return {k: tuple(v) for k, v in input_shapes.items()}
    inputs = [n for n in sym.list_inputs() if n not in params]
    if len(inputs) != len(input_shapes):
        raise ValueError(
            f"{len(input_shapes)} shapes for {len(inputs)} inputs {inputs}")
    return dict(zip(inputs, (tuple(s) for s in input_shapes)))


def _trace_block(block, input_shapes):
    """A HybridBlock's graph through the port's Symbol trace, and its
    parameters by var name."""
    import inspect

    from ... import symbol as sym_mod
    n_in = len(input_shapes) if input_shapes is not None and \
        not isinstance(input_shapes, dict) else 1
    names = ["data"] if n_in == 1 else [f"data{i}" for i in range(n_in)]
    if isinstance(input_shapes, dict):
        names = list(input_shapes)
    try:
        out = block._trace_symbol(*[sym_mod.var(n) for n in names])
    except TypeError as e:
        # only a GENUINE arity mismatch (forward takes another input
        # count than guessed) becomes the input_shapes error, judged
        # from the hybrid_forward signature; a TypeError from inside
        # the model body propagates untouched
        try:
            sig = inspect.signature(type(block).hybrid_forward)
            data_args = [
                p.name for p in list(sig.parameters.values())[2:]
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty
                and p.name not in block._reg_params]
        except (TypeError, ValueError):
            data_args = None
        if data_args is None or len(data_args) == len(names):
            raise
        raise ValueError(
            f"export_model: {type(block).__name__}.hybrid_forward "
            f"takes {len(data_args)} data input(s) {data_args} but "
            f"{len(names)} were guessed ({names}); pass "
            f"input_shapes as a dict {{name: shape}} or a list "
            f"with one shape per forward input") from e
    if isinstance(out, (list, tuple)):
        out = sym_mod.Group(list(out))
    aux_names = set(out.list_auxiliary_states())
    params = {p.name: p.data() for p in block.collect_params().values()
              if p.name in aux_names or p.name in out.list_arguments()}
    return out, params


def export_model(sym, params=None, input_shapes=None,
                 onnx_file: str = "model.onnx", opset: int = 13,
                 verbose: bool = False) -> str:
    """Export to ONNX (reference ``onnx_mxnet.export_model``).

    ``sym`` is a Symbol (with ``params`` mapping var name → NDArray) or
    an initialized HybridBlock (traced here through the Symbol trace;
    ``params`` ignored). ``input_shapes``: dict name → shape, or list in
    input order. Parameters on the card are read back to the host.
    """
    from ...gluon.block import HybridBlock

    if isinstance(sym, HybridBlock):
        sym, params = _trace_block(sym, input_shapes)
    params = params or {}
    shapes = _normalize_shapes(sym, params, input_shapes)
    model = export_graph(sym, params, input_shapes=shapes, opset=opset)
    with open(onnx_file, "wb") as f:
        f.write(model.SerializeToString())
    if verbose:
        print(f"exported {len(model.graph.node)} nodes / "
              f"{len(model.graph.initializer)} initializers → {onnx_file}")
    return onnx_file


def _read(model_file: str):
    model = onnx_pb2.ModelProto()
    with open(model_file, "rb") as f:
        model.ParseFromString(f.read())
    return model


def import_model(model_file: str, ctx=None):
    """ONNX file → (sym, arg_params, aux_params) (reference
    ``onnx_mxnet.import_model``), the params on ``ctx``."""
    sym, arg_params, aux_params, _ = import_graph(_read(model_file), ctx)
    return sym, arg_params, aux_params


def import_to_gluon(model_file: str, ctx=None):
    """ONNX file → runnable Gluon ``SymbolBlock`` (reference
    ``onnx_mxnet.import_to_gluon``) with its parameters on ``ctx``."""
    from ... import symbol as sym_mod
    from ...context import resolve_device
    from ...gluon.block import SymbolBlock

    dev = resolve_device(ctx)
    sym, arg_params, aux_params, input_names = import_graph(
        _read(model_file), dev)
    params = dict(arg_params)
    params.update(aux_params)
    return SymbolBlock(sym, [sym_mod.var(n) for n in input_names],
                       params=params, ctx=dev)


def get_model_metadata(model_file: str) -> Dict[str, Any]:
    """Input/output names and shapes of an ONNX file (reference
    ``onnx_mxnet.get_model_metadata``)."""
    g = _read(model_file).graph
    inits = {t.name for t in g.initializer}

    def vi_shape(vi):
        tt = vi.type.tensor_type
        return tuple(d.dim_value if d.WhichOneof("value") == "dim_value"
                     else d.dim_param for d in tt.shape.dim)

    return {
        "input_tensor_data": [(vi.name, vi_shape(vi)) for vi in g.input
                              if vi.name not in inits],
        "output_tensor_data": [(vi.name, vi_shape(vi)) for vi in g.output],
    }
