"""Symbol — the port of ``mxtpu/symbol/symbol.py`` (reference
``python/mxnet/symbol/symbol.py`` over NNVM's graph IR).

The user surface is the reference's: ``var``/op composition,
``infer_shape``/``infer_type``, ``tojson``/``load_json`` (the JSON is
``mxtpu``'s, byte for byte, for the same graph), ``bind``/
``simple_bind`` and the :class:`Executor`. A Symbol is a list of output
entries ``(node, out_idx)`` over a DAG of ``_Node``s; each node names an
op of :data:`mxtpu_torch.ndarray.ops.OP_REGISTRY`, the ops ``mx.nd``
runs, so both frontends share one op library.

Where the port differs from the reference, deliberately:

- Shape and type inference run each op on ``torch.device("meta")``
  tensors, which carry a shape and a dtype and no data (the reference
  abstract-evaluates with ``jax.eval_shape``); an op that cannot run
  there raises ``MXNetError`` naming it. ``infer_type`` gives
  ``torch.dtype``s, as the port's NDArrays carry.
- The Executor runs the graph eagerly. A training forward whose
  arguments need gradients builds torch's autograd graph, and
  ``backward`` is one ``torch.autograd.grad`` over it (kept, so a second
  ``backward`` works); a ``backward`` after a predict-mode forward
  replays that forward with its key, as the reference's VJP replays
  it. A predict-mode forward on the card is one CUDA graph per input
  signature. Every forward draws one key from the ``mx.random`` chain
  and pushes it for the graph's random ops, so a replay draws the same
  Dropout masks.
- ``bind``/``simple_bind``/``eval`` take ``ctx`` as a ``torch.device``
  (None: the card; ``eval`` without ``ctx`` runs where its arrays are).
- ``validate`` (the mxlint graph pass) waits for ``contrib.analysis``,
  ROADMAP Queue A item 10.4(d), and raises.
"""
from __future__ import annotations

import ast
import inspect
import json
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import autograd
from .. import engine as _engine
from ..base import MXNetError, dtype_name, dtype_torch
from ..context import resolve_device
from ..cuda_graphs import capture_graph, graphs_on
from ..ndarray import NDArray
from ..ndarray import ops as _ops
from ..ndarray import random as _random

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "Executor"]

ANALYSIS_SLICE = ("Symbol.validate (the mxlint graph pass) comes with "
                  "contrib.analysis, ROADMAP Queue A item 10.4(d)")

_META = torch.device("meta")


# ---------------------------------------------------------------------------
# op metadata: which call args are array inputs (in order), which are aux
# ---------------------------------------------------------------------------
_OP_ARRAY_ARGS: Dict[str, Tuple[str, ...]] = {
    "FullyConnected": ("data", "weight", "bias"),
    "Convolution": ("data", "weight", "bias"),
    "Deconvolution": ("data", "weight", "bias"),
    "BatchNorm": ("data", "gamma", "beta", "moving_mean", "moving_var"),
    "LayerNorm": ("data", "gamma", "beta"),
    "InstanceNorm": ("data", "gamma", "beta"),
    "GroupNorm": ("data", "gamma", "beta"),
    "Embedding": ("data", "weight"),
    "LeakyReLU": ("data", "gamma"),
    "RNN": ("data", "parameters", "state", "state_cell"),
    "SoftmaxOutput": ("data", "label"),
    "softmax_cross_entropy": ("data", "label"),
    "where": ("condition", "x", "y"),
    "ctc_loss": ("data", "label", "data_lengths", "label_lengths"),
}
for _alias, _canon in [("fully_connected", "FullyConnected"),
                       ("convolution", "Convolution"),
                       ("deconvolution", "Deconvolution"),
                       ("batch_norm", "BatchNorm"),
                       ("layer_norm", "LayerNorm"),
                       ("embedding", "Embedding")]:
    _OP_ARRAY_ARGS[_alias] = _OP_ARRAY_ARGS[_canon]

_OP_AUX_ARGS = {"BatchNorm": ("moving_mean", "moving_var"),
                "batch_norm": ("moving_mean", "moving_var")}

# ops whose trailing optional array args are skipped under these attrs
_VARIADIC_OPS = {"concat", "Concat", "add_n", "ElementWiseSum", "stack"}


def _num_outputs(op: str, attrs: Dict[str, Any]) -> int:
    if op in ("split", "SliceChannel"):
        return int(attrs.get("num_outputs", 1))
    if op == "topk" and attrs.get("ret_typ") == "both":
        return 2
    if op == "RNN" and attrs.get("state_outputs"):
        return 3 if attrs.get("mode", "lstm") == "lstm" else 2
    return 1


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs")

    def __init__(self, op: str, name: str, attrs: Dict[str, Any],
                 inputs: List[Tuple["_Node", int]]):
        self.op = op
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self.num_outputs = _num_outputs(op, attrs) if op != "null" else 1

    def is_var(self) -> bool:
        return self.op == "null"

    def is_aux(self) -> bool:
        return self.op == "null" and (
            self.attrs.get("__aux__") or
            self.name.endswith(("moving_mean", "moving_var",
                                "running_mean", "running_var")))


# one counter per op hint for the process, as the reference's: the same
# graph built in the same order gets the same names in both packages
_NAME_COUNTER: Dict[str, int] = {}


def _auto_name(op: str) -> str:
    hint = op.lower().lstrip("_")
    n = _NAME_COUNTER.get(hint, 0)
    _NAME_COUNTER[hint] = n + 1
    return f"{hint}{n}"


def _meta(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype_torch(dtype), device=_META)


# ---------------------------------------------------------------------------
# Symbol
# ---------------------------------------------------------------------------
class Symbol:
    """A (possibly multi-output) handle into the symbolic graph."""

    def __init__(self, entries: List[Tuple[_Node, int]]):
        self._entries = entries

    # -- construction helpers -----------------------------------------------
    @property
    def name(self) -> str:
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return "group"

    def __repr__(self):
        outs = ", ".join(f"{n.name}[{i}]" if n.num_outputs and
                         n.num_outputs > 1 else n.name
                         for n, i in self._entries)
        return f"<Symbol {outs}>"

    def __getitem__(self, index):
        if isinstance(index, str):
            for n, i in self._entries:
                if n.name == index:
                    return Symbol([(n, i)])
            raise ValueError(f"no output named {index!r}")
        # entries hold the symbol's outputs explicitly (a multi-output
        # op's symbol carries one entry per output): plain selection
        if isinstance(index, slice):
            return Symbol(self._entries[index])
        return Symbol([self._entries[index]])

    def __len__(self):
        return len(self.list_outputs())

    def __iter__(self):
        n = len(self.list_outputs())
        return (self[i] for i in range(n))

    def attr(self, key: str):
        if len(self._entries) == 1:
            v = self._entries[0][0].attrs.get(key)
            return None if v is None else str(v)
        return None

    def list_attr(self) -> Dict[str, str]:
        if len(self._entries) == 1:
            return {k: str(v) for k, v in self._entries[0][0].attrs.items()}
        return {}

    def get_internals(self) -> "Symbol":
        """Every node's outputs (reference ``Symbol.get_internals``),
        selectable as ``internals['name_output']``."""
        entries = []
        for node in self._topo():
            for i in range(node.num_outputs or 1):
                entries.append((node, i))
        return _InternalsSymbol(entries)

    def get_children(self) -> Optional["Symbol"]:
        node, _ = self._entries[0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    # -- graph queries -------------------------------------------------------
    def _topo(self) -> List[_Node]:
        return _topo_order(self._entries)

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._topo() if n.is_var() and not n.is_aux()]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in self._topo() if n.is_aux()]

    def list_inputs(self) -> List[str]:
        return [n.name for n in self._topo() if n.is_var()]

    def list_outputs(self) -> List[str]:
        outs = []
        for node, i in self._entries:
            if node.num_outputs and node.num_outputs > 1:
                outs.append(f"{node.name}_output{i}")
            else:
                outs.append(node.name + "_output" if not node.is_var()
                            else node.name)
        return outs

    # -- composition: arithmetic --------------------------------------------
    def _binop(self, other, op, scalar_op, rev: bool = False):
        if isinstance(other, Symbol):
            a, b = (other, self) if rev else (self, other)
            return _make_op_symbol(op, [a, b], {})
        return _make_op_symbol(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, o): return self._binop(o, "broadcast_add", "_plus_scalar")
    def __radd__(self, o): return self.__add__(o)
    def __sub__(self, o): return self._binop(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binop(o, "broadcast_sub", "_rminus_scalar", rev=True)
    def __mul__(self, o): return self._binop(o, "broadcast_mul", "_mul_scalar")
    def __rmul__(self, o): return self.__mul__(o)
    def __truediv__(self, o): return self._binop(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binop(o, "broadcast_div", "_rdiv_scalar", rev=True)
    def __mod__(self, o): return self._binop(o, "broadcast_mod", "_mod_scalar")
    def __pow__(self, o): return self._binop(o, "broadcast_power", "_power_scalar")
    def __rpow__(self, o): return self._binop(o, "broadcast_power", "_rpower_scalar", rev=True)
    def __neg__(self): return _make_op_symbol("negative", [self], {})

    def __eq__(self, o): return self._binop(o, "broadcast_equal", "_equal_scalar")
    def __ne__(self, o): return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")
    def __gt__(self, o): return self._binop(o, "broadcast_greater", "_greater_scalar")
    def __ge__(self, o): return self._binop(o, "broadcast_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._binop(o, "broadcast_lesser", "_lesser_scalar")
    def __le__(self, o): return self._binop(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    __hash__ = object.__hash__

    # -- composition: common methods (mirror NDArray) ------------------------
    def reshape(self, shape, **kw):
        return _make_op_symbol("reshape", [self], {"shape": tuple(shape)})

    def transpose(self, axes=None):
        return _make_op_symbol("transpose", [self],
                               {} if axes is None else {"axes": tuple(axes)})

    def flatten(self):
        return _make_op_symbol("Flatten", [self], {})

    def _reduce(self, op, axis, keepdims):
        return _make_op_symbol(op, [self], {"axis": axis,
                                            "keepdims": keepdims})

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def astype(self, dtype):
        return _make_op_symbol("cast", [self], {"dtype": dtype_name(dtype)})

    def slice_axis(self, axis, begin, end):
        return _make_op_symbol("slice_axis", [self],
                               {"axis": axis, "begin": begin, "end": end})

    def expand_dims(self, axis):
        return _make_op_symbol("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _make_op_symbol("squeeze", [self], {"axis": axis})

    def softmax(self, axis=-1):
        return _make_op_symbol("softmax", [self], {"axis": axis})

    def relu(self):
        return _make_op_symbol("relu", [self], {})

    def sigmoid(self):
        return _make_op_symbol("sigmoid", [self], {})

    def tanh(self):
        return _make_op_symbol("tanh", [self], {})

    def exp(self):
        return _make_op_symbol("exp", [self], {})

    def log(self):
        return _make_op_symbol("log", [self], {})

    def sqrt(self):
        return _make_op_symbol("sqrt", [self], {})

    def abs(self):
        return _make_op_symbol("abs", [self], {})

    def dot(self, other):
        return _make_op_symbol("dot", [self, other], {})

    def __getattr__(self, name):
        # any registered op becomes a method: sym.broadcast_like(...), etc.
        if not name.startswith("_") and name in _ops.OP_REGISTRY:
            def method(*args, **kwargs):
                from .. import symbol as _sym_mod
                return getattr(_sym_mod, name)(self, *args, **kwargs)
            return method
        raise AttributeError(f"Symbol has no attribute {name!r}")

    # -- shape/type inference ------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """Returns (arg_shapes, out_shapes, aux_shapes) in declaration
        order: each parameter's shape from its op's rule, then each node
        run on meta tensors; no kernel runs."""
        structs = self._infer_structs(*args, **kwargs)
        if structs is None:
            return None, None, None
        entry_structs, var_structs = structs
        arg_shapes = [tuple(var_structs[n].shape)
                      for n in self.list_arguments()]
        aux_shapes = [tuple(var_structs[n].shape)
                      for n in self.list_auxiliary_states()]
        out_shapes = [tuple(entry_structs[(id(n), i)].shape)
                      for n, i in self._entries]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        structs = self._infer_structs(**{k: _meta((1,), v)
                                         for k, v in kwargs.items()}) \
            if all(not isinstance(v, (tuple, list)) for v in kwargs.values()) \
            else self._infer_structs(*args, **kwargs)
        if structs is None:
            return None, None, None
        entry_structs, var_structs = structs
        arg_types = [var_structs[n].dtype for n in self.list_arguments()]
        aux_types = [var_structs[n].dtype
                     for n in self.list_auxiliary_states()]
        out_types = [entry_structs[(id(n), i)].dtype
                     for n, i in self._entries]
        return arg_types, out_types, aux_types

    def _infer_structs(self, *args, **kwargs):
        """Abstract-evaluate the graph. kwargs: name → shape tuple (dtype
        float32), or name → a tensor whose shape and dtype count (a meta
        tensor). Positional args match list_arguments order."""
        if args:
            for name, a in zip(self.list_arguments(), args):
                if a is not None:
                    kwargs.setdefault(name, a)
        var_structs: Dict[str, torch.Tensor] = {}
        for name, spec in kwargs.items():
            if isinstance(spec, torch.Tensor):
                var_structs[name] = _meta(spec.shape, spec.dtype)
            else:
                var_structs[name] = _meta(spec, torch.float32)
        return self._infer_structs_impl(var_structs)

    def _infer_structs_impl(self, var_structs, on_error=None):
        """The single inference walker. With ``on_error`` set, a failure
        is reported as ``on_error(node, in_structs, exc,
        missing_var_name)`` (``exc`` None means the var named
        ``missing`` has no shape) and the walk returns None instead of
        raising."""
        entry_structs: Dict[Tuple[int, int], torch.Tensor] = {}

        def var_struct(node: _Node):
            # a var's shape may only become known once a consuming op's
            # param rule runs (_resolve_param_shapes) — resolve lazily
            if node.name not in var_structs:
                shp = node.attrs.get("__shape__")
                if shp is None:
                    return None  # underdetermined
                var_structs[node.name] = _meta(
                    shp, node.attrs.get("__dtype__", "float32"))
            st = var_structs[node.name]
            entry_structs[(id(node), 0)] = st
            return st

        for node in self._topo():
            if node.is_var():
                continue
            _resolve_param_shapes(node, var_structs, entry_structs)
            in_structs = []
            for p, i in node.inputs:
                st = entry_structs.get((id(p), i))
                if st is None and p.is_var():
                    st = var_struct(p)
                if st is None:
                    if on_error is not None:
                        on_error(node, in_structs, None, p.name)
                    return None  # underdetermined
                in_structs.append(st)
            try:
                outs = _abstract_eval_node(node, in_structs)
            except MXNetError as e:
                if on_error is None:
                    raise
                on_error(node, in_structs, e, None)
                return None
            for i, o in enumerate(outs):
                entry_structs[(id(node), i)] = o
            if node.num_outputs is None:
                node.num_outputs = len(outs)
        # entries that are bare vars (identity outputs)
        for node, _ in self._entries:
            if node.is_var() and var_struct(node) is None:
                if on_error is not None:
                    on_error(node, [], None, node.name)
                return None
        return entry_structs, var_structs

    def validate(self, params=None, **input_shapes):
        raise NotImplementedError(ANALYSIS_SLICE)

    # -- serialization -------------------------------------------------------
    def tojson(self) -> str:
        nodes = self._topo()
        index = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": n.op,
                "name": n.name,
                "attrs": {k: _attr_str(v) for k, v in n.attrs.items()},
                "inputs": [[index[id(p)], i, 0] for p, i in n.inputs],
            })
        graph = {
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_var()],
            "heads": [[index[id(n)], i, 0] for n, i in self._entries],
            "attrs": {"mxnet_version": ["int", 10900],
                      "mxtpu": ["int", 1]},
        }
        return json.dumps(graph, indent=2)

    def save(self, fname: str) -> None:
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- evaluation ----------------------------------------------------------
    def eval(self, ctx=None, **kwargs) -> List[NDArray]:
        """Bind and run forward in predict mode (reference
        ``Symbol.eval``); without ``ctx``, on the device of the given
        arrays."""
        if ctx is None and kwargs:
            ctx = next(iter(kwargs.values())).context
        ex = self.bind(ctx, kwargs)
        return ex.forward(is_train=False)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, **kwargs) -> "Executor":
        if isinstance(args, (list, tuple)):
            args = dict(zip(self.list_arguments(), args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(self.list_arguments(), args_grad))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.list_auxiliary_states(), aux_states))
        return Executor(self, ctx, args, args_grad, grad_req,
                        aux_states or {})

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **shapes) -> "Executor":
        """Allocate argument, gradient and aux arrays from the inferred
        shapes on ``ctx`` (None: the card) and bind (reference
        ``Symbol.simple_bind``)."""
        dev = resolve_device(ctx)
        structs = self._infer_structs(**shapes)
        if structs is None:
            raise MXNetError(
                f"simple_bind: cannot infer all shapes from {shapes}")
        _, var_structs = structs
        type_dict = type_dict or {}

        def zeros(st, dtype):
            return NDArray(torch.zeros(st.shape, dtype=dtype, device=dev))
        args = {name: zeros(var_structs[name], dtype_torch(
            type_dict.get(name, var_structs[name].dtype)))
            for name in self.list_arguments()}
        aux = {name: zeros(var_structs[name], var_structs[name].dtype)
               for name in self.list_auxiliary_states()}
        args_grad = None
        if grad_req != "null":
            args_grad = {n: NDArray(torch.zeros_like(v._data))
                         for n, v in args.items()}
        return Executor(self, dev, args, args_grad, grad_req, aux)


class _InternalsSymbol(Symbol):
    """get_internals() result: indexable by 'name_output' / 'name'."""

    def __getitem__(self, index):
        if isinstance(index, str):
            want = index[:-7] if index.endswith("_output") else index
            for n, i in self._entries:
                if n.name == want:
                    return Symbol([(n, i)])
            raise ValueError(f"no internal output {index!r}")
        return Symbol([self._entries[index]])


def _topo_order(entries) -> List[_Node]:
    order: List[_Node] = []
    seen = set()

    def visit(node: _Node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for parent, _ in node.inputs:
            visit(parent)
        order.append(node)

    for node, _ in entries:
        visit(node)
    return order


# ---------------------------------------------------------------------------
# node construction
# ---------------------------------------------------------------------------
def _attr_str(v) -> str:
    return json.dumps(v) if not isinstance(v, str) else v


def _parse_attr(s: str):
    if not isinstance(s, str):
        return s
    try:
        return json.loads(s)
    except (ValueError, TypeError):
        try:
            return ast.literal_eval(s)
        except (ValueError, SyntaxError):
            return s


def var(name: str, attr=None, shape=None, dtype=None, lr_mult=None,
        wd_mult=None, init=None, stype=None, aux=False, **kwargs) -> Symbol:
    """Create a symbolic variable (reference ``mx.sym.var``)."""
    attrs: Dict[str, Any] = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if init is not None:
        attrs["__init__"] = str(init)
    if aux:
        attrs["__aux__"] = True
    node = _Node("null", name, attrs, [])
    return Symbol([(node, 0)])


Variable = var


def Group(symbols: Sequence[Symbol]) -> Symbol:
    entries: List[Tuple[_Node, int]] = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def _make_op_symbol(op: str, inputs: Sequence[Symbol],
                    attrs: Dict[str, Any], name: Optional[str] = None) -> Symbol:
    if op not in _ops.OP_REGISTRY:
        raise MXNetError(f"unknown op {op!r} in symbolic graph")
    attrs = {k: v for k, v in attrs.items() if v is not None}
    name = name or _auto_name(op)
    entries = []
    for s in inputs:
        if not isinstance(s, Symbol):
            raise TypeError(f"op {op}: inputs must be Symbols, got {type(s)}")
        if len(s._entries) != 1:
            raise MXNetError(f"op {op}: cannot take a grouped symbol input")
        entries.append(s._entries[0])
    node = _Node(op, name, attrs, entries)
    if node.num_outputs and node.num_outputs > 1:
        return Symbol([(node, i) for i in range(node.num_outputs)])
    return Symbol([(node, 0)])


def make_symbol_function(op_name: str):
    """Build the ``mx.sym.<op>`` composer for a registered op."""
    array_args = _OP_ARRAY_ARGS.get(op_name)
    aux_args = set(_OP_AUX_ARGS.get(op_name, ()))

    def sym_fn(*args, name: Optional[str] = None, attr=None, **kwargs):
        inputs: List[Symbol] = []
        attrs: Dict[str, Any] = dict(attr or {})
        # variadic ops: all positional Symbols are inputs
        if op_name in _VARIADIC_OPS:
            flat = args[0] if len(args) == 1 and \
                isinstance(args[0], (list, tuple)) else args
            inputs = list(flat)
            attrs.update({k: v for k, v in kwargs.items()
                          if not isinstance(v, Symbol)})
            return _make_op_symbol(op_name, inputs, attrs, name)
        if array_args:
            name = name or _auto_name(op_name)
            no_bias = bool(kwargs.get("no_bias", False))
            supplied = dict(zip(array_args, args))
            for k in list(kwargs):
                if isinstance(kwargs[k], Symbol):
                    supplied[k] = kwargs.pop(k)
            attrs.update(kwargs)
            for pname in array_args:
                if pname == "bias" and no_bias:
                    continue
                if pname in supplied and supplied[pname] is not None:
                    inputs.append(supplied[pname])
                elif pname == "data":
                    raise MXNetError(f"{op_name}: 'data' input required")
                elif op_name == "LeakyReLU" and pname == "gamma" and \
                        attrs.get("act_type", "leaky") != "prelu":
                    continue
                elif op_name == "ctc_loss" and pname in (
                        "data_lengths", "label_lengths"):
                    continue
                elif op_name == "RNN" and pname == "state_cell" and \
                        attrs.get("mode") != "lstm":
                    continue
                else:
                    # the parameter variable the reference's NNVM makes:
                    # sym.FullyConnected(data, num_hidden=k) creates
                    # fc_weight/fc_bias
                    inputs.append(var(f"{name}_{pname}",
                                      aux=pname in aux_args))
            return _make_op_symbol(op_name, inputs, attrs, name)
        # generic op: positional Symbols are inputs, everything else attrs
        rest = []
        for a in args:
            if isinstance(a, Symbol):
                inputs.append(a)
            else:
                rest.append(a)
        if rest:
            # positional non-symbol args keep their declared order after
            # the arrays (sym.reshape(x, shape)): map by op signature
            fn = _ops.OP_REGISTRY[op_name]
            try:
                sig = inspect.signature(fn)
                pnames = [p for p in sig.parameters
                          if p not in ("args", "kwargs")]
                extra = pnames[len(inputs):len(inputs) + len(rest)]
                for k, v in zip(extra, rest):
                    attrs[k] = v
            except (ValueError, TypeError):
                raise MXNetError(
                    f"{op_name}: cannot map positional args {rest}")
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                inputs.append(v)
            else:
                attrs[k] = v
        return _make_op_symbol(op_name, inputs, attrs, name)

    sym_fn.__name__ = op_name
    sym_fn.__qualname__ = f"sym.{op_name}"
    sym_fn.__doc__ = f"Symbolic version of mx.nd.{op_name}."
    return sym_fn


# ---------------------------------------------------------------------------
# JSON load
# ---------------------------------------------------------------------------
def load_json(json_str: str) -> Symbol:
    graph = json.loads(json_str)
    jnodes = graph["nodes"]
    nodes: List[_Node] = []
    for jn in jnodes:
        attrs = {k: _parse_attr(v)
                 for k, v in (jn.get("attrs") or jn.get("param") or {}).items()}
        inputs = [(nodes[i], oi) for i, oi, *_ in jn["inputs"]]
        nodes.append(_Node(jn["op"], jn["name"], attrs, inputs))
    heads = graph.get("heads") or [[len(nodes) - 1, 0, 0]]
    return Symbol([(nodes[i], oi) for i, oi, *_ in heads])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


# ---------------------------------------------------------------------------
# interpretation (shared by Executor / eval / abstract eval)
# ---------------------------------------------------------------------------
def _takes_ctx(fn) -> bool:
    try:
        return "ctx" in inspect.signature(fn).parameters
    except (ValueError, TypeError):
        return False


def _call_registry_op(node: _Node, in_nds: List[NDArray], ctx=None):
    """Run ``node``'s op on NDArrays. An op with no array input that
    makes its own (``full``, the ``zeros``/``ones`` of ``mx.sym``) makes
    it on ``ctx``."""
    fn = _ops.OP_REGISTRY[node.op]
    attrs = {k: v for k, v in node.attrs.items()
             if not k.startswith("__")}
    if not in_nds and ctx is not None and _takes_ctx(fn):
        attrs["ctx"] = ctx
    out = fn(*in_nds, **attrs)
    return out if isinstance(out, tuple) else (out,)


def _abstract_eval_node(node: _Node, in_structs):
    try:
        with autograd.pause(), torch.no_grad():
            outs = _call_registry_op(node, [NDArray(t) for t in in_structs],
                                     _META)
        return tuple(_meta(o.shape, o.dtype) for o in outs)
    except Exception as e:
        raise MXNetError(
            f"shape inference failed at op {node.op}({node.name}) with "
            f"input shapes {[tuple(s.shape) for s in in_structs]}: "
            f"{e}") from e


# forward param-shape rules: resolve unknown var shapes feeding an op from
# its data input shape + attrs (the reference's per-op FInferShape, as
# gluon's per-layer infer_shape rules give them)
def _resolve_param_shapes(node: _Node, var_structs, entry_structs) -> None:
    unresolved = [(idx, p) for idx, (p, _) in enumerate(node.inputs)
                  if p.is_var() and p.name not in var_structs and
                  "__shape__" not in p.attrs]
    if not unresolved:
        return
    op = node.op
    array_args = _OP_ARRAY_ARGS.get(op)
    if array_args is None:
        return
    d_entry = node.inputs[0]
    dstruct = entry_structs.get((id(d_entry[0]), d_entry[1]))
    if dstruct is None and d_entry[0].is_var():
        dstruct = var_structs.get(d_entry[0].name)
        if dstruct is None and "__shape__" in d_entry[0].attrs:
            dstruct = _meta(d_entry[0].attrs["__shape__"],
                            d_entry[0].attrs.get("__dtype__", "float32"))
    if dstruct is None:
        return
    dshape = tuple(dstruct.shape)
    a = node.attrs
    # which array arg does each input slot hold? (bias may be skipped)
    slot_names = []
    ai = 0
    for p, _ in node.inputs:
        if ai < len(array_args):
            nm = array_args[ai]
            if nm == "bias" and a.get("no_bias"):
                ai += 1
                nm = array_args[ai] if ai < len(array_args) else "?"
            slot_names.append(nm)
            ai += 1
        else:
            slot_names.append("?")
    shapes: Dict[str, Tuple[int, ...]] = {}
    if op in ("FullyConnected", "fully_connected"):
        nh = int(a["num_hidden"])
        in_units = 1
        for d in dshape[1:]:
            in_units *= int(d)
        if not a.get("flatten", True):
            in_units = dshape[-1]
        shapes = {"weight": (nh, in_units), "bias": (nh,)}
    elif op in ("Convolution", "convolution"):
        nf = int(a["num_filter"])
        kernel = tuple(a["kernel"])
        ng = int(a.get("num_group", 1))
        shapes = {"weight": (nf, dshape[1] // ng) + kernel, "bias": (nf,)}
    elif op in ("Deconvolution", "deconvolution"):
        nf = int(a["num_filter"])
        kernel = tuple(a["kernel"])
        ng = int(a.get("num_group", 1))
        shapes = {"weight": (dshape[1], nf // ng) + kernel, "bias": (nf,)}
    elif op in ("BatchNorm", "batch_norm", "InstanceNorm", "GroupNorm"):
        axis = int(a.get("axis", 1)) % len(dshape)
        c = dshape[axis]
        shapes = {k: (c,) for k in
                  ("gamma", "beta", "moving_mean", "moving_var")}
    elif op in ("LayerNorm", "layer_norm"):
        axis = int(a.get("axis", -1)) % len(dshape)
        c = dshape[axis]
        shapes = {"gamma": (c,), "beta": (c,)}
    elif op in ("Embedding", "embedding"):
        shapes = {"weight": (int(a["input_dim"]), int(a["output_dim"]))}
    elif op == "LeakyReLU":
        shapes = {"gamma": (dshape[1] if len(dshape) > 1 else dshape[0],)}
    for idx, p in unresolved:
        nm = slot_names[idx] if idx < len(slot_names) else "?"
        if nm in shapes:
            var_structs[p.name] = _meta(shapes[nm], dstruct.dtype)


def interpret_nd(entries: List[Tuple[_Node, int]],
                 values: Dict[str, NDArray], ctx=None):
    """Run the graph on NDArrays through the registry ops (under
    ``autograd.record`` this records as imperative calls do; on tensors
    that require grad it builds torch's graph).

    Returns (outputs, aux_updates): BatchNorm's running statistics (the
    reference's mutable aux states, updated by the op's forward in
    training mode) come back in ``aux_updates`` (name → NDArray) when
    ``autograd.is_training()``. ``ctx``: where an op with no array
    input makes its array."""
    computed: Dict[Tuple[int, int], NDArray] = {}
    aux_updates: Dict[str, NDArray] = {}
    is_train = autograd.is_training()
    for node in _topo_order(entries):
        if node.is_var():
            if node.name not in values:
                raise MXNetError(f"unbound argument {node.name!r}")
            computed[(id(node), 0)] = values[node.name]
            continue
        in_nds = [computed[(id(p), i)] for p, i in node.inputs]
        outs = _call_registry_op(node, in_nds, ctx)
        if node.num_outputs is None:
            node.num_outputs = len(outs)
        for i, o in enumerate(outs):
            computed[(id(node), i)] = o
        if is_train and node.op in ("BatchNorm", "batch_norm") and \
                not node.attrs.get("use_global_stats", False):
            _batchnorm_aux_update(node, in_nds, aux_updates)
    return [computed[(id(n), i)] for n, i in entries], aux_updates


def _batchnorm_aux_update(node: _Node, in_nds, aux_updates) -> None:
    with torch.no_grad():
        x = in_nds[0]._data.detach().float()
        momentum = float(node.attrs.get("momentum", 0.9))
        axis = int(node.attrs.get("axis", 1)) % x.ndim
        red = tuple(i for i in range(x.ndim) if i != axis)
        mean = x.mean(dim=red)
        var_ = ((x - mean.reshape([-1 if i == axis else 1
                                   for i in range(x.ndim)])) ** 2
                ).mean(dim=red)
        mm, mv = in_nds[3]._data, in_nds[4]._data
        aux_updates[node.inputs[3][0].name] = NDArray(
            momentum * mm + (1 - momentum) * mean.to(mm.dtype))
        aux_updates[node.inputs[4][0].name] = NDArray(
            momentum * mv + (1 - momentum) * var_.to(mv.dtype))


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------
class _Capture:
    """One CUDA graph of a predict-mode forward: static copies of every
    argument and aux state, the key, and the outputs. ``copied`` holds,
    for each argument, a weak reference to the tensor last copied in and
    that tensor's ``_version``: an argument unchanged since is not copied
    again, and a replaced one is not kept alive."""

    __slots__ = ("graph", "static", "copied", "key", "outs")


class Executor:
    """Bound computation (reference ``Executor`` over GraphExecutor).

    ``forward(is_train=True)`` runs the graph eagerly; where arguments
    need gradients it builds torch's autograd graph over detached
    copies of them, and ``backward`` differentiates that graph (kept,
    so a second ``backward`` gives the same grads). ``forward`` in
    predict mode on the card runs a signature (the shapes and dtypes of
    every argument and aux state) eagerly at its first call, captures
    it as one CUDA graph at its second and replays that graph after:
    each argument is copied into the graph's own buffer when its tensor
    was replaced or written since the last replay. A one-off ``eval``
    captures nothing. A capture that fails raises.
    """

    def __init__(self, symbol: Symbol, ctx, args: Dict[str, NDArray],
                 args_grad: Optional[Dict[str, NDArray]],
                 grad_req, aux_states: Dict[str, NDArray]):
        self._symbol = symbol
        self._ctx = resolve_device(ctx)
        self.arg_dict = dict(args)
        self.grad_dict = dict(args_grad or {})
        self.aux_dict = dict(aux_states)
        arg_names = symbol.list_arguments()
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in arg_names}
        else:
            self.grad_req = dict(grad_req)
        missing = [n for n in arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")
        for n in symbol.list_auxiliary_states():
            if n not in self.aux_dict:
                raise MXNetError(f"bind: missing auxiliary state {n!r}")
        self.outputs: List[NDArray] = []
        self.captures = 0             # CUDA graphs captured, ever
        self._captures: Dict[Any, _Capture] = {}
        self._seen: set = set()       # signatures run once, not captured
        self._last_train = False
        self._last_key = None
        self._tape = None             # (output tensors, {name: input})

    # -- forward -------------------------------------------------------------
    def _values(self) -> Dict[str, torch.Tensor]:
        values = {n: a._data for n, a in self.arg_dict.items()}
        values.update({n: a._data for n, a in self.aux_dict.items()})
        return values

    def _run(self, values, key, is_train):
        """The graph on tensors, with ``key`` pushed for its random ops:
        (output tensors, {aux name: tensor})."""
        _random.push_trace_key(key)
        try:
            with autograd.pause(train_mode=is_train):
                outs, aux_up = interpret_nd(
                    self._symbol._entries,
                    {n: NDArray(v) for n, v in values.items()}, self._ctx)
        finally:
            _random.pop_trace_key()
        return ([o._data for o in outs],
                {n: a._data for n, a in aux_up.items()})

    def _diff_names(self) -> List[str]:
        return [n for n in self._symbol.list_arguments()
                if self.grad_req.get(n, "null") != "null"]

    def _run_for_grad(self, key, is_train):
        """The graph on detached copies of the differentiated arguments
        that require grad: (outputs, aux, the tape)."""
        values = self._values()
        ins = {n: values[n].detach().requires_grad_()
               for n in self._diff_names()}
        values.update(ins)
        with torch.enable_grad():
            outs, aux_up = self._run(values, key, is_train)
        return outs, aux_up, (outs, ins)

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {k!r}")
            cur = self.arg_dict[k]._data
            new = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
            self.arg_dict[k]._set_data(new.to(cur.device))
        key = _random._next_key(self._ctx)
        self._tape = None
        if not is_train and graphs_on(self._ctx):
            outs, aux_up = self._replay(key), {}
            if _engine.is_debug_nans():
                values = self._values()

                def rerun():
                    with torch.no_grad():
                        self._run(values, key, False)
                _engine.check_program(f"executor[{self._symbol.name}]",
                                      outs, rerun)
        elif is_train and self._diff_names():
            outs, aux_up, self._tape = self._run_for_grad(key, True)
            outs = [o.detach() for o in outs]
        else:
            with torch.no_grad():
                outs, aux_up = self._run(self._values(), key, is_train)
        self._last_train = is_train
        self._last_key = key      # backward must replay the same masks
        for n, v in aux_up.items():
            self.aux_dict[n]._set_data(v)
        self.outputs = [NDArray(o) for o in outs]
        return self.outputs

    # -- the predict-mode CUDA graphs ---------------------------------------
    def _replay(self, key) -> List[torch.Tensor]:
        values = self._values()
        sig = tuple((n, tuple(v.shape), v.dtype) for n, v in values.items())
        cap = self._captures.get(sig)
        if cap is None:
            if sig not in self._seen:
                self._seen.add(sig)
                with torch.no_grad():
                    return self._run(values, key, False)[0]
            cap = self._capture(values, key)
            self._captures[sig] = cap
        for n, v in values.items():
            ref, version = cap.copied[n]
            if ref() is not v or version != v._version:
                cap.static[n].copy_(v)
                cap.copied[n] = (weakref.ref(v), v._version)
        cap.key.copy_(key)
        cap.graph.replay()
        return [o.clone() for o in cap.outs]

    def _capture(self, values, key) -> _Capture:
        cap = _Capture()
        cap.static = {n: v.clone() for n, v in values.items()}
        cap.copied = {n: (weakref.ref(v), v._version)
                      for n, v in values.items()}
        cap.key = key.clone()

        def run():
            return self._run(cap.static, cap.key, False)[0]

        def fn():
            cap.outs = run()

        with torch.no_grad():
            cap.graph = capture_graph(
                f"executor[{self._symbol.name}]", fn, run, self._ctx)
        self.captures += 1
        return cap

    # -- backward ------------------------------------------------------------
    def backward(self, out_grads=None) -> None:
        """Gradients of the outputs with respect to every argument whose
        grad_req is not 'null', written into grad_dict per grad_req
        (write | add)."""
        diff_names = self._diff_names()
        if not diff_names:
            return
        tape = self._tape
        if tape is None:
            # a predict-mode forward kept no graph: replay it with its key
            key = self._last_key if self._last_key is not None \
                else _random.current_key().to(self._ctx)
            _, _, tape = self._run_for_grad(key, self._last_train)
        outs, ins = tape
        if out_grads is None:
            ogs = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            ogs = [g._data if isinstance(g, NDArray) else torch.as_tensor(g)
                   for g in out_grads]
            ogs = [g.to(o.device, o.dtype) for g, o in zip(ogs, outs)]
        pairs = [(o, g) for o, g in zip(outs, ogs) if o.requires_grad]
        names = [n for n in diff_names if n in ins]
        grads = [None] * len(names)
        if pairs:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [ins[n] for n in names],
                [g for _, g in pairs], retain_graph=True, allow_unused=True)
        for n, g in zip(names, grads):
            if g is None:
                g = torch.zeros_like(ins[n])
            tgt = self.grad_dict.get(n)
            if tgt is None:
                tgt = NDArray(torch.zeros_like(g))
                self.grad_dict[n] = tgt
            if self.grad_req.get(n) == "add":
                tgt._set_data(tgt._data + g)
            else:
                tgt._set_data(g)

    # -- accessors ----------------------------------------------------------
    @property
    def arg_arrays(self) -> List[NDArray]:
        return [self.arg_dict[n] for n in self._symbol.list_arguments()]

    @property
    def grad_arrays(self) -> List[Optional[NDArray]]:
        return [self.grad_dict.get(n) for n in self._symbol.list_arguments()]

    @property
    def aux_arrays(self) -> List[NDArray]:
        return [self.aux_dict[n]
                for n in self._symbol.list_auxiliary_states()]

    def copy_params_from(self, arg_params: Dict[str, NDArray],
                         aux_params: Optional[Dict[str, NDArray]] = None,
                         allow_extra_params: bool = False) -> None:
        for src, dst, kind in ((arg_params, self.arg_dict, "parameter"),
                               (aux_params or {}, self.aux_dict,
                                "aux state")):
            for n, v in src.items():
                if n in dst:
                    cur = dst[n]._data
                    dst[n]._set_data(v._data.to(cur.device, cur.dtype))
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {kind} {n!r}")

    def reshape(self, **shapes) -> "Executor":
        def zeros(shape, a):
            return NDArray(torch.zeros(shape, dtype=a.dtype,
                                       device=self._ctx))
        args = {n: zeros(shapes.get(n, a.shape), a)
                for n, a in self.arg_dict.items()}
        grads = {n: zeros(args[n].shape, a)
                 for n, a in self.grad_dict.items()} or None
        return Executor(self._symbol, self._ctx, args, grads,
                        self.grad_req, dict(self.aux_dict))
