"""Gluon Block / HybridBlock — the port of ``mxtpu/gluon/block.py``
(reference ``python/mxnet/gluon/block.py``).

``hybridize()`` is the reference's CachedOp (``src/imperative/
cached_op.cc``). The first hybrid call runs eagerly (resolving deferred
shapes, like CachedOp's first-call shape passes); afterwards a call is
one function of tensors

    raw(inputs..., params..., rng_key) -> ((outputs...), (aux_updates...))

that binds the parameters to the tensors it is given, pushes the call's
key for the random ops inside (``push_trace_key``), and runs the
block's eager forward. Aux updates carry mutated non-differentiable
state (BatchNorm running stats) out of it and are written back after
the call, as the reference writes its aux outputs back. Each call
draws its key from the ``mx.random`` chain, as the reference's does.

How a call runs:

- **under ``record()``**: ``raw`` goes through the tape's funnel
  (``autograd.invoke``) as one node: the forward runs under
  ``enable_grad`` on detached inputs and parameters, and the node's
  pullback is one ``torch.autograd.grad`` over that graph.
- **in predict mode on the card**: one CUDA graph per input signature
  (the tree of inputs, their shapes and dtypes), captured at its first
  call (after a warm-up run) and replayed after that. The capture owns
  what it reads: inputs and the key are copied into its static buffers,
  and it holds the parameter tensors it was captured over. A parameter
  rebound since (``Trainer.step``, ``set_data``, a load: NDArray
  mutation rebinds, and bumps ``_version``) makes the next call
  recapture. A capture that fails raises; there is no eager fallback.
  Each capture runs inside ``watcher.build``.
- **otherwise** (training mode without recording, or on the CPU):
  ``raw`` runs plainly.

``shard(mesh, rules)`` takes a one-device mesh (``parallel.mesh``):
every parameter stays whole on that device (``hybridize(mesh=,
rules=)`` is sugar for it). A mesh across devices raises (ROADMAP
Queue A item 11).

``export`` traces the block with ``F = mx.sym`` (each child's
``hybrid_forward`` composes symbols, its parameters become variables)
and writes the reference's ``prefix-symbol.json`` and
``prefix-%04d.params``; :class:`SymbolBlock` runs such a graph as a
block. ``export_stablehlo`` (the reference's name) writes the
deployment artifact: a ``torch.export`` archive of the eager inference
forward with the weights baked in, which ``contrib.deploy.load`` runs
without the model's class.
"""
from __future__ import annotations

import contextlib
import re
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import autograd
from .. import engine as _engine
from .. import ndarray as nd
from ..base import MXNetError
from ..cuda_graphs import capture_graph, graphs_on
from ..ndarray import NDArray
from ..ndarray import random as _random
from ..ndarray.ndarray import _parents_of
from .parameter import (DeferredInitializationError, Parameter, ParameterDict)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

MESH_SLICE = ("mesh sharding of a Gluon block over more than one device "
              "comes with the multi-device slice (ROADMAP Queue A item 11)")


# ---------------------------------------------------------------------------
# naming
# ---------------------------------------------------------------------------
class _NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter: Dict[str, int] = {}

    @classmethod
    def get(cls) -> "_NameManager":
        if not hasattr(cls._current, "value"):
            cls._current.value = _NameManager()
        return cls._current.value

    def next_prefix(self, hint: str) -> str:
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return f"{hint}{count}_"


class _BlockScope:
    """Name scope: children created inside ``with block.name_scope():``
    get prefixes nested under the block's prefix (reference behavior)."""

    _current = threading.local()

    def __init__(self, block: "Block"):
        self._block = block
        self._counter: Dict[str, int] = {}
        self._old_scope = None

    @staticmethod
    def create(prefix: Optional[str], params: Optional[ParameterDict],
               hint: str) -> Tuple[str, ParameterDict]:
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _NameManager.get().next_prefix(hint)
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, shared=params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix)
        else:
            params = ParameterDict(params.prefix, shared=params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


# ---------------------------------------------------------------------------
# NDArray tree helpers: flatten a call's arguments at the CachedOp boundary
# ---------------------------------------------------------------------------
def _flatten_nds(obj, out: List[Any]):
    if isinstance(obj, NDArray):
        out.append(obj)
        return ("_",)
    if isinstance(obj, (list, tuple)):
        return tuple(_flatten_nds(x, out) for x in obj)
    out.append(obj)  # non-array leaf passes through untouched
    return ("_",)


def _unflatten_nds(tree, flat: List[Any], pos: List[int]):
    if tree == ("_",):
        val = flat[pos[0]]
        pos[0] += 1
        return val
    return tuple(_unflatten_nds(t, flat, pos) for t in tree)


_TRACE_DEPTH = threading.local()
_SYM_MODE = threading.local()


def _in_trace() -> bool:
    return getattr(_TRACE_DEPTH, "depth", 0) > 0


def _in_symbolic() -> bool:
    return getattr(_SYM_MODE, "active", False)


@contextlib.contextmanager
def _eager():
    """Children of a hybridized block run their eager forward, as inside
    a cached op's trace."""
    _TRACE_DEPTH.depth = getattr(_TRACE_DEPTH, "depth", 0) + 1
    try:
        yield
    finally:
        _TRACE_DEPTH.depth -= 1


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------
class Block:
    """Base class for all layers/models (imperative, reference
    ``gluon.Block``)."""

    def __init__(self, prefix: Optional[str] = None,
                 params: Optional[ParameterDict] = None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children: "OrderedDict[str, Block]" = OrderedDict()
        self._reg_params: Dict[str, Parameter] = {}

    def _alias(self) -> str:
        return self.__class__.__name__.lower()

    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._name

    @property
    def params(self) -> ParameterDict:
        return self._params

    def name_scope(self) -> _BlockScope:
        return self._scope

    def __repr__(self):
        s = f"{self.__class__.__name__}("
        for k, v in self._children.items():
            s += f"\n  ({k}): " + repr(v).replace("\n", "\n  ")
        return s + ("\n)" if self._children else ")")

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, Block):
            existing = self._children.get(name) \
                if hasattr(self, "_children") else None
            if existing is not None:
                self._children[name] = value
            else:
                self.register_child(value, name)
        elif isinstance(value, Parameter):
            if not hasattr(self, "_reg_params"):
                raise RuntimeError(
                    "call Block.__init__ before assigning Parameters")
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def register_child(self, block: "Block", name: Optional[str] = None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """All parameters of this block and children, optionally filtered
        by regex (reference semantics: ``select`` matches anywhere)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pat = re.compile(select)
            ret._params.update(
                {k: v for k, v in self._params.items() if pat.match(k)})
        for p in self._reg_params.values():
            if select is None or re.compile(select).match(p.name):
                if p.name not in ret._params:
                    ret._params[p.name] = p
        for child in self._children.values():
            ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix: str = "") -> Dict[str,
                                                                   Parameter]:
        """Attribute-path parameter names ('features.0.weight') used by
        save_parameters/load_parameters (portable across prefixes)."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, ctx=None, verbose: bool = False,
                   force_reinit: bool = False) -> None:
        """Initialize every parameter on ``ctx`` (None: the card)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active: bool = True, **kwargs) -> None:
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype) -> None:
        for child in self._children.values():
            child.cast(dtype)
        for p in self.collect_params().values():
            p.cast(dtype)

    def shard(self, mesh, rules) -> "Block":
        """Place every Parameter on ``mesh`` by the rule table, keyed on
        parameter names (reference ``Block.shard``), and mark the block
        tree with the mesh ``Trainer.make_fused_step`` needs. On a
        one-device mesh each parameter stays whole, on the mesh's device
        (or where it is, for a mesh built without devices); gradient
        buffers are re-created zeroed, so do not call it mid-accumulation.
        Compiled caches of this block and its children are cleared."""
        from ..parallel.mesh import Mesh
        if not isinstance(mesh, Mesh) or mesh.size != 1:
            raise NotImplementedError(MESH_SLICE)
        for p in self.collect_params().values():
            if p._data is None:
                if p._deferred_init:
                    raise MXNetError(
                        f"parameter {p.name} has a deferred shape; run "
                        "one forward before shard() so shapes resolve")
                raise MXNetError(
                    f"parameter {p.name} is uninitialized; call "
                    "initialize() before shard()")
            placement = rules.sharding(mesh, p.name)
            placement._check_axes()
            if mesh.device is not None and \
                    p._data._data.device != mesh.device:
                p.reset_ctx(mesh.device)
            if p._grad_req != "null":      # grads live on the same device
                p._data.attach_grad(p._grad_req)
            p._sharding = placement

        def mark(b):
            b._mesh, b._shard_rules = mesh, rules
            if hasattr(b, "_clear_cached_op"):
                b._clear_cached_op()
            for c in b._children.values():
                mark(c)
        mark(self)
        return self

    def apply(self, fn: Callable[["Block"], None]) -> "Block":
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    # -- serialization ------------------------------------------------------
    def save_parameters(self, filename: str) -> None:
        params = self._collect_params_with_prefix()
        nd.save(filename, {k: v.data() for k, v in params.items()})

    def load_parameters(self, filename: str, ctx=None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False,
                        cast_dtype: bool = False) -> None:
        """Load a ``.params`` file written by either package onto
        ``ctx`` (None: the card)."""
        from ..model import split_arg_aux
        arg_p, aux_p = split_arg_aux(nd.load(filename, ctx))
        loaded = {**arg_p, **aux_p}
        params = self._collect_params_with_prefix()
        if not allow_missing:
            missing = [k for k in params if k not in loaded]
            if missing:
                raise RuntimeError(
                    f"parameters {missing} missing in file {filename}")
        if not ignore_extra:
            extra = [k for k in loaded if k not in params]
            if extra:
                raise RuntimeError(
                    f"file {filename} contains extra parameters {extra}")
        for k, v in loaded.items():
            if k in params:
                if cast_dtype:
                    v = v.astype(params[k].dtype)
                params[k]._load_init(v, ctx)

    save_params = save_parameters
    load_params = load_parameters

    # -- execution ----------------------------------------------------------
    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# HybridBlock
# ---------------------------------------------------------------------------
class _Capture:
    """One CUDA graph of a hybridized block's predict-mode call: its
    static inputs and key, its outputs, and the parameter tensors (and
    their versions) it reads."""

    __slots__ = ("graph", "static_in", "static_key", "outs", "aux",
                 "params", "versions")


class HybridBlock(Block):
    """Block that can run as one cached program via ``hybridize()``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op_params: Optional[List[Parameter]] = None
        self._raw_cache: Dict[Any, Callable] = {}
        self._aux_params_for: Dict[Any, List[Parameter]] = {}
        self._out_tree_for: Dict[Any, Any] = {}
        self._captures: Dict[Any, _Capture] = {}
        self.captures = 0             # CUDA graphs captured, ever

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, mesh=None, rules=None,
                  **kwargs) -> None:
        self._active = active
        self._clear_cached_op()
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)
        if mesh is not None:
            if rules is None:
                from ..parallel.sharding import ShardingRules
                rules = ShardingRules([])
            self.shard(mesh, rules)

    def _clear_cached_op(self) -> None:
        self._cached_op_params = None
        self._raw_cache = {}
        self._aux_params_for = {}
        self._out_tree_for = {}
        self._captures = {}

    def cast(self, dtype) -> None:
        self._clear_cached_op()
        super().cast(dtype)

    def infer_shape(self, *args) -> None:
        """Resolve deferred parameter shapes from input shapes. Layers with
        deferred-init parameters override this."""
        raise MXNetError(
            f"{self.__class__.__name__} has parameters with deferred "
            "(unknown) shapes but does not implement infer_shape(); "
            "specify in_units/in_channels explicitly")

    # -- eager path ---------------------------------------------------------
    def forward(self, x, *args):
        try:
            params = {k: p.data() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(x, *args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            params = {k: p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(nd, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    # -- cached path ----------------------------------------------------------
    def __call__(self, *args):
        if _in_symbolic():
            return self._symbolic_call(*args)
        if self._active and not _in_trace():
            return self._call_cached_op(*args)
        return super().__call__(*args)

    def _call_cached_op(self, *args):
        if self._cached_op_params is None:
            params = list(self.collect_params().values())
            if any(p._data is None for p in params):
                # first call: run eagerly to resolve deferred shapes (the
                # reference's first-call shape/type/storage passes)
                return super().__call__(*args)
            self._cached_op_params = params
        params = self._cached_op_params
        flat_in: List[Any] = []
        in_tree = _flatten_nds(args, flat_in)
        training = autograd.is_training()
        cache_key = (training, in_tree)
        raw = self._raw_cache.get(cache_key)
        if raw is None:
            raw = self._build_raw(training, in_tree, len(flat_in), cache_key)
            self._raw_cache[cache_key] = raw
        datas = [a._data if isinstance(a, NDArray) else a for a in flat_in]
        datas += [p.data()._data for p in params]
        device = next((d.device for d in datas
                       if isinstance(d, torch.Tensor)), torch.device("cpu"))
        datas.append(_random._next_key(device))
        if graphs_on(device) and not training \
                and not autograd.is_recording():
            outs, aux = self._replay(raw, cache_key, datas, len(flat_in),
                                     params)
            node = None
            if _engine.is_debug_nans():
                _engine.check_program(f"CachedOp[{self.name}]", outs,
                                      lambda: raw(*datas))
        else:
            parent_arrays = list(flat_in) + [p.data() for p in params] + \
                [None]
            parents = _parents_of(
                [a if isinstance(a, NDArray) else None
                 for a in parent_arrays])
            (outs, aux), node = autograd.invoke(
                raw, datas, parents, f"CachedOp[{self.name}]", has_aux=True)
        # write mutated aux state back into the real parameters
        with autograd.pause():
            for p, v in zip(self._aux_params_for[cache_key], aux):
                p.set_data(v.detach())
        out_nds = []
        for i, o in enumerate(outs):
            r = NDArray(o)
            if node is not None:
                r._ag = (node, i)
            out_nds.append(r)
        res = _unflatten_nds(self._out_tree_for[cache_key], out_nds, [0])
        return res[0] if len(res) == 1 else res

    def _build_raw(self, training: bool, in_tree, n_in: int, cache_key):
        params = self._cached_op_params
        block = self

        def raw(*datas):
            xs = list(datas[:n_in])
            ps = datas[n_in:n_in + len(params)]
            key = datas[-1]
            for p, d in zip(params, ps):
                p._bind(d)
            _random.push_trace_key(key)
            try:
                with autograd.pause(train_mode=training), _eager():
                    wrapped = [NDArray(x) if isinstance(x, torch.Tensor)
                               else x for x in xs]
                    args = _unflatten_nds(in_tree, wrapped, [0])
                    out = block.forward(*args)
            finally:
                _random.pop_trace_key()
                new_vals = [p._unbind() for p in params]
            aux_params, aux_vals = [], []
            for p, d, nv in zip(params, ps, new_vals):
                if nv is not d:
                    aux_params.append(p)
                    aux_vals.append(nv)
            block._aux_params_for[cache_key] = aux_params
            flat_out: List[Any] = []
            out_tree = _flatten_nds((out,) if isinstance(out, NDArray)
                                    else out, flat_out)
            block._out_tree_for[cache_key] = out_tree
            return (tuple(o._data if isinstance(o, NDArray) else o
                          for o in flat_out), tuple(aux_vals))
        return raw

    # -- the predict-mode CUDA graphs ---------------------------------------
    def _replay(self, raw, cache_key, datas, n_in, params):
        """Run ``raw`` on ``datas`` as this signature's CUDA graph,
        capturing it first when there is none or a parameter was rebound
        since; returns (outputs, aux) cloned out of the graph's memory."""
        ins = datas[:n_in]
        sig = (cache_key, tuple((tuple(d.shape), d.dtype)
                                if isinstance(d, torch.Tensor) else repr(d)
                                for d in ins))
        tensors = [d for d in datas[n_in:n_in + len(params)]]
        versions = tuple(p._data._version for p in params)
        cap = self._captures.get(sig)
        if cap is None or cap.versions != versions or any(
                a is not b for a, b in zip(cap.params, tensors)):
            self._captures.pop(sig, None)      # frees the old graph first
            cap = self._capture(raw, sig, datas, n_in, tensors, versions)
            self._captures[sig] = cap
        for static, d in zip(cap.static_in, ins):
            if static is not None:
                static.copy_(d)
        cap.static_key.copy_(datas[-1])
        cap.graph.replay()
        return (tuple(o.clone() for o in cap.outs),
                tuple(a.clone() for a in cap.aux))

    def _capture(self, raw, sig, datas, n_in, tensors, versions):
        cap = _Capture()
        cap.static_in = [d.clone() if isinstance(d, torch.Tensor) else None
                         for d in datas[:n_in]]
        cap.static_key = datas[-1].clone()
        args = [s if s is not None else d
                for s, d in zip(cap.static_in, datas[:n_in])]
        args += list(tensors) + [cap.static_key]

        def fn():
            cap.outs, cap.aux = raw(*args)

        with torch.no_grad():
            cap.graph = capture_graph(f"cachedop[{self.name}]", fn,
                                      lambda: raw(*args), datas[-1].device)
        cap.params = tensors
        cap.versions = versions
        self.captures += 1
        return cap

    # -- symbolic tracing / deploy ------------------------------------------
    def _symbolic_call(self, *args):
        """This block with Symbol inputs → Symbol outputs (the
        reference's trace of ``hybrid_forward`` with Symbol
        placeholders). State that takes no gradient (grad_req 'null')
        exports as an aux variable whatever its name, so
        ``SymbolBlock.imports`` rebuilds it as frozen state."""
        from .. import symbol as sym
        param_syms = {k: sym.var(p.name, aux=p.grad_req == "null")
                      for k, p in self._reg_params.items()}
        return self.hybrid_forward(sym, *args, **param_syms)

    def _trace_symbol(self, *input_syms):
        """Run the whole net symbolically; children are traced through
        ``__call__`` by the thread's symbolic mode."""
        prev = _in_symbolic()
        _SYM_MODE.active = True
        try:
            out = self(*input_syms)
        finally:
            _SYM_MODE.active = prev
        return out

    def export(self, path: str, epoch: int = 0, num_inputs: int = 1) -> None:
        """Write the traced graph and the parameters in the reference's
        export layout (``path-symbol.json``, ``path-%04d.params``), which
        ``SymbolBlock.imports`` of either package reloads without the
        Python class. Inputs are named ``data``, or ``data0``,
        ``data1``, ... for ``num_inputs`` > 1."""
        from .. import symbol as sym
        inputs = [sym.var("data" if num_inputs == 1 else f"data{i}")
                  for i in range(num_inputs)]
        out = self._trace_symbol(*inputs)
        if isinstance(out, (list, tuple)):
            out = sym.Group(list(out))
        out.save(f"{path}-symbol.json")
        aux_names = set(out.list_auxiliary_states())
        params = {}
        for p in self.collect_params().values():
            kind = "aux:" if p.name in aux_names else "arg:"
            params[kind + p.name] = p.data()
        nd.save(f"{path}-{epoch:04d}.params", params)

    def export_stablehlo(self, path: str, *example_inputs) -> str:
        """Serialize the inference forward as a deployment artifact
        runnable without the model's Python class (the reference's
        name, kept so code written for it runs): a ``torch.export``
        archive (``torch.export.save``) at ``path + ".pt2"``, with the
        weights baked in and shapes fixed to the example inputs'.
        ``mxtpu_torch.contrib.deploy.load`` reloads it. The eager
        forward is traced under ``autograd.pause(train_mode=False)``,
        never a hybridized block's CUDA graph; the hand kernels' launches
        become ``mxtpu_torch::`` operator nodes of the graph. Example
        inputs that are not NDArrays go to the parameters' device.
        Returns the archive's path."""
        params = list(self.collect_params().values())
        dev = next((p._data.context for p in params
                    if p._data is not None), None)
        ex = [x if isinstance(x, NDArray) else nd.array(x, ctx=dev)
              for x in example_inputs]
        if any(p._data is None for p in params):
            with autograd.pause(train_mode=False), _eager():
                self.forward(*ex)       # resolves deferred shapes
        program = torch.export.export(
            _ExportedForward(self, params), tuple(x._data for x in ex))
        out_path = path if path.endswith(".pt2") else path + ".pt2"
        torch.export.save(program, out_path)
        return out_path


class _ExportedForward(torch.nn.Module):
    """A HybridBlock's eager inference forward over tensors, with its
    parameters as buffers: what ``torch.export`` traces. Each call binds
    the parameters to the buffers it is given (the tracer's stand-ins),
    so the graph reads them as state and the archive stores them."""

    def __init__(self, block: HybridBlock, params: List[Parameter]):
        super().__init__()
        self._block = [block]           # not a submodule: no state of its own
        self._params = params
        self._names = []
        for i, p in enumerate(params):
            name = f"p{i}_" + "".join(c if c.isalnum() else "_"
                                      for c in p.name)
            self.register_buffer(name, p.data()._data)
            self._names.append(name)

    def forward(self, *xs):
        for p, name in zip(self._params, self._names):
            p._bind(getattr(self, name))
        try:
            with autograd.pause(train_mode=False), _eager():
                out = self._block[0].forward(*[NDArray(x) for x in xs])
        finally:
            for p in self._params:
                p._unbind()
        outs = out if isinstance(out, (list, tuple)) else (out,)
        return tuple(o._data for o in outs)


class SymbolBlock(HybridBlock):
    """Run a Symbol graph as a Gluon block (reference
    ``gluon.SymbolBlock``): the reload path of ``HybridBlock.export``.

    Parameters are made from the symbol's argument and aux lists, less
    the declared inputs; their shapes come from the params given, or
    from the first forward's input shapes through shape inference. The
    forward interprets the graph through the registry ops, so under
    ``autograd.record()`` it is taped like any op and, hybridized, it
    is one tape node, or one CUDA graph a signature in predict mode on
    the card.
    """

    def __init__(self, outputs, inputs, params=None, prefix=None,
                 ctx=None):
        super().__init__(prefix=prefix or "", params=None)
        from .. import symbol as sym
        if isinstance(outputs, (list, tuple)):
            outputs = sym.Group(list(outputs))
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self._sb_symbol = outputs
        self._input_names = [i.name if isinstance(i, sym.Symbol) else str(i)
                             for i in inputs]
        aux_names = set(outputs.list_auxiliary_states())
        self._sb_params: Dict[str, Parameter] = {}
        loaded = params or {}
        for name in outputs.list_inputs():
            if name in self._input_names:
                continue
            p = Parameter(name,
                          grad_req="null" if name in aux_names else "write",
                          shape=None, allow_deferred_init=True,
                          differentiable=name not in aux_names)
            if name in loaded:
                p._load_init(loaded[name], ctx)
            self._sb_params[name] = p
            self._reg_params[name] = p

    @classmethod
    def imports(cls, symbol_file: str, input_names, param_file=None,
                ctx=None) -> "SymbolBlock":
        """Load an exported ``prefix-symbol.json`` (and its params, on
        ``ctx``; None: the card) — reference ``SymbolBlock.imports``."""
        from .. import symbol as sym
        from ..model import split_arg_aux
        out = sym.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        params = {}
        if param_file:
            arg_p, aux_p = split_arg_aux(nd.load(param_file, ctx))
            params = {**arg_p, **aux_p}
        return cls(out, [sym.var(n) for n in input_names], params=params,
                   ctx=ctx)

    def _resolve_shapes(self, *args) -> None:
        from ..symbol.symbol import _meta
        shapes = {n: _meta(a.shape, a.dtype)
                  for n, a in zip(self._input_names, args)
                  if isinstance(a, NDArray)}
        for n, p in self._sb_params.items():
            if p.shape is not None and 0 not in p.shape:
                shapes[n] = _meta(p.shape, p.dtype)
        structs = self._sb_symbol._infer_structs(**shapes)
        if structs is None:
            raise MXNetError("SymbolBlock: cannot infer parameter shapes "
                             "from input shapes")
        _, var_structs = structs
        for n, p in self._sb_params.items():
            if p.shape is None or 0 in (p.shape or (0,)):
                p.shape = tuple(var_structs[n].shape)

    def forward(self, *args):
        from ..symbol.symbol import interpret_nd
        unresolved = [p for p in self._sb_params.values()
                      if p.shape is None or (p.shape and 0 in p.shape)]
        if unresolved and any(p._data is None for p in unresolved):
            self._resolve_shapes(*args)
            for p in self._sb_params.values():
                if p._data is None and p._deferred_init:
                    p._finish_deferred_init()
        values = dict(zip(self._input_names, args))
        for n, p in self._sb_params.items():
            values[n] = p.data()
        ctx = next((a.context for a in args if isinstance(a, NDArray)),
                   None)
        outs, aux_up = interpret_nd(self._sb_symbol._entries, values, ctx)
        if aux_up:
            with autograd.pause():
                for n, v in aux_up.items():
                    self._sb_params[n].set_data(v)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _symbolic_call(self, *args):
        # re-exporting a SymbolBlock: splice the stored graph
        return _splice_symbol(self._sb_symbol,
                              dict(zip(self._input_names, args)))


def _splice_symbol(symbol, input_map):
    """Rebuild a symbol graph with its input variables replaced (for
    re-export)."""
    from ..symbol.symbol import Symbol, _Node
    memo = {}

    def clone(node):
        if id(node) in memo:
            return memo[id(node)]
        if node.op == "null" and node.name in input_map:
            repl = input_map[node.name]._entries[0][0]
            memo[id(node)] = repl
            return repl
        new = _Node(node.op, node.name, dict(node.attrs),
                    [(clone(p), i) for p, i in node.inputs])
        memo[id(node)] = new
        return new

    return Symbol([(clone(n), i) for n, i in symbol._entries])
