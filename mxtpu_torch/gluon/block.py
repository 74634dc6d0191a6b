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

``shard``/``hybridize(mesh=)`` (ROADMAP Queue A item 11) and
``export``/``export_stablehlo``/``SymbolBlock`` (item 10.4) raise.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import autograd
from .. import ndarray as nd
from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray import random as _random
from ..ndarray.ndarray import _parents_of
from ..telemetry import watcher
from .parameter import (DeferredInitializationError, Parameter, ParameterDict)

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

MESH_SLICE = ("mesh sharding of a Gluon block comes with the multi-device "
              "slice (ROADMAP Queue A item 11)")
EXPORT_SLICE = ("the Symbol export path (export, export_stablehlo, "
                "SymbolBlock) comes with ROADMAP Queue A item 10.4")


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


def _in_trace() -> bool:
    return getattr(_TRACE_DEPTH, "depth", 0) > 0


def _graphs_on(device: torch.device) -> bool:
    """Whether a predict-mode call on ``device`` replays a CUDA graph."""
    return device.type == "cuda"


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
        raise NotImplementedError(MESH_SLICE)

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
        if mesh is not None:
            raise NotImplementedError(MESH_SLICE)
        self._active = active
        self._clear_cached_op()
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

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
        if _graphs_on(device) and not training \
                and not autograd.is_recording():
            outs, aux = self._replay(raw, cache_key, datas, len(flat_in),
                                     params)
            node = None
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
            _TRACE_DEPTH.depth = getattr(_TRACE_DEPTH, "depth", 0) + 1
            try:
                with autograd.pause(train_mode=training):
                    wrapped = [NDArray(x) if isinstance(x, torch.Tensor)
                               else x for x in xs]
                    args = _unflatten_nds(in_tree, wrapped, [0])
                    out = block.forward(*args)
            finally:
                _TRACE_DEPTH.depth -= 1
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
        from ..serve.engine import _CAPTURE_LOCK
        cap = _Capture()
        device = datas[-1].device
        cap.static_in = [d.clone() if isinstance(d, torch.Tensor) else None
                         for d in datas[:n_in]]
        cap.static_key = datas[-1].clone()
        args = [s if s is not None else d
                for s, d in zip(cap.static_in, datas[:n_in])]
        args += list(tensors) + [cap.static_key]
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        with _CAPTURE_LOCK, watcher.build(f"cachedop[{self.name}]"), \
                torch.no_grad():
            side.wait_stream(main)
            with torch.cuda.stream(side):
                raw(*args)                     # warm-up, off the graph
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                cap.outs, cap.aux = raw(*args)
        cap.graph = graph
        cap.params = tensors
        cap.versions = versions
        self.captures += 1
        return cap

    # -- the Symbol export path (a later slice) -------------------------------
    def export(self, path: str, epoch: int = 0, num_inputs: int = 1):
        raise NotImplementedError(EXPORT_SLICE)

    def export_stablehlo(self, path: str, *example_inputs):
        raise NotImplementedError(EXPORT_SLICE)


class SymbolBlock(HybridBlock):
    """Runs a Symbol graph as a block: comes with the Symbol frontend."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(EXPORT_SLICE)

    @classmethod
    def imports(cls, *args, **kwargs):
        raise NotImplementedError(EXPORT_SLICE)
