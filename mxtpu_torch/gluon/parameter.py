"""Gluon Parameter / ParameterDict — the port of
``mxtpu/gluon/parameter.py`` (reference ``python/mxnet/gluon/parameter.py``).

A Parameter owns one NDArray on one device (the reference's multi-device
copies wait for ROADMAP Queue A item 11b). Deferred shape inference keeps
the reference's semantics: unknown dims are 0 until the first forward
resolves them. During a hybridized call (the CachedOp of
``gluon.block``) the parameter is *bound* to the tensor the call was
given: ``data()`` then returns that tensor as an NDArray, so the
block's eager forward runs on the call's own inputs, and a ``set_data``
(BatchNorm's running statistics) rebinds it, to be written back after
the call as the reference writes its aux outputs.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional

import numpy as _np
import torch

from .. import initializer as init_mod
from .. import ndarray as nd
from ..base import MXNetError, dtype_torch
from ..context import resolve_device
from ..ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]

class DeferredInitializationError(MXNetError):
    """Raised when a parameter's value is requested before its shape is
    known (reference: same-named error class)."""


def _shape_complete(shape) -> bool:
    return shape is not None and all(s > 0 for s in shape)


class Parameter:
    """A trainable weight: value + grad + init spec + deferred shape."""

    def __init__(self, name: str, grad_req: str = "write", shape=None,
                 dtype="float32", lr_mult: float = 1.0, wd_mult: float = 1.0,
                 init=None, allow_deferred_init: bool = False,
                 differentiable: bool = True, stype: str = "default",
                 grad_stype: str = "default"):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._data: Optional[NDArray] = None
        self._bound: Optional[torch.Tensor] = None   # during a CachedOp call
        self._bound_depth = 0
        self._deferred_init = ()     # (init, device) pending until shape known
        self._ctx: Optional[torch.device] = None

    # -- properties ---------------------------------------------------------
    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req: str) -> None:
        if req not in ("write", "add", "null"):
            raise ValueError(f"invalid grad_req {req!r}")
        self._grad_req = req
        if self._data is not None:
            if req == "null":
                self._data._ag_leaf = None
                self._data.grad = None
            else:
                self._data.attach_grad(req)

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    # -- initialization -----------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit: bool = False) -> None:
        """Initialize on ``ctx`` (None: the card; a list takes its first
        device, the one-device port's only one)."""
        if self._data is not None and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        self._ctx = resolve_device(ctx)
        default_init = default_init or init_mod.Uniform()
        chosen = init if init is not None else (self.init or default_init)
        if not _shape_complete(self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (chosen, self._ctx)
                return
            raise ValueError(
                f"cannot initialize parameter {self.name} of unknown shape "
                f"{self.shape}; set allow_deferred_init=True or specify "
                "in_units/in_channels")
        self._init_impl(chosen, self._ctx)

    def _init_impl(self, chosen_init, ctx) -> None:
        data = nd.zeros(self.shape, ctx=ctx, dtype=dtype_torch(self.dtype))
        init_mod.create(chosen_init)(init_mod.InitDesc(self.name), data)
        self._data = data
        self._deferred_init = ()
        if self._grad_req != "null":
            self._data.attach_grad(self._grad_req)

    def _finish_deferred_init(self) -> None:
        if not self._deferred_init:
            return
        if not _shape_complete(self.shape):
            raise DeferredInitializationError(
                f"parameter {self.name} shape still unknown: {self.shape}")
        chosen, ctx = self._deferred_init
        self._init_impl(chosen, ctx)

    def _load_init(self, data: NDArray, ctx=None) -> None:
        """Install loaded values (load_parameters path) on ``ctx``, or on
        this parameter's device, or (None) the card."""
        if self.shape is not None and _shape_complete(self.shape) and \
                tuple(data.shape) != tuple(self.shape):
            raise ValueError(
                f"shape mismatch loading {self.name}: file {data.shape} "
                f"vs declared {self.shape}")
        self.shape = tuple(data.shape)
        self.dtype = data.dtype
        self._ctx = resolve_device(ctx if ctx is not None else self._ctx)
        self._data = data.as_in_context(self._ctx)
        self._deferred_init = ()
        if self._grad_req != "null":
            self._data.attach_grad(self._grad_req)

    # -- CachedOp binding ----------------------------------------------------
    def _bind(self, tensor: torch.Tensor) -> None:
        self._bound = tensor
        self._bound_depth += 1

    def _unbind(self) -> torch.Tensor:
        val = self._bound
        self._bound = None
        self._bound_depth -= 1
        return val

    # -- access -------------------------------------------------------------
    def _check_and_get(self) -> NDArray:
        if self._bound is not None:
            return NDArray(self._bound)
        if self._data is not None:
            return self._data
        if self._deferred_init:
            raise DeferredInitializationError(
                f"parameter {self.name} has deferred init pending; its "
                "shape resolves on the first forward")
        raise RuntimeError(
            f"parameter {self.name} has not been initialized; call "
            "net.initialize() / block.collect_params().initialize() first")

    def data(self, ctx=None) -> NDArray:
        return self._check_and_get()

    def list_data(self) -> List[NDArray]:
        return [self._check_and_get()]

    def set_data(self, data) -> None:
        if self._bound_depth > 0:
            # inside a hybridized call: the new value is an aux output of
            # the call (BatchNorm running stats), written back after it
            self._bound = data._data if isinstance(data, NDArray) else data
            return
        if isinstance(data, NDArray):
            data = data._data
        if self._data is None:
            if not self._deferred_init:
                raise RuntimeError(
                    f"parameter {self.name} not initialized; cannot set_data")
            self.shape = tuple(data.shape)
            self._finish_deferred_init()
        self._data._set_data(data.to(self._data._data.device))

    def grad(self, ctx=None) -> NDArray:
        d = self._check_and_get()
        if d.grad is None:
            raise RuntimeError(
                f"cannot get gradient of parameter {self.name}: "
                f"grad_req is {self._grad_req!r}")
        return d.grad

    def list_grad(self) -> List[NDArray]:
        return [self.grad()]

    def zero_grad(self) -> None:
        if self._data is not None and self._data.grad is not None:
            self._data.grad._set_data(torch.zeros_like(self._data.grad._data))

    def list_ctx(self) -> List[torch.device]:
        if self._data is None and self._deferred_init:
            return [self._deferred_init[1]]
        return [resolve_device(self._ctx)]

    def reset_ctx(self, ctx) -> None:
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        self._ctx = resolve_device(ctx)
        if self._data is not None:
            grad_req = self._grad_req
            self._data = self._data.as_in_context(self._ctx)
            if grad_req != "null":
                self._data.attach_grad(grad_req)

    def cast(self, dtype) -> None:
        self.dtype = dtype
        if self._data is not None:
            grad_req = self._grad_req
            self._data = self._data.astype(dtype)
            if grad_req != "null":
                self._data.attach_grad(grad_req)

    def var(self):
        """This parameter as a symbolic variable (reference
        ``Parameter.var``)."""
        from .. import symbol
        return symbol.var(self.name, shape=self.shape, dtype=self.dtype)


class Constant(Parameter):
    """Non-differentiable parameter with a fixed value
    (reference ``gluon.Constant``)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd.array(value, ctx="cpu")
        self.value = value

        class _CInit(init_mod.Initializer):
            def __call__(_self, _desc, arr):
                # a Constant is a constant: bypass the name-suffix
                # dispatch (which would zero a '*mean' or one a '*var')
                arr[:] = value

            def _init_weight(_self, _name, arr):
                arr[:] = value

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_CInit())


class ParameterDict:
    """Ordered name→Parameter mapping with a shared prefix
    (reference ``gluon.ParameterDict``)."""

    def __init__(self, prefix: str = "",
                 shared: Optional["ParameterDict"] = None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    @property
    def prefix(self) -> str:
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        body = "".join(f"\n  {v!r}" for v in self._params.values())
        return f"ParameterDict '{self._prefix}' ({body}\n)"

    def __getitem__(self, key) -> Parameter:
        return self._params[key]

    def __contains__(self, key) -> bool:
        return key in self._params

    def get(self, name: str, **kwargs) -> Parameter:
        """Find or create ``prefix+name``, merging attribute hints —
        the reference's create-on-demand accessor used by every layer."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            if v is None:
                continue
            if k == "shape":
                v = (v,) if isinstance(v, int) else tuple(v)
                if param.shape is not None:
                    if len(v) == len(param.shape) and all(
                            a == b or a == 0 or b == 0
                            for a, b in zip(v, param.shape)):
                        v = tuple(b if a == 0 else a
                                  for a, b in zip(v, param.shape))
                    else:
                        raise ValueError(
                            f"inconsistent shape for {name}: {v} vs "
                            f"{param.shape}")
                param.shape = v
            elif getattr(param, k, None) is None:
                setattr(param, k, v)
        return param

    def get_constant(self, name: str, value=None) -> Parameter:
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError(f"no constant named {name} and no value given")
            param = Constant(name, value)
            self._params[name] = param
        return param

    def _get_impl(self, name: str) -> Optional[Parameter]:
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def update(self, other: "ParameterDict") -> None:
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(f"duplicate parameter name {k}")
            self._params[k] = v

    # -- bulk ops ------------------------------------------------------------
    def initialize(self, init=None, ctx=None, verbose: bool = False,
                   force_reinit: bool = False) -> None:
        default = init or init_mod.Uniform()
        for p in self.values():
            p.initialize(None, ctx, default, force_reinit=force_reinit)

    def zero_grad(self) -> None:
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx) -> None:
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name: str, value) -> None:
        for p in self.values():
            setattr(p, name, value)

    def cast(self, dtype) -> None:
        for p in self.values():
            p.cast(dtype)

    # -- weights in: {name: numpy} -------------------------------------------
    def load_dict(self, arrays, ctx=None, allow_missing: bool = False,
                  ignore_extra: bool = False) -> None:
        """Install ``{full parameter name: array-like}`` (numpy arrays,
        NDArrays or tensors) on ``ctx`` (None: each parameter's device,
        else the card), keeping each array's dtype (bfloat16 as torch
        gives it; numpy has none). The in-memory twin of :meth:`load`."""
        if not allow_missing:
            missing = [n for n in self.keys() if n not in arrays]
            if missing:
                raise RuntimeError(f"parameters {missing} missing")
        for name, val in arrays.items():
            if name not in self._params:
                if not ignore_extra:
                    raise RuntimeError(f"extra parameter {name}")
                continue
            p = self._params[name]
            dev = resolve_device(ctx if ctx is not None else p._ctx)
            if isinstance(val, NDArray):
                val = val._data
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(_np.ascontiguousarray(val))
            p._load_init(NDArray(val.to(dev, copy=True)), dev)

    # -- serialization (.params container — mxtpu_torch.serde) ---------------
    def save(self, filename: str, strip_prefix: str = "") -> None:
        arg_dict = {}
        for p in self.values():
            if p._data is None:
                raise RuntimeError(f"parameter {p.name} not initialized; "
                                   "cannot save")
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict["arg:" + name] = p.data()
        nd.save(filename, arg_dict)

    def load(self, filename: str, ctx=None, allow_missing: bool = False,
             ignore_extra: bool = False, restore_prefix: str = "") -> None:
        """Load a ``.params`` file onto ``ctx`` (None: the card)."""
        loaded = nd.load(filename, ctx)
        arg_dict = {}
        for k, v in loaded.items():
            if k.startswith("arg:") or k.startswith("aux:"):
                k = k[4:]
            arg_dict[restore_prefix + k] = v
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise RuntimeError(
                        f"parameter {name} missing in file {filename}")
        for name, data in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise RuntimeError(
                        f"file {filename} has extra parameter {name}")
                continue
            self._params[name]._load_init(data, ctx)
