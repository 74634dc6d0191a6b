"""Weight initializers — the port of ``mxtpu/initializer.py`` (reference
``python/mxnet/initializer.py``).

Same registry + descriptor design as the reference: an ``Initializer``
dispatches on the parameter name's suffix (``_weight``/``_bias``/``_gamma``/
``_beta``/``_mean``/``_var``) unless an ``InitDesc`` attr overrides, and
string names like ``"xavier"`` resolve through a registry. Sampling goes
through the port's ``mx.nd.random`` on the array's own device, so
``mx.random.seed(s)`` followed by the same initializer gives the
reference's weights (its draws are the reference's Threefry chain).
``Orthogonal`` draws from numpy's global generator, as the reference's
does.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Optional

import numpy as _np

from . import ndarray as nd
from .ndarray import random as _random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "register", "create"]

_INIT_REGISTRY: Dict[str, type] = {}


def register(klass):
    """Register an initializer class under its lowercased name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init: Any, **kwargs) -> "Initializer":
    """Resolve ``init`` (Initializer | str | None) to an Initializer."""
    if init is None:
        return Uniform()
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        name = init.lower()
        if name not in _INIT_REGISTRY:
            raise ValueError(f"unknown initializer {init!r}; "
                             f"registered: {sorted(_INIT_REGISTRY)}")
        return _INIT_REGISTRY[name](**kwargs)
    raise TypeError(f"cannot create initializer from {init!r}")


class InitDesc(str):
    """Parameter name + attrs describing how to initialize it
    (reference ``mx.init.InitDesc``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Base initializer: ``init(desc, arr)`` fills ``arr`` in place."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self) -> str:
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr) -> None:
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        if desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "")
        if init:
            create(json.loads(init)[0], **json.loads(init)[1]) \
                ._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean") \
                or name.endswith("mean"):
            self._init_zero(desc, arr)
        elif name.endswith("running_var") or name.endswith("moving_var") \
                or name.endswith("var"):
            self._init_one(desc, arr)
        else:
            self._init_default(desc, arr)

    # -- suffix rules (reference behavior) ----------------------------------
    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_bias(self, name, arr):
        arr[:] = 0.0

    def _init_gamma(self, name, arr):
        arr[:] = 1.0

    def _init_beta(self, name, arr):
        arr[:] = 0.0

    def _init_zero(self, name, arr):
        arr[:] = 0.0

    def _init_one(self, name, arr):
        arr[:] = 1.0

    def _init_default(self, name, arr):
        self._init_weight(name, arr)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._kwargs})"


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 0.0


_INIT_REGISTRY["zeros"] = Zero


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 1.0


_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        val = self.value
        if hasattr(val, "asnumpy"):
            val = val.asnumpy()
        arr[:] = val


@register
class Uniform(Initializer):
    """U(-scale, scale) — the reference's default global init (scale 0.07)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        _random.uniform(-self.scale, self.scale, arr.shape,
                        dtype=arr.dtype, out=arr)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _random.normal(0.0, self.sigma, arr.shape, dtype=arr.dtype, out=arr)


@register
class Xavier(Initializer):
    """Glorot init (reference ``mx.init.Xavier``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError(
                f"Xavier requires at least 2D weight, got {shape} for {name}")
        hw_scale = 1.0
        if len(shape) > 2:
            hw_scale = float(_np.prod(shape[2:]))
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0,
                  "in": fan_in, "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _random.uniform(-scale, scale, shape, dtype=arr.dtype, out=arr)
        elif self.rnd_type == "gaussian":
            _random.normal(0.0, scale, shape, dtype=arr.dtype, out=arr)
        else:
            raise ValueError(f"unknown rnd_type {self.rnd_type}")


@register
class MSRAPrelu(Xavier):
    """Kaiming init (reference ``mx.init.MSRAPrelu``)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = _np.random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = _np.random.normal(0.0, 1.0, (nout, nin))
        u, _, v = _np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == (nout, nin) else v
        arr[:] = self.scale * q.reshape(arr.shape)


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernel (for Deconvolution)."""

    def _init_weight(self, name, arr):
        weight = _np.zeros(arr.shape, dtype="float32")
        shape = arr.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(_np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight


@register
class LSTMBias(Initializer):
    """Forget-gate bias init (reference ``mx.init.LSTMBias``)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        arr[:] = 0.0
        num_hidden = arr.shape[0] // 4
        a = arr.asnumpy()
        a[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = a

    _init_bias = _init_weight


class Mixed:
    """Per-pattern initializer mix (reference ``mx.init.Mixed``)."""

    def __init__(self, patterns, initializers):
        import re
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must pair up")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for pat, init in self.map:
            if pat.match(str(name)):
                init(name, arr)
                return
        raise ValueError(f"parameter {name} did not match any pattern")
