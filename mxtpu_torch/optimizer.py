"""Optimizers — the port of ``mxtpu/optimizer.py`` (reference
``python/mxnet/optimizer/optimizer.py`` and the fused update ops of
``src/operator/optimizer_op.cc``).

Same user API as the reference: the registry
(``mx.optimizer.create('sgd')``), ``create_state``/``update`` per
parameter index, and ``Updater`` for update-on-kvstore. Each rule is
plain tensor arithmetic that rebinds the weight and state NDArrays (a
buffer is never written in place: the tape may hold it). The
multi-tensor step of SGD and Adam (the reference's one jitted program
over every parameter, ``_fused_sgd_*``/``_fused_adam``) is a sequence
of ``torch._foreach_*`` calls, one launch per op for all parameters.

The hyperparameters round as the reference's do: its jitted kernels
take them as float32 arrays (``1 - beta1`` is then a float32
subtraction), its eager rules as Python floats, each rounded once to
the weight's dtype. A tensor divided by a Python float divides
elementwise here (torch would multiply by the reciprocal, an ulp away
from the reference's division).
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict

import numpy as _np
import torch

from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "AdaDelta",
           "RMSProp", "Ftrl", "Signum", "SGLD", "LAMB", "Updater",
           "get_updater", "create", "register"]

_OPT_REGISTRY: Dict[str, type] = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    if name.lower() not in _OPT_REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; "
                         f"registered: {sorted(_OPT_REGISTRY)}")
    return _OPT_REGISTRY[name.lower()](**kwargs)


def _t(x) -> torch.Tensor:
    return x._data if isinstance(x, NDArray) else x


def _f32(x) -> float:
    """A hyperparameter as the reference's float32 kernel argument."""
    return float(_np.float32(x))


def _one_minus(b) -> float:
    """``1 - b`` computed in float32 from float32 ``b`` (the reference's
    ``(1 - b1)`` inside a jitted kernel)."""
    return float(_np.float32(1) - _np.float32(b))


def _div(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t / s`` as an elementwise division (not a reciprocal multiply)."""
    return t / torch.full((), s, dtype=t.dtype, device=t.device).expand(
        t.shape)


def _zeros_like(weight: NDArray) -> NDArray:
    return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)


def _prep(g, w, rescale, clip, wd):
    g = g * rescale
    if clip is not None:
        g = torch.clamp(g, -clip, clip)
    return g + wd * w


class Optimizer:
    """Base optimizer. State is an NDArray (or a tuple of them) per
    parameter index, on the weight's device."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None,
                 **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    opt_registry = _OPT_REGISTRY
    create_optimizer = staticmethod(create)

    # -- lr / wd resolution -------------------------------------------------
    def set_learning_rate(self, lr: float) -> None:
        if self.lr_scheduler is not None:
            raise UserWarning("lr_scheduler is set; use it to adjust lr")
        self.lr = lr

    @property
    def learning_rate(self) -> float:
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr: float) -> None:
        self.lr = lr

    def set_lr_mult(self, args_lr_mult: Dict[Any, float]) -> None:
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[Any, float]) -> None:
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index) -> None:
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index) -> float:
        lr = self.learning_rate
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index) -> float:
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    # -- per-param API ------------------------------------------------------
    def create_state(self, index, weight):
        return None

    @staticmethod
    def _is_low_precision(weight) -> bool:
        return weight.dtype in (torch.float16, torch.bfloat16)

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and self._is_low_precision(weight):
            master = weight.astype("float32")
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and self._is_low_precision(weight):
            master, inner = state
            self.update(index, master, grad.astype("float32"), inner)
            weight._set_data(master._data.to(weight.dtype))
            return
        self.update(index, weight, grad, state)

    def __getstate__(self):
        return self.__dict__

    def __setstate__(self, state):
        self.__dict__.update(state)


@register
class SGD(Optimizer):
    """SGD with momentum (reference ``sgd_update``/``sgd_mom_update``)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = _f32(self._get_lr(index)), _f32(self._get_wd(index))
        w = _t(weight)
        clip = self.clip_gradient
        g = _prep(_t(grad), w, _f32(self.rescale_grad),
                  None if clip is None else _f32(clip), wd)
        if self.momentum == 0.0:
            weight._set_data(w - lr * g)
            return
        mom = _f32(self.momentum) * _t(state) - lr * g
        weight._set_data(w + mom)
        state._set_data(mom)

    def fused_step(self, indices, weights, grads, states):
        return _fused_sgd_step(self, indices, weights, grads, states)


def _fused_sgd_step(opt, indices, weights, grads, states):
    """Every parameter's SGD update in one ``torch._foreach_*`` sequence
    (the reference's ``multi_sgd_update`` program)."""
    if opt.multi_precision or opt.clip_gradient is not None:
        return False
    for i in indices:
        opt._update_count(i)
    ws = [_t(w) for w in weights]
    lrs = [_f32(opt._get_lr(i)) for i in indices]
    wds = [_f32(opt._get_wd(i)) for i in indices]
    gs = torch._foreach_mul([_t(g) for g in grads], _f32(opt.rescale_grad))
    gs = torch._foreach_add(gs, torch._foreach_mul(ws, wds))
    steps = torch._foreach_mul(gs, lrs)
    if opt.momentum == 0.0:
        for w, nw in zip(weights, torch._foreach_sub(ws, steps)):
            w._set_data(nw)
        return True
    moms = torch._foreach_sub(
        torch._foreach_mul([_t(s) for s in states], _f32(opt.momentum)),
        steps)
    for w, nw, s, nm in zip(weights, torch._foreach_add(ws, moms), states,
                            moms):
        w._set_data(nw)
        s._set_data(nm)
    return True


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference ``nag_mom_update``)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = _prep(_t(grad), w, self.rescale_grad, self.clip_gradient, wd)
        if state is None:
            weight._set_data(w - lr * g)
            return
        mom = self.momentum * _t(state) + g
        weight._set_data(w - lr * (g + self.momentum * mom))
        state._set_data(mom)


@register
class Adam(Optimizer):
    """Adam (reference ``adam_update``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _lr_t(self, index) -> float:
        t = self._index_update_count[index]
        return self._get_lr(index) * math.sqrt(1. - self.beta2 ** t) / \
            (1. - self.beta1 ** t)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr_t, wd = _f32(self._lr_t(index)), _f32(self._get_wd(index))
        b1, b2 = _f32(self.beta1), _f32(self.beta2)
        w = _t(weight)
        g = _t(grad) * _f32(self.rescale_grad)
        if self.clip_gradient is not None:
            c = _f32(self.clip_gradient)
            g = torch.clamp(g, -c, c)
        g = g + wd * w
        m = b1 * _t(state[0]) + _one_minus(self.beta1) * g
        v = b2 * _t(state[1]) + _one_minus(self.beta2) * torch.square(g)
        weight._set_data(w - lr_t * m / (torch.sqrt(v)
                                         + _f32(self.epsilon)))
        state[0]._set_data(m)
        state[1]._set_data(v)

    def fused_step(self, indices, weights, grads, states):
        """Every parameter's Adam update in one ``torch._foreach_*``
        sequence (the reference's ``_fused_adam`` program)."""
        if self.multi_precision or self.clip_gradient is not None:
            return False
        for i in indices:
            self._update_count(i)
        ws = [_t(w) for w in weights]
        lr_ts = [_f32(self._lr_t(i)) for i in indices]
        wds = [_f32(self._get_wd(i)) for i in indices]
        gs = torch._foreach_mul([_t(g) for g in grads],
                                _f32(self.rescale_grad))
        gs = torch._foreach_add(gs, torch._foreach_mul(ws, wds))
        ms = torch._foreach_add(
            torch._foreach_mul([_t(s[0]) for s in states], _f32(self.beta1)),
            torch._foreach_mul(gs, _one_minus(self.beta1)))
        vs = torch._foreach_add(
            torch._foreach_mul([_t(s[1]) for s in states], _f32(self.beta2)),
            torch._foreach_mul(torch._foreach_mul(gs, gs),
                               _one_minus(self.beta2)))
        denom = torch._foreach_add(torch._foreach_sqrt(vs),
                                   _f32(self.epsilon))
        steps = torch._foreach_div(torch._foreach_mul(ms, lr_ts), denom)
        for w, nw in zip(weights, torch._foreach_sub(ws, steps)):
            w._set_data(nw)
        for s, nm, nv in zip(states, ms, vs):
            s[0]._set_data(nm)
            s[1]._set_data(nv)
        return True


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (reference contrib adamw_update)."""

    def fused_step(self, indices, weights, grads, states):
        # the fused Adam sequence folds wd into the gradient (coupled);
        # AdamW's decay is decoupled — keep the exact per-param path
        return False

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = _prep(_t(grad), w, self.rescale_grad, self.clip_gradient, 0.0)
        m = self.beta1 * _t(state[0]) + (1 - self.beta1) * g
        v = self.beta2 * _t(state[1]) + (1 - self.beta2) * torch.square(g)
        mhat = _div(m, 1 - self.beta1 ** t)
        vhat = _div(v, 1 - self.beta2 ** t)
        weight._set_data(
            w - lr * (mhat / (torch.sqrt(vhat) + self.epsilon) + wd * w))
        state[0]._set_data(m)
        state[1]._set_data(v)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = _prep(_t(grad), w, self.rescale_grad, self.clip_gradient, wd)
        hist = _t(state) + torch.square(g)
        weight._set_data(
            w - lr * g / torch.sqrt(hist + self.float_stable_eps))
        state._set_data(hist)


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        w = _t(weight)
        g = _prep(_t(grad), w, self.rescale_grad, self.clip_gradient, wd)
        acc_g, acc_delta = _t(state[0]), _t(state[1])
        acc_g = self.rho * acc_g + (1 - self.rho) * torch.square(g)
        delta = torch.sqrt(acc_delta + self.epsilon) / \
            torch.sqrt(acc_g + self.epsilon) * g
        acc_delta = self.rho * acc_delta + \
            (1 - self.rho) * torch.square(delta)
        weight._set_data(w - delta)
        state[0]._set_data(acc_g)
        state[1]._set_data(acc_delta)


@register
class RMSProp(Optimizer):
    """RMSProp (reference ``rmsprop_update``/``rmspropalex_update``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = _prep(_t(grad), w, self.rescale_grad, self.clip_gradient, wd)
        if not self.centered:
            n = (1 - self.gamma1) * torch.square(g) + self.gamma1 * _t(state)
            new_w = w - lr * g / torch.sqrt(n + self.epsilon)
            state._set_data(n)
        else:
            n, gm, delta = (_t(s) for s in state)
            n = (1 - self.gamma1) * torch.square(g) + self.gamma1 * n
            gm = (1 - self.gamma1) * g + self.gamma1 * gm
            delta = self.gamma2 * delta - \
                lr * g / torch.sqrt(n - torch.square(gm) + self.epsilon)
            new_w = w + delta
            state[0]._set_data(n)
            state[1]._set_data(gm)
            state[2]._set_data(delta)
        if self.clip_weights:
            new_w = torch.clamp(new_w, -self.clip_weights, self.clip_weights)
        weight._set_data(new_w)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))   # z, n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = _t(grad) * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        z, n = _t(state[0]), _t(state[1])
        sigma = _div(torch.sqrt(n + torch.square(g)) - torch.sqrt(n), lr)
        z = z + g - sigma * w
        n = n + torch.square(g)
        shrunk = -(z - torch.sign(z) * self.lamda1) / \
            (_div(self.beta + torch.sqrt(n), lr) + wd)
        new_w = torch.where(torch.abs(z) > self.lamda1, shrunk,
                            torch.zeros_like(shrunk)).to(w.dtype)
        weight._set_data(new_w)
        state[0]._set_data(z)
        state[1]._set_data(n)


@register
class Signum(Optimizer):
    """Sign-SGD with momentum (reference ``signum_update``)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        if state is not None:
            g = _prep(_t(grad), w, self.rescale_grad, self.clip_gradient, wd)
            mom = self.momentum * _t(state) - (1 - self.momentum) * g
            new_w = (1 - lr * self.wd_lh) * w + lr * torch.sign(mom)
            state._set_data(mom)
        else:
            g = _t(grad) * self.rescale_grad + wd * w
            new_w = (1 - lr * self.wd_lh) * w - lr * torch.sign(g)
        weight._set_data(new_w)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference ``sgld``): the
    noise is drawn from the ``mx.random`` key chain."""

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = _prep(_t(grad), w, self.rescale_grad, self.clip_gradient, wd)
        noise = nd.random.normal(0, math.sqrt(lr), w.shape, dtype=w.dtype,
                                 ctx=w.device)._data
        weight._set_data(w - lr / 2 * g + noise)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments for large-batch training (reference
    ``lamb_update_phase1/2``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _t(weight)
        g = _t(grad) * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        m = self.beta1 * _t(state[0]) + (1 - self.beta1) * g
        v = self.beta2 * _t(state[1]) + (1 - self.beta2) * torch.square(g)
        if self.bias_correction:
            mhat = _div(m, 1 - self.beta1 ** t)
            vhat = _div(v, 1 - self.beta2 ** t)
        else:
            mhat, vhat = m, v
        r = mhat / (torch.sqrt(vhat) + self.epsilon) + wd * w
        r1 = torch.linalg.vector_norm(w)
        if self.lower_bound is not None:
            r1 = torch.clamp_min(r1, self.lower_bound)
        if self.upper_bound is not None:
            r1 = torch.clamp_max(r1, self.upper_bound)
        r2 = torch.linalg.vector_norm(r)
        ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                            torch.ones_like(r1))
        weight._set_data(w - lr * ratio * r)
        state[0]._set_data(m)
        state[1]._set_data(v)


# ---------------------------------------------------------------------------
# Updater — the reference's update-on-kvstore callable
# ---------------------------------------------------------------------------
class Updater:
    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        """The states pickled (NDArrays as host numpy with their device),
        with the optimizer when ``dump_optimizer``."""
        return pickle.dumps((self.states, self.optimizer)
                            if dump_optimizer else self.states)

    def set_states(self, states) -> None:
        obj = pickle.loads(states)
        if isinstance(obj, tuple) and len(obj) == 2 and \
                isinstance(obj[1], Optimizer):
            self.states, self.optimizer = obj
        else:
            self.states = obj


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
