"""The optax transforms that ``make_train_step`` takes, written out in
torch: :func:`adamw` and :func:`sgd`, each a :class:`GradientTransformation`
with ``init(params) -> state`` and ``update(grads, state, params) ->
(updates, state)`` over a parameter tree.

They follow optax (the reference trains Llama with ``optax.adamw`` and
ResNet with ``optax.sgd(0.1, momentum=0.9)``), not ``torch.optim``:
AdamW's decay is added to the Adam direction before the learning rate
scales it (``u = -lr * (m_hat / (sqrt(v_hat + eps_root) + eps) + wd * p)``,
``weight_decay`` 1e-4 by default, where ``torch.optim.AdamW`` decays
``p`` by ``lr * 0.01`` before the step), momentum is ``optax.trace``
(``m = g + mu * m``), and moments are kept in the params' dtype. The
update is functional, as in optax; ``make_train_step`` applies it to
the params in place.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ._tree import tree_leaves, tree_map

__all__ = ["GradientTransformation", "ScaleByAdamState", "TraceState",
           "adamw", "sgd"]

_INT32_MAX = 2 ** 31 - 1


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor       # int32 scalar: updates applied so far
    mu: Any
    nu: Any


class TraceState(NamedTuple):
    trace: Any


def _zeros(params):
    return tree_map(torch.zeros_like, params)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """``optax.adamw``: ``scale_by_adam``, ``add_decayed_weights``,
    ``scale_by_learning_rate``, with optax's defaults."""
    def init(params):
        device = tree_leaves(params)[0].device
        return ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=_zeros(params), nu=_zeros(params))

    def update(grads, state, params):
        # optax's safe_increment: the count saturates instead of wrapping
        count = torch.where(state.count < _INT32_MAX, state.count + 1,
                            state.count)
        # 1 - decay**count in f64, cast to each moment's dtype as optax
        # does, so it never rounds to 0 for a low-precision moment
        c = count.double()
        bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state.nu)

        def leaf(m, v, p):
            u = (m / bc1.to(m.dtype)) / (
                torch.sqrt(v / bc2.to(v.dtype) + eps_root) + eps)
            return -learning_rate * (u + weight_decay * p)
        return tree_map(leaf, mu, nu, params), \
            ScaleByAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    """``optax.sgd``: ``trace(momentum, nesterov)`` when ``momentum`` is
    given, then ``scale_by_learning_rate``."""
    def init(params):
        return () if momentum is None else TraceState(trace=_zeros(params))

    def update(grads, state, params=None):
        if momentum is None:
            return tree_map(lambda g: -learning_rate * g, grads), state
        trace = tree_map(lambda g, t: g + momentum * t, grads, state.trace)
        direction = tree_map(lambda g, t: g + momentum * t, grads, trace) \
            if nesterov else trace
        return tree_map(lambda g: -learning_rate * g, direction), \
            TraceState(trace=trace)

    return GradientTransformation(init, update)
