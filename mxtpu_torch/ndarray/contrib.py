"""``mx.nd.contrib``: the control-flow ops and the contrib op set — the
port of ``mxtpu/ndarray/contrib.py`` (reference
``python/mxnet/ndarray/contrib.py``, ``src/operator/control_flow.cc``).

``foreach``, ``while_loop`` and ``cond`` run the user's Python bodies
eagerly, one call per step, under the port's autograd (the reference
traces them once into ``lax.scan``/``lax.cond``): gradients flow
through every step's recorded ops. ``while_loop`` evaluates ``cond``
on the host each step, stops at ``max_iterations``, and pads the
stacked step outputs with zeros to ``max_iterations`` rows, as the
reference's do; ``cond`` reads its predicate on the host and runs one
branch.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from .. import autograd
from ..base import MXNetError
from .ndarray import NDArray, apply_op, stack

__all__ = ["foreach", "while_loop", "cond", "isinf", "isnan", "isfinite"]


def _listify(x) -> Tuple[List, bool]:
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def _delistify(lst, was_list):
    return list(lst) if was_list else lst[0]


def foreach(body: Callable, data, init_states):
    """Run ``body`` over the leading axis (reference ``foreach`` op).

    ``body(data_slice, states) -> (outputs, new_states)``; returns
    (stacked outputs, final states). Differentiable."""
    datas, data_was_list = _listify(data)
    states, states_was_list = _listify(init_states)
    n_states = len(states)
    steps = datas[0].shape[0]
    per_step, out_was_list = [], True
    for t in range(steps):
        outs, new_states = body(
            _delistify([d[t] for d in datas], data_was_list),
            _delistify(states, states_was_list))
        outs_l, out_was_list = _listify(outs)
        states, _ = _listify(new_states)
        if len(states) != n_states:
            raise MXNetError(f"foreach body returned {len(states)} states, "
                             f"expected {n_states}")
        per_step.append(outs_l)
    stacked = [stack(*[s[k] for s in per_step], axis=0)
               for k in range(len(per_step[0]))] if per_step else []
    return _delistify(stacked, out_was_list), \
        _delistify(states, states_was_list)


def _truth(x) -> bool:
    """A predicate as the host reads it: every element nonzero."""
    if isinstance(x, NDArray):
        return bool(x._data.to(torch.bool).all())
    return bool(torch.as_tensor(x).to(torch.bool).all())


def while_loop(cond: Callable, func: Callable, loop_vars,
               max_iterations: int):
    """Bounded while loop (reference ``while_loop`` op): runs ``func``
    while ``cond`` holds, up to ``max_iterations``; step outputs are
    stacked and zero-padded to ``max_iterations`` rows like the
    reference's. Returns (outputs, final loop_vars). Differentiable."""
    lvars, was_list = _listify(loop_vars)
    per_step, out_was_list = [], True
    for _ in range(max_iterations):
        if not _truth(cond(*lvars)):
            break
        outs, new_vals = func(*lvars)
        outs_l, out_was_list = _listify(outs)
        lvars, _ = _listify(new_vals)
        per_step.append(outs_l)
    if per_step:
        shapes = per_step[0]
    else:
        # no step ran: the outputs' shapes come from one untaken step
        with autograd.pause():
            outs, _ = func(*lvars)
        shapes, out_was_list = _listify(outs)
    pad = max_iterations - len(per_step)
    stacked = []
    for k, like in enumerate(shapes):
        rows = [s[k] for s in per_step]
        zero = apply_op(lambda x: torch.zeros_like(x), [like],
                        "zeros_like")
        stacked.append(stack(*(rows + [zero] * pad), axis=0))
    return _delistify(stacked, out_was_list), _delistify(lvars, was_list)


def cond(pred, then_func: Callable, else_func: Callable, inputs=None):
    """Conditional (reference ``cond`` op): the predicate is read on the
    host and one branch runs. Differentiable."""
    ins, _ = _listify(inputs if inputs is not None else [])
    branch = then_func if _truth(pred) else else_func
    return branch(*ins) if ins else branch()


# re-export the registered ops (one implementation, two namespaces)
from .ops import isinf, isnan, isfinite  # noqa: E402,F401
from .contrib_ops import *  # noqa: E402,F401,F403
