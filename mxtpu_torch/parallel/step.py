"""The training step on one device — the port of
``mxtpu/parallel/step.py``.

The reference jits the whole step (forward, backward, optimizer update)
into one XLA program and donates the state so the update lands in place.
Here the step runs eagerly: ``torch.autograd.grad`` takes the grads, the
optimizer transform (``mxtpu_torch.parallel.optim``) computes the
updates, and the params are updated in place under ``torch.no_grad()``,
which is the torch analogue of donation: the state passed in is spent.

One device only: a ``mesh`` or sharding rules that place anything
raise; they come with the multi-device slice (ROADMAP Queue A item
11). ``has_rng`` steps draw on :mod:`mxtpu_torch.prng`, the port of
the ``jax.random`` key chain, so a loss that draws from its key sees
the reference's numbers.

Telemetry, as the reference's: ``init_state`` accounts the params, the
optimizer state and the model state in perfscope's HBM ledger, and the
step is a watched program (``train_step``, ``loop="train"``) whose
variants are its argument signatures: the first call of a signature
is its build, counted for the cost catalog as it runs. Every call
feeds the live MFU/MBU/goodput gauges and the ``train.step_dispatch``
span (``span_train_dispatch_ms``: the eager step's host time).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .. import prng, telemetry
from ..telemetry import perfscope, watcher
from ._tree import tree_leaves, tree_map

__all__ = ["TrainState", "init_state", "make_train_step", "make_eval_step"]


class TrainState(NamedTuple):
    """Params, optimizer state, step count (an int32 tensor) and the
    non-differentiable model state (e.g. BatchNorm running stats)."""
    params: Any
    opt_state: Any
    step: Any
    model_state: Any = ()

    @classmethod
    def create(cls, params: Any, tx, model_state: Any = ()) -> "TrainState":
        device = tree_leaves(params)[0].device
        return cls(params=params, opt_state=tx.init(params),
                   step=torch.zeros((), dtype=torch.int32, device=device),
                   model_state=model_state)


def _one_device(mesh, rules) -> None:
    """Raise unless the placement asked for is one device: no mesh, and
    rules (a sequence of (pattern, spec) pairs) that replicate all."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh sharding comes with the multi-device slice (ROADMAP "
            "Queue A item 11); pass mesh=None")
    if rules is None:
        return
    if not isinstance(rules, (list, tuple)) or any(
            len(tuple(spec)) for _, spec in rules):
        raise NotImplementedError(
            "sharding rules that place a parameter come with the "
            "multi-device slice (ROADMAP Queue A item 11); pass rules=None "
            "or only replicated (empty) specs")


def _detached_copy(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def init_state(params: Any, tx, mesh=None, rules=None,
               model_state: Any = ()) -> TrainState:
    """Copy the params and model state (the step updates the state in
    place, so the caller's tensors are never aliased) and build the
    optimizer state on their device."""
    _one_device(mesh, rules)
    state = TrainState.create(_detached_copy(params), tx,
                              _detached_copy(model_state))
    # the HBM ledger: the training state's footprint (one trainer per
    # process is the deployed shape, so fixed names last-write-win)
    led = perfscope.ledger()
    led.account_tree("params", state.params, name="train")
    led.account_tree("optimizer", state.opt_state, name="train")
    if state.model_state != ():
        led.account_tree("workspace", state.model_state,
                         name="train_model_state")
    return state


def _detach(tree):
    return tree_map(
        lambda t: t.detach() if isinstance(t, torch.Tensor) else t, tree)


def make_train_step(loss_fn: Callable[..., Any], tx, mesh=None, rules=None,
                    has_rng: bool = False, grad_accum: int = 1,
                    loss_has_aux: bool = False, has_state: bool = False,
                    skip_nonfinite: bool = False):
    """Build ``step(state, batch, rng=None) -> (state, loss[, aux][,
    skipped])``.

    ``loss_fn(params, batch) -> loss`` (or ``(loss, aux)`` with
    ``loss_has_aux``); with ``has_state``, ``loss_fn(params,
    model_state, batch) -> (loss, new_model_state)`` and the model state
    threads through ``TrainState.model_state``. With ``has_rng`` the
    loss takes the step's key last: ``loss_fn(params, batch, rng)`` or
    ``loss_fn(params, model_state, batch, rng)``. ``tx`` is a
    :class:`~mxtpu_torch.parallel.optim.GradientTransformation`.

    ``grad_accum > 1`` takes a batch with a leading microbatch dim and
    averages loss and grads over it (``aux`` comes back stacked on that
    dim); microbatch i draws on ``prng.fold_in(rng, i)``, so each has
    its own noise. ``skip_nonfinite=True``: a step whose loss or any
    grad leaf is inf/nan applies no update — params, opt state, model
    state and the step count keep their values, selected with
    ``torch.where`` on the device (no host sync) — and the step returns
    a trailing ``skipped`` bool tensor. The state passed in is updated
    in place and must not be used again; the returned state holds the
    same params tensors.
    """
    _one_device(mesh, rules)
    if has_state and loss_has_aux:
        raise ValueError("has_state already uses the aux slot for "
                         "model_state; fold extra aux into it")
    has_aux = loss_has_aux or has_state

    def grad_fn(params, batch, mstate, rng):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        args = ((live, mstate, batch) if has_state else (live, batch)) \
            + ((rng,) if has_rng else ())
        with torch.enable_grad():
            out = loss_fn(*args)
            loss, aux = out if has_aux else (out, None)
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = iter([torch.zeros_like(p) if g is None else g
                      for g, p in zip(grads, leaves)])
        return loss.detach(), _detach(aux), \
            tree_map(lambda _: next(grads), params)

    def step(state: TrainState, batch, rng=None):
        mstate = state.model_state
        if grad_accum > 1:
            loss, grads, auxes = 0.0, None, []
            for i in range(grad_accum):
                mb = tree_map(lambda t: t[i], batch)
                mb_rng = None if rng is None else prng.fold_in(rng, i)
                mb_loss, aux, mb_grads = grad_fn(state.params, mb, mstate,
                                                 mb_rng)
                if has_state:
                    mstate, aux = aux, 0.0
                loss = loss + mb_loss
                grads = mb_grads if grads is None else tree_map(
                    torch.add, grads, mb_grads)
                auxes.append(aux)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
            aux = tree_map(lambda *xs: torch.stack(xs), *auxes) \
                if loss_has_aux else None
        else:
            loss, aux, grads = grad_fn(state.params, batch, mstate, rng)
            if has_state:
                mstate, aux = aux, None

        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
            params = tree_leaves(state.params)
            if not skip_nonfinite:
                for p, u in zip(params, tree_leaves(updates)):
                    p.add_(u.to(p.dtype))
                new = TrainState(state.params, opt_state, state.step + 1,
                                 mstate)
                return (new, loss, aux) if loss_has_aux else (new, loss)
            finite = torch.isfinite(loss)
            for g in tree_leaves(grads):
                finite = finite & torch.isfinite(g).all()

            def sel(new_v, old_v):
                return torch.where(finite, new_v, old_v)
            for p, u in zip(params, tree_leaves(updates)):
                p.copy_(sel(p + u.to(p.dtype), p))
            new = TrainState(state.params,
                             tree_map(sel, opt_state, state.opt_state),
                             state.step + finite.to(torch.int32),
                             tree_map(sel, mstate, state.model_state))
        if loss_has_aux:
            return new, loss, aux, ~finite
        return new, loss, ~finite

    telemetry.install_compile_listener()
    # watched: each new signature is counted as it runs (program_flops/
    # bytes → roofline class) and every call feeds the live MFU/goodput
    # gauges + step-anomaly detector. expected=None — one step fn may
    # legally run over several shapes
    watched = telemetry.watch(
        watcher.Program(step, "train_step",
                        key=lambda *a, **k: watcher.describe_args(a, k)),
        "train_step", expected=None, loop="train")
    dispatch_span = telemetry.span_factory("train.step_dispatch",
                                           "train_dispatch")

    def dispatch(state: TrainState, batch, rng=None):
        with dispatch_span():
            return watched(state, batch, rng)

    return dispatch


def make_eval_step(apply_fn: Callable, mesh=None):
    """``step(params, batch) -> apply_fn(params, batch)`` without grad."""
    _one_device(mesh, None)

    @torch.no_grad()
    def step(params, batch):
        return apply_fn(params, batch)

    return step
