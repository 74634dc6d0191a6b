"""The training step, on one device or over a mesh — the port of
``mxtpu/parallel/step.py``.

The reference jits the whole step (forward, backward, optimizer update)
into one XLA program and donates the state so the update lands in place.
Here the step runs eagerly: ``torch.autograd.grad`` takes the grads, the
optimizer transform (``mxtpu_torch.parallel.optim``) computes the
updates, and the params are updated in place under ``torch.no_grad()``,
which is the torch analogue of donation: the state passed in is spent.

Over a mesh of a process group (:mod:`.mesh`), ``init_state`` lays the
params out by the rule table as DTensors (``shard_pytree``), and the
optimizer's per-parameter moments, made from them, take their
parameter's layout while its scalars stay plain (replicated), which is
:func:`opt_state_shardings`. The step lays the batch out on
``batch_spec(mesh)`` (on dim 1 with ``grad_accum > 1``, dim 0 being the
microbatch index), runs the loss under ``use_mesh(mesh)`` with plain
tensors taken as replicated (DTensor's ``implicit_replication``),
reduces each gradient to its parameter's layout (``redistribute``: an
all-reduce over the axes the batch splits, a reduce-scatter where the
parameter is sharded too), and updates the DTensors in place. The loss
and aux come back as plain tensors, the same on every rank. With no
mesh, or the one-device placement, the step is the one-device step.

``has_rng`` steps draw on :mod:`mxtpu_torch.prng`, the port of the
``jax.random`` key chain, so a loss that draws from its key sees the
reference's numbers.

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
from . import collectives, dist
from ._tree import (path_str, tree_flatten_with_path, tree_leaves, tree_map,
                    tree_map_with_path)
from .mesh import Mesh
from .sharding import (P, Placement, ShardingRules, batch_spec,
                       global_device_put, is_dtensor, mcon, shard_pytree,
                       spmd, to_full)

__all__ = ["TrainState", "init_state", "make_train_step", "make_eval_step",
           "opt_state_shardings"]


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


def _check(mesh, rules) -> ShardingRules:
    """The rule table (a :class:`ShardingRules` or a sequence of
    (pattern, spec) pairs), checked against the mesh: rules that place a
    parameter need one."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (create_mesh), "
                        f"not {type(mesh).__name__}")
    if rules is None:
        return ShardingRules([(r".*", P())])
    if not isinstance(rules, ShardingRules):
        rules = ShardingRules(list(rules))
    if mesh is None and any(len(tuple(s)) for _, s in rules._rules):
        raise ValueError("sharding rules that place a parameter need a "
                         "mesh; pass mesh=create_mesh(...)")
    return rules


def _on_mesh(mesh) -> bool:
    return mesh is not None and mesh.distributed


def opt_state_shardings(tx, params: Any, mesh: Mesh, rules=None):
    """The placement tree of ``tx.init(params)``: a state leaf whose path
    ends with a parameter's path and has its shape takes that
    parameter's placement; everything else (counts, scalars)
    replicates. ``init_state`` needs no table (moments made from a
    DTensor take its layout); this is the reference's for inspection."""
    rules = _check(mesh, rules)
    plist = [(tuple(str(k[0]) for k in path), tuple(leaf.shape),
              rules.spec(path_str(path)))
             for path, leaf in tree_flatten_with_path(params)]
    abstract = tx.init(tree_map(
        lambda p: torch.empty(tuple(p.shape), dtype=p.dtype, device="meta"),
        params))

    def spec_for(path, leaf):
        p = tuple(str(k[0]) for k in path)
        for ppath, pshape, pspec in plist:
            if len(p) >= len(ppath) and p[-len(ppath):] == ppath \
                    and tuple(leaf.shape) == pshape:
                return Placement(mesh, pspec)
        return Placement(mesh, P())
    return tree_map_with_path(spec_for, abstract)


def _detached_copy(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def init_state(params: Any, tx, mesh=None, rules=None,
               model_state: Any = ()) -> TrainState:
    """Copy the params and model state (the step updates the state in
    place, so the caller's tensors are never aliased), laid out by the
    rule table over a mesh, and build the optimizer state from them."""
    rules = _check(mesh, rules)
    params, model_state = _detached_copy(params), _detached_copy(model_state)
    if _on_mesh(mesh):
        params = shard_pytree(params, mesh, rules)
        if model_state != ():
            model_state = shard_pytree(model_state, mesh, rules)
    elif mesh is not None and mesh.device is not None:
        params = tree_map(lambda t: t.to(mesh.device), params)
        model_state = tree_map(lambda t: t.to(mesh.device), model_state)
    with spmd(mesh):
        state = TrainState.create(params, tx, model_state)
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
    same params tensors. Over a mesh, ``state`` comes from
    :func:`init_state` on the same mesh and rules, and the batch is the
    global batch, the same on every rank (each takes its chunk).
    """
    rules = _check(mesh, rules)
    on_mesh = _on_mesh(mesh)
    if on_mesh:
        bspec = P(None, *batch_spec(mesh)) if grad_accum > 1 \
            else batch_spec(mesh)
        bplace = Placement(mesh, bspec)
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
            if on_mesh:
                loss = mcon(mesh, loss)          # the loss, on every rank
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        if on_mesh:
            grads = [_reduce_grad(g, p) for g, p in zip(grads, leaves)]
        grads = iter(grads)
        return loss.detach(), _detach(aux), \
            tree_map(lambda _: next(grads), params)

    def step(state: TrainState, batch, rng=None):
        if on_mesh:
            batch = tree_map(lambda t: global_device_put(t, bplace)
                             if isinstance(t, torch.Tensor) else t, batch)
        with spmd(mesh):
            out = _step(state, batch, rng)
        if not on_mesh:
            return out
        new, loss, *rest = out
        return (new, to_full(loss)) + tuple(
            tree_map(lambda t: to_full(t) if is_dtensor(t) else t, r)
            for r in rest)

    def _step(state: TrainState, batch, rng=None):
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
            if on_mesh:
                updates, opt_state = _local_update(tx, grads, state)
            else:
                updates, opt_state = tx.update(grads, state.opt_state,
                                               state.params)
            params = tree_leaves(state.params)
            if not skip_nonfinite:
                for p, u in zip(params, tree_leaves(updates)):
                    # in place on the shard: both have the param's layout
                    _local(p).add_(_local(u).to(p.dtype))
                new = TrainState(state.params, opt_state, state.step + 1,
                                 mstate)
                return (new, loss, aux) if loss_has_aux else (new, loss)
            finite = _all_finite(loss, tree_leaves(grads), on_mesh)

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


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _local_update(tx, grads, state):
    """``tx.update`` on each rank's shards: every gradient, moment and
    parameter of a leaf has the parameter's layout, and the port's
    transforms (sgd, adamw) read nothing across entries. The updates and
    the new state are DTensors of the layouts they came in."""
    from torch.distributed.tensor import DTensor
    updates, opt_state = tx.update(tree_map(_local, grads),
                                   tree_map(_local, state.opt_state),
                                   tree_map(_local, state.params))

    def wrap(u, ref):
        if not is_dtensor(ref):
            return u
        return DTensor.from_local(u, ref.device_mesh, ref.placements,
                                  run_check=False, shape=ref.shape,
                                  stride=ref.stride())
    return tree_map(wrap, updates, state.params), \
        tree_map(wrap, opt_state, state.opt_state)


def _reduce_grad(g, p):
    """The gradient in its parameter's layout: the mesh's gradient
    reduction (a sum over the ranks that hold parts of it)."""
    if not is_dtensor(p):
        return g
    if tuple(g.placements) != tuple(p.placements):
        collectives.count("grad_reduce")
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def _all_finite(loss, grads, on_mesh: bool):
    """Whether the loss (None: none) and every gradient are finite, on
    every rank: each rank checks its shards, then one all-reduce (min)
    over the group, when it has more than one rank."""
    ts = grads if loss is None else [loss] + list(grads)
    finite = torch.stack([torch.isfinite(_local(t)).all() for t in ts]).all()
    if on_mesh and dist.process_count() > 1:
        import torch.distributed as tdist
        flag = finite.to(torch.int32)
        collectives.count("all_reduce")
        tdist.all_reduce(flag, op=tdist.ReduceOp.MIN)
        finite = flag.bool()
    return finite


def make_eval_step(apply_fn: Callable, mesh=None):
    """``step(params, batch) -> apply_fn(params, batch)`` without grad;
    over a mesh the batch is laid out on ``batch_spec(mesh)`` and the
    outputs come back as plain tensors, the same on every rank."""
    _check(mesh, None)
    on_mesh = _on_mesh(mesh)
    bplace = Placement(mesh, batch_spec(mesh)) if on_mesh else None

    @torch.no_grad()
    def step(params, batch):
        if not on_mesh:
            return apply_fn(params, batch)
        batch = tree_map(lambda t: global_device_put(t, bplace)
                         if isinstance(t, torch.Tensor) else t, batch)
        with spmd(mesh):
            out = apply_fn(params, batch)
        return tree_map(to_full, out)

    return step
