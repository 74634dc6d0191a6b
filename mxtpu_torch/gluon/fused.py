"""The one-program train step of a Gluon HybridBlock — the port of
``mxtpu/gluon/fused.py``.

``Trainer.make_fused_step(net)`` runs forward, loss, backward and the
optimizer update of a ``net.shard(mesh, rules)``-ed block as one
program. In the reference that is one donated XLA program; here, on
the card, it is one CUDA graph per input signature (the batch's shapes
and dtypes): the signature's first call runs the step eagerly on a side
stream (the capture's warm-up) and then captures it; later calls
replay it. So the first step is the CPU's, and a dtype the first step
settles (BatchNorm's statistics in a low-precision net) is settled
before the capture:

- the step owns its tensors: the parameters (the live ``Parameter``s
  are bound to them, so ``param.data()``, ``save_parameters`` and a
  predict-mode replay read the trained weights), the optimizer state,
  the dynamic-AMP state, and static buffers for the batch, the key,
  lr, wd, rescale and the schedule position ``t``. Each call copies
  the batch and the key into their buffers and fills the scalars, so
  ``trainer.set_learning_rate``, schedulers and ``wd`` edits never
  recapture; the graph updates parameters and state in place. A
  parameter rebound between steps (``set_data``, a load) is copied in
  before the next replay.
- a capture that fails raises; there is no eager fallback. Each
  capture runs inside ``watcher.build("fused_step")`` and counts in
  ``num_compiles()``.

On the CPU the same step body runs eagerly, once per call.

The update rules are pure functions of (w, g, state) and 0-d tensors
lr, wd, rescale and t, one per optimizer family, computing the
reference's ``_pure_*`` ops in the same order. With dynamic AMP
(float16) the loss is scaled, the overflow decision, the skipped
update and the halve/grow policy run inside the step, and the
Adam-family ``t`` counts applied updates (the classic path counts
attempts). ``grad_accum=n`` runs n microbatches in order, threading
BatchNorm's running statistics through them, and folds the step's key
per microbatch. An optimizer with ``multi_precision`` keeps float32
master weights of float16/bfloat16 parameters in its state, as the
classic Trainer does.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch

from .. import autograd
from .. import optimizer as opt_mod
from .. import prng
from ..amp.loss_scaler import MAX_LOSS_SCALE
from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray import random as _random
from ..parallel.mesh import use_mesh
from .block import _TRACE_DEPTH, _graphs_on, capture_graph

__all__ = ["make_fused_step"]


# ---------------------------------------------------------------------------
# pure update rules: (opt, t, w, g, state, lr, wd, rescale) -> (w', state').
# t, lr, wd and rescale are 0-d tensors; each rule computes the
# reference's ops in its order.
# ---------------------------------------------------------------------------
def _clipped(opt, g, rescale):
    g = g * rescale
    if opt.clip_gradient is not None:
        g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
    return g


def _pure_sgd(opt, t, w, g, state, lr, wd, rescale):
    g = _clipped(opt, g, rescale) + wd * w
    if opt.momentum == 0.0:
        return w - lr * g, state
    mom = opt.momentum * state - lr * g
    return w + mom, mom


def _pure_nag(opt, t, w, g, state, lr, wd, rescale):
    g = _clipped(opt, g, rescale) + wd * w
    if opt.momentum == 0.0:
        return w - lr * g, state
    mom = opt.momentum * state + g
    return w - lr * (g + opt.momentum * mom), mom


def _pow(base: float, tf: torch.Tensor) -> torch.Tensor:
    return torch.pow(float(base), tf)


def _pure_adam(opt, t, w, g, state, lr, wd, rescale):
    tf = t.to(torch.float32)
    lr_t = lr * torch.sqrt(1.0 - _pow(opt.beta2, tf)) / \
        (1.0 - _pow(opt.beta1, tf))
    m, v = state
    g = _clipped(opt, g, rescale) + wd * w
    m = opt.beta1 * m + (1 - opt.beta1) * g
    v = opt.beta2 * v + (1 - opt.beta2) * torch.square(g)
    return w - lr_t * m / (torch.sqrt(v) + opt.epsilon), (m, v)


def _pure_adamw(opt, t, w, g, state, lr, wd, rescale):
    tf = t.to(torch.float32)
    m, v = state
    g = _clipped(opt, g, rescale)
    m = opt.beta1 * m + (1 - opt.beta1) * g
    v = opt.beta2 * v + (1 - opt.beta2) * torch.square(g)
    mhat = m / (1 - _pow(opt.beta1, tf))
    vhat = v / (1 - _pow(opt.beta2, tf))
    return (w - lr * (mhat / (torch.sqrt(vhat) + opt.epsilon) + wd * w),
            (m, v))


def _pure_lamb(opt, t, w, g, state, lr, wd, rescale):
    tf = t.to(torch.float32)
    m, v = state
    g = _clipped(opt, g, rescale)
    m = opt.beta1 * m + (1 - opt.beta1) * g
    v = opt.beta2 * v + (1 - opt.beta2) * torch.square(g)
    if opt.bias_correction:
        mhat = m / (1 - _pow(opt.beta1, tf))
        vhat = v / (1 - _pow(opt.beta2, tf))
    else:
        mhat, vhat = m, v
    r = mhat / (torch.sqrt(vhat) + opt.epsilon) + wd * w
    r1 = torch.linalg.vector_norm(w)
    if opt.lower_bound is not None:
        r1 = torch.clamp_min(r1, opt.lower_bound)
    if opt.upper_bound is not None:
        r1 = torch.clamp_max(r1, opt.upper_bound)
    r2 = torch.linalg.vector_norm(r)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    return w - lr * ratio * r, (m, v)


def _pure_adagrad(opt, t, w, g, state, lr, wd, rescale):
    g = _clipped(opt, g, rescale) + wd * w
    hist = state + torch.square(g)
    return w - lr * g / torch.sqrt(hist + opt.float_stable_eps), hist


def _pure_adadelta(opt, t, w, g, state, lr, wd, rescale):
    g = _clipped(opt, g, rescale) + wd * w
    acc_g, acc_d = state
    acc_g = opt.rho * acc_g + (1 - opt.rho) * torch.square(g)
    delta = torch.sqrt(acc_d + opt.epsilon) / \
        torch.sqrt(acc_g + opt.epsilon) * g
    acc_d = opt.rho * acc_d + (1 - opt.rho) * torch.square(delta)
    return w - delta, (acc_g, acc_d)


def _pure_rmsprop(opt, t, w, g, state, lr, wd, rescale):
    g = _clipped(opt, g, rescale) + wd * w
    if not opt.centered:
        n = (1 - opt.gamma1) * torch.square(g) + opt.gamma1 * state
        new_w = w - lr * g / torch.sqrt(n + opt.epsilon)
        state = n
    else:
        n, gm, delta = state
        n = (1 - opt.gamma1) * torch.square(g) + opt.gamma1 * n
        gm = (1 - opt.gamma1) * g + opt.gamma1 * gm
        delta = opt.gamma2 * delta - \
            lr * g / torch.sqrt(n - torch.square(gm) + opt.epsilon)
        new_w = w + delta
        state = (n, gm, delta)
    if opt.clip_weights:
        new_w = torch.clamp(new_w, -opt.clip_weights, opt.clip_weights)
    return new_w, state


def _pure_ftrl(opt, t, w, g, state, lr, wd, rescale):
    g = _clipped(opt, g, rescale)        # Ftrl applies wd in the closed
    z, n = state                         # form below, not on the grad
    sigma = (torch.sqrt(n + torch.square(g)) - torch.sqrt(n)) / lr
    z = z + g - sigma * w
    n = n + torch.square(g)
    shrunk = -(z - torch.sign(z) * opt.lamda1) / \
        ((opt.beta + torch.sqrt(n)) / lr + wd)
    new_w = torch.where(torch.abs(z) > opt.lamda1, shrunk,
                        torch.zeros_like(shrunk)).to(w.dtype)
    return new_w, (z, n)


def _pure_signum(opt, t, w, g, state, lr, wd, rescale):
    if state is not None:
        g = _clipped(opt, g, rescale) + wd * w
        mom = opt.momentum * state - (1 - opt.momentum) * g
        return (1 - lr * opt.wd_lh) * w + lr * torch.sign(mom), mom
    g = g * rescale + wd * w
    return (1 - lr * opt.wd_lh) * w - lr * torch.sign(g), state


def _pure_sgld(opt, t, w, g, state, lr, wd, rescale, key):
    """SGLD: a gradient half-step plus N(0, lr) noise drawn from the
    step's key folded per parameter (the one rule that takes a key)."""
    g = _clipped(opt, g, rescale) + wd * w
    noise = prng.normal(key, tuple(w.shape), torch.float32).to(w.dtype) \
        * torch.sqrt(lr)
    return w - lr / 2 * g + noise, state


_pure_sgld._needs_key = True

_PURE_UPDATES: Dict[type, Callable] = {
    opt_mod.SGD: _pure_sgd,
    opt_mod.NAG: _pure_nag,
    opt_mod.AdamW: _pure_adamw,
    opt_mod.Adam: _pure_adam,
    opt_mod.LAMB: _pure_lamb,
    opt_mod.AdaGrad: _pure_adagrad,
    opt_mod.AdaDelta: _pure_adadelta,
    opt_mod.RMSProp: _pure_rmsprop,
    opt_mod.Ftrl: _pure_ftrl,
    opt_mod.Signum: _pure_signum,
    opt_mod.SGLD: _pure_sgld,
}


def _pure_update_for(optimizer):
    # the MRO walk resolves AdamW (an Adam subclass) to its own rule
    for cls in type(optimizer).__mro__:
        fn = _PURE_UPDATES.get(cls)
        if fn is not None:
            return fn
    raise MXNetError(
        "make_fused_step supports "
        f"{[c.__name__ for c in _PURE_UPDATES]} optimizers, got "
        f"{type(optimizer).__name__}; use the classic Trainer.step "
        "path or register a pure rule in _PURE_UPDATES")


def _state_width(optimizer):
    """Zero buffers per parameter in this family's state (None:
    stateless), as each ``create_state`` makes them."""
    if isinstance(optimizer, (opt_mod.AdaDelta, opt_mod.Ftrl,
                              opt_mod.LAMB, opt_mod.Adam)):
        return 2
    if isinstance(optimizer, opt_mod.RMSProp):
        return 3 if optimizer.centered else 1
    if isinstance(optimizer, opt_mod.AdaGrad):
        return 1
    if getattr(optimizer, "momentum", 0.0):     # SGD/NAG/Signum
        return 1
    return None


_LOW = (torch.float16, torch.bfloat16)


def _is_master(optimizer, w: torch.Tensor) -> bool:
    """Whether ``w``'s state carries a float32 master copy."""
    return bool(optimizer.multi_precision) and w.dtype in _LOW


def _init_opt_state(optimizer, w: torch.Tensor):
    """One parameter's optimizer state, zeroed on its device: None, a
    tensor, a tuple, or (master, inner) under multi-precision."""
    master = _is_master(optimizer, w)
    like = w.to(torch.float32) if master else w
    width = _state_width(optimizer)
    if width is None:
        inner = None
    elif width == 1:
        inner = torch.zeros_like(like)
    else:
        inner = tuple(torch.zeros_like(like) for _ in range(width))
    return (like.clone(), inner) if master else inner


def _leaves(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in _leaves(t)]


def _map2(fn, a, b):
    """``fn`` over the leaves of two trees of one structure."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    return tuple(_map2(fn, x, y) for x, y in zip(a, b))


class _Static:
    """The tensors a step owns: what a captured graph reads and
    updates in place."""

    __slots__ = ("live", "frozen", "states", "amp", "hyper", "key")


class _Variant:
    """One input signature's batch buffers, loss output and graph."""

    __slots__ = ("batch", "loss", "graph")


def make_fused_step(trainer, net, loss_fn: Optional[Callable] = None,
                    grad_accum: int = 1, loss_args: int = 0):
    """Build ``step(*batch) -> loss``: one train step of ``net`` as one
    program (one CUDA graph per input signature on the card).

    - ``net`` must be initialized and ``shard(mesh, rules)``-ed.
    - ``loss_fn(out..., *extras) -> scalar NDArray`` maps the net's
      output to the loss; None means the output is the loss.
    - ``grad_accum=n`` splits every batch arg's leading dim into n
      microbatches; the loss returned is their mean.
    - ``loss_args=k``: the last k batch args go to ``loss_fn``, not to
      the net (targets that microbatch with the data).
    - ``step.num_compiles()`` counts built variants (captures on the
      card), ``step.state_dict()``/``load_state_dict()`` carry what a
      resume needs, ``step.loss_scale()`` and ``step.applied_updates()``
      read the AMP state.

    ``amp.init_trainer`` must run before ``make_fused_step``; a scaler
    attached afterwards raises at the next call.
    """
    if grad_accum < 1:
        raise MXNetError(f"grad_accum must be >= 1, got {grad_accum}")
    if loss_args < 0:
        raise MXNetError(f"loss_args must be >= 0, got {loss_args}")
    if loss_args and loss_fn is None:
        raise MXNetError("loss_args needs a loss_fn to receive them")
    mesh = getattr(net, "_mesh", None)
    if mesh is None:
        raise MXNetError("net.shard(mesh, rules) must run before "
                         "make_fused_step")
    optimizer = trainer._optimizer
    pure_update = _pure_update_for(optimizer)
    needs_key = getattr(pure_update, "_needs_key", False)
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    dynamic_amp = bool(scaler is not None and scaler.dynamic)
    params = list(trainer._params)
    for p in params:
        if p._data is None:
            raise MXNetError(f"parameter {p.name} is uninitialized; "
                             "initialize (and run one forward if shapes "
                             "defer) before net.shard/make_fused_step")
    live = [p for p in params if p.grad_req != "null"]
    frozen = [p for p in params if p.grad_req == "null"]
    device = params[0]._data._data.device

    def ints(values):
        # fold-in data as device tensors made here, never inside a capture
        return [torch.tensor(v, dtype=torch.int64, device=device)
                for v in values]

    mb_data = ints(range(grad_accum))
    noise_data = ints(1_000_000 + i for i in range(len(live))) \
        if needs_key else []

    # the step's own tensors; the Parameters are bound to them
    S = _Static()
    S.live = [p._data._data.clone() for p in live]
    S.frozen = [p._data._data.clone() for p in frozen]
    with autograd.pause():
        for p, t in zip(live + frozen, S.live + S.frozen):
            p._data._set_data(t)
    S.states = [_init_opt_state(optimizer, w) for w in S.live]
    S.hyper = {k: torch.zeros((), dtype=dt, device=device)
               for k, dt in (("lr", torch.float32), ("wd", torch.float32),
                             ("rescale", torch.float32), ("t", torch.int32))}
    S.key = torch.zeros(2, dtype=torch.int64, device=device)
    S.amp = ({"scale": torch.full((), float(scaler.loss_scale),
                                  dtype=torch.float32, device=device),
              "unskipped": torch.zeros((), dtype=torch.int32, device=device),
              "t": torch.zeros((), dtype=torch.int32, device=device)}
             if dynamic_amp else {})
    # indices (into `frozen`) of parameters the forward rebinds
    # (BatchNorm's running statistics), found by the first run
    mutated_idx: List[int] = []

    def grad_fn(live_vals, frozen_vals, batch_vals, key, scale):
        leaves = [w.detach().requires_grad_() for w in live_vals]
        for p, v in zip(live, leaves):
            p._bind(v)
        for p, v in zip(frozen, frozen_vals):
            p._bind(v)
        _random.push_trace_key(key)
        _TRACE_DEPTH.depth = getattr(_TRACE_DEPTH, "depth", 0) + 1
        try:
            with torch.enable_grad(), autograd.pause(train_mode=True):
                nds = [NDArray(b) for b in batch_vals]
                if loss_args >= len(nds):
                    raise MXNetError(
                        f"loss_args={loss_args} but only {len(nds)} batch "
                        "args were passed — nothing left for the net")
                net_in = nds[:-loss_args] if loss_args else nds
                extras = nds[-loss_args:] if loss_args else []
                out = net(*net_in)
                if loss_fn is not None:
                    out = loss_fn(*out, *extras) if isinstance(out, tuple) \
                        else loss_fn(out, *extras)
        finally:
            _TRACE_DEPTH.depth -= 1
            _random.pop_trace_key()
            for p in live:
                p._unbind()
            new_frozen = [p._unbind() for p in frozen]
        mutated_idx[:] = [i for i, (v, nv) in
                          enumerate(zip(frozen_vals, new_frozen))
                          if nv is not v]
        aux = [new_frozen[i].detach() for i in mutated_idx]
        loss = out._data if isinstance(out, NDArray) else out
        if loss.ndim != 0:
            raise MXNetError(
                "fused step needs a SCALAR loss; got shape "
                f"{tuple(loss.shape)} — reduce (e.g. .mean()) in loss_fn")
        # differentiate the scaled loss (AMP); the caller sees the true one
        target = loss * scale if scale is not None else loss
        grads = torch.autograd.grad(target, leaves, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(live_vals, grads)]
        return loss.detach(), aux, grads

    def body(batch_vals):
        """The step on S's tensors; returns the loss. Each parameter's
        new value and state go into S as soon as they are computed (one
        parameter's temporaries are alive at a time), then the AMP state
        and BatchNorm's statistics."""
        scale = S.amp["scale"] if dynamic_amp else None
        key = S.key
        if grad_accum == 1:
            loss, aux, grads = grad_fn(S.live, S.frozen, batch_vals, key,
                                       scale)
        else:
            n = grad_accum
            mbs = [b.reshape((n, b.shape[0] // n) + tuple(b.shape[1:]))
                   for b in batch_vals]
            froz = list(S.frozen)
            loss, grads = None, None
            for i in range(n):
                # distinct dropout/noise per microbatch
                mb_key = prng.fold_in(key, mb_data[i])
                l_i, aux_i, g_i = grad_fn(S.live, froz, [m[i] for m in mbs],
                                          mb_key, scale)
                for j, v in zip(mutated_idx, aux_i):
                    froz[j] = v          # BatchNorm stats thread in order
                loss = l_i if loss is None else loss + l_i
                grads = g_i if grads is None else \
                    [a + b for a, b in zip(grads, g_i)]
                del g_i
            loss = loss / n
            grads = [g / n for g in grads]
            aux = [froz[j] for j in mutated_idx]
        hyper = S.hyper
        if dynamic_amp:
            finite = torch.stack([torch.isfinite(g).all()
                                  for g in grads]).all()
            t = S.amp["t"] + 1                  # applied-update count
            # unscale by division in float32, cast back
            grads = [(g.to(torch.float32) / scale).to(g.dtype)
                     for g in grads]
        else:
            finite, t = None, hyper["t"]
        for pi, (p, w, s) in enumerate(zip(live, S.live, S.states)):
            g, grads[pi] = grads[pi], None
            lr = hyper["lr"] * p.lr_mult
            wd = hyper["wd"] * p.wd_mult
            kargs = ((prng.fold_in(key, noise_data[pi]),) if needs_key
                     else ())
            if _is_master(optimizer, w):
                master, inner = s
                nm, ni = pure_update(optimizer, t, master,
                                     g.to(torch.float32), inner, lr, wd,
                                     hyper["rescale"], *kargs)
                nw, ns = nm.to(w.dtype), (nm, ni)
            else:
                nw, ns = pure_update(optimizer, t, w, g, s,
                                     lr.to(w.dtype), wd.to(w.dtype),
                                     hyper["rescale"].to(w.dtype), *kargs)
                nw = nw.to(w.dtype)
            if dynamic_amp:           # overflow: drop the whole update
                nw = torch.where(finite, nw, w)
                ns = _map2(lambda a, b: torch.where(finite, a, b), ns, s)
            with torch.no_grad():
                w.copy_(nw)
                for a, b in zip(_leaves(s), _leaves(ns)):
                    if a is not b:
                        a.copy_(b)
        if dynamic_amp:
            # the LossScaler policy: halve on overflow (floored), double
            # after scale_window clean steps (capped)
            zero = torch.zeros_like(S.amp["unskipped"])
            unskipped = torch.where(finite, S.amp["unskipped"] + 1, zero)
            grow = unskipped >= scaler._scale_window
            new_amp = {
                "scale": torch.where(
                    finite,
                    torch.where(grow, torch.clamp(
                        scale * scaler._scale_factor, max=MAX_LOSS_SCALE),
                        scale),
                    torch.clamp(scale / scaler._scale_factor,
                                min=scaler._min_scale)),
                "unskipped": torch.where(grow, zero, unskipped),
                "t": torch.where(finite, t, S.amp["t"])}
            for k, v in new_amp.items():
                S.amp[k].copy_(v)
        # BatchNorm's statistics take the dtype the forward gives them
        # (float32 in a low-precision net, as the classic step leaves
        # them) at their first step, which runs eagerly before any
        # capture, so a capture allocates none
        for j, v in zip(mutated_idx, aux):
            if v.dtype != S.frozen[j].dtype:
                S.frozen[j] = S.frozen[j].to(v.dtype)
                with autograd.pause():
                    frozen[j]._data._set_data(S.frozen[j])
        with torch.no_grad():
            for j, v in zip(mutated_idx, aux):
                S.frozen[j].copy_(v)
        return loss

    def run(var: _Variant) -> None:
        """The step, writing its results into S in place."""
        var.loss = body(var.batch)

    def _trace_fp():
        """Digest of the knobs the step reads as Python attributes
        (momentum, betas, clip_gradient, lr/wd mults, the scaler's
        policy): a change rebuilds. lr, wd, rescale_grad and the
        schedule ride in tensors and are left out."""
        from .trainer import opt_fingerprint
        extra = {"__mults": [(p.name, p.lr_mult, p.wd_mult)
                             for p in params]}
        if scaler is not None:
            extra["__scaler"] = (scaler.dynamic, scaler._scale_factor,
                                 scaler._scale_window, scaler._min_scale)
        return opt_fingerprint(
            optimizer, skip={"lr", "rescale_grad", "lr_scheduler", "wd"},
            extra=extra)

    def _layout():
        return (_state_width(optimizer),
                tuple(_is_master(optimizer, w) for w in S.live))

    box = {"fp": _trace_fp(), "layout": _layout(), "past_compiles": 0,
           "variants": {}}

    def _sync_params():
        """Copy parameters rebound since the last step into S."""
        for ps, ts in ((live, S.live), (frozen, S.frozen)):
            for p, t in zip(ps, ts):
                cur = p._data._data
                if cur is t:
                    continue
                if cur.shape != t.shape or cur.dtype != t.dtype:
                    raise MXNetError(
                        f"parameter {p.name} changed from {tuple(t.shape)} "
                        f"{t.dtype} to {tuple(cur.shape)} {cur.dtype} since "
                        "make_fused_step; build the step again")
                t.copy_(cur)
                with autograd.pause():
                    p._data._set_data(t)

    def step(*batch):
        """One fused train step; returns the loss NDArray."""
        if getattr(trainer, "_amp_loss_scaler", None) is not scaler:
            raise MXNetError(
                "trainer's AMP loss scaler changed after make_fused_step "
                "(amp.init_trainer called after the step was built?) — "
                "call make_fused_step again so AMP is built into the step")
        fp = _trace_fp()
        if fp != box["fp"]:
            # a hyperparameter the step reads as a constant changed:
            # rebuild, with fresh zeroed state if its structure changed
            box["past_compiles"] += len(box["variants"])
            box["variants"].clear()
            if _layout() != box["layout"]:
                box["layout"] = _layout()
                S.states[:] = [_init_opt_state(optimizer, w)
                               for w in S.live]
            box["fp"] = fp
        raw = [b._data if isinstance(b, NDArray) else torch.as_tensor(b)
               for b in batch]
        for b in raw:
            if b.shape[0] % grad_accum:
                raise MXNetError(
                    f"batch leading dim {b.shape[0]} not divisible by "
                    f"grad_accum={grad_accum}")
        _sync_params()
        # the schedule position and hyperparameters ride in tensors; with
        # dynamic AMP the applied count lives in S.amp (the host's
        # num_update counts attempts)
        for i in range(len(live)):
            optimizer._update_count(i)
        S.hyper["lr"].fill_(float(optimizer.learning_rate))
        S.hyper["wd"].fill_(float(optimizer.wd))
        S.hyper["rescale"].fill_(float(optimizer.rescale_grad))
        S.hyper["t"].fill_(int(optimizer.num_update))
        S.key.copy_(_random._next_key(device))
        if dynamic_amp:
            # the live scale and clean-step count come from the scaler,
            # so classic and fused steps on one trainer share the policy
            for k, v in (("scale", scaler.loss_scale),
                         ("unskipped", scaler._unskipped)):
                if v is not S.amp[k]:
                    if isinstance(v, torch.Tensor):
                        S.amp[k].copy_(v)
                    else:
                        S.amp[k].fill_(v)
        sig = tuple((tuple(b.shape), b.dtype) for b in raw)
        var = box["variants"].get(sig)
        graphs = _graphs_on(device)
        with use_mesh(mesh):
            if var is None:
                var = _Variant()
                var.graph = None
                box["variants"][sig] = var
                if graphs:
                    # the signature's first call: this step runs eagerly
                    # on a side stream (the capture's warm-up), then is
                    # captured, not replayed
                    var.batch = [b.to(device).clone() for b in raw]
                    eager = _Variant()
                    eager.batch = var.batch
                    var.graph = capture_graph(
                        "fused_step", functools.partial(run, var),
                        functools.partial(run, eager), device)
                    loss = eager.loss
            elif graphs:
                for static, b in zip(var.batch, raw):
                    static.copy_(b, non_blocking=True)
                var.graph.replay()
                loss = var.loss
            if not graphs:
                var.batch = [b.to(device) for b in raw]
                run(var)
                loss = var.loss
        if dynamic_amp:
            scaler._loss_scale = S.amp["scale"]
            scaler._unskipped = S.amp["unskipped"]
        return NDArray(loss.clone())

    def state_dict():
        """What a resume needs, as one tree of tensors: every parameter
        by name, each live one's optimizer state, the dynamic-AMP state,
        and the host's update counters (Adam-family bias correction
        reads them). Its structure is fixed for a net and optimizer, so
        a freshly built step's tree is the template a checkpoint
        restore fills."""
        counts = torch.tensor(
            [optimizer._index_update_count.get(i, 0)
             for i in range(len(live))], dtype=torch.int32)
        sd = {"params": {p.name: p._data._data for p in params},
              "opt": {p.name: s for p, s in zip(live, S.states)
                      if s is not None},
              "counters": {
                  "num_update": torch.tensor(optimizer.num_update,
                                             dtype=torch.int32),
                  "index_update_count": counts}}
        if dynamic_amp:
            sd["amp"] = dict(S.amp)
        return sd

    def load_state_dict(sd):
        """Write a state tree (a ``state_dict``, maybe restored from a
        checkpoint) into the parameters, the optimizer state, the AMP
        state and the host's counters. A missing or mis-shaped entry
        raises :class:`MXNetError` naming it."""
        with torch.no_grad():
            for p, t in zip(live + frozen, S.live + S.frozen):
                if p.name not in sd.get("params", {}):
                    raise MXNetError(
                        f"fused state_dict has no parameter '{p.name}' — "
                        "wrong checkpoint for this net?")
                v = torch.as_tensor(sd["params"][p.name])
                if tuple(v.shape) != tuple(t.shape):
                    raise MXNetError(
                        f"restored parameter '{p.name}' has shape "
                        f"{tuple(v.shape)} but the net expects "
                        f"{tuple(t.shape)}")
                t.copy_(v)
                with autograd.pause():
                    p._data._set_data(t)
            for p, s in zip(live, S.states):
                if s is None:
                    continue
                saved = sd.get("opt", {}).get(p.name)
                if saved is None:
                    raise MXNetError(
                        f"fused state_dict has no optimizer state for "
                        f"'{p.name}'")
                cur, got = _leaves(s), _leaves(saved)
                if len(got) != len(cur):
                    raise MXNetError(
                        f"optimizer state for '{p.name}' has {len(got)} "
                        f"leaves, expected {len(cur)}")
                for c, g in zip(cur, got):
                    if tuple(g.shape) != tuple(c.shape):
                        raise MXNetError(
                            f"optimizer state for '{p.name}' has leaf "
                            f"shape {tuple(g.shape)}, expected "
                            f"{tuple(c.shape)}")
                    c.copy_(g)
            counters = sd["counters"]
            optimizer.num_update = int(counters["num_update"])
            optimizer._index_update_count = {
                i: int(c) for i, c in
                enumerate(torch.as_tensor(
                    counters["index_update_count"]).tolist())}
            if dynamic_amp:
                for k in ("scale", "unskipped", "t"):
                    S.amp[k].copy_(torch.as_tensor(sd["amp"][k]))
                scaler._loss_scale = S.amp["scale"]
                scaler._unskipped = S.amp["unskipped"]

    step.state_dict = state_dict
    step.load_state_dict = load_state_dict
    step.num_compiles = lambda: box["past_compiles"] + len(box["variants"])
    step.loss_scale = (lambda: float(S.amp["scale"])) if dynamic_amp \
        else (lambda: float(getattr(scaler, "loss_scale", 1.0)))
    step.applied_updates = (lambda: int(S.amp["t"])) if dynamic_amp \
        else (lambda: int(optimizer.num_update))
    step._opt_states = S.states
    step._static = S
    step._box = box
    return step
