"""Gluon Trainer — the port of ``mxtpu/gluon/trainer.py`` (reference
``python/mxnet/gluon/trainer.py``).

Applies an Optimizer to a set of Parameters each step. A parameter is
one array on one device, so ``allreduce_grads`` has nothing to reduce
in one process (``kvstore="device"``, ``"local"`` or None). The
multi-tensor update (``Optimizer.fused_step``: SGD's and Adam's
``torch._foreach_*`` sequence) serves every live parameter at once; the
other rules update one parameter at a time. With ``amp.init_trainer``
a float16 step whose gradients overflowed is skipped and the loss
scale shrinks. ``make_fused_step`` builds the one-program step of
``gluon/fused.py``.

A distributed or ``tpu_sync`` kvstore, or a kvstore object, waits for
the multi-device slice (ROADMAP Queue A item 11) and raises.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Union

from .. import optimizer as opt
from ..base import MXNetError, atomic_write
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer", "opt_fingerprint"]

KVSTORE_SLICE = ("a distributed kvstore comes with the multi-device slice "
                 "(ROADMAP Queue A item 11); use kvstore='device' or None")

# attributes that change every step and never enter a fingerprint
_FP_BASE_SKIP = frozenset({"_index_update_count", "num_update",
                           "param_dict"})


def opt_fingerprint(optimizer, skip=frozenset(), extra=None) -> bytes:
    """sha1 over an optimizer's hyperparameters: its pickled attribute
    dict less the per-step update state (and ``skip``), with ``extra``
    mixed in (reference ``trainer.opt_fingerprint``). Attributes that do
    not pickle fall back to a coarser digest over the plain-typed ones,
    which never changes from step to step."""
    import hashlib
    keys = _FP_BASE_SKIP | set(skip)
    d = {k: v for k, v in vars(optimizer).items() if k not in keys}
    if extra:
        d.update(extra)
    try:
        blob = pickle.dumps(sorted(d.items()), protocol=4)
    except Exception:
        blob = repr(sorted(
            (k, v) for k, v in d.items()
            if isinstance(v, (int, float, str, bool, type(None))))).encode()
    return hashlib.sha1(blob).digest()


class Trainer:
    def __init__(self, params, optimizer,
                 optimizer_params: Optional[Dict] = None,
                 kvstore: Union[str, Any] = "device",
                 compression_params=None, update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a ParameterDict/dict/list")
        if kvstore is not None and not (isinstance(kvstore, str) and
                                        kvstore in ("device", "local")):
            raise NotImplementedError(KVSTORE_SLICE)
        self._params: List[Parameter] = []
        self._param2idx: Dict[str, int] = {}
        for i, p in enumerate(params):
            if not isinstance(p, Parameter):
                raise ValueError(f"expected Parameter, got {type(p)}")
            self._param2idx[p.name] = i
            self._params.append(p)
        self._scale = 1.0
        optimizer_params = optimizer_params or {}
        param_dict = {i: p for i, p in enumerate(self._params)}
        self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                     **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]
        self._kvstore_type = kvstore
        self._compression_params = compression_params

    @property
    def learning_rate(self) -> float:
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr: float) -> None:
        self._optimizer.learning_rate = lr

    def step(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        """Rescale grads by 1/batch_size, reduce, and update parameters.

        With AMP attached (``amp.init_trainer``), a float16 step whose
        gradients overflowed skips the update and shrinks the loss
        scale (the reference's dynamic loss scaling)."""
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None and scaler.dynamic:
            if getattr(self, "_amp_unscaled", False):
                # amp.unscale() already decided, and updated the scale
                overflow = not getattr(self, "_amp_last_finite", True)
            else:
                grads = [p.grad() for p in self._params
                         if p.grad_req != "null" and p._data is not None]
                overflow = not scaler.is_finite(grads)
                scaler.update_scale(overflow)
            if overflow:
                # drop this update; scale_loss takes the smaller scale
                # at the next backward
                self._scale = self._amp_original_scale
                self._amp_unscaled = False
                return
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)
        if scaler is not None:
            self._scale = self._amp_original_scale
            self._amp_unscaled = False

    def allreduce_grads(self) -> None:
        """One process and one device: every gradient is already whole."""

    def update(self, batch_size: int,
               ignore_stale_grad: bool = False) -> None:
        self._optimizer.rescale_grad = self._scale / batch_size
        updater = self._updaters[0]
        live = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if p._data is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"parameter {p.name} not initialized before step()")
            live.append((i, p))
        # the multi-tensor path (the reference's multi_sgd/multi-adam
        # program); an optimizer without one updates per parameter
        fused = getattr(self._optimizer, "fused_step", None)
        if fused is not None and live:
            for i, p in live:
                if i not in updater.states:
                    updater.states[i] = \
                        self._optimizer.create_state_multi_precision(
                            i, p.data())
            if fused([i for i, _ in live],
                     [p.data() for _, p in live],
                     [p.grad() for _, p in live],
                     [updater.states[i] for i, _ in live]):
                return
        # the fallback when the optimizer has no fused step: one
        # dispatch per parameter, what make_fused_step removes
        for i, p in live:  # mxlint: disable=MXL003
            updater(i, p.grad(), p.data())

    def make_fused_step(self, net, loss_fn=None, grad_accum=1,
                        loss_args=0):
        """The one-program train step for a ``net.shard(mesh, rules)``-ed
        HybridBlock: forward, loss, backward and the optimizer update,
        one CUDA graph on the card (see ``mxtpu_torch.gluon.fused``).
        ``grad_accum=n`` splits the batch into n microbatches inside the
        step; ``loss_args=k`` routes the last k batch args to
        ``loss_fn`` instead of the net."""
        from .fused import make_fused_step
        return make_fused_step(self, net, loss_fn, grad_accum=grad_accum,
                               loss_args=loss_args)

    def zero_grad(self) -> None:
        for p in self._params:
            p.zero_grad()

    # -- optimizer-state checkpointing (reference save_states/load_states) --
    def save_states(self, fname: str) -> None:
        """Write the optimizer states atomically (a temporary file, then
        a rename): a kill mid-write leaves the previous file whole."""
        atomic_write(fname, self._updaters[0].get_states(
            dump_optimizer=False))

    def load_states(self, fname: str) -> None:
        """Load optimizer states saved by :meth:`save_states`,
        validating them against this Trainer's parameters first: an
        unknown parameter index, or a state whose shape disagrees with
        its parameter's, raises :class:`MXNetError` naming it."""
        with open(fname, "rb") as f:
            blob = f.read()
        obj = pickle.loads(blob)
        states = obj[0] if (isinstance(obj, tuple) and len(obj) == 2
                            and isinstance(obj[1], opt.Optimizer)) else obj
        if not isinstance(states, dict):
            raise MXNetError(
                f"{fname!r} is not a Trainer states file "
                f"(expected a dict of per-parameter states, got "
                f"{type(states).__name__})")
        self._validate_states(states)
        self._updaters[0].set_states(blob)

    def _validate_states(self, states: Dict) -> None:
        def leaves(st):
            if isinstance(st, (tuple, list)):
                for s in st:
                    yield from leaves(s)
            elif st is not None and hasattr(st, "shape"):
                yield st
        for idx in sorted(states, key=repr):
            if not isinstance(idx, int) or \
                    not 0 <= idx < len(self._params):
                raise MXNetError(
                    f"optimizer states name parameter index {idx!r} "
                    f"which this Trainer does not have "
                    f"({len(self._params)} params)")
            p = self._params[idx]
            if p._data is None:
                continue   # uninitialized — shape unknown yet
            pshape = tuple(p.data().shape)
            for leaf in leaves(states[idx]):
                lshape = tuple(leaf.shape)
                if lshape != pshape:
                    raise MXNetError(
                        f"optimizer state for parameter '{p.name}' "
                        f"(index {idx}) has shape {lshape} but the "
                        f"parameter has shape {pshape} — the saved "
                        "states do not match this Trainer's params")
