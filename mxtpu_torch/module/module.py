"""Module: symbolic training over a bound Executor — the port of
``mxtpu/module/module.py`` (reference ``python/mxnet/module/module.py``
and ``executor_group.py``).

The reference's DataParallelExecutorGroup sliced each batch over a GPU
list; here, as in ``mxtpu``, one executor runs the whole batch, so a
``context`` list collapses to its first entry (None: the card). The
``"local"`` and ``"device"`` kvstores are the identity, as in the
reference; a distributed one raises (ROADMAP Queue A item 11).
"""
from __future__ import annotations

import logging
from typing import Dict

from .. import initializer as _init
from .. import optimizer as _opt
from ..base import MXNetError
from ..model import save_checkpoint as _save_checkpoint
from .base_module import BaseModule

__all__ = ["Module"]


class Module(BaseModule):
    """Train/predict a Symbol (reference ``mx.mod.Module``)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        self.symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        if isinstance(context, (list, tuple)):
            context = context[0] if context else None
        self._context = context
        self._fixed_param_names = set(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        self._param_names = [n for n in arg_names
                             if n not in self._data_names and
                             n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._preload_opt_states = None

    # -- binding ------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        shapes = {}
        for desc in list(data_shapes) + list(label_shapes or []):
            shapes[desc[0]] = tuple(desc[1])
        req: Dict[str, str] = {}
        for name in self.symbol.list_arguments():
            if name in self._data_names:
                req[name] = "write" if inputs_need_grad else "null"
            elif name in self._label_names or \
                    name in self._fixed_param_names or not for_training:
                req[name] = "null"
            else:
                req[name] = grad_req
        self._exec = self.symbol.simple_bind(self._context, grad_req=req,
                                             **shapes)
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self.binded = True

    # -- parameters ----------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        assert self.binded, "call bind before init_params"
        if self.params_initialized and not force_init:
            return
        if arg_params is None and getattr(self, "_preloaded_params", None):
            arg_params, aux_params = self._preloaded_params
        initializer = initializer if initializer is not None \
            else _init.Uniform(0.01)
        if isinstance(initializer, str):
            initializer = _init.create(initializer)

        def fill(names, arrays, given, check):
            for name in names:
                arr = arrays[name]
                if given and name in given:
                    arr._set_data(given[name]._data.to(arr._data.device,
                                                       arr.dtype))
                else:
                    if check and given is not None and not allow_missing:
                        raise MXNetError(f"parameter {name} missing from "
                                         "arg_params")
                    initializer(_init.InitDesc(name), arr)
        fill(self._param_names, self._exec.arg_dict, arg_params, True)
        fill(self._aux_names, self._exec.aux_dict, aux_params, False)
        self.params_initialized = True

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params = {n: self._exec.arg_dict[n].copy()
                      for n in self._param_names}
        aux_params = {n: self._exec.aux_dict[n].copy()
                      for n in self._aux_names}
        return arg_params, aux_params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    # -- optimizer ------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        if kvstore is not None and not (isinstance(kvstore, str) and
                                        kvstore in ("local", "device")):
            from ..gluon.trainer import KVSTORE_SLICE
            raise NotImplementedError(KVSTORE_SLICE)
        if isinstance(optimizer, str):
            optimizer = _opt.create(optimizer, **dict(optimizer_params))
        self._optimizer = optimizer
        self._updater = _opt.get_updater(optimizer)
        # one executor: aggregation over a local kvstore is the identity
        self._kvstore = kvstore
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # -- computation ----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feed = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label is not None:
            feed.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        assert self.optimizer_initialized
        # the reference's per-parameter updater, in its index order
        for i, name in enumerate(self._param_names):  # mxlint: disable=MXL003
            grad = self._exec.grad_dict.get(name)
            if grad is None or self._exec.grad_req.get(name) == "null":
                continue
            self._updater(i, grad, self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            {name: lab for name, lab in zip(self._label_names, labels)},
            {name: out for name, out in
             zip(self.output_names, self._exec.outputs)})

    @property
    def output_names(self):
        return self.symbol.list_outputs()

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def data_shapes(self):
        return self._data_shapes

    # -- serialization --------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        arg_params, aux_params = self.get_params()
        _save_checkpoint(prefix, epoch, self.symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over ``prefix``'s checkpoint; its parameters load on
        the ``context`` given (None: the card)."""
        from ..model import load_checkpoint
        ctx = kwargs.get("context")
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod._preloaded_params = (args, auxs)
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
