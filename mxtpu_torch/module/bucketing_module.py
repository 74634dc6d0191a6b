"""BucketingModule: variable-length training through one Module per
bucket key over shared parameters — the port of
``mxtpu/module/bucketing_module.py`` (reference
``python/mxnet/module/bucketing_module.py``). Switching buckets copies
the parameters through from the active module, and every bucket's
module shares one updater, as the reference's shared-module binding
does.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, **kwargs):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._kwargs = kwargs
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._opt_config = None

    def _gen_module(self, bucket_key):
        if bucket_key in self._buckets:
            return self._buckets[bucket_key]
        sym, data_names, label_names = self._sym_gen(bucket_key)
        mod = Module(sym, data_names=data_names, label_names=label_names,
                     logger=self.logger, context=self._context,
                     **self._kwargs)
        self._buckets[bucket_key] = mod
        return mod

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        self.for_training = for_training
        self._inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training,
                 inputs_need_grad, force_rebind, grad_req)
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.symbol = mod.symbol
        self.binded = True

    def init_params(self, **kwargs):
        assert self.binded
        self._curr_module.init_params(**kwargs)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._opt_config = (kvstore, optimizer, optimizer_params)
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params, force_init)
        self.optimizer_initialized = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Switch the active bucket, sharing params from the current one
        (the reference's shared_module binding)."""
        assert self.binded
        prev = self._curr_module
        mod = self._gen_module(bucket_key)
        if not mod.binded:
            mod.bind(data_shapes, label_shapes, self.for_training,
                     inputs_need_grad=self._inputs_need_grad,
                     grad_req=self._grad_req)
            arg_params, aux_params = prev.get_params()
            mod.init_params(arg_params=arg_params, aux_params=aux_params,
                            allow_missing=False, force_init=True)
            if self._opt_config is not None:
                mod.init_optimizer(*self._opt_config)
                mod._updater = prev._updater    # shared optimizer state
        else:
            # refresh shared params from the previously-active bucket
            arg_params, aux_params = prev.get_params()
            mod.set_params(arg_params, aux_params)
        self._curr_module = mod
        self._curr_bucket_key = bucket_key
        self.symbol = mod.symbol

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", None)
        if key is None:
            key = self._curr_bucket_key
        if key != self._curr_bucket_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs()

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params, **kwargs):
        self._curr_module.set_params(arg_params, aux_params, **kwargs)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)
