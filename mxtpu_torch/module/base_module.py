"""BaseModule: the epoch-loop trainer contract — the port of
``mxtpu/module/base_module.py`` (reference
``python/mxnet/module/base_module.py``).

``fit()`` is the reference's symbolic training loop: bind → init params
→ init optimizer → per batch forward/backward/update and the metric,
with callbacks. The per-batch body is the bound Executor's eager
forward and backward and the optimizer's update.
"""
from __future__ import annotations

import logging
import time
from typing import List

from .. import metric as _metric


class BaseModule:
    """Abstract module: high-level (fit/score/predict) over the
    intermediate (forward/backward/update) API."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.symbol = None

    # -- to implement -------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    # -- derived high-level API ---------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """Run inference over ``eval_data``, accumulating ``eval_metric``."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(BatchEndParam(epoch, nbatch, eval_metric, locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True):
        """Forward over a whole iterator, returning concatenated outputs."""
        from .. import ndarray as nd
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        outputs_list: List[List] = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            outs = self.get_outputs()
            if batch.pad:
                outs = [o[:o.shape[0] - batch.pad] for o in outs]
            outputs_list.append(outs)
        if not outputs_list:
            return []
        if merge_batches:
            n_out = len(outputs_list[0])
            merged = [nd.concat(*[b[i] for b in outputs_list], dim=0)
                      for i in range(n_out)]
            return merged[0] if n_out == 1 else merged
        return outputs_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """The reference's training loop (Module.fit, SURVEY.md §3.3)."""
        assert num_epoch is not None, "num_epoch is required for fit"
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    for cb in _as_list(batch_end_callback):
                        cb(BatchEndParam(epoch, nbatch, eval_metric,
                                         locals()))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_params, aux_params = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params, aux_params)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)


class BatchEndParam:
    """Callback payload (reference namedtuple BatchEndParam)."""

    def __init__(self, epoch, nbatch, eval_metric, locals_=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals_


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
