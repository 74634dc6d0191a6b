"""Evaluation metrics — the port of ``mxtpu/metric.py`` (reference
``python/mxnet/metric.py``).

Host numpy arithmetic, as the reference's: ``update(labels, preds)``
copies each array to the host (the one per-batch sync the reference's
docs allow) and accumulates; ``get()`` returns (name, value), the
reference's values for the same arrays.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as _np

from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MAE", "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
           "Perplexity", "PearsonCorrelation", "Loss", "CustomMetric",
           "create", "np"]

_METRIC_REGISTRY: Dict[str, type] = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs) -> "EvalMetric":
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    name = str(metric).lower()
    aliases = {"acc": "accuracy", "ce": "crossentropy",
               "nll_loss": "negativeloglikelihood",
               "top_k_accuracy": "topkaccuracy", "top_k_acc": "topkaccuracy",
               "pearsonr": "pearsoncorrelation"}
    name = aliases.get(name, name)
    if name not in _METRIC_REGISTRY:
        raise ValueError(f"unknown metric {metric!r}")
    return _METRIC_REGISTRY[name](*args, **kwargs)


def _as_numpy(x) -> _np.ndarray:
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


def _listify(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class EvalMetric:
    def __init__(self, name: str, output_names=None, label_names=None,
                 **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        # upstream's text; mxtpu's zip(*...) raises on every metric
        return f"EvalMetric: {dict(self.get_name_value())}"

    def reset(self) -> None:
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds) -> None:
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def update_dict(self, label: Dict, pred: Dict) -> None:
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric) -> None:
        self.metrics.append(create(metric))

    def get_metric(self, index: int):
        return self.metrics[index]

    def reset(self) -> None:
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds) -> None:
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            name, value = m.get()
            names.extend(_listify(name))
            values.extend(_listify(value))
        return names, values


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds) -> None:
        for label, pred in zip(_listify(labels), _listify(preds)):
            pred = _as_numpy(pred)
            label = _as_numpy(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype("int32").reshape(-1)
            label = label.astype("int32").reshape(-1)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names)
        self.top_k = top_k

    def update(self, labels, preds) -> None:
        for label, pred in zip(_listify(labels), _listify(preds)):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype("int32").reshape(-1)
            topk = _np.argsort(pred, axis=-1)[:, -self.top_k:]
            for j in range(self.top_k):
                self.sum_metric += float((topk[:, j] == label).sum())
            self.num_inst += len(label)


@register
class F1(EvalMetric):
    """Binary F1 (reference behavior: preds are class-1 probabilities or
    2-col scores; average='macro'|'micro')."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self._tp = self._fp = self._fn = 0.0
        self._scores: List[float] = []
        super().__init__(name, output_names, label_names)

    def reset(self) -> None:
        super().reset()
        self._tp = self._fp = self._fn = 0.0
        self._scores = []

    def update(self, labels, preds) -> None:
        for label, pred in zip(_listify(labels), _listify(preds)):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype("int32").reshape(-1)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred_cls = pred.argmax(axis=-1).reshape(-1)
            else:
                pred_cls = (pred.reshape(-1) > 0.5).astype("int32")
            tp = float(((pred_cls == 1) & (label == 1)).sum())
            fp = float(((pred_cls == 1) & (label == 0)).sum())
            fn = float(((pred_cls == 0) & (label == 1)).sum())
            if self.average == "macro":
                prec = tp / (tp + fp) if tp + fp else 0.0
                rec = tp / (tp + fn) if tp + fn else 0.0
                f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
                self._scores.append(f1)
            else:
                self._tp += tp
                self._fp += fp
                self._fn += fn
            self.num_inst += 1

    def get(self):
        if self.average == "macro":
            if not self._scores:
                return self.name, float("nan")
            return self.name, sum(self._scores) / len(self._scores)
        prec = self._tp / (self._tp + self._fp) if self._tp + self._fp else 0.0
        rec = self._tp / (self._tp + self._fn) if self._tp + self._fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        return self.name, f1


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds) -> None:
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if label.shape != pred.shape:
                label = label.reshape(pred.shape)
            self.sum_metric += float(_np.abs(label - pred).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds) -> None:
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if label.shape != pred.shape:
                label = label.reshape(pred.shape)
            self.sum_metric += float(((label - pred) ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.sqrt(self.sum_metric / self.num_inst)


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds) -> None:
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_numpy(label).ravel().astype("int64")
            pred = _as_numpy(pred)
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds) -> None:
        loss = 0.0
        num = 0
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_numpy(label).astype("int64")
            pred = _as_numpy(pred)
            flat_label = label.ravel()
            pred = pred.reshape(-1, pred.shape[-1])
            prob = pred[_np.arange(flat_label.shape[0]), flat_label]
            if self.ignore_label is not None:
                ignore = (flat_label == self.ignore_label)
                prob = prob[~ignore]
            loss += float(-_np.log(_np.maximum(prob, 1e-10)).sum())
            num += prob.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.exp(self.sum_metric / self.num_inst)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds) -> None:
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred).ravel()
            self.sum_metric += float(_np.corrcoef(pred, label)[0, 1])
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Mean of raw loss values (reference ``mx.metric.Loss``)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds) -> None:
        for pred in _listify(preds):
            loss = _as_numpy(pred)
            self.sum_metric += float(loss.sum())
            self.num_inst += loss.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds) -> None:
        for label, pred in zip(_listify(labels), _listify(preds)):
            reval = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(reval, tuple):
                num, value = reval
                self.sum_metric += value
                self.num_inst += num
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (reference ``mx.metric.np``)."""
    return CustomMetric(numpy_feval, name, allow_extra_outputs)
