"""Loss blocks — the port of ``mxtpu/gluon/loss.py`` (reference
``python/mxnet/gluon/loss.py``).

All losses are HybridBlocks: ``loss(pred, label[, sample_weight])`` returns
per-sample loss averaged over the batch axis per the reference's
``_apply_weighting`` + ``mean over batch_axis`` convention.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss", "CTCLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(F, pred, label):
    return F.reshape_like(label, pred)


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def _mean_all_but_batch(self, F, loss):
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = ((pred - _reshape_like(F, pred, label)) ** 2)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return self._mean_all_but_batch(F, loss)


class L1Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (pred - _reshape_like(F, pred, label)).abs()
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, pred, label)
        if not self._from_sigmoid:
            # log(1+exp(-|x|)) + max(x,0) - x*z  — numerically stable
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    F.Activation(-pred.abs(), act_type="softrelu")
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = F.relu(pred) - pred * label + log_weight * \
                    (F.Activation(-pred.abs(), act_type="softrelu") +
                     F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -((pred + eps).log() * label +
                         (1. - pred + eps).log() * (1. - label))
            else:
                loss = -((pred + eps).log() * label * pos_weight +
                         (1. - pred + eps).log() * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """CE over softmax logits (reference ``gluon.loss.SoftmaxCrossEntropyLoss``):
    sparse labels by default, dense when sparse_label=False."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, pred, label)
            loss = -(pred * label).sum(axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * ((label + 1e-12).log() - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


class HuberLoss(Loss):
    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = (pred - _reshape_like(F, pred, label)).abs()
        loss = F.where(loss > self._rho,
                       loss - 0.5 * self._rho,
                       (0.5 / self._rho) * (loss ** 2))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.relu(self._margin - pred * _reshape_like(F, pred, label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.relu(self._margin - pred * _reshape_like(F, pred, label)) ** 2
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError(f"bad label_format {label_format}")
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-pred.abs(), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = _reshape_like(F, pred, positive)
        negative = _reshape_like(F, pred, negative)
        loss = F.sum((pred - positive) ** 2 - (pred - negative) ** 2,
                     axis=self._batch_axis, exclude=True) + self._margin
        loss = F.relu(loss)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        # MXNet reshape code 0 = keep that dim
        input1 = input1.reshape((0, -1))
        input2 = input2.reshape((0, -1))
        cos = (input1 * input2).sum(axis=1) / \
            (input1.norm(axis=1) * input2.norm(axis=1) + 1e-12)
        label = label.reshape((-1,))
        pos = 1 - cos
        neg = F.relu(cos - self._margin)
        loss = F.where(label == 1, pos, neg)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification (reference
    ``gluon.loss.CTCLoss`` over warp-ctc), through ``mx.nd.ctc_loss``'s
    log-alpha recursion."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError(f"bad layout {layout}")
        batch_axis = label_layout.find("N")
        super().__init__(weight, batch_axis, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = pred.swapaxes(0, 1)
        if self._batch_axis == 1:
            label = label.swapaxes(0, 1)
        loss = F.ctc_loss(pred, label, pred_lengths, label_lengths)
        return _apply_weighting(F, loss, self._weight, sample_weight)
