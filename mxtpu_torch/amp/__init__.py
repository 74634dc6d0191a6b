"""AMP, automatic mixed precision — the port of ``mxtpu/amp`` (reference
``python/mxnet/contrib/amp/``).

The target dtype is bfloat16 by default, which shares float32's
exponent range, so its loss scale is a static 1.0; float16 gets the
dynamic :class:`LossScaler`. Casting a block's parameters is the
conversion: each op computes in its inputs' dtype. ``convert_model``
casts a Symbol's arg params the same way and leaves the Symbol as it
is.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..base import MXNetError, dtype_torch
from .loss_scaler import MAX_LOSS_SCALE, LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_hybrid_block", "convert_model", "LossScaler",
           "MAX_LOSS_SCALE", "amp_cast", "amp_multicast"]

_TARGET_DTYPE: Optional[str] = None

# layers whose parameters stay float32 (the reference's FP32 list:
# normalizations accumulate statistics)
_KEEP_FP32_BLOCKS = ("batchnorm", "layernorm", "instancenorm", "groupnorm")


def init(target_dtype: str = "bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP (reference ``amp.init``): records the target dtype
    that ``convert_hybrid_block`` and ``init_trainer`` use."""
    global _TARGET_DTYPE
    if target_dtype not in ("bfloat16", "float16"):
        raise ValueError("target_dtype must be bfloat16 or float16")
    _TARGET_DTYPE = target_dtype


def _target():
    if _TARGET_DTYPE is None:
        raise MXNetError("call amp.init() first")
    return _TARGET_DTYPE


def convert_hybrid_block(block, target_dtype: Optional[str] = None,
                         cast_optional_params: bool = False):
    """Cast a Gluon block's floating parameters to the target dtype in
    place, normalization layers excepted, and return it (reference
    ``amp.convert_hybrid_block``)."""
    target = target_dtype or _target()

    def _cast(b):
        name = type(b).__name__.lower()
        if any(k in name for k in _KEEP_FP32_BLOCKS):
            return
        for p in b._reg_params.values():
            if dtype_torch(p.dtype).is_floating_point:
                p.cast(target)
    block.apply(_cast)
    if hasattr(block, "_clear_cached_op"):
        block._clear_cached_op()
    return block


def convert_model(sym, arg_params, aux_params,
                  target_dtype: Optional[str] = None, **kwargs):
    """Symbolic conversion (reference ``amp.convert_model``): cast the
    floating arg params to the target dtype, ``gamma`` and ``beta``
    excepted; the aux params (BatchNorm statistics) and the symbol are
    returned unchanged, each op computing in its inputs' dtype."""
    target = target_dtype or _target()
    new_args = {}
    for k, v in arg_params.items():
        new_args[k] = v.astype(target) if v.dtype.is_floating_point and \
            not k.endswith(("gamma", "beta")) else v
    return sym, new_args, dict(aux_params)


def init_trainer(trainer):
    """Attach a LossScaler to a Trainer (reference ``amp.init_trainer``):
    static at 1.0 for bfloat16, dynamic from 2**16 for float16."""
    bf16 = _target() == "bfloat16"
    scaler = LossScaler(init_scale=1.0 if bf16 else 2 ** 16,
                        dynamic=not bf16)
    trainer._amp_loss_scaler = scaler
    trainer._amp_original_scale = trainer._scale
    return trainer


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``:
    scales the loss up and has ``Trainer.step`` scale the gradients
    back down (reference ``amp.scale_loss``)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("call amp.init_trainer(trainer) first")
    trainer._scale = trainer._amp_original_scale / scaler.loss_scale
    trainer._amp_unscaled = False       # fresh scaled grads incoming
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def unscale(trainer):
    """Check the gradients for inf/nan and unscale them now (reference
    ``amp.unscale``); True when they are finite. A second call before
    the step returns the first call's verdict."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("call amp.init_trainer(trainer) first")
    if getattr(trainer, "_amp_unscaled", False):
        return trainer._amp_last_finite
    if not scaler.dynamic:                 # bfloat16: fixed scale 1.0
        trainer._amp_unscaled = True
        trainer._amp_last_finite = True
        return True
    params = [p for p in trainer._params
              if p.grad_req != "null" and p._data is not None]
    grads = [p.grad() for p in params]
    # the gradients carry the scale of their backward: take it before
    # update_scale moves the scaler on to the next step's
    applied_scale = scaler.loss_scale
    finite = scaler.is_finite(grads)
    scaler.update_scale(not finite)
    if finite and applied_scale != 1.0:
        for g in grads:
            g._set_data(g._data / torch.full((), float(applied_scale),
                                             dtype=g._data.dtype,
                                             device=g._data.device))
        trainer._scale = trainer._amp_original_scale
    trainer._amp_unscaled = True
    trainer._amp_last_finite = finite
    return finite


def amp_cast(data, dtype="bfloat16"):
    """Cast op (reference ``amp_cast``)."""
    return data.astype(dtype)


def amp_multicast(*data, num_outputs=None, cast_narrow=False):
    """Cast arrays to one dtype (reference ``amp_multicast``): the
    widest, or the narrowest with ``cast_narrow``."""
    dtypes = [dtype_torch(d.dtype) for d in data]
    pick = min if cast_narrow else max
    target = pick(dtypes, key=lambda dt: dt.itemsize)
    return [d.astype(target) for d in data]
