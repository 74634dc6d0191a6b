"""Parity of mxtpu_torch.models.resnet with mxtpu.models.resnet on the CPU
at a bottleneck configuration: ``resnet50`` at width 8 with 10 classes
(depth 50, all 16 bottleneck blocks), forward in eval and train mode
with the new BN state, at 32×32 and 36×36 (odd sizes in the later
stages). Weights, images and the memoized runs of both packages are in
``test_torch_resnet_refs.py``.

Tolerances:
- f32 at 36×36: ``atol=rtol=2e-4`` (summation order only; 3e-5 seen).
- f32 at 32×32, train mode: the last stage is 1×1, so batch statistics
  are taken over the 4 images alone, and where they nearly agree the
  normalisation amplifies f32 summation-order differences: 3e-4
  relative seen (1.6e-3 absolute), so
  ``atol=rtol=2e-3`` there. Eval mode stays at 2e-4.
- bf16, against the reference compiled to round wherever it casts
  (``test_torch_resnet_refs``): eval logits within 1e-5 relative
  distance (3.4e-7 seen). In train mode the same amplification meets
  bf16's coarser rounding: where the two sums round a value to
  neighbouring bf16 numbers (2^-8 apart, not f32's 2^-24), batch
  statistics over few, nearly equal values enlarge the step, and it
  grows over 16 blocks. Seen: train logits 8.7e-2 apart, new-state
  leaves at most 1.9e-2, against 0.33 between either package's bf16
  and f32 train logits. Bounds 0.15 and 0.05.
"""
import pytest

import test_torch_resnet_refs as refs

F32_TOL = dict(atol=2e-4, rtol=2e-4)
ONE_BY_ONE_TRAIN_TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("hw", [32, 36])
def test_forward_eval_and_train_match_mxtpu_f32(hw):
    refs.check_f32("r50w8", hw, F32_TOL,
                   ONE_BY_ONE_TRAIN_TOL if hw == 32 else F32_TOL)


def test_forward_eval_and_train_match_mxtpu_bf16():
    refs.check_bf16("r50w8", 36, 1e-5, 0.15, 0.05)
