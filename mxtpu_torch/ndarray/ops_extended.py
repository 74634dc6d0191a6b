"""What this slice's Gluon needs of ``mxtpu/ndarray/ops_extended.py``:
``reshape_like`` (the losses), ``space_to_depth`` and
``depth_to_space`` (the model zoo's s2d ResNet stem), registered into
the shared ``OP_REGISTRY`` like every other op.

The reference module registers about a hundred more (vision ops, the
rest of ``linalg_*``, the fused optimizer update ops, the random
samplers as ops, ...). They come with ROADMAP Queue A item 10.4: each
of their names, here and in ``mx.nd``, raises ``AttributeError`` saying
so.
"""
from __future__ import annotations

from .ndarray import apply_op
from .ops import register_op

__all__ = ["LATER", "LATER_SLICE"]

LATER_SLICE = "comes with ROADMAP Queue A item 10.4"

# the reference's other registered names (its ops_extended,
# contrib.quantization and operator's Custom), each raising until item
# 10.4 (its contrib_ops are ported: ``contrib_ops.py``)
LATER = frozenset("""
BilinearResize2D BilinearSampler Convolution_v1 Correlation Crop
DeformableConvolution GELU GridGenerator GroupNorm IdentityAttachKLSparseReg
LRN Pooling_v1 SVMOutput SoftmaxActivation SpatialTransformer UpSampling
_adamw_update _contrib_BilinearResize2D _contrib_DeformableConvolution
_contrib_index_add _random_exponential _random_gamma _random_normal
_random_poisson _random_uniform _sample_multinomial _scatter_set_nd _shuffle
adam_update adamw_update all_finite argmax_channel batch_take
bilinear_resize2d broadcast_like cast_storage col2im crop det digamma
ediff1d elu erfc fill_element_0index ftrl_update gelu groupnorm
hard_sigmoid histogram im2col index_add index_array inverse khatri_rao
linalg_det linalg_extractdiag linalg_extracttrian linalg_gelqf linalg_gemm
linalg_inverse linalg_makediag linalg_maketrian linalg_potri linalg_slogdet
linalg_sumlogdiag linalg_syevd linalg_trmm log_sigmoid lrn
masked_log_softmax masked_softmax mish moments mp_sgd_update
multi_all_finite nag_mom_update random_exponential random_gamma
random_normal random_poisson random_uniform ravel_multi_index
rmsprop_update roll rot90 sample_exponential sample_gamma
sample_multinomial sample_normal sample_poisson sample_uniform
scatter_set_nd searchsorted selu sgd_mom_update sgd_update shuffle
signsgd_update slogdet softmax_activation softplus softrelu svm_output
trace unique unravel_index upsampling
_contrib_dequantize _contrib_quantize_v2 _contrib_quantized_conv
_contrib_quantized_fully_connected dequantize quantize_v2
Custom
""".split())


@register_op("depth_to_space")
def depth_to_space(data, block_size, **kwargs):
    """DCR rearrange, NCHW (reference tensor/matrix_op.cc
    DepthToSpace): (N, C, H, W) → (N, C/b², H·b, W·b)."""
    b = int(block_size)

    def _f(x):
        N, C, H, W = x.shape
        y = x.reshape(N, b, b, C // (b * b), H, W)
        y = y.permute(0, 3, 4, 1, 5, 2)
        return y.reshape(N, C // (b * b), H * b, W * b)
    return apply_op(_f, [data], "depth_to_space")


@register_op("space_to_depth")
def space_to_depth(data, block_size, **kwargs):
    """Inverse of depth_to_space (reference tensor/matrix_op.cc)."""
    b = int(block_size)

    def _f(x):
        N, C, H, W = x.shape
        y = x.reshape(N, C, H // b, b, W // b, b)
        y = y.permute(0, 3, 5, 1, 2, 4)
        return y.reshape(N, C * b * b, H // b, W // b)
    return apply_op(_f, [data], "space_to_depth")


@register_op("reshape_like")
def reshape_like(lhs, rhs, **kwargs):
    return apply_op(lambda a, b: a.reshape(b.shape), [lhs, rhs],
                    "reshape_like")


def __getattr__(name):
    if name in LATER:
        raise AttributeError(f"mx.nd.{name} {LATER_SLICE}")
    raise AttributeError(
        f"module 'mxtpu_torch.ndarray.ops_extended' has no attribute "
        f"{name!r}")
