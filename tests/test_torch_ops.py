"""Parity of the port's op registry (``mxtpu_torch.ndarray.ops``) with
``mxtpu.ndarray.ops`` on the CPU: the elementwise, reduction, sorting
and shape ops of the table in ``torch_op_cases.py`` (the nn, linalg and
indexing ops are ``test_torch_ops_nn.py``'s), every case through both
packages' ``mx.nd`` on the same numpy inputs, values and gradients
compared at the table's tolerances; and the registry itself: its names
are the reference's less a written list of the names that wait for
ROADMAP item 10.4, and each alias is the same op in both packages.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.contrib.quantization  # noqa: F401  (registers its ops)
import mxtpu.ndarray.contrib_ops  # noqa: F401  (registers its ops)
import mxtpu.operator  # noqa: F401  (registers Custom)
import mxtpu_torch as tmx
from mxtpu_torch.base import dtype_name

import torch_op_cases as oc

torch.set_num_threads(2)

REF, PORT = oc.Side(jmx, jmx.cpu()), oc.Side(tmx, "cpu")
_ORDER = [n for n in oc.CASES]
NAMES = _ORDER[:_ORDER.index(oc.NN_FROM)]

# the reference's registered names that wait for ROADMAP item 10.4: the
# rest of its ops_extended, contrib.quantization's and mx.operator's
# Custom (each module is imported above, so the registry is the same
# whatever else this process imported)
LATER_10_4 = frozenset("""
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

# the contrib ops the port registers (test_torch_contrib_ops.py holds
# them against mxtpu.ndarray.contrib_ops)
CONTRIB = frozenset("""
AdaptiveAvgPooling2D MultiBoxDetection MultiBoxPrior MultiBoxTarget ROIAlign
ROIPooling _contrib_AdaptiveAvgPooling2D _contrib_MultiBoxDetection
_contrib_MultiBoxPrior _contrib_MultiBoxTarget _contrib_ROIAlign
_contrib_allclose _contrib_arange_like _contrib_bipartite_matching
_contrib_box_iou _contrib_box_nms _contrib_index_copy allclose arange_like
bipartite_matching box_iou box_nms index_copy
""".split())

_X64 = {"float64": "float32", "int64": "int32"}


def check_case(op, case):
    ref_outs, ref_grads = REF.run(op, case)
    got_outs, got_grads = PORT.run(op, case)
    assert len(got_outs) == len(ref_outs), op
    for k, (r, g) in enumerate(zip(ref_outs, got_outs)):
        want = dtype_name(g.dtype)
        ref_dt = np.dtype(r.dtype).name
        if case.x64:
            assert want == _X64.get(ref_dt, ref_dt), (op, k, want, ref_dt)
        else:
            assert want == ref_dt, (op, k, want, ref_dt)
        oc.assert_close(g.asnumpy(), r.asnumpy(), case.exact,
                        f"{op} output {k}", case.scale)
    for i, r, g in zip(case.grad, ref_grads, got_grads):
        oc.assert_close(g.asnumpy(), r.asnumpy(), False, f"{op} grad {i}")


@pytest.mark.parametrize("op", NAMES)
def test_op_matches_mxtpu(op):
    for case in oc.CASES[op]:
        check_case(op, case)


def test_registry_is_the_references_less_item_10_4():
    from mxtpu.ndarray import ops as rops
    from mxtpu_torch.ndarray import ops as tops
    from mxtpu_torch.ndarray.ops_extended import LATER
    assert LATER == LATER_10_4
    assert set(tops.OP_REGISTRY) == set(rops.OP_REGISTRY) - LATER_10_4
    assert set(oc.CASES) | set(oc.ALIASES) | CONTRIB | {
        "reshape_like", "space_to_depth", "depth_to_space"} == \
        set(tops.OP_REGISTRY)
    for name in sorted(LATER_10_4)[::9]:
        with pytest.raises(AttributeError, match="ROADMAP Queue A item 10.4"):
            getattr(tmx.nd, name)


@pytest.mark.parametrize("alias", sorted(oc.ALIASES))
def test_alias_is_the_same_op(alias):
    from mxtpu.ndarray import ops as rops
    from mxtpu_torch.ndarray import ops as tops
    first = oc.ALIASES[alias]
    assert rops.OP_REGISTRY[alias] is rops.OP_REGISTRY[first]
    assert tops.OP_REGISTRY[alias] is tops.OP_REGISTRY[first]
    assert getattr(tmx.nd, alias) is tops.OP_REGISTRY[first]
