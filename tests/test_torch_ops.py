"""Parity of the port's op registry (``mxtpu_torch.ndarray.ops``) with
``mxtpu.ndarray.ops`` on the CPU: the elementwise, reduction, sorting
and shape ops of the table in ``torch_op_cases.py`` (the nn, linalg and
indexing ops are ``test_torch_ops_nn.py``'s), every case through both
packages' ``mx.nd`` on the same numpy inputs, values and gradients
compared at the table's tolerances, with the first half of the rest of
the op set (``ops_extended``: activations, normalization, resizing, the
sampling grids, deformable convolution, correlation, SVMOutput); and
the registry itself: its names are the reference's, and each alias is
the same op in both packages.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.contrib.quantization  # noqa: F401  (registers its ops)
import mxtpu.ndarray.contrib_ops  # noqa: F401  (registers its ops)
import mxtpu.operator  # noqa: F401  (registers Custom)
import mxtpu_torch as tmx
import mxtpu_torch.contrib.quantization  # noqa: F401  (registers its ops)
from mxtpu_torch.base import dtype_name

import torch_op_cases as oc

torch.set_num_threads(2)

REF, PORT = oc.Side(jmx, jmx.cpu()), oc.Side(tmx, "cpu")
_ORDER = [n for n in oc.CASES]
NAMES = _ORDER[:_ORDER.index(oc.NN_FROM)] + \
    _ORDER[_ORDER.index(oc.EXT_FROM):_ORDER.index(oc.EXT_NN_FROM)]
oc.register_custom(jmx)
oc.register_custom(tmx)

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


def test_registry_is_the_references():
    from mxtpu.ndarray import ops as rops
    from mxtpu_torch.ndarray import ops as tops
    import mxtpu_torch.contrib.quantization  # noqa: F401
    import mxtpu_torch.operator  # noqa: F401
    assert set(tops.OP_REGISTRY) == set(rops.OP_REGISTRY)
    assert set(oc.CASES) | set(oc.ALIASES) | CONTRIB | {
        "reshape_like", "space_to_depth", "depth_to_space"} == \
        set(tops.OP_REGISTRY)
    for name in sorted(rops.OP_REGISTRY):
        assert callable(getattr(tmx.nd, name)), name


@pytest.mark.parametrize("alias", sorted(oc.ALIASES))
def test_alias_is_the_same_op(alias):
    from mxtpu.ndarray import ops as rops
    from mxtpu_torch.ndarray import ops as tops
    first = oc.ALIASES[alias]
    assert rops.OP_REGISTRY[alias] is rops.OP_REGISTRY[first]
    assert tops.OP_REGISTRY[alias] is tops.OP_REGISTRY[first]
    assert getattr(tmx.nd, alias) is tops.OP_REGISTRY[first]

