"""Parity of the port's op registry with ``mxtpu.ndarray.ops`` on the
CPU, second half: the linalg, indexing, sequence, neural-network, loss,
and scalar ops of the table in ``torch_op_cases.py``
(``Convolution``/``Deconvolution``/``Pooling`` included, with their
groups, dilations, strides and pooling conventions), each case through
both packages' ``mx.nd`` with values and gradients compared; and the
three ``ops_extended`` ops this slice brings."""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx

import torch_op_cases as oc
from test_torch_ops import check_case

torch.set_num_threads(2)

_ORDER = [n for n in oc.CASES]
NAMES = [n for n in _ORDER[_ORDER.index(oc.NN_FROM):] if n not in oc.SEQ]

_S2D = np.random.default_rng(3).standard_normal((2, 3, 4, 6)).astype(
    np.float32)


@pytest.mark.parametrize("op", NAMES)
def test_op_matches_mxtpu(op):
    for case in oc.CASES[op]:
        check_case(op, case)


@pytest.mark.parametrize("op,case", [
    ("space_to_depth", oc.C(_S2D, block_size=2)),
    ("depth_to_space", oc.C(_S2D.reshape(2, 12, 2, 3), block_size=2)),
    ("reshape_like", oc.C(oc.B3, np.zeros((4, 6), np.float32), grad=[0])),
])
def test_extended_op_matches_mxtpu(op, case):
    check_case(op, case)


def test_ndarray_dot_and_pad_match_mxtpu():
    def run(mx, ctx):
        a = mx.nd.array(oc.X, ctx=ctx)
        img = mx.nd.array(oc.IMG[:1, :1], ctx=ctx)
        return (a.dot(mx.nd.array(oc.M, ctx=ctx)).asnumpy(),
                img.pad(mode="edge", pad_width=(0, 0, 0, 0, 1, 1, 2, 0))
                .asnumpy())
    for got, want in zip(run(tmx, "cpu"), run(jmx, jmx.cpu())):
        oc.assert_close(got, want, False, "dot/pad")
