"""Parity of the port's op registry with ``mxtpu.ndarray.ops`` on the
CPU, second half: the linalg, indexing, sequence, neural-network, loss,
and scalar ops of the table in ``torch_op_cases.py``
(``Convolution``/``Deconvolution``/``Pooling`` included, with their
groups, dilations, strides and pooling conventions), and the second
half of the rest of the op set (``linalg_*``, the tensor extras, the
flat random ops and ``sample_*``, the optimizer update ops with the
state arrays they rebind, ``im2col``/``col2im``, the masked softmaxes,
``Custom`` and the int8 ops), each case through both packages'
``mx.nd`` with values and gradients compared; and the three
``ops_extended`` ops the model zoo needs."""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.contrib.quantization  # noqa: F401  (registers its ops)
import mxtpu.operator  # noqa: F401  (registers Custom)
import mxtpu_torch as tmx
import mxtpu_torch.contrib.quantization  # noqa: F401  (registers its ops)

import torch_op_cases as oc
from test_torch_ops import check_case

torch.set_num_threads(2)

_ORDER = [n for n in oc.CASES]
NAMES = [n for n in _ORDER[_ORDER.index(oc.NN_FROM):
                            _ORDER.index(oc.EXT_FROM)]
         if n not in oc.SEQ] + _ORDER[_ORDER.index(oc.EXT_NN_FROM):]
oc.register_custom(jmx)
oc.register_custom(tmx)

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


@pytest.mark.parametrize("op,states", [("sgd_mom_update", 1),
                                       ("adam_update", 2),
                                       ("mp_sgd_update", 1)])
def test_update_op_writes_out(op, states):
    """``out=weight``, as MXNet's optimizer calls the update ops: the
    weight array holds the reference's new weight and the states the
    reference's, also inside ``autograd.record()`` on a leaf weight."""
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((3, 4)).astype(np.float32)
    g0 = rng.standard_normal((3, 4)).astype(np.float32)
    s0 = [rng.uniform(0.1, 1.0, (3, 4)).astype(np.float32)
          for _ in range(states)]
    if op == "mp_sgd_update":
        w0, g0, s0 = w0.astype(np.float16), g0.astype(np.float16), [w0]
    kw = {"lr": 0.05, "wd": 0.01}

    def run(mx, ctx, record):
        w, g = (mx.nd.array(a, ctx=ctx, dtype=a.dtype.name) for a in (w0, g0))
        st = [mx.nd.array(a, ctx=ctx) for a in s0]
        if record:
            w.attach_grad()
            with mx.autograd.record():
                out = getattr(mx.nd, op)(w, g, *st, out=w, **kw)
        else:                     # the reference ignores ``out``
            out = getattr(mx.nd, op)(w, g, *st, out=w, **kw)
        return w, out, st
    ref_w, ref_out, ref_st = run(jmx, jmx.cpu(), False)
    for record in (False, True):
        w, out, st = run(tmx, "cpu", record)
        assert out is w
        oc.assert_close(w.asnumpy(), ref_out.asnumpy(), True, op)
        for a, b in zip(st, ref_st):
            oc.assert_close(a.asnumpy(), b.asnumpy(), True, op)
