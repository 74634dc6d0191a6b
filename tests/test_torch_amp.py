"""``mxtpu_torch.amp`` against ``mxtpu.amp``: block conversion, the loss
scaler's policy and cap, and the classic Trainer's AMP branch (scaled
backward, ``unscale``, the overflow skip). Same weights in both
packages (``mx.random.seed(0)``); gradients and weights within 1e-6
relative (float32, one scaled backward and one SGD step)."""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.amp as jamp
import mxtpu_torch as tmx
from mxtpu_torch import amp as tamp
from mxtpu_torch.amp.loss_scaler import LossScaler, MAX_LOSS_SCALE

import torch_gluon_cases as gc

torch.set_num_threads(2)

PKGS = {"ref": (jmx, jamp, jmx.cpu()), "port": (tmx, tamp, "cpu")}


def name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def dense(mx, ctx, units, in_units, prefix, **kw):
    mx.random.seed(0)
    net = mx.gluon.nn.Dense(units, in_units=in_units, prefix=prefix, **kw)
    net.initialize(ctx=ctx)
    return net


def test_convert_hybrid_block_keeps_norms_float32():
    for mx, amp, ctx in PKGS.values():
        amp.init("bfloat16")
        nn = mx.gluon.nn
        net = nn.HybridSequential(prefix="c_")
        with net.name_scope():
            net.add(nn.Dense(8, in_units=4), nn.BatchNorm(in_channels=8),
                    nn.Dense(2, in_units=8))
        net.initialize(ctx=ctx)
        amp.convert_hybrid_block(net)
        assert name(net[0].weight.data().dtype) == "bfloat16"
        assert name(net[1].gamma.data().dtype) == "float32"
        y = net(mx.nd.ones((2, 4), ctx=ctx).astype("bfloat16"))
        assert name(y.dtype) == "bfloat16"
    a = [tmx.nd.ones((2,), ctx="cpu"), tmx.nd.ones((2,), ctx="cpu",
                                                    dtype="float16")]
    assert [name(x.dtype) for x in tamp.amp_multicast(*a)] == \
        ["float32"] * 2
    assert [name(x.dtype) for x in tamp.amp_multicast(
        *a, cast_narrow=True)] == ["float16"] * 2
    assert name(tamp.amp_cast(a[0], "float16").dtype) == "float16"


def test_loss_scaler_policy_and_cap():
    """has_overflow, the split API, the window, and the 2**126 cap on
    every write (host float, numpy scalar, device scalar)."""
    for ones, bad in (
            (jmx.nd.ones((2,)), jmx.nd.array([np.inf, 1.0])),
            (tmx.nd.ones((2,), ctx="cpu"),
             tmx.nd.array([np.inf, 1.0], ctx="cpu"))):
        cls = jamp.LossScaler if isinstance(ones, jmx.nd.NDArray) \
            else LossScaler
        s = cls(init_scale=1024, scale_window=2)
        assert not s.has_overflow([ones])
        assert s.has_overflow([bad]) and s.loss_scale == 512
        assert not s.has_overflow([ones]) and not s.has_overflow([ones])
        assert s.loss_scale == 1024
        assert s.is_finite([ones]) and not s.is_finite([bad])
        assert s.loss_scale == 1024          # a check updates nothing
        s.update_scale(True)
        assert s.loss_scale == 512
    s = LossScaler()
    s.loss_scale = 1e38
    assert s.loss_scale == MAX_LOSS_SCALE
    s.loss_scale = np.float32(1e38)
    assert float(s.loss_scale) == MAX_LOSS_SCALE
    s.loss_scale = torch.tensor(MAX_LOSS_SCALE)
    s._unskipped = s._scale_window - 1
    s.update_scale(False)                    # grows on the device
    assert float(s.loss_scale) == MAX_LOSS_SCALE


def scaled_step(which, x, scale=None, window=None, unscale_twice=False,
                step=True, bf16=False):
    """One scaled backward (and step) of a Dense(1, no bias) under AMP:
    (grad, weight, scaler, unscale verdicts)."""
    mx, amp, ctx = PKGS[which]
    amp.init("bfloat16" if bf16 else "float16")
    net = dense(mx, ctx, 1, 2, "a_", use_bias=False)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    amp.init_trainer(tr)
    if window is not None:
        tr._amp_loss_scaler._scale_window = window
    xs = mx.nd.array(x, ctx=ctx)
    with mx.autograd.record():
        with amp.scale_loss((net(xs) * 1e30).sum() if scale == "inf"
                            else net(xs).sum(), tr) as scaled:
            pass
        scaled.backward()
    applied = tr._amp_loss_scaler.loss_scale
    verdicts = []
    if unscale_twice:
        verdicts = [amp.unscale(tr), amp.unscale(tr)]
    grad = net.weight.grad().asnumpy().copy()
    if step:
        tr.step(1)
    return grad, net.weight.data().asnumpy(), tr, applied, verdicts


@pytest.mark.parametrize("case", ["unscale", "window", "overflow", "bf16"])
def test_trainer_amp_branch_matches_mxtpu(case):
    kw = {"unscale": dict(unscale_twice=True),
          "window": dict(unscale_twice=True, window=1),
          "overflow": dict(scale="inf"),
          "bf16": dict(unscale_twice=True, bf16=True)}[case]
    x = [[1e30, 1e30]] if case == "overflow" else [[1.0, 1.0]]
    want = scaled_step("ref", x, **kw)
    got = scaled_step("port", x, **kw)
    if case != "overflow":
        gc.close(got[0], want[0], f"{case} grad")
    gc.close(got[1], want[1], f"{case} weight")
    assert float(got[2]._amp_loss_scaler.loss_scale) == \
        float(want[2]._amp_loss_scaler.loss_scale)
    assert got[4] == want[4]
    scaler = got[2]._amp_loss_scaler
    if case == "unscale":
        np.testing.assert_allclose(got[0], np.ones((1, 2)), rtol=1e-3)
    if case == "window":                       # doubled at the unscale
        assert scaler.loss_scale == got[3] * 2
    if case == "overflow":                     # skipped, halved
        mx, amp, ctx = PKGS["port"]
        w0 = dense(mx, ctx, 1, 2, "a_", use_bias=False).weight.data()
        np.testing.assert_array_equal(got[1], w0.asnumpy())
        assert scaler.loss_scale == got[3] / 2
    if case == "bf16":
        assert scaler.dynamic is False and scaler.loss_scale == 1.0
        scaler.update_scale(True)
        assert scaler.loss_scale == 1.0


def test_scale_loss_needs_init_trainer():
    tamp.init("float16")
    net = dense(tmx, "cpu", 2, 4, "n_")
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd")
    with pytest.raises(tmx.MXNetError, match="init_trainer"):
        with tamp.scale_loss(net(tmx.nd.ones((2, 4), ctx="cpu")).sum(),
                             tr):
            pass
    with pytest.raises(ValueError):
        tamp.init("float64")
