"""``mx.nd.contrib`` on the CPU against ``mxtpu.ndarray.contrib``.

Every contrib op (``box_iou``, ``box_nms``, ``bipartite_matching``,
``MultiBoxPrior``/``Target``/``Detection``, ``ROIAlign``,
``ROIPooling``, ``AdaptiveAvgPooling2D``, ``boolean_mask``,
``allclose``, ``arange_like``, ``index_copy``) runs through both
packages on the same seeded numpy inputs: outputs within 1e-5 (the
reference computes some positions in float64, as its tests run jax
with x64 on; integer-valued outputs — class ids, matches, masks, kept
rows — exactly), and gradients through both tapes within 1e-5 where
the reference's op is differentiable. ``foreach``, ``while_loop`` and
``cond`` (eager here, ``lax`` control flow there) give the same values
and gradients.
"""
import numpy as onp
import pytest
import torch

import mxtpu as jmx
from mxtpu.ndarray import contrib as jc
import mxtpu_torch as tmx
from mxtpu_torch.ndarray import contrib as tc

torch.set_num_threads(2)   # a CPU share for each xdist worker

SIDES = ((jmx, jc, {}), (tmx, tc, {"ctx": "cpu"}))


def lookup(mx, c, op):
    """An op by name: the module's own (``boolean_mask`` is not
    registered), else the registry's (the ``_contrib_*`` aliases)."""
    return c.__dict__.get(op) or mx.nd.ops.OP_REGISTRY[op]


TOL = dict(rtol=1e-5, atol=1e-5)


def boxes(rng, n, lead=()):
    b = rng.uniform(0, 0.6, lead + (n, 4)).astype(onp.float32)
    b[..., 2:] += b[..., :2] + 0.05
    return b


def run(op, inputs, grad=(), **params):
    """(outputs, grads) of ``op`` in each package, as numpy."""
    res = []
    for mx, c, at in SIDES:
        arrs = [mx.nd.array(x, **at) if isinstance(x, onp.ndarray) else x
                for x in inputs]
        for i in grad:
            arrs[i].attach_grad()
        with mx.autograd.record():
            out = lookup(mx, c, op)(*arrs, **params)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            if grad:
                head = outs[0]
                loss = (head * mx.nd.array(
                    onp.linspace(0.5, 1.5, head.size).reshape(head.shape)
                    .astype(onp.float32), **at)).sum()
        if grad:
            loss.backward()
        res.append(([o.asnumpy() for o in outs],
                    [arrs[i].grad.asnumpy() for i in grad]))
    return res


def check(op, inputs, grad=(), exact=(), **params):
    (want, wgrads), (got, ggrads) = run(op, inputs, grad, **params)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (op, k)
        if k in exact:
            onp.testing.assert_array_equal(g, w, err_msg=f"{op} out {k}")
        else:
            onp.testing.assert_allclose(g, w, **TOL, err_msg=f"{op} out {k}")
    for g, w in zip(ggrads, wgrads):
        onp.testing.assert_allclose(g, w, **TOL, err_msg=f"{op} grad")
    return got


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rng = onp.random.default_rng(0)
    check("box_iou", [boxes(rng, 5), boxes(rng, 7)], grad=(0, 1),
          format=fmt)
    check("_contrib_box_iou", [boxes(rng, 2, (3,)), boxes(rng, 4)],
          format=fmt)


def nms_data(rng, b, n, ids=3):
    d = onp.zeros((b, n, 6), onp.float32)
    d[..., 0] = rng.integers(0, ids, (b, n))
    d[..., 1] = rng.uniform(0, 1, (b, n))
    d[..., 2:] = boxes(rng, n, (b,))
    return d


@pytest.mark.parametrize("kw", [
    dict(), dict(overlap_thresh=0.3, id_index=0),
    dict(overlap_thresh=0.4, id_index=0, force_suppress=True, topk=9),
    dict(valid_thresh=0.4, in_format="center", out_format="corner"),
    dict(out_format="center", overlap_thresh=0.2)])
def test_box_nms(kw):
    rng = onp.random.default_rng(1)
    out = check("box_nms", [nms_data(rng, 2, 24)], grad=(0,), **kw)[0]
    assert (out[..., 1] == -1).any() and (out[..., 1] > 0).any()
    check("_contrib_box_nms", [nms_data(rng, 1, 10)[0]], **kw)


def test_box_nms_reference_case():
    data = onp.array([[0, 0.9, 0.0, 0.0, 1.0, 1.0],
                      [1, 0.8, 0.05, 0.05, 1.0, 1.0],
                      [0, 0.7, 2.0, 2.0, 3.0, 3.0]], onp.float32)
    out = check("box_nms", [data], overlap_thresh=0.5)[0]
    assert list(out[:, 1]) == [onp.float32(0.9), -1.0, onp.float32(0.7)]
    out = check("box_nms", [data], overlap_thresh=0.5, id_index=0)[0]
    assert (out[:, 1] > 0).sum() == 3


@pytest.mark.parametrize("kw", [dict(threshold=0.2),
                                dict(threshold=0.6, is_ascend=True, topk=3)])
def test_bipartite_matching(kw):
    rng = onp.random.default_rng(2)
    check("bipartite_matching", [rng.uniform(0, 1, (2, 6, 4))
                                 .astype(onp.float32)], exact=(0, 1), **kw)
    check("_contrib_bipartite_matching",
          [rng.uniform(0, 1, (5, 7)).astype(onp.float32)], exact=(0, 1),
          **kw)


@pytest.mark.parametrize("kw", [
    dict(sizes=(0.5, 0.25), ratios=(1, 2)),
    dict(sizes=(0.2, 0.272), ratios=(1, 2, 0.5, 3, 1 / 3.), clip=True),
    dict(sizes=(0.9,), ratios=(1, 2), steps=(0.2, 0.25),
         offsets=(0.3, 0.6))])
def test_multibox_prior(kw):
    x = onp.zeros((1, 3, 5, 4), onp.float32)
    out = check("MultiBoxPrior", [x], **kw)[0]
    assert out.dtype == onp.float32
    check("_contrib_MultiBoxPrior", [x], **kw)


def ssd_inputs(rng, b=2, a_side=4, m=4, classes=5):
    anchors = tmx.nd.contrib.MultiBoxPrior(
        tmx.nd.zeros((1, 3, a_side, a_side), ctx="cpu"),
        sizes=(0.3, 0.5), ratios=(1, 2)).asnumpy()
    n_anchor = anchors.shape[1]
    label = onp.full((b, m, 5), -1.0, onp.float32)
    for i in range(b):
        k = 1 + i % m
        label[i, :k, 0] = rng.integers(0, classes, k)
        label[i, :k, 1:] = boxes(rng, k)
    pred = rng.normal(0, 1, (b, classes + 1, n_anchor)).astype(onp.float32)
    return anchors, label, pred


@pytest.mark.parametrize("kw", [
    dict(), dict(overlap_threshold=0.3, negative_mining_ratio=3,
                 negative_mining_thresh=0.4, ignore_label=-1)])
def test_multibox_target(kw):
    rng = onp.random.default_rng(3)
    loc, mask, cls = check("MultiBoxTarget", list(ssd_inputs(rng)),
                           exact=(1, 2), **kw)
    assert mask.sum() > 0 and (cls > 0).any()


@pytest.mark.parametrize("kw", [dict(), dict(nms_threshold=0.3,
                                             force_suppress=True,
                                             nms_topk=20, clip=False)])
def test_multibox_detection(kw):
    rng = onp.random.default_rng(4)
    anchors, _, pred = ssd_inputs(rng)
    prob = onp.exp(pred) / onp.exp(pred).sum(axis=1, keepdims=True)
    loc = rng.normal(0, 0.5, (2, anchors.shape[1] * 4)).astype(onp.float32)
    out = check("MultiBoxDetection", [prob.astype(onp.float32), loc,
                                      anchors], **kw)[0]
    assert out.shape == (2, anchors.shape[1], 6)
    assert (out[..., 1] == -1).any()


@pytest.mark.parametrize("op,kw", [
    ("ROIAlign", dict(pooled_size=(3, 2), spatial_scale=0.5,
                      sample_ratio=2)),
    ("ROIAlign", dict(pooled_size=(2, 2), sample_ratio=1)),
    ("ROIPooling", dict(pooled_size=(3, 3), spatial_scale=0.5))])
def test_roi_ops(op, kw):
    rng = onp.random.default_rng(5)
    feat = rng.normal(0, 1, (2, 3, 9, 11)).astype(onp.float32)
    rois = onp.array([[0, 1.0, 2.0, 12.0, 14.0], [1, 0.0, 0.0, 20.0, 16.0],
                      [1, 6.5, 3.25, 9.0, 7.5]], onp.float32)
    check(op, [feat, rois], grad=(0,), **kw)


@pytest.mark.parametrize("size", [1, 3, (2, 5), (4, 4)])
def test_adaptive_avg_pooling(size):
    x = onp.random.default_rng(6).normal(0, 1, (2, 3, 7, 9)).astype(
        onp.float32)
    check("AdaptiveAvgPooling2D", [x], grad=(0,), output_size=size)


def test_small_ops():
    rng = onp.random.default_rng(7)
    x = rng.normal(0, 1, (5, 3)).astype(onp.float32)
    check("boolean_mask", [x, onp.array([1, 0, 1, 1, 0], onp.float32)],
          grad=(0,))
    check("boolean_mask", [x, onp.array([0, 1, 1], onp.float32)], axis=1)
    for y, kw in ((x, {}), (x + 1e-7, {}), (x + 1e-3, {}),
                  (x + 1e-3, dict(atol=1e-2))):
        check("allclose", [x, y], exact=(0,), **kw)
    for kw in (dict(), dict(start=2.0, step=0.5, repeat=2),
               dict(axis=1, repeat=2), dict(axis=0, start=-1.0)):
        check("arange_like", [x], exact=(0,), **kw)
    check("index_copy", [x, onp.array([4, 1], onp.float32),
                         rng.normal(0, 1, (2, 3)).astype(onp.float32)],
          grad=(0, 2))


def _flow(mod, c, at):
    """foreach, while_loop and cond in one recorded program."""
    mx = mod
    data = mx.nd.array(onp.arange(12, dtype=onp.float32).reshape(4, 3) / 7,
                       **at)
    s1 = mx.nd.array(onp.ones(3, onp.float32), **at)
    x = mx.nd.array(onp.array([2.0], onp.float32), **at)
    for a in (data, s1, x):
        a.attach_grad()
    with mx.autograd.record():
        outs, (fa, fb) = c.foreach(
            lambda d, st: (d * st[0], [st[0] * 1.5 + d, st[1] + d]),
            data, [s1, s1 * 2])
        # x rides as a loop variable: a closure's array is a constant
        # inside the reference's traced body
        wouts, (wi, ws, _) = c.while_loop(
            lambda i, s, k: i < 4,
            lambda i, s, k: (i * s, (i + 1, s * k, k)),
            (mx.nd.array(onp.array([0.0], onp.float32), **at), x, x), 6)
        taken = c.cond(x > 1, lambda a: a * a, lambda a: a * 3, inputs=[x])
        other = c.cond(x < 1, lambda a: a * a, lambda a: a * 3, inputs=[x])
        loss = outs.sum() + fa.sum() * 2 + fb.sum() + wouts.sum() \
            + ws.sum() + taken.sum() * 0.5 + other.sum()
    loss.backward()
    return ([o.asnumpy() for o in (outs, fa, fb, wouts, wi, ws, taken,
                                   other)],
            [a.grad.asnumpy() for a in (data, s1, x)])


def test_control_flow_values_and_grads():
    (want, wgrads), (got, ggrads) = [_flow(*side) for side in SIDES]
    assert want[3].shape == got[3].shape == (6, 1)
    for g, w in zip(got + ggrads, want + wgrads):
        assert g.shape == w.shape
        onp.testing.assert_allclose(g, w, **TOL)


def test_control_flow_edges():
    for mx, c, at in SIDES:
        z = mx.nd.array(onp.array([5.0], onp.float32), **at)
        outs, final = c.while_loop(lambda i: i < 3, lambda i: (i * 2, i + 1),
                                   z, 4)
        assert outs.shape == (4, 1) and float(outs.asnumpy().sum()) == 0
        assert float(final.asscalar()) == 5.0
        outs, final = c.foreach(lambda d, s: (d + s, s + 1),
                                mx.nd.array(onp.ones((3, 2), onp.float32),
                                            **at),
                                mx.nd.array(onp.zeros(2, onp.float32), **at))
        onp.testing.assert_array_equal(outs.asnumpy(),
                                       [[1, 1], [2, 2], [3, 3]])
        with pytest.raises(Exception, match="states"):
            c.foreach(lambda d, s: (d, [s, s]),
                      mx.nd.array(onp.ones((2, 2), onp.float32), **at),
                      [mx.nd.array(onp.ones(2, onp.float32), **at)])
    assert tmx.nd.contrib.isnan is tmx.nd.isnan
    assert tmx.contrib.foreach is tc.foreach
    assert tmx.contrib.box_nms is tmx.nd._contrib_box_nms
