"""The port's model-zoo ResNets (``mxtpu_torch.gluon.model_zoo.vision``)
against ``mxtpu.gluon.model_zoo.vision`` on the CPU: ``get_model`` of
``resnet18_v1`` at 32² with the standard stem (the space-to-depth stem
is ``test_torch_gluon_resnet_s2d.py``'s, ``resnet18_v2``
``test_torch_gluon_resnet_v2.py``'s, ``resnet50_v1``
``test_torch_gluon_resnet50*.py``'s), batch 8 (at 32² the last stage is
1×1, where train-mode BatchNorm normalizes each channel over the batch
alone), on the weights ``mx.random.seed(0)`` plus
``Xavier(magnitude=2)`` gives both packages (checked equal), hybridized:
eval logits within ``atol=rtol=2e-4`` (f32 on both sides, other
summation orders: the bound of ``test_torch_resnet.py``), then 2 steps
of ``Trainer('sgd', lr 1e-3, momentum 0.9)`` under ``record()``, the
losses, every parameter and every BatchNorm running statistic within
``atol=rtol=1e-4`` (the bound of ``test_torch_resnet_train.py``). The
rate is small because the stem's gradient is large at this init
(BatchNorm follows it): at 1e-2 a step moves the stem by more than its
own size, and the two packages' summation-order difference in that
gradient, no larger than the one between the reference's own two stems
(exact rewrites of one conv), grows past the bound by the second step.
"""
import numpy as np
import torch

import mxtpu as jmx
import mxtpu_torch as tmx

torch.set_num_threads(2)

EVAL_TOL = dict(atol=2e-4, rtol=2e-4)
TRAIN_TOL = dict(atol=1e-4, rtol=1e-4)
X = np.random.default_rng(41).standard_normal((8, 3, 32, 32)).astype(
    np.float32)
Y = np.array([3, 7, 0, 1, 9, 4, 4, 2], np.float32)


def zero_last_gammas(net):
    """Each residual body's last BatchNorm gamma to 0 (the usual init for
    deep ResNets: every block starts as its shortcut)."""
    for stage in list(net.features._children.values())[4:-1]:
        for block in stage._children.values():
            last = list(block.body._children.values())[-1]
            last.gamma.set_data(last.gamma.data() * 0)


def run(mx, ctx, name, stem, steps=2, zero_gamma=False):
    mx.random.seed(0)
    net = mx.gluon.model_zoo.vision.get_model(name, classes=10, stem=stem,
                                              prefix="r_")
    net.initialize(mx.initializer.Xavier(magnitude=2), ctx=ctx)
    net.hybridize()
    x, y = mx.nd.array(X, ctx=ctx), mx.nd.array(Y, ctx=ctx)
    with mx.autograd.predict_mode():
        net(x)                              # resolves the deferred shapes
    if zero_gamma:
        zero_last_gammas(net)
    weights = {n: p.data().asnumpy() for n, p in
               net.collect_params().items()}
    with mx.autograd.predict_mode():
        logits = net(x).asnumpy()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1e-3, "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(X.shape[0])
        losses.append(loss.asnumpy())
    after = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    return weights, logits, losses, after


def check(name, stem, zero_gamma=False):
    w_ref, l_ref, losses_ref, a_ref = run(jmx, jmx.cpu(), name, stem,
                                          zero_gamma=zero_gamma)
    w, logits, losses, after = run(tmx, "cpu", name, stem,
                                   zero_gamma=zero_gamma)
    assert sorted(w) == sorted(w_ref)
    for n in w_ref:
        np.testing.assert_allclose(w[n], w_ref[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)
    assert logits.shape == (8, 10)
    np.testing.assert_allclose(logits, l_ref, **EVAL_TOL)
    np.testing.assert_allclose(losses, losses_ref, **TRAIN_TOL)
    for n in a_ref:
        np.testing.assert_allclose(after[n], a_ref[n], err_msg=n,
                                   **TRAIN_TOL)
    moved = [n for n in a_ref if "running_mean" in n
             and np.abs(after[n]).max() > 0]
    assert len(moved) == len([n for n in a_ref if "running_mean" in n])


def test_resnet18_v1_matches_mxtpu():
    check("resnet18_v1", "std")
