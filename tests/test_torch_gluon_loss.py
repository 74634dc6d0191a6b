"""Parity of the port's Gluon losses, parameters, Trainer and utilities
with ``mxtpu.gluon`` on the CPU.

- Every loss of ``gluon.loss``, eager and hybridized, through
  ``torch_gluon_cases.check`` (values and the prediction's gradient).
- ``.params`` files cross both ways byte for byte (the reference's
  ``save_parameters`` loads into the port, whose ``save_parameters``
  writes the same bytes, and the reverse); ``ParameterDict.load_dict``
  installs ``{name: numpy}``; deferred init resolves on the first call.
- ``Trainer`` (sgd with momentum through the multi-tensor step, adam,
  adamw per parameter): a 3-step trajectory of a hybridized net under
  ``record()`` against the reference's; ``save_states``/``load_states``.
- A hybridized predict-mode call after ``Trainer.step`` reads the new
  weights: on the CPU the call runs plainly, so the CUDA-graph branch
  is driven with a stand-in graph that replays the captured function on
  the tensors it was captured over (as a real graph reads their memory):
  a stale capture would give the old weights' output.
- ``split_and_load``, ``clip_global_norm`` and ``check_sha1`` against
  the reference's; the names that wait for later slices raise, naming
  their ROADMAP item.
"""
import os

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.gluon import block as tblock

import torch_gluon_cases as gc

torch.set_num_threads(2)

rng = np.random.default_rng(31)
f32 = np.float32
PRED = rng.standard_normal((4, 5)).astype(f32)
PROB = rng.uniform(0.05, 0.95, (4, 5)).astype(f32)
LAB01 = (rng.uniform(size=(4, 5)) > 0.5).astype(f32)
SIGNED = 2 * LAB01 - 1
SPARSE = np.array([0, 3, 1, 4], f32)
DENSE = np.eye(5, dtype=f32)[[0, 3, 1, 4]]
W4 = rng.uniform(0.5, 1.5, (4, 1)).astype(f32)
CTC_PRED = rng.standard_normal((2, 6, 5)).astype(f32)
CTC_LAB = np.array([[1, 2, 2], [3, 1, 0]], f32)


class LossNet:
    """A loss wrapped so ``check`` can build it like a block."""

    def __init__(self, name, **kw):
        self.name, self.kw = name, kw

    def __call__(self, mx):
        return getattr(mx.gluon.loss, self.name)(prefix="loss_", **self.kw)


LOSSES = {
    "l2": (LossNet("L2Loss"), [PRED, PROB]),
    "l1_weighted": (LossNet("L1Loss", weight=0.5), [PRED, PROB, W4]),
    "sigmoid_bce": (LossNet("SigmoidBCELoss"), [PRED, LAB01]),
    "sigmoid_bce_from_sigmoid": (LossNet("SigmoidBCELoss",
                                         from_sigmoid=True), [PROB, LAB01]),
    "softmax_ce": (LossNet("SoftmaxCrossEntropyLoss"), [PRED, SPARSE]),
    "softmax_ce_dense": (LossNet("SoftmaxCELoss", sparse_label=False),
                         [PRED, DENSE]),
    "softmax_ce_from_logits": (LossNet("SoftmaxCELoss", from_logits=True,
                                       weight=2.0), [PRED, SPARSE]),
    "kldiv": (LossNet("KLDivLoss"), [PRED, PROB]),
    "kldiv_from_probs": (LossNet("KLDivLoss", from_logits=False),
                         [PRED, PROB]),
    "huber": (LossNet("HuberLoss", rho=0.5), [PRED, PROB]),
    "hinge": (LossNet("HingeLoss"), [PRED, SIGNED]),
    "squared_hinge": (LossNet("SquaredHingeLoss", margin=0.5),
                      [PRED, SIGNED]),
    "logistic": (LossNet("LogisticLoss"), [PRED, SIGNED]),
    "logistic_binary": (LossNet("LogisticLoss", label_format="binary"),
                        [PRED, LAB01]),
    "triplet": (LossNet("TripletLoss", margin=0.3), [PRED, PROB, LAB01]),
    "cosine_embedding": (LossNet("CosineEmbeddingLoss", margin=0.1),
                         [PRED, PROB, np.array([1, -1, 1, -1], f32)]),
    "ctc": (LossNet("CTCLoss"), [CTC_PRED, CTC_LAB]),
}


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_mxtpu(name, hybrid):
    make, xs = LOSSES[name]
    gc.check(make, xs, (0,), hybrid)


def mlp(mx, prefix="mlp_"):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(8, use_bias=False), nn.BatchNorm(),
                nn.Activation("relu"), nn.Dense(3))
    return net


X = rng.standard_normal((6, 5)).astype(f32)
Y = np.array([0, 2, 1, 1, 0, 2], f32)


def built(mx, ctx, seed=0):
    mx.random.seed(seed)
    net = mlp(mx)
    net.initialize(mx.initializer.Xavier(), ctx=ctx)
    net(mx.nd.array(X, ctx=ctx))          # resolves the deferred shapes
    return net


def test_params_files_cross_byte_for_byte(tmp_path):
    ref = built(jmx, gc.REF_CTX)
    port = built(tmx, "cpu", seed=1)
    f_ref, f_port = str(tmp_path / "ref.params"), str(tmp_path / "p.params")
    ref.save_parameters(f_ref)
    port.load_parameters(f_ref, ctx="cpu")
    port.save_parameters(f_port)
    assert open(f_ref, "rb").read() == open(f_port, "rb").read()
    # and the reverse: the port's file into the reference
    port2 = built(tmx, "cpu", seed=2)
    f_port2 = str(tmp_path / "p2.params")
    port2.save_parameters(f_port2)
    ref.load_parameters(f_port2)
    ref.save_parameters(f_ref)
    assert open(f_ref, "rb").read() == open(f_port2, "rb").read()
    # the ParameterDict's own arg:-prefixed format too
    port2.collect_params().save(f_port2)
    ref.collect_params().save(f_ref)
    assert open(f_ref, "rb").read() == open(f_port2, "rb").read()


def test_load_dict_and_deferred_init():
    ref = built(jmx, gc.REF_CTX)
    arrays = {n: p.data().asnumpy() for n, p in
              ref.collect_params().items()}
    port = mlp(tmx)
    assert port.collect_params()["mlp_dense0_weight"].shape == (8, 0)
    port.collect_params().load_dict(arrays, ctx="cpu")
    for n, p in port.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), arrays[n])
    with pytest.raises(RuntimeError, match="missing"):
        mlp(tmx, "other_").collect_params().load_dict({}, ctx="cpu")
    deferred = mlp(tmx, "d_")
    deferred.initialize(ctx="cpu")
    with pytest.raises(tmx.gluon.DeferredInitializationError):
        deferred.collect_params()["d_dense0_weight"].data()
    deferred(tmx.nd.array(X, ctx="cpu"))
    assert deferred.collect_params()["d_dense0_weight"].shape == (8, 5)


def train(mx, ctx, opt, kw, steps=3):
    net = built(mx, ctx)
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), opt, kw)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = mx.nd.array(X, ctx=ctx), mx.nd.array(Y, ctx=ctx)
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(X.shape[0])
        losses.append(loss.asnumpy())
    return net, trainer, losses


@pytest.mark.parametrize("opt,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("adam", dict(learning_rate=0.01)),
    ("adamw", dict(learning_rate=0.01, wd=0.01)),
])
def test_trainer_trajectory_matches_mxtpu(opt, kw):
    ref, _, ref_losses = train(jmx, gc.REF_CTX, opt, kw)
    port, _, losses = train(tmx, "cpu", opt, kw)
    for k, (g, w) in enumerate(zip(losses, ref_losses)):
        gc.close(g, w, f"{opt} loss {k}")
    want = {n: p.data().asnumpy() for n, p in ref.collect_params().items()}
    for n, p in port.collect_params().items():
        gc.close(p.data().asnumpy(), want[n], f"{opt} {n}")


def test_trainer_states_and_learning_rate(tmp_path):
    net, trainer, _ = train(tmx, "cpu", "adam", dict(learning_rate=0.01))
    f = str(tmp_path / "t.states")
    trainer.save_states(f)
    other = tmx.gluon.Trainer(net.collect_params(), "adam")
    other.load_states(f)
    for i, st in trainer._updaters[0].states.items():
        for a, b in zip(st, other._updaters[0].states[i]):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    trainer.set_learning_rate(0.5)
    assert trainer.learning_rate == 0.5
    small = tmx.gluon.Trainer(list(net.collect_params().values())[:2],
                              "adam")
    with pytest.raises(tmx.MXNetError, match="does not have"):
        small.load_states(f)


class _StandInGraph:
    """Replays the captured function on the tensors it was captured over,
    into the capture's outputs (what a CUDA graph's replay computes)."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _stand_in_capture(self, raw, sig, datas, n_in, tensors, versions):
    cap = tblock._Capture()
    cap.static_in = [d.clone() if isinstance(d, torch.Tensor) else None
                     for d in datas[:n_in]]
    cap.static_key = datas[-1].clone()
    args = [s if s is not None else d
            for s, d in zip(cap.static_in, datas[:n_in])]
    args += list(tensors) + [cap.static_key]
    with torch.no_grad():
        cap.outs, cap.aux = raw(*args)

    def run():
        with torch.no_grad():
            outs, aux = raw(*args)
        for a, b in zip(cap.outs + cap.aux, outs + aux):
            a.copy_(b)
    cap.graph = _StandInGraph(run)
    cap.params, cap.versions = tensors, versions
    self.captures += 1
    return cap


def test_predict_after_step_reads_new_weights(monkeypatch):
    monkeypatch.setattr(tblock, "graphs_on", lambda device: True)
    monkeypatch.setattr(tblock.HybridBlock, "_capture", _stand_in_capture)
    net, trainer, _ = train(tmx, "cpu", "sgd", dict(learning_rate=0.5))
    x = tmx.nd.array(X, ctx="cpu")
    before = net(x).asnumpy()
    assert net.captures == 1
    np.testing.assert_array_equal(net(x).asnumpy(), before)
    assert net.captures == 1                     # replayed, not recaptured
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        loss = loss_fn(net(x), tmx.nd.array(Y, ctx="cpu"))
    loss.backward()
    trainer.step(X.shape[0])
    after = net(x).asnumpy()
    assert net.captures == 2                     # the weights were rebound
    net.hybridize(False)
    with tmx.autograd.predict_mode():
        eager = net(x).asnumpy()
    np.testing.assert_array_equal(after, eager)
    assert np.abs(after - before).max() > 1e-3


def test_utils_match_mxtpu(tmp_path):
    data = rng.standard_normal((6, 3)).astype(f32)
    for got, want in zip(
            tmx.gluon.utils.split_and_load(data, ["cpu", "cpu"]),
            jmx.gluon.utils.split_and_load(data, [jmx.cpu(), jmx.cpu()])):
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    arrays = [rng.standard_normal((3, 4)).astype(f32) for _ in range(3)]
    t = [tmx.nd.array(a, ctx="cpu") for a in arrays]
    j = [jmx.nd.array(a) for a in arrays]
    gc.close(tmx.gluon.utils.clip_global_norm(t, 1.0),
             jmx.gluon.utils.clip_global_norm(j, 1.0), "norm")
    for a, b in zip(t, j):
        gc.close(a.asnumpy(), b.asnumpy(), "clipped")
    f = tmp_path / "blob"
    f.write_bytes(os.urandom(1000))
    import hashlib
    digest = hashlib.sha1(f.read_bytes()).hexdigest()
    assert tmx.gluon.utils.check_sha1(str(f), digest)
    assert not tmx.gluon.utils.check_sha1(str(f), "0" * 40)


def test_later_slices_raise(tmp_path):
    from mxtpu_torch.parallel import mesh as tmesh
    net = mlp(tmx, "r_")
    # ported (item 11a): shard takes a parallel.mesh.Mesh, and a mesh
    # over two devices needs a process group
    with pytest.raises(TypeError, match="Mesh"):
        net.hybridize(mesh=object())
    with pytest.raises(ValueError, match="dist.initialize"):
        net.shard(tmesh.create_mesh(dp=2), None)
    with pytest.raises(TypeError, match="Mesh"):
        net.shard(None, None)
    # ported: export_stablehlo writes a torch.export archive that
    # contrib.deploy loads and runs without the net
    enet = mlp(tmx, "e_")
    enet.initialize(ctx="cpu")
    x = tmx.nd.array(X, ctx="cpu")
    path = enet.export_stablehlo(str(tmp_path / "e"), x)
    assert path.endswith(".pt2")
    np.testing.assert_array_equal(
        tmx.contrib.deploy.load(path, ctx="cpu")(x).asnumpy(),
        enet(x).asnumpy())
    with pytest.raises(OSError, match="x.rec"):     # ported: no such file
        tmx.io.ImageRecordIter(path_imgrec="x.rec", data_shape=(3, 8, 8),
                               ctx="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        tmx.gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd")
    with pytest.raises(tmx.MXNetError, match="net.shard"):
        tr.make_fused_step(net)       # ported: it needs a sharded net
    for name in ("data", "rnn", "contrib"):
        assert getattr(tmx.gluon, name).__name__ == f"mxtpu_torch.gluon.{name}"
    assert tmx.gluon.model_zoo.vision.get_model("vgg11").__class__.__name__ \
        == "VGG"
    assert callable(tmx.gluon.model_zoo.vision.mobilenet1_0)
    # ported since: each opens its file, or converts
    with pytest.raises(FileNotFoundError):
        tmx.gluon.data.RecordFileDataset("x.rec")
    assert tmx.amp.convert_model(None, {}, {}, target_dtype="bfloat16") \
        == (None, {}, {})
    with pytest.raises(OSError, match="x.rec"):
        tmx.io.NativeImageRecordIter(path_imgrec="x.rec",
                                     data_shape=(3, 8, 8), ctx="cpu")
