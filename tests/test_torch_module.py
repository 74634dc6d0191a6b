"""``mxtpu_torch.module`` (``mx.mod.Module``, ``BucketingModule``) on the
CPU against ``mxtpu``'s.

The reference's own cases (every test of ``tests/test_module.py``) run
through the port with ``context=mx.cpu()`` and iterators on the host.
Parity, on the same seeded numpy data:

- ``Module.fit`` from the same ``mx.random.seed`` initialisation and
  the same ``np.random.seed`` shuffles (sgd with momentum, 3 epochs):
  every parameter after each epoch, and the metric, within 1e-5 of the
  parameter's largest |value| (float32 products and sums taken in
  another order, carried through 9 steps; 4.3e-7 measured);
- ``score``, ``predict`` (pad stripped) and input gradients within the
  same bound; ``save_checkpoint`` writes the reference's bytes;
- ``BucketingModule`` (the reference's per-step projection, and an LSTM
  word model as ``example/rnn/bucketing`` builds it) over two buckets
  with one shared parameter set: outputs within 1e-6 of the largest
  |value| after a step in each bucket.
"""
import logging

import numpy as onp
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx

torch.set_num_threads(2)   # a CPU share for each xdist worker

FIT_REL = 1e-5
OUT_REL = 1e-6


def _close(a, b, rel):
    a, b = onp.asarray(a), onp.asarray(b)
    assert a.shape == b.shape
    assert onp.abs(a - b).max() <= rel * onp.abs(b).max(), \
        (onp.abs(a - b).max(), onp.abs(b).max())


def _kw(mx):
    return {"ctx": "cpu"} if mx is tmx else {}


def _nd(mx, x):
    return mx.nd.array(onp.asarray(x, onp.float32), **_kw(mx))


def _mlp_symbol(mx, hidden=32, classes=4):
    sym = mx.sym
    net = sym.FullyConnected(sym.var("data"), num_hidden=hidden, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=classes, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax", normalization="batch")


def _blob_data(n=200, dim=8, classes=4, seed=0):
    rng = onp.random.default_rng(seed)
    centers = rng.standard_normal((classes, dim)) * 3
    labels = rng.integers(0, classes, n)
    data = centers[labels] + rng.standard_normal((n, dim)) * 0.5
    return data.astype(onp.float32), labels.astype(onp.float32)


def _iter(mx, data, labels, **kw):
    return mx.io.NDArrayIter(data, labels, **kw, **_kw(mx))


# ---------------------------------------------------------------------------
# the reference's cases, through the port
# ---------------------------------------------------------------------------
def test_module_bind_and_forward():
    mod = tmx.mod.Module(_mlp_symbol(tmx), context=tmx.cpu())
    mod.bind(data_shapes=[("data", (10, 8))],
             label_shapes=[("softmax_label", (10,))])
    mod.init_params()
    mod.forward(tmx.io.DataBatch(data=[_nd(tmx, onp.ones((10, 8)))],
                                 label=[_nd(tmx, onp.zeros(10))]),
                is_train=False)
    out = mod.get_outputs()[0]
    assert out.shape == (10, 4)
    onp.testing.assert_allclose(out.asnumpy().sum(axis=1), onp.ones(10),
                                rtol=1e-5)


def test_module_fit_converges():
    data, labels = _blob_data()
    mod = tmx.mod.Module(_mlp_symbol(tmx), context=tmx.cpu())
    val = _iter(tmx, data, labels, batch_size=20)
    mod.fit(_iter(tmx, data, labels, batch_size=20, shuffle=True),
            eval_data=val, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.5),), eval_metric="acc",
            num_epoch=10)
    score = mod.score(val, "acc")
    assert score[0][1] > 0.95, score


def test_module_get_set_params():
    def bound():
        mod = tmx.mod.Module(_mlp_symbol(tmx), context=tmx.cpu())
        mod.bind(data_shapes=[("data", (4, 8))],
                 label_shapes=[("softmax_label", (4,))])
        return mod
    mod = bound()
    mod.init_params(initializer=tmx.initializer.Normal(0.1))
    args, auxs = mod.get_params()
    assert set(args) == {"fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"}
    mod2 = bound()
    mod2.set_params(args, auxs)
    x = tmx.io.DataBatch(data=[_nd(tmx, onp.ones((4, 8)))],
                         label=[_nd(tmx, onp.zeros(4))])
    mod.forward(x, is_train=False)
    mod2.forward(x, is_train=False)
    onp.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(),
                                   mod2.get_outputs()[0].asnumpy())


def test_module_checkpoint_round_trip(tmp_path):
    data, labels = _blob_data(80)
    mod = tmx.mod.Module(_mlp_symbol(tmx), context=tmx.cpu())
    mod.fit(_iter(tmx, data, labels, batch_size=16),
            optimizer_params=(("learning_rate", 0.3), ("momentum", 0.9)),
            num_epoch=3)
    prefix = str(tmp_path / "mlp")
    mod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    mod2 = tmx.mod.Module.load(prefix, 3, load_optimizer_states=True,
                               context=tmx.cpu())
    mod2.bind(data_shapes=[("data", (16, 8))],
              label_shapes=[("softmax_label", (16,))])
    mod2.init_params()
    mod2.init_optimizer(optimizer_params=(("learning_rate", 0.3),
                                          ("momentum", 0.9)))
    assert set(mod2._updater.states) == set(mod._updater.states)
    b = tmx.io.DataBatch(data=[_nd(tmx, data[:16])],
                         label=[_nd(tmx, labels[:16])])
    mod.forward(b, is_train=False)
    mod2.forward(b, is_train=False)
    onp.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(),
                                   mod2.get_outputs()[0].asnumpy())


def test_module_predict_and_input_grads():
    data, labels = _blob_data(40)
    it = _iter(tmx, data, labels, batch_size=16)    # pads the last batch
    mod = tmx.mod.Module(_mlp_symbol(tmx), context=tmx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             inputs_need_grad=True)
    mod.init_params()
    assert mod.predict(it).shape == (40, 4)        # pad stripped
    it.reset()
    mod.forward(next(it), is_train=True)
    mod.backward()
    ig = mod.get_input_grads()[0]
    assert ig.shape == (16, 8)
    assert float(ig.abs().sum().asscalar()) > 0


def _bucket_sym_gen(mx):
    def sym_gen(seq_len):
        # a per-step shared projection over (N, T, F): weights that do
        # not depend on the bucket length, like the reference's buckets
        sym = mx.sym
        net = sym.FullyConnected(sym.var("data"), num_hidden=8,
                                 flatten=False, name="fc_shared")
        net = sym.sum(net, axis=1)
        net = sym.FullyConnected(net, num_hidden=2, name="out")
        return sym.SoftmaxOutput(net, name="softmax"), ("data",), \
            ("softmax_label",)
    return sym_gen


def _bucket_batch(mx, key, data, label, shape):
    return mx.io.DataBatch(
        data=[_nd(mx, data)], label=[_nd(mx, label)], bucket_key=key,
        provide_data=[mx.io.DataDesc("data", shape)],
        provide_label=[mx.io.DataDesc("softmax_label", (shape[0],))])


def test_bucketing_module():
    mod = tmx.mod.BucketingModule(_bucket_sym_gen(tmx), default_bucket_key=10,
                                  context=tmx.cpu())
    mod.bind(data_shapes=[("data", (4, 10, 3))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.1),))
    mod.forward(_bucket_batch(tmx, 10, onp.ones((4, 10, 3)), onp.zeros(4),
                              (4, 10, 3)), is_train=True)
    mod.backward()
    mod.update()
    # another bucket; the shared fc weight persists
    mod.forward(_bucket_batch(tmx, 5, onp.ones((4, 5, 3)), onp.zeros(4),
                              (4, 5, 3)), is_train=True)
    assert mod.get_outputs()[0].shape == (4, 2)
    args, _ = mod.get_params()
    assert "out_weight" in args


def test_score_with_composite_metric():
    data, labels = _blob_data(60)
    it = _iter(tmx, data, labels, batch_size=20)
    mod = tmx.mod.Module(_mlp_symbol(tmx), context=tmx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    comp = tmx.metric.CompositeEvalMetric()
    comp.add(tmx.metric.Accuracy())
    comp.add(tmx.metric.CrossEntropy())
    res = dict(mod.score(it, comp))
    assert "accuracy" in res and "cross-entropy" in res


def test_distributed_kvstore_raises():
    mod = tmx.mod.Module(_mlp_symbol(tmx), context=tmx.cpu())
    mod.bind(data_shapes=[("data", (4, 8))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params()
    with pytest.raises(NotImplementedError, match="item 11"):
        mod.init_optimizer(kvstore="dist_sync")


# ---------------------------------------------------------------------------
# parity with mxtpu
# ---------------------------------------------------------------------------
def _fit_run(mx, tmp_path):
    """3 epochs of sgd with momentum from mx.random.seed's Uniform init,
    shuffled after np.random.seed: the parameters after each epoch, the
    train metric, the score, the predictions and the checkpoint."""
    data, labels = _blob_data(60, seed=3)
    mx.random.seed(4)
    onp.random.seed(5)
    it = _iter(mx, data, labels, batch_size=20, shuffle=True)
    mod = mx.mod.Module(_mlp_symbol(mx), context=mx.cpu())
    params, metrics = [], []

    def epoch_end(epoch, symbol, arg, aux):
        params.append({k: v.asnumpy() for k, v in sorted(arg.items())})

    def batch_end(p):
        metrics.append(p.eval_metric.get())
    mod.fit(it, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.2), ("momentum", 0.9),
                              ("wd", 1e-3)),
            eval_metric="ce", num_epoch=3, epoch_end_callback=epoch_end,
            batch_end_callback=batch_end)
    val = _iter(mx, data[:50], labels[:50], batch_size=16)
    score = mod.score(val, "acc")
    preds = mod.predict(val).asnumpy()
    prefix = str(tmp_path / ("port" if mx is tmx else "ref"))
    mod.save_checkpoint(prefix, 3)
    files = [open(prefix + s, "rb").read()
             for s in ("-symbol.json", "-0003.params")]
    return params, metrics, score, preds, files


def test_module_fit_trajectory_matches_mxtpu(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        port = _fit_run(tmx, tmp_path)
        ref = _fit_run(jmx, tmp_path)
    assert len(port[0]) == len(ref[0]) == 3
    for pe, re in zip(port[0], ref[0]):
        assert list(pe) == list(re)
        for k in pe:
            _close(pe[k], re[k], FIT_REL)
    assert [m[0] for m in port[1]] == [m[0] for m in ref[1]]
    _close([m[1] for m in port[1]], [m[1] for m in ref[1]], FIT_REL)
    assert port[2] == ref[2]
    _close(port[3], ref[3], FIT_REL)
    # the checkpoint of each holds its own weights: the JSON is the
    # same bytes, the .params the same layout and names
    assert port[4][0] == ref[4][0]
    assert len(port[4][1]) == len(ref[4][1])


def test_module_checkpoint_bytes_match_mxtpu(tmp_path):
    """The same weights through each package's Module: the same
    checkpoint bytes, and each package's Module.load reads the other's
    checkpoint into the same predictions."""
    rng = onp.random.default_rng(6)
    shapes = {"fc1_weight": (32, 8), "fc1_bias": (32,), "fc2_weight": (4, 32),
              "fc2_bias": (4,)}
    vals = {k: rng.standard_normal(s).astype(onp.float32) * 0.3
            for k, s in shapes.items()}
    x = rng.standard_normal((6, 8)).astype(onp.float32)
    prefixes, outs = {}, {}
    for name, mx in (("port", tmx), ("ref", jmx)):
        mod = mx.mod.Module(_mlp_symbol(mx), context=mx.cpu())
        mod.bind(data_shapes=[("data", (6, 8))],
                 label_shapes=[("softmax_label", (6,))])
        mod.init_params(arg_params={k: _nd(mx, v) for k, v in vals.items()})
        prefixes[name] = str(tmp_path / name)
        mod.save_checkpoint(prefixes[name], 1)
    for suffix in ("-symbol.json", "-0001.params"):
        with open(prefixes["port"] + suffix, "rb") as a, \
                open(prefixes["ref"] + suffix, "rb") as b:
            assert a.read() == b.read()
    for mx, other in ((tmx, "ref"), (jmx, "port")):
        mod = mx.mod.Module.load(prefixes[other], 1, context=mx.cpu())
        mod.bind(data_shapes=[("data", (6, 8))], for_training=False,
                 label_shapes=[("softmax_label", (6,))])
        mod.init_params()
        mod.forward(mx.io.DataBatch(data=[_nd(mx, x)],
                                    label=[_nd(mx, onp.zeros(6))]),
                    is_train=False)
        outs[other] = mod.get_outputs()[0].asnumpy()
    _close(outs["ref"], outs["port"], OUT_REL)


def _lstm_sym_gen(mx, batch=4, vocab=11, embed=6, hidden=8):
    """example/rnn/bucketing's model: embed → fused LSTM with learned
    initial states → last step → FC → softmax, parameter names
    independent of the bucket."""
    def sym_gen(seq_len):
        sym = mx.sym
        emb = sym.Embedding(sym.var("data"), input_dim=vocab,
                            output_dim=embed, name="embed")
        tnc = sym.transpose(emb, axes=(1, 0, 2))
        _, total = mx.nd.ops.rnn_param_layout("lstm", embed, hidden, 1,
                                              False)
        out = sym.RNN(tnc, sym.var("lstm_parameters", shape=(total,)),
                      sym.var("lstm_h0", shape=(1, batch, hidden)),
                      state_cell=sym.var("lstm_c0", shape=(1, batch, hidden)),
                      state_size=hidden, num_layers=1, mode="lstm",
                      name="lstm")
        fc = sym.FullyConnected(sym.SequenceLast(out), num_hidden=3,
                                name="cls")
        return sym.SoftmaxOutput(fc, name="softmax"), ("data",), \
            ("softmax_label",)
    return sym_gen


@pytest.mark.parametrize("model", ["projection", "lstm"])
def test_bucketing_module_matches_mxtpu(model):
    rng = onp.random.default_rng(7)
    if model == "lstm":
        keys, shape = (7, 4), lambda k: (4, k)
        batches = {k: rng.integers(0, 11, shape(k)).astype(onp.float32)
                   for k in keys}
        labels = rng.integers(0, 3, 4).astype(onp.float32)
    else:
        keys, shape = (10, 5), lambda k: (4, k, 3)
        batches = {k: rng.standard_normal(shape(k)).astype(onp.float32)
                   for k in keys}
        labels = rng.integers(0, 2, 4).astype(onp.float32)
    got = []
    for mx in (tmx, jmx):
        gen = _lstm_sym_gen(mx) if model == "lstm" else _bucket_sym_gen(mx)
        mx.random.seed(8)
        mod = mx.mod.BucketingModule(gen, default_bucket_key=keys[0],
                                     context=mx.cpu())
        mod.bind(data_shapes=[("data", shape(keys[0]))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(initializer=mx.initializer.Uniform(0.3))
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.5),
                                             ("momentum", 0.9)))
        outs = []
        for k in keys + keys:
            mod.forward(_bucket_batch(mx, k, batches[k], labels, shape(k)),
                        is_train=True)
            outs.append(mod.get_outputs()[0].asnumpy())
            mod.backward()
            mod.update()
        args, _ = mod.get_params()
        got.append((outs, {n: v.asnumpy() for n, v in sorted(args.items())},
                    sorted(mod._buckets)))
    assert got[0][2] == got[1][2] == sorted(keys)
    for a, b in zip(got[0][0], got[1][0]):
        _close(a, b, OUT_REL)
    assert list(got[0][1]) == list(got[1][1])
    for k in got[0][1]:
        _close(got[0][1][k], got[1][1][k], OUT_REL)
