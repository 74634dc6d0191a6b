"""``mxtpu_torch.metric``, ``callback``, ``monitor`` and
``visualization`` on the CPU against ``mxtpu``'s.

The reference's cases (the metric tests of ``tests/test_loss_metric.py``,
the monitor tests of ``tests/test_aux_subsystems.py``, the Speedometer
test of ``tests/test_telemetry.py`` and the visualization tests of
``tests/test_symbol.py``) run through the port. Parity: every
registered metric, the composite, ``CustomMetric``/``np`` and
``create``'s aliases give the reference's values on the same seeded
numpy arrays (equal, as both compute on the host in numpy from the
same float32 values); ``Speedometer`` and ``log_train_metric`` write the
same families (name, kind, help text), counts and metric values into
the port's registry as the reference's into its own; the Monitor's
statistics equal the reference's over the same executor; the
summary table and the DOT text are the reference's, character for
character.
"""
import logging

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu import telemetry as jtm
from mxtpu_torch import telemetry as ttm

torch.set_num_threads(2)   # a CPU share for each xdist worker


def _nd(mx, x):
    kw = {"ctx": "cpu"} if mx is tmx else {}
    return mx.nd.array(np.asarray(x), **kw)


# ---------------------------------------------------------------------------
# the reference's metric cases, through the port
# ---------------------------------------------------------------------------
def test_accuracy_metric():
    m = tmx.metric.Accuracy()
    pred = _nd(tmx, [[0.1, 0.9], [0.8, 0.2], [0.3, 0.7]])
    m.update([_nd(tmx, [1, 0, 0])], [pred])
    assert m.get()[1] == pytest.approx(2.0 / 3)
    m.reset()
    assert np.isnan(m.get()[1])


def test_topk_f1_metrics():
    pred = _nd(tmx, [[0.5, 0.3, 0.2], [0.1, 0.2, 0.7]])
    m = tmx.metric.TopKAccuracy(top_k=2)
    m.update([_nd(tmx, [1, 2])], [pred])
    assert m.get()[1] == pytest.approx(1.0)
    f1 = tmx.metric.F1()
    f1.update([_nd(tmx, [1, 0, 1])],
              [_nd(tmx, [[0.2, 0.8], [0.9, 0.1], [0.3, 0.7]])])
    assert f1.get()[1] == pytest.approx(1.0)


def test_mse_perplexity_composite():
    pred = _nd(tmx, [[0.6, 0.4], [0.2, 0.8]])
    label = _nd(tmx, [0, 1])
    ce = tmx.metric.create("ce")
    ce.update([label], [pred])
    assert ce.get()[1] == pytest.approx(-(np.log(0.6) + np.log(0.8)) / 2,
                                        rel=1e-5)
    comp = tmx.metric.create(["acc", "ce"])
    comp.update([label], [pred])
    names, values = comp.get()
    assert names == ["accuracy", "cross-entropy"]
    assert values[0] == pytest.approx(1.0)


def test_custom_metric():
    m = tmx.metric.np(lambda label, pred: float(np.abs(label - pred).sum()))
    m.update([tmx.nd.ones((2,), ctx="cpu")], [tmx.nd.zeros((2,), ctx="cpu")])
    assert m.get()[1] == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# parity of every metric's values
# ---------------------------------------------------------------------------
def _metric_inputs(seed):
    rng = np.random.default_rng(seed)
    probs = rng.random((12, 5)).astype(np.float32)
    probs /= probs.sum(axis=1, keepdims=True)
    labels = rng.integers(0, 5, 12).astype(np.float32)
    reg = rng.standard_normal((12, 5)).astype(np.float32)
    binary = rng.integers(0, 2, 12).astype(np.float32)
    two = rng.random((12, 2)).astype(np.float32)
    return probs, labels, reg, binary, two


METRICS = [
    ("acc", {}, "cls"), ("accuracy", {"axis": 1}, "cls"),
    ("top_k_accuracy", {"top_k": 3}, "cls"), ("ce", {}, "cls"),
    ("nll_loss", {}, "cls"), ("perplexity", {}, "cls"),
    ("perplexity", {"ignore_label": 2}, "cls"), ("mae", {}, "reg"),
    ("mse", {}, "reg"), ("rmse", {}, "reg"), ("pearsonr", {}, "reg"),
    ("loss", {}, "reg"), ("f1", {}, "bin"), ("f1", {"average": "micro"},
                                             "bin"),
    (["acc", "ce", "top_k_acc"], {}, "cls"),
]


@pytest.mark.parametrize("name,kw,kind", METRICS,
                         ids=[str(m[0]) + str(m[1]) for m in METRICS])
def test_metric_values_match_mxtpu(name, kw, kind):
    """Two updates of two batches each, then a reset and one more: the
    port's (name, value) equal the reference's at each get()."""
    got = []
    for mx in (tmx, jmx):
        m = mx.metric.create(name, **kw)
        vals = []
        for seed in (0, 1, 2):
            if seed == 2:
                m.reset()
            probs, labels, reg, binary, two = _metric_inputs(seed)
            lab, pred = {"cls": (labels, probs), "reg": (reg, reg[::-1] * 0.5),
                         "bin": (binary, two)}[kind]
            m.update([_nd(mx, lab), _nd(mx, lab)],
                     [_nd(mx, pred), _nd(mx, pred * 0.9 + 0.01)])
            vals.append(m.get())
        vals.append(m.get_name_value())
        got.append(vals)
    assert got[0] == got[1]


def test_custom_metric_and_update_dict_match_mxtpu():
    got = []
    for mx in (tmx, jmx):
        def feval(label, pred):
            return (label.size, float(np.abs(label - pred.max(axis=1)).sum()))
        m = mx.metric.CustomMetric(feval, name="maxgap",
                                   output_names=["out"],
                                   label_names=["lab"])
        probs, labels, *_ = _metric_inputs(4)
        m.update_dict({"lab": _nd(mx, labels), "other": _nd(mx, labels)},
                      {"out": _nd(mx, probs)})
        got.append(m.get())
    assert got[0] == got[1]
    assert str(m_port := tmx.metric.MSE()) == "EvalMetric: {'mse': nan}"
    m_port.update([_nd(tmx, [1.0])], [_nd(tmx, [3.0])])
    assert str(m_port) == "EvalMetric: {'mse': 4.0}"


# ---------------------------------------------------------------------------
# callbacks: the telemetry families and the checkpoint callback
# ---------------------------------------------------------------------------
class _Param:
    def __init__(self, nbatch, metric):
        self.nbatch, self.epoch, self.eval_metric = nbatch, 0, metric


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step=None):
        self.scalars.append((tag, float(value), step))


FAMILIES = ("train_samples_per_s", "train_batches_total", "train_batch_ms",
            "train_metric")


def _families(tm):
    return {f.name: (f.kind, f.help) for f in tm.registry().families()
            if f.name in FAMILIES}


def _callback_run(mx, tm):
    """Speedometer (the reference's test: fires at nbatch 2 and 4) and
    log_train_metric over the same metric; what the registry and the
    writer got."""
    reg = tm.registry()
    h = reg.get("train_batch_ms")
    before = (reg.value("train_batches_total"), 0 if h is None else h.count)
    w = _Writer()
    sp = mx.callback.Speedometer(batch_size=4, frequent=2,
                                 auto_reset=False, summary_writer=w)
    m = mx.metric.MSE()
    m.update([_nd(mx, np.zeros((2, 1)))], [_nd(mx, np.ones((2, 1)))])
    for nb in (1, 2, 3, 4):
        sp(_Param(nb, m))
    lt = mx.callback.log_train_metric(2, auto_reset=True)
    lt(_Param(2, m))
    assert reg.value("train_samples_per_s") > 0
    return {"families": _families(tm),
            "batches": reg.value("train_batches_total") - before[0],
            "hist": reg.get("train_batch_ms").count - before[1],
            "mse": reg.value("train_metric", metric="mse"),
            "tags": [(t, s) for t, _, s in w.scalars],
            "mse_written": [v for t, v, _ in w.scalars if t == "train/mse"],
            "reset": np.isnan(m.get()[1])}


def test_speedometer_telemetry_matches_mxtpu(caplog):
    with caplog.at_level(logging.INFO):
        port = _callback_run(tmx, ttm)
        ref = _callback_run(jmx, jtm)
    assert port == ref
    assert port["mse"] == pytest.approx(1.0) and port["reset"]
    assert set(port["families"]) == set(FAMILIES)


def test_do_checkpoint_and_progress_bar(tmp_path, caplog):
    out = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=2,
                                 name="fc")
    args = {"fc_weight": tmx.nd.ones((2, 3), ctx="cpu"),
            "fc_bias": tmx.nd.zeros((2,), ctx="cpu")}
    cb = tmx.callback.do_checkpoint(str(tmp_path / "m"), period=2)
    for epoch in range(4):
        cb(epoch, out, args, {})
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["m-0002.params", "m-0004.params", "m-symbol.json"]
    assert tmx.callback.module_checkpoint is tmx.callback.do_checkpoint
    with caplog.at_level(logging.INFO):
        tmx.callback.ProgressBar(total=4, length=8)(_Param(2, None))
    assert "[====----] 50%" in caplog.text


# ---------------------------------------------------------------------------
# the monitor: the reference's cases, and its statistics against mxtpu's
# ---------------------------------------------------------------------------
def _fc_executor(mx):
    data = mx.sym.var("data")
    out = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
    ex = out.simple_bind(mx.cpu(), data=(2, 8))
    ex.arg_dict["fc_weight"][:] = 1.0
    return ex


def _ones(mx, shape):
    return mx.nd.ones(shape, ctx=mx.cpu())


def test_monitor():
    ex = _fc_executor(tmx)
    mon = tmx.monitor.Monitor(interval=1, monitor_all=True)
    mon.install(ex)
    mon.tic()
    ex.forward(is_train=False, data=_ones(tmx, (2, 8)))
    names = [s[1] for s in mon.toc()]
    assert "fc_output" in names and "fc_weight" in names


def test_monitor_pattern_sort_and_interval():
    ex = _fc_executor(tmx)
    mon = tmx.monitor.Monitor(interval=2, pattern=".*weight.*", sort=True,
                              monitor_all=True)
    mon.install(ex)
    mon.tic()                               # step 0: fires
    ex.forward(is_train=False, data=_ones(tmx, (2, 8)))
    names = [s[1] for s in mon.toc()]
    assert names and names == sorted(names)
    assert all("weight" in n for n in names) and "fc_output" not in names
    mon.tic()                               # step 1: off-interval
    ex.forward(is_train=False, data=_ones(tmx, (2, 8)))
    assert mon.toc() == []
    mon.tic()                               # step 2: fires again
    ex.forward(is_train=False, data=_ones(tmx, (2, 8)))
    assert mon.toc()


def test_monitor_custom_stat_and_toc_print(capsys):
    ex = _fc_executor(tmx)
    mon = tmx.monitor.Monitor(interval=1, stat_func=lambda x: x.max(),
                              monitor_all=False)
    mon.install(ex)
    mon.tic()
    ex.forward(is_train=False, data=_ones(tmx, (2, 8)))
    mon.toc_print()
    out = capsys.readouterr().out
    assert "fc_output" in out and "Batch" in out and "fc_weight" not in out


def test_monitor_install_module():
    mod = tmx.mod.Module(
        tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=3,
                               name="fcm"),
        data_names=("data",), label_names=None, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (2, 5))], for_training=False)
    mod.init_params()
    mon = tmx.monitor.Monitor(interval=1)
    mon.install_module(mod)
    mon.tic()
    mod.forward(tmx.io.DataBatch(data=[_ones(tmx, (2, 5))]), is_train=False)
    assert any(name == "fcm_output" for _, name, _ in mon.toc())


def test_monitor_stats_match_mxtpu():
    """Forward and backward with grads over the same weights: every
    statistic (mean |x| of outputs, args, grads) is the reference's
    printed value."""
    got = []
    w = np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32)
    x = np.random.default_rng(3).standard_normal((2, 8)).astype(np.float32)
    for mx in (tmx, jmx):
        ex = _fc_executor(mx)
        ex.arg_dict["fc_weight"][:] = w
        mon = mx.monitor.Monitor(interval=1, monitor_all=True, sort=True)
        mon.install(ex)
        mon.tic()
        ex.forward(is_train=True, data=_nd(mx, x))
        ex.backward(out_grads=_nd(mx, np.ones((2, 4), np.float32)))
        got.append([(s, n, float(v.strip("[]"))) for s, n, v in mon.toc()])
    assert [r[:2] for r in got[0]] == [r[:2] for r in got[1]]
    np.testing.assert_allclose([r[2] for r in got[0]],
                               [r[2] for r in got[1]], rtol=1e-6)


# ---------------------------------------------------------------------------
# mx.viz: the reference's cases, and the same text as mxtpu's
# ---------------------------------------------------------------------------
def _viz_net(mx):
    data = mx.sym.var("data")
    net = mx.sym.Convolution(data, num_filter=4, kernel=(3, 3), name="c1")
    net = mx.sym.Activation(net, act_type="relu", name="a1")
    return mx.sym.FullyConnected(mx.sym.Flatten(net, name="fl"),
                                 num_hidden=10, name="fc")


def test_visualization(capsys):
    net = _viz_net(tmx)
    total = tmx.viz.print_summary(net, shape={"data": (1, 3, 8, 8)})
    out = capsys.readouterr().out
    assert "c1 (Convolution)" in out and "Total params" in out
    assert total == (4 * 3 * 3 * 3 + 4) + (10 * 4 * 6 * 6 + 10)
    dot = tmx.viz.plot_network(net, shape={"data": (1, 3, 8, 8)})
    assert dot.startswith("digraph") and '"c1"' in dot and "->" in dot
    assert "(1, 4, 6, 6)" in dot          # edge shape labels


def test_visualization_nonstandard_input_names():
    x = tmx.sym.var("x")
    net = tmx.sym.FullyConnected(x, num_hidden=10, name="fc")
    assert tmx.viz.print_summary(net, shape={"x": (1, 20)}) == 10 * 20 + 10
    dot = tmx.viz.plot_network(net)
    assert '"x"' in dot and '"x" -> "fc"' in dot
    tmx.viz.print_summary(net, shape={"x": (1, 20)},
                          positions=[50, 80, 95, 120])
    dot2 = tmx.viz.plot_network(net, node_attrs={"shape": "oval",
                                                 "fontname": "Courier New"})
    assert 'shape="oval"' in dot2 and 'fontname="Courier New"' in dot2


def test_visualization_text_matches_mxtpu(capsys):
    got = []
    for mx in (tmx, jmx):
        net = _viz_net(mx)
        total = mx.viz.print_summary(net, shape={"data": (2, 3, 8, 8)},
                                     line_length=100)
        got.append((total, capsys.readouterr().out,
                    mx.viz.plot_network(net, shape={"data": (2, 3, 8, 8)},
                                        hide_weights=False)))
    assert got[0] == got[1]
