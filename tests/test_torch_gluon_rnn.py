"""``mxtpu_torch.gluon.rnn`` against ``mxtpu.gluon.rnn`` (reference
``tests/test_rnn.py``): the fused layers eager and hybridized with their
gradients (NTC with explicit states too), every cell unrolled (the GRU
cell inside the sequential and residual ones), the wrappers, and
``valid_length``. Both packages build with one prefix and initialize
after ``mx.random.seed(0)`` (bit-equal weights); outputs and gradients
within 1e-6 relative or 2 float32 ulps of the largest magnitude
(``torch_gluon_cases.close``), scaled up where a time loop sums."""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx

import torch_gluon_cases as gc

torch.set_num_threads(2)

T, N, C, H = 5, 3, 4, 6
PKGS = {"ref": (jmx, jmx.cpu()), "port": (tmx, "cpu")}
X = np.random.default_rng(0).standard_normal((T, N, C)).astype(np.float32)


def layer_run(which, mode, hybrid, layout="TNC", states=False, **kw):
    mx, ctx = PKGS[which]
    mx.random.seed(0)
    cls = {"lstm": "LSTM", "gru": "GRU"}.get(mode, "RNN")
    if cls == "RNN":
        kw["activation"] = mode.split("_")[1]
    layer = getattr(mx.gluon.rnn, cls)(H, input_size=C, layout=layout,
                                       prefix="l_", **kw)
    layer.initialize(ctx=ctx)
    if hybrid:
        layer.hybridize()
    x = X.transpose(1, 0, 2) if layout == "NTC" else X
    xs = mx.nd.array(x, ctx=ctx)
    xs.attach_grad()
    records = []
    for call in range(2):
        args = (xs, layer.begin_state(N, ctx=ctx)) if states else (xs,)
        with mx.autograd.record():
            out = layer(*args)
        y = out[0] if states else out
        y.backward(mx.nd.ones(y.shape, ctx=ctx))
        rec = [y.asnumpy(), xs.grad.asnumpy()]
        if states:
            rec += [s.asnumpy() for s in out[1]]
        rec += [p.grad().asnumpy() for p in layer.collect_params().values()]
        records.append(rec)
    return records


@pytest.mark.parametrize("mode,kw,hybrid", [
    ("lstm", dict(num_layers=2, layout="NTC", states=True), True),
    ("gru", dict(num_layers=2, bidirectional=True), True),
    ("rnn_tanh", dict(bidirectional=True), True),
    ("rnn_relu", dict(), False),
])
def test_fused_layer_matches_mxtpu(mode, kw, hybrid):
    want = layer_run("ref", mode, hybrid, **kw)
    got = layer_run("port", mode, hybrid, **kw)
    for call, (g, w) in enumerate(zip(got, want)):
        for k, (a, b) in enumerate(zip(g, w)):
            gc.close(a, b, f"{mode} call {call} array {k}", scale=1.0)


def test_lstm_states_and_ntc():
    """The NTC layout with explicit states (held against the reference
    above): the last layer's final state is the last output step."""
    out, _, h, c = layer_run("port", "lstm", False, layout="NTC",
                             states=True)[0][:4]
    assert out.shape == (N, T, H) and h.shape == c.shape == (1, N, H)
    np.testing.assert_allclose(h[0], out[:, -1], rtol=1e-6)


def cell_of(mx, kind, prefix="c_"):
    rnn = mx.gluon.rnn
    if kind == "sequential":
        cell = rnn.SequentialRNNCell(prefix=prefix)
        with cell.name_scope():
            cell.add(rnn.LSTMCell(H, input_size=C))
            cell.add(rnn.GRUCell(H, input_size=H))
        return cell
    if kind == "residual":
        return rnn.ResidualCell(rnn.GRUCell(C, input_size=C, prefix=prefix))
    if kind == "dropout":
        cell = rnn.SequentialRNNCell(prefix=prefix)
        with cell.name_scope():
            cell.add(rnn.LSTMCell(H, input_size=C))
            cell.add(rnn.DropoutCell(0.5))
        return cell
    if kind == "zoneout":
        return rnn.ZoneoutCell(rnn.GRUCell(H, input_size=C, prefix=prefix),
                               zoneout_outputs=0.5, zoneout_states=0.5)
    if kind == "bidirectional":
        return rnn.BidirectionalCell(rnn.LSTMCell(H, input_size=C,
                                                  prefix=prefix + "l_"),
                                     rnn.LSTMCell(H, input_size=C,
                                                  prefix=prefix + "r_"))
    return getattr(rnn, kind)(H, input_size=C, prefix=prefix)


def unroll_run(which, kind, valid=None):
    """``cell.unroll`` over X under ``record()`` (train mode: the
    dropout and zoneout masks are keyed draws after one
    ``mx.random.seed``), or with ``valid="step"`` one call of the cell
    on X's first step from ``begin_state``; the outputs, the input's
    gradient, the states and the parameters' gradients."""
    mx, ctx = PKGS[which]
    mx.random.seed(0)
    cell = cell_of(mx, kind)
    cell.initialize(ctx=ctx)
    if valid == "step":
        x = mx.nd.array(X[0], ctx=ctx)
        begin = cell.begin_state(N, ctx=ctx)
    else:
        x = mx.nd.array(X.transpose(1, 0, 2), ctx=ctx)
        vl = None if valid is None else mx.nd.array(valid, ctx=ctx)
    x.attach_grad()
    with mx.autograd.record():
        if valid == "step":
            out, states = cell(x, begin)
        else:
            out, states = cell.unroll(T, x, layout="NTC", valid_length=vl)
    out.backward(mx.nd.ones(out.shape, ctx=ctx))
    return [out.asnumpy(), x.grad.asnumpy()] + \
        [s.asnumpy() for s in states] + \
        [p.grad().asnumpy() for p in cell.collect_params().values()]


@pytest.mark.parametrize("kind,valid", [
    ("RNNCell", None), ("LSTMCell", [2.0, 5.0, 4.0]),
    ("sequential", [2.0, 5.0, 4.0]), ("residual", None),
    ("bidirectional", [2.0, 5.0, 4.0]), ("dropout", None),
    ("zoneout", None), ("RNNCell", "step"), ("LSTMCell", "step"),
    ("GRUCell", "step")])
def test_cell_unroll_matches_mxtpu(kind, valid):
    want = unroll_run("ref", kind, valid)
    got = unroll_run("port", kind, valid)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        gc.close(g, w, f"{kind} array {k}", scale=1.0)


def test_cells_step_and_wrappers():
    for kind in ("RNNCell", "LSTMCell", "GRUCell"):
        cell = cell_of(tmx, kind)
        cell.initialize(ctx="cpu")
        states = cell.begin_state(N, ctx="cpu")
        out, new = cell(tmx.nd.ones((N, C), ctx="cpu"), states)
        assert out.shape == (N, H) and len(new) == len(states)
    cell = cell_of(tmx, "residual")
    cell.initialize(ctx="cpu")
    x = tmx.nd.ones((N, C), ctx="cpu")
    states = cell.begin_state(N, ctx="cpu")
    out, _ = cell(x, states)
    base, _ = cell.base_cell(x, states)
    np.testing.assert_array_equal(out.asnumpy(), (base + x).asnumpy())
    drop = tmx.gluon.rnn.DropoutCell(0.5)
    np.testing.assert_array_equal(drop(x, [])[0].asnumpy(), np.ones((N, C)))
    with tmx.autograd.record(train_mode=True):
        assert (drop(x, [])[0].asnumpy() == 0).sum() > 0
    zone = tmx.gluon.rnn.ZoneoutCell(tmx.gluon.rnn.GRUCell(H, input_size=C),
                                     zoneout_outputs=0.5,
                                     zoneout_states=0.5)
    zone.initialize(ctx="cpu")
    with tmx.autograd.record(train_mode=True):
        out, states = zone.unroll(T, tmx.nd.array(X, ctx="cpu"),
                                  layout="TNC")
    assert out.shape == (T, N, H) and len(states) == 1
    with pytest.raises(NotImplementedError, match="unroll"):
        cell_of(tmx, "bidirectional")(x, [])
