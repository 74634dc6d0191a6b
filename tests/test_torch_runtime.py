"""``mx.profiler``, ``mx.runtime``, ``mx.util``, ``mx.engine`` (bulk and
the NaN sanitizer), ``mx.test_utils`` and ``mx.context`` of the port on
the CPU: the reference's ``tests/test_aux_subsystems.py`` profiler,
runtime, util and engine tests run on both packages; the sanitizer on
an eager op, a hybridized call (eager, and its captured branch through
a stand-in graph that is blind to NaNs as a CUDA graph is) and
``MXTPU_DEBUG_NANS=1`` in a subprocess; ``check_numeric_gradient``
passing a correct gradient and failing a planted wrong one (a
``Custom`` op) in both packages; ``check_consistency``, ``with_seed``;
and the ``Context`` scope, its equality with ``torch.device`` and
``current_context`` across threads.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.profiler  # noqa: F401
import mxtpu_torch as tmx
from mxtpu_torch.gluon import block as tblock

torch.set_num_threads(2)

PKGS = [pytest.param(jmx, id="mxtpu"), pytest.param(tmx, id="mxtpu_torch")]


# -- the reference's profiler / runtime / util / engine tests -------------
@pytest.mark.parametrize("mx", PKGS)
def test_profiler_aggregate(mx, tmp_path):
    with mx.cpu():
        mx.profiler.set_config(filename=str(tmp_path / "prof.json"),
                               profile_all=True, aggregate_stats=True)
        mx.profiler.start()
        a = mx.nd.ones((4, 4))
        b = (a * 2 + 1).sum()
        b.wait_to_read()
        mx.profiler.stop()
        table = mx.profiler.dumps()
        assert "mul" in table and "sum" in table
        (a * 3).sum()
        assert mx.profiler.dumps() == table


@pytest.mark.parametrize("mx", PKGS)
def test_profiler_task_counter(mx):
    c = mx.profiler.Counter("samples")
    c += 5
    c -= 2
    assert c.value == 3
    with mx.profiler.Task("block"):
        pass
    mx.profiler.Marker("evt").mark()


def test_runtime_features():
    feats = tmx.runtime.Features()
    assert feats.is_enabled("CPU")
    assert feats.is_enabled("CUDA") == torch.cuda.is_available()
    assert feats.is_enabled("cudnn") == (torch.cuda.is_available() and
                                        torch.backends.cudnn.is_available())
    assert not feats.is_enabled("TPU") and not feats.is_enabled(
        "DIST_KVSTORE")
    assert feats.is_enabled("X64") and feats.is_enabled("INT64_TENSOR_SIZE")
    assert feats.is_enabled("IMAGE_CODEC") == bool(
        tmx.native._codec_headers())
    assert len(tmx.runtime.feature_list()) > 5
    assert "CPU" in repr(feats)
    assert set(feats) == set(jmx.runtime.Features())


@pytest.mark.parametrize("mx", PKGS)
def test_util_np_mode(mx, tmp_path):
    from importlib import import_module
    util = import_module(f"{mx.__name__}.util")
    assert not util.is_np_array()

    @util.use_np
    def inner():
        return util.is_np_array()

    assert inner()
    assert not util.is_np_array()
    util.set_np()
    try:
        assert util.is_np_array()
    finally:
        util.reset_np()
    assert not util.is_np_array()
    util.makedirs(str(tmp_path / "made" / "here"))
    assert os.path.isdir(tmp_path / "made" / "here")
    assert util.get_gpu_count() == (torch.cuda.device_count()
                                    if mx is tmx else util.get_gpu_count())


def test_get_gpu_memory_needs_a_card():
    if torch.cuda.is_available():
        assert tmx.util.get_gpu_memory(0) == torch.cuda.mem_get_info(0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmx.util.get_gpu_memory(0)


@pytest.mark.parametrize("mx", PKGS)
def test_engine_bulk(mx):
    from importlib import import_module
    engine = import_module(f"{mx.__name__}.engine")
    prev = engine.set_bulk_size(30)
    assert engine.set_bulk_size(prev) == 30
    with engine.bulk(64):
        assert engine.set_bulk_size(64) == 64
    assert engine.set_bulk_size(prev) == prev


@pytest.mark.parametrize("mx", PKGS)
def test_profiler_pause_resume_accumulates(mx, tmp_path):
    with mx.cpu():
        mx.profiler.set_config(filename=str(tmp_path / "pr.json"))
        mx.profiler.start()
        (mx.nd.ones((2,)) * 2).wait_to_read()
        mx.profiler.pause()
        mx.profiler.resume()
        (mx.nd.ones((2,)) * 2).wait_to_read()
        mx.profiler.stop()
        row = [ln for ln in mx.profiler.dumps().splitlines()
               if ln.startswith("mul")][0]
        assert int(row.split()[1]) == 2
        mx.profiler.start()
        mx.profiler.start()
        mx.profiler.stop()


@pytest.mark.parametrize("mx", PKGS)
def test_profiler_pause_keeps_trace_alive_and_gates_agg(mx, tmp_path):
    prof = mx.profiler
    with mx.cpu():
        prof.set_config(filename=str(tmp_path / "pk.json"))
        prof.start()
        (mx.nd.ones((2,)) * 2).wait_to_read()
        prof.pause()
        assert prof._state["running"] and prof._state["paused"]
        (mx.nd.ones((2,)) * 5).wait_to_read()
        prof.resume()
        assert not prof._state["paused"]
        (mx.nd.ones((2,)) * 2).wait_to_read()
        prof.stop()
        assert not prof._state["running"]
        row = [ln for ln in prof.dumps().splitlines()
               if ln.startswith("mul")][0]
        assert int(row.split()[1]) == 2
        prof.pause()
        assert not prof._state["paused"]


@pytest.mark.parametrize("mx", PKGS)
def test_profiler_dumps_json_format(mx, tmp_path):
    with mx.cpu():
        mx.profiler.set_config(filename=str(tmp_path / "pj.json"))
        mx.profiler.start()
        ((mx.nd.ones((3,)) * 2) + 1).wait_to_read()
        mx.profiler.stop()
        data = json.loads(mx.profiler.dumps(format="json"))
        assert data["mul"]["count"] >= 1
        assert data["mul"]["time_ms"] >= 0.0
        assert json.loads(mx.profiler.dumps(format="json")) == data
        with pytest.raises(ValueError):
            mx.profiler.dumps(format="xml")
        mx.profiler.dumps(format="json", reset=True)
        assert json.loads(mx.profiler.dumps(format="json")) == {}


def test_profiler_writes_a_chrome_trace(tmp_path):
    """The trace lands under ``<stem>_trace/`` as chrome-trace JSON
    holding the dispatches' host events; the aggregate counts each
    dispatch once, ``mx.np``'s included; a resume after stop writes a
    second trace and keeps the aggregate."""
    prof = tmx.profiler
    with tmx.cpu():
        prof.set_config(filename=str(tmp_path / "run.json"))
        prof.start()
        a = tmx.np.ones((8, 8))
        tmx.np.matmul(a, a).wait_to_read()
        prof.stop()
        first = prof.last_trace()
        assert os.path.dirname(first) == str(tmp_path / "run_trace")
        with open(first) as f:
            trace = json.load(f)
        names = {e.get("name") for e in trace["traceEvents"]}
        assert any("mm" in str(n) for n in names), sorted(names)[:20]
        prof.resume()
        tmx.np.matmul(a, a).wait_to_read()
        prof.stop()
        assert prof.last_trace() != first
        assert json.loads(prof.dumps(format="json"))["matmul"]["count"] == 2
        prof.dumps(reset=True)


def test_profiler_reports_a_foreign_trace(tmp_path):
    with torch.profiler.profile():
        with pytest.warns(UserWarning, match="another torch.profiler"):
            tmx.profiler.set_config(filename=str(tmp_path / "f.json"))
            tmx.profiler.start()
        with tmx.cpu():
            (tmx.nd.ones((2,)) * 2).wait_to_read()
        tmx.profiler.stop()
    assert json.loads(tmx.profiler.dumps(format="json", reset=True)) \
        ["mul"]["count"] == 1


# -- the NaN sanitizer ------------------------------------------------------
class _Normalize(tmx.gluon.HybridBlock):
    """A row divided by its norm: 0/0 on an all-zero row."""

    def hybrid_forward(self, F, x):
        return F.broadcast_div(x, F.norm(x, axis=1, keepdims=True))


def _net():
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(6, in_units=4, use_bias=False), _Normalize())
    net.initialize(ctx="cpu")
    net.hybridize()
    return net


def test_debug_nans_sanitizer():
    from mxtpu_torch import autograd, engine
    net = _net()
    good = tmx.nd.array(np.ones((2, 4), np.float32), ctx="cpu")
    bad = tmx.nd.array(np.array([[1, 2, 3, 4], [0, 0, 0, 0]], np.float32),
                       ctx="cpu")
    assert not engine.is_debug_nans()
    with engine.debug_nans(True):
        assert np.isfinite(net(good).asnumpy()).all()
        zero = tmx.nd.zeros((2, 6), ctx="cpu")
        with pytest.raises(FloatingPointError, match="nan.*'div'"):
            with autograd.pause():
                (net(good) * 0 / zero).asnumpy()
        # inside the hybridized call: the op that made it is named
        with pytest.raises(FloatingPointError, match="broadcast_div"):
            net(bad)
    assert not engine.is_debug_nans()
    y = (net(good) * 0 / tmx.nd.zeros((2, 6), ctx="cpu")).asnumpy()
    assert np.isnan(y).all()
    assert np.isnan(net(bad).asnumpy()[1]).all()


def _blind_capture(self, raw, sig, datas, n_in, tensors, versions):
    """A stand-in graph that, like a CUDA graph, runs no check inside."""
    from mxtpu_torch import engine
    cap = tblock._Capture()
    cap.static_in = [d.clone() if isinstance(d, torch.Tensor) else None
                     for d in datas[:n_in]]
    cap.static_key = datas[-1].clone()
    args = [s if s is not None else d
            for s, d in zip(cap.static_in, datas[:n_in])]
    args += list(tensors) + [cap.static_key]

    def run():
        with torch.no_grad(), engine.debug_nans(False):
            return raw(*args)
    cap.outs, cap.aux = run()

    class Graph:
        def replay(self):
            outs, aux = run()
            for a, b in zip(cap.outs + cap.aux, outs + aux):
                a.copy_(b)
    cap.graph = Graph()
    cap.params, cap.versions = tensors, versions
    self.captures += 1
    return cap


def test_debug_nans_reruns_a_captured_call(monkeypatch):
    """A captured program is checked on return and re-run eagerly, op
    by op, to name the op; the flag off lets the NaN through."""
    from mxtpu_torch import engine
    monkeypatch.setattr(tblock, "graphs_on", lambda device: True)
    monkeypatch.setattr(tblock.HybridBlock, "_capture", _blind_capture)
    net = _net()
    good = tmx.nd.array(np.ones((2, 4), np.float32), ctx="cpu")
    bad = tmx.nd.array(np.array([[1, 2, 3, 4], [0, 0, 0, 0]], np.float32),
                       ctx="cpu")
    net(good)
    net(good)
    assert net.captures == 1
    with engine.debug_nans(True):
        assert np.isfinite(net(good).asnumpy()).all()
        with pytest.raises(FloatingPointError, match="broadcast_div"):
            net(bad)
    assert net.captures == 1
    assert np.isnan(net(bad).asnumpy()[1]).all()


def test_debug_nans_names_a_program_it_cannot_rerun():
    from mxtpu_torch import engine
    with pytest.raises(FloatingPointError, match="fused_step.*step again"):
        engine.check_program("fused_step", torch.tensor([float("nan")]),
                             None, "an eager re-run would step again")
    engine.check_program("clean", torch.ones(3), None)


def test_debug_nans_env_toggle():
    code = ("import mxtpu_torch as mx\n"
            "from mxtpu_torch import engine\n"
            "assert engine.is_debug_nans()\n"
            "try:\n"
            "    with mx.cpu():\n"
            "        mx.nd.zeros((2,)) / mx.nd.zeros((2,))\n"
            "except FloatingPointError as e:\n"
            "    print('NANS_ON', e)\n")
    out = subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ, "MXTPU_DEBUG_NANS": "1"},
        capture_output=True, text=True, timeout=120,
        cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert out.returncode == 0, out.stderr[-1000:]
    assert "NANS_ON" in out.stdout and "'div'" in out.stdout


# -- test_utils ---------------------------------------------------------------
def _register_scale(mx, wrong):
    """``Custom`` op y = 3x whose backward is 3 (or a planted 2)."""
    class Scale(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 3)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0] * (2 if wrong else 3))

    name = f"rt_scale_{int(wrong)}"

    @mx.operator.register(name)
    class ScaleProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Scale()
    return name


@pytest.mark.parametrize("mx", PKGS)
def test_check_numeric_gradient(mx):
    import importlib
    import mxtpu.operator  # noqa: F401
    import mxtpu_torch.operator  # noqa: F401
    tu = importlib.import_module(f"{mx.__name__}.test_utils")
    x = np.random.default_rng(0).standard_normal((2, 3))
    with mx.cpu():
        tu.check_numeric_gradient(lambda a: (a * a).sum(), [x])
        good = _register_scale(mx, False)
        tu.check_numeric_gradient(
            lambda a: mx.nd.Custom(a, op_type=good).sum(), [x])
        bad = _register_scale(mx, True)
        with pytest.raises(AssertionError, match="gradient of input 0"):
            tu.check_numeric_gradient(
                lambda a: mx.nd.Custom(a, op_type=bad).sum(), [x])


def test_check_consistency_and_with_seed():
    tu = tmx.test_utils
    x = np.random.default_rng(1).standard_normal((5, 6))
    res = tu.check_consistency(
        lambda a: (tmx.np.sort(a, axis=1), tmx.np.argsort(a, axis=0)),
        [x], ctx_list=[tmx.cpu(), tmx.cpu()],
        array_fn=lambda v, ctx: tmx.np.array(v, dtype="float64", ctx=ctx))
    assert res[0][1].dtype == np.int64
    with pytest.raises(AssertionError):
        calls = []

        def differs(a):
            calls.append(1)
            return tmx.np.argsort(a, axis=0) + len(calls)
        tu.check_consistency(differs, [x], ctx_list=[tmx.cpu(), tmx.cpu()])
    if not torch.cuda.is_available():
        with tmx.cpu():
            tu.check_consistency(lambda a: a * 2, [x])

    @tu.with_seed(7)
    def draw():
        return (np.random.rand(), tmx.nd.random.uniform(
            shape=(3,), ctx="cpu").asnumpy())
    a, b = draw(), draw()
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(
        a[1], jmx.test_utils.with_seed(7)(
            lambda: jmx.nd.random.uniform(shape=(3,)).asnumpy())())
    assert tu.same(tmx.nd.ones((2,), ctx="cpu"), np.ones(2))
    assert tu.almost_equal(np.ones(2), np.ones(2) + 1e-7)
    assert tu.default_rtol_atol("float64") == \
        jmx.test_utils.default_rtol_atol("float64")


def test_default_context_honours_the_env(monkeypatch):
    monkeypatch.setenv("MXNET_TEST_DEVICE", "cpu")
    assert tmx.test_utils.default_context() == tmx.cpu()
    monkeypatch.delenv("MXNET_TEST_DEVICE")
    with tmx.cpu():
        assert tmx.test_utils.default_context() == tmx.cpu()


# -- the context ------------------------------------------------------------
def test_context_equals_its_torch_device():
    assert tmx.cpu() == torch.device("cpu") and \
        torch.device("cpu") == tmx.cpu()
    assert not (torch.device("cpu") != tmx.cpu())
    assert tmx.gpu(1) == torch.device("cuda", 1) == tmx.tpu(1)
    assert tmx.cpu() != tmx.gpu() and tmx.gpu() != "cpu"
    assert tmx.Context("cpu_pinned") == tmx.cpu() and \
        tmx.Context("cpu_shared").device_type == "cpu"
    assert hash(tmx.gpu(0)) == hash(torch.device("cuda", 0))
    assert {torch.device("cpu"): 1}[tmx.cpu()] == 1
    assert repr(tmx.gpu(2)) == "gpu(2)" == str(tmx.gpu(2))
    assert torch.zeros(1, device=tmx.cpu()).device == torch.device("cpu")
    assert torch.device(tmx.gpu(0)) == torch.device("cuda", 0)
    with pytest.raises(ValueError):
        tmx.Context("npu")
    assert tmx.num_gpus() == tmx.num_tpus() == torch.cuda.device_count()
    import pickle
    assert pickle.loads(pickle.dumps(tmx.tpu(0))).device_type == "tpu"


def test_with_scope_places_arrays():
    with tmx.cpu() as ctx:
        assert tmx.current_context() is ctx
        a = tmx.nd.array([1.0, 2.0])
        b = tmx.np.zeros((2,))
        c = tmx.np.sin(0.5)
        d = tmx.nd.random.uniform(shape=(2,))
    for v in (a, b, c, d):
        assert v.context == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmx.nd.array([1.0])
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmx.current_context()
    with tmx.cpu():
        with tmx.gpu():
            assert tmx.current_context() == tmx.gpu()
        assert tmx.current_context() == tmx.cpu()


def test_current_context_is_per_thread():
    seen = {}

    def other():
        try:
            seen["ctx"] = tmx.current_context()
        except RuntimeError as e:
            seen["error"] = str(e)
        with tmx.cpu():
            seen["inner"] = tmx.current_context()

    with tmx.gpu(0):
        t = threading.Thread(target=other)
        t.start()
        t.join(30)
        assert tmx.current_context() == tmx.gpu(0)
    assert not t.is_alive()
    assert seen["inner"] == tmx.cpu()
    if torch.cuda.is_available():
        assert seen["ctx"] == tmx.gpu(0)
    else:
        assert "no CUDA card" in seen["error"]


def test_debug_nans_reruns_the_executor_graph(monkeypatch):
    """The Executor's predict graph, through a stand-in that runs with
    the sanitizer off as a CUDA graph would: a NaN in its output is
    found on return and the eager re-run names the op."""
    from mxtpu_torch import engine
    from mxtpu_torch.symbol import symbol as tsymbol

    def blind(build, fn, warm, device):
        def run():
            with engine.debug_nans(False):
                fn()
        with engine.debug_nans(False):
            warm()
        run()

        class Graph:
            def replay(self):
                run()
        return Graph()
    monkeypatch.setattr(tsymbol, "graphs_on", lambda device: True)
    monkeypatch.setattr(tsymbol, "capture_graph", blind)
    sym = tmx.sym
    out = sym.sqrt(sym.FullyConnected(sym.var("data"), num_hidden=4,
                                      no_bias=True, name="fc"))
    ex = out.simple_bind(tmx.cpu(), grad_req="null", data=(2, 3))
    ex.arg_dict["fc_weight"][:] = np.eye(4, 3, dtype=np.float32)
    good = tmx.nd.array(np.ones((2, 3), np.float32), ctx="cpu")
    bad = tmx.nd.array(-np.ones((2, 3), np.float32), ctx="cpu")
    ex.forward(data=good)
    ex.forward(data=good)
    assert ex.captures == 1
    with engine.debug_nans(True):
        ex.forward(data=good)
        with pytest.raises(FloatingPointError, match="'sqrt'"):
            ex.forward(data=bad)
    assert np.isnan(ex.forward(data=bad)[0].asnumpy()[:, :3]).all()
