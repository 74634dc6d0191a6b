"""mxtpu_torch.telemetry against mxtpu.telemetry: the exposition, the
trace and flight files, the rpc codec and the metrics federation.

The port's registry, tracing, flight recorder, ``rpc`` and federation
are copies of the reference's host code, so the same calls must give
the same bytes: ``prometheus()`` and ``summary()`` byte for byte (labels
with quotes, backslashes and newlines among them), ``parse_prometheus``
the same dicts, ``rpc.encode`` the same frames, and the two packages'
peers must read each other over loopback (scrapes both ways,
``federate_text`` over a peer of each, ``TraceContext`` wire round
trips). Inputs are drawn from ``np.random.default_rng(seed)``; every
comparison is exact (tolerance 0) unless it says otherwise. Both
packages keep a process-wide registry, so these tests use fresh
``MetricsRegistry()`` instances wherever they compare values.
"""
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxtpu import rpc as ref_rpc
from mxtpu import telemetry as rt
from mxtpu.telemetry import distributed as rdist

from mxtpu_torch import rpc as port_rpc
from mxtpu_torch import telemetry as pt
from mxtpu_torch.telemetry import distributed as pdist

torch.set_num_threads(2)

SECRET = b"port-and-reference"


@pytest.fixture(autouse=True)
def _telemetry_on():
    rt.enable(True)
    pt.enable(True)
    yield
    rt.enable(True)
    pt.enable(True)


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------
NASTY = ['plain', 'a"b', 'back\\slash', 'new\nline', 'all"\\\n"']


def _drive(reg, seed):
    """The same seeded calls into one registry: counters, gauges and
    histograms with and without labels, label values with quotes,
    backslashes and newlines, a help text with a newline."""
    rng = np.random.default_rng(seed)
    for i in range(40):
        lab = NASTY[int(rng.integers(len(NASTY)))]
        kind = int(rng.integers(3))
        if kind == 0:
            reg.counter("t_requests_total", "requests\nserved",
                        code=lab).inc(float(rng.integers(1, 5)))
        elif kind == 1:
            reg.gauge("t_depth", "queue depth", slot=str(i % 3)).set(
                float(rng.normal()))
        else:
            reg.histogram("t_latency_ms", "latency",
                          buckets=(0.5, 1, 2.5, 10, 100),
                          route=lab).observe(float(rng.exponential(5.0)))
    reg.counter("t_bare_total").inc(3)
    reg.gauge("t_int_gauge").set(7)
    reg.histogram("t_bytes", "sizes", buckets=rt.BYTES_BUCKETS).observe(
        float(rng.integers(1, 1 << 20)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_and_summary_byte_equal(seed):
    """The same calls into a reference and a port registry give equal
    exposition text, summary table and wire snapshot (exact)."""
    ref, port = rt.MetricsRegistry(), pt.MetricsRegistry()
    _drive(ref, seed)
    _drive(port, seed)
    assert port.prometheus() == ref.prometheus()
    assert port.summary() == ref.summary()
    assert port.snapshot_state() == ref.snapshot_state()
    assert pt.BYTES_BUCKETS == rt.BYTES_BUCKETS
    assert pt.SECONDS_BUCKETS == rt.SECONDS_BUCKETS
    assert pt.escape_label_value(NASTY[-1]) == \
        rt.escape_label_value(NASTY[-1])
    # reset zeroes in place: held handles stay valid, both the same
    ref.reset()
    port.reset()
    assert port.prometheus() == ref.prometheus()
    assert port.summary() == ref.summary()


@pytest.mark.parametrize("seed", [0, 1])
def test_parse_prometheus_equal_in_both_packages(seed):
    """Either package's parser reads either package's text to the same
    dict; escaped label values come back as they were written."""
    ref, port = rt.MetricsRegistry(), pt.MetricsRegistry()
    _drive(ref, seed)
    _drive(port, seed)
    for text in (ref.prometheus(), port.prometheus()):
        got = pt.parse_prometheus(text)
        assert got == rt.parse_prometheus(text)
    s = pt.parse_prometheus(port.prometheus())["samples"]
    labels = {dict(lab).get("code") for name, lab in s
              if name == "mxtpu_t_requests_total"}
    assert labels <= set(NASTY) and labels
    with pytest.raises(ValueError):
        pt.parse_prometheus('mxtpu_x{a="1"} 1\nmxtpu_x{a="1"} 2\n')


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_interval_percentile_and_over_fraction_equal(seed):
    """The bucket-diff helpers: equal results for the same windows,
    and the histogram method agrees with the module function."""
    from mxtpu.telemetry.registry import interval_over_fraction as r_over
    from mxtpu_torch.telemetry.registry import \
        interval_over_fraction as p_over
    rng = np.random.default_rng(seed)
    bounds = tuple(float(b) for b in np.cumsum(rng.uniform(0.5, 3, 8)))
    prev = [int(x) for x in rng.integers(0, 5, len(bounds) + 1)]
    cur = [p + int(x) for p, x in zip(prev, rng.integers(0, 9,
                                                         len(prev)))]
    for q in (50.0, 90.0, 99.0):
        assert pt.interval_percentile(bounds, prev, cur, q) == \
            rt.interval_percentile(bounds, prev, cur, q)
    for thr in (0.0, bounds[2], bounds[-1] + 1):
        assert p_over(bounds, prev, cur, thr) == r_over(bounds, prev, cur,
                                                        thr)
    assert p_over(bounds, None, cur, 1.0) is None
    h = pt.Histogram(buckets=bounds)
    base, _, _ = h.snapshot()
    for v in rng.uniform(0, bounds[-1] * 1.2, 50):
        h.observe(float(v))
    now, _, _ = h.snapshot()
    assert h.interval_percentile(list(base), q=99.0) == \
        pt.interval_percentile(bounds, list(base), list(now), 99.0)


def test_disabled_telemetry_records_nothing():
    pt.enable(False)
    try:
        c = pt.counter("t_disabled_total")
        c.inc(5)
        assert pt.registry().get("t_disabled_total") is None
        with pt.span("t_disabled_span") as s:
            pass
        assert s.duration_ms is not None
    finally:
        pt.enable(True)


# ---------------------------------------------------------------------------
# spans, trace files, flight recorder
# ---------------------------------------------------------------------------
def _nest(tm):
    tm.clear_trace()
    depths = []
    with tm.span("t_outer", stage="unit"):
        depths.append(tm.current_depth())
        with tm.span("t_inner", bucket=64):
            depths.append(tm.current_depth())
            tm.instant("t_mark", note=1)
        with tm.span("t_second"):
            depths.append(tm.current_depth())
    depths.append(tm.current_depth())
    events = [e for e in tm.trace_events()
              if e["name"] in ("t_outer", "t_inner", "t_mark", "t_second")]
    return depths, events


def test_span_nesting_and_dump_equal_reference(tmp_path):
    """The same nested spans give the same events in both packages,
    times and ids excepted, and the same nesting depths; ``dump_trace``
    writes a JSON array of them."""
    r_depths, r_events = _nest(rt)
    p_depths, p_events = _nest(pt)
    assert p_depths == r_depths == [1, 2, 2, 0]

    def shape(events):
        return [(e["name"], e["ph"], e.get("args")) for e in events]
    assert shape(p_events) == shape(r_events)
    inner = next(e for e in p_events if e["name"] == "t_inner")
    outer = next(e for e in p_events if e["name"] == "t_outer")
    assert outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert pt.registry().get("span_t_outer_ms").count >= 1
    loaded = json.load(open(pt.dump_trace(str(tmp_path / "trace.json"))))
    assert [e["name"] for e in loaded if e["name"].startswith("t_")] == \
        [e["name"] for e in p_events]


def test_trace_streams_jsonl_to_path_and_dir(tmp_path, monkeypatch):
    """MXTPU_TELEMETRY_TRACE_PATH streams every event as one JSON line;
    MXTPU_TELEMETRY_TRACE_DIR names a per-process file the way the
    reference does."""
    stream = tmp_path / "stream.jsonl"
    monkeypatch.setenv("MXTPU_TELEMETRY_TRACE_PATH", str(stream))
    with pt.span("t_streamed", k=2):
        pass
    pt.instant("t_instant", note=1)
    monkeypatch.delenv("MXTPU_TELEMETRY_TRACE_PATH")
    events = [json.loads(line) for line in open(stream)]
    assert [e["name"] for e in events][-2:] == ["t_streamed", "t_instant"]
    assert events[-2]["args"] == {"k": 2}
    monkeypatch.setenv("MXTPU_TELEMETRY_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("MXTPU_TELEMETRY_PROCESS", "worker3")
    from mxtpu.telemetry import tracing as rtr
    from mxtpu_torch.telemetry import tracing as ptr
    assert ptr.stream_path() == rtr.stream_path() == os.path.join(
        str(tmp_path), f"mxtpu_trace_worker3_{os.getpid()}.jsonl")
    pt.instant("t_in_dir")
    lines = open(ptr.stream_path()).read().splitlines()
    assert json.loads(lines[-1])["name"] == "t_in_dir"


def test_flight_ring_bounded_dump_and_tail(tmp_path):
    """The ring keeps the newest ``maxlen`` events; ``dump`` writes them
    as JSONL (atomically), ``format_tail`` renders them."""
    fr = pt.FlightRecorder(maxlen=5)
    for i in range(12):
        fr.record("note", f"e{i}", i=i)
    assert len(fr) == 5
    assert [e["name"] for e in fr.tail(10)] == [f"e{i}" for i in
                                                range(7, 12)]
    path = fr.dump(str(tmp_path / "ring.jsonl"))
    lines = [json.loads(line) for line in open(path)]
    assert len(lines) == 5 and lines[-1]["i"] == 11
    assert "e11" in fr.format_tail(2)
    assert pt.FlightRecorder(maxlen=2).format_tail() == \
        rt.FlightRecorder(maxlen=2).format_tail()
    fr.clear()
    assert len(fr) == 0


_FORK_CHILD_CHECK = """
import importlib, os, sys, time
fl = importlib.import_module("mxtpu_torch.telemetry.flight")
pid = os.fork()
if pid == 0:
    ok = (fl.current_pid() == os.getpid()
          and fl.process_role() == f"pid{os.getpid()}")
    os._exit(0 if ok else 1)
deadline = time.monotonic() + 30
while True:
    done, status = os.waitpid(pid, os.WNOHANG)
    if done:
        break
    if time.monotonic() > deadline:
        os.kill(pid, 9)
        os.waitpid(pid, 0)
        sys.exit("the forked child did not exit within 30 s")
    time.sleep(0.01)
if status != 0:
    sys.exit(f"the forked child failed its pid/role check: {status}")
print("child-ok")
if fl.process_role() != f"pid{os.getpid()}":
    sys.exit(f"parent role after the fork: {fl.process_role()}")
print("parent-ok")
"""


def test_flight_fork_path_and_process_tag(tmp_path, monkeypatch):
    """A process forked after import dumps to ``<path>.<pid>``, never
    over its parent's file, and every record carries the process
    role (the env knob or ``set_process_role``)."""
    fl = importlib.import_module("mxtpu_torch.telemetry.flight")
    dump = tmp_path / "flight.jsonl"
    monkeypatch.setenv("MXTPU_TELEMETRY_FLIGHT_PATH", str(dump))
    assert fl.default_flight_path() == str(dump)
    monkeypatch.setattr(fl, "_IMPORT_PID", os.getpid() + 1)
    assert fl.default_flight_path() == f"{dump}.{os.getpid()}"
    monkeypatch.setattr(fl, "_IMPORT_PID", os.getpid())
    monkeypatch.delenv("MXTPU_TELEMETRY_PROCESS", raising=False)
    fr = pt.FlightRecorder(maxlen=4)
    fr.record("note", "before")
    monkeypatch.setenv("MXTPU_TELEMETRY_PROCESS", "prefill0")
    fr.record("note", "after")
    pt.set_process_role("decode1")
    try:
        fr.record("note", "named")
        assert pt.process_role() == "decode1"
    finally:
        pt.set_process_role("")
    tail = fr.tail(3)
    assert [e["process"] for e in tail] == [f"pid{os.getpid()}",
                                            "prefill0", "decode1"]
    path = fr.dump()
    assert path == str(dump)
    assert [json.loads(line)["name"] for line in open(path)] == \
        ["before", "after", "named"]
    # a real fork: the child's records carry its own pid. It forks in a
    # fresh interpreter that runs no other thread (a fork of this
    # multithreaded worker may leave the child waiting on a lock some
    # thread held), and every wait has a deadline
    monkeypatch.delenv("MXTPU_TELEMETRY_PROCESS")
    out = subprocess.run(
        [sys.executable, "-c", _FORK_CHILD_CHECK],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, (out.stdout + out.stderr)[-2000:]
    assert out.stdout.split() == ["child-ok", "parent-ok"], out.stdout
    assert fl.process_role() == f"pid{os.getpid()}"


# ---------------------------------------------------------------------------
# rpc codec
# ---------------------------------------------------------------------------
DTYPES = ["<f4", "<f8", "<f2", "<i1", "<i2", "<i4", "<i8", "|u1", "<u2",
          "<u4", "<u8", "|b1", "<c8", "<c16", "bfloat16"]


def _array(rng, dtype, shape):
    if dtype == "bfloat16":
        import ml_dtypes
        return rng.normal(size=shape).astype(ml_dtypes.bfloat16)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.integers(0, 2, shape).astype(bool)
    if dt.kind == "c":
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
                ).astype(dt)
    if dt.kind in "iu":
        return rng.integers(0, 100, shape).astype(dt)
    return rng.normal(size=shape).astype(dt)


@pytest.mark.parametrize("seed", [0, 1])
def test_rpc_encode_byte_equal(seed):
    """``encode`` of the same message gives the same bytes in both
    packages: nested tuples and lists, strings, ints, floats, bytes,
    None/True/False, and numpy arrays of every dtype the codec knows
    (0-d, empty and non-contiguous ones among them); each package's
    ``decode`` reads the other's frame back."""
    rng = np.random.default_rng(seed)
    arrays = [_array(rng, dt, tuple(int(n) for n in rng.integers(0, 4, k)))
              for k, dt in zip(rng.integers(0, 4, len(DTYPES)), DTYPES)]
    arrays.append(np.arange(12, dtype=np.float32).reshape(3, 4).T)
    arrays.append(np.full((), 2.5))
    msg = ("mxmetrics", 1, -7, 3.25, "naïve\n", b"\x00\xff", None, True,
           False, [1, (2, "x", [3.0])], tuple(arrays),
           np.int64(9), np.float32(0.5))
    enc = port_rpc.encode(msg)
    assert bytes(enc) == bytes(ref_rpc.encode(msg))
    for back in (port_rpc.decode(bytes(enc)), ref_rpc.decode(bytes(enc))):
        for a, b in zip(back[10], arrays):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert port_rpc.max_frame_bytes() == ref_rpc.max_frame_bytes()
    assert port_rpc.MAC_SIZE == ref_rpc.MAC_SIZE
    with pytest.raises(TypeError):
        port_rpc.encode(object())
    ctx = ("ab" * 8, "cd" * 4, 3, 4, 0.0)
    wrapped = port_rpc.attach_context(msg[:3], ctx)
    assert bytes(port_rpc.encode(wrapped)) == \
        bytes(ref_rpc.encode(ref_rpc.attach_context(msg[:3], ctx)))
    assert port_rpc.split_context(wrapped) == (msg[:3], ctx)


# ---------------------------------------------------------------------------
# federation over loopback, across the packages
# ---------------------------------------------------------------------------
def _filled(pkg, seed, scale=1.0):
    reg = pkg.MetricsRegistry()
    rng = np.random.default_rng(seed)
    reg.counter("fed_requests_total", "requests", code="ok").inc(
        float(rng.integers(1, 9)) * scale)
    reg.gauge("fed_depth", "queue depth").set(float(rng.integers(0, 50)))
    h = reg.histogram("fed_ms", "latency", buckets=(1, 10, 100))
    for v in rng.exponential(20.0, 5):
        h.observe(float(v))
    reg.gauge("mfu", "m", program="peer_step").set(float(rng.uniform()))
    return reg


def test_scrapes_cross_the_packages_both_ways():
    """A reference ``scrape_peer`` reads a port ``RegistryServer`` and a
    port ``scrape_peer`` a reference one, with one secret: each gets
    the serving process's name and its exact snapshot."""
    p_reg, r_reg = _filled(pt, 0), _filled(rt, 1)
    p_srv = pt.RegistryServer(port=0, registry=p_reg, process="port0",
                              secret=SECRET)
    r_srv = rt.RegistryServer(port=0, registry=r_reg, process="ref0",
                              secret=SECRET)
    try:
        proc, snap = rdist.scrape_peer("127.0.0.1", p_srv.port,
                                       secret=SECRET)
        assert (proc, snap) == ("port0", p_reg.snapshot_state())
        proc, snap = pdist.scrape_peer("127.0.0.1", r_srv.port,
                                       secret=SECRET)
        assert (proc, snap) == ("ref0", r_reg.snapshot_state())
        with pytest.raises(ConnectionError):
            pdist.scrape_peer("127.0.0.1", r_srv.port, secret=b"wrong",
                              timeout=2.0)
    finally:
        p_srv.close()
        r_srv.close()


def test_federate_text_over_a_peer_of_each_package():
    """``federate_text`` over one port and one reference peer gives the
    text that two peers of one package give, in either package; the
    aggregate counter is the exact sum and the text parses strictly."""
    local = _filled(pt, 2)
    regs = {"w0": _filled(pt, 3), "w1": _filled(rt, 4)}
    same = {"w0": _filled(pt, 3), "w1": _filled(pt, 4)}
    servers = [pt.RegistryServer(port=0, registry=regs["w0"], process="w0",
                                 secret=SECRET),
               rt.RegistryServer(port=0, registry=regs["w1"], process="w1",
                                 secret=SECRET),
               pt.RegistryServer(port=0, registry=same["w0"], process="w0",
                                 secret=SECRET),
               pt.RegistryServer(port=0, registry=same["w1"], process="w1",
                                 secret=SECRET)]
    try:
        mixed = [("127.0.0.1", s.port) for s in servers[:2]]
        alike = [("127.0.0.1", s.port) for s in servers[2:]]
        want = pdist.federate_text(local, alike, process="gw",
                                   secret=SECRET)
        assert pdist.federate_text(local, mixed, process="gw",
                                   secret=SECRET) == want
        r_local = _filled(rt, 2)      # the same calls, in the reference
        assert rdist.federate_text(r_local, mixed, process="gw",
                                   secret=SECRET) == want
        s = pt.parse_prometheus(want)["samples"]
        per = [s[("mxtpu_fed_requests_total",
                  (("code", "ok"), ("process", p)))]
               for p in ("gw", "w0", "w1")]
        assert s[("mxtpu_fed_requests_total", (("code", "ok"),))] == \
            sum(per)
    finally:
        for srv in servers:
            srv.close()


def test_federation_skips_dead_peer_and_dedups_roles():
    """A peer that is down costs its series, not the scrape (counted in
    ``federation_errors_total{peer}``); two peers claiming one role get
    a positional suffix, so the scrape has no duplicate series."""
    local = pt.MetricsRegistry()
    local.counter("fed_dup_total").inc(1)
    before = pt.registry().value("federation_errors_total",
                                 peer="127.0.0.1:1")
    r1, r2 = pt.MetricsRegistry(), rt.MetricsRegistry()
    r1.counter("fed_dup_total").inc(2)
    r2.counter("fed_dup_total").inc(4)
    s1 = pt.RegistryServer(port=0, registry=r1, process="prefill",
                           secret=b"")
    s2 = rt.RegistryServer(port=0, registry=r2, process="prefill",
                           secret=b"")
    try:
        text = pdist.federate_text(
            local, [("127.0.0.1", s1.port), ("127.0.0.1", 1),
                    ("127.0.0.1", s2.port)], process="gateway", secret=b"",
            timeout=1.0)
    finally:
        s1.close()
        s2.close()
    s = pt.parse_prometheus(text)["samples"]
    assert s[("mxtpu_fed_dup_total", ())] == 7.0
    assert s[("mxtpu_fed_dup_total", (("process", "prefill"),))] == 2.0
    assert s[("mxtpu_fed_dup_total", (("process", "prefill~1"),))] == 4.0
    assert pt.registry().value("federation_errors_total",
                               peer="127.0.0.1:1") - before == 1


def test_trace_context_wire_round_trips_across_packages():
    """A port context's ``to_wire()`` through the rpc codec and the
    reference's ``from_wire()`` comes back with equal fields, and the
    other way round; ``child`` keeps the trace and links its parent."""
    p_ctx = pdist.mint(rid=5, seed=11, deadline_abs=123.5).child()
    assert p_ctx.parent_id and p_ctx.trace_id
    r_back = rdist.TraceContext.from_wire(
        ref_rpc.decode(bytes(port_rpc.encode(p_ctx.to_wire()))))
    assert r_back.to_wire() == p_ctx.to_wire()
    r_ctx = rdist.mint(rid=7, seed=3, trace_id="00ff00ff00ff00ff")
    p_back = pdist.TraceContext.from_wire(
        port_rpc.decode(bytes(ref_rpc.encode(r_ctx.to_wire()))))
    assert (p_back.trace_id, p_back.span_id, p_back.rid, p_back.seed,
            p_back.deadline_abs) == (r_ctx.trace_id, r_ctx.span_id, 7, 3,
                                     0.0)
    assert pdist.TraceContext.from_wire(("a" * 16, "b" * 8)).rid == -1
    with pytest.raises(ValueError):
        pdist.TraceContext.from_wire((1, 2))
    assert pdist.current() is None
    with pdist.use(p_back):
        assert pdist.current() is p_back
        pt.instant("t_ctx_event")
    ev = [e for e in pt.trace_events() if e["name"] == "t_ctx_event"][-1]
    assert ev["args"]["trace_id"] == r_ctx.trace_id


def test_slo_tracker_equals_reference():
    """The same latency observations through a port and a reference
    ``SLOTracker`` (own registries, a pinned clock) give the same p99,
    burn rates and breach state."""
    now = [0.0]
    trackers = []
    for pkg, dmod in ((pt, pdist), (rt, rdist)):
        reg = pkg.MetricsRegistry()
        h = reg.histogram("serve_token_latency_ms", "gaps",
                          buckets=pkg.LATENCY_MS_BUCKETS)
        trackers.append((h, dmod.SLOTracker(
            {"token": 20.0}, window_s=1.0, registry=reg,
            clock=lambda: now[0], labels={"model": f"t_{pkg.__name__}"})))
    rng = np.random.default_rng(0)
    results = [[], []]
    for tick in range(4):
        vals = rng.exponential(12.0, 40)
        for i, (h, tr) in enumerate(trackers):
            for v in vals:
                h.observe(float(v))
            now[0] = tick + 1.0
            results[i].append(tr.tick())
    assert results[0] == results[1]
    assert trackers[0][1].describe() == trackers[1][1].describe()
    assert pdist.SLOTracker.from_spec({"ttft_ms": 0}) is None
    with pytest.raises(ValueError):
        pdist.SLOTracker({"bogus": 1.0})


def test_registry_server_serves_the_process_registry():
    """With no registry given, a ``RegistryServer`` serves the process
    one; ``federate_text`` of it parses back the gauge a caller set."""
    pt.gauge("t_served_gauge", "g", program="x").set(0.25)
    srv = pt.RegistryServer(port=0, process="smoke", secret=b"")
    try:
        proc, snap = pdist.scrape_peer("127.0.0.1", srv.port, secret=b"")
        text = pdist.federate_text(pt.MetricsRegistry(),
                                   [("127.0.0.1", srv.port)],
                                   process="reader", secret=b"")
    finally:
        srv.close()
    assert proc == "smoke"
    assert pt.parse_prometheus(text)["samples"][
        ("mxtpu_t_served_gauge", (("process", "smoke"),
                                  ("program", "x")))] == 0.25
