"""The port's checkpoint store (``mxtpu_torch.checkpoint``) and the
manifest trio of ``mxtpu_torch.base`` on the CPU.

Contracts: ``manifest_commit`` writes the reference's bytes, each
package reads the other's commits and refuses a torn one; the publish
pointer crosses the packages; ``describe_tree_mismatch`` gives the
reference's text; the port's format round-trips f32, bf16, int8 and
int32 leaves bit for bit (the tiny llama tree and a ``TrainState`` with
scalars too), checks a tree against ``abstract_state`` before reading a
leaf, and detects, counts and skips a torn step; ``CheckpointManager``
keeps the reference's save interval, ``force``, retention, fallback,
journal and publish-seq rules (``tests/test_checkpoint.py`` and
``tests/test_flywheel.py``'s seams); an async save is joined with a
bounded wait; ``PreemptionGuard`` turns SIGTERM into one final save
(in a fresh interpreter, with a deadline).
"""
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import llama_refs
from mxtpu import base as j_base
from mxtpu import checkpoint as j_ckpt
from mxtpu_torch import base, checkpoint, telemetry
from mxtpu_torch.base import ManifestError, MXNetError
from mxtpu_torch.checkpoint import CheckpointManager
from mxtpu_torch.models import llama as tl
from mxtpu_torch.parallel import optim, step as pstep

torch.set_num_threads(2)   # a CPU share for each xdist worker

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WAIT = 60.0                # every join and subprocess wait


def _join(fn, *args):
    """Run ``fn`` on a thread and join it with a bound."""
    out = {}
    t = threading.Thread(target=lambda: out.update(r=fn(*args)),
                         daemon=True)
    t.start()
    t.join(WAIT)
    assert not t.is_alive(), f"{fn} did not finish in {WAIT} s"
    return out.get("r")


def _bytes(t):
    return t.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy().tobytes()


def _same_tree(a, b):
    """Equal structure, types and leaves bit for bit."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, torch.Tensor):
        assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape, b.device)
        assert _bytes(a) == _bytes(b)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# the manifest trio, across the packages
# ---------------------------------------------------------------------------
def test_manifest_commit_byte_equal_and_read_across(tmp_path):
    data = np.random.default_rng(0).bytes(4097)
    for name, mod in (("port", base), ("ref", j_base)):
        os.makedirs(tmp_path / name)
        mod.manifest_commit(str(tmp_path / name / "blob.mxj"), data)
    for suffix in ("", ".payload"):
        assert (tmp_path / "port" / f"blob.mxj{suffix}").read_bytes() == \
            (tmp_path / "ref" / f"blob.mxj{suffix}").read_bytes()
    assert base.manifest_read(str(tmp_path / "ref" / "blob.mxj")) == data
    assert j_base.manifest_read(str(tmp_path / "port" / "blob.mxj")) \
        == data


@pytest.mark.parametrize("tear", ["manifest", "payload", "checksum"])
def test_torn_manifest_commit_raises_in_both(tmp_path, tear):
    path = str(tmp_path / "blob.mxj")
    base.manifest_commit(path, b"the committed payload")
    if tear == "manifest":
        open(path, "wb").write(b"{torn")
    elif tear == "payload":
        os.unlink(path + ".payload")
    else:
        open(path + ".payload", "wb").write(b"the committed paylOad")
    with pytest.raises(ManifestError):
        base.manifest_read(path)
    with pytest.raises(j_base.ManifestError):
        j_base.manifest_read(path)
    with pytest.raises(FileNotFoundError):
        base.manifest_read(str(tmp_path / "absent.mxj"))


def test_publish_pointer_crosses_packages(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    os.makedirs(a)
    os.makedirs(b)
    assert checkpoint.read_published(a) is None
    mine = checkpoint.publish_pointer(a, 4, seq=1, generation=2, loss=0.5)
    theirs = j_ckpt.publish_pointer(b, 4, seq=1, generation=2, loss=0.5)
    for got, want in ((j_ckpt.read_published(a), mine),
                      (checkpoint.read_published(b), theirs)):
        assert {k: v for k, v in got.items() if k != "time"} == \
            {k: v for k, v in want.items() if k != "time"} == \
            {"step": 4, "seq": 1, "generation": 2, "loss": 0.5}
    assert checkpoint.published_path(a) == j_ckpt.published_path(a)
    open(checkpoint.published_path(a), "wb").write(b"torn by chaos")
    with pytest.raises(ManifestError):
        checkpoint.read_published(a)
    with pytest.raises(j_base.ManifestError):
        j_ckpt.read_published(a)


# ---------------------------------------------------------------------------
# describe_tree_mismatch: the reference's text
# ---------------------------------------------------------------------------
def _trees(case):
    """(expected, saved) as numpy shapes; each package builds its own."""
    exp = {"w": (3, 2), "b": {"c": (4,)}, "s": ()}
    sav = {"w": (3, 2), "b": {"c": (4,)}, "s": ()}
    if case == "missing":
        del sav["b"]
    elif case == "extra":
        sav["b"]["d"] = (2, 2)
    elif case == "shape":
        sav["w"] = (4, 2)
    return exp, sav


def _build(shapes, make):
    return {k: _build(v, make) if isinstance(v, dict) else make(v)
            for k, v in shapes.items()}


@pytest.mark.parametrize("case", ["missing", "extra", "shape", "same"])
def test_describe_tree_mismatch_matches_reference(case):
    exp, sav = _trees(case)
    port = checkpoint.describe_tree_mismatch(
        _build(exp, torch.zeros), _build(sav, torch.zeros))
    ref = j_ckpt.describe_tree_mismatch(
        _build(exp, jnp.zeros), _build(sav, jnp.zeros))
    assert port == ref
    assert (port is None) == (case == "same")


# ---------------------------------------------------------------------------
# the port's format
# ---------------------------------------------------------------------------
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int32": torch.int32}


def _leaf(rng, dtype, shape):
    if dtype == "bfloat16":
        bits = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    if dtype == "float32":
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    info = np.iinfo(dtype)
    return torch.from_numpy(rng.integers(info.min, info.max, shape,
                                         dtype=dtype, endpoint=True))


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_save_load_round_trip_bit_exact(tmp_path, dtype):
    rng = np.random.default_rng(1)
    tree = {"m": _leaf(rng, dtype, (5, 7)), "s": _leaf(rng, dtype, ()),
            "e": _leaf(rng, dtype, (0, 3)),
            "v": [_leaf(rng, dtype, (129,)), (_leaf(rng, dtype, (2, 2)),)]}
    checkpoint.save_state(str(tmp_path / "ck"), tree)
    back = checkpoint.load_state(str(tmp_path / "ck"), device="cpu")
    _same_tree(tree, back)
    assert back["m"].dtype == _DTYPES[dtype]
    man = json.loads(base.manifest_read(str(tmp_path / "ck" /
                                            checkpoint.MANIFEST)))
    assert [r["dtype"] for r in man["leaves"]] == [dtype] * 5
    # a save over the same path replaces it
    tree["m"] = _leaf(rng, dtype, (5, 7))
    checkpoint.save_state(str(tmp_path / "ck"), tree)
    _same_tree(tree, checkpoint.load_state(str(tmp_path / "ck"),
                                           device="cpu"))


def test_save_load_tiny_llama_tree(tmp_path):
    params = tl.params_from_numpy(
        jax.tree.map(np.asarray, llama_refs.serve_weights(0)), device="cpu")
    bf16 = {k: ({kk: vv.bfloat16() for kk, vv in v.items()}
                if isinstance(v, dict) else v.bfloat16())
            for k, v in params.items()}
    for name, tree in (("f32", params), ("bf16", bf16)):
        checkpoint.save_state(str(tmp_path / name), tree)
        _same_tree(tree, checkpoint.load_state(str(tmp_path / name),
                                               device="cpu"))


def _train_state(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": torch.from_numpy(rng.standard_normal((3, 2)).astype(
        np.float32)), "b": torch.zeros(2)}
    state = pstep.init_state(params, optim.adamw(1e-2))
    return state._replace(model_state={"scale": 2.5, "n": 3,
                                       "tag": "bn", "none": None})


def test_save_load_train_state_with_scalars(tmp_path):
    state = _train_state()
    checkpoint.save_state(str(tmp_path / "ts"), state)
    back = checkpoint.load_state(str(tmp_path / "ts"), device="cpu")
    _same_tree(state, back)
    assert type(back) is pstep.TrainState
    assert type(back.opt_state) is optim.ScaleByAdamState
    # into an abstract state: its types, devices and dtypes
    fresh = _train_state(seed=9)
    into = checkpoint.load_state(str(tmp_path / "ts"),
                                 abstract_state=fresh)
    _same_tree(state, into)


def test_load_state_mismatch_raises_diagnosed(tmp_path):
    checkpoint.save_state(str(tmp_path / "ck"),
                          {"w": torch.zeros(3, 2), "b": torch.ones(2)})
    live = {"w": torch.zeros(4, 2), "b": torch.ones(2)}
    want = j_ckpt.describe_tree_mismatch(
        {"w": jnp.zeros((4, 2)), "b": jnp.ones(2)},
        {"w": jnp.zeros((3, 2)), "b": jnp.ones(2)})
    with pytest.raises(MXNetError) as ei:
        checkpoint.load_state(str(tmp_path / "ck"), abstract_state=live)
    assert str(ei.value).endswith(want), (str(ei.value), want)
    with pytest.raises(MXNetError, match="'c' .* is missing"):
        checkpoint.load_state(str(tmp_path / "ck"), abstract_state=dict(
            live, c=torch.zeros(1)))


def test_load_state_needs_a_device_or_the_card(tmp_path):
    checkpoint.save_state(str(tmp_path / "ck"), {"w": torch.zeros(3)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            checkpoint.load_state(str(tmp_path / "ck"))
    # a leaf of an abstract state on the meta device takes device=
    out = checkpoint.load_state(
        str(tmp_path / "ck"),
        abstract_state={"w": torch.empty(3, dtype=torch.bfloat16,
                                         device="meta")}, device="cpu")
    assert out["w"].device.type == "cpu" and \
        out["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("tear", ["truncated_leaf", "flipped_byte",
                                  "no_manifest", "torn_manifest"])
def test_torn_checkpoint_raises(tmp_path, tear):
    path = tmp_path / "ck"
    checkpoint.save_state(str(path), {"w": torch.arange(64.0),
                                      "b": torch.ones(3)})
    if tear == "truncated_leaf":
        (path / "leaf_0.bin").write_bytes((path / "leaf_0.bin")
                                          .read_bytes()[:100])
    elif tear == "flipped_byte":
        raw = bytearray((path / "leaf_1.bin").read_bytes())
        raw[0] ^= 1
        (path / "leaf_1.bin").write_bytes(bytes(raw))
    elif tear == "no_manifest":
        os.unlink(path / checkpoint.MANIFEST)
    else:
        (path / (checkpoint.MANIFEST + ".payload")).write_bytes(b"{}")
    with pytest.raises(ManifestError):
        checkpoint.load_state(str(path), device="cpu")


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------
def _tree(v):
    return {"w": torch.full((4,), float(v)), "i": torch.tensor(v)}


def test_manager_interval_force_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2,
                            save_interval_steps=2, async_save=False)
    assert [mgr.save(i, _tree(i)) for i in range(5)] == \
        [True, False, True, False, True]
    assert mgr.all_steps() == [2, 4] and mgr.latest_step() == 4
    assert not mgr.save(3, _tree(3))            # at or below the latest
    assert mgr.save(5, _tree(5), force=True)    # off the interval
    assert mgr.all_steps() == [4, 5]
    with pytest.raises(checkpoint.StepAlreadyExistsError):
        mgr.save(5, _tree(5), force=True)
    _same_tree(mgr.restore(device="cpu"), _tree(5))
    _same_tree(mgr.restore(4, device="cpu"), _tree(4))
    mgr.close()


def test_manager_torn_latest_falls_back_counted(tmp_path):
    reg = telemetry.registry()
    f0 = reg.value("checkpoint_total", kind="fallback")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3, async_save=False)
    for i in range(3):
        mgr.save(i, _tree(i))
    leaf = tmp_path / "2" / "leaf_0.bin"
    leaf.write_bytes(leaf.read_bytes()[:5])
    with pytest.warns(RuntimeWarning, match="falling back"):
        back = mgr.restore(device="cpu")
    _same_tree(back, _tree(1))                  # never the torn step
    assert reg.value("checkpoint_total", kind="fallback") - f0 == 1
    # an explicit step never falls back; fallback=False never scans
    with pytest.raises(ManifestError):
        mgr.restore(2, device="cpu")
    with pytest.raises(ManifestError):
        mgr.restore(fallback=False, device="cpu")
    assert reg.value("checkpoint_total", kind="fallback") - f0 == 1
    # a step whose manifest never committed is written over by a later
    # save of that step; one with a committed manifest is not
    with pytest.raises(checkpoint.StepAlreadyExistsError):
        mgr.save(2, _tree(2), force=True)
    os.unlink(tmp_path / "2" / checkpoint.MANIFEST)
    assert mgr.save(2, _tree(2), force=True)
    _same_tree(mgr.restore(device="cpu"), _tree(2))
    mgr.close()


@pytest.mark.parametrize("entry", ["restore", "restore_with_journal"])
@pytest.mark.parametrize("fault", ["no_card", "out_of_memory", "mismatch"])
def test_manager_placement_error_raises_not_falls_back(tmp_path,
                                                       monkeypatch, entry,
                                                       fault):
    """Only a torn step falls back: an error of the device or of the
    caller's tree on an intact latest step raises, uncounted, and never
    loads the older step."""
    reg = telemetry.registry()
    f0 = reg.value("checkpoint_total", kind="fallback")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3, async_save=False)
    for i in range(3):
        mgr.save(i, _tree(i))
        mgr.save_journal(i, {"cursor": i})
    kw = {"device": "cpu"}
    if fault == "no_card":
        def no_card(device=None):
            raise RuntimeError("no CUDA card is visible")
        monkeypatch.setattr(checkpoint, "resolve_device", no_card)
        want = RuntimeError
    elif fault == "out_of_memory":
        read = checkpoint._read_leaf

        def oom(dirpath, *args):
            if os.path.basename(dirpath) == "2":
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return read(dirpath, *args)
        monkeypatch.setattr(checkpoint, "_read_leaf", oom)
        want = torch.cuda.OutOfMemoryError
    else:
        kw["abstract_state"] = {"w": torch.zeros(4)}
        want = MXNetError
    with pytest.raises(want) as err:
        getattr(mgr, entry)(**kw)
    assert not isinstance(err.value, ManifestError)
    assert reg.value("checkpoint_total", kind="fallback") == f0
    mgr.close()


def test_manager_journal_and_restore_with_journal(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, async_save=False)
    for i in range(4):
        mgr.save(i, _tree(i))
        mgr.save_journal(i, {"cursor": 10 * i})
    # pruned with the steps they belong to
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.endswith(".mxj")) == ["journal_2.mxj",
                                             "journal_3.mxj"]
    assert mgr.load_journal(3) == {"cursor": 30, "step": 3}
    # the reference reads the port's journal
    assert json.loads(j_base.manifest_read(mgr.journal_path(3))) == \
        {"cursor": 30, "step": 3}
    open(mgr.journal_path(3), "wb").write(b"torn")
    with pytest.warns(RuntimeWarning, match="journal step 3"):
        state, journal, step = mgr.restore_with_journal(device="cpu")
    assert (journal, step) == ({"cursor": 20, "step": 2}, 2)
    _same_tree(state, _tree(2))
    mgr.close()


def test_manager_publish_seq_and_torn_pointer(tmp_path):
    """``tests/test_flywheel.py``'s manager seam: publish defaults to the
    latest step and refuses an empty directory; a torn pointer reads as
    unpublished (counted, warned); the seq floors at a prior pointer."""
    reg = telemetry.registry()
    f0 = reg.value("checkpoint_total", kind="fallback")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    with pytest.raises(FileNotFoundError):
        mgr.publish()
    mgr.save(2, {"w": np.zeros(2, np.float32)})
    rec = mgr.publish(loss=0.5)
    assert (rec["step"], rec["seq"], rec["loss"]) == (2, 1, 0.5)
    mgr.save(4, {"w": np.ones(2, np.float32)})
    assert mgr.publish()["seq"] == 2
    assert j_ckpt.read_published(str(tmp_path))["step"] == 4
    with open(checkpoint.published_path(str(tmp_path)), "wb") as f:
        f.write(b"garbage")
    with pytest.warns(RuntimeWarning, match="treating as unpublished"):
        assert mgr.latest_published() is None
    assert reg.value("checkpoint_total", kind="fallback") - f0 == 1
    mgr.close()
    # a fresh manager floors its seq at the last readable pointer, the
    # reference's included
    j_ckpt.publish_pointer(str(tmp_path), 2, seq=7)
    mgr2 = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr2.publish(4)["seq"] == 8
    mgr2.close()


def test_manager_async_save_copies_then_writes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, async_save=True)
    live = {"w": torch.zeros(1 << 16)}
    for i in range(3):
        live["w"].fill_(float(i))
        assert mgr.save(i, live)
        live["w"].fill_(-1.0)          # the step overwrites its buffers
    _join(mgr.wait_until_finished)
    assert mgr.all_steps() == [1, 2]
    for i in (1, 2):
        assert torch.equal(mgr.restore(i, device="cpu")["w"],
                           torch.full((1 << 16,), float(i)))
    # publish waits out the write in flight
    live["w"].fill_(3.0)
    mgr.save(3, live)
    assert _join(mgr.publish)["step"] == 3
    _join(mgr.close)


def test_manager_refuses_a_leaf_it_cannot_store(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(0, {"w": torch.zeros(2)})
    with pytest.raises(TypeError, match="cannot checkpoint a leaf"):
        mgr.save(1, {"w": torch.zeros(2), "o": object()})
    _join(mgr.wait_until_finished)
    assert mgr.all_steps() == [0]


_GUARD = r"""
import os, signal, sys, time
sys.path.insert(0, {repo!r})
import torch
from mxtpu_torch import checkpoint
mgr = checkpoint.CheckpointManager(sys.argv[1], save_interval_steps=100,
                                   async_save=True)
state = {{"w": torch.zeros(8)}}
with checkpoint.PreemptionGuard(mgr) as guard:
    for i in range(1, 1000):
        state["w"].fill_(float(i))
        mgr.save(i, state)              # off the interval: no save
        if i == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        if guard.preempted:
            guard.save_now(i, state)
            break
        time.sleep(0.01)
print("STOPPED", i, guard.signum, mgr.all_steps(), flush=True)
"""


def test_preemption_guard_sigterm_final_save(tmp_path):
    d = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", _GUARD.format(repo=REPO), d], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=WAIT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"STOPPED 3 {int(__import__('signal').SIGTERM)} [3]" in \
        res.stdout, res.stdout
    mgr = CheckpointManager(d, async_save=False)
    assert torch.equal(mgr.restore(device="cpu")["w"], torch.full((8,), 3.0))
