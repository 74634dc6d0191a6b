"""Checkpoint/resume on one device — the port of ``mxtpu/checkpoint.py``:
step-indexed checkpoints with retention, async saves, the torn-step
fallback, the data-position journal, the train→serve publish pointer,
``PreemptionGuard`` and the one-shot ``save_state``/``load_state``.

The reference stores trees with orbax (tensorstore/ocdbt), which are
jax libraries, so the port keeps its own format:

- A checkpoint is a directory holding one raw little-endian file per
  tensor leaf (``leaf_<i>.bin``, the leaf's bytes in C order: bf16 as
  its 16-bit patterns, int8 as int8) and a manifest committed LAST
  through ``base.manifest_commit`` (``manifest.mxc`` and its
  ``.payload``). The manifest's JSON holds the tree's structure (dict
  keys, NamedTuple type and field names, tuples and lists, and
  non-tensor scalar leaves) and, for each tensor leaf, its key path,
  dtype name, shape, byte count and sha256.
- A directory without a valid manifest, or with a leaf whose size or
  hash disagrees with it, is torn: reading it raises
  :class:`~mxtpu_torch.base.ManifestError`, and ``restore()`` of the
  latest step falls back to the previous one and counts it, where the
  reference's orbax read would raise.
- Nothing is pickled, and a tree is never one ``bytes`` object: each
  leaf is copied to the host, hashed and written on its own (a few at a
  time, on a small thread pool), so a 16 GB tree costs its leaves'
  buffers, not twice the tree. Only the manifest goes through
  ``manifest_commit``.
- A save writes into a ``<step>.partial-*`` directory and renames it to
  ``<step>`` once the manifest is committed, so a save cut short never
  shows as a step.
- Restore builds the tree once, on its device: each leaf goes to its
  ``abstract_state`` leaf's device and dtype (the tree is first checked
  against it, path by path, as the reference does), or without one to
  ``device=``, which is the card unless told otherwise.
- Async mode copies every leaf to the host inside ``save`` (the step may
  overwrite its buffers right after: the port's train step updates the
  params in place), then one background writer thread does the file
  I/O; ``wait_until_finished`` joins it, and a new save first waits for
  the one in flight.

Cross-mesh restore (resharding onto another data-parallel width) comes
with the multi-device slice.
"""
from __future__ import annotations

import collections
import hashlib
import importlib
import json as _json
import os
import shutil
import signal as _signal
import sys
import threading
import time as _time
import uuid
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .base import (DTYPES, ManifestError, MXNetError, dtype_name,
                   manifest_commit, manifest_read)
from .context import resolve_device
from .parallel._tree import path_str, tree_flatten_with_path

__all__ = ["CheckpointManager", "PreemptionGuard", "StepAlreadyExistsError",
           "save_state", "load_state", "describe_tree_mismatch",
           "published_path", "publish_pointer", "read_published"]

#: the versioned publish pointer: a manifest-committed JSON file naming
#: the checkpoint step the trainer declares ready to SERVE. The serve
#: side never scans the step directories — it subscribes to this one
#: file. Same name and bytes as the reference's, so either package
#: reads the other's pointer.
PUBLISHED_POINTER = "latest-published.mxp"

MANIFEST = "manifest.mxc"
FORMAT = "mxtpu_torch-checkpoint"
_CHUNK = 64 << 20          # bytes hashed and written at a time
_IO_WORKERS = 8            # leaves written or read at once


class StepAlreadyExistsError(MXNetError):
    """A committed checkpoint already holds this step (orbax raises its
    own error of this name)."""


# what a torn or vanished step raises when it is read: only these fall
# back. A device or placement error (no card, out of memory) is not the
# checkpoint's and raises, lest an older step load silently
_TORN = (ManifestError, OSError)


def published_path(directory: str) -> str:
    return os.path.join(os.path.abspath(directory), PUBLISHED_POINTER)


def publish_pointer(directory: str, step: int, *, seq: int,
                    **meta: Any) -> dict:
    """Atomically commit the ``latest-published`` pointer for
    ``directory`` (manifest-committed like the data-position journal,
    so a kill mid-publish leaves either the previous pointer or a
    detectably-torn one — never a half-written step number). ``seq``
    is the monotonically increasing publish sequence the subscriber
    uses to tell "new candidate" from "same pointer re-read"."""
    rec = dict(meta, step=int(step), seq=int(seq), time=_time.time())
    manifest_commit(published_path(directory),
                    _json.dumps(rec).encode())
    return rec


def read_published(directory: str) -> Optional[dict]:
    """Validated read of the ``latest-published`` pointer: the pointer
    dict (``step``/``seq``/publisher metadata), or None when nothing
    has ever been published. A TORN pointer raises
    :class:`~mxtpu_torch.base.ManifestError` — subscribers skip it the
    way ``restore()`` skips a torn step, they do not guess."""
    try:
        raw = manifest_read(published_path(directory))
    except FileNotFoundError:
        return None
    return _json.loads(raw)


def _metrics():
    """Checkpoint telemetry handles, created lazily so importing this
    module never initializes the registry (and a disabled run gets
    no-ops)."""
    from . import telemetry
    return {
        "save_s": telemetry.histogram(
            "checkpoint_save_seconds",
            "Checkpoint save dispatch time (async mode: time to hand "
            "the write to the background committer).",
            buckets=telemetry.SECONDS_BUCKETS),
        "restore_s": telemetry.histogram(
            "checkpoint_restore_seconds",
            "Checkpoint restore time (disk -> placed train state).",
            buckets=telemetry.SECONDS_BUCKETS),
        "total": lambda kind: telemetry.counter(
            "checkpoint_total",
            "Checkpoint operations by kind (save/restore/fallback/"
            "journal/publish).", kind=kind),
    }


def _flight(kind: str, name: str, **fields) -> None:
    """A flight record when telemetry is on; never breaks the caller."""
    try:
        from . import telemetry
        if telemetry.enabled():
            telemetry.flight().record(kind, name, **fields)
    except Exception:
        pass


def describe_tree_mismatch(expected: Any, saved: Any) -> Optional[str]:
    """Human diagnosis of why ``saved`` cannot restore into
    ``expected``: the FIRST mismatched key path / shape, or None when
    the trees are structurally compatible (the failure was something
    else). The reference's text for the same trees."""

    def _paths(tree):
        return {path_str(path): tuple(getattr(leaf, "shape", ()))
                for path, leaf in tree_flatten_with_path(tree)}

    try:
        exp, sav = _paths(expected), _paths(saved)
    except Exception:
        return None
    for name in sorted(exp):
        if name not in sav:
            return (f"expected key {name!r} "
                    f"(shape {exp[name]}) is missing from the saved "
                    "state")
    for name in sorted(sav):
        if name not in exp:
            return (f"saved state has unexpected key {name!r} "
                    f"(shape {sav[name]})")
    for name in sorted(exp):
        if exp[name] != sav[name]:
            return (f"key {name!r} was saved with shape {sav[name]} "
                    f"but the live tree expects {exp[name]}")
    return None


# ---------------------------------------------------------------------------
# the format: a tree as (structure, tensor leaves) and back
# ---------------------------------------------------------------------------
class _Saved:
    """A saved tensor leaf before it is read: what the structural check
    compares (``shape``) without touching the leaf's file."""
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape, self.dtype = shape, dtype


def _encode(tree: Any, leaves: List[Tuple[str, torch.Tensor]],
            path: Tuple) -> Dict[str, Any]:
    """The JSON structure of ``tree``; its tensor leaves are appended to
    ``leaves`` as ``(key path, tensor)``."""
    if isinstance(tree, (np.ndarray, np.generic)):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        leaves.append(("/".join(path), tree))
        return {"leaf": len(leaves) - 1}
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, (str, int)) or isinstance(k, bool):
                raise TypeError(f"cannot checkpoint a dict key {k!r} "
                                "(str and int keys only)")
        return {"dict": [[k, _encode(v, leaves, path + (str(k),))]
                         for k, v in tree.items()]}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        return {"namedtuple": f"{cls.__module__}:{cls.__qualname__}",
                "fields": list(tree._fields),
                "items": [_encode(v, leaves, path + (f,))
                          for f, v in zip(tree._fields, tree)]}
    if isinstance(tree, (tuple, list)):
        return {type(tree).__name__: [_encode(v, leaves, path + (str(i),))
                                      for i, v in enumerate(tree)]}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"cannot checkpoint a leaf of type "
                    f"{type(tree).__name__} at {'/'.join(path)!r}")


def _namedtuple_type(spec: str, fields: List[str]):
    """The NamedTuple class a manifest names: the class itself when its
    module is loaded (or is the port's own) and its fields agree, else a
    plain ``collections.namedtuple`` of the same name and fields."""
    mod_name, _, qual = spec.partition(":")
    mod = sys.modules.get(mod_name)
    if mod is None and (mod_name == "mxtpu_torch"
                        or mod_name.startswith("mxtpu_torch.")):
        try:
            mod = importlib.import_module(mod_name)
        except ImportError:
            mod = None
    obj = mod
    for part in qual.split("."):
        obj = getattr(obj, part, None)
    if isinstance(obj, type) and getattr(obj, "_fields", None) \
            == tuple(fields):
        return obj
    return collections.namedtuple(qual.rsplit(".", 1)[-1], fields)


def _decode(spec: Dict[str, Any], values: Dict[int, Any]) -> Any:
    if "leaf" in spec:
        return values[spec["leaf"]]
    if "value" in spec:
        return spec["value"]
    if "dict" in spec:
        return {k: _decode(v, values) for k, v in spec["dict"]}
    if "list" in spec:
        return [_decode(v, values) for v in spec["list"]]
    if "tuple" in spec:
        return tuple(_decode(v, values) for v in spec["tuple"])
    if "namedtuple" in spec:
        cls = _namedtuple_type(spec["namedtuple"], spec["fields"])
        return cls(*(_decode(v, values) for v in spec["items"]))
    raise ManifestError(f"unknown tree node {spec!r} in a manifest")


def _host_leaf(t: torch.Tensor, copy: bool) -> torch.Tensor:
    """The leaf as a contiguous CPU tensor; ``copy`` forces a copy even
    for a CPU leaf (an async save must not alias the live state)."""
    t = t.detach()
    if t.device.type != "cpu":
        return t.to("cpu").contiguous()
    return t.clone(memory_format=torch.contiguous_format) if copy \
        else t.contiguous()


def _write_leaf(dirpath: str, i: int, path: str,
                t: torch.Tensor) -> Dict[str, Any]:
    name = f"leaf_{i}.bin"
    data = memoryview(t.reshape(-1).view(torch.uint8).numpy())
    h = hashlib.sha256()
    with open(os.path.join(dirpath, name), "wb") as f:
        for off in range(0, len(data), _CHUNK):
            piece = data[off:off + _CHUNK]
            h.update(piece)
            f.write(piece)
        f.flush()
        os.fsync(f.fileno())
    return {"path": path, "file": name, "dtype": dtype_name(t.dtype),
            "shape": list(t.shape), "bytes": len(data),
            "sha256": h.hexdigest()}


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_dir(final: str, spec: Dict[str, Any],
               leaves: List[Tuple[str, torch.Tensor]]) -> None:
    """Write a tree (its ``_encode`` structure and ``(key path, tensor)``
    leaves) as a checkpoint directory at ``final``, replacing one that is
    there: leaves into a partial directory, the manifest last, then the
    rename."""
    final = os.path.abspath(final)
    parent = os.path.dirname(final)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{final}.partial-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    try:
        with ThreadPoolExecutor(max(1, min(_IO_WORKERS, len(leaves)))) \
                as pool:
            records = list(pool.map(
                lambda ip: _write_leaf(tmp, ip[0], ip[1][0],
                                       _host_leaf(ip[1][1], copy=False)),
                enumerate(leaves)))
        manifest_commit(os.path.join(tmp, MANIFEST), _json.dumps(
            {"format": FORMAT, "version": 1, "tree": spec,
             "leaves": records}).encode())
        _fsync_dir(tmp)
        old = None
        if os.path.lexists(final):
            old = f"{final}.old-{uuid.uuid4().hex[:8]}"
            os.rename(final, old)
        os.rename(tmp, final)
        _fsync_dir(parent)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _read_manifest(dirpath: str) -> Dict[str, Any]:
    """The checkpoint's manifest, validated (``ManifestError`` when it is
    torn or foreign, ``FileNotFoundError`` when there is none)."""
    if not os.path.isdir(dirpath):
        raise FileNotFoundError(f"no checkpoint at {dirpath!r}")
    try:
        raw = manifest_read(os.path.join(dirpath, MANIFEST))
    except FileNotFoundError as e:
        raise ManifestError(f"checkpoint {dirpath!r} has no manifest: "
                            "torn") from e
    try:
        man = _json.loads(raw)
        if man.get("format") != FORMAT or man.get("version") != 1:
            raise ValueError(f"format {man.get('format')!r} version "
                             f"{man.get('version')!r}")
        for rec in man["leaves"]:
            if os.path.basename(rec["file"]) != rec["file"] \
                    or rec["dtype"] not in DTYPES:
                raise ValueError(f"bad leaf record {rec!r}")
    except Exception as e:
        raise ManifestError(f"checkpoint manifest in {dirpath!r} is not "
                            f"a {FORMAT} v1 manifest ({e!r})") from e
    return man


def _read_leaf(dirpath: str, rec: Dict[str, Any], device: torch.device,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    fpath = os.path.join(dirpath, rec["file"])
    try:
        raw = np.fromfile(fpath, dtype=np.uint8)
    except OSError as e:
        raise ManifestError(f"leaf {rec['path']!r} of {dirpath!r} cannot "
                            f"be read ({e}): torn") from e
    if raw.size != int(rec["bytes"]) \
            or hashlib.sha256(memoryview(raw)).hexdigest() != rec["sha256"]:
        raise ManifestError(
            f"leaf {rec['path']!r} of {dirpath!r} does not match its "
            f"manifest (size {raw.size} vs {rec['bytes']}): torn")
    dt = DTYPES[rec["dtype"]]
    t = torch.from_numpy(raw).view(dt).reshape(rec["shape"]) if raw.size \
        else torch.empty(rec["shape"], dtype=dt)
    return t.to(device=device, dtype=dtype or t.dtype)


def _read_dir(dirpath: str, abstract_state: Any = None,
              device=None) -> Any:
    """Read a checkpoint directory: the tree of the manifest, or
    ``abstract_state``'s structure filled with the saved leaves, each on
    its abstract leaf's device and dtype (a leaf on the ``meta`` device
    takes ``device=``'s)."""
    dirpath = os.path.abspath(dirpath)
    man = _read_manifest(dirpath)
    recs = man["leaves"]
    if abstract_state is not None:
        saved = _decode(man["tree"], {
            i: _Saved(tuple(r["shape"]), r["dtype"])
            for i, r in enumerate(recs)})
        why = describe_tree_mismatch(abstract_state, saved)
        if why is not None:
            raise MXNetError(f"checkpoint at {dirpath!r} does not match "
                             f"the provided state tree: {why}")
        live = {path_str(p): leaf for p, leaf in
                tree_flatten_with_path(abstract_state)}
    else:
        live = {}
    fallback = None

    def target(rec):
        nonlocal fallback
        leaf = live.get(rec["path"])
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
            return leaf.device, leaf.dtype
        if fallback is None:
            fallback = resolve_device(device)
        return fallback, (leaf.dtype if isinstance(leaf, torch.Tensor)
                          else None)

    placed = [target(r) for r in recs]
    with ThreadPoolExecutor(max(1, min(_IO_WORKERS, len(recs)))) as pool:
        values = list(pool.map(
            lambda i: _read_leaf(dirpath, recs[i], *placed[i]),
            range(len(recs))))
    tree = _decode(man["tree"], dict(enumerate(values)))
    if abstract_state is None:
        return tree
    restored = {path_str(p): leaf for p, leaf in
                tree_flatten_with_path(tree)}
    return _refill(abstract_state, restored, ())


def _refill(abstract: Any, restored: Dict[str, Any], path: Tuple) -> Any:
    """``abstract``'s structure with each leaf the restored one at its
    key path."""
    if abstract is None:
        return None
    if isinstance(abstract, dict):
        return {k: _refill(v, restored, path + (str(k),))
                for k, v in abstract.items()}
    if isinstance(abstract, tuple) and hasattr(abstract, "_fields"):
        return type(abstract)(*(_refill(v, restored, path + (f,))
                                for f, v in zip(abstract._fields,
                                                abstract)))
    if isinstance(abstract, (tuple, list)):
        return type(abstract)(_refill(v, restored, path + (str(i),))
                              for i, v in enumerate(abstract))
    return restored["/".join(path)]


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------
class CheckpointManager:
    """Step-indexed checkpoints with retention + optional async saves
    (the reference's orbax manager, over the port's format). A step is
    the directory ``<directory>/<step>``."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1, async_save: bool = True):
        if save_interval_steps < 1:
            raise ValueError(f"save_interval_steps must be >= 1, got "
                             f"{save_interval_steps}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = int(save_interval_steps)
        self.async_save = bool(async_save)
        self._m = _metrics()
        self._pub_seq = 0   # publish sequence floor (see publish())
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None

    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        return step % self.save_interval_steps == 0

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save a tree at ``step`` (no-op off the save interval, or at or
        below the latest step, unless ``force``). Async mode copies the
        leaves to the host here and returns; the write completes in the
        background (call wait_until_finished() before exiting).
        ``force=True`` ignores the save interval — the preemption
        final-save path. A step already committed raises
        :class:`StepAlreadyExistsError`."""
        step = int(step)
        self.wait_until_finished()
        if not force and not self._should_save(step):
            return False
        path = self.step_path(step)
        if os.path.isdir(path):
            try:
                _read_manifest(path)
            except (ManifestError, FileNotFoundError):
                pass                  # a torn step is written over
            else:
                raise StepAlreadyExistsError(
                    f"checkpoint for step {step} already exists under "
                    f"{self.directory}")
        t0 = _time.perf_counter()
        leaves: List[Tuple[str, torch.Tensor]] = []
        spec = _encode(state, leaves, ())
        host = [(p, _host_leaf(t, copy=self.async_save))
                for p, t in leaves]
        if self.async_save:
            self._writer = threading.Thread(
                target=self._write_async, args=(step, spec, host),
                daemon=True, name="mxtpu-checkpoint-writer")
            self._writer.start()
        else:
            self._write(step, spec, host)
        self._m["save_s"].observe(_time.perf_counter() - t0)
        self._m["total"]("save").inc()
        return True

    def _write(self, step: int, spec, host) -> None:
        _write_dir(self.step_path(step), spec, host)
        if self.max_to_keep is not None:
            for s in self.all_steps()[:-int(self.max_to_keep)]:
                shutil.rmtree(self.step_path(s), ignore_errors=True)

    def _write_async(self, step: int, spec, host) -> None:
        try:
            self._write(step, spec, host)
        except Exception as e:              # surfaced by the next join
            self._write_error = e

    def restore(self, step: Optional[int] = None,
                abstract_state: Any = None, fallback: bool = True, *,
                device=None) -> Any:
        """Restore the given (default: latest) step. Pass
        ``abstract_state`` (a like-structured tree, e.g. a freshly
        initialized TrainState) to restore into its structure, each leaf
        on its device and dtype; without one the leaves go to ``device``
        (the card unless told otherwise).

        When restoring the LATEST step and it turns out partial or
        corrupt (torn by a kill or a truncated file: ``ManifestError``,
        or ``OSError`` from the read), fall back to the previous
        retained step instead of failing the relaunch —
        checkpoint+restart must survive exactly the crashes it exists
        for. An EXPLICITLY requested step never falls back: the caller
        asked for that step, silently returning another would be worse.
        ``fallback=False`` disables the scan entirely. Any other error
        (a tree that does not match ``abstract_state``, no card, out of
        memory while placing a leaf) raises at once."""
        if step is not None:
            return self._restore_one(step, abstract_state, device)
        candidates = sorted(self.all_steps(), reverse=True)
        if not candidates:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory}")
        last_err: Optional[BaseException] = None
        for s in candidates:
            try:
                return self._restore_one(s, abstract_state, device)
            except _TORN as e:
                last_err = e
                if not fallback:
                    raise
                self._record_fallback(s, e)
        raise RuntimeError(
            f"every retained checkpoint under {self.directory} failed "
            f"to restore (steps {candidates})") from last_err

    def _record_fallback(self, step: int, err: BaseException,
                         what: str = "checkpoint") -> None:
        """A torn/corrupt latest step being skipped is an EVENT, not a
        silent branch: counter + flight record + warning, so a fleet
        restoring one step further back than expected is diagnosable
        from the scrape and the black box."""
        self._m["total"]("fallback").inc()
        _flight("checkpoint", "fallback", step=int(step), what=what,
                directory=self.directory,
                error=f"{type(err).__name__}: {err}")
        warnings.warn(
            f"{what} step {step} under {self.directory} is "
            f"partial/corrupt ({type(err).__name__}: {err}); "
            "falling back to the previous retained step",
            RuntimeWarning)

    def _restore_one(self, step: int, abstract_state: Any,
                     device=None) -> Any:
        t0 = _time.perf_counter()
        out = _read_dir(self.step_path(step), abstract_state, device)
        self._m["restore_s"].observe(_time.perf_counter() - t0)
        self._m["total"]("restore").inc()
        return out

    # -- data-position journal (resume: no batch replayed or skipped) -----
    def journal_path(self, step: int) -> str:
        return os.path.join(self.directory, f"journal_{int(step)}.mxj")

    def save_journal(self, step: int, journal: dict) -> str:
        """Manifest-commit the data-position journal for ``step`` —
        a small JSON dict (batch cursor, per-host positions, rng
        state...) saved ALONGSIDE the checkpoint so a resume knows
        exactly where the input stream stood. Journals for steps no
        longer retained are pruned. Returns the journal path."""
        path = self.journal_path(step)
        manifest_commit(path, _json.dumps(
            dict(journal, step=int(step))).encode())
        self._m["total"]("journal").inc()
        keep = set(self.all_steps()) | {int(step)}
        for name in os.listdir(self.directory):
            if name.startswith("journal_") and name.endswith(".mxj"):
                try:
                    s = int(name[len("journal_"):-len(".mxj")])
                except ValueError:
                    continue
                if s not in keep:
                    for p in (os.path.join(self.directory, name),
                              os.path.join(self.directory,
                                           name + ".payload")):
                        try:
                            os.unlink(p)
                        except OSError:
                            pass
        return path

    def load_journal(self, step: int) -> dict:
        """Read + validate the journal for ``step``
        (:class:`~mxtpu_torch.base.ManifestError` on a torn commit)."""
        return _json.loads(manifest_read(self.journal_path(step)))

    def restore_with_journal(self, abstract_state: Any = None, *,
                             device=None) -> Tuple[Any, dict, int]:
        """The resume entry point: scan retained steps newest-first for
        one whose checkpoint AND data-position journal BOTH validate,
        and return ``(state, journal, step)``. A step with a torn
        checkpoint or a torn/missing journal is skipped (counted +
        flight-recorded; any other error raises, as in ``restore``) — resuming training state without knowing the
        data position would silently replay or skip batches, which is
        exactly the bug the journal exists to kill."""
        candidates = sorted(self.all_steps(), reverse=True)
        if not candidates:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory}")
        last_err: Optional[BaseException] = None
        for s in candidates:
            try:
                journal = self.load_journal(s)
            except _TORN + (ValueError,) as e:     # ValueError: not JSON
                last_err = e
                self._record_fallback(s, e, what="journal")
                continue
            try:
                state = self._restore_one(s, abstract_state, device)
            except _TORN as e:
                last_err = e
                self._record_fallback(s, e)
                continue
            return state, journal, s
        raise RuntimeError(
            f"every retained checkpoint under {self.directory} failed "
            f"to restore with a valid journal (steps {candidates})"
        ) from last_err

    # -- publish/subscribe seam (the flywheel's train->serve handoff) -------
    def publish(self, step: Optional[int] = None, **meta: Any) -> dict:
        """Declare ``step`` (default: latest) ready to serve: wait out
        any in-flight async write, then atomically commit the
        ``latest-published`` pointer. The pointer is versioned by a
        publish ``seq`` so a subscriber polling the file can tell a new
        candidate from a re-read; extra ``meta`` (generation, loss...)
        rides along for eval gates. Returns the pointer record."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"nothing to publish under {self.directory}")
        prev = self.latest_published()
        self._pub_seq = max(self._pub_seq,
                            int(prev["seq"]) if prev else 0) + 1
        rec = publish_pointer(self.directory, step, seq=self._pub_seq,
                              **meta)
        self._m["total"]("publish").inc()
        _flight("checkpoint", "publish", step=int(step),
                seq=self._pub_seq, directory=self.directory)
        return rec

    def latest_published(self) -> Optional[dict]:
        """The subscriber view of :meth:`publish`: the current pointer
        record, or None when nothing is published OR the pointer is
        torn (a torn pointer is counted + flight-recorded like a torn
        checkpoint, then treated as absent — the previous candidate
        keeps serving)."""
        try:
            return read_published(self.directory)
        except ManifestError as e:
            self._m["total"]("fallback").inc()
            _flight("checkpoint", "fallback", step=-1,
                    what="published-pointer", directory=self.directory,
                    error=f"{type(e).__name__}: {e}")
            warnings.warn(
                f"latest-published pointer under {self.directory} is "
                f"torn ({e}); treating as unpublished", RuntimeWarning)
            return None

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """Every step directory, torn ones included (``restore`` finds
        those out and falls back past them)."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def wait_until_finished(self) -> None:
        """Join the write in flight; a failed write raises here."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._write_error = self._write_error, None
        if err is not None:
            raise err

    def close(self) -> None:
        self.wait_until_finished()


class PreemptionGuard:
    """Preemption-safe shutdown: catch SIGTERM/SIGINT and convert them
    into a flag the training loop checks at step boundaries, plus a
    forced final SYNCHRONOUS save.

    Usage::

        mgr = CheckpointManager(ckdir, async_save=True)
        with PreemptionGuard(mgr) as guard:
            for i in range(start, steps):
                state, loss = train_step(state, batch)
                mgr.save(i, state)
                if guard.preempted:
                    guard.save_now(i, state)   # sync, ignores interval
                    break
        # relaunch: CheckpointManager(ckdir).restore(...) resumes at i

    Handlers can only be installed from the main thread (Python's
    ``signal`` rule). A second signal while the final save is running
    is left to the default disposition only after ``__exit__`` restores
    handlers; inside the guard it just re-sets the flag (the save must
    not be torn by a double-SIGTERM).
    """

    def __init__(self, manager: Optional[CheckpointManager] = None,
                 signals=(_signal.SIGTERM, _signal.SIGINT)):
        self._manager = manager
        self._signals = tuple(signals)
        self._old: dict = {}
        self.preempted = False
        self.signum: Optional[int] = None
        self.flight_dump_path: Optional[str] = None

    def _handler(self, signum, frame):
        self.preempted = True
        self.signum = signum
        # crash-path observability: persist the flight recorder NOW —
        # if the scheduler escalates to SIGKILL before the final save
        # finishes, the dump is the only record of the job's last
        # moments. Never let telemetry failure break the save path.
        try:
            from . import telemetry
            if telemetry.enabled():      # honor the kill switch: a
                telemetry.flight().record("preemption", "signal",
                                          signum=int(signum))
                self.flight_dump_path = telemetry.flight().dump()
        except Exception:                # disabled run writes nothing
            pass

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._old[s] = _signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> bool:
        for s, h in self._old.items():
            _signal.signal(s, h)
        self._old.clear()
        return False

    def save_now(self, step: int, state: Any) -> None:
        """The final save: wait out any in-flight ASYNC write, then
        force-save this step synchronously, ignoring the save
        interval."""
        if self._manager is None:
            raise ValueError(
                "PreemptionGuard(manager=...) is required for save_now")
        self._manager.wait_until_finished()
        try:
            self._manager.save(step, state, force=True)
        except StepAlreadyExistsError:
            # the interval save already committed this exact step —
            # nothing left to persist
            pass
        self._manager.wait_until_finished()


def save_state(path: str, state: Any) -> None:
    """One-shot synchronous tree save; a checkpoint already at ``path``
    is replaced (refreshing a fixed path such as 'latest' is the common
    pattern)."""
    leaves: List[Tuple[str, torch.Tensor]] = []
    spec = _encode(state, leaves, ())
    _write_dir(path, spec, leaves)


def load_state(path: str, abstract_state: Any = None, *,
               device=None) -> Any:
    """One-shot tree load. A saved tree that does not match
    ``abstract_state`` raises a clear :class:`~mxtpu_torch.base
    .MXNetError` naming the FIRST mismatched key/shape, checked before
    any leaf is read. Without ``abstract_state`` the leaves go to
    ``device`` (the card unless told otherwise); a torn checkpoint
    raises :class:`~mxtpu_torch.base.ManifestError`."""
    return _read_dir(path, abstract_state, device)
