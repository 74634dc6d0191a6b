"""A pool of ``torch.distributed`` ranks on the CPU for the port's
multi-rank tests.

``RankPool(n, store_dir)`` starts n processes of this file, each one
rank of a ``gloo`` group that ``mxtpu_torch.parallel.dist.initialize``
joins through a ``file://`` store under ``store_dir`` (no TCP port, so
parallel test workers never race for one). A rank runs one thread of
torch and imports only ``torch``, ``numpy`` and ``mxtpu_torch``: the
tasks it runs live in :mod:`torch_parallel_tasks`. ``pool.run(name,
*args)`` runs ``torch_parallel_tasks.<name>(*args)`` on every rank and
returns the ranks' results in rank order; a task that raises on any
rank raises here with that rank's traceback. Every call, and the
teardown, has a timeout, after which the ranks are killed.

The ranks are processes, not virtual devices, because a process group
is one rank per process: that is what the port's meshes span.

Run as a script, this file is one rank's loop (``--rank``, ``--world``,
``--store``): it reads pickled ``(module, function, args)`` requests on
stdin and writes pickled replies on what was its stdout; its own output
goes to stderr, which the pool keeps in ``rank<r>.log``.
"""
from __future__ import annotations

import os
import pickle
import select
import struct
import subprocess
import sys
import time
from typing import Any, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CALL_TIMEOUT = 240.0
START_TIMEOUT = 240.0


def _send(f, obj) -> None:
    data = pickle.dumps(obj)
    f.write(struct.pack("<Q", len(data)) + data)
    f.flush()


def _read_exact(fd: int, n: int, deadline: float) -> bytes:
    out = b""
    while len(out) < n:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError("rank did not answer in time")
        ready, _, _ = select.select([fd], [], [], left)
        if not ready:
            continue
        chunk = os.read(fd, n - len(out))
        if not chunk:
            raise EOFError("rank closed its pipe")
        out += chunk
    return out


def _recv_fd(fd: int, deadline: float):
    (n,) = struct.unpack("<Q", _read_exact(fd, 8, deadline))
    return pickle.loads(_read_exact(fd, n, deadline))


class RankPool:
    """n gloo ranks, started once, serving task calls."""

    def __init__(self, n: int, store_dir: str, timeout: float = START_TIMEOUT):
        self.n = n
        self.store_dir = str(store_dir)
        self.timeout = timeout
        self.starts = 0
        self.procs: List[subprocess.Popen] = []
        self.logs: list = []
        self._start()

    def _start(self) -> None:
        """Start the ranks (again, after a failed call killed them: each
        start rendezvous through a store file of its own)."""
        os.makedirs(self.store_dir, exist_ok=True)
        self.starts += 1
        store = os.path.join(self.store_dir, f"store{self.starts}")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT, HERE] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                            else []))
        env["OMP_NUM_THREADS"] = "1"
        n = self.n
        for r in range(n):
            log = open(os.path.join(self.store_dir, f"rank{r}.log"), "wb")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                 "--world", str(n), "--store", store],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log,
                env=env, cwd=ROOT))
        try:
            ready = self._collect(time.monotonic() + self.timeout)
        except BaseException:
            self.close(kill=True)
            raise
        assert all(r == "ready" for r in ready), ready

    def _tail(self, r: int) -> str:
        self.logs[r].flush()
        with open(os.path.join(self.store_dir, f"rank{r}.log"), "rb") as f:
            return f.read()[-4000:].decode(errors="replace")

    def _collect(self, deadline: float) -> List[Any]:
        out = []
        for r, p in enumerate(self.procs):
            try:
                ok, val, dirty = _recv_fd(p.stdout.fileno(), deadline)
            except (TimeoutError, EOFError) as e:
                raise RuntimeError(f"rank {r}: {e}\n{self._tail(r)}") \
                    from None
            if dirty:
                raise AssertionError(f"rank {r} imported {dirty}")
            if not ok:
                raise RuntimeError(f"rank {r} raised:\n{val}")
            out.append(val)
        return out

    def run(self, name: str, *args, timeout: float = CALL_TIMEOUT,
            module: str = "torch_parallel_tasks") -> List[Any]:
        """``module.name(*args)`` on every rank; the results by rank."""
        if not self.procs:
            self._start()
        for p in self.procs:
            _send(p.stdin, (module, name, args))
        try:
            return self._collect(time.monotonic() + timeout)
        except BaseException:
            self.close(kill=True)      # a rank may be stuck in a collective
            raise

    def close(self, kill: bool = False, timeout: float = 30.0) -> None:
        for p in self.procs:
            if p.poll() is None and not kill:
                try:
                    _send(p.stdin, None)
                except OSError:
                    pass
        deadline = time.monotonic() + timeout
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=0 if kill else
                           max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
            if p.poll() is None:
                p.kill()
                p.wait(timeout=timeout)
        for log in self.logs:
            log.close()
        self.procs = []
        self.logs = []


def _forbidden_imports() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "mxtpu"))


def _serve(rank: int, world: int, store: str) -> None:
    import faulthandler
    import importlib
    import traceback
    proto_in = sys.stdin.buffer
    proto_out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)                   # prints go to the rank's log
    import torch
    torch.set_num_threads(1)
    from mxtpu_torch.parallel import dist
    dist.initialize(num_processes=world, process_id=rank, device="cpu",
                    init_method=f"file://{store}", timeout=CALL_TIMEOUT)
    _send(proto_out, (True, "ready", _forbidden_imports()))
    while True:
        head = proto_in.read(8)
        if len(head) < 8:
            break
        (n,) = struct.unpack("<Q", head)
        msg = pickle.loads(proto_in.read(n))
        if msg is None:
            break
        mod, name, args = msg
        # a task stuck in a collective leaves its stack in the log
        faulthandler.dump_traceback_later(CALL_TIMEOUT - 5)
        try:
            val = getattr(importlib.import_module(mod), name)(*args)
            reply = (True, val, _forbidden_imports())
        except BaseException:
            reply = (False, traceback.format_exc(), _forbidden_imports())
        faulthandler.cancel_dump_traceback_later()
        _send(proto_out, reply)
    dist.shutdown()


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    a = ap.parse_args()
    _serve(a.rank, a.world, a.store)
