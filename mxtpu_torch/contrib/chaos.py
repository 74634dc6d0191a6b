"""mx.contrib.chaos — deterministic fault injection for the serving
tier: the serve half of ``mxtpu/contrib/chaos.py``, over the port's
gateway (``mxtpu_torch.serve.gateway``).

- :class:`ServeChaosPlan` + :func:`attach_serve` — kill an engine
  replica at step N, raise inside decode dispatch, sever/delay/corrupt
  KV handoff frames, kill a prefill worker — attached to a live
  gateway, so supervision, deterministic re-dispatch, channel
  self-healing and the circuit breaker are all provoked rather than
  trusted.
- :func:`free_port` — an OS-assigned free TCP port.

Everything is seeded and thread-free on the decision path, so a chaos
run is exactly reproducible. The training half (parameter-server
message faults, server processes, the elastic trainer's host deaths)
comes with the multi-device slice.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional

__all__ = ["ServeChaosFault", "ServeChaosPlan", "attach_serve",
           "free_port"]


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (best-effort: released before use,
    like every test-harness port picker)."""
    import socket as _socket
    s = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    try:
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


class ServeChaosFault(RuntimeError):
    """The injected failure ``ServeChaosPlan`` raises inside serving
    threads — distinct from real faults so a test log reads
    honestly."""


class ServeChaosPlan:
    """Seeded, schedule-driven fault injection for the SERVING tier.
    Attach to a LIVE gateway with :func:`attach_serve`; every action
    fires at a deterministic point, so a chaos run is exactly
    reproducible:

    - ``kill_replica`` — {replica index: engine step}: the replica's
      serving thread dies (an exception escaping its loop) when its
      engine reaches that step — mid-decode, with requests seated.
    - ``raise_in_decode`` — {replica index: dispatch count}: raises
      inside the decode dispatch path instead (same death, different
      stack — both must end in supervision + re-dispatch).
    - ``kv_frames`` — {handoff frame index: action} on the disagg
      channel's send side: ``"sever"`` (connection torn down
      mid-handoff → reconnect + HMAC re-auth + resend), ``"delay"``
      (sleep ``delay_s``), ``"corrupt"`` (an unverifiable frame on
      the wire ahead of the real one → the receiver quarantines the
      connection, the sender reconnects and resends).
    - ``kill_prefill`` — {worker index: job index}: the prefill
      worker thread dies mid-pool (→ respawn + single resubmit).

    ``injected`` counts what actually fired, for test assertions.
    Replacement replicas/workers spawned by the supervisor are NOT
    re-wrapped — each scheduled fault fires at most once."""

    KV_ACTIONS = ("sever", "delay", "corrupt")

    def __init__(self, seed: int = 0,
                 kill_replica: Optional[Dict[int, int]] = None,
                 raise_in_decode: Optional[Dict[int, int]] = None,
                 kv_frames: Optional[Dict[int, str]] = None,
                 kill_prefill: Optional[Dict[int, int]] = None,
                 delay_s: float = 0.02):
        self._rng = random.Random(seed)
        self.kill_replica = dict(kill_replica or {})
        self.raise_in_decode = dict(raise_in_decode or {})
        self.kv_frames = dict(kv_frames or {})
        for a in self.kv_frames.values():
            if a not in self.KV_ACTIONS:
                raise ValueError(f"unknown kv chaos action {a!r}")
        self.kill_prefill = dict(kill_prefill or {})
        self.delay_s = delay_s
        self._kv_index = 0
        self._kv_lock = threading.Lock()
        self.injected: Dict[str, int] = {
            "replica_kill": 0, "decode_raise": 0, "kv_sever": 0,
            "kv_delay": 0, "kv_corrupt": 0, "prefill_kill": 0}

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    # -- wrapping ------------------------------------------------------------
    def _wrap_dispatch(self, replica, kill_step: Optional[int],
                       raise_at: Optional[int]) -> None:
        engine = replica.engine
        orig = engine._dispatch
        calls = {"n": 0}
        plan = self

        def chaotic_dispatch(firsts):
            if kill_step is not None \
                    and engine.steps_run >= kill_step:
                plan.injected["replica_kill"] += 1
                raise ServeChaosFault(
                    f"chaos: replica {replica.name} killed at step "
                    f"{engine.steps_run}")
            if raise_at is not None and calls["n"] >= raise_at:
                plan.injected["decode_raise"] += 1
                raise ServeChaosFault(
                    f"chaos: raised inside decode dispatch of "
                    f"{replica.name}")
            calls["n"] += 1
            return orig(firsts)

        engine._dispatch = chaotic_dispatch

    def _wrap_channel(self, channel) -> None:
        orig = channel.send_handoff
        plan = self

        def chaotic_send(msg):
            with plan._kv_lock:
                idx = plan._kv_index
                plan._kv_index += 1
                action = plan.kv_frames.pop(idx, None)
            if action == "sever":
                plan.injected["kv_sever"] += 1
                sock = channel._sock
                if sock is not None:
                    try:
                        sock.shutdown(2)    # mid-handoff connection cut
                    except OSError:
                        pass
                    sock.close()
            elif action == "delay":
                plan.injected["kv_delay"] += 1
                time.sleep(plan.delay_s)
            elif action == "corrupt":
                plan.injected["kv_corrupt"] += 1
                sock = channel._sock
                if sock is not None:
                    from .. import rpc as _rpc
                    try:
                        # a frame MAC'd with the wrong key: fails the
                        # receiver's HMAC check, poisoning the
                        # connection ahead of the real handoff
                        _rpc.send_msg(sock, ("kv", -1, 0, 0),
                                      b"chaos-wrong-secret")
                    except OSError:
                        pass
            return orig(msg)

        channel.send_handoff = chaotic_send

    def _wrap_worker(self, worker, job_index: int) -> None:
        orig = worker._one
        jobs = {"n": 0}
        plan = self

        def chaotic_one(rid, req):
            n = jobs["n"]
            jobs["n"] += 1
            if n == job_index:
                plan.injected["prefill_kill"] += 1
                raise ServeChaosFault(
                    f"chaos: prefill worker {worker.name} killed at "
                    f"job {n}")
            return orig(rid, req)

        worker._one = chaotic_one


def attach_serve(gateway, plan: ServeChaosPlan) -> ServeChaosPlan:
    """Wire a :class:`ServeChaosPlan` into a LIVE gateway: wraps the
    scheduled replicas' dispatch paths, the disagg KV channel's send
    side, and the scheduled prefill workers. Accepts a ``Gateway`` or
    a bare backend (``ReplicaSet`` / ``DisaggBackend``)."""
    backend = getattr(gateway, "backend", gateway)
    replicas = backend.replicas() if hasattr(backend, "replicas") \
        else []
    for idx in sorted(set(plan.kill_replica) | set(plan.raise_in_decode)):
        if idx >= len(replicas):
            raise ValueError(
                f"chaos plan targets replica {idx}; backend has "
                f"{len(replicas)}")
        plan._wrap_dispatch(replicas[idx],
                            plan.kill_replica.get(idx),
                            plan.raise_in_decode.get(idx))
    if plan.kv_frames or plan.kill_prefill:
        workers = getattr(backend, "prefill", None)
        tx = getattr(backend, "_tx", None)
        if workers is None or tx is None:
            raise ValueError(
                "kv/prefill chaos needs a DisaggBackend gateway")
        if plan.kv_frames:
            plan._wrap_channel(tx)
        for idx, job in plan.kill_prefill.items():
            if idx >= len(workers):
                raise ValueError(
                    f"chaos plan targets prefill worker {idx}; pool "
                    f"has {len(workers)}")
            plan._wrap_worker(workers[idx], job)
    return plan
