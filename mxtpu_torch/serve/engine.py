"""ServeEngine — continuous batching over the llama slot KV bank: the
port of ``mxtpu/serve/engine.py``'s dense engine.

Scheduler design (Orca, OSDI '22; one fixed slot bank, no paging):

- **slot bank**: ``llama.init_slot_cache`` holds ``max_slots``
  independent cache rows; per-slot ``lengths`` confine attention to
  each request's own prefix (``slot_decode_attention``).
- **admission at step boundaries**: a finished slot is overwritten in
  place by the next queued request through a per-BUCKET prefill program
  (prompts end-padded to a power of two, which is exact, see
  ``llama.prefill_slot``), so the programs are bounded by the bucket
  count. Prefill and inject programs run eagerly.
- **one decode program**: every step runs ``llama.decode_slots`` over
  the full bank; per-slot position, length, key and sampling vectors
  make request churn invisible to its shapes. On the card it is one
  CUDA graph, captured at the first step and replayed on every step
  after (:class:`_DecodeGraph`), which takes the host's per-op launch
  cost out of decode; on the CPU it is the plain function.
  :attr:`ServeEngine.compile_count` counts the programs.
- **overlapped host sync**: step ``t``'s tokens are read back only after
  step ``t+1`` has been dispatched, so the sync runs under the next
  step's device time (``MXTPU_SERVE_OVERLAP=0`` forces the synchronous
  order).

Determinism contract: each slot's forward and sampling depend only on
its own cache row and key chain, so the engine's output for a request
never depends on how requests are interleaved, admitted or delayed
(tested across slot counts and overlap modes). Against per-request
``llama.generate`` the math is the same and the key chain replays
exactly; tokens are equal in f32 up to near-ties, where the two
attention formulations (the slot path's blockwise f32 online softmax,
the cached path's softmax over the whole cache) may round the last ulp
apart. In bf16 they round differently (the slot path accumulates in
f32, the cached path casts its probabilities to bf16), so a near-tie
token can differ: invariance to scheduling, not equality across the two
formulations, is the contract there.

The paged pool (``paged=True``, ROADMAP Queue A item 5b), speculative
decoding (``speculate_k``, item 5c) and mesh serving (item 11) raise
until their slices.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import prng, telemetry
from ..base import env_int, env_str
from ..context import DeviceLike, resolve_device
from ..models import llama
from ..telemetry import distributed as dtrace

__all__ = ["Request", "KVHandoff", "ServeEngine", "bucket_for",
           "resume_key", "cancel_counter"]

# admission wait is measured in engine steps (arrival → slot grant)
_WAIT_STEP_BUCKETS = (0.0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 1024)
# decode steps run on a side stream before the capture (lazy cuBLAS
# handles and workspaces are made there, not inside the graph)
_WARMUP_STEPS = 2
# one capture at a time in the process: engines may start on threads
_CAPTURE_LOCK = threading.Lock()

_engine_seq = itertools.count(1)     # atomic: engines build on threads


def _engine_metrics(eid: str):
    """Process-wide serve metrics (one handle set per engine; the
    registry interns children, so every engine shares the TOTALS).
    Point-in-time gauges are labelled per engine instead. Created at
    engine construction: the telemetry knob is read then."""
    return {
        "requests": telemetry.counter(
            "serve_requests_total", "Requests submitted to ServeEngine"),
        "tokens": telemetry.counter(
            "serve_tokens_total", "Tokens emitted by ServeEngine"),
        "steps": telemetry.counter(
            "serve_steps_total", "Decode steps dispatched"),
        "queue": telemetry.gauge(
            "serve_queue_depth", "Requests queued, not yet admitted",
            engine=eid),
        "slots": telemetry.gauge(
            "serve_slot_occupancy", "Active slots in the decode bank",
            engine=eid),
        "wait": telemetry.histogram(
            "serve_admission_wait_steps",
            "Engine steps between a request's arrival and its slot",
            buckets=_WAIT_STEP_BUCKETS),
        "latency": telemetry.histogram(
            "serve_token_latency_ms",
            "Inter-token gaps per request (host emission clock)"),
        "kv_reserved": telemetry.gauge(
            "serve_kv_reserved_bytes",
            "Bytes the dense KV slot bank reserves", engine=eid),
        "kv_live": telemetry.gauge(
            "serve_kv_live_bytes",
            "Bytes of the slot bank covered by live sequence "
            "prefixes", engine=eid),
        "kv_occ": telemetry.gauge(
            "serve_kv_occupancy_ratio",
            "live/reserved fraction of the KV slot bank", engine=eid),
    }


def bucket_for(length: int, min_bucket: int, max_len: int) -> int:
    """Prefill bucket policy: the smallest power of two >= ``length``
    (floored at ``min_bucket``, capped at ``max_len``). Programs are
    bounded by the bucket count: log2(max_len / min_bucket) + 1
    programs cover every prompt length."""
    if length > max_len:
        raise ValueError(f"prompt length {length} > max_len {max_len}")
    b = max(1, min_bucket)
    while b < length:
        b *= 2
    return min(b, max_len)


@dataclass
class Request:
    """One generation request. ``temperature=0`` is greedy; ``seed``
    starts the request's OWN key chain (the one ``generate`` would use
    as ``rng=prng.PRNGKey(seed)``). ``arrival_step`` delays admission
    until that engine step, the hook seeded arrival streams use.
    ``on_token(rid, token)`` streams tokens as they are produced;
    ``on_done(rid, reason)`` fires exactly once per request with reason
    ``"complete"``, ``"cancel"``/another explicit
    :meth:`ServeEngine.cancel` reason, or ``"deadline"``.
    ``deadline_s`` is a RELATIVE budget on the engine's clock: a
    request still running (or queued) that many seconds after
    ``submit`` is cancelled at the next step boundary. ``rng``, when
    set, is an explicit (2,) uint32 chain state used INSTEAD of
    ``PRNGKey(seed)``: a re-dispatch prefills ``prompt +
    already-streamed tokens`` with the chain fast-forwarded past them
    (:func:`resume_key`), so the resumed stream replays the exact chain
    a fault-free run would have used. ``ctx``, when set, is the
    request's :class:`~mxtpu_torch.telemetry.TraceContext`: every
    per-request event the engine records carries its trace_id."""
    prompt: Any
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0
    arrival_step: int = 0
    on_token: Optional[Callable[[int, int], None]] = None
    on_done: Optional[Callable[[int, str], None]] = None
    deadline_s: Optional[float] = None
    rng: Optional[Any] = None
    ctx: Optional[Any] = None


def cancel_counter(reason: str):
    """``serve_cancelled_total{reason}``: the one definition of the
    cancel counter, so its name, help and labels cannot fork."""
    return telemetry.counter(
        "serve_cancelled_total",
        "Requests ended before completion, by reason",
        reason=reason)


def resume_key(seed: int, n_emitted: int) -> np.ndarray:
    """The key chain state of a request seeded ``seed`` after it has
    emitted ``n_emitted`` tokens: every emission (the prefill's first
    token and each decode step) takes one ``prng.split``, keeping the
    carry half, so re-prefilling ``prompt + emitted`` with this key
    samples token ``n_emitted + 1`` from the same subkey, on the same
    logits, as the fault-free run. Computed on the CPU; returns the
    (2,) uint32 key as ``mxtpu``'s does."""
    key = prng.PRNGKey(int(seed), device="cpu")
    for _ in range(int(n_emitted)):
        key = prng.split(key)[0]
    return prng.key_to_numpy(key)


@dataclass
class KVHandoff:
    """A prefill worker's detached output: everything a decode engine
    needs to seat the request without re-running the prompt
    (``llama.prefill_detached`` produces it, ``llama.inject_slot_kv``
    consumes it). ``k``/``v``: (L, n_kv_heads, bucket, hd) host arrays
    (numpy, or CPU tensors where numpy lacks the dtype, as for
    bfloat16); ``rng``: the (2,) uint32 chain state AFTER the
    first-token split, so decode continues the exact chain ``generate``
    would."""
    k: Any
    v: Any
    true_len: int
    token: int
    rng: np.ndarray


@dataclass
class _Dispatch:
    """One in-flight decode step: the device tokens plus the host-side
    snapshot needed to attribute them after the overlapped sync."""
    sampled: Any                                   # (S,) int32 tensor
    slots: List[Tuple[int, int]]                   # (slot, rid) active
    firsts: List[Tuple[int, Any]]                  # (rid, (1,) tensor)


class _DecodeGraph:
    """``llama.decode_slots`` over one engine's bank: the engine's one
    decode program. Called with the (S,) host arrays ``active``,
    ``temperature``, ``top_k`` and ``top_p``; returns the (S,) int32
    tokens of the step.

    On the CPU it is the plain function. On a CUDA bank it is a CUDA
    graph, captured at the first call after ``_WARMUP_STEPS`` steps on a
    side stream, and replayed on every call: the bank and the slot
    vectors are its static buffers (the step writes them in place), the
    host arrays are copied into static device buffers from pinned host
    memory before each replay (two pinned sets in turn, each reused
    only once its last copy has run), and the tokens are cloned out of
    the graph's output on the stream, so a step read after the next one
    is dispatched (the overlapped loop) keeps its own tokens. The
    warm-up steps run on the real state: they write each slot's K/V at
    its next position, which the replay writes again with the same
    values, and the slot vectors are restored before the capture.

    Everything the graph reads is held here or by the engine: the RoPE
    tables are this object's own, not the shared cache's, which may
    drop them. The capture holds a process-wide lock and checks only
    its own thread's calls (``capture_error_mode="thread_local"``), so
    another engine's readback, prefill or allocation on another thread
    cannot break it. A capture that fails (a host sync inside the
    step) raises: there is no eager fallback."""

    def __init__(self, cfg, params, kv, sv):
        self.cfg, self.params, self.kv, self.sv = cfg, params, kv, sv
        self.device = kv["k"].device
        self._rope = llama.rope_tables(cfg, kv["k"].shape[3],
                                       device=self.device)
        self.steps = 0
        self.captures = 0
        self._graph = None

    def _step(self, active, temperature, top_k, top_p):
        with torch.no_grad():
            sampled, _, _ = llama.decode_slots(
                self.cfg, self.params, self.kv, self.sv, active,
                temperature, top_k, top_p, rope=self._rope)
        return sampled

    def __call__(self, active, temperature, top_k, top_p):
        knobs = (active, temperature, top_k, top_p)
        self.steps += 1
        if self.device.type != "cuda":
            return self._step(*(torch.from_numpy(np.array(k))
                                for k in knobs))
        if self._graph is None:
            self._capture(knobs)
        else:
            self._stage(knobs)
        self._graph.replay()
        return self._out.clone()

    def _stage(self, knobs) -> None:
        turn = self._turn
        self._turn ^= 1
        if self._copied[turn] is not None:
            self._copied[turn].synchronize()
        for pinned, static, k in zip(self._pinned[turn], self._static,
                                     knobs):
            pinned.numpy()[...] = k
            static.copy_(pinned, non_blocking=True)
        self._copied[turn] = torch.cuda.Event()
        self._copied[turn].record()

    def _capture(self, knobs) -> None:
        dtypes = [torch.from_numpy(np.asarray(k)).dtype for k in knobs]
        with torch.inference_mode(False):   # written from any thread
            self._static = [torch.empty(np.shape(k), dtype=dt,
                                        device=self.device)
                            for k, dt in zip(knobs, dtypes)]
            self._pinned = [[torch.empty(np.shape(k), dtype=dt,
                                         pin_memory=True)
                             for k, dt in zip(knobs, dtypes)]
                            for _ in range(2)]
        self._copied = [None, None]
        self._turn = 0
        self._stage(knobs)
        saved = {n: t.clone() for n, t in self.sv.items()}
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        with _CAPTURE_LOCK:
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(_WARMUP_STEPS):
                    self._step(*self._static)
            main.wait_stream(side)
            for n, t in saved.items():
                self.sv[n].copy_(t)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._out = self._step(*self._static)
        self._graph = graph
        self.captures += 1


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class ServeEngine:
    """Continuous-batching scheduler over one model and one slot bank.

    Args: ``cfg``/``params``, a llama config and parameter tree (the
    weight-only int8 tree of ``quantize_params_int8`` rides the same
    programs), on ``device``. ``max_slots``/``max_len``/``min_bucket``
    default from ``MXTPU_SERVE_MAX_SLOTS`` / the config's
    ``max_seq_len`` / ``MXTPU_SERVE_MIN_BUCKET``. ``device`` places the
    bank: the card by default (raises when none is visible), or
    ``"cpu"``; params on another device raise, they are never moved.
    ``paged``, ``speculate_k`` and ``mesh`` raise until their slices
    (ROADMAP Queue A items 5b, 5c and 11)."""

    def __init__(self, cfg, params, *, max_slots: Optional[int] = None,
                 max_len: Optional[int] = None,
                 min_bucket: Optional[int] = None,
                 mesh=None, overlap: Optional[bool] = None,
                 clock: Optional[Callable[[], float]] = None,
                 paged: bool = False,
                 speculate_k: Optional[int] = None,
                 device: DeviceLike = None):
        if paged:
            raise NotImplementedError(
                "the paged KV pool comes with ROADMAP Queue A item 5b; "
                "serve from the dense bank (paged=False)")
        speculate_k = int(speculate_k if speculate_k is not None
                          else env_int("MXTPU_SERVE_SPECULATE_K", 0))
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if speculate_k:
            raise NotImplementedError(
                "speculative decoding comes with ROADMAP Queue A item 5c; "
                "pass speculate_k=0")
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving comes with the multi-device slice (ROADMAP "
                "Queue A item 11); pass mesh=None")
        # canonical ("cuda" is cuda:<current>), to compare with the params'
        self.device = torch.empty(0, device=resolve_device(device)).device
        off = sorted({str(t.device) for t in _tensor_leaves(params)
                      if t.device != self.device})
        if off:
            raise ValueError(f"params on {off}, the engine on "
                             f"{self.device}: move them first")
        self.cfg = cfg
        self.params = params
        # deadlines are measured on THIS clock (monotonic seconds);
        # injectable so deadline tests are deterministic
        self._clock = clock or time.monotonic
        self.max_slots = (max_slots if max_slots is not None
                          else env_int("MXTPU_SERVE_MAX_SLOTS", 8,
                                       "ServeEngine's default slot count"))
        self.max_len = int(max_len or cfg.max_seq_len)
        self.min_bucket = (min_bucket if min_bucket is not None
                           else env_int("MXTPU_SERVE_MIN_BUCKET", 16,
                                        "ServeEngine's smallest prefill "
                                        "bucket"))
        self.overlap = (env_str("MXTPU_SERVE_OVERLAP", "1",
                                "0 reads each decode step's tokens before "
                                "the next is dispatched") != "0"
                        if overlap is None else bool(overlap))
        # the engine's name in per-request trace events, and the model
        # build it serves (a gateway replica stamps both)
        self.role = "engine"
        self.build: Optional[str] = None

        # normal tensors even when built under torch.inference_mode():
        # that mode is per thread, and a loop on another thread
        # (run_forever) writes the bank in place outside it
        with torch.inference_mode(False):
            state = llama.init_slot_cache(cfg, self.max_slots,
                                          self.max_len, device=self.device)
        self._kv = {"k": state["k"], "v": state["v"]}
        self._sv = {n: state[n] for n in ("lengths", "tokens", "rngs")}
        # the one decode program, and the admission buckets seen so far
        # (each runs eagerly: one program per bucket)
        self._decode = _DecodeGraph(cfg, params, self._kv, self._sv)
        self._prefills: Set[int] = set()
        self._injects: Set[int] = set()
        eid = str(next(_engine_seq))
        self.engine_id = eid
        self._m = _engine_metrics(eid)
        self._m_cancel: Dict[str, Any] = {}    # per-reason counters
        # span factories pre-bind their registry histograms: the
        # per-step/per-admission hot paths must not re-intern handles
        self._span_decode = telemetry.span_factory(
            "serve.decode_step", "serve_decode_dispatch")
        self._span_prefill = telemetry.span_factory(
            "serve.prefill", "serve_prefill")
        # private resettable latency stats (always-on Histogram
        # instance, independent of the global telemetry knob)
        self._lat = telemetry.Histogram(telemetry.LATENCY_MS_BUCKETS)
        self._last_tok: Dict[int, float] = {}

        S = self.max_slots
        self._active = np.zeros(S, bool)
        self._temps = np.zeros(S, np.float32)
        self._topks = np.full(S, cfg.vocab_size, np.int32)
        self._topps = np.ones(S, np.float32)
        self._slot_rid: List[Optional[int]] = [None] * S

        # KV occupancy: host-mirrored per-slot lengths (a prefill seats
        # the prompt length; every decode dispatch adds one entry per
        # active slot, exactly the device's `lengths`, tracked without
        # reading it back: a sync here would block the decode loop)
        self._slot_len = np.zeros(S, np.int64)
        self._kv_tok_bytes = (2 * cfg.n_layers * cfg.n_kv_heads
                              * cfg.head_dim * state["k"].element_size())
        self._kv_reserved = int(sum(t.numel() * t.element_size()
                                    for t in self._kv.values()))
        self._m["kv_reserved"].set(self._kv_reserved)
        self._m["kv_live"].set(0)
        self._m["kv_occ"].set(0.0)

        # batch mode (run()) returns the per-request token lists, so it
        # must retain them; a long-lived replica turns this off so
        # request bookkeeping is pruned at finalize
        self.retain_results = True
        self._queue: List[Tuple[int, int, Request]] = []   # heap
        self._requests: Dict[int, Request] = {}
        self._results: Dict[int, List[int]] = {}
        self._done: Dict[int, bool] = {}
        self._handoffs: Dict[int, KVHandoff] = {}
        self._cancelled: Dict[int, str] = {}   # rid -> pending reason
        self._deadlines: Dict[int, float] = {}  # rid -> absolute clock
        self._ended: Dict[int, str] = {}       # rid -> final reason
        self._next_rid = 0
        self._step_idx = 0
        self.steps_run = 0
        # submit()/cancel() may run on other threads while the engine
        # loop steps; the lock guards the request-table state, the
        # condition wakes an idle run_forever on new work
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)

    # -- submission ----------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Queue a request; returns its id. Validation mirrors
        ``generate``'s. Thread-safe."""
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got "
                f"{request.max_new_tokens}")
        if prompt.size + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_len "
                f"{self.max_len}")
        if request.top_k is not None and request.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {request.top_k}")
        if request.top_p is not None and not 0.0 < request.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {request.top_p}")
        return self._enqueue(request)

    def submit_prefilled(self, handoff: KVHandoff,
                         request: Request) -> int:
        """Queue a request whose prompt was already prefilled on a
        prefill worker (disaggregated mode): admission seats the
        handed-off KV block through ``llama.inject_slot_kv`` instead of
        running a prefill program, and the worker-sampled first token
        is emitted as this request's first token."""
        if handoff.true_len < 1:
            raise ValueError("empty handoff")
        if handoff.true_len + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({handoff.true_len}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_len "
                f"{self.max_len}")
        if handoff.k.shape[2] > self.max_len:
            raise ValueError(
                f"handoff bucket {handoff.k.shape[2]} exceeds max_len "
                f"{self.max_len}")
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        if prompt.size > handoff.true_len:
            raise ValueError(
                "handoff shorter than prompt: page-journaled resume "
                "needs the paged engine (ROADMAP Queue A item 5b)")
        return self._enqueue(request, handoff=handoff)

    def _enqueue(self, request: Request,
                 handoff: Optional[KVHandoff] = None) -> int:
        with self._cv:
            rid = self._next_rid
            self._next_rid += 1
            self._requests[rid] = request
            self._results[rid] = []
            self._done[rid] = False
            if handoff is not None:
                self._handoffs[rid] = handoff
            if request.deadline_s is not None:
                self._deadlines[rid] = (self._clock()
                                        + float(request.deadline_s))
            heapq.heappush(self._queue,
                           (int(request.arrival_step), rid, request))
            self._m["requests"].inc()
            self._m["queue"].set(len(self._queue))
            self._cv.notify_all()
        return rid

    # -- cancellation / deadlines --------------------------------------------
    def cancel(self, rid: int, reason: str = "cancel") -> bool:
        """Request cancellation: the rid's slot is freed at the NEXT
        step boundary (a queued rid is finalized without ever taking a
        slot) and ``serve_cancelled_total{reason}`` increments. Returns
        False if the rid is unknown or already finished."""
        with self._cv:
            if rid not in self._requests or rid in self._ended \
                    or self._done.get(rid):
                return False
            self._cancelled.setdefault(rid, reason)
            self._cv.notify_all()
        return True

    def _cancel_counter(self, reason: str):
        m = self._m_cancel.get(reason)
        if m is None:
            m = self._m_cancel[reason] = cancel_counter(reason)
        return m

    def _finalize(self, rid: int, reason: str) -> None:
        """Exactly-once request teardown (lock held): final reason,
        cancel accounting, the on_done callback, and, with
        ``retain_results`` off, pruning, so a forever-serving replica
        stays O(live requests)."""
        if rid in self._ended:
            return
        self._ended[rid] = reason
        self._done[rid] = True
        self._deadlines.pop(rid, None)
        self._handoffs.pop(rid, None)
        self._last_tok.pop(rid, None)
        # always pruned: a stale entry here would also permanently
        # defeat _sweep_cancelled's empty-dict fast path
        self._cancelled.pop(rid, None)
        if reason != "complete":
            self._cancel_counter(reason).inc()
            telemetry.flight().record("serve", "cancelled", rid=rid,
                                      reason=reason)
        req = self._requests[rid]
        if req.ctx is not None:
            with dtrace.use(req.ctx):
                telemetry.instant("serve.done", reason=reason,
                                  role=self.role, build=self.build)
        if req.on_done is not None:
            req.on_done(rid, reason)
        if not self.retain_results:
            self._requests.pop(rid, None)
            self._results.pop(rid, None)
            self._done.pop(rid, None)
            if rid in self._slot_rid:
                # seated: its heap entry was consumed at admission, so
                # nothing else will reap the tombstone
                self._ended.pop(rid, None)

    def _sweep_cancelled(self) -> None:
        """Lock held, once per loop: expire deadlines, and finalize
        cancelled rids that hold NO slot (queued ones; active ones free
        their slot in ``_process``, the step boundary)."""
        if self._deadlines:
            now = self._clock()
            for rid, dl in list(self._deadlines.items()):
                if now >= dl and rid not in self._ended:
                    self._cancelled.setdefault(rid, "deadline")
        if not self._cancelled:
            return
        seated = set(r for r in self._slot_rid if r is not None)
        for rid, reason in list(self._cancelled.items()):
            if rid not in seated:
                self._finalize(rid, reason)

    # -- admission -----------------------------------------------------------
    # Two phases: PICK under the engine lock (queue pops, slot seating,
    # gauges: everything submit()/cancel()/load() observe), then the
    # prefill/inject programs outside it, so a submitter never waits
    # behind an admission.
    def _pick_admissions(self) -> List[Tuple[int, int, Request,
                                             Optional[KVHandoff]]]:
        picks: List[Tuple[int, int, Request, Optional[KVHandoff]]] = []
        while self._queue:
            arrival, rid, req = self._queue[0]
            if rid in self._ended:         # cancelled while queued
                heapq.heappop(self._queue)
                if not self.retain_results:
                    self._ended.pop(rid, None)   # tombstone reaped
                continue
            if arrival > self._step_idx:
                break
            free = np.flatnonzero(~self._active)
            if free.size == 0:
                break
            heapq.heappop(self._queue)
            slot = int(free[0])
            self._m["wait"].observe(max(0, self._step_idx - arrival))
            self._seat(slot, rid, req)
            if req.ctx is not None:
                with dtrace.use(req.ctx):
                    telemetry.instant("serve.seat", slot=slot,
                                      role=self.role)
            picks.append((slot, rid, req, self._handoffs.pop(rid, None)))
        self._m["queue"].set(len(self._queue))
        self._m["slots"].set(int(self._active.sum()))
        return picks

    def _run_admissions(self, picks, firsts: List[Tuple[int, Any]]
                        ) -> None:
        """Run the admission programs for already-seated picks (engine
        thread only: slot and bank state are loop-private)."""
        for slot, rid, req, handoff in picks:
            with dtrace.use(req.ctx):
                if handoff is not None:
                    firsts.append((rid, self._inject_into(slot, handoff)))
                else:
                    firsts.append((rid, self._prefill_into(slot, req)))

    def _prefill_into(self, slot: int, req: Request):
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        bucket = bucket_for(prompt.size, self.min_bucket, self.max_len)
        self._prefills.add(bucket)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :prompt.size] = prompt
        key = (prng.PRNGKey(req.seed, device=self.device)
               if req.rng is None else
               prng.key_from_numpy(np.asarray(req.rng, np.uint32),
                                   self.device))
        with self._span_prefill(bucket=bucket, role=self.role), \
                torch.no_grad():
            tok, _, _ = llama.prefill_slot(
                self.cfg, self.params,
                torch.from_numpy(padded).to(self.device), prompt.size,
                slot, self._kv, self._sv, key, float(req.temperature),
                req.top_k, req.top_p)
        with self._lock:      # host mirror of lengths: kv_cache_stats
            self._slot_len[slot] = prompt.size  # sums it under _lock
        return tok

    def _inject_into(self, slot: int, h: KVHandoff):
        """Admission program for a handed-off prefill (disaggregated
        mode): one program per block bucket writes the KV block and the
        per-slot vectors; the first token was already sampled on the
        prefill worker and is returned as a host tensor (``_process``
        reads firsts uniformly)."""
        bucket = int(h.k.shape[2])
        self._injects.add(bucket)
        with self._span_prefill(bucket=bucket, inject=True,
                                role=self.role), torch.no_grad():
            llama.inject_slot_kv(
                self.cfg, h.k, h.v, h.true_len, slot, h.token,
                prng.key_from_numpy(np.asarray(h.rng, np.uint32),
                                    self.device),
                self._kv, self._sv)
        with self._lock:      # host mirror of lengths: kv_cache_stats
            self._slot_len[slot] = h.true_len  # sums it under _lock
        return torch.tensor([h.token], dtype=torch.int32)

    def _seat(self, slot: int, rid: int, req: Request) -> None:
        self._active[slot] = True
        self._temps[slot] = req.temperature
        self._topks[slot] = (self.cfg.vocab_size if req.top_k is None
                             else req.top_k)
        self._topps[slot] = 1.0 if req.top_p is None else req.top_p
        self._slot_rid[slot] = rid

    # -- stepping ------------------------------------------------------------
    def _dispatch(self, firsts) -> _Dispatch:
        # host DISPATCH time only: on the card the step runs async (no
        # sync in the decode loop); device time belongs to the profiler
        with self._span_decode():
            sampled = self._decode(self._active, self._temps,
                                   self._topks, self._topps)
        self._m["steps"].inc()
        with self._lock:
            self.steps_run += 1
            slots = [(s, rid) for s, rid in enumerate(self._slot_rid)
                     if self._active[s] and rid is not None]
            # the decode step appends one cache entry per active slot;
            # mirror that on the host (no readback)
            for s, _rid in slots:
                self._slot_len[s] += 1
        return _Dispatch(sampled, slots, firsts)

    def _emit(self, rid: int, token: int, now: float) -> None:
        self._results[rid].append(token)
        self._m["tokens"].inc()
        last = self._last_tok.get(rid)
        if last is not None:
            gap_ms = 1e3 * (now - last)
            self._lat.observe(gap_ms)
            self._m["latency"].observe(gap_ms)
        self._last_tok[rid] = now
        req = self._requests[rid]
        if req.on_token is not None:
            req.on_token(rid, token)
        if len(self._results[rid]) >= req.max_new_tokens:
            self._finalize(rid, "complete")

    def _process(self, disp: _Dispatch) -> None:
        # the device sync happens OUTSIDE the lock: a submitter must
        # never block behind a device readback
        sampled = disp.sampled.cpu().numpy() if disp.slots else None
        firsts = [(rid, int(tok.reshape(-1)[0])) for rid, tok in disp.firsts]
        now = time.perf_counter()
        with self._lock:
            for rid, tok in firsts:
                if rid not in self._cancelled:
                    self._emit(rid, tok, now)
            for slot, rid in disp.slots:
                if not self._done.get(rid, True) \
                        and rid not in self._cancelled:
                    self._emit(rid, int(sampled[slot]), now)
            for slot, rid in enumerate(self._slot_rid):
                if rid is None:
                    continue
                reason = self._cancelled.get(rid)
                if reason is not None:
                    self._finalize(rid, reason)
                if self._done.get(rid, True):
                    self._active[slot] = False   # recycle at the next
                    self._slot_rid[slot] = None  # step boundary
            self._m["slots"].set(int(self._active.sum()))
            live = (int(self._slot_len[self._active].sum())
                    * self._kv_tok_bytes)
            self._m["kv_live"].set(live)
            self._m["kv_occ"].set(live / self._kv_reserved
                                  if self._kv_reserved else 0.0)

    # -- the serving loop ----------------------------------------------------
    def _loop_iter(self, prev: Optional[_Dispatch]
                   ) -> Optional[_Dispatch]:
        """One engine step: sweep cancels/deadlines, admit, dispatch,
        and (overlap permitting) process the PREVIOUS step's tokens
        under this step's device time. Shared by :meth:`run` (batch
        drain) and :meth:`run_forever` (a replica loop)."""
        firsts: List[Tuple[int, Any]] = []
        with self._lock:
            self._sweep_cancelled()
            picks = self._pick_admissions()
        self._run_admissions(picks, firsts)
        # any admission leaves its slot active, so firsts are always
        # carried by a dispatch
        out = (self._dispatch(firsts) if self._active.any()
               else None)
        if not self.overlap and out is not None:
            self._process(out)
            out = None
        if prev is not None:
            self._process(prev)
        with self._lock:
            self._step_idx += 1
        return out

    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue: admit → dispatch → (overlapped) process,
        until every submitted request has completed. Returns {rid:
        generated tokens} (prompts not included, matching the
        ``generate`` continuation; a cancelled request's entry holds
        whatever tokens it produced before its cancellation)."""
        prev: Optional[_Dispatch] = None
        while True:
            with self._lock:
                if not (self._queue or self._active.any()
                        or prev is not None):
                    break
            prev = self._loop_iter(prev)
            with self._lock:
                if (prev is None and not self._active.any()
                        and self._queue):
                    # idle until the next scheduled arrival
                    self._step_idx = max(self._step_idx,
                                         self._queue[0][0])
        with self._lock:
            return {rid: np.asarray(toks, np.int32)
                    for rid, toks in self._results.items()}

    def run_forever(self, stop: threading.Event,
                    idle_wait: float = 0.02) -> None:
        """The replica loop: serve submissions as they arrive until
        ``stop`` is set, then DRAIN: in-flight and queued requests
        finish (or hit their deadlines) before the loop exits. Idle
        waits block on the submit/cancel condition, bounded by
        ``idle_wait`` so a stop with no traffic is noticed promptly."""
        prev: Optional[_Dispatch] = None
        while True:
            with self._cv:
                work = (bool(self._queue) or self._active.any()
                        or prev is not None)
                if not work:
                    if stop.is_set():
                        break
                    self._cv.wait(idle_wait)
                    continue
                if (prev is None and not self._active.any()
                        and self._queue
                        and self._queue[0][0] > self._step_idx):
                    # future-only arrivals (seeded streams): jump the
                    # step clock instead of spinning
                    self._step_idx = self._queue[0][0]
            prev = self._loop_iter(prev)

    def wake(self) -> None:
        """Nudge an idle :meth:`run_forever` (call it right after
        setting the stop event)."""
        with self._cv:
            self._cv.notify_all()

    def load(self) -> Dict[str, int]:
        """Routing snapshot: queued (submitted, not yet seated), active
        slots, and the bank size."""
        with self._lock:
            queued = sum(1 for _, rid, _r in self._queue
                         if rid not in self._ended)
            return {"queued": queued,
                    "active": int(self._active.sum()),
                    "slots": self.max_slots}

    # -- introspection -------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Programs this engine has built: one per admission bucket
        (prefill, or inject in disaggregated mode) and, once a step has
        run, the one decode program (a CUDA graph capture on the card,
        the plain function on the CPU). The reference's bound,
        ``n_buckets + 1``, holds by construction: a bucket's program is
        built at its first admission, and the decode step is captured
        only while it has no graph."""
        return self.n_buckets + int(self._decode.steps > 0)

    @property
    def n_buckets(self) -> int:
        """Distinct admission buckets built so far: prefill programs
        plus (disaggregated mode) inject programs; the program bound is
        ``n_buckets + 1`` either way."""
        return len(self._prefills) + len(self._injects)

    def kv_cache_stats(self) -> Dict[str, Any]:
        """KV slot-bank occupancy: bytes the dense bank RESERVES against
        bytes live sequence prefixes COVER. Host arithmetic only (the
        mirrored per-slot lengths; reading the device ``lengths`` here
        would put a sync next to the decode loop)."""
        with self._lock:
            active = int(self._active.sum())
            live_tokens = int(self._slot_len[self._active].sum())
        live = live_tokens * self._kv_tok_bytes
        return {"slots": self.max_slots, "active": active,
                "reserved_bytes": self._kv_reserved, "live_bytes": live,
                "occupancy": (live / self._kv_reserved
                              if self._kv_reserved else 0.0)}

    def latency_stats(self) -> Dict[str, float]:
        """Per-token latency: p50/p99 over the gaps between a request's
        consecutive tokens (ms), from this engine's private fixed-bucket
        histogram (the same gaps also feed the process-wide
        ``serve_token_latency_ms``)."""
        n = self._lat.count
        if n == 0:
            return {"p50_token_ms": 0.0, "p99_token_ms": 0.0,
                    "n_gaps": 0}
        return {"p50_token_ms": float(self._lat.percentile(50)),
                "p99_token_ms": float(self._lat.percentile(99)),
                "n_gaps": n}

    def reset_stats(self) -> None:
        """Zero the per-engine latency histogram and step counter (the
        bench's warm-up boundary)."""
        with self._lock:      # _emit observes/updates these under _lock
            self._lat.reset()
            self._last_tok.clear()
            self.steps_run = 0
