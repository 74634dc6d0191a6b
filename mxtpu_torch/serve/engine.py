"""ServeEngine — continuous batching over the llama slot KV bank or a
paged KV pool: the port of ``mxtpu/serve/engine.py``.

Scheduler design (Orca, OSDI '22; PagedAttention, SOSP '23):

- **slot bank**: ``llama.init_slot_cache`` holds ``max_slots``
  independent cache rows; per-slot ``lengths`` confine attention to
  each request's own prefix (``slot_decode_attention``).
- **paged pool** (``paged=True``): ``llama.init_paged_cache`` holds
  fixed-size pages and each slot a host-owned row of the page table;
  admission is bounded by free pages (:class:`PageAllocator`, all or
  nothing), and registered prompt prefixes share their pages between
  slots, refcounted, with a copy-on-write fork of a shared boundary
  page (:class:`PrefixCache`). A warm admission prefills only the
  suffix. ``submit_prefilled`` also seats a journaled handoff shorter
  than its prompt (a resumed request) and prefills the rest.
- **speculative decoding** (``speculate_k``, paged only): the host
  drafts up to k tokens a slot (:func:`ngram_drafter` or any
  ``drafter``), one verify step runs them through the model, and an
  exact-match oracle on each slot's own key chain accepts a run, so
  the stream is the same whatever is drafted.
- **admission at step boundaries**: a finished slot is overwritten in
  place by the next queued request through a per-BUCKET prefill program
  (prompts end-padded to a power of two, which is exact, see
  ``llama.prefill_slot``), so the programs are bounded by the bucket
  count. Prefill and inject programs run eagerly.
- **one decode program**: every step runs ``llama.decode_slots`` (or
  ``decode_slots_paged``) over the full bank; per-slot position,
  length, key and sampling vectors make request churn invisible to its
  shapes. On the card it is one CUDA graph, captured at the first step
  and replayed on every step after (:class:`_DecodeGraph`), which takes
  the host's per-op launch cost out of decode; on the CPU it is the
  plain function. The verify step of speculative mode is a second
  graph over the same pool; a step where no slot drafted runs the
  plain one. :attr:`ServeEngine.compile_count` counts the programs.
- **overlapped host sync**: step ``t``'s tokens are read back only after
  step ``t+1`` has been dispatched, so the sync runs under the next
  step's device time (``MXTPU_SERVE_OVERLAP=0`` forces the synchronous
  order; speculative mode is synchronous, since the drafter reads every
  token emitted so far).

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

Mesh serving (ROADMAP Queue A item 11) raises until its slice.
"""
from __future__ import annotations

import contextlib
import heapq
import itertools
import threading
import time
import weakref
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import prng, telemetry
from ..base import env_int, env_str
from ..context import DeviceLike, resolve_device
from ..cuda_graphs import capture_graph
from ..models import llama
from ..telemetry import distributed as dtrace, perfscope, watcher

__all__ = ["Request", "KVHandoff", "ServeEngine", "bucket_for",
           "resume_key", "cancel_counter", "PageAllocator", "PrefixCache",
           "ngram_drafter"]

# admission wait is measured in engine steps (arrival → slot grant)
_WAIT_STEP_BUCKETS = (0.0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 1024)
# decode steps run on a side stream before the capture (lazy cuBLAS
# handles and workspaces are made there, not inside the graph)
_WARMUP_STEPS = 2

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
        # paged mode: the page pool
        "pages_total": telemetry.gauge(
            "serve_kv_pages_total",
            "Allocatable pages in the paged KV pool (scratch page 0 "
            "excluded)", engine=eid),
        "pages_free": telemetry.gauge(
            "serve_kv_pages_free",
            "Pages not mapped by any slot or prefix-cache entry",
            engine=eid),
        "pages_shared": telemetry.gauge(
            "serve_kv_pages_shared",
            "Pages mapped by more than one owner (refcount >= 2)",
            engine=eid),
        "prefix_hits": telemetry.counter(
            "serve_prefix_cache_hits_total",
            "Admissions seated on shared prefix pages (warm prefill)"),
        "prefix_misses": telemetry.counter(
            "serve_prefix_cache_misses_total",
            "Admissions that found no usable shared prefix"),
        "cow": telemetry.counter(
            "serve_cow_forks_total",
            "Copy-on-write page forks (private copy of a shared page)"),
        # speculative decoding: both ends of the accept rate
        "spec_proposed": telemetry.counter(
            "serve_spec_proposed_total",
            "Drafted tokens proposed to the speculative verify step"),
        "spec_accepted": telemetry.counter(
            "serve_spec_accepted_total",
            "Drafted tokens accepted (bit-exact match with the "
            "target chain)"),
        "spec_len": telemetry.histogram(
            "serve_spec_accepted_len",
            "Tokens emitted per slot per speculative step (1 + "
            "accepted run length)",
            buckets=(0.0, 1, 2, 3, 4, 6, 8, 12, 16)),
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


class PageAllocator:
    """Host-side refcounted allocator over the paged KV pool (the
    scheduler half of PagedAttention): pages are handed out from a free
    stack, shared read-only through :meth:`retain` (prefix sharing), and
    returned to the stack only when their last owner releases them.
    Page 0 is the scratch page: never allocated; zeroed page-table rows
    name it and redirected writes land there. Host state only; the
    engine serializes access under its lock."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(
                f"need >= 2 pages (scratch + 1), got {n_pages}")
        self.n_pages = int(n_pages)
        self._ref = np.zeros(self.n_pages, np.int32)
        # LIFO free stack: recently freed pages are handed out first;
        # page 0 is never a member
        self._free = list(range(self.n_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages with more than one owner (slot rows and cache entries)."""
        return int((self._ref >= 2).sum())

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages (refcount 1 each), or None, never a partial
        grant: a request that cannot seat whole leaves the pool as it
        was."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def retain(self, pages) -> None:
        """Add an owner to live pages (prefix sharing)."""
        for p in pages:
            if p == 0 or self._ref[p] < 1:
                raise ValueError(f"retain of non-live page {p}")
        for p in pages:
            self._ref[p] += 1

    def release(self, pages) -> None:
        """Drop one ownership per page; a page's last release frees it."""
        for p in pages:
            if p == 0 or self._ref[p] < 1:
                raise ValueError(f"release of non-live page {p}")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(int(p))


@dataclass
class _PrefixEntry:
    tokens: Tuple[int, ...]     # the full registered prompt
    n_tokens: int               # positions the pages actually cover
    pages: Tuple[int, ...]      # cache-owned (retained) pages
    hits: int = 0
    last_used: int = 0


class PrefixCache:
    """LRU map of registered prompt prefixes to the pool pages holding
    their K/V (RadixAttention's sharing, flat-keyed: a few system
    prompts dominate real traffic, so a bounded linear scan serves).
    Entries own a refcount on their pages, so a prefix outlives the
    request that prefilled it; eviction (LRU, or on demand when
    admission runs dry) releases that hold, and pages still mapped by
    live slots survive through the slots' own refs."""

    def __init__(self, allocator: PageAllocator, max_entries: int = 32):
        self._alloc = allocator
        self.max_entries = int(max_entries)
        self._entries: Dict[Tuple[int, ...], _PrefixEntry] = {}
        self._tick = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt) -> Tuple[Optional[_PrefixEntry], int]:
        """Longest registered prefix of ``prompt``, capped at
        ``len(prompt) - 1``: the last prompt token always runs through
        the forward pass (its logits give the first sample)."""
        pl = len(prompt)
        pt = tuple(int(x) for x in prompt)
        best, best_m = None, 0
        for e in self._entries.values():
            cap = min(e.n_tokens, pl - 1)
            if cap <= best_m:
                continue
            m = 0
            while m < cap and pt[m] == e.tokens[m]:
                m += 1
            if m > best_m:
                best, best_m = e, m
        return best, best_m

    def pin(self, entry: _PrefixEntry) -> None:
        """Freshen an entry's LRU position without counting a hit: the
        admission planner pins the matched entry before it allocates, so
        eviction under pool pressure prefers every other entry (a failed
        admission retries each step and must not inflate the hits)."""
        self._tick += 1
        entry.last_used = self._tick

    def touch(self, entry: _PrefixEntry) -> None:
        self.pin(entry)
        entry.hits += 1

    def insert(self, tokens, n_tokens: int, pages) -> _PrefixEntry:
        """Register ``pages`` as covering ``tokens[:n_tokens]``. The pages
        must be live; the cache retains its own hold on them. An insert
        over capacity evicts the LRU entry first."""
        key = tuple(int(x) for x in tokens)
        old = self._entries.pop(key, None)
        if old is not None:
            self._alloc.release(old.pages)
        while len(self._entries) >= self.max_entries:
            if not self.evict_lru():
                break
        self._alloc.retain(pages)
        self._tick += 1
        e = _PrefixEntry(key, int(n_tokens),
                         tuple(int(p) for p in pages),
                         last_used=self._tick)
        self._entries[key] = e
        return e

    def evict_lru(self, skip: Optional[_PrefixEntry] = None) -> bool:
        """Drop the least recently used entry, releasing its page hold.
        ``skip`` exempts one pinned entry (the planner's matched prefix:
        evicting it mid-plan would free the pages the plan is about to
        share). Returns False when nothing is evictable."""
        key, oldest = None, None
        for k, e in self._entries.items():
            if e is skip:
                continue
            if oldest is None or e.last_used < oldest:
                key, oldest = k, e.last_used
        if key is None:
            return False
        e = self._entries.pop(key)
        self._alloc.release(e.pages)
        return True

    def top(self, n: int = 5) -> List[Dict[str, Any]]:
        """The most-hit prefixes."""
        es = sorted(self._entries.values(), key=lambda e: -e.hits)[:n]
        return [{"n_tokens": e.n_tokens, "hits": e.hits,
                 "pages": len(e.pages),
                 "head": list(e.tokens[:8])} for e in es]


def ngram_drafter(history: np.ndarray, k: int) -> np.ndarray:
    """The default model-free drafter: the ``k`` tokens that followed the
    most recent earlier occurrence of the history's longest trailing
    n-gram (g = 3, 2, 1; prompt lookup decoding). A match at position
    ``i`` implies the stream repeats with period ``(n - g) - i``, so when
    fewer than ``k`` tokens follow the match the draft repeats that
    period: a plateau (period 1) drafts the whole budget. Host
    arithmetic only: drafting never touches a key chain, the device or
    another request, so the streams stay exact whatever it returns.
    Returns up to ``k`` int32 tokens (none makes a plain step)."""
    h = np.asarray(history, np.int64).reshape(-1)
    n = int(h.size)
    if k < 1 or n < 2:
        return np.empty(0, np.int32)
    for g in (3, 2, 1):
        if n <= g:
            continue
        tail = h[n - g:]
        for i in range(n - g - 1, -1, -1):
            if np.array_equal(h[i:i + g], tail):
                period = (n - g) - i
                out = h[[i + g + (j % period) for j in range(k)]]
                return out.astype(np.int32)
    return np.empty(0, np.int32)


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
    key = prng.PRNGKey(int(seed), device="cpu")  # noqa: MXL301 — chain ROOT: resume_key defines the oracle
    for _ in range(int(n_emitted)):
        key = prng.split(key)[0]  # noqa: MXL301 — this IS the chain primitive resume_key replays
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
    snapshot needed to attribute them after the overlapped sync. A
    speculative step carries (S, W) tokens in ``sampled`` and their
    validity in ``emits``, and the per-slot counts of drafted tokens."""
    sampled: Any                                   # (S,) int32 tensor
    slots: List[Tuple[int, int]]                   # (slot, rid) active
    firsts: List[Tuple[int, Any]]                  # (rid, (1,) tensor)
    emits: Any = None                              # spec: (S, W) bool
    proposed: Optional[np.ndarray] = None          # spec: (S,) host


class _DecodeGraph:
    """One of the engine's per-step programs over its bank:
    ``program(cfg, params, kv, sv, *knobs, rope=...)``, which writes kv
    and sv in place and returns its outputs followed by kv and sv.
    ``llama.decode_slots`` (the dense step: knobs ``active``,
    ``temperature``, ``top_k``, ``top_p``), ``decode_slots_paged`` (the
    (S, P) page table after ``active``) or ``decode_slots_spec`` (the
    table and the (S, k) drafts). Called with the knobs as host arrays;
    returns the program's output, or the tuple of them.

    On the CPU it is the plain function. On a CUDA bank it is a CUDA
    graph, captured at the first call after ``_WARMUP_STEPS`` steps on a
    side stream, and replayed on every call: the bank and the slot
    vectors are its static buffers (the step writes them in place), the
    host arrays are copied into static device buffers from pinned host
    memory before each replay (two pinned sets in turn, each reused
    only once its last copy has run), and the outputs are cloned out of
    the graph's memory on the stream, so a step read after the next one
    is dispatched (the overlapped loop) keeps its own tokens. The
    warm-up steps run on the real state: they write each slot's K/V at
    its next positions, past its length, which later steps write again,
    and the slot vectors are restored before the capture. Each graph
    has its own memory pool, so one engine's graphs never write each
    other's outputs.

    Everything the graph reads is held here or by the engine: the RoPE
    tables (``rope_len`` rows, the bank's max_len by default) are this
    object's own, not the shared cache's, which may drop them. The
    capture holds a process-wide lock and checks only its own thread's
    calls (``capture_error_mode="thread_local"``), so another engine's
    readback, prefill or allocation on another thread cannot break it.
    A capture that fails (a host sync inside the step) raises: there is
    no eager fallback.

    It is a watchable program (``telemetry.watch``): ``_cache_size()``
    is its captures on the card and, on the CPU, 1 once it has stepped.
    Building it (the capture, or the CPU's first step) runs inside
    ``watcher.build(name)``; the step a watcher counts is the last eager
    warm-up before the capture (the CPU's first step), never one inside
    ``torch.cuda.graph`` and never a replay."""

    def __init__(self, cfg, params, kv, sv, program=llama.decode_slots,
                 rope_len: Optional[int] = None, name: str = "serve_decode"):
        self.cfg, self.params, self.kv, self.sv = cfg, params, kv, sv
        self.program = program
        self.name = name
        self.device = kv["k"].device
        self._rope = llama.rope_tables(cfg, rope_len or kv["k"].shape[3],
                                       device=self.device)
        self.steps = 0
        self.captures = 0
        self._graph = None

    def _cache_size(self) -> int:
        if self.device.type == "cuda":
            return self.captures
        return int(self.steps > 0)

    def _step(self, *knobs):
        with torch.no_grad():
            out = self.program(self.cfg, self.params, self.kv, self.sv,
                               *knobs, rope=self._rope)
        return out[:-2]

    def __call__(self, *knobs):
        self.steps += 1
        if self.device.type != "cuda":
            knobs = [torch.from_numpy(np.array(k)) for k in knobs]
            if self.steps > 1:
                out = self._step(*knobs)
            else:
                with watcher.build(self.name), watcher.counted():
                    out = self._step(*knobs)
        else:
            if self._graph is None:
                self._capture(knobs)
            else:
                self._stage(knobs)
            self._graph.replay()
            out = tuple(o.clone() for o in self._out)
        return out[0] if len(out) == 1 else out

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

        def warm():
            for _ in range(_WARMUP_STEPS - 1):
                self._step(*self._static)
            with watcher.counted(self.device):
                self._step(*self._static)
            for n, t in saved.items():
                self.sv[n].copy_(t)

        def fn():
            self._out = self._step(*self._static)
        self._graph = capture_graph(self.name, fn, warm, self.device)
        self.captures += 1


def _release_ledger(led, pool: str, name: str) -> None:
    # a finalizer: queue the releases, never take a lock here
    led.release_later("params", name=name)
    led.release_later(pool, name=name)


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

    ``paged=True`` serves from a page pool instead of the dense bank:
    ``page_size`` tokens a page (``MXTPU_KV_PAGE_SIZE``, 16), ``n_pages``
    pages with scratch page 0 (``MXTPU_KV_PAGES``; by default the dense
    bank's capacity plus scratch), prefix sharing (``prefix_cache``,
    ``MXTPU_KV_PREFIX_CACHE``, on) and int8 pages (``int8_pages``,
    ``MXTPU_KV_INT8_PAGES``, off). ``speculate_k`` drafted tokens a step
    (``MXTPU_SERVE_SPECULATE_K``, 0) need ``paged=True``; ``drafter(history,
    k)`` drafts them (:func:`ngram_drafter` by default). ``mesh`` raises
    until its slice (ROADMAP Queue A item 11)."""

    def __init__(self, cfg, params, *, max_slots: Optional[int] = None,
                 max_len: Optional[int] = None,
                 min_bucket: Optional[int] = None,
                 mesh=None, overlap: Optional[bool] = None,
                 clock: Optional[Callable[[], float]] = None,
                 paged: bool = False,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 int8_pages: Optional[bool] = None,
                 speculate_k: Optional[int] = None,
                 drafter: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.paged = bool(paged)
        # speculative decoding drafts k tokens a slot on the host and
        # verifies them in one step; paged only, since the verify step
        # writes through the page table
        self.speculate_k = int(speculate_k if speculate_k is not None
                               else env_int("MXTPU_SERVE_SPECULATE_K", 0))
        if self.speculate_k < 0:
            raise ValueError(
                f"speculate_k must be >= 0, got {self.speculate_k}")
        if self.speculate_k and not self.paged:
            raise ValueError(
                "speculate_k requires paged=True (the verify program "
                "runs against the paged KV layout)")
        self._drafter = drafter or ngram_drafter
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
        if self.speculate_k:
            # the drafter reads every token emitted so far, so a step's
            # tokens are read before the next step is drafted
            self.overlap = False
        # the engine's name in per-request trace events, and the model
        # build it serves (a gateway replica stamps both)
        self.role = "engine"
        self.build: Optional[str] = None

        if self.paged:
            self.page_size = int(page_size or env_int(
                "MXTPU_KV_PAGE_SIZE", 16, "tokens a page of the paged KV "
                "pool"))
            self._pages_per_slot = -(-self.max_len // self.page_size)
            # by default the dense bank's capacity plus scratch page 0
            self.n_pages = int(n_pages or env_int(
                "MXTPU_KV_PAGES",
                self.max_slots * self._pages_per_slot + 1,
                "pages of the paged KV pool, scratch page 0 included"))
            self.prefix_cache_enabled = (
                bool(prefix_cache) if prefix_cache is not None
                else env_str("MXTPU_KV_PREFIX_CACHE", "1",
                             "0 turns prefix sharing off") != "0")
            self.int8_pages = (
                bool(int8_pages) if int8_pages is not None
                else env_str("MXTPU_KV_INT8_PAGES", "0",
                             "1 stores the paged pool as int8") == "1")
        else:
            self.page_size = None
            self.n_pages = 0
            self.prefix_cache_enabled = False
            self.int8_pages = False

        # normal tensors even when built under torch.inference_mode():
        # that mode is per thread, and a loop on another thread
        # (run_forever) writes the bank in place outside it
        with torch.inference_mode(False):
            if self.paged:
                state = llama.init_paged_cache(
                    cfg, self.max_slots, self.n_pages, self.page_size,
                    int8=self.int8_pages, device=self.device)
            else:
                state = llama.init_slot_cache(cfg, self.max_slots,
                                              self.max_len,
                                              device=self.device)
        self._kv = {n: state[n] for n in ("k", "v", "ks", "vs")
                    if n in state}
        self._sv = {n: state[n] for n in ("lengths", "tokens", "rngs")}
        # the decode program (and in speculative mode the verify step
        # beside it, on the same pool), and the admission buckets seen so
        # far (each runs eagerly: one program per bucket)
        # watch(): ONE decode program ever — a second capture is the
        # spurious-rebuild anomaly (recompile_total + offending key)
        telemetry.install_compile_listener()
        self._spec_decode = None
        if self.paged:
            cap = self._pages_per_slot * self.page_size
            self._decode = telemetry.watch(
                _DecodeGraph(cfg, params, self._kv, self._sv,
                             llama.decode_slots_paged, cap),
                "serve_decode", expected=1, loop="serve")
            if self.speculate_k:
                # the one extra watched program speculative mode adds
                self._spec_decode = telemetry.watch(
                    _DecodeGraph(cfg, params, self._kv, self._sv,
                                 llama.decode_slots_spec, cap,
                                 name="serve_spec_verify"),
                    "serve_spec_verify", expected=1, loop="serve")
            # the host page table (a small int32 operand of each step),
            # the refcounted allocator and the prefix cache
            self._pt = np.zeros((self.max_slots, self._pages_per_slot),
                                np.int32)
            self._pages = PageAllocator(self.n_pages)
            self._prefix = (PrefixCache(self._pages)
                            if self.prefix_cache_enabled else None)
            # the copy-on-write fork and registration copy: ONE program
            # (src and dst are arguments), this engine's own
            self._copy_fn = telemetry.watch(
                watcher.Program(partial(llama.copy_page, self._kv),
                                "serve_copy_page"),
                "serve_copy_page", expected=1)
            # engine-local tallies (the telemetry counters are
            # process-wide totals shared across engines)
            self._prefix_hits = 0
            self._prefix_misses = 0
            self._cow_forks = 0
        else:
            self._decode = telemetry.watch(
                _DecodeGraph(cfg, params, self._kv, self._sv),
                "serve_decode", expected=1, loop="serve")
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
        # speculative mode: per-slot history (prompt and every emitted
        # token) the drafter reads, and the draft/accept tallies (all
        # written under _lock)
        self._hist: List[List[int]] = [[] for _ in range(S)]
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_steps = 0

        # KV occupancy: host-mirrored per-slot lengths (a prefill seats
        # the prompt length; every decode dispatch adds one entry per
        # active slot, exactly the device's `lengths`, tracked without
        # reading it back: a sync here would block the decode loop)
        self._slot_len = np.zeros(S, np.int64)
        self._kv_reserved = int(sum(t.numel() * t.element_size()
                                    for t in self._kv.values()))
        if self.paged:
            # a token's bytes include the int8 scales; reserved counts
            # the whole pool, scratch page included
            self._kv_tok_bytes = (self._kv_reserved
                                  // (self.n_pages * self.page_size))
            self._m["pages_total"].set(self.n_pages - 1)
            self._m["pages_free"].set(self._pages.free_pages)
            self._m["pages_shared"].set(0)
        else:
            self._kv_tok_bytes = (2 * cfg.n_layers * cfg.n_kv_heads
                                  * cfg.head_dim
                                  * state["k"].element_size())
        self._m["kv_reserved"].set(self._kv_reserved)
        self._m["kv_live"].set(0)
        self._m["kv_occ"].set(0.0)
        # the ledger: this engine's params and bank, released when the
        # engine is collected (the entries would outlive it otherwise)
        led = perfscope.ledger()
        pool = "kv_page_pool" if self.paged else "kv_slot_bank"
        led.account_tree("params", params, name=f"engine{eid}")
        led.account(pool, self._kv_reserved, name=f"engine{eid}")
        weakref.finalize(self, _release_ledger, led, pool, f"engine{eid}")

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
        is emitted as this request's first token. In a paged engine the
        prompt may be longer than the handoff: a resumed request's prompt
        is the original one plus the tokens it had emitted, with
        ``rng=resume_key(seed, n)``; admission injects the journaled
        block and prefills only the emitted suffix over it."""
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
            if not self.paged:
                raise ValueError(
                    "handoff shorter than prompt: page-journaled resume "
                    "requires a paged engine")
            if prompt.size + request.max_new_tokens > self.max_len:
                raise ValueError(
                    f"prompt ({prompt.size}) + max_new_tokens "
                    f"({request.max_new_tokens}) exceeds max_len "
                    f"{self.max_len}")
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
                                             Optional[KVHandoff],
                                             Optional[Dict]]]:
        picks: List[Tuple[int, int, Request, Optional[KVHandoff],
                          Optional[Dict]]] = []
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
            plan = None
            if self.paged:
                # bounded by free pages: plan the slot's table row (shared
                # prefix, fork, fresh pages) first; a pool too full to
                # seat the head request leaves it queued (backpressure),
                # and completions free pages for a retry
                plan = self._plan_pages(req, self._handoffs.get(rid))
                if plan is None:
                    break
            heapq.heappop(self._queue)
            slot = int(free[0])
            self._m["wait"].observe(max(0, self._step_idx - arrival))
            self._seat(slot, rid, req)
            if plan is not None:
                self._pt[slot, :] = 0
                self._pt[slot, :len(plan["row"])] = plan["row"]
            if req.ctx is not None:
                with dtrace.use(req.ctx):
                    telemetry.instant("serve.seat", slot=slot,
                                      role=self.role)
            picks.append((slot, rid, req, self._handoffs.pop(rid, None),
                          plan))
        self._m["queue"].set(len(self._queue))
        self._m["slots"].set(int(self._active.sum()))
        if self.paged:
            self._m["pages_free"].set(self._pages.free_pages)
            self._m["pages_shared"].set(self._pages.shared_pages)
        return picks

    # -- paged admission planning (lock held) --------------------------------
    def _alloc_with_evict(self, n: int,
                          keep: Optional[_PrefixEntry] = None
                          ) -> Optional[List[int]]:
        """All-or-nothing page grant; when the pool runs dry, evict
        prefix-cache entries LRU first (their pages come back once no
        live slot shares them) and retry. ``keep``, the plan's matched
        entry, is never evicted by its own admission."""
        while True:
            pages = self._pages.alloc(n)
            if pages is not None:
                return pages
            if self._prefix is None \
                    or not self._prefix.evict_lru(skip=keep):
                return None

    def _plan_pages(self, req: Request,
                    handoff: Optional[KVHandoff]) -> Optional[Dict]:
        """Plan one paged admission: how many pages, which are shared
        from the prefix cache, where the copy-on-write fork goes, and
        what is registered after the prefill. Returns None when the pool
        cannot seat it (the request stays queued). Changes only the
        allocator and the prefix cache; the device work runs later, in
        ``_run_admissions``."""
        ps = self.page_size
        cap = self._pages_per_slot * ps
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        total = int(prompt.size) + int(req.max_new_tokens)
        n_total = -(-total // ps)
        entry, m = None, 0
        ignore_handoff = False
        if handoff is not None:
            # the inject block spans ceil(bucket / ps) pages; its pad
            # lands in the slot's own pages, masked by its length
            n_total = max(n_total, self._inject_block_len(handoff) // ps)
            tl = int(handoff.true_len)
            if (prompt.size > tl
                    and tl + bucket_for(int(prompt.size) - tl,
                                        self.min_bucket,
                                        self.max_len) > cap):
                # the resume suffix's bucket does not fit behind the
                # handoff: a cold prefill of the whole prompt with the
                # resume key gives the same tokens
                ignore_handoff = True
                n_total = -(-total // ps)
        elif self._prefix is not None:
            entry, m = self._prefix.lookup(prompt)
            suffix_bucket = bucket_for(int(prompt.size) - m,
                                       self.min_bucket, self.max_len)
            if entry is None or m < ps or m + suffix_bucket > cap:
                # no usable share: a match under a page is not worth a
                # fork, and the suffix bucket must fit the row
                entry, m = None, 0
        n_shared = m // ps
        # registration: cold admissions (and warm ones the cache cannot
        # already serve whole) register the full prompt; a partial
        # boundary page is copied into a cache-owned page after the
        # prefill, so decode writes past the prompt never reach the entry
        register = (handoff is None and self._prefix is not None
                    and int(prompt.size) >= ps
                    and m < int(prompt.size) - 1)
        reg_partial = register and (int(prompt.size) % ps != 0)
        n_fresh = n_total - n_shared
        # Pin the matched entry and hold its pages before any eviction
        # can run: under pool pressure _alloc_with_evict evicts prefix
        # entries, and without the planner's hold it could free (or hand
        # out again as fresh) the pages this plan is about to share. The
        # holds on the full shared pages pass to the slot's row; the
        # boundary page's hold keeps the fork's source live until the
        # copy is dispatched (_prefill_into_paged releases it).
        hold: List[int] = []
        if entry is not None:
            hold = [int(p) for p in entry.pages[:n_shared]]
            if m % ps:
                hold.append(int(entry.pages[n_shared]))
            self._pages.retain(hold)
            self._prefix.pin(entry)
        got = self._alloc_with_evict(n_fresh + (1 if reg_partial else 0),
                                     keep=entry)
        if got is None and entry is not None:
            # even with every other entry evicted the warm plan does not
            # fit: drop the share and plan cold, where the matched entry
            # is evictable too (a pinned entry never wedges admission)
            self._pages.release(hold)
            hold, entry, m, n_shared = [], None, 0, 0
            register = (handoff is None and self._prefix is not None
                        and int(prompt.size) >= ps
                        and 0 < int(prompt.size) - 1)
            reg_partial = register and (int(prompt.size) % ps != 0)
            n_fresh = n_total
            got = self._alloc_with_evict(n_fresh + (1 if reg_partial
                                                    else 0))
        if got is None:
            if hold:
                self._pages.release(hold)   # plan abandoned: unpin
            return None
        fresh, reg_page = ((got[:-1], got[-1]) if reg_partial
                           else (got, None))
        row = np.zeros(n_total, np.int32)
        fork = None
        if entry is not None:
            row[:n_shared] = entry.pages[:n_shared]
            if m % ps:
                # the suffix writes into the shared boundary page: fork
                # it into the first fresh page (the planner's hold keeps
                # the source live even if the entry is evicted first)
                fork = (int(entry.pages[n_shared]), int(fresh[0]))
            self._prefix.touch(entry)
            self._prefix_hits += 1
            self._m["prefix_hits"].inc()
        elif handoff is None and self._prefix is not None:
            self._prefix_misses += 1
            self._m["prefix_misses"].inc()
        row[n_shared:] = fresh
        reg = None
        if register:
            n_full = int(prompt.size) // ps
            reg_pages = list(row[:n_full])
            reg_copy = None
            if reg_partial:
                reg_copy = (int(row[n_full]), int(reg_page))
                reg_pages.append(int(reg_page))
            reg = {"tokens": tuple(int(t) for t in prompt),
                   "n_tokens": int(prompt.size),
                   "pages": reg_pages, "copy": reg_copy}
        return {"row": row, "prefix_len": m, "fork": fork,
                "register": reg, "ignore_handoff": ignore_handoff}

    def _run_admissions(self, picks, firsts: List[Tuple[int, Any]]
                        ) -> None:
        """Run the admission programs for already-seated picks (engine
        thread only: slot and bank state are loop-private)."""
        for slot, rid, req, handoff, plan in picks:
            with dtrace.use(req.ctx):
                if self.paged and handoff is not None:
                    first = self._inject_into_paged(slot, handoff, req,
                                                    plan)
                elif self.paged:
                    first = self._prefill_into_paged(slot, req, plan)
                elif handoff is not None:
                    first = self._inject_into(slot, handoff)
                else:
                    first = self._prefill_into(slot, req)
                firsts.append((rid, first))

    def _request_key(self, req: Request):
        """The request's key chain on the engine's device: ``PRNGKey(seed)``,
        or the explicit resume state ``req.rng``."""
        if req.rng is None:
            return prng.PRNGKey(req.seed, device=self.device)  # noqa: MXL301 — chain position 0 is PRNGKey(seed) by definition
        return prng.key_from_numpy(np.asarray(req.rng, np.uint32),
                                   self.device)

    def _prefill_into(self, slot: int, req: Request):
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        bucket = bucket_for(prompt.size, self.min_bucket, self.max_len)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :prompt.size] = prompt
        with self._bucket_build(self._prefills, bucket, "serve_prefill"), \
                self._span_prefill(bucket=bucket, role=self.role), \
                torch.no_grad():
            tok, _, _ = llama.prefill_slot(
                self.cfg, self.params,
                torch.from_numpy(padded).to(self.device), prompt.size,
                slot, self._kv, self._sv, self._request_key(req),
                float(req.temperature), req.top_k, req.top_p)
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
        with self._bucket_build(self._injects, bucket, "serve_inject"), \
                self._span_prefill(bucket=bucket, inject=True,
                                   role=self.role), torch.no_grad():
            llama.inject_slot_kv(
                self.cfg, h.k, h.v, h.true_len, slot, h.token,
                prng.key_from_numpy(np.asarray(h.rng, np.uint32),
                                    self.device),
                self._kv, self._sv)
        with self._lock:      # host mirror of lengths: kv_cache_stats
            self._slot_len[slot] = h.true_len  # sums it under _lock
        return torch.tensor([h.token], dtype=torch.int32)

    # -- paged admission programs --------------------------------------------
    def _copy_page(self, src: int, dst: int) -> None:
        """The copy-on-write fork and the registration copy: one page of
        every pool array, eager, ordered before the next program on the
        stream."""
        with torch.no_grad():
            self._copy_fn(src, dst)

    def _bucket_build(self, table: Set[int], bucket: int, program: str):
        """The context an admission at ``bucket`` runs in: the first one
        builds the bucket's program (``watcher.build``), the rest reuse
        it."""
        if bucket in table:
            return contextlib.nullcontext()
        table.add(bucket)
        return watcher.build(program)

    def _run_paged_prefill(self, slot: int, req: Request, suffix,
                           total_len: int, prefix_len: int):
        """One warm or cold paged prefill: the suffix tokens, end-padded
        to their bucket, at ``pos=prefix_len`` over the slot's pages.
        The suffix's bucket keys the program, so a warm admission runs a
        smaller bucket than its whole prompt would."""
        bucket = bucket_for(int(suffix.size), self.min_bucket,
                            self.max_len)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :suffix.size] = suffix
        with self._bucket_build(self._prefills, bucket, "serve_prefill"), \
                self._span_prefill(bucket=bucket, role=self.role,
                                   prefix_len=prefix_len), torch.no_grad():
            tok, _, _ = llama.prefill_slot_paged(
                self.cfg, self.params,
                torch.from_numpy(padded).to(self.device), total_len,
                prefix_len, self._pt[slot].copy(), slot, self._kv,
                self._sv, self._request_key(req), float(req.temperature),
                req.top_k, req.top_p)
        with self._lock:
            self._slot_len[slot] = total_len
        return tok

    def _prefill_into_paged(self, slot: int, req: Request, plan):
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        m = plan["prefix_len"]
        if plan["fork"] is not None:
            # the suffix writes into the shared boundary page: this slot
            # gets a private copy first (stream order puts the copy
            # before the prefill)
            src, dst = plan["fork"]
            self._copy_page(src, dst)
            with self._lock:
                self._cow_forks += 1
                # the copy is queued: drop the planner's pin on the source
                self._pages.release([src])
            self._m["cow"].inc()
        tok = self._run_paged_prefill(slot, req, prompt[m:],
                                      int(prompt.size), m)
        reg = plan["register"]
        if reg is not None:
            if reg["copy"] is not None:
                # the entry's partial boundary page is a cache-owned copy
                # of the slot's: decode writes past the prompt must never
                # reach the registered prefix
                self._copy_page(*reg["copy"])
            with self._lock:
                self._prefix.insert(reg["tokens"], reg["n_tokens"],
                                    reg["pages"])
                if reg["copy"] is not None:
                    # insert() retains; drop the planner's hold
                    self._pages.release([reg["copy"][1]])
        return tok

    def _inject_block_len(self, h: KVHandoff) -> int:
        """The block length the paged inject runs at: a page-granular wire
        trims handoff blocks to the page multiple that covers
        ``true_len``, an arbitrary multiple per prompt length, so the
        block is padded back to its power-of-two bucket (rounded up to
        whole pages) and inject programs stay bounded by the buckets."""
        blk = int(h.k.shape[2])
        b = bucket_for(blk, self.min_bucket, self.max_len)
        b = -(-b // self.page_size) * self.page_size
        return max(blk, b)

    def _inject_into_paged(self, slot: int, h: KVHandoff, req: Request,
                           plan):
        """Paged admission of a handed-off prefill; when the prompt is
        longer than the handoff (a journaled resume), the emitted suffix
        is prefilled warm over the injected pages in the same
        admission."""
        if plan["ignore_handoff"]:
            return self._prefill_into_paged(slot, req, plan)
        bucket = self._inject_block_len(h)
        k, v = torch.as_tensor(h.k), torch.as_tensor(h.v)
        if bucket > k.shape[2]:
            # a wire-trimmed block: zero-pad it to the bucket (positions
            # past true_len are masked by the length)
            pad = (0, 0, 0, bucket - k.shape[2])
            k = torch.nn.functional.pad(k, pad)
            v = torch.nn.functional.pad(v, pad)
        with self._bucket_build(self._injects, bucket, "serve_inject"), \
                self._span_prefill(bucket=bucket, inject=True,
                                   role=self.role), torch.no_grad():
            llama.inject_paged_kv(
                self.cfg, k, v, h.true_len, self._pt[slot].copy(), slot,
                h.token, prng.key_from_numpy(np.asarray(h.rng, np.uint32),
                                             self.device),
                self._kv, self._sv)
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size > h.true_len:
            return self._run_paged_prefill(
                slot, req, prompt[h.true_len:], int(prompt.size),
                int(h.true_len))
        with self._lock:
            self._slot_len[slot] = h.true_len
        return torch.tensor([h.token], dtype=torch.int32)

    def _seat(self, slot: int, rid: int, req: Request) -> None:
        self._active[slot] = True
        self._temps[slot] = req.temperature
        self._topks[slot] = (self.cfg.vocab_size if req.top_k is None
                             else req.top_k)
        self._topps[slot] = 1.0 if req.top_p is None else req.top_p
        self._slot_rid[slot] = rid
        if self.speculate_k:
            # the drafting context: the prompt now, every emission later
            # (a resumed prompt already holds the tokens emitted before)
            self._hist[slot] = [
                int(t) for t in np.asarray(req.prompt, np.int32).reshape(-1)]

    # -- stepping ------------------------------------------------------------
    def _build_drafts(self) -> Optional[np.ndarray]:
        """Host drafting for one speculative step: up to ``speculate_k``
        tokens per active slot from the drafter, clamped to
        ``max_new_tokens - emitted - 1`` so every accepted write stays
        inside the slot's granted pages (the plan covers prompt +
        max_new_tokens, and the last token's K/V is never written).
        Returns (S, k) int32 with -1 for no draft, or None when no slot
        drafted: the loop then runs the plain step."""
        K = self.speculate_k
        drafts = np.full((self.max_slots, K), -1, np.int32)
        any_d = False
        with self._lock:
            for s, rid in enumerate(self._slot_rid):
                if rid is None or not self._active[s]:
                    continue
                req = self._requests.get(rid)
                res = self._results.get(rid)
                if req is None or res is None \
                        or self._done.get(rid, True) \
                        or rid in self._cancelled:
                    continue
                hist = self._hist[s]
                # the history ends with the pending token (device length
                # + 1 entries); a slot admitted this step has its first
                # token still on the device and drafts nothing this once
                if len(hist) <= int(self._slot_len[s]):
                    continue
                budget = min(K, int(req.max_new_tokens) - len(res) - 1)
                if budget < 1:
                    continue
                d = np.asarray(
                    self._drafter(np.asarray(hist, np.int32), budget),
                    np.int32).reshape(-1)[:budget]
                if d.size:
                    drafts[s, :d.size] = d
                    any_d = True
        return drafts if any_d else None

    def _dispatch(self, firsts) -> _Dispatch:
        # host DISPATCH time only: on the card the step runs async (no
        # sync in the decode loop); device time belongs to the profiler
        drafts = self._build_drafts() if self.speculate_k else None
        emits = proposed = None
        with self._span_decode():
            if drafts is not None:
                # the verify step: each slot's token and its drafts in one
                # forward, accepted by identity down the same key chain
                sampled, emits = self._spec_decode(
                    self._active, self._pt, drafts, self._temps,
                    self._topks, self._topps)
                proposed = (drafts >= 0).sum(axis=1).astype(np.int64)
            elif self.paged:
                sampled = self._decode(self._active, self._pt, self._temps,
                                       self._topks, self._topps)
            else:
                sampled = self._decode(self._active, self._temps,
                                       self._topks, self._topps)
        self._m["steps"].inc()
        with self._lock:
            self.steps_run += 1
            if drafts is not None:
                self._spec_steps += 1
            slots = [(s, rid) for s, rid in enumerate(self._slot_rid)
                     if self._active[s] and rid is not None]
            if emits is None:
                # the decode step appends one cache entry per active
                # slot; mirror that on the host (no readback). A verify
                # step advances by the accepted run, known after the
                # sync: _process (synchronous in this mode) mirrors it
                for s, _rid in slots:
                    self._slot_len[s] += 1
        return _Dispatch(sampled, slots, firsts, emits=emits,
                         proposed=proposed)

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
        emits = (disp.emits.cpu().numpy()
                 if disp.emits is not None and disp.slots else None)
        firsts = [(rid, int(tok.reshape(-1)[0])) for rid, tok in disp.firsts]
        now = time.perf_counter()
        with self._lock:
            rid2slot = ({rid: s for s, rid in enumerate(self._slot_rid)
                         if rid is not None} if self.speculate_k else {})
            for rid, tok in firsts:
                if rid not in self._cancelled:
                    self._emit(rid, tok, now)
                    s = rid2slot.get(rid)
                    if s is not None:
                        self._hist[s].append(tok)
            for slot, rid in disp.slots:
                if emits is not None:
                    self._emit_run(slot, rid, sampled[slot], emits[slot],
                                   int(disp.proposed[slot]), now)
                elif not self._done.get(rid, True) \
                        and rid not in self._cancelled:
                    tok = int(sampled[slot])
                    self._emit(rid, tok, now)
                    if self.speculate_k:
                        self._hist[slot].append(tok)
            for slot, rid in enumerate(self._slot_rid):
                if rid is None:
                    continue
                reason = self._cancelled.get(rid)
                if reason is not None:
                    self._finalize(rid, reason)
                if self._done.get(rid, True):
                    self._active[slot] = False   # recycle at the next
                    self._slot_rid[slot] = None  # step boundary
                    if self.paged:
                        # release the slot's hold on its pages; prefix
                        # entries keep their own, so shared pages outlive
                        # the request that seeded them
                        row = self._pt[slot]
                        held = [int(p) for p in row if p]
                        if held:
                            self._pages.release(held)
                        row[:] = 0
            self._m["slots"].set(int(self._active.sum()))
            if self.paged:
                self._m["pages_free"].set(self._pages.free_pages)
                self._m["pages_shared"].set(self._pages.shared_pages)
            live = (int(self._slot_len[self._active].sum())
                    * self._kv_tok_bytes)
            self._m["kv_live"].set(live)
            self._m["kv_occ"].set(live / self._kv_reserved
                                  if self._kv_reserved else 0.0)

    def _emit_run(self, slot: int, rid: int, toks, valid, proposed: int,
                  now: float) -> None:
        """A verify step's tokens for one slot (lock held): the device
        advanced the slot by its accepted run, so the host mirror of its
        length does too, and the run is emitted in order until the
        request completes or is cancelled (the device's advance past a
        finishing request is inert: the slot is freed and re-seeded at
        its next admission)."""
        n = int(valid.sum())
        self._slot_len[slot] += n
        self._spec_proposed += proposed
        self._spec_accepted += n - 1
        if proposed:
            self._m["spec_proposed"].inc(proposed)
            self._m["spec_accepted"].inc(n - 1)
        self._m["spec_len"].observe(n)
        for i in range(n):
            # a pruned rid (not retained, finalized) reads as done
            if self._done.get(rid, True) or rid in self._cancelled:
                break
            tok = int(toks[i])
            self._emit(rid, tok, now)
            self._hist[slot].append(tok)

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
        the plain function on the CPU); a paged engine adds the page
        copy once it has forked or registered a page, and a speculative
        one the verify step once it has run. The reference's bounds,
        ``n_buckets + 1`` (dense), ``+ 2`` (paged) and ``+ 3``
        (speculative), hold by construction: a bucket's program is built
        at its first admission, and a step is captured only while it has
        no graph. Read from the watched programs' ``_cache_size()``."""
        n = self.n_buckets + self._decode._cache_size()
        if self.paged:
            n += self._copy_fn._cache_size()
        if self._spec_decode is not None:
            n += self._spec_decode._cache_size()
        return n

    @property
    def n_buckets(self) -> int:
        """Distinct admission buckets built so far: prefill programs
        plus (disaggregated mode) inject programs; the program bound is
        ``n_buckets + 1`` either way."""
        return len(self._prefills) + len(self._injects)

    def kv_cache_stats(self) -> Dict[str, Any]:
        """KV occupancy: bytes the bank or pool RESERVES against bytes
        live sequence prefixes COVER; in paged mode also the pages and
        the prefix cache, and in speculative mode the draft and accept
        counts. Host arithmetic only (the mirrored per-slot lengths;
        reading the device ``lengths`` here would put a sync next to the
        decode loop)."""
        with self._lock:
            active = int(self._active.sum())
            live_tokens = int(self._slot_len[self._active].sum())
            out = {"slots": self.max_slots, "active": active,
                   "reserved_bytes": self._kv_reserved}
            if self.paged:
                out.update({
                    "paged": True,
                    "page_size": self.page_size,
                    "pages_total": self.n_pages - 1,
                    "pages_free": self._pages.free_pages,
                    "pages_used": self._pages.used_pages,
                    "pages_shared": self._pages.shared_pages,
                    "cow_forks": self._cow_forks,
                    "prefix_hits": self._prefix_hits,
                    "prefix_misses": self._prefix_misses,
                    "prefix_entries": (len(self._prefix)
                                       if self._prefix is not None else 0),
                    "top_prefixes": (self._prefix.top()
                                     if self._prefix is not None else []),
                })
                if self.speculate_k:
                    prop = self._spec_proposed
                    out.update({
                        "speculate_k": self.speculate_k,
                        "spec_proposed": prop,
                        "spec_accepted": self._spec_accepted,
                        "spec_accept_rate": (self._spec_accepted / prop
                                             if prop else 0.0),
                        "spec_steps": self._spec_steps,
                    })
        live = live_tokens * self._kv_tok_bytes
        out["live_bytes"] = live
        out["occupancy"] = (live / self._kv_reserved
                            if self._kv_reserved else 0.0)
        return out

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
        """Zero the per-engine latency histogram, the step counter and the
        speculative accept counters (the bench's warm-up boundary, so an
        accept rate leaves the warm-up out)."""
        with self._lock:      # _emit observes/updates these under _lock
            self._lat.reset()
            self._last_tok.clear()
            self.steps_run = 0
            self._spec_proposed = 0
            self._spec_accepted = 0
            self._spec_steps = 0
