"""Perfscope — live roofline attribution, HBM ledger, step anomalies: the
port of ``mxtpu/telemetry/perfscope.py``.

The numbers that explain a slow step (per-program FLOPs and bytes, peak
device memory, KV-bank waste) are an always-on runtime layer here, on
the telemetry substrate:

- **program cost catalog** — :func:`profile_program` counts one call of
  a program and publishes ``mxtpu_program_flops``,
  ``mxtpu_program_bytes_accessed``, arithmetic intensity, and a
  roofline class (``compute_bound`` vs ``memory_bound`` at the
  device's FLOP/byte knee). ``telemetry.watch`` counts the call that
  builds each variant of a watched program (the train step, the serve
  engine's decode, verify and page-copy programs), never a second
  call: the port's programs write their state in place, so running one
  again to count it would corrupt a stream or a trajectory.

  How a call is counted (:class:`CostCount`, a ``TorchDispatchMode``):
  FLOPs are what ``torch.utils.flop_counter`` gives the products (its
  formula table: ``mm``, ``bmm``, ``addmm``, convolutions, ...; an
  elementwise op is 0 FLOPs); bytes accessed are the operand and result
  bytes of every aten op that is not a view (and not an allocation,
  which moves nothing). In an eager program every op is its own kernel,
  so this is what the program moves through device memory; the
  reference reads XLA's cost model instead, which counts a fused
  program's bytes once per fusion, so the two byte counts differ by
  the fusion XLA would have done. A hand-written kernel is not an aten
  op: its wrapper reports its own ``(flops, bytes)`` through
  :func:`reported`, which also keeps the count from seeing the aten ops
  of the wrapper's allocations or of its plain version, so a program
  counts the same on a CPU tensor (the plain version runs) and on a
  CUDA tensor (the kernel runs). The count is reached through the
  dispatch-mode stack, which autograd carries to its device threads,
  so the backward kernels that ``torch.autograd.grad`` runs there are
  counted too. Peak bytes are ``torch.cuda.max_memory_allocated()``
  over the call, after resetting the card's peak statistic (on the CPU
  they are None).
- **live MFU / MBU** — :meth:`PerfScope.on_call` keeps a rolling
  window of inter-dispatch gaps per program. The gap between
  consecutive dispatches of a steady loop tracks the device step time:
  the loop is paced by the previous step's readback. Catalog
  flops/bytes over the rolling mean gap give ``mxtpu_mfu{program}``
  and ``mxtpu_hbm_bw_util{program}``. The ratio math lives in ONE
  helper pair (:func:`mfu` / :func:`hbm_bw_util`), which offline
  readers (``chip_smoke.py``) call too, so offline and live MFU cannot
  disagree by construction.
- **HBM ledger** — :class:`HBMLedger` accounts device-resident bytes
  by category (params / optimizer / kv_slot_bank / kv_page_pool /
  workspace), publishes ``mxtpu_hbm_ledger_bytes{category}`` +
  ``mxtpu_hbm_headroom_bytes`` (capacity from
  ``torch.cuda.mem_get_info()`` on the card), and leaves an
  OOM-adjacent flight record when headroom first dips below
  ``MXTPU_TELEMETRY_PERF_HEADROOM_BYTES``. The KV byte helpers
  (:func:`kv_slot_bank_bytes` / :func:`kv_live_bytes`) are the
  reserved-against-live arithmetic of the serving engine.
- **step-anomaly detector** — per-program rolling median/MAD over the
  same gaps; a gap beyond ``median + k*MAD`` emits a ``perf.anomaly``
  instant, a flight record naming the program, and increments
  ``mxtpu_step_anomalies_total{program}``. Gaps longer than
  ``MXTPU_TELEMETRY_PERF_IDLE_S`` are the loop being idle (a parked
  serve engine), not a slow step: they reset the window instead.

Goodput: :func:`goodput_gauge` is the ONE definition of
``mxtpu_goodput_ratio{loop=...}``; programs registered with a loop
(``watch(..., loop="train"/"serve")``) get a step-pacing goodput
(fraction of wall the window spent at median pace) published
automatically.

Device table: the card the port runs on (NVIDIA H100 80GB HBM3, the
SXM datasheet's dense bf16 peak and HBM rate) and a nominal ``cpu``
row, so CPU tests classify deterministically. A card the table does
not know raises unless the ``MXTPU_TELEMETRY_PERF_PEAK_FLOPS`` and
``MXTPU_TELEMETRY_PERF_PEAK_BW`` overrides name its peaks: there is
no silent fallback to another part's numbers.

Everything on a loop's path is exception-safe and honors the master
``MXTPU_TELEMETRY`` switch plus its own ``MXTPU_TELEMETRY_PERF`` knob:
attribution must never break a train or serve loop.
"""
from __future__ import annotations

import bisect
import contextlib
import logging
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

from ..base import env_bool, env_float, env_int

__all__ = [
    "DeviceSpec", "ProgramCost", "PerfScope", "HBMLedger", "CostCount",
    "device_spec", "spec_for", "mfu", "hbm_bw_util", "roofline_class",
    "bound_ms", "profile_program", "program_costs", "on_call", "scope",
    "catalog", "ledger", "goodput_gauge", "tree_bytes",
    "kv_slot_bank_bytes", "kv_live_bytes", "reported", "reset",
]

_log = logging.getLogger(__name__)

# -- knobs ------------------------------------------------------------------
_PERF_ON = env_bool(
    "MXTPU_TELEMETRY_PERF", True,
    "Perfscope layer (program cost catalog, live MFU/MBU, step-anomaly "
    "detector). 0 disables it while leaving the rest of telemetry on.")
_WINDOW = env_int(
    "MXTPU_TELEMETRY_PERF_WINDOW", 64,
    "Rolling window (steps) for per-program MFU/MBU/goodput gauges and "
    "the anomaly detector's median/MAD.")
_ANOMALY_K = env_float(
    "MXTPU_TELEMETRY_PERF_ANOMALY_K", 8.0,
    "Step-anomaly threshold: a step gap beyond median + k*MAD of the "
    "rolling window trips mxtpu_step_anomalies_total + a flight record.")
_MIN_SAMPLES = env_int(
    "MXTPU_TELEMETRY_PERF_MIN_SAMPLES", 8,
    "Gaps required in a program's window before the anomaly detector "
    "arms (median/MAD over fewer steps is noise).")
_IDLE_S = env_float(
    "MXTPU_TELEMETRY_PERF_IDLE_S", 2.0,
    "A dispatch gap longer than this is the loop being IDLE (parked "
    "serve engine between requests), not a slow step: the program's "
    "rolling window resets instead of flagging an anomaly.")
_PEAK_FLOPS = env_float(
    "MXTPU_TELEMETRY_PERF_PEAK_FLOPS", 0.0,
    "Override the device's peak FLOP/s for MFU/roofline math "
    "(0 = the built-in table keyed on torch.cuda.get_device_name()); "
    "required, with MXTPU_TELEMETRY_PERF_PEAK_BW, on a card the table "
    "does not know.")
_PEAK_BW = env_float(
    "MXTPU_TELEMETRY_PERF_PEAK_BW", 0.0,
    "Override the device's peak memory bytes/s for MBU/roofline math "
    "(0 = built-in table).")
_HBM_BYTES = env_float(
    "MXTPU_TELEMETRY_PERF_HBM_BYTES", 0.0,
    "Override the device memory capacity for the ledger's headroom "
    "gauge (0 = torch.cuda.mem_get_info() on the card, else the "
    "built-in table).")
_HEADROOM_BYTES = env_float(
    "MXTPU_TELEMETRY_PERF_HEADROOM_BYTES", 0.0,
    "When hbm_headroom_bytes first drops below this, record an "
    "OOM-adjacent flight event with the full ledger breakdown "
    "(0 = disabled; set ~1e9 on real cards).")


# -- device roofline specs -------------------------------------------------
@dataclass(frozen=True)
class DeviceSpec:
    """Per-device peaks used for MFU/MBU and the roofline knee. The
    dense bf16 matmul peak is the MFU convention published numbers
    use."""
    kind: str
    peak_flops: float        # dense bf16 FLOP/s, one device
    peak_bw: float           # device-memory bytes/s, one device
    hbm_bytes: float         # device-memory capacity, one device

    @property
    def knee(self) -> float:
        """FLOP/byte where the roofline turns: programs with lower
        arithmetic intensity are memory-bound on this device."""
        return self.peak_flops / self.peak_bw


# matched by substring of the lower-cased device name, first hit wins.
# The H100 row is NVIDIA's SXM datasheet (dense bf16 tensor cores,
# HBM3); the CPU row is a nominal desktop-class roofline so CPU tests
# classify deterministically.
_SPECS: Tuple[Tuple[Tuple[str, ...], DeviceSpec], ...] = (
    (("h100",), DeviceSpec("NVIDIA H100 80GB HBM3", 989e12, 3.35e12,
                           80e9)),
    (("cpu",), DeviceSpec("cpu", 5e11, 5e10, 16e9)),
)


def spec_for(kind: str) -> DeviceSpec:
    """The roofline spec for a device name (``torch.cuda.get_device_name``
    or ``"cpu"``), with the MXTPU_TELEMETRY_PERF_* overrides applied.
    Raises on a device the table does not know unless both peak
    overrides are set."""
    k = str(kind).lower()
    for keys, spec in _SPECS:
        if any(key in k for key in keys):
            return _apply_overrides(spec)
    if not (_PEAK_FLOPS and _PEAK_BW):
        raise ValueError(
            f"perfscope has no roofline for device {kind!r}: set "
            "MXTPU_TELEMETRY_PERF_PEAK_FLOPS and "
            "MXTPU_TELEMETRY_PERF_PEAK_BW (and "
            "MXTPU_TELEMETRY_PERF_HBM_BYTES) to its peaks")
    return DeviceSpec(str(kind), _PEAK_FLOPS, _PEAK_BW, _HBM_BYTES or 0.0)


def _apply_overrides(spec: DeviceSpec) -> DeviceSpec:
    if not (_PEAK_FLOPS or _PEAK_BW or _HBM_BYTES):
        return spec
    return DeviceSpec(spec.kind,
                      _PEAK_FLOPS or spec.peak_flops,
                      _PEAK_BW or spec.peak_bw,
                      _HBM_BYTES or spec.hbm_bytes)


_device_name: Optional[str] = None


def device_spec() -> DeviceSpec:
    """The current process's device spec: the visible card's
    (``torch.cuda.get_device_name()``, read once), else the cpu row."""
    global _device_name
    if _device_name is None:
        _device_name = (torch.cuda.get_device_name()
                        if torch.cuda.is_available() else "cpu")
    return spec_for(_device_name)


# -- the shared ratio helpers (offline readers + live gauges) --------------
def mfu(flops: float, seconds: float,
        peak_flops: Optional[float] = None) -> float:
    """Model FLOPs utilization: useful flops / (wall seconds x peak).
    THE one definition — offline readers pass their counted flops and
    the card's peak; the live gauges pass catalog flops and the local
    device peak. Pass ``peak_flops`` explicitly to pin the
    denominator."""
    if seconds <= 0:
        return 0.0
    peak = device_spec().peak_flops if peak_flops is None else peak_flops
    return flops / seconds / peak if peak > 0 else 0.0


def hbm_bw_util(nbytes: float, seconds: float,
                peak_bw: Optional[float] = None) -> float:
    """Memory-bandwidth utilization: bytes accessed / (wall seconds x
    peak memory bandwidth) — MBU, the serving-side twin of MFU."""
    if seconds <= 0:
        return 0.0
    peak = device_spec().peak_bw if peak_bw is None else peak_bw
    return nbytes / seconds / peak if peak > 0 else 0.0


def roofline_class(flops: float, bytes_accessed: float,
                   spec: Optional[DeviceSpec] = None) -> str:
    """``compute_bound`` iff arithmetic intensity (flops per byte
    accessed) is at or past the device's roofline knee."""
    sp = spec or device_spec()
    if bytes_accessed <= 0:
        return "compute_bound"
    return ("compute_bound" if flops / bytes_accessed >= sp.knee
            else "memory_bound")


def bound_ms(flops: float, nbytes: float, spec: Optional[DeviceSpec] = None,
             peak_flops: Optional[float] = None) -> Tuple[float, str]:
    """(ms, ``"operations"`` | ``"bytes"``): the least time the device
    could take for ``flops`` at its peak (``peak_flops`` for work that
    does not run on the bf16 tensor cores) and ``nbytes`` at its memory
    rate, whichever is larger."""
    sp = spec or device_spec()
    t_ops = flops / (sp.peak_flops if peak_flops is None else peak_flops)
    t_bytes = nbytes / sp.peak_bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# -- counting one call: a dispatch mode ------------------------------------
_NO_BYTES = frozenset(
    getattr(torch.ops.aten, n) for n in ("empty", "empty_strided",
                                         "empty_like", "new_empty",
                                         "new_empty_strided"))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class CostCount(TorchDispatchMode):
    """Count one call: FLOPs by ``torch.utils.flop_counter``'s formulas
    and the operand and result bytes of every aten op that is not a
    view or an allocation. ``with CostCount() as c: fn(...)``, then
    ``c.flops`` and ``c.bytes``. Hand-written kernels add their own
    cost through :func:`reported`. Thread-safe: autograd's device
    threads run the backward of a counted call under the same mode."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self._lock = threading.Lock()
        self._quiet = threading.local()
        self._composites: Dict[Any, bool] = {}

    def add(self, flops: float, nbytes: float) -> None:
        with self._lock:
            self.flops += flops
            self.bytes += nbytes

    def _composite(self, func, args) -> bool:
        """Whether ``func`` on these tensors' device is only its
        CompositeImplicitAutograd decomposition (no kernel of its own,
        whose numbers might differ from the decomposition's)."""
        dev = next((a.device.type for a in tree_leaves(args)
                    if isinstance(a, torch.Tensor)), None)
        key = (func, dev)
        hit = self._composites.get(key)
        if hit is None:
            has = torch._C._dispatch_has_kernel_for_dispatch_key
            name = func.name()
            hit = self._composites[key] = bool(
                dev in ("cpu", "cuda")
                and has(name, "CompositeImplicitAutograd")
                and not has(name, dev.upper())
                and not has(name, "CompositeExplicitAutograd"))
        return hit

    def _formula(self, packet):
        formula = self._formulas.get(packet)
        if formula is None and packet.__name__.endswith("_"):
            # an in-place product (``addmm_``) costs what its
            # functional form does
            formula = self._formulas.get(
                getattr(torch.ops.aten, packet.__name__[:-1], None))
        return formula

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        formula = self._formula(packet)
        if formula is None and self._composite(func, args):
            # a composite op that reached the mode undecomposed (under
            # inference_mode, ``matmul`` does) and has no kernel of its
            # own on this device: it runs as its decomposition anyway, so
            # run that here, where the products inside are counted
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if getattr(self._quiet, "depth", 0):
            return out
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        nbytes = 0 if (getattr(func, "is_view", False)
                       or packet in _NO_BYTES) else \
            _nbytes((args, kwargs)) + _nbytes(out)
        if flops or nbytes:
            self.add(flops, nbytes)
        return out

    @contextlib.contextmanager
    def quiet(self):
        """Context: this thread's aten ops go uncounted (a wrapper whose
        kernel reports its own cost)."""
        self._quiet.depth = getattr(self._quiet, "depth", 0) + 1
        try:
            yield
        finally:
            self._quiet.depth -= 1


def active_count() -> Optional[CostCount]:
    """The innermost :class:`CostCount` on this thread's dispatch-mode
    stack (autograd's device threads inherit it), or None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCount):
            return mode
    return None


def reported(cost: Callable[[], Tuple[float, float]], run: Callable,
             *args, **kwargs):
    """``run(*args, **kwargs)``, and under an active count: its own aten
    ops uncounted and ``cost()`` → ``(flops, bytes)`` added instead.
    What a hand-written kernel's wrapper calls around its launch and
    around its plain version, so both count the kernel's work. Without
    a count this is one C call and the call itself."""
    c = active_count()
    if c is None:
        return run(*args, **kwargs)
    with c.quiet():
        out = run(*args, **kwargs)
    c.add(*cost())
    return out


# -- program cost catalog --------------------------------------------------
@dataclass
class ProgramCost:
    """One watched program's counted cost (latest built variant;
    ``variants`` counts how many were seen)."""
    name: str
    flops: float
    bytes_accessed: float
    transcendentals: float = 0.0
    argument_bytes: Optional[float] = None
    output_bytes: Optional[float] = None
    temp_bytes: Optional[float] = None
    peak_hbm_bytes: Optional[float] = None
    variants: int = 1
    spec: DeviceSpec = field(default_factory=device_spec)

    @property
    def intensity(self) -> float:
        return (self.flops / self.bytes_accessed
                if self.bytes_accessed > 0 else float("inf"))

    @property
    def klass(self) -> str:
        return roofline_class(self.flops, self.bytes_accessed, self.spec)


class _Counted:
    """One counted call: the count, and the card's peak allocation over
    it (None on the CPU)."""

    def __init__(self, device: Optional[torch.device] = None):
        self.count = CostCount()
        self.device = device
        self.peak: Optional[float] = None

    def __enter__(self) -> "_Counted":
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.count.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.count.__exit__(*exc)
        if self.device is not None and self.device.type == "cuda":
            self.peak = float(torch.cuda.max_memory_allocated(self.device))
        return False

    def cost(self, name: str, spec: DeviceSpec,
             args: Any = None) -> ProgramCost:
        return ProgramCost(
            name=name, flops=float(self.count.flops),
            bytes_accessed=float(self.count.bytes),
            argument_bytes=None if args is None else float(_nbytes(args)),
            peak_hbm_bytes=self.peak, spec=spec)


def counting(device: Optional[torch.device] = None) -> _Counted:
    """Context: count the calls inside (``.cost(name, spec)`` after). On
    a CUDA ``device`` the card's peak memory statistic is reset first and
    read at the end."""
    return _Counted(device)


def _device_of(tree) -> Optional[torch.device]:
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def program_costs(fn: Callable, args: tuple = (),
                  kwargs: Optional[dict] = None, name: Optional[str] = None,
                  spec: Optional[DeviceSpec] = None) -> Dict[str, Any]:
    """Count one call ``fn(*args, **kwargs)`` (it runs: a program that
    writes its arguments writes them) and return the cost as one plain
    dict: flops, bytes_accessed, transcendentals (not counted: 0),
    roofline, argument_bytes and, on the card, peak_hbm_bytes. With
    ``name`` the cost also enters the live catalog. ``spec`` pins the
    roofline knee."""
    sp = spec or device_spec()
    with counting(_device_of((args, kwargs))) as c:
        fn(*args, **(kwargs or {}))
    cost = c.cost(name or "", sp, (args, kwargs))
    if name is not None:
        scope().register_cost(cost)
    out = {"flops": cost.flops, "bytes_accessed": cost.bytes_accessed,
           "transcendentals": 0.0,
           "roofline": roofline_class(cost.flops, cost.bytes_accessed, sp),
           "argument_bytes": cost.argument_bytes}
    if cost.peak_hbm_bytes is not None:
        out["peak_hbm_bytes"] = cost.peak_hbm_bytes
    return out


def tree_bytes(tree: Any) -> int:
    """Total tensor bytes in a nested dict/list/tuple of tensors (the
    ledger's accounting unit)."""
    return int(_nbytes(tree))


def kv_slot_bank_bytes(n_layers: int, n_kv_heads: int, head_dim: int,
                       max_slots: int, max_len: int,
                       itemsize: int) -> int:
    """Bytes the dense serve slot bank RESERVES: k and v of
    (L, max_slots, n_kv_heads, max_len, head_dim) each."""
    return 2 * n_layers * max_slots * n_kv_heads * max_len \
        * head_dim * itemsize


def kv_live_bytes(n_layers: int, n_kv_heads: int, head_dim: int,
                  lengths, itemsize: int) -> int:
    """Bytes live sequence prefixes actually COVER: the per-token KV
    row (k+v across layers/heads) times the summed live lengths. The
    reserved-minus-live gap is the dense bank's waste."""
    per_token = 2 * n_layers * n_kv_heads * head_dim * itemsize
    return int(per_token * int(sum(int(x) for x in lengths)))


# -- HBM ledger ------------------------------------------------------------
class HBMLedger:
    """Per-process device-memory accounting. Entries are keyed
    (category, name) and last-write-wins, so a re-built trainer or a
    restarted engine replaces its own entry instead of double
    counting. Publishes ``hbm_ledger_bytes{category}`` and
    ``hbm_headroom_bytes`` on every change; the first dip below the
    headroom knob leaves an OOM-adjacent flight record with the full
    breakdown (edge-triggered — an OOM post-mortem needs one record,
    not a ring full of them)."""

    def __init__(self, headroom_bytes: Optional[float] = None):
        self._lock = threading.Lock()
        self._table: Dict[Tuple[str, str], int] = {}
        # releases queued by finalizers (release_later), applied at the
        # next call into the ledger
        self._pending: deque = deque()
        self._low_latched = False
        self._capacity: Optional[float] = None
        self._headroom_knob = (_HEADROOM_BYTES if headroom_bytes is None
                               else float(headroom_bytes))

    @property
    def _entries(self) -> Dict[Tuple[str, str], int]:
        """The accounted entries, with queued releases applied."""
        with self._lock:
            drained = self._drain_locked()
        if drained:
            self._publish()
        return self._table

    def _drain_locked(self) -> bool:
        """Apply the queued releases; True when there were any."""
        drained = False
        while self._pending:
            try:
                key = self._pending.popleft()
            except IndexError:
                break
            self._table.pop(key, None)
            drained = True
        return drained

    def account(self, category: str, nbytes: int,
                name: str = "default") -> None:
        with self._lock:
            self._drain_locked()
            self._table[(category, name)] = int(nbytes)
        self._publish()

    def account_tree(self, category: str, tree: Any,
                     name: str = "default") -> None:
        self.account(category, tree_bytes(tree), name=name)

    def release(self, category: str, name: str = "default") -> None:
        with self._lock:
            self._drain_locked()
            self._table.pop((category, name), None)
        self._publish()

    def release_later(self, category: str, name: str = "default") -> None:
        """:meth:`release` for a finalizer. The garbage collector runs a
        weakref callback inside whatever allocation triggered it, on a
        thread that may hold this ledger's or the metrics registry's
        (non-reentrant) lock: releasing there would wait on that lock
        forever. So this only queues the release (a deque append takes
        no lock); the next call into the ledger applies it."""
        self._pending.append((category, name))  # noqa: MXL201 — a finalizer takes no lock; deque.append is atomic

    def breakdown(self) -> Dict[str, int]:
        with self._lock:
            drained = self._drain_locked()
            out: Dict[str, int] = {}
            for (cat, _), n in self._table.items():
                out[cat] = out.get(cat, 0) + n
        if drained:
            # the gauges follow the releases a finalizer queued
            self._publish()
        return out

    def total(self) -> int:
        return sum(self.breakdown().values())

    def capacity(self) -> float:
        """Per-process device-memory budget: the override knob, else the
        card's total memory (``torch.cuda.mem_get_info()``), else the
        spec table's."""
        if self._capacity is None:
            if _HBM_BYTES:
                self._capacity = _HBM_BYTES
            elif torch.cuda.is_available():
                self._capacity = float(torch.cuda.mem_get_info()[1])
            else:
                self._capacity = device_spec().hbm_bytes
        return self._capacity

    def headroom(self) -> float:
        return self.capacity() - self.total()

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
            self._table.clear()
            self._low_latched = False

    def _publish(self) -> None:
        try:
            from . import _metrics, flight as _fl
            m = _metrics()
            per_cat = self.breakdown()
            for cat, n in per_cat.items():
                m.gauge("hbm_ledger_bytes",
                        "Accounted device-resident bytes by category "
                        "(params/optimizer/kv_slot_bank/workspace)",
                        category=cat).set(n)
            head = self.headroom()
            m.gauge("hbm_headroom_bytes",
                    "HBM capacity minus every accounted allocation — "
                    "how close this process is to OOM").set(head)
            with self._lock:
                trip = (self._headroom_knob > 0
                        and head < self._headroom_knob
                        and not self._low_latched)
                if trip:
                    self._low_latched = True
                elif head >= self._headroom_knob:
                    self._low_latched = False
            if trip:
                _fl().record(
                    "perf", "hbm_headroom_low",
                    headroom_bytes=int(head),
                    capacity_bytes=int(self.capacity()),
                    threshold_bytes=int(self._headroom_knob),
                    **{f"bytes_{c}": n for c, n in per_cat.items()})
        except Exception:        # accounting must never break training
            pass


# -- rolling per-program step accounting -----------------------------------
class _Window:
    __slots__ = ("gaps", "ordered", "last_end", "loop", "warned",
                 "handles")

    def __init__(self, maxlen: int):
        self.gaps: deque = deque(maxlen=maxlen)
        # the same gaps kept sorted, so a median is a read, not a sort
        # (this runs on every dispatch)
        self.ordered: List[float] = []
        self.last_end: Optional[float] = None
        self.loop: Optional[str] = None
        self.warned = False
        # the registry children this program's gauges write, made at
        # first use (on every dispatch, interning them again would take
        # the registry lock each time): name -> handle
        self.handles: Dict[str, Any] = {}

    def push(self, gap: float) -> None:
        if len(self.gaps) == self.gaps.maxlen:
            del self.ordered[bisect.bisect_left(self.ordered, self.gaps[0])]
        self.gaps.append(gap)
        bisect.insort(self.ordered, gap)

    def clear(self) -> None:
        self.gaps.clear()
        self.ordered.clear()

    def median(self) -> float:
        """``_median(gaps)``: the upper middle of the sorted window."""
        return self.ordered[len(self.ordered) // 2]


def _pkg():
    """The telemetry package (imported on first use: it imports this
    module)."""
    global _PKG
    if _PKG is None:
        from .. import telemetry as _PKG
    return _PKG


_PKG = None


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2]


def goodput_gauge(loop: str):
    """``mxtpu_goodput_ratio{loop=...}`` — the ONE definition: train,
    elastic, and serve goodput must scrape as one family, not three
    spellings."""
    from . import _metrics
    return _metrics().gauge(
        "goodput_ratio",
        "Useful fraction of wall time by loop (1.0 = every wall "
        "second was a committed step at nominal pace)", loop=loop)


class PerfScope:
    """The per-process attribution engine. The module-level singleton
    (:func:`scope`) is what ``telemetry.watch`` feeds; tests construct
    their own with tighter knobs. All public entry points swallow
    exceptions — perf attribution must never break the loop it
    measures."""

    def __init__(self, window: Optional[int] = None,
                 anomaly_k: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 idle_s: Optional[float] = None,
                 spec: Optional[DeviceSpec] = None):
        self.window = int(window or _WINDOW)
        self.anomaly_k = float(_ANOMALY_K if anomaly_k is None
                               else anomaly_k)
        self.min_samples = int(_MIN_SAMPLES if min_samples is None
                               else min_samples)
        self.idle_s = float(_IDLE_S if idle_s is None else idle_s)
        self._spec = spec
        self.catalog: Dict[str, ProgramCost] = {}
        self._windows: Dict[str, _Window] = {}
        self._loops: Dict[str, str] = {}
        self._published_class: Dict[str, str] = {}
        self.ledger = HBMLedger()
        self._lock = threading.Lock()

    # the knob gate: read per call (tests flip telemetry.enable())
    def _on(self) -> bool:
        return _PERF_ON and _pkg().enabled()

    def spec(self) -> DeviceSpec:
        return self._spec or device_spec()

    # -- catalog ----------------------------------------------------------
    def set_loop(self, program: str, loop: Optional[str]) -> None:
        if loop:
            with self._lock:
                self._loops[program] = loop

    def register_cost(self, cost: ProgramCost) -> None:
        with self._lock:
            prev = self.catalog.get(cost.name)
            if prev is not None:
                cost.variants = prev.variants + 1
            self.catalog[cost.name] = cost
        self._publish_cost(cost)

    def profile_program(self, fn: Callable, name: str, args: tuple = (),
                        kwargs: Optional[dict] = None
                        ) -> Optional[ProgramCost]:
        """Catalog one program by counting one call of it:
        ``fn(*args, **kwargs)`` runs under a :class:`CostCount` (its
        output is discarded; a program that writes its arguments writes
        them). With perfscope off the call does not run and None is
        returned. A failure to count warns once and leaves the program
        uncataloged."""
        if not self._on():
            return None
        try:
            with counting(_device_of((args, kwargs))) as c:
                fn(*args, **(kwargs or {}))
            cost = c.cost(name, self.spec(), (args, kwargs))
            self.register_cost(cost)
            return cost
        except Exception as e:
            w = self._window(name)
            if not w.warned:
                w.warned = True
                _log.warning("perfscope: counting failed for %s (%r) — "
                             "program stays uncataloged", name, e)
            return None

    def _publish_cost(self, cost: ProgramCost) -> None:
        try:
            from . import _metrics
            m = _metrics()
            lbl = {"program": cost.name}
            m.gauge("program_flops",
                    "Counted FLOPs per execution of the program (the "
                    "products, by torch.utils.flop_counter's formulas, "
                    "and the kernels' own counts)", **lbl).set(cost.flops)
            m.gauge("program_bytes_accessed",
                    "Counted bytes accessed per execution (operand and "
                    "result bytes of every op that is not a view)",
                    **lbl).set(cost.bytes_accessed)
            if cost.peak_hbm_bytes is not None:
                m.gauge("program_peak_hbm_bytes",
                        "Peak device memory during one execution "
                        "(torch.cuda.max_memory_allocated)", **lbl).set(
                            cost.peak_hbm_bytes)
            if cost.bytes_accessed > 0:
                m.gauge("program_arithmetic_intensity",
                        "FLOPs per byte accessed — compare against "
                        "the device knee", **lbl).set(cost.intensity)
            klass = cost.klass
            prev = self._published_class.get(cost.name)
            help_ = ("1 for the program's side of the device's "
                     "FLOP/byte knee")
            if prev is not None and prev != klass:
                m.gauge("program_roofline", help_, program=cost.name,
                        **{"class": prev}).set(0)
            m.gauge("program_roofline", help_, program=cost.name,
                    **{"class": klass}).set(1)
            self._published_class[cost.name] = klass
        except Exception:
            pass

    # -- live step accounting ---------------------------------------------
    def _window(self, name: str) -> _Window:
        with self._lock:
            w = self._windows.get(name)
            if w is None:
                w = self._windows[name] = _Window(self.window)
            return w

    def on_call(self, name: str, t_start: float, t_end: float) -> None:
        """One dispatch of a watched program: fold the inter-dispatch
        gap into the rolling window and refresh the program's MFU /
        MBU / goodput gauges + anomaly detector. Called on every
        train/serve step — must stay cheap and never raise."""
        if not self._on():
            return
        try:
            self._on_call(name, t_start, t_end)
        except Exception:
            pass

    def _on_call(self, name: str, t_start: float, t_end: float) -> None:
        w = self._window(name)
        last = w.last_end
        w.last_end = t_end
        if last is None:
            return
        gap = t_end - last
        if gap <= 0:
            return
        if gap > self.idle_s:
            w.clear()               # the loop was parked, not slow
            return
        tm = _pkg()
        m = tm._metrics()
        wall = w.handles.get("wall")
        if wall is None:
            wall = w.handles["wall"] = m.counter(
                "program_wall_ms_total",
                "Wall time attributed to the program's dispatch "
                "loop (sum of inter-dispatch gaps)", program=name)
        wall.inc(gap * 1e3)
        if len(w.gaps) >= self.min_samples:
            med = w.median()
            # floor MAD at 2% of median: a perfectly steady window
            # would otherwise flag microsecond jitter. A gap under the
            # floor's threshold cannot trip whatever the MAD, so the
            # MAD (a pass over the window and a sort) waits for a gap
            # past it
            if gap > med + self.anomaly_k * (0.02 * med) \
                    or self.anomaly_k < 0:
                mad = _median([abs(g - med) for g in w.gaps])
                thresh = med + self.anomaly_k * max(mad, 0.02 * med)
                if gap > thresh:
                    m.counter("step_anomalies_total",
                              "Steps beyond median + k*MAD of the "
                              "program's rolling window",
                              program=name).inc()
                    tm.flight().record(
                        "perf", "step_anomaly", program=name,
                        gap_ms=round(gap * 1e3, 3),
                        median_ms=round(med * 1e3, 3),
                        mad_ms=round(mad * 1e3, 3), k=self.anomaly_k)
                    tm.instant("perf.anomaly", program=name,
                               gap_ms=round(gap * 1e3, 3))
        w.push(gap)
        self._refresh_gauges(name, w, m)

    def _refresh_gauges(self, name: str, w: _Window, m) -> None:
        if not w.gaps:
            return
        mean_gap = sum(w.gaps) / len(w.gaps)
        cost = self.catalog.get(name)
        h = w.handles
        if cost is not None and mean_gap > 0:
            if "mfu" not in h:
                h["mfu"] = m.gauge(
                    "mfu", "Live model-FLOPs utilization over the rolling "
                    "window (catalog flops / mean dispatch gap / device "
                    "peak)", program=name)
                h["mbu"] = m.gauge(
                    "hbm_bw_util", "Live HBM-bandwidth utilization over "
                    "the rolling window (catalog bytes / mean dispatch "
                    "gap / device peak bandwidth)", program=name)
            # the port runs a program on one device: its peak is the
            # device's (the reference multiplies by its mesh size)
            sp = self.spec()
            h["mfu"].set(mfu(cost.flops, mean_gap, peak_flops=sp.peak_flops))
            h["mbu"].set(hbm_bw_util(cost.bytes_accessed, mean_gap,
                                     peak_bw=sp.peak_bw))
        loop = self._loops.get(name)
        if loop:
            med = w.median()
            total = sum(w.gaps)
            if total > 0:
                if h.get("loop") != loop:
                    h["loop"], h["goodput"] = loop, goodput_gauge(loop)
                h["goodput"].set(min(1.0, med * len(w.gaps) / total))

    def restart(self, name: str) -> None:
        """The program's next dispatch starts its window's next gap
        (after a call that is no pacing boundary: the one that built a
        variant under a count)."""
        self._window(name).last_end = None

    # -- lifecycle --------------------------------------------------------
    def reset(self) -> None:
        """Drop rolling windows + ledger entries (test isolation; the
        catalog survives — program costs don't rot)."""
        with self._lock:
            self._windows.clear()
        self.ledger.clear()


# -- module singleton ------------------------------------------------------
_scope: Optional[PerfScope] = None
_scope_lock = threading.Lock()


def scope() -> PerfScope:
    global _scope
    if _scope is None:
        with _scope_lock:
            if _scope is None:
                _scope = PerfScope()
    return _scope


def profile_program(fn: Callable, name: str, args: tuple = (),
                    kwargs: Optional[dict] = None
                    ) -> Optional[ProgramCost]:
    return scope().profile_program(fn, name, args, kwargs)


def on_call(name: str, t_start: float, t_end: float) -> None:
    scope().on_call(name, t_start, t_end)


def catalog() -> Dict[str, ProgramCost]:
    return dict(scope().catalog)


def ledger() -> HBMLedger:
    return scope().ledger


def reset() -> None:
    scope().reset()
