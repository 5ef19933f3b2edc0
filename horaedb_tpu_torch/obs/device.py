"""Device telemetry plane — HBM occupancy, kernel timing, and compile
accounting as first-class observables.

The host-side observability stack (docs/OBSERVABILITY.md) answers *when*
(span trees) and *what it cost* (the query ledger), but the device plane
was dark: nothing reported what HBM is spent on, how long dispatches
actually run on-device, or when a kernel shape is first dispatched. StreamBox-HBM
(PAPERS.md) treats HBM residency as a first-class managed resource, and
"Fine-Tuning Data Structures for Analytical Query Processing" argues
layout/route decisions are only tunable when their cost counters are
first-class — the compressed-storage auto-tuner and incremental-window
eviction (ROADMAP items 2 and 4) read the usage map this module serves.

Four legs:

1. **Occupancy** — a per-(table, column, dtype) residency inventory
   derived from the scan cache's own ``device_bytes`` accounting (the
   sum of its tensors' ``nbytes``, plus session uploads), served as
   ``system.public.device`` with bytes, rows, dtype, last-hit age, and
   eviction counts.
2. **Kernel timing** — ``timed_dispatch(kind, fn, device)`` wraps every
   kernel launch point (the cached packed kernel and the fused direct
   kernel). Timing is SAMPLED (default 1-in-N, ``HORAEDB_DEVICE_SAMPLE``):
   a sampled dispatch is bracketed by a ``torch.cuda.Event`` pair and
   waits on the end event, an unsampled one stays asynchronous. Slow-log
   candidates and EXPLAIN ANALYZE runs are always timed. Results land in
   the ledger (``device_ms``, ``device_dispatches``) and the per-kernel
   ``horaedb_device_dispatch_seconds`` histograms.
3. **First-dispatch accounting** — ``utils/querystats.note_kernel_dispatch``
   routes first-seen static shapes here: a typed ``kernel_compile``
   event (kind, shape, wall ms) lands in the journal and the ledger's
   ``compile_hit`` marks the query that paid it.
4. **Surfaces** — ``system.public.device`` (table_engine/system.py); the
   ``horaedb_device_*`` families ride the metrics registry.

``HORAEDB_DEVICE_TELEMETRY=0`` turns the whole plane off (dispatch
wrappers become bare calls).
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Optional

from ..utils.env import env_float, env_int
from ..utils.metrics import REGISTRY

# Every device-dispatch point declares its kernel kind here — the label
# set of the horaedb_device_* families (eagerly registered, lint-pinned
# like SEGMENT_KERNEL_LABELS / RAW_SCAN_PATHS).
DEVICE_KERNEL_KINDS = (
    "cached_packed",   # packed cached agg over the resident columns
    "fused",           # direct fused scan-agg over a host batch
)

# Occupancy row components: "column" rows sum to the scan cache's own
# device_bytes accounting (the acceptance invariant); "session" rows
# are the content-keyed query-shape uploads the cache keeps beside the
# columns; "evicted" rows carry eviction counts
# for tables no longer resident.
OCCUPANCY_COMPONENTS = ("column", "session", "evicted")
# the components with a resident-bytes gauge
_GAUGED = ("column", "session")

# Registry discipline (lint-enforced like the agg-kernel/raw families):
# declared here, registered eagerly, documented in docs/OBSERVABILITY.md,
# and no stray horaedb_device_* family may exist outside this tuple.
DEVICE_METRIC_FAMILIES = (
    "horaedb_device_dispatch_total",
    "horaedb_device_dispatch_seconds",
    "horaedb_device_compile_total",
    "horaedb_device_compile_seconds",
    "horaedb_device_resident_bytes",
    "horaedb_device_evictions_total",
)

# Device dispatches are sub-ms..s on real chips; the default bucket
# ladder starts at 1ms and would fold the whole fast path into one
# bucket.
_DISPATCH_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
)

_M_DISPATCH = {
    k: REGISTRY.counter(
        "horaedb_device_dispatch_total",
        "device kernel dispatches, by kernel kind",
        labels={"kernel": k},
    )
    for k in DEVICE_KERNEL_KINDS
}
_M_DISPATCH_SECONDS = {
    k: REGISTRY.histogram(
        "horaedb_device_dispatch_seconds",
        "sampled on-device dispatch seconds",
        buckets=_DISPATCH_BUCKETS,
        labels={"kernel": k},
    )
    for k in DEVICE_KERNEL_KINDS
}
_M_COMPILE_SECONDS = {
    k: REGISTRY.histogram(
        "horaedb_device_compile_seconds",
        "wall seconds of first-time kernel dispatches, by kernel kind",
        labels={"kernel": k},
    )
    for k in DEVICE_KERNEL_KINDS
}
_M_COMPILE = {
    (k, outcome): REGISTRY.counter(
        "horaedb_device_compile_total",
        "compile-cache outcomes per device dispatch shape, by kernel kind",
        labels={"kernel": k, "outcome": outcome},
    )
    for k in DEVICE_KERNEL_KINDS
    for outcome in ("compile", "hit")
}
_M_RESIDENT = {
    c: REGISTRY.gauge(
        "horaedb_device_resident_bytes",
        "HBM-resident bytes by component (scan-cache columns/sessions)",
        labels={"component": c},
    )
    for c in _GAUGED
}
_M_EVICTIONS = REGISTRY.counter(
    "horaedb_device_evictions_total",
    "scan-cache entries evicted under the HBM byte/entry budget",
)


# ---- knobs -----------------------------------------------------------------


def device_telemetry_enabled() -> bool:
    """HORAEDB_DEVICE_TELEMETRY=0 turns the plane off entirely (the
    dispatch wrappers become bare calls — the bench A/B's off arm)."""
    import os

    return os.environ.get("HORAEDB_DEVICE_TELEMETRY", "1") != "0"


def sample_every() -> int:
    """Time 1 in N dispatches (HORAEDB_DEVICE_SAMPLE, default 8; <=1
    times every dispatch). Sampling exists so the async dispatch
    pipeline is not serialized: a timed dispatch blocks until the device
    answers, an untimed one overlaps host work as before."""
    return max(1, env_int("HORAEDB_DEVICE_SAMPLE", 8))


# The proxy's live slow-log threshold overrides the env default (see
# set_slow_candidate_s): a query that will be slow-logged must carry a
# device_ms whatever threshold the operator dialed in at runtime.
_slow_override: Optional[float] = None


def set_slow_candidate_s(seconds: float) -> None:
    """Couple the always-time threshold to the slow-log threshold — the
    proxy calls this whenever ``slow_threshold_s`` changes (init and the
    PUT /debug/slow_threshold endpoint), so a slow-logged query's
    dispatches are always timed. Process-global like the slow log's
    candidate set itself; with several proxies the last setter wins."""
    global _slow_override
    _slow_override = max(0.0, float(seconds))


def _slow_candidate_s() -> float:
    """Queries already slower than this are timed ALWAYS — their
    slow-log row must say where the time went. The MIN of the env knob
    (HORAEDB_DEVICE_SLOW_MS, default 1s) and the proxy's live slow-log
    threshold: min, not override, so the documented knob keeps working
    in server deployments (Proxy.__init__ sets the override at
    construction) and a lowered threshold from either side only ever
    times MORE, never less."""
    env_s = env_float("HORAEDB_DEVICE_SLOW_MS", 1000.0) / 1000.0
    if _slow_override is not None:
        return min(_slow_override, env_s)
    return env_s


# ---- kernel timing ---------------------------------------------------------

# per-kind dispatch counters driving the 1-in-N sample choice (first
# dispatch of each kind is always sampled — compiles mostly get timed)
_sample_counts: dict[str, int] = {}
_sample_lock = threading.Lock()


def _should_time(kind: str) -> bool:
    from ..utils.querystats import current_ledger

    ledger = current_ledger()
    if ledger is not None:
        # slow-log candidate: the query has already blown the slow
        # threshold — its diagnosis needs the device number
        if time.time() - ledger.started_at >= _slow_candidate_s():
            return True
        # EXPLAIN ANALYZE is a diagnostic run: always time it so the
        # rendered ledger carries device_ms (serializing it is fine)
        if ledger.sql.lstrip()[:7].lower() == "explain":
            return True
    n = sample_every()
    if n <= 1:
        return True
    with _sample_lock:
        c = _sample_counts.get(kind, 0)
        _sample_counts[kind] = c + 1
    return c % n == 0


def timed_dispatch(kind: str, fn: Callable[[], Any], device=None) -> Any:
    """Run one device dispatch with sampled timing; returns ``fn()``'s
    result unchanged.

    Always (cheap): bumps ``horaedb_device_dispatch_total{kernel=}`` and
    the ledger's ``device_dispatches``. Sampled: on a CUDA ``device`` a
    ``torch.cuda.Event`` pair brackets the launch and the host waits on
    the end event, so the number is the card's own time; on the CPU the
    host clock times the call. Observes the per-kernel dispatch
    histogram and adds the milliseconds to the ledger's ``device_ms``.
    Telemetry off: a bare call."""
    if not device_telemetry_enabled():
        return fn()
    from ..utils import querystats

    timed = _should_time(kind)
    events = None
    if timed and device is not None and device.type == "cuda":
        import torch

        events = (
            torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True),
        )
        events[0].record()
    t0 = time.perf_counter()
    out = fn()
    counter = _M_DISPATCH.get(kind)
    if counter is None:  # undeclared kind: account it, lint will flag
        counter = REGISTRY.counter(
            "horaedb_device_dispatch_total",
            "device kernel dispatches, by kernel kind",
            labels={"kernel": kind},
        )
    counter.inc()
    querystats.record(device_dispatches=1)
    if timed:
        if events is not None:
            events[1].record()
            events[1].synchronize()
            dt = events[0].elapsed_time(events[1]) / 1000.0
        else:
            dt = time.perf_counter() - t0
        hist = _M_DISPATCH_SECONDS.get(kind)
        if hist is None:
            hist = REGISTRY.histogram(
                "horaedb_device_dispatch_seconds",
                "sampled on-device dispatch seconds",
                buckets=_DISPATCH_BUCKETS,
                labels={"kernel": kind},
            )
        hist.observe(dt)
        querystats.record(device_ms=dt * 1000.0)
    return out


# ---- compile accounting ----------------------------------------------------


def _shape_of(key) -> str:
    """Compact printable rendering of a static kernel key — the "shape
    bucket" a compile event names (keys are tuples of ints/strings/op
    tuples; padding already bucketed them to powers of two)."""
    s = repr(key)
    return s if len(s) <= 200 else s[:197] + "..."


def note_compile(kind: str, key, wall_s: float,
                 cost: Optional[dict] = None) -> None:
    """A never-seen static shape's first dispatch: journal the typed
    ``kernel_compile`` event (trace-linked, so EXPLAIN ANALYZE and the
    slow log can attribute the stall), tick the per-kernel compile
    histogram + counter, and mark the paying query's ledger
    (``compile_hit``). ``wall_s`` is the first call's wall time — the
    honest upper bound on the first-use cost. ``cost`` optionally carries
    ``cost_analysis`` flops/bytes (see ``cost_analysis``)."""
    if not device_telemetry_enabled():
        return
    from ..utils import querystats

    hist = _M_COMPILE_SECONDS.get(kind)
    if hist is not None:
        hist.observe(wall_s)
    counter = _M_COMPILE.get((kind, "compile"))
    if counter is not None:
        counter.inc()
    querystats.record(compile_hit=1)
    from ..utils.events import record_event

    # NB record_event's own ``kind`` arg collides (the rule_kind
    # precedent): the kernel kind ships as ``kernel``.
    attrs: dict = {
        "kernel": kind,
        "shape": _shape_of(key),
        "wall_ms": round(wall_s * 1000.0, 3),
    }
    if cost:
        attrs.update({k: v for k, v in cost.items() if v is not None})
    record_event("kernel_compile", **attrs)


def note_compile_cache_hit(kind: str) -> None:
    """A seen shape dispatched again: the compile cache served it."""
    if not device_telemetry_enabled():
        return
    counter = _M_COMPILE.get((kind, "hit"))
    if counter is not None:
        counter.inc()


def cost_analysis(fn=None, args=(), kwargs=None) -> Optional[dict]:
    """XLA's ``cost_analysis`` has no counterpart for a hand-written
    kernel: compile events carry kind, shape and wall time only."""
    return None


def compile_stats() -> dict:
    """Per-kernel compile/hit counts — the /debug/device compile block."""
    out = {}
    for kind in DEVICE_KERNEL_KINDS:
        compiles = _M_COMPILE[(kind, "compile")].value
        hits = _M_COMPILE[(kind, "hit")].value
        if compiles or hits:
            out[kind] = {"compiles": int(compiles), "hits": int(hits)}
    return out


def note_eviction(n: int = 1) -> None:
    """The scan cache evicted ``n`` entries under its HBM budget."""
    _M_EVICTIONS.inc(n)


# ---- HBM occupancy ---------------------------------------------------------

# Occupancy providers: anything holding device-resident state registers
# ITSELF (held weakly — a closed executor's cache drops out) and must
# expose ``snapshot_device() -> list[dict]`` (rows with table_name /
# column_name / component / dtype / bytes / rows / last_hit_age_ms /
# evictions). The scan cache registers at construction; the ROADMAP
# item-2 window state and item-4 encoded layouts plug in here.
_PROVIDERS: "weakref.WeakSet" = weakref.WeakSet()


def register_occupancy_provider(owner) -> None:
    """Track ``owner`` (weakly) as a device-residency source; it must
    expose ``snapshot_device() -> list[dict]``."""
    _PROVIDERS.add(owner)


def unregister_occupancy_provider(owner) -> None:
    """Drop ``owner`` from the inventory immediately — Connection.close
    calls this so a closed database's cache stops contributing rows the
    moment it closes instead of whenever GC collects it (the inventory
    is process-wide by design, like system.public.workload, but it must
    only merge LIVE sources). The gauges refresh forcibly afterwards:
    a close is a residency mutation like any eviction, and a parked
    gauge would report the freed bytes until the next cache serve."""
    _PROVIDERS.discard(owner)
    refresh_occupancy(force=True)


def _component_sums(rows: list[dict]) -> dict:
    """Byte totals per gauge component — THE one summing loop (the
    gauges, /debug/device totals, and the refresh fallback all use it;
    a new OCCUPANCY_COMPONENT lands in one place)."""
    sums = {c: 0 for c in _GAUGED}
    for r in rows:
        c = r.get("component")
        if c in sums:
            sums[c] += int(r.get("bytes", 0))
    return sums


def device_inventory() -> list[dict]:
    """The full per-(table, column, dtype) residency inventory across
    every registered provider, with the resident-bytes gauges refreshed
    from what was just walked (so scrapes stay honest between queries)."""
    rows: list[dict] = []
    for p in list(_PROVIDERS):
        try:
            rows.extend(p.snapshot_device())
        except Exception:
            continue  # one sick provider must not dark the whole plane
    for c, v in _component_sums(rows).items():
        _M_RESIDENT[c].set(float(v))
    return rows


_last_refresh = 0.0


def refresh_occupancy(force: bool = False) -> None:
    """Recompute the resident-bytes gauges — the scan cache calls this
    after serving/mutations so the self-monitoring recorder scrapes
    fresh values. HOT-PATH cheap: providers exposing
    ``occupancy_bytes()`` are summed without materializing inventory
    rows, and un-forced refreshes are throttled to ~1/s (the recorder
    scrapes at 10s; per-query precision lives in the inventory reads,
    which always recompute live). Mutations that can be the LAST touch
    for a while (build, eviction, invalidate, bf16 drop) pass
    ``force=True`` so the throttle can never park a gauge on freed
    bytes forever."""
    global _last_refresh
    if not device_telemetry_enabled():
        return
    now = time.monotonic()
    if not force and now - _last_refresh < 1.0:
        return
    _last_refresh = now
    sums = {c: 0 for c in _GAUGED}
    for p in list(_PROVIDERS):
        try:
            fast = getattr(p, "occupancy_bytes", None)
            per = fast() if fast is not None else _component_sums(
                p.snapshot_device()
            )
            for c, v in per.items():
                if c in sums:
                    sums[c] += int(v)
        except Exception:
            continue
    for c, g in _M_RESIDENT.items():
        g.set(float(sums[c]))


def occupancy_totals(rows: Optional[list[dict]] = None) -> dict:
    """Byte totals by component plus the grand total — the /debug/device
    summary block (``column`` is the scan cache's device_bytes truth)."""
    if rows is None:
        rows = device_inventory()
    out = _component_sums(rows)
    out["total"] = sum(out.values())
    return out
