"""Per-query resource accounting — the cost ledger beside the span tree
(ref: trace_metric's per-operator cost counters; Fine-Tuning Data
Structures for Analytical Query Processing argues route/layout decisions
are only tunable when per-operator cost counters are first-class).

A ``QueryLedger`` rides a ContextVar next to the request trace: the proxy
opens one per SQL statement, every stage the request touches adds its
costs (rows scanned, SSTs pruned vs read, object-store bytes, scan-cache
hits, kernel compiles, remote RPCs, ...), and finalization feeds three
sinks at once:

- the bounded ``STATS_STORE`` ring, served as the SQL-queryable virtual
  table ``system.public.query_stats`` (joinable on request_id);
- the ``horaedb_query_*`` Prometheus families (one counter per ledger
  field, plus ``horaedb_query_route_total{route=...}``);
- EXPLAIN ANALYZE and the slow-query log, which render the ledger
  inline with the span tree.

Cross-node: partition owners account their share in a detached serving
ledger (``serving_ledger``) and ship it home in the RPC response's
``ledger`` field; the remote client merges it into the coordinator's
ledger (``merge_remote``), so the coordinator's row is the CLUSTER-wide
cost of the query. Everything is a cheap no-op outside a request
(background flush/compaction pays one ContextVar read).

Field registry discipline: ``NUMERIC_FIELDS`` is the single source of
truth — the query_stats schema, the metric families, and the docs lint
all derive from (or are checked against) it, so a new field cannot land
without a column, a metric, and documentation.
"""

from __future__ import annotations

import contextvars
import threading
import time
from typing import Any, Optional

from .metrics import REGISTRY

# ---- field registry -------------------------------------------------------

# field -> one-line meaning (becomes metric HELP and the docs table).
# Names must keep the metrics lint happy once prefixed/suffixed into
# ``horaedb_query_<field>_total``.
NUMERIC_FIELDS: dict[str, str] = {
    "scan_rows": "rows materialized by storage scans for the query",
    "memtable_rows": "rows of those served from memtables",
    "sst_read": "SST files opened by the query's scans",
    "sst_pruned": "SST files skipped by time-range pruning",
    "store_read_bytes": "object-store bytes fetched (compressed row groups)",
    "cache_hits": "scan-cache (HBM) hits serving the query",
    "cache_misses": "scan-cache misses/bypasses on eligible paths",
    "cache_bytes": "device-resident bytes the cache served from",
    "jit_compiles": "kernel shapes compiled for the first time",
    "jit_cache_hits": "kernel dispatches served by the compile cache",
    "fanout": "partition fan-out width (scattered sub-queries)",
    "remote_rpcs": "remote-engine RPCs issued",
    "remote_bytes": "request+response bytes over the remote engine",
    "retries": "stale-route retries during execution",
    # workload-management roles (wlm/dedup): single-flight reads record
    # which side of the coalescing they were on
    "dedup_followers": "identical in-flight twins this leader execution served",
    "dedup_follower": "1 when this query awaited an identical in-flight leader",
    # cohort batching (wlm/batch): shape-identical in-flight queries
    # served by one fused device dispatch record which side of the
    # cohort they were on, and how wide it was
    "batch_leader": "cohort size when this query led a fused cohort dispatch",
    "batch_member": "1 when this query was served by a cohort leader's fused dispatch",
    "batch_cohort": "fused cohort size for batch-served queries (leader and members)",
    # kernel-routing feedback: how many (group x bucket) cells the device
    # aggregation actually produced — the cardinality truth the kernel
    # router seeds from on the next sighting of the shape
    "agg_segments": "live segment cells the device aggregation produced",
    # raw (non-aggregate) device reads: result rows the fused
    # filter+top-k/selection path returned (0 for host-served raw reads)
    "raw_rows_returned": "rows the device raw-read path returned",
    # replicated follower reads (route=follower): how far the serving
    # follower's freshness watermark trailed "now" at serve time
    "replica_lag_ms": "follower watermark lag (ms) on replica-served reads",
    # deadline propagation / cooperative cancellation (utils/deadline):
    # the budget the request carried and how it ended
    "deadline_ms": "time budget (ms) the request carried at ingress (0 = unbounded)",
    "timed_out": "1 when the query died to its deadline (DeadlineExceeded)",
    "cancelled": "1 when the query was cooperatively cancelled (KILL/disconnect)",
    # device telemetry plane (obs/device): how much device work the
    # query issued and whether it paid a compile stall
    "device_dispatches": "device kernel dispatches the query issued",
    "compile_hit": "device dispatches that paid a first-time kernel build (stall marker)",
    # live window state (state/livewindow, route=livewindow): how many
    # ring buckets the state-served tail of the query read
    "state_buckets": "device ring buckets served from live window state",
}

# wall-time costs; seconds, float.
FLOAT_FIELDS: dict[str, str] = {
    "jit_compile_seconds": "wall seconds spent compiling new kernel shapes",
    "admission_wait_seconds": "wall seconds waiting for an admission slot",
    # sampled on-device dispatch wall (obs/device timed_dispatch):
    # milliseconds for render friendliness — tiny kernels are sub-ms
    "device_ms": "sampled on-device dispatch wall milliseconds (block_until_ready timing)",
}

LEDGER_FIELDS: dict[str, str] = {**NUMERIC_FIELDS, **FLOAT_FIELDS}


def metric_name(field: str) -> str:
    """The Prometheus family a ledger field feeds at finalization."""
    return f"horaedb_query_{field}_total"


# Eager registration: the families exist from the first scrape (and the
# registry lint sees them) even before any query finalizes.
_FIELD_COUNTERS = {
    field: REGISTRY.counter(metric_name(field), help_)
    for field, help_ in LEDGER_FIELDS.items()
}


def _route_counter(route: str):
    return REGISTRY.counter(
        "horaedb_query_route_total",
        "queries by executor route (which of the six paths ran)",
        labels={"route": route},
    )


# ---- aggregation-kernel accounting ----------------------------------------

# Which segment-reduction impl served a device aggregation (the learned
# kernel router's choice, or the static heuristic's). "single" is the
# n_seg == 1 pure-reduction shape; "host" the tiny-input hash fallback.
SEGMENT_KERNEL_LABELS = ("shared", "scatter", "single")

# Registry discipline (lint-enforced like the admission/flush families):
# declared here, registered eagerly, documented in docs/OBSERVABILITY.md,
# and no stray horaedb_agg_* family may exist outside this tuple.
AGG_KERNEL_METRIC_FAMILIES = ("horaedb_agg_kernel_total",)

_AGG_KERNEL_COUNTERS = {
    k: REGISTRY.counter(
        "horaedb_agg_kernel_total",
        "device aggregation dispatches by segment-reduction kernel",
        labels={"kernel": k},
    )
    for k in SEGMENT_KERNEL_LABELS
}


# ---- raw-read accounting ---------------------------------------------------

# Which serving shape a raw (non-aggregate) read took. "topk"/"select"
# are the device kernels ("_dist" variants when the entry is sharded
# over the mesh), "host" an ELIGIBLE query deliberately routed to the
# host path (router choice, kill switch, selectivity over budget), and
# "fallback" a device attempt the cache or eligibility checks bounced.
RAW_SCAN_PATHS = (
    "topk", "select", "topk_dist", "select_dist", "host", "fallback",
)

# Registry discipline (lint-enforced like the agg-kernel family):
# declared here, registered eagerly, documented in docs/OBSERVABILITY.md,
# and no stray horaedb_raw_* family may exist outside this tuple.
RAW_SCAN_METRIC_FAMILIES = ("horaedb_raw_scan_total",)

_RAW_SCAN_COUNTERS = {
    p: REGISTRY.counter(
        "horaedb_raw_scan_total",
        "raw (non-aggregate) reads by serving path",
        labels={"path": p},
    )
    for p in RAW_SCAN_PATHS
}


def note_raw_scan(path: str, kernel: str = "", rows=None) -> None:
    """Account one raw read: bump the per-path family and — on the
    device paths — stamp the ledger's ``kernel`` field and the
    ``raw_rows_returned`` count, so ``system.public.query_stats`` covers
    raw serving on every wire."""
    counter = _RAW_SCAN_COUNTERS.get(path)
    if counter is not None:
        counter.inc()
    ledger = _current_ledger.get()
    if ledger is not None:
        if kernel:
            ledger.set_kernel(kernel)
        if rows is not None:
            ledger.add(raw_rows_returned=rows)


def note_agg_kernel(kernel: str, segments: int = 0) -> None:
    """Account one aggregation dispatch: bump the per-kernel family,
    stamp the ledger's ``kernel`` field, and record the live segment
    count the kernel router learns cardinality from."""
    counter = _AGG_KERNEL_COUNTERS.get(kernel)
    if counter is not None:
        counter.inc()
    ledger = _current_ledger.get()
    if ledger is not None:
        ledger.set_kernel(kernel)
        if segments:
            ledger.add(agg_segments=segments)


# ---- ledger ---------------------------------------------------------------


class QueryLedger:
    """One request's accumulating cost counters. Thread-safe: the scatter
    pool and gRPC client callbacks add from several threads at once."""

    __slots__ = ("request_id", "sql", "route", "kernel", "table_name",
                 "counts", "started_at", "_lock")

    def __init__(self, request_id=None, sql: str = "") -> None:
        self.request_id = request_id
        self.sql = sql
        self.route = ""  # last executor path taken (one of the six)
        self.kernel = ""  # last segment-reduction impl dispatched
        # primary table the statement targeted — the elastic control
        # loop's load signal (meta/elastic reads per-table query counts
        # from system.public.query_stats over the distributed read path)
        self.table_name = ""
        self.counts: dict[str, float] = dict.fromkeys(LEDGER_FIELDS, 0)
        self.started_at = time.time()
        self._lock = threading.Lock()

    def add(self, **fields: float) -> None:
        with self._lock:
            for k, v in fields.items():
                if k in self.counts:
                    self.counts[k] += v

    def set_route(self, route: str) -> None:
        self.route = route

    def set_kernel(self, kernel: str) -> None:
        self.kernel = kernel

    def set_table(self, table: Optional[str]) -> None:
        if table:
            self.table_name = table

    def merge_remote(self, remote: Optional[dict]) -> None:
        """Fold a partition owner's shipped ledger into this one (numeric
        fields only — the owner's route is a sub-plan detail)."""
        if not isinstance(remote, dict):
            return
        counts = remote.get("counts")
        if not isinstance(counts, dict):
            return
        if not self.kernel and isinstance(remote.get("kernel"), str):
            # partition owners ran the kernels; the coordinator did not
            self.kernel = remote["kernel"]
        with self._lock:
            for k, v in counts.items():
                if k in self.counts and isinstance(v, (int, float)):
                    self.counts[k] += v

    def to_dict(self) -> dict:
        with self._lock:
            counts = dict(self.counts)
        return {"route": self.route, "kernel": self.kernel, "counts": counts}

    def nonzero(self) -> dict[str, float]:
        """Fields with activity — what EXPLAIN ANALYZE / slow log print."""
        with self._lock:
            return {k: v for k, v in self.counts.items() if v}


_current_ledger: contextvars.ContextVar[Optional[QueryLedger]] = (
    contextvars.ContextVar("horaedb_query_ledger", default=None)
)


def current_ledger() -> Optional[QueryLedger]:
    return _current_ledger.get()


def record(**fields: float) -> None:
    """Add costs to the current request's ledger (no-op outside one)."""
    ledger = _current_ledger.get()
    if ledger is not None:
        ledger.add(**fields)


def set_route(route: str) -> None:
    ledger = _current_ledger.get()
    if ledger is not None:
        ledger.set_route(route)


def merge_remote(remote: Optional[dict]) -> None:
    """Fold a remote owner's response ledger into the current one."""
    ledger = _current_ledger.get()
    if ledger is not None:
        ledger.merge_remote(remote)


def start_ledger(request_id=None, sql: str = "") -> tuple[QueryLedger, Any]:
    """Open a ledger in the current context; pass the handle (and the
    ledger) to ``finish_ledger``."""
    ledger = QueryLedger(request_id, sql)
    token = _current_ledger.set(ledger)
    return ledger, token


def finish_ledger(ledger: QueryLedger, token, duration_s: float,
                  record_stats: bool = True) -> None:
    """Close the request's ledger: reset the ContextVar and (by default)
    record the row in STATS_STORE + feed the horaedb_query_* families."""
    _current_ledger.reset(token)
    if not record_stats:
        return
    snapshot = {
        "timestamp": int(time.time() * 1000),
        "request_id": ledger.request_id,
        "sql": ledger.sql[:200],
        "route": ledger.route,
        "kernel": ledger.kernel,
        "table_name": ledger.table_name,
        "duration_ms": round(duration_s * 1000, 3),
        **ledger.counts,
    }
    STATS_STORE.record(snapshot)
    if ledger.route:
        _route_counter(ledger.route).inc()
    for field, counter in _FIELD_COUNTERS.items():
        v = ledger.counts.get(field, 0)
        if v:
            counter.inc(v)


class _ServingLedger:
    """Context manager serving an RPC under a detached ledger: the owner's
    costs ship home in the response (``wire`` attribute) instead of
    landing in this node's query_stats ring — the coordinator's merged
    row is the one source of per-query truth."""

    def __init__(self, request_id=None) -> None:
        self.request_id = request_id
        self.ledger: Optional[QueryLedger] = None
        self._token = None

    def __enter__(self) -> QueryLedger:
        self.ledger, self._token = start_ledger(self.request_id)
        return self.ledger

    def __exit__(self, *exc) -> None:
        finish_ledger(self.ledger, self._token, 0.0, record_stats=False)

    @property
    def wire(self) -> dict:
        return self.ledger.to_dict()


def serving_ledger(request_id=None) -> _ServingLedger:
    return _ServingLedger(request_id)


# ---- kernel compile-cache accounting --------------------------------------

# Static kernel shapes seen by THIS process. First dispatch of a shape
# pays one-time costs (the kernel build); the wall time of that first call is an honest
# upper bound on the compile cost and is what operators need to explain a
# latency cliff ("this query shape compiled").
_seen_kernel_keys: set = set()
_kernel_lock = threading.Lock()


def note_kernel_dispatch(key, elapsed_s: float, kind: str = "",
                         cost_fn=None) -> None:
    """Account one device-kernel dispatch: a never-seen static ``key``
    counts as a compile (with its wall seconds); a seen one as a
    compile-cache hit.

    ``kind`` (a DEVICE_KERNEL_KINDS label) routes the outcome into the
    device telemetry plane too: a first sighting journals a typed
    ``kernel_compile`` event and marks the ledger's ``compile_hit``; a
    repeat ticks the per-kernel compile-cache-hit counter. ``cost_fn``
    (only called on a compile) may return an XLA cost_analysis dict to
    ride the event (obs/device.cost_analysis)."""
    with _kernel_lock:
        first = key not in _seen_kernel_keys
        if first:
            _seen_kernel_keys.add(key)
    if first:
        record(jit_compiles=1, jit_compile_seconds=elapsed_s)
        if kind:
            from ..obs.device import note_compile

            cost = None
            if cost_fn is not None:
                try:
                    cost = cost_fn()
                except Exception:
                    cost = None
            note_compile(kind, key, elapsed_s, cost)
    else:
        record(jit_cache_hits=1)
        if kind:
            from ..obs.device import note_compile_cache_hit

            note_compile_cache_hit(kind)


# ---- stats store ----------------------------------------------------------


class StatsStore:
    """Bounded ring of finalized per-query ledgers — the rows behind
    ``system.public.query_stats``. Snapshots (plain dicts), so readers
    never race a live request."""

    def __init__(self, maxlen: int = 256) -> None:
        from collections import deque

        self._ring: "deque[dict]" = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def record(self, snapshot: dict) -> None:
        with self._lock:
            self._ring.append(snapshot)

    def list(self) -> list[dict]:
        """Oldest-first snapshot of the ring."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


STATS_STORE = StatsStore()


def render_ledger(ledger: QueryLedger) -> str:
    """One-line rendering for EXPLAIN ANALYZE / logs: route plus every
    nonzero cost field."""
    parts = []
    if ledger.route:
        parts.append(f"route={ledger.route}")
    if ledger.kernel:
        parts.append(f"kernel={ledger.kernel}")
    for k, v in ledger.nonzero().items():
        if isinstance(v, float) and not v.is_integer():
            parts.append(f"{k}={v:.4f}")
        else:
            parts.append(f"{k}={int(v)}")
    return " ".join(parts) if parts else "(no costs recorded)"
