"""Continuous profile plane — fleetwide wall-clock attribution from the
database's own span trees.

The node could already show ONE trace (`utils/tracectx` span trees at
/debug/trace, a ring of 64); this module answers the question a single
trace cannot: *where does the wall-clock actually go, by stage and by
shape, over time?* Every ``finish_trace`` folds its finished tree into
the process-global streaming ``PROFILE`` aggregator — no sampling
daemon, no second timing source: the profile is derived from the exact
spans EXPLAIN ANALYZE and the slow log already show, so the two can
never disagree ("Fine-Tuning Data Structures for Analytical Query
Processing": tune from the *observed* mix, which first requires
measuring it).

Keying: ``(path, route, shape)`` where ``path`` is the slash-joined
span chain from the root (``sql/execute/dispatch``), ``route`` the
serving plane (query/ingest/ddl/flush/compaction/rules), and ``shape``
the normalized plan key class (literal-masked SQL for queries, the
target table for ingest). Each key holds count, total (inclusive) and
exclusive milliseconds, an EWMA plus fast/slow running-sum windows
(the incremental-window discipline), and a last-exemplar
``trace_id`` linking back to ``/debug/trace/{id}``.

Accounting contract (the hard invariant the tests reconcile): per
folded trace

    ``root_ms == Σ non-root exclusive_ms + untracked_ms``

where a span's exclusive time is its duration minus its direct
children's, SIGNED — parallel children that overlap their parent drive
exclusive negative rather than silently clipping — and ``untracked``
(the root's own uncovered time) is a first-class row at
``<root>/(untracked)``, never absorbed. A large untracked fraction IS
the signal a plane lacks span coverage. LRU eviction under the
``[observability] profile_keys`` bound is exactly accounted: evicted
counts/totals accumulate so live rows + evicted totals always equal a
naive refold of every trace ever folded.

Surfaces: ``system.public.profile`` on all three wires,
``/debug/profile?path=&route=``, ``horaectl profile``, the EXPLAIN
ANALYZE ``Critical path:`` line, and the ``horaedb_profile_*``
families below (eagerly registered, lint-pinned). ``HORAEDB_PROFILE=0``
kills the whole plane (fold returns immediately — the bench A/B's off
arm).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Optional

from ..utils.metrics import REGISTRY

# ---- registry discipline (lint-enforced, docs-pinned) ---------------------

PROFILE_METRIC_FAMILIES = (
    "horaedb_profile_traces_total",
    "horaedb_profile_spans_total",
    "horaedb_profile_dropped_total",
    "horaedb_profile_root_ms_total",
    "horaedb_profile_untracked_ms_total",
    "horaedb_profile_untracked_ratio",
)

_M_TRACES = REGISTRY.counter(
    "horaedb_profile_traces_total",
    "finished traces folded into the profile aggregator",
)
_M_SPANS = REGISTRY.counter(
    "horaedb_profile_spans_total",
    "span rows folded into the profile aggregator",
)
_M_DROPPED = REGISTRY.counter(
    "horaedb_profile_dropped_total",
    "profile keys LRU-evicted under the profile_keys bound",
)
_M_ROOT_MS = REGISTRY.counter(
    "horaedb_profile_root_ms_total",
    "root wall milliseconds folded (the denominator of coverage)",
)
_M_UNTRACKED_MS = REGISTRY.counter(
    "horaedb_profile_untracked_ms_total",
    "root milliseconds no child span covered (clipped at 0)",
)
_M_UNTRACKED_RATIO = REGISTRY.gauge(
    "horaedb_profile_untracked_ratio",
    "EWMA fraction of root wall time no child span covered",
)


def profile_enabled() -> bool:
    """HORAEDB_PROFILE=0 turns the whole plane off — fold is a cheap
    env-read no-op (the bench A/B's off arm). Read per call, not cached:
    the kill switch must take effect immediately."""
    try:
        return os.environ["HORAEDB_PROFILE"] not in ("0", "off", "false")
    except KeyError:
        return True


# ---- incremental windows (the running-sum discipline) ------------


class _MsWindow:
    """Running-sum sliding window over ms observations, bucketed into a
    ring of ``_NB`` time slices: push is a strict O(1) — bucket index,
    two list adds — with NO per-observation storage (a deque of every
    observation made the fold the hot path's hot path; the profile plane
    runs on every finished trace, so its own cost is the first thing the
    overhead gate would flag). Eviction granularity is span/``_NB``:
    the mean covers [span, span + span/_NB) seconds of history, the same
    coarsening the metrics scrape already accepts."""

    _NB = 8

    __slots__ = ("span_s", "_bucket_s", "_sums", "_ns", "_sum", "_n",
                 "_epoch")

    def __init__(self, span_s: float) -> None:
        self.span_s = span_s
        self._bucket_s = span_s / self._NB
        self._sums = [0.0] * self._NB
        self._ns = [0] * self._NB
        self._sum = 0.0
        self._n = 0
        self._epoch = -1  # absolute bucket index of the newest slice

    def _advance(self, b: int) -> None:
        """Rotate the ring forward to absolute bucket ``b``, evicting
        the slices that fell out of the span."""
        if b <= self._epoch:
            return
        if self._epoch < 0 or b - self._epoch >= self._NB:
            # first push, or a gap longer than the whole window
            self._sums = [0.0] * self._NB
            self._ns = [0] * self._NB
            self._sum = 0.0
            self._n = 0
        else:
            for e in range(self._epoch + 1, b + 1):
                i = e % self._NB
                self._sum -= self._sums[i]
                self._n -= self._ns[i]
                self._sums[i] = 0.0
                self._ns[i] = 0
        self._epoch = b

    def push(self, now: float, ms: float) -> None:
        b = int(now / self._bucket_s)
        if b != self._epoch:
            self._advance(b)
        i = b % self._NB
        self._sums[i] += ms
        self._ns[i] += 1
        self._sum += ms
        self._n += 1

    def mean(self, now: float) -> tuple[float, int]:
        self._advance(int(now / self._bucket_s))
        return (self._sum / self._n if self._n else 0.0), self._n


# window spans, env-tunable like HORAEDB_CALIBRATION_FAST_S
def _window_spans() -> tuple[float, float]:
    import os

    try:
        fast = float(os.environ.get("HORAEDB_PROFILE_FAST_S", "60"))
        slow = float(os.environ.get("HORAEDB_PROFILE_SLOW_S", "600"))
    except ValueError:
        return 60.0, 600.0
    return max(fast, 1.0), max(slow, 1.0)


class _Key:
    """One (path, route, shape) row's streaming aggregates."""

    __slots__ = (
        "count", "total_ms", "excl_ms", "ewma_ms",
        "fast", "slow", "last_trace_id", "last_at",
    )

    def __init__(self) -> None:
        fast_s, slow_s = _window_spans()
        self.count = 0
        self.total_ms = 0.0
        self.excl_ms = 0.0
        self.ewma_ms: Optional[float] = None  # per-occurrence exclusive
        self.fast = _MsWindow(fast_s)
        self.slow = _MsWindow(slow_s)
        self.last_trace_id: Any = None
        self.last_at = 0.0


_EWMA_ALPHA = 0.3
_RATIO_ALPHA = 0.2
UNTRACKED = "(untracked)"  # first-class row suffix, never absorbed


class ProfileAggregator:
    """Bounded streaming fold of finished span trees, keyed by
    (path, route, shape). Thread-safe; every verb reconciles under one
    lock. Eviction is exactly accounted (see module docstring)."""

    def __init__(self, capacity: int = 1024) -> None:
        self.capacity = max(1, int(capacity))
        self._keys: "OrderedDict[tuple, _Key]" = OrderedDict()
        self._lock = threading.Lock()
        # fleetwide accounting — live rows + these == naive refold
        self.traces = 0
        self.spans = 0
        self.dropped = 0
        self.evicted_count = 0
        self.evicted_total_ms = 0.0
        self.evicted_excl_ms = 0.0
        self.untracked_ratio: Optional[float] = None

    # ---- fold ----------------------------------------------------------

    def fold(self, trace_id, root: dict, route: str = "",
             shape: str = "") -> None:
        """Fold one finished trace's serialized root into the profile.
        ``root`` is the snapshot dict ``Trace.to_dict()["root"]`` — the
        same object TRACE_STORE records, so the profile and /debug/trace
        can never disagree about a trace. The HORAEDB_PROFILE gate lives
        at the ``fold_trace`` entry, decided at enqueue time — a queued
        fold always lands even if the switch flips before the worker
        drains it."""
        if not isinstance(root, dict):
            return
        root_ms = root.get("duration_ms")
        if not isinstance(root_ms, (int, float)):
            return
        now = time.time()
        root_name = str(root.get("name", "request"))
        # (path, total_ms, exclusive_ms) rows; the walk is the whole cost
        rows: list[tuple[str, float, float]] = []

        def walk(node: dict, path: str) -> float:
            """-> inclusive duration; appends this node's row."""
            dur = node.get("duration_ms")
            dur = float(dur) if isinstance(dur, (int, float)) else 0.0
            child_sum = 0.0
            for c in node.get("children") or ():
                if isinstance(c, dict):
                    name = str(c.get("name", "?"))
                    child_sum += walk(c, f"{path}/{name}")
            rows.append((path, dur, dur - child_sum))
            return dur

        walk(root, root_name)
        # the root row's exclusive IS the untracked remainder — keep it a
        # first-class row so root == Σ non-root exclusive + untracked
        _, root_total, untracked = rows.pop()
        rows.append((root_name, root_total, 0.0))
        rows.append((f"{root_name}/{UNTRACKED}", untracked, untracked))

        with self._lock:
            self.traces += 1
            self.spans += len(rows)
            _M_TRACES.inc()
            _M_SPANS.inc(len(rows))
            _M_ROOT_MS.inc(max(0.0, float(root_ms)))
            _M_UNTRACKED_MS.inc(max(0.0, untracked))
            if root_ms > 0:
                frac = max(0.0, untracked) / float(root_ms)
                prev = self.untracked_ratio
                self.untracked_ratio = (
                    frac if prev is None
                    else prev + _RATIO_ALPHA * (frac - prev)
                )
                _M_UNTRACKED_RATIO.set(round(self.untracked_ratio, 6))
            for path, total, excl in rows:
                k = (path, route, shape)
                entry = self._keys.get(k)
                if entry is None:
                    entry = _Key()
                    self._keys[k] = entry
                else:
                    self._keys.move_to_end(k)  # touch at MRU end
                entry.count += 1
                entry.total_ms += total
                entry.excl_ms += excl
                entry.ewma_ms = (
                    excl if entry.ewma_ms is None
                    else entry.ewma_ms + _EWMA_ALPHA * (excl - entry.ewma_ms)
                )
                entry.fast.push(now, excl)
                entry.slow.push(now, excl)
                entry.last_trace_id = trace_id
                entry.last_at = now
            self._evict_locked()

    def _evict_locked(self) -> None:
        while len(self._keys) > self.capacity:
            _, victim = self._keys.popitem(last=False)
            self.dropped += 1
            self.evicted_count += victim.count
            self.evicted_total_ms += victim.total_ms
            self.evicted_excl_ms += victim.excl_ms
            _M_DROPPED.inc()

    # ---- read side -----------------------------------------------------

    def list(self, path: Optional[str] = None, route: Optional[str] = None,
             limit: int = 0) -> list[dict]:
        """Snapshot rows (exclusive-heavy first). ``path`` matches by
        prefix (``sql/execute`` covers its subtree), ``route`` exactly."""
        now = time.time()
        with self._lock:
            out = []
            for (p, r, shape), e in self._keys.items():
                if path and not p.startswith(path):
                    continue
                if route and r != route:
                    continue
                fast_ms, fast_n = e.fast.mean(now)
                slow_ms, slow_n = e.slow.mean(now)
                out.append({
                    "path": p,
                    "route": r,
                    "shape": shape,
                    "count": e.count,
                    "total_ms": round(e.total_ms, 3),
                    "exclusive_ms": round(e.excl_ms, 3),
                    "ewma_ms": round(e.ewma_ms, 4)
                    if e.ewma_ms is not None else None,
                    "fast_ms": round(fast_ms, 4),
                    "fast_n": fast_n,
                    "slow_ms": round(slow_ms, 4),
                    "slow_n": slow_n,
                    "last_trace_id": e.last_trace_id,
                    "last_at": round(e.last_at, 3),
                })
        out.sort(key=lambda r: r["exclusive_ms"], reverse=True)
        return out[:limit] if limit else out

    def stats(self) -> dict:
        """Fleetwide accounting — what the reconciliation property and
        /debug/profile's header read."""
        with self._lock:
            live_count = sum(e.count for e in self._keys.values())
            live_total = sum(e.total_ms for e in self._keys.values())
            live_excl = sum(e.excl_ms for e in self._keys.values())
            return {
                "keys": len(self._keys),
                "capacity": self.capacity,
                "traces": self.traces,
                "spans": self.spans,
                "dropped": self.dropped,
                "untracked_ratio": (
                    round(self.untracked_ratio, 6)
                    if self.untracked_ratio is not None else None
                ),
                "live": {
                    "count": live_count,
                    "total_ms": round(live_total, 3),
                    "exclusive_ms": round(live_excl, 3),
                },
                "evicted": {
                    "count": self.evicted_count,
                    "total_ms": round(self.evicted_total_ms, 3),
                    "exclusive_ms": round(self.evicted_excl_ms, 3),
                },
            }

    def resize(self, capacity: int) -> None:
        """Apply the [observability] profile_keys knob; shrinking evicts
        (and accounts) oldest keys immediately."""
        with self._lock:
            self.capacity = max(1, int(capacity))
            self._evict_locked()

    def clear(self) -> None:
        with self._lock:
            self._keys.clear()
            self.traces = 0
            self.spans = 0
            self.dropped = 0
            self.evicted_count = 0
            self.evicted_total_ms = 0.0
            self.evicted_excl_ms = 0.0
            self.untracked_ratio = None


PROFILE = ProfileAggregator()


# ---- async fold -----------------------------------------------------------
#
# The tree walk + per-row updates cost ~30us; paid on every finished
# request under one global lock, that's exactly the tax the bench
# overhead gate exists to catch. So the request thread pays only an
# enqueue — a single daemon worker does the folding. Exactness is kept
# two ways: a full queue folds INLINE (backpressure, never drop), and
# ``flush()`` is the barrier tests/gates call before reconciling.

_MAX_PENDING = 1024
_pending: "deque" = deque()
_outstanding = 0  # queued + in-flight, under _cond
_cond = threading.Condition()
_worker: Optional[threading.Thread] = None


def _drain_loop() -> None:
    global _outstanding
    while True:
        with _cond:
            while not _pending:
                _cond.wait()
            item = _pending.popleft()
        try:
            PROFILE.fold(*item)
        except Exception:
            pass
        with _cond:
            _outstanding -= 1
            if _outstanding == 0:
                _cond.notify_all()


def _ensure_worker() -> None:
    global _worker
    w = _worker
    if w is None or not w.is_alive():  # first fold, or lost to a fork
        w = threading.Thread(
            target=_drain_loop, name="profile-fold", daemon=True
        )
        _worker = w
        w.start()


def fold_trace(trace_id, root: dict, route: str = "", shape: str = "") -> None:
    """finish_trace's hook: fold one finished tree into the global
    aggregator. Never raises, and never taxes the request thread with
    the tree walk — the fold is queued for the daemon worker. The
    HORAEDB_PROFILE gate is decided HERE, at enqueue time."""
    global _outstanding
    if not isinstance(root, dict) or not profile_enabled():
        return
    try:
        inline = False
        with _cond:
            if _outstanding >= _MAX_PENDING:
                inline = True  # backpressure: exactness over latency
            else:
                _pending.append((trace_id, root, route, shape))
                _outstanding += 1
                _cond.notify()
        if inline:
            PROFILE.fold(trace_id, root, route=route, shape=shape)
        else:
            _ensure_worker()
    except Exception:
        pass


def flush(timeout: float = 5.0) -> bool:
    """Barrier: block until every queued fold has landed (tests, the
    tenantsim gate and the bench A/B reconcile AFTER a flush). False on
    timeout."""
    deadline = time.monotonic() + timeout
    with _cond:
        while _outstanding > 0:
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            _cond.wait(left)
    return True


# ---- critical path (EXPLAIN ANALYZE) --------------------------------------


def critical_path(root: dict, max_hops: int = 12) -> list[dict]:
    """The max-time chain through one trace: from the root, repeatedly
    descend into the child with the greatest inclusive duration. Each
    hop carries its inclusive duration and its exclusive (self) time —
    the hop where inclusive≈exclusive is where the wall-clock actually
    went."""
    hops: list[dict] = []
    node = root
    for _ in range(max_hops):
        if not isinstance(node, dict):
            break
        dur = node.get("duration_ms")
        dur = float(dur) if isinstance(dur, (int, float)) else 0.0
        kids = [c for c in (node.get("children") or ()) if isinstance(c, dict)]
        child_sum = sum(
            float(c.get("duration_ms") or 0.0) for c in kids
        )
        hops.append({
            "name": str(node.get("name", "?")),
            "duration_ms": round(dur, 3),
            "self_ms": round(dur - child_sum, 3),
        })
        if not kids:
            break
        node = max(kids, key=lambda c: float(c.get("duration_ms") or 0.0))
    return hops


def render_critical_path(root: dict) -> str:
    """One-line rendering for EXPLAIN ANALYZE's ``Critical path:``."""
    hops = critical_path(root)
    return " -> ".join(
        f"{h['name']} {h['duration_ms']:.1f}ms (self {h['self_ms']:.1f})"
        for h in hops
    )
