"""Decision plane — every adaptive loop journals its choice, its
features-at-decision-time, and the realized outcome; the database grades
its own predictions.

The engine runs five feedback loops (docs/OBSERVABILITY.md §Decision
plane): the kernel router's per-shape impl EWMA, admission's cost-EWMA
`est_cost_s`, the elastic controller's scale/move/hold rounds, the scan
cache's layout auto-tuner, and the deadline-budget shed check. Each one
predicts something, acts on it, and — before this module — discarded the
prediction, so there was no way to tell a well-calibrated loop from a
guessing one, and nothing for ROADMAP item 4's learned control plane to
learn from. "Fine-tune the data structure to the observed mix"
(PAPERS.md 2112.13099) applies to *measurement* first: you cannot tune
a loop whose error you never computed.

Two verbs, journal discipline identical to utils/events.py:

    ``record_decision(loop, key, choice, features, predicted) -> id``
    ``resolve_decision(id, actual, outcome, loop=...)``

Entries live in a bounded ring (``[observability] decision_ring`` knob,
drop-accounted — an evicted UNRESOLVED entry is counted expired, never
silently lost), and every loop's accounting reconciles exactly:

    issued == resolved + expired + unresolved_live

A resolve whose id already rolled off is a counted **miss**, not a
KeyError; an unresolved decision past ``HORAEDB_DECISION_EXPIRE_MS`` is
a counted **expiry** — a leaked resolve is an observable, not a silent
gap. Calibration is graded per loop with the SLO plane's incremental-
window discipline (slo/evaluator._Window): signed/abs relative-error
EWMA plus fast/slow sliding windows, O(1) amortized, never a rescan.
Sustained abs error over threshold in BOTH windows emits a typed
``loop_miscalibrated`` event; resolutions sample into typed
``decision_resolved`` events (1-in-N per loop so the high-rate loops
cannot flood the event ring).

Surfaces: ``system.public.decisions`` + ``system.public.calibration``
(all three wires), ``/debug/decisions``, ``horaectl decisions``, an
EXPLAIN ANALYZE ``Decision:`` line, and the registry-linted
``horaedb_decision_*`` / ``horaedb_calibration_*`` families.
``HORAEDB_DECISIONS=0`` turns the plane off (record returns 0,
resolve(0) is a no-op); the ``BENCH_CONFIG=decisions`` gate pins
journal-on within 2% of off on the flood shape.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Optional, Union

from ..utils.env import env_float
from ..utils.metrics import REGISTRY

# The instrumented loops — the label set of every horaedb_decision_*
# / horaedb_calibration_* family (eagerly registered, lint-pinned like
# DEVICE_KERNEL_KINDS).
DECISION_LOOPS = (
    "kernel_router",  # per-(plan shape, n_seg bucket) segment-impl EWMA
    "admission",      # est_cost_s admit/shed classification
    "elastic",        # scale/move/hold control rounds
    "layout_tuner",   # scan-cache per-column layouts (bf16/dict/delta),
                      # absorbing the former dtype_tuner promotion loop
    "deadline",       # reason=deadline_budget sheds (provably doomed?)
    "livewindow",     # live-window state promotions (predicted vs realized hits)
)

DECISION_METRIC_FAMILIES = (
    "horaedb_decision_recorded_total",
    "horaedb_decision_resolved_total",
    "horaedb_decision_expired_total",
    "horaedb_decision_miss_total",
    "horaedb_decision_dropped_total",
)

CALIBRATION_METRIC_FAMILIES = (
    "horaedb_calibration_error_ratio",
    "horaedb_calibration_samples_total",
    "horaedb_calibration_miscalibrated_total",
)

CALIBRATION_WINDOWS = ("fast", "slow", "ewma")
CALIBRATION_ERROR_KINDS = ("signed", "abs")

_M_RECORDED = {
    loop: REGISTRY.counter(
        "horaedb_decision_recorded_total",
        "adaptive-loop decisions journaled, by loop",
        labels={"loop": loop},
    )
    for loop in DECISION_LOOPS
}
_M_RESOLVED = {
    loop: REGISTRY.counter(
        "horaedb_decision_resolved_total",
        "journaled decisions whose realized outcome arrived, by loop",
        labels={"loop": loop},
    )
    for loop in DECISION_LOOPS
}
_M_EXPIRED = {
    loop: REGISTRY.counter(
        "horaedb_decision_expired_total",
        "decisions that aged out or were evicted unresolved, by loop",
        labels={"loop": loop},
    )
    for loop in DECISION_LOOPS
}
_M_MISS = {
    loop: REGISTRY.counter(
        "horaedb_decision_miss_total",
        "resolves whose decision id had already expired or rolled off",
        labels={"loop": loop},
    )
    for loop in DECISION_LOOPS
}
_M_DROPPED = REGISTRY.counter(
    "horaedb_decision_dropped_total",
    "journal entries discarded by the bounded ring (oldest-first)",
)
_M_CAL_ERROR = {
    (loop, window, kind): REGISTRY.gauge(
        "horaedb_calibration_error_ratio",
        "relative prediction error ((actual-predicted)/|predicted|), "
        "by loop, window, and error kind",
        labels={"loop": loop, "window": window, "kind": kind},
    )
    for loop in DECISION_LOOPS
    for window in CALIBRATION_WINDOWS
    for kind in CALIBRATION_ERROR_KINDS
}
_M_CAL_SAMPLES = {
    loop: REGISTRY.counter(
        "horaedb_calibration_samples_total",
        "resolved decisions graded into the calibration windows, by loop",
        labels={"loop": loop},
    )
    for loop in DECISION_LOOPS
}
_M_CAL_MISCAL = {
    loop: REGISTRY.counter(
        "horaedb_calibration_miscalibrated_total",
        "transitions of a loop into the miscalibrated state",
        labels={"loop": loop},
    )
    for loop in DECISION_LOOPS
}


def decisions_enabled() -> bool:
    """HORAEDB_DECISIONS=0 turns the whole plane off — record returns 0
    and resolve(0) is a no-op (the bench A/B's off arm)."""
    import os

    return os.environ.get("HORAEDB_DECISIONS", "1") not in ("0", "off", "false")


def _expire_ms() -> float:
    """Unresolved decisions older than this are counted expired
    (HORAEDB_DECISION_EXPIRE_MS, default 10 minutes)."""
    return max(0.0, env_float("HORAEDB_DECISION_EXPIRE_MS", 600_000.0))


# decision_resolved events are SAMPLED per loop (1-in-N) — the kernel
# router resolves on every aggregation dispatch and would otherwise own
# the 512-entry event ring; the low-rate loops journal every resolution.
_EVENT_SAMPLE = {
    "kernel_router": 64,
    "admission": 16,
    "elastic": 1,
    "layout_tuner": 1,
    "deadline": 1,
    "livewindow": 1,
}

# miscalibration verdict: both windows' mean |relative error| over the
# threshold, with at least MIN_SAMPLES in the fast window
_MISCAL_THRESHOLD = 0.5
_MISCAL_MIN_SAMPLES = 8


class _ErrWindow:
    """Sliding time window over (signed, abs) relative errors — the SLO
    evaluator's running-sums discipline: push + lazy head eviction, O(1)
    amortized, never a rescan of the deque."""

    __slots__ = ("span_ms", "samples", "signed_sum", "abs_sum")

    def __init__(self, span_ms: float) -> None:
        self.span_ms = float(span_ms)
        self.samples: "deque[tuple[float, float, float]]" = deque()
        self.signed_sum = 0.0
        self.abs_sum = 0.0

    def _evict(self, now_ms: float) -> None:
        cutoff = now_ms - self.span_ms
        q = self.samples
        while q and q[0][0] <= cutoff:
            _, s, a = q.popleft()
            self.signed_sum -= s
            self.abs_sum -= a

    def push(self, now_ms: float, signed: float, abs_err: float) -> None:
        self._evict(now_ms)
        self.samples.append((now_ms, signed, abs_err))
        self.signed_sum += signed
        self.abs_sum += abs_err

    def means(self, now_ms: float) -> tuple[Optional[float], Optional[float], int]:
        """(signed mean, abs mean, n) over the live span; None means when
        empty."""
        self._evict(now_ms)
        n = len(self.samples)
        if n == 0:
            return None, None, 0
        return self.signed_sum / n, self.abs_sum / n, n


class _LoopCalibration:
    """Per-loop grading state: signed/abs EWMA + fast/slow windows +
    the miscalibration state machine."""

    __slots__ = (
        "loop", "alpha", "fast", "slow",
        "ewma_signed", "ewma_abs", "samples", "miscalibrated",
    )

    def __init__(self, loop: str, fast_ms: float, slow_ms: float,
                 alpha: float = 0.3) -> None:
        self.loop = loop
        self.alpha = alpha
        self.fast = _ErrWindow(fast_ms)
        self.slow = _ErrWindow(slow_ms)
        self.ewma_signed: Optional[float] = None
        self.ewma_abs: Optional[float] = None
        self.samples = 0
        self.miscalibrated = False

    def push(self, now_ms: float, signed: float) -> Optional[dict]:
        """Fold one graded resolution in; returns miscalibration-event
        attrs when this sample TRANSITIONS the loop into the state."""
        abs_err = abs(signed)
        self.samples += 1
        a = self.alpha
        self.ewma_signed = (
            signed if self.ewma_signed is None
            else (1 - a) * self.ewma_signed + a * signed
        )
        self.ewma_abs = (
            abs_err if self.ewma_abs is None
            else (1 - a) * self.ewma_abs + a * abs_err
        )
        self.fast.push(now_ms, signed, abs_err)
        self.slow.push(now_ms, signed, abs_err)
        _, fast_abs, fast_n = self.fast.means(now_ms)
        _, slow_abs, _ = self.slow.means(now_ms)
        bad = (
            fast_n >= _MISCAL_MIN_SAMPLES
            and fast_abs is not None and fast_abs > _MISCAL_THRESHOLD
            and slow_abs is not None and slow_abs > _MISCAL_THRESHOLD
        )
        fired = None
        if bad and not self.miscalibrated:
            self.miscalibrated = True
            fired = {
                "loop": self.loop,
                "fast_abs_error": round(fast_abs, 4),
                "slow_abs_error": round(slow_abs, 4),
                "fast_samples": fast_n,
            }
        elif self.miscalibrated and fast_abs is not None and not bad:
            # recover on the fast window clearing (or draining empty)
            self.miscalibrated = False
        return fired

    def snapshot(self, now_ms: float) -> dict:
        fast_signed, fast_abs, fast_n = self.fast.means(now_ms)
        slow_signed, slow_abs, slow_n = self.slow.means(now_ms)
        return {
            "loop": self.loop,
            "samples": self.samples,
            "ewma_signed": self.ewma_signed,
            "ewma_abs": self.ewma_abs,
            "fast_signed": fast_signed,
            "fast_abs": fast_abs,
            "fast_n": fast_n,
            "slow_signed": slow_signed,
            "slow_abs": slow_abs,
            "slow_n": slow_n,
            "miscalibrated": self.miscalibrated,
        }


class DecisionJournal:
    """Bounded ring of decision entries + per-loop calibration. One per
    process, like EVENT_STORE / TRACE_STORE / STATS_STORE.

    Accounting contract (the tenantsim reconciliation gate reads it from
    ``system.public.calibration``): for every loop, at any instant,
    ``issued == resolved + expired + unresolved`` — a decision is always
    in exactly one of those states; late resolves of expired/rolled-off
    ids are counted misses and consume nothing.
    """

    DEFAULT_CAPACITY = 1024

    def __init__(
        self,
        maxlen: int = DEFAULT_CAPACITY,
        fast_window_s: Optional[float] = None,
        slow_window_s: Optional[float] = None,
    ) -> None:
        self._ring: "deque[dict]" = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._issued = 0
        self.dropped = 0  # ring evictions of RESOLVED/EXPIRED entries
        # id -> live unresolved entry (insertion order == id order, so
        # TTL expiry pops from the front, O(1) amortized)
        self._pending: dict[int, dict] = {}
        # (loop, key) -> ids awaiting a keyed resolve_matching
        self._pending_by_key: dict[tuple, list[int]] = {}
        self._counts = {
            loop: {"issued": 0, "resolved": 0, "expired": 0, "missed": 0}
            for loop in DECISION_LOOPS
        }
        fast_ms = (
            fast_window_s if fast_window_s is not None
            else env_float("HORAEDB_CALIBRATION_FAST_S", 300.0)
        ) * 1000.0
        slow_ms = (
            slow_window_s if slow_window_s is not None
            else env_float("HORAEDB_CALIBRATION_SLOW_S", 3600.0)
        ) * 1000.0
        self._calibration = {
            loop: _LoopCalibration(loop, fast_ms, slow_ms)
            for loop in DECISION_LOOPS
        }
        self._event_counts: dict[str, int] = {}

    # ---- verbs -----------------------------------------------------------

    def record(
        self,
        loop: str,
        key: str,
        choice: str,
        features: Optional[dict] = None,
        predicted: Optional[float] = None,
    ) -> int:
        """Journal one adaptive decision; returns its id (0 when the
        plane is disabled — resolve(0) is a no-op)."""
        if loop not in DECISION_LOOPS:
            raise ValueError(
                f"undeclared decision loop {loop!r}: add it to "
                "horaedb_tpu_torch.obs.decisions.DECISION_LOOPS (and document it)"
            )
        if not decisions_enabled():
            return 0
        from ..utils.tracectx import get_request_id

        now_ms = time.time() * 1000.0
        entry = {
            "timestamp": int(now_ms),
            "loop": loop,
            "key": str(key),
            "choice": str(choice),
            "features": dict(features) if features else {},
            "predicted": None if predicted is None else float(predicted),
            "resolved": False,
            "resolved_at": 0,
            "actual": None,
            "outcome": "",
            "error": None,
            "trace_id": get_request_id(),
        }
        with self._lock:
            self._expire_locked(now_ms)
            did = entry["id"] = self._issued = next(self._seq)
            self._counts[loop]["issued"] += 1
            if len(self._ring) == self._ring.maxlen:
                self._evict_oldest_locked()
            self._ring.append(entry)
            self._pending[did] = entry
            self._pending_by_key.setdefault((loop, entry["key"]), []).append(did)
        _M_RECORDED[loop].inc()
        return did

    def resolve(
        self,
        decision_id: int,
        actual: Optional[float] = None,
        outcome: str = "ok",
        loop: Optional[str] = None,
        calibrate: bool = True,
    ) -> bool:
        """Attach the realized outcome to a journaled decision.

        Returns False (and counts a miss against ``loop``) when the id
        already expired or rolled off the ring — a late resolve is an
        observable, never a KeyError. ``calibrate=False`` resolves
        without grading (compile-tainted samples, failed queries)."""
        if decision_id <= 0:
            return False  # disabled-plane ids resolve to nothing, silently
        now_ms = time.time() * 1000.0
        fired = None
        with self._lock:
            self._expire_locked(now_ms)
            entry = self._pending.pop(decision_id, None)
            if entry is None:
                miss_loop = loop if loop in DECISION_LOOPS else None
                if miss_loop is not None:
                    self._counts[miss_loop]["missed"] += 1
                    counter = _M_MISS[miss_loop]
                else:
                    counter = None
                if counter is not None:
                    counter.inc()
                return False
            self._unindex_locked(entry)
            entry["resolved"] = True
            entry["resolved_at"] = int(now_ms)
            entry["actual"] = None if actual is None else float(actual)
            entry["outcome"] = str(outcome)
            self._counts[entry["loop"]]["resolved"] += 1
            fired = self._grade_locked(entry, now_ms, calibrate)
        _M_RESOLVED[entry["loop"]].inc()
        self._emit_events(entry, fired)
        return True

    def resolve_matching(
        self,
        loop: str,
        key: str,
        actual: Optional[float] = None,
        outcome: Union[str, Callable[[dict], str]] = "ok",
        calibrate: bool = True,
        limit: int = 0,
    ) -> int:
        """Resolve pending decisions of ``(loop, key)`` oldest-first —
        the keyed form for loops whose outcome arrives detached from the
        id (a deadline shed graded by a later same-shape completion, a
        dtype promotion graded at the f32 re-upload). ``outcome`` may be
        a callable receiving the entry (so the caller can grade doomed
        vs premature from the features it recorded). ``limit=0`` means
        all pending matches. Returns how many resolved; zero matches is
        NOT a miss — nothing was issued for this completion."""
        now_ms = time.time() * 1000.0
        resolved: list[tuple[dict, Optional[dict]]] = []
        with self._lock:
            self._expire_locked(now_ms)
            ids = list(self._pending_by_key.get((loop, str(key)), ()))
            if limit > 0:
                ids = ids[:limit]
            for did in ids:
                entry = self._pending.pop(did, None)
                if entry is None:
                    continue
                self._unindex_locked(entry)
                entry["resolved"] = True
                entry["resolved_at"] = int(now_ms)
                entry["actual"] = None if actual is None else float(actual)
                entry["outcome"] = str(
                    outcome(entry) if callable(outcome) else outcome
                )
                self._counts[loop]["resolved"] += 1
                fired = self._grade_locked(entry, now_ms, calibrate)
                resolved.append((entry, fired))
        for entry, fired in resolved:
            _M_RESOLVED[loop].inc()
            self._emit_events(entry, fired)
        return len(resolved)

    # ---- internals -------------------------------------------------------

    def _unindex_locked(self, entry: dict) -> None:
        k = (entry["loop"], entry["key"])
        ids = self._pending_by_key.get(k)
        if ids is not None:
            try:
                ids.remove(entry["id"])
            except ValueError:
                pass
            if not ids:
                self._pending_by_key.pop(k, None)

    def _expire_one_locked(self, entry: dict, now_ms: float) -> None:
        self._pending.pop(entry["id"], None)
        self._unindex_locked(entry)
        entry["resolved"] = False
        entry["outcome"] = "expired"
        entry["resolved_at"] = int(now_ms)
        self._counts[entry["loop"]]["expired"] += 1
        _M_EXPIRED[entry["loop"]].inc()

    def _expire_locked(self, now_ms: float) -> None:
        """Lazily age out unresolved decisions (pending is id-ordered, so
        only the head can be expired — O(1) amortized)."""
        ttl = _expire_ms()
        if ttl <= 0:
            return
        cutoff = now_ms - ttl
        while self._pending:
            first_id = next(iter(self._pending))
            entry = self._pending[first_id]
            if entry["timestamp"] > cutoff:
                break
            self._expire_one_locked(entry, now_ms)

    def _evict_oldest_locked(self) -> None:
        """The ring is full: deque(maxlen) would evict silently; the
        journal must not — an evicted UNRESOLVED entry is accounted
        expired (its resolve, should it ever come, is a counted miss),
        and every eviction ticks the dropped counter."""
        victim = self._ring[0]
        if not victim["resolved"] and victim["id"] in self._pending:
            self._expire_one_locked(victim, time.time() * 1000.0)
        self.dropped += 1
        _M_DROPPED.inc()

    def _grade_locked(self, entry: dict, now_ms: float,
                      calibrate: bool) -> Optional[dict]:
        """Compute the relative error and fold it into the loop's
        calibration; returns loop_miscalibrated attrs on transition."""
        predicted, actual = entry["predicted"], entry["actual"]
        if not calibrate or predicted is None or actual is None:
            return None
        signed = (actual - predicted) / max(abs(predicted), 1e-9)
        entry["error"] = signed
        cal = self._calibration[entry["loop"]]
        fired = cal.push(now_ms, signed)
        _M_CAL_SAMPLES[entry["loop"]].inc()
        self._export_gauges_locked(entry["loop"], now_ms)
        if fired is not None:
            _M_CAL_MISCAL[entry["loop"]].inc()
        return fired

    def _export_gauges_locked(self, loop: str, now_ms: float) -> None:
        cal = self._calibration[loop]
        snap = cal.snapshot(now_ms)
        for window, (signed, abs_err) in (
            ("ewma", (snap["ewma_signed"], snap["ewma_abs"])),
            ("fast", (snap["fast_signed"], snap["fast_abs"])),
            ("slow", (snap["slow_signed"], snap["slow_abs"])),
        ):
            if signed is not None:
                _M_CAL_ERROR[(loop, window, "signed")].set(float(signed))
            if abs_err is not None:
                _M_CAL_ERROR[(loop, window, "abs")].set(float(abs_err))

    def _emit_events(self, entry: dict, fired: Optional[dict]) -> None:
        """Typed journal events, outside the lock (record_event takes the
        event ring's own lock)."""
        from ..utils.events import record_event

        loop = entry["loop"]
        n = self._event_counts.get(loop, 0)
        self._event_counts[loop] = n + 1
        if n % _EVENT_SAMPLE.get(loop, 1) == 0:
            attrs = {
                "loop": loop,
                "decision_key": entry["key"],
                "choice": entry["choice"],
                "outcome": entry["outcome"],
            }
            if entry["predicted"] is not None:
                attrs["predicted"] = round(entry["predicted"], 6)
            if entry["actual"] is not None:
                attrs["actual"] = round(entry["actual"], 6)
            if entry["error"] is not None:
                attrs["error"] = round(entry["error"], 4)
            record_event("decision_resolved", **attrs)
        if fired is not None:
            record_event("loop_miscalibrated", **fired)

    # ---- reads -----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def resize(self, maxlen: int) -> None:
        """Re-bound the ring ([observability] decision_ring). Shrinking
        discards oldest-first with the same accounting as overflow."""
        maxlen = max(1, int(maxlen))
        with self._lock:
            if maxlen == self._ring.maxlen:
                return
            old = list(self._ring)
            cut = max(0, len(old) - maxlen)
            for victim in old[:cut]:
                if not victim["resolved"] and victim["id"] in self._pending:
                    self._expire_one_locked(victim, time.time() * 1000.0)
                self.dropped += 1
                _M_DROPPED.inc()
            self._ring = deque(old[cut:], maxlen=maxlen)

    def list(
        self,
        loop: Optional[str] = None,
        limit: Optional[int] = None,
        resolved: Optional[bool] = None,
    ) -> list[dict]:
        """Oldest-first snapshot of entry COPIES (entries mutate on
        resolve; readers must never race a live mutation), optionally
        filtered by loop/resolution and tailed to the newest ``limit``."""
        now_ms = time.time() * 1000.0
        with self._lock:
            self._expire_locked(now_ms)
            out = [dict(e) for e in self._ring]
        if loop is not None:
            out = [e for e in out if e["loop"] == loop]
        if resolved is not None:
            out = [e for e in out if e["resolved"] == resolved]
        if limit is not None:
            # 0 means zero entries, never "no limit" (the events contract)
            out = out[-limit:] if limit > 0 else []
        return out

    def stats(self) -> dict:
        """One consistent snapshot: ring accounting + the per-loop
        issued/resolved/expired/missed/unresolved ledger the
        reconciliation gate checks."""
        now_ms = time.time() * 1000.0
        with self._lock:
            self._expire_locked(now_ms)
            pending_by_loop = {loop: 0 for loop in DECISION_LOOPS}
            for e in self._pending.values():
                pending_by_loop[e["loop"]] += 1
            loops = {}
            for loop in DECISION_LOOPS:
                c = self._counts[loop]
                loops[loop] = {
                    **c,
                    "unresolved": pending_by_loop[loop],
                }
            return {
                "capacity": self.capacity,
                "size": len(self._ring),
                "dropped": self.dropped,
                "issued": self._issued,
                "pending": len(self._pending),
                "loops": loops,
            }

    def calibration(self) -> list[dict]:
        """Per-loop calibration rows (the ``system.public.calibration``
        materialization): window means + the accounting ledger."""
        now_ms = time.time() * 1000.0
        with self._lock:
            self._expire_locked(now_ms)
            pending_by_loop = {loop: 0 for loop in DECISION_LOOPS}
            for e in self._pending.values():
                pending_by_loop[e["loop"]] += 1
            rows = []
            for loop in DECISION_LOOPS:
                snap = self._calibration[loop].snapshot(now_ms)
                snap.update(self._counts[loop])
                snap["unresolved"] = pending_by_loop[loop]
                rows.append(snap)
            return rows

    def clear(self) -> None:
        """Drop entries + calibration state but keep the issued/drop
        accounting (the EventStore.clear contract) — live pending
        entries are expired, not forgotten."""
        now_ms = time.time() * 1000.0
        with self._lock:
            for e in list(self._pending.values()):
                self._expire_one_locked(e, now_ms)
            self._ring.clear()
            self._calibration = {
                loop: _LoopCalibration(
                    loop, cal.fast.span_ms, cal.slow.span_ms, cal.alpha
                )
                for loop, cal in self._calibration.items()
            }


DECISION_JOURNAL = DecisionJournal()


def record_decision(
    loop: str,
    key: str,
    choice: str,
    features: Optional[dict] = None,
    predicted: Optional[float] = None,
) -> int:
    """Journal one adaptive decision on the process-global journal."""
    return DECISION_JOURNAL.record(loop, key, choice, features, predicted)


def resolve_decision(
    decision_id: int,
    actual: Optional[float] = None,
    outcome: str = "ok",
    loop: Optional[str] = None,
    calibrate: bool = True,
) -> bool:
    """Attach the realized outcome on the process-global journal; pass
    ``loop`` so a late resolve is miss-attributed to the right loop."""
    return DECISION_JOURNAL.resolve(
        decision_id, actual, outcome, loop=loop, calibrate=calibrate
    )
