"""Cost-based admission control (ref: the reference proxy's limiter /
priority runtime split, and StreamBox-HBM's capacity-aware admission —
an analytic engine only stays at hardware speed under overload when
arrivals are gated against what the hardware can actually hold).

Three pieces:

- ``classify_plan``: each ``QueryPlan`` is classified cheap / normal /
  expensive from planner shape (time-range span, aggregate-ness, the
  planner's own priority demotion) blended with an EWMA over the
  observed latency of the same *normalized SQL shape* (literals
  stripped) — the same signal ``system.public.query_stats`` records.
  Three observations of a shape outrank the static guess: a full-range
  ``count(*)`` over a tiny table stops hogging the expensive lane.

- ``AdmissionController``: weighted concurrency slots plus a memory
  budget. Each class costs a number of slot units and an estimated
  working-set size; admission blocks on a bounded per-class wait queue
  with a deadline, and sheds with a typed, retryable
  ``OverloadedError`` when the queue is full or the deadline passes.
  Non-cheap load (normal + expensive together) is additionally capped
  below the total so neither a scan storm nor a dashboard-aggregate
  storm can occupy every slot — a cheap query always has a unit to
  claim (the acceptance contract).

- Cross-node propagation: ``admit()`` publishes the admitted class in a
  ContextVar (``current_admission()``); the remote-engine client ships
  it beside the trace/ledger context so partition owners run
  PartialAgg/ExecutePlan on the matching PriorityRuntime lane and apply
  their own gate.
"""

from __future__ import annotations

import contextvars
import re
import threading
import time
from contextlib import contextmanager
from typing import Optional

from ..utils.metrics import REGISTRY

CLASSES = ("cheap", "normal", "expensive")

# slot units one admitted query of each class occupies
WEIGHTS = {"cheap": 1, "normal": 2, "expensive": 3}

# working-set estimate per class, charged against the memory budget
MEM_ESTIMATES = {
    "cheap": 16 << 20,
    "normal": 64 << 20,
    "expensive": 256 << 20,
}

# EWMA thresholds: an observed shape faster than CHEAP_MS is cheap, one
# slower than EXPENSIVE_MS is expensive, regardless of static shape.
CHEAP_MS = 50.0
EXPENSIVE_MS = 500.0

# observations of a shape before the EWMA outranks the static class
HISTORY_MIN_SAMPLES = 3


# rides a gRPC RESOURCE_EXHAUSTED status detail when (and only when) a
# serving-side admission gate shed the call — the remote client maps
# marked errors back to a retryable OverloadedError, and ONLY those
# (grpc uses the same status for e.g. message-size overflow)
SHED_MARKER = "admission shed"


def lane_for(admission_class: str) -> str:
    """The PriorityRuntime lane an admission class executes on."""
    return "low" if admission_class == "expensive" else "high"


class OverloadedError(RuntimeError):
    """Admission control shed this request. Retryable by contract: the
    node is healthy, just full — clients should back off and retry
    (HTTP maps it to 503 + Retry-After, MySQL to errno 1040, PG to
    SQLSTATE 53300)."""

    retryable = True

    def __init__(self, msg: str, reason: str, retry_after_s: float = 1.0) -> None:
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = retry_after_s


# ---- SQL shape normalization + EWMA cost history --------------------------

_NUM_RE = re.compile(r"\b\d+(\.\d+)?([eE][+-]?\d+)?\b")
_STR_RE = re.compile(r"'(?:[^']|'')*'")
_WS_RE = re.compile(r"\s+")


def normalize_shape(sql: str) -> str:
    """Literal-insensitive shape key: ``SELECT v FROM t WHERE ts > 5``
    and ``... ts > 9`` share one cost history entry."""
    s = _STR_RE.sub("?", sql)
    s = _NUM_RE.sub("?", s)
    return _WS_RE.sub(" ", s).strip().lower()


class CostHistory:
    """EWMA of observed latency per normalized SQL shape, bounded LRU.

    Misses bootstrap lazily from the query_stats ring (the durable-ish
    record of recent shapes), so a restarted proxy — or the EXPLAIN
    path, which never executes through the proxy — still benefits from
    whatever history the node has."""

    def __init__(self, capacity: int = 1024, alpha: float = 0.3) -> None:
        from collections import OrderedDict

        self.capacity = capacity
        self.alpha = alpha
        self._ewma: "OrderedDict[str, tuple[float, int]]" = OrderedDict()
        self._lock = threading.Lock()

    def observe(self, shape: str, elapsed_s: float) -> None:
        ms = elapsed_s * 1000.0
        with self._lock:
            prev = self._ewma.pop(shape, None)
            if prev is None or prev[1] == 0:  # fresh (or negative-cached)
                self._ewma[shape] = (ms, 1)
            else:
                est, n = prev
                self._ewma[shape] = (est + self.alpha * (ms - est), n + 1)
            while len(self._ewma) > self.capacity:
                self._ewma.popitem(last=False)

    def estimate_ms(self, shape: str) -> Optional[tuple[float, int]]:
        """(ewma_ms, samples) for the shape, or None when never seen."""
        with self._lock:
            got = self._ewma.get(shape)
            if got is not None:
                self._ewma.move_to_end(shape)
                return got if got[1] > 0 else None
        self._bootstrap(shape)
        with self._lock:
            got = self._ewma.get(shape)
            if got is None:
                # negative cache: one O(ring) bootstrap scan per shape,
                # ever — the admission hot path must not re-pay it on
                # every miss (samples=0 means "known absent")
                self._ewma[shape] = (0.0, 0)
                while len(self._ewma) > self.capacity:
                    self._ewma.popitem(last=False)
                return None
            return got if got[1] > 0 else None

    def _bootstrap(self, shape: str) -> None:
        from ..utils.querystats import STATS_STORE

        for row in STATS_STORE.list():
            sql = row.get("sql")
            if sql and normalize_shape(sql) == shape:
                self.observe(shape, float(row.get("duration_ms", 0.0)) / 1000.0)


COST_HISTORY = CostHistory()


def classify_plan(plan, shape: Optional[str] = None) -> tuple[str, Optional[float]]:
    """(admission class, ewma estimate ms or None) for a QueryPlan.

    Static shape first (the planner's long-range demotion, aggregates);
    a seasoned EWMA for the normalized shape overrides it entirely —
    history beats heuristics once there is enough of it."""
    prio = getattr(getattr(plan, "priority", None), "value", "high")
    static = "expensive" if prio == "low" else (
        "normal" if getattr(plan, "is_aggregate", False) else "cheap"
    )
    if shape is None:
        return static, None
    got = COST_HISTORY.estimate_ms(shape)
    if got is None:
        return static, None
    est_ms, samples = got
    if samples < HISTORY_MIN_SAMPLES:
        return static, est_ms
    if est_ms >= EXPENSIVE_MS:
        return "expensive", est_ms
    if est_ms < CHEAP_MS:
        return "cheap", est_ms
    return "normal", est_ms


# ---- the controller -------------------------------------------------------

_current_admission: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "horaedb_admission_class", default=None
)


def current_admission() -> Optional[str]:
    """The admission class of the currently-executing query (rides the
    context to pool threads and out over remote RPC envelopes)."""
    return _current_admission.get()


class AdmissionController:
    """Weighted slots + memory budget with bounded per-class wait queues.

    ``total_units`` is the node's concurrency capital; a query of class
    c costs WEIGHTS[c] units and MEM_ESTIMATES[c] budget bytes.
    Non-cheap load (normal + expensive together) is capped at
    ``total_units - 1`` units in use — the cheap lane can never be
    fully starved, whatever the mix — and expensive alone is held to
    the same cap so it can't crowd out normal either."""

    def __init__(
        self,
        total_units: int = 8,
        memory_budget_bytes: int = 1 << 30,
        queue_depth: int = 32,
        deadline_s: float = 5.0,
    ) -> None:
        # floor: one expensive admit plus the cheap reserve must fit, or
        # an idle controller could never admit an expensive query and a
        # small-slots config would shed them forever
        self.total_units = max(WEIGHTS["expensive"] + 1, int(total_units))
        self.memory_budget_bytes = int(memory_budget_bytes)
        self.queue_depth = int(queue_depth)
        self.deadline_s = float(deadline_s)
        # expensive can never occupy the last unit (cheap reserve)
        self.expensive_cap = self.total_units - 1
        self._cv = threading.Condition()
        self._units_in_use = 0
        self._mem_in_use = 0
        self._class_units = dict.fromkeys(CLASSES, 0)
        self._waiting = dict.fromkeys(CLASSES, 0)
        self._admitted = {
            c: REGISTRY.counter(
                "horaedb_admission_admitted_total",
                "queries admitted by the workload manager, by class",
                labels={"class": c},
            )
            for c in CLASSES
        }
        self._wait_hist = REGISTRY.histogram(
            "horaedb_admission_wait_seconds",
            "time queries spent waiting for an admission slot",
        )

    def _shed_counter(self, cls: str, reason: str):
        return REGISTRY.counter(
            "horaedb_admission_shed_total",
            "queries shed by admission control, by class and reason",
            labels={"class": cls, "reason": reason},
        )

    def _fits_locked(self, cls: str, units: int, mem: int) -> bool:
        if self._units_in_use + units > self.total_units:
            return False
        if cls != "cheap":
            # the cheap reserve holds against ALL non-cheap load (a
            # normal-class dashboard storm must not starve point
            # lookups either): non-cheap units collectively stay below
            # the total, and one cheap-sized slice of the memory budget
            # is untouchable
            noncheap = self._units_in_use - self._class_units["cheap"]
            if noncheap + units > self.total_units - 1:
                return False
            if self._mem_in_use + mem > self.memory_budget_bytes - MEM_ESTIMATES["cheap"]:
                return False
        elif self._mem_in_use + mem > self.memory_budget_bytes:
            return False
        if cls == "expensive" and self._class_units[cls] + units > self.expensive_cap:
            return False
        return True

    def _shed(self, cls: str, reason: str, msg: str) -> OverloadedError:
        self._shed_counter(cls, reason).inc()
        from ..utils.events import record_event

        record_event("admission_shed", **{"class": cls, "reason": reason})
        return OverloadedError(msg, reason=reason, retry_after_s=1.0)

    @contextmanager
    def admit(self, cls: str, deadline_s: Optional[float] = None,
              est_cost_s: Optional[float] = None,
              shape: Optional[str] = None):
        """Block until a slot frees (bounded queue + deadline), then run
        the body holding the slot. Records the queue wait into the
        current query ledger (``admission_wait_seconds``).

        The request's time budget (utils/deadline) is CHARGED here:
        queue wait never outlives the remaining budget, a budget that
        cannot fit the shape's expected cost (``est_cost_s``, the
        classifier's EWMA estimate) sheds immediately instead of
        queueing doomed work, and a KILL observed while queued unwinds
        without ever taking the slot. The slot-release invariant holds
        by construction: the slot is only held inside this context
        manager's try/finally, so a typed deadline/cancel raise from
        the body always releases it."""
        if cls not in WEIGHTS:
            cls = "normal"
        units = WEIGHTS[cls]
        mem = MEM_ESTIMATES[cls]
        deadline_s = self.deadline_s if deadline_s is None else deadline_s
        from ..utils.deadline import current_deadline

        budget = current_deadline()
        if budget is not None:
            budget.check("queued")
            rem = budget.remaining_s()
            if rem is not None:
                if est_cost_s is not None and rem < est_cost_s:
                    # the remaining budget cannot fit the expected cost:
                    # shed NOW — queueing (and then executing most of)
                    # work that is provably going to time out only
                    # burns the slot another query could use
                    from ..utils.deadline import DeadlineExceeded
                    from ..utils.events import record_event

                    self._shed_counter(cls, "deadline_budget").inc()
                    record_event(
                        "admission_shed",
                        **{"class": cls, "reason": "deadline_budget"},
                    )
                    # Decision plane: was this shed provably doomed?
                    # Journaled with the predicted cost + remaining
                    # budget; the proxy resolves it when a later
                    # same-shape query completes (actual seconds >=
                    # the remaining budget here -> "doomed", else the
                    # shed was premature and the estimator is graded
                    # by the signed error either way.
                    from ..obs.decisions import record_decision

                    record_decision(
                        "deadline",
                        key=shape if shape else cls,
                        choice="shed",
                        features={
                            "class": cls,
                            "remaining_s": round(rem, 6),
                            "budget_ms": budget.budget_ms or 0,
                        },
                        predicted=est_cost_s,
                    )
                    raise DeadlineExceeded(
                        f"remaining budget {rem * 1000:.0f}ms cannot fit "
                        f"the expected {est_cost_s * 1000:.0f}ms cost of "
                        f"this {cls} query",
                        stage="queued",
                        budget_ms=budget.budget_ms,
                    )
                deadline_s = min(deadline_s, rem)
            budget.state = "queued"
        t0 = time.perf_counter()
        deadline = t0 + deadline_s
        with self._cv:
            if not self._fits_locked(cls, units, mem):
                if self._waiting[cls] >= self.queue_depth:
                    raise self._shed(
                        cls, "queue_full",
                        f"admission queue for class {cls!r} is full "
                        f"({self.queue_depth} waiting); retry later",
                    )
                self._waiting[cls] += 1
                try:
                    while not self._fits_locked(cls, units, mem):
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            if budget is not None:
                                # the BUDGET ran out first: the typed
                                # 504, not a generic overload shed
                                budget.check("queued")
                            raise self._shed(
                                cls, "deadline",
                                f"no admission slot for class {cls!r} "
                                f"query within {deadline_s:.1f}s; "
                                "retry later",
                            )
                        # sliced waits: a KILL while queued unwinds
                        # within a checkpoint interval, not at the
                        # admission deadline
                        self._cv.wait(min(remaining, 0.25))
                        if budget is not None:
                            budget.check("queued")
                finally:
                    self._waiting[cls] -= 1
            self._units_in_use += units
            self._mem_in_use += mem
            self._class_units[cls] += units
        if budget is not None:
            budget.state = "executing"
        waited = time.perf_counter() - t0
        self._wait_hist.observe(waited)
        self._admitted[cls].inc()
        from ..utils.querystats import record

        record(admission_wait_seconds=waited)
        token = _current_admission.set(cls)
        try:
            yield
        finally:
            _current_admission.reset(token)
            with self._cv:
                self._units_in_use -= units
                self._mem_in_use -= mem
                self._class_units[cls] -= units
                self._cv.notify_all()

    def snapshot(self) -> dict:
        """Live state for /debug/workload + system.public.workload."""
        with self._cv:
            return {
                "total_units": self.total_units,
                "units_in_use": self._units_in_use,
                "memory_budget_bytes": self.memory_budget_bytes,
                "memory_in_use_bytes": self._mem_in_use,
                "expensive_cap": self.expensive_cap,
                "class_units": dict(self._class_units),
                "queue_depth": dict(self._waiting),
                "queue_limit": self.queue_depth,
                "deadline_s": self.deadline_s,
            }
