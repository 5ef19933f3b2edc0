"""Per-request deadline propagation + cooperative cancellation — every
query carries a time budget from wire to kernel (ref: the reference
proxy's Context deadline threading through proxy/route/remote engine;
the reference forwards `timeout` in its RPC contexts instead of a fixed
per-hop constant).

One ``Deadline`` rides a ContextVar beside the trace (utils/tracectx)
and the cost ledger (utils/querystats): the gateway parses
``X-HoraeDB-Timeout-Ms`` (or the MySQL/PG session knob, or the
``[limits] query_timeout`` default) at ingress, the proxy opens the
scope, and every layer *charges* it —

- admission queue wait counts against the budget and sheds immediately
  when the remaining budget cannot fit the shape's expected cost
  (wlm/admission);
- the executor observes ``checkpoint()`` at cheap points (per scan
  batch / SST read, per partial-agg window, before each device
  dispatch);
- remote RPC envelopes and forwarding hops send the *remaining* budget
  as their per-call timeout (remote/client, server/http, cluster/
  meta_client) and the receiving side refuses already-expired work;
- object-store waits cap at ``min(op_cap, remaining)``.

Cooperative cancellation rides the same object: a live-query registry
(served as ``system.public.queries`` on every wire) lets
``KILL QUERY <id>`` / ``horaectl query kill`` / ``DELETE
/debug/queries/{id}`` (and a client disconnect) flip the cancel flag,
which the SAME checkpoints observe. The hard invariant: a cancelled or
expired query always releases its admission slots (the admit context
manager's finally), its dedup flight (leader finally; followers get a
typed retryable error, wlm/dedup) and its cohort membership (a
cancelled member demuxes out, the cohort survives — wlm/batch).

Typed errors map to all three wire protocols: ``DeadlineExceeded`` →
HTTP 504 + Retry-After, MySQL 1317/SQLSTATE 70100, PG SQLSTATE 57014;
``QueryCancelled`` → HTTP 499-style, same native codes.

Registry discipline (the contract): the families below are
declared in ``DEADLINE_METRIC_FAMILIES`` / ``CANCEL_METRIC_FAMILIES``,
eagerly registered, documented in docs/OBSERVABILITY.md, and linted in
tests/test_observability.py (no stray ``horaedb_query_deadline_*`` /
``horaedb_query_cancel*`` family may exist outside them).
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from contextlib import contextmanager
from typing import Any, Optional

from .metrics import REGISTRY

# Stages a budget can die at — the label set of the expiry counter and
# the `stage` attr of `query_timeout` events. "ingress" = already
# expired on arrival (a forwarded hop received <= 0 remaining);
# "queued" = the admission wait ate the budget (or the remaining budget
# could not fit the expected cost); "executing" = an executor/scan/agg
# checkpoint; "dispatch" = just before a device dispatch; "remote" =
# the remote-engine client/server hop; "forward" = an HTTP forwarding
# hop; "store" = an object-store read wait.
DEADLINE_STAGES = (
    "ingress", "queued", "executing", "dispatch", "remote", "forward",
    "store",
)

CANCEL_SOURCES = ("kill", "disconnect")

# rides a gRPC DEADLINE_EXCEEDED status detail when (and only when) the
# serving side refused or stopped work against the SHIPPED budget — the
# remote client maps marked errors back to the typed DeadlineExceeded
# (same discipline as wlm.admission.SHED_MARKER)
DEADLINE_MARKER = "deadline exceeded"

# family -> help; single source of truth the registry lint walks. The
# ledger-derived families (horaedb_query_deadline_ms_total from the
# `deadline_ms` field, horaedb_query_cancelled_total from `cancelled`)
# share the prefixes and are declared here too so the no-stray check
# has one complete inventory.
DEADLINE_METRIC_FAMILIES: dict[str, str] = {
    "horaedb_query_deadline_expired_total":
        "queries whose time budget expired, by the stage that observed it",
    "horaedb_query_deadline_budget_seconds":
        "per-request time budgets observed at proxy ingress",
    "horaedb_query_deadline_ms_total":
        "summed per-request deadline budgets (ledger field deadline_ms)",
}
CANCEL_METRIC_FAMILIES: dict[str, str] = {
    "horaedb_query_cancel_total":
        "cooperative query cancellations, by source (kill/disconnect)",
    "horaedb_query_cancelled_total":
        "queries that surfaced QueryCancelled (ledger field cancelled)",
}

# Eager registration: the labeled series exist from the first scrape
# (same discipline as the admission/event families). The two
# ledger-derived families register in utils/querystats.
_M_EXPIRED = {
    stage: REGISTRY.counter(
        "horaedb_query_deadline_expired_total",
        DEADLINE_METRIC_FAMILIES["horaedb_query_deadline_expired_total"],
        labels={"stage": stage},
    )
    for stage in DEADLINE_STAGES
}
_M_BUDGET = REGISTRY.histogram(
    "horaedb_query_deadline_budget_seconds",
    DEADLINE_METRIC_FAMILIES["horaedb_query_deadline_budget_seconds"],
)
_M_CANCEL = {
    src: REGISTRY.counter(
        "horaedb_query_cancel_total",
        CANCEL_METRIC_FAMILIES["horaedb_query_cancel_total"],
        labels={"source": src},
    )
    for src in CANCEL_SOURCES
}


class DeadlineExceeded(RuntimeError):
    """The query's time budget ran out. Retryable by contract — the
    node is healthy, the budget was just too small for the load (HTTP
    maps it to 504 + Retry-After, MySQL to 1317/SQLSTATE 70100, PG to
    SQLSTATE 57014)."""

    retryable = True

    def __init__(self, msg: str, stage: str = "executing",
                 budget_ms: Optional[float] = None,
                 retry_after_s: float = 1.0) -> None:
        super().__init__(msg)
        self.stage = stage if stage in DEADLINE_STAGES else "executing"
        self.budget_ms = budget_ms
        self.retry_after_s = retry_after_s


class QueryCancelled(RuntimeError):
    """The query was cooperatively cancelled (KILL QUERY / horaectl
    query kill / DELETE /debug/queries/{id} / client disconnect). Not
    retryable: someone asked for this work to stop."""

    retryable = False

    def __init__(self, msg: str, query_id: Optional[int] = None,
                 source: str = "kill") -> None:
        super().__init__(msg)
        self.query_id = query_id
        self.source = source if source in CANCEL_SOURCES else "kill"


class Deadline:
    """One request's time budget + cancel flag. ``budget_ms`` None means
    unbounded (cancellation still observed). Thread-safe by design: the
    fields checkpoints read are set-once/monotonic (a torn read of
    ``_cancelled`` only delays the observation to the next checkpoint).
    """

    __slots__ = ("budget_ms", "started", "_deadline_at", "_cancelled",
                 "cancel_source", "state", "proto")

    def __init__(self, budget_ms: Optional[float] = None,
                 proto: str = "sql") -> None:
        if budget_ms is not None and budget_ms <= 0:
            budget_ms = None
        self.budget_ms = budget_ms
        self.started = time.monotonic()
        self._deadline_at = (
            None if budget_ms is None else self.started + budget_ms / 1000.0
        )
        self._cancelled = False
        self.cancel_source = ""
        # coarse live-query state for system.public.queries
        # (running -> queued -> executing as the layers report in)
        self.state = "running"
        # which wire the request came in on (system.public.queries'
        # protocol column; the gateway stamps http/mysql/postgres)
        self.proto = proto

    # ---- budget ----------------------------------------------------------
    def remaining_s(self) -> Optional[float]:
        """Seconds left, or None when unbounded. May be <= 0."""
        if self._deadline_at is None:
            return None
        return self._deadline_at - time.monotonic()

    def remaining_ms(self) -> Optional[int]:
        rem = self.remaining_s()
        return None if rem is None else int(rem * 1000)

    def expired(self) -> bool:
        rem = self.remaining_s()
        return rem is not None and rem <= 0

    def elapsed_ms(self) -> float:
        return (time.monotonic() - self.started) * 1000.0

    # ---- cancellation ----------------------------------------------------
    def cancel(self, source: str = "kill") -> None:
        if not self._cancelled:
            self._cancelled = True
            self.cancel_source = source if source in CANCEL_SOURCES else "kill"

    def cancelled(self) -> bool:
        return self._cancelled

    # ---- the checkpoint --------------------------------------------------
    def check(self, stage: str = "executing") -> None:
        """Raise the typed error when cancelled or out of budget; the
        caller's cleanup (admission slot release, dedup flight pop,
        cohort demux) runs in the ordinary finally/except unwinding."""
        if self._cancelled:
            raise QueryCancelled(
                "query cancelled cooperatively "
                f"({self.cancel_source or 'kill'})",
                source=self.cancel_source or "kill",
            )
        rem = self.remaining_s()
        if rem is not None and rem <= 0:
            counter = _M_EXPIRED.get(stage)
            if counter is not None:
                counter.inc()
            raise DeadlineExceeded(
                f"query exceeded its {self.budget_ms:.0f}ms time budget "
                f"(observed at {stage})",
                stage=stage,
                budget_ms=self.budget_ms,
            )

    def cap_timeout(self, op_cap_s: float) -> float:
        """``min(op_cap, remaining)`` for a blocking sub-operation's
        timeout — never below a small positive floor so a just-expiring
        budget surfaces as a typed deadline error at the next
        checkpoint, not as an opaque 0-second transport failure."""
        rem = self.remaining_s()
        if rem is None:
            return op_cap_s
        return max(0.05, min(op_cap_s, rem))


_current_deadline: contextvars.ContextVar[Optional[Deadline]] = (
    contextvars.ContextVar("horaedb_deadline", default=None)
)


def current_deadline() -> Optional[Deadline]:
    return _current_deadline.get()


def checkpoint(stage: str = "executing") -> None:
    """The cooperative checkpoint: a cheap no-op outside a deadline
    scope (one ContextVar read), a typed raise when the current query is
    cancelled or out of budget."""
    d = _current_deadline.get()
    if d is not None:
        d.check(stage)


def cap_timeout(op_cap_s: float) -> float:
    """min(op_cap, remaining budget) — the per-call timeout every
    outbound hop (forward, RPC, store wait) should use instead of a
    fixed constant. Without an active deadline, the cap itself."""
    d = _current_deadline.get()
    return op_cap_s if d is None else d.cap_timeout(op_cap_s)


def bind(deadline: Optional[Deadline]) -> contextvars.Context:
    """A context COPY with ``deadline`` installed — for running a
    callable on an executor thread under the budget without changing
    the callable's signature (``loop.run_in_executor(None, ctx.run,
    fn)``); the caller's own context is left untouched."""
    token = _current_deadline.set(deadline)
    try:
        return contextvars.copy_context()
    finally:
        _current_deadline.reset(token)


@contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    """Install ``deadline`` as the current scope (None = explicit
    no-budget scope, shadowing any outer one)."""
    token = _current_deadline.set(deadline)
    try:
        yield deadline
    finally:
        _current_deadline.reset(token)


@contextmanager
def serving_deadline(deadline_ms: Optional[float], stage: str = "remote"):
    """Serve an RPC/forwarded request under the origin's REMAINING
    budget. ``deadline_ms`` <= 0 means the work was already expired on
    arrival — refuse it before doing anything (the typed error maps to
    the wire; the origin's own checkpoint fires regardless)."""
    if deadline_ms is None:
        yield None
        return
    if deadline_ms <= 0:
        counter = _M_EXPIRED.get("ingress")
        if counter is not None:
            counter.inc()
        raise DeadlineExceeded(
            "request arrived with an exhausted time budget",
            stage="ingress",
            budget_ms=float(deadline_ms),
        )
    d = Deadline(float(deadline_ms))
    with deadline_scope(d):
        yield d


def observe_budget(budget_ms: Optional[float]) -> None:
    """Record a request's ingress budget into the histogram (and the
    ledger's ``deadline_ms`` field via the caller)."""
    if budget_ms is not None and budget_ms > 0:
        _M_BUDGET.observe(budget_ms / 1000.0)


def note_expired(stage: str) -> None:
    """Count one budget expiry observed outside a Deadline.check (e.g.
    a wire front end refusing an explicit zero budget on arrival)."""
    counter = _M_EXPIRED.get(stage)
    if counter is not None:
        counter.inc()


def note_cancel(source: str) -> None:
    counter = _M_CANCEL.get(source if source in CANCEL_SOURCES else "kill")
    if counter is not None:
        counter.inc()


# ---- live-query registry ---------------------------------------------------


class _LiveQuery:
    __slots__ = ("query_id", "request_id", "sql", "tenant", "protocol",
                 "admission_class", "started_at", "deadline")

    def __init__(self, query_id: int, request_id, sql: str, tenant: str,
                 protocol: str, deadline: Deadline) -> None:
        self.query_id = query_id
        self.request_id = request_id
        self.sql = sql
        self.tenant = tenant
        self.protocol = protocol
        self.admission_class = ""
        self.started_at = time.time()
        self.deadline = deadline


class LiveQueryRegistry:
    """Every in-flight proxy statement, keyed by a process-global query
    id — the KILL QUERY / horaectl query kill / DELETE
    /debug/queries/{id} target, served as ``system.public.queries``.
    Registration is cheap (one dict insert under a lock); a query that
    never deregisters cannot exist — the proxy's finally owns it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._live: dict[int, _LiveQuery] = {}

    def register(self, request_id, sql: str, tenant: str,
                 deadline: Deadline, protocol: str = "sql") -> _LiveQuery:
        entry = _LiveQuery(
            next(self._ids), request_id, sql, tenant, protocol, deadline
        )
        with self._lock:
            self._live[entry.query_id] = entry
        return entry

    def deregister(self, entry: _LiveQuery) -> None:
        with self._lock:
            self._live.pop(entry.query_id, None)

    def kill(self, query_id: int, source: str = "kill") -> bool:
        """Flip the cancel flag on a live query. True when the id was
        live (the query unwinds at its next checkpoint); False when no
        such query is running here."""
        with self._lock:
            entry = self._live.get(int(query_id))
        if entry is None:
            return False
        entry.deadline.cancel(source)
        note_cancel(source)
        return True

    def get(self, query_id: int) -> Optional[_LiveQuery]:
        with self._lock:
            return self._live.get(int(query_id))

    def list(self) -> list[dict[str, Any]]:
        """Snapshot rows for system.public.queries / /debug/queries."""
        with self._lock:
            entries = list(self._live.values())
        out = []
        for e in entries:
            d = e.deadline
            rem = d.remaining_ms()
            out.append(
                {
                    "query_id": e.query_id,
                    "request_id": e.request_id or 0,
                    "sql": e.sql[:200],
                    "tenant": e.tenant,
                    "protocol": e.protocol,
                    "class": e.admission_class,
                    "state": (
                        "cancelled" if d.cancelled() else d.state
                    ),
                    "started_ms": int(e.started_at * 1000),
                    "elapsed_ms": round(d.elapsed_ms(), 3),
                    "deadline_ms": int(d.budget_ms or 0),
                    "remaining_ms": -1 if rem is None else rem,
                    "cancelled": 1 if d.cancelled() else 0,
                }
            )
        out.sort(key=lambda r: r["query_id"])
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._live)


QUERY_REGISTRY = LiveQueryRegistry()
