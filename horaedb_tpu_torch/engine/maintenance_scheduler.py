"""Shared background maintenance-scheduler core
(ref: analytic_engine/src/compaction/scheduler.rs — a foreground path
REQUESTS work; a background worker picks and runs it, keeping the heavy
lifting off the write path).

One core serves both maintenance kinds (compaction merges and memtable
flushes) instead of two copy-pasted schedulers: per-table pending-set
dedupe (a table already queued is not queued again; a request landing
mid-run re-queues), per-table exponential failure backoff, an optional
periodic picking loop, waiter futures for synchronous callers
(``flush_table(wait=True)``, tests, close, ALTER), and a drain-on-close
so shutdown never abandons half-scheduled work silently.

Waiter semantics: a waiter attaches to a QUEUED entry (its run starts
later and snapshots state then, so it covers everything present now) —
never to a run already in flight, because that run froze its inputs
before the waiter arrived. The pending entry is discarded before the run
starts, which makes the distinction fall out of the data structure.
"""

from __future__ import annotations

import contextvars
import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional

from ..utils.metrics import Counter, Gauge

logger = logging.getLogger("horaedb_tpu_torch.engine.maintenance")


class PeriodicLoop:
    """The background picking-loop core (ref: scheduler.rs — the
    scheduler wakes on its own, not only on requests), shared by the
    maintenance schedulers and the self-monitoring MetricsRecorder.

    Every ``interval_s``, ``tick_fn`` runs; a ``False`` return ends the
    loop (weakref wrappers return it once their owner is collected), an
    exception is logged and the loop continues. The loop closure holds
    ONLY the stop event and the tick function the caller passed — the
    caller decides whether that closure may pin anything (the instance
    schedulers pass weakref wrappers for exactly this reason)."""

    def __init__(self, interval_s: float, tick_fn: Callable, name: str) -> None:
        self._stop = threading.Event()
        stop, nm = self._stop, name

        def loop():
            while not stop.wait(interval_s):
                try:
                    if tick_fn() is False:
                        return
                except Exception:
                    logger.exception("periodic %s tick failed", nm)

        self._thread = threading.Thread(target=loop, name=f"{nm}-tick", daemon=True)

    def start(self) -> "PeriodicLoop":
        self._thread.start()
        return self

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

# Backoff: without it a periodic loop would retry (and stack-trace-log) a
# durably failing table every tick forever. Exponential, success clears.
_BACKOFF_BASE_S = 30.0
_BACKOFF_CAP_S = 3600.0


class SchedulerClosed(RuntimeError):
    """A waiter's request arrived at (or survived into) a closed
    scheduler — typed so synchronous callers can fall back to running the
    work inline during shutdown instead of mistaking this for a real
    maintenance failure."""


@dataclass(frozen=True)
class SchedulerMetrics:
    """The metric families one scheduler kind reports through — each kind
    (compaction, flush) registers its own ``horaedb_<kind>_*`` names and
    hands them here so the core stays name-agnostic."""

    accepted: Counter
    deduped: Counter
    rejected_closed: Counter
    failures: Counter
    backoff: Counter
    depth: Gauge


class MaintenanceScheduler:
    def __init__(
        self,
        run_fn: Callable,
        metrics: SchedulerMetrics,
        workers: int = 1,
        thread_prefix: str = "maintenance",
        kind: str = "maintenance",
    ) -> None:
        self._run_fn = run_fn
        self._m = metrics
        self._kind = kind
        self._lock = threading.Lock()
        # key -> waiter futures attached while the entry is still queued
        self._pending: dict[tuple[int, int], list[Future]] = {}
        self._running = 0
        self._executor = ThreadPoolExecutor(
            max_workers=max(1, workers), thread_name_prefix=thread_prefix
        )
        self._closed = False
        self._periodic: PeriodicLoop | None = None
        self._backoff: dict[tuple[int, int], tuple[int, float]] = {}

    def start_periodic(self, interval_s: float, scan_fn: Callable) -> None:
        """Background picking loop on the shared ``PeriodicLoop`` core:
        every ``interval_s``, ``scan_fn`` inspects tables and request()s
        work; a ``False`` return ends the loop (the instance-side weakref
        wrapper returns it once its instance is collected). Idempotent;
        the thread dies promptly on close(). The loop closure captures
        ONLY the stop event and scan_fn — a strong ``self`` would chain
        thread -> scheduler -> run_fn -> instance and pin an abandoned
        engine forever."""
        with self._lock:
            if self._closed or self._periodic is not None:
                return
            self._periodic = PeriodicLoop(
                interval_s, scan_fn, self._kind
            ).start()

    def _update_depth_locked(self) -> None:
        self._m.depth.set(len(self._pending) + self._running)

    def request(
        self, table, waiter: Optional[Future] = None, urgent: bool = False
    ) -> bool:
        """Queue work for ``table`` unless an entry is already queued (a
        ``waiter`` attaches to that queued entry instead); returns True if
        newly queued. Failure backoff suppresses only waiterless
        (fire-and-forget) requests — an explicit synchronous caller must
        get its attempt (and its exception) regardless, and ``urgent``
        requests (a stalled writer pushing on the backpressure bound)
        bypass it too: after one transient failure, the ONLY thing that
        can unblock a stalled writer is a retried flush, so suppressing
        its re-requests would turn a blip into a deadline-long outage."""
        key = (table.space_id, table.table_id)
        # Submit under the lock: close() sets _closed under the same lock
        # before shutting the executor down, so a request that saw
        # _closed=False cannot race submit against shutdown (which would
        # raise RuntimeError into the requesting writer).
        with self._lock:
            if self._closed:
                self._m.rejected_closed.inc()
                if waiter is not None:
                    waiter.set_exception(
                        SchedulerClosed(f"{self._kind} scheduler closed")
                    )
                return False
            if key in self._pending:
                self._m.deduped.inc()
                if waiter is not None:
                    self._pending[key].append(waiter)
                return False
            entry = self._backoff.get(key)
            if (
                waiter is None
                and not urgent
                and entry is not None
                and time.monotonic() < entry[1]
            ):
                self._m.backoff.inc()
                return False
            self._pending[key] = [waiter] if waiter is not None else []
            self._update_depth_locked()
            # The requester's context rides to the worker: the run's
            # spans, ledger records and journal events (flush_dump /
            # flush_install) then carry the triggering request's
            # trace_id — same pattern as the io-pool context copies in
            # engine/flush.py. A periodic-loop request has an empty
            # context; that's the honest answer (no request caused it).
            self._executor.submit(
                self._run, key, table, contextvars.copy_context()
            )
        self._m.accepted.inc()
        return True

    def _run(
        self, key: tuple[int, int], table,
        ctx: contextvars.Context | None = None,
    ) -> None:
        # Release the dedupe slot BEFORE running: a request that arrives
        # while the work runs re-queues (the run may not cover state that
        # changed after its snapshot). Discarding after the run instead
        # would silently swallow that request — if it was the workload's
        # last trigger, the condition persists with no work ever
        # scheduled. A re-queued no-op is cheap; a lost trigger is not.
        with self._lock:
            waiters = self._pending.pop(key, [])
            self._running += 1
            self._update_depth_locked()
        try:
            if ctx is not None:
                result = ctx.run(self._run_fn, table)
            else:
                result = self._run_fn(table)
            with self._lock:
                self._backoff.pop(key, None)
            for f in waiters:
                f.set_result(result)
        except Exception as e:
            self._m.failures.inc()
            # A table retired/dropped mid-run gets no backoff entry: its
            # forget() may already have run, and re-inserting here would
            # recreate exactly the permanent stats() leak forget() fixes.
            gone = getattr(table, "retired", False) or getattr(table, "dropped", False)
            fails, delay = 1, _BACKOFF_BASE_S
            with self._lock:
                if not gone:
                    fails = self._backoff.get(key, (0, 0.0))[0] + 1
                    delay = min(_BACKOFF_BASE_S * (2 ** (fails - 1)), _BACKOFF_CAP_S)
                    self._backoff[key] = (fails, time.monotonic() + delay)
            for f in waiters:
                f.set_exception(e)
            logger.exception(
                "background %s failed for table %s (attempt %d; "
                "suppressed for %.0fs)", self._kind, table.name, fails, delay,
            )
        finally:
            with self._lock:
                self._running -= 1
                self._update_depth_locked()

    def forget(self, key: tuple[int, int]) -> None:
        """Drop a table's failure-backoff entry when the table is dropped
        or handed off — otherwise a durably-failing table leaves its entry
        (and stats() row) behind forever."""
        with self._lock:
            self._backoff.pop(key, None)

    @staticmethod
    def idle_stats(closed: bool = False) -> dict:
        """The no-scheduler-yet shape — ONE place defines the key schema
        for both the live and idle answers of the /debug endpoints."""
        return {
            "pending": [], "running": 0, "closed": closed,
            "periodic": False, "backoff": {},
        }

    def stats(self) -> dict:
        """Introspection for /debug/{compaction,flush} and horaectl:
        what's queued, what's running, which tables are in backoff."""
        now = time.monotonic()
        with self._lock:
            return {
                "pending": sorted(f"{s}/{t}" for s, t in self._pending),
                "running": self._running,
                "closed": self._closed,
                # liveness, not object presence: a closed or weakref-dead
                # loop must not report as running
                "periodic": self._periodic is not None and self._periodic.is_alive(),
                "backoff": {
                    f"{s}/{t}": {
                        "failures": fails,
                        "retry_in_s": round(max(0.0, retry_at - now), 1),
                    }
                    for (s, t), (fails, retry_at) in self._backoff.items()
                },
            }

    def close(self, wait: bool = True) -> None:
        """Stop accepting requests and shut the workers down. ``wait``
        drains everything queued; without it, queued-but-unstarted work is
        CANCELLED and only runs in flight are joined. Either way close
        never returns with a worker still racing the next instance's
        manifest appends, and no waiter is left hanging."""
        with self._lock:
            self._closed = True
            periodic = self._periodic
        if periodic is not None:
            periodic.close(timeout=5)
        self._executor.shutdown(wait=True, cancel_futures=not wait)
        with self._lock:
            # Cancelled futures never ran _run; don't leave their pending
            # entries pinned in the depth gauge (or their waiters hung)
            # forever.
            leftovers = list(self._pending.values())
            self._pending.clear()
            self._running = 0
            self._update_depth_locked()
        for waiters in leftovers:
            for f in waiters:
                if not f.done():
                    f.set_exception(
                        SchedulerClosed(f"{self._kind} scheduler closed")
                    )
