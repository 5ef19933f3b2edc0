"""Background compaction scheduler
(ref: analytic_engine/src/compaction/scheduler.rs — flush REQUESTS
compaction; a background worker picks and runs it, keeping the k-way
merge cost off the write path. The reference bounds concurrency with
ScheduleRoom tokens; here a small worker pool plus per-table dedupe
gives the same two properties: writes never block on a merge, and one
table never has two merges racing — per-table dedupe stops a second
merge from QUEUEING while one is queued, and ``Compactor.compact``'s
``serial_lock`` serializes the rare re-queue that lands mid-run).

The scheduling mechanics (pending-set dedupe, failure backoff, periodic
loop, drain-on-close, waiter futures) live in the shared
``MaintenanceScheduler`` core — this module binds the compaction metric
families and run function to it. The flush scheduler
(flush_scheduler.py) binds the same core to the flush path."""

from __future__ import annotations

from typing import Callable

from ..utils.metrics import REGISTRY
from .maintenance_scheduler import MaintenanceScheduler, SchedulerMetrics

# Register at import so every series exists (as 0) from the first scrape;
# a rate() over an absent series silently shows nothing instead of 0.
_METRICS = SchedulerMetrics(
    accepted=REGISTRY.counter(
        "horaedb_compaction_requests_total",
        "background compaction requests accepted",
    ),
    deduped=REGISTRY.counter(
        "horaedb_compaction_requests_deduped_total",
        "compaction requests coalesced into an already-queued one",
    ),
    rejected_closed=REGISTRY.counter(
        "horaedb_compaction_requests_rejected_closed_total",
        "compaction requests dropped because the scheduler was closed",
    ),
    failures=REGISTRY.counter(
        "horaedb_compaction_failures_total",
        "background compactions that raised",
    ),
    backoff=REGISTRY.counter(
        "horaedb_compaction_requests_backoff_total",
        "compaction requests suppressed by per-table failure backoff",
    ),
    depth=REGISTRY.gauge(
        "horaedb_compaction_queue_depth_total",
        "background compactions queued or running",
    ),
)


class CompactionScheduler(MaintenanceScheduler):
    def __init__(self, run_fn: Callable, workers: int = 2) -> None:
        super().__init__(
            run_fn,
            _METRICS,
            workers=workers,
            thread_prefix="compaction",
            kind="compaction",
        )
