"""Background flush scheduler
(ref: analytic_engine/src/instance/flush_compaction.rs + the per-table
flush serializer in instance/serial_executor.rs — the write path FREEZES
the mutable memtable under a cheap lock and *requests* a flush; a
background worker dumps the frozen memtables to L0 SSTs, so writers
never block on an object-store upload).

Thin binding of the shared ``MaintenanceScheduler`` core to the flush
run function: per-table dedupe (a flush already queued absorbs later
requests AND synchronous waiters — its freeze happens at run time, so
it covers everything present now), failure backoff for fire-and-forget
requests, waiter futures for ``flush_table(wait=True)`` (tests, close,
ALTER), and drain-on-close. Per-table dump serialization itself lives in
``TableData.flush_lock`` — two workers can never interleave one table's
freeze/dump/install."""

from __future__ import annotations

from typing import Callable

from ..utils.metrics import REGISTRY
from .maintenance_scheduler import MaintenanceScheduler, SchedulerMetrics

# Declared registry of the flush-pipeline metric families — the
# metrics-name lint (tests/test_observability.py) checks each one is
# registered live, convention-clean, and documented in
# docs/OBSERVABILITY.md, and that no horaedb_flush_* family exists
# outside this list. The write-stall histogram and the per-bucket
# concurrency gauge register in engine/instance.py and engine/flush.py;
# they are declared here so the pipeline's whole surface is one list.
FLUSH_PIPELINE_METRIC_FAMILIES = (
    "horaedb_flush_duration_seconds",
    "horaedb_flush_rows_total",
    "horaedb_flush_bytes_total",
    "horaedb_flush_requests_total",
    "horaedb_flush_requests_deduped_total",
    "horaedb_flush_requests_rejected_closed_total",
    "horaedb_flush_requests_backoff_total",
    "horaedb_flush_failures_total",
    "horaedb_flush_queue_depth_total",
    "horaedb_flush_bucket_writes_inflight_total",
    "horaedb_write_stall_seconds",
)

# Registered at import so the series exist from the first scrape.
_METRICS = SchedulerMetrics(
    accepted=REGISTRY.counter(
        "horaedb_flush_requests_total",
        "background flush requests accepted",
    ),
    deduped=REGISTRY.counter(
        "horaedb_flush_requests_deduped_total",
        "flush requests coalesced into an already-queued one",
    ),
    rejected_closed=REGISTRY.counter(
        "horaedb_flush_requests_rejected_closed_total",
        "flush requests dropped because the scheduler was closed",
    ),
    failures=REGISTRY.counter(
        "horaedb_flush_failures_total",
        "background flushes that raised",
    ),
    backoff=REGISTRY.counter(
        "horaedb_flush_requests_backoff_total",
        "flush requests suppressed by per-table failure backoff",
    ),
    depth=REGISTRY.gauge(
        "horaedb_flush_queue_depth_total",
        "background flushes queued or running",
    ),
)


class FlushScheduler(MaintenanceScheduler):
    def __init__(self, run_fn: Callable, workers: int = 2) -> None:
        super().__init__(
            run_fn,
            _METRICS,
            workers=workers,
            thread_prefix="flush",
            kind="flush",
        )
