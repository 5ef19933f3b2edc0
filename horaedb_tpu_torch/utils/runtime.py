"""Priority runtimes (ref: components/runtime priority_runtime.rs:57-100).

The reference runs expensive (long-time-range) queries on a separate,
smaller tokio runtime so they can't starve cheap queries. Same shape here:
two thread pools; the planner's priority decision picks the pool. The low
pool is intentionally small — expensive queries queue among themselves.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Callable, TypeVar

T = TypeVar("T")


class PriorityRuntime:
    def __init__(self, high_workers: int = 4, low_workers: int = 2) -> None:
        self._high = cf.ThreadPoolExecutor(
            max_workers=high_workers, thread_name_prefix="query-high"
        )
        self._low = cf.ThreadPoolExecutor(
            max_workers=low_workers, thread_name_prefix="query-low"
        )
        self.submitted_high = 0
        self.submitted_low = 0
        self._lock = threading.Lock()

    def submit(self, priority: str, fn: Callable[[], T]) -> "cf.Future[T]":
        pool = self._low if priority == "low" else self._high
        with self._lock:
            if priority == "low":
                self.submitted_low += 1
            else:
                self.submitted_high += 1
        return pool.submit(fn)

    def run(self, priority: str, fn: Callable[[], T]) -> T:
        """Run on the priority pool, blocking the caller until done.

        When the caller already sits on the TARGET pool's own thread,
        run inline instead — submitting would deadlock once the pool is
        saturated with blocked callers.
        """
        name = threading.current_thread().name
        target_prefix = "query-low" if priority == "low" else "query-high"
        if name.startswith(target_prefix):
            return fn()
        return self.submit(priority, fn).result()

    def shutdown(self) -> None:
        self._high.shutdown(wait=False, cancel_futures=True)
        self._low.shutdown(wait=False, cancel_futures=True)


_scatter_pool = None
_scatter_lock = threading.Lock()


def scatter_pool() -> "cf.ThreadPoolExecutor":
    """Shared pool for partition scatter/gather (partial-agg fan-out,
    remote reads). One long-lived pool instead of per-query spawn/join —
    the fan-out sits on the hot serving path."""
    global _scatter_pool
    with _scatter_lock:
        if _scatter_pool is None:
            _scatter_pool = cf.ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="scatter"
            )
        return _scatter_pool


_io_pool = None
_io_lock = threading.Lock()


def io_pool() -> "cf.ThreadPoolExecutor":
    """Dedicated pool for storage IO fan-out (concurrent SST fetches from
    remote stores). SEPARATE from scatter_pool: partition scatter tasks
    trigger SST reads, and nesting both on one bounded pool would
    deadlock under load."""
    global _io_pool
    with _io_lock:
        if _io_pool is None:
            _io_pool = cf.ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="sst-io"
            )
        return _io_pool
