"""Replicated follower reads — the shared vocabulary of the scale-out
read path (ref: the shard_lock_manager.rs lease-fencing model applied to
READ scale-out: writes stay single-leader, but all durable data lives in
shared object storage, so follower nodes can open a shard read-only,
tail the leader's manifest, and serve bounded-staleness reads; the
TiKV-PD stance in PAPER.md, and StreamBox-HBM's replicate-the-read-side
scaling in PAPERS.md).

This module holds what every layer agrees on:

- the typed, retryable refusal errors a follower raises instead of
  serving past its guarantees (``ReplicaFencedError`` — lease lapsed or
  epoch trails a transfer; ``ReplicaStaleError`` — the query's range
  needs data beyond the follower's watermark);
- the ``horaedb_replica_*`` metric families (lint-enforced registry);
- the ContextVars that carry "this statement is being served from a
  follower" into the proxy's ledger (``route=follower`` +
  ``replica_lag_ms`` in ``system.public.query_stats`` on every wire)
  and back out to the HTTP response headers.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from ..utils.metrics import REGISTRY

# Declared registry of the replica metric families — the lint in
# tests/test_observability.py checks each is registered live,
# convention-clean, and documented in docs/OBSERVABILITY.md, and that no
# stray horaedb_replica_* family exists outside it.
REPLICA_METRIC_FAMILIES = (
    "horaedb_replica_reads_total",
    "horaedb_replica_watermark_lag_seconds",
)

# Outcomes of one replica-read attempt, labeled on the reads family:
#   served          a follower answered from its manifest snapshot
#   fenced          a follower refused: lease lapsed / epoch trails
#   stale_fallback  the read fell back to the leader (range beyond the
#                   follower's watermark, or a follower refusal)
REPLICA_READ_OUTCOMES = ("served", "fenced", "stale_fallback")

# Eager registration: series exist from the first scrape (and the lint).
_M_READS = {
    o: REGISTRY.counter(
        "horaedb_replica_reads_total",
        "replica (follower) read attempts by outcome",
        labels={"outcome": o},
    )
    for o in REPLICA_READ_OUTCOMES
}
_M_WM_LAG = REGISTRY.gauge(
    "horaedb_replica_watermark_lag_seconds",
    "worst follower freshness lag (now - last installed flush) across "
    "the replica tables this node serves",
)


def note_replica_read(outcome: str) -> None:
    c = _M_READS.get(outcome)
    if c is not None:
        c.inc()


def set_watermark_lag(lag_s: float) -> None:
    _M_WM_LAG.set(max(0.0, lag_s))


class ReplicaFencedError(RuntimeError):
    """A follower refusing to serve because it can no longer prove its
    view of the topology: its replica lease lapsed (cut off from the
    coordinator past one TTL) or its shard epoch trails a transfer the
    caller has already observed. Retryable by contract — the caller
    falls back to the leader (or retries after the fence heals)."""

    def __init__(self, msg: str, epoch: int = 0, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.epoch = epoch
        self.retry_after_s = retry_after_s


class ReplicaStaleError(RuntimeError):
    """A follower refusing a read whose time range needs data beyond its
    freshness watermark (and no staleness opt-in covers the lag).
    Retryable by contract — the caller serves it from the leader."""

    def __init__(self, msg: str, epoch: int = 0,
                 watermark_ms: int = 0, retry_after_s: float = 0.5):
        super().__init__(msg)
        self.epoch = epoch
        self.watermark_ms = watermark_ms
        self.retry_after_s = retry_after_s


# ---- serving context -------------------------------------------------------

# Set (in the worker thread) around a follower-served statement so the
# proxy's ledger finalization stamps route=follower + replica_lag_ms, and
# EXPLAIN renders the Replica: line — without threading a parameter
# through every layer.
_REPLICA_CTX: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "horaedb_replica_serving", default=None
)

# Set in the REQUEST TASK's context (async side) so the HTTP handler can
# attach X-HoraeDB-Replica-* headers after gateway.execute returns.
REPLICA_RESPONSE: contextvars.ContextVar[Optional[dict]] = (
    contextvars.ContextVar("horaedb_replica_response", default=None)
)


@contextlib.contextmanager
def replica_serving(table: str, epoch: int, lag_ms: int):
    token = _REPLICA_CTX.set(
        {"table": table, "epoch": int(epoch), "lag_ms": int(lag_ms)}
    )
    try:
        yield
    finally:
        _REPLICA_CTX.reset(token)


def replica_context() -> Optional[dict]:
    return _REPLICA_CTX.get()
