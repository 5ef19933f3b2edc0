"""Engine event journal — typed, bounded, trace-linked
(ref: the reference's tracing spans around flush/compaction in
analytic_engine, and StreamBox-HBM's stance that the system's own
telemetry is just another high-rate stream worth first-class treatment).

Discrete engine lifecycle events (a flush froze a memtable, a writer hit
the stall bound, admission shed a query, a shard froze) vanish into
counters the moment they happen — an operator debugging "why was p99 bad
at 14:32" needs the *sequence*, not just the totals. ``record_event``
appends one typed entry to a bounded in-memory ring served as the
virtual table ``system.public.events`` (all three wire protocols) and at
``/debug/events``; each entry carries the active ``trace_id`` so events
cross-link to the span store (/debug/trace/{id}) and the query ledger.

Registry discipline (the same contract as the metric-family lints):
every event ``kind`` emitted anywhere must be declared in
``EVENT_KINDS`` below — ``record_event`` refuses undeclared kinds — and
each kind has an eagerly-registered ``horaedb_events_total{kind=...}``
counter and a docs/OBSERVABILITY.md row. tests/test_observability.py
enforces all of it.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Optional

from .metrics import REGISTRY

# kind -> one-line meaning (the single source of truth: the counter HELP,
# the docs table, and the lint all derive from or are checked against it).
EVENT_KINDS: dict[str, str] = {
    "flush_freeze": "a table's mutable memtable was frozen for flush",
    "flush_dump": "frozen memtables were dumped to L0 SSTs",
    "flush_install": "a flush's manifest edits + version swap installed",
    "flush_failed": "a flush raised before installing",
    "compaction": "a compaction pass merged L0 runs / dropped expired SSTs",
    "compaction_failed": "a compaction pass raised",
    "write_stall_enter": "a writer began blocking on the immutable-memtable bound",
    "write_stall_exit": "a stalled writer resumed or shed (see outcome attr)",
    "admission_shed": "admission control shed a query (queue full / deadline)",
    "quota_reject": "a tenant/table token bucket rejected a request",
    "wal_replay": "a table replayed WAL entries at open",
    "ddl_create_table": "a table was created",
    "ddl_drop_table": "a table was dropped",
    "ddl_alter_table": "a table's schema or options were altered",
    "shard_freeze": "the lease watch froze a shard (lease lapsed)",
    "shard_thaw": "a frozen shard thawed (lease renewed)",
    "self_scrape_skipped": "a self-monitoring scrape round was shed by backpressure",
    "self_retention": "self-monitoring retention dropped expired sample SSTs",
    "alert_fired": "an alert rule's series transitioned pending -> firing",
    "alert_resolved": "a firing alert series stopped matching and resolved",
    "rule_eval_failed": "a rule/rollup evaluation raised (or a round was shed)",
    "rollup_catchup": "a rollup tier advanced over a multi-bucket backlog (restart/backfill)",
    "slo_burn": "an SLO objective's fast+slow burn rates crossed the threshold",
    "slo_recovered": "a burning SLO objective's fast window came back under threshold",
    "elastic_decision": "the elastic control loop decided a round's actions (dry-run rounds journal here without acting)",
    "elastic_action": "the elastic control loop applied one guarded action (scale_up/scale_down/move/prewarm)",
    "elastic_quarantined": "the elastic circuit breaker quarantined a shard after repeated failed moves",
    "elastic_released": "an operator released a quarantined shard (horaectl elastic release)",
    "query_timeout": "a query exceeded its time budget and unwound at a checkpoint",
    "query_cancelled": "a query was cooperatively cancelled (KILL QUERY / ctl / disconnect)",
    "kernel_compile": "a device kernel shape compiled for the first time (XLA compile)",
    "decision_resolved": "an adaptive loop's journaled decision got its realized outcome (sampled per loop)",
    "loop_miscalibrated": "an adaptive loop's fast+slow calibration windows crossed the error threshold",
}

_EVENTS_FAMILY = "horaedb_events_total"

# Ring overflow is ACCOUNTED, never silent: the journal's "no seq gaps"
# invariant (tools/tenantsim asserts it from system.public.events) is
# only falsifiable if drops are visible — min(seq) - 1 must equal the
# dropped count. Sized by the [observability] event_ring knob.
_M_DROPPED = REGISTRY.counter(
    "horaedb_events_dropped_total",
    "journal entries discarded by the bounded ring (oldest-first)",
)

# Eager registration: every kind's labeled counter exists from the first
# scrape (and for the registry lint) even before the event ever fires —
# same discipline as the ledger/admission families.
_KIND_COUNTERS = {
    kind: REGISTRY.counter(
        _EVENTS_FAMILY,
        "engine lifecycle events recorded in the journal, by kind",
        labels={"kind": kind},
    )
    for kind in EVENT_KINDS
}


class EventStore:
    """Bounded ring of event entries (plain dicts — readers never race a
    live mutation). One per process, like TRACE_STORE / STATS_STORE."""

    DEFAULT_CAPACITY = 512

    def __init__(self, maxlen: int = DEFAULT_CAPACITY) -> None:
        from collections import deque

        self._ring: "deque[dict]" = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._issued = 0  # last seq handed out (survives clear())
        self.dropped = 0

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def resize(self, maxlen: int) -> None:
        """Re-bound the ring ([observability] event_ring). Shrinking
        discards oldest-first and ACCOUNTS the discards like any other
        overflow; growing keeps everything."""
        from collections import deque

        maxlen = max(1, int(maxlen))
        with self._lock:
            if maxlen == self._ring.maxlen:
                return
            old = list(self._ring)
            cut = max(0, len(old) - maxlen)
            if cut:
                self.dropped += cut
                _M_DROPPED.inc(cut)
            self._ring = deque(old[cut:], maxlen=maxlen)

    def record(self, entry: dict) -> dict:
        with self._lock:
            entry["seq"] = self._issued = next(self._seq)
            if len(self._ring) == self._ring.maxlen:
                # deque(maxlen) evicts silently; the journal must not —
                # an unaccounted drop would make a seq gap in the ring
                # indistinguishable from a lost event
                self.dropped += 1
                _M_DROPPED.inc()
            self._ring.append(entry)
        return entry

    def stats(self) -> dict:
        # one consistent snapshot: dropped/issued read OUTSIDE the lock
        # could tear against a concurrent evicting record(), breaking the
        # documented `first_seq - 1 == dropped` invariant readers check
        with self._lock:
            size = len(self._ring)
            first = self._ring[0]["seq"] if size else 0
            last = self._ring[-1]["seq"] if size else 0
            dropped = self.dropped
            issued = self._issued
        return {
            "capacity": self.capacity,
            "size": size,
            "dropped": dropped,
            "first_seq": first,
            "last_seq": last,
            # last seq ever handed out — unlike last_seq this survives
            # clear(), so drop accounting across a clear stays exact
            "issued": issued,
        }

    def list(
        self, kind: Optional[str] = None, limit: Optional[int] = None
    ) -> list[dict]:
        """Oldest-first snapshot, optionally filtered by kind and tailed
        to the newest ``limit`` entries."""
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        if limit is not None:
            # 0 means zero entries; negative is clamped to 0, never
            # "no limit" (out[-0:] would return the whole ring)
            out = out[-limit:] if limit > 0 else []
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


EVENT_STORE = EventStore()


def record_event(kind: str, table: Optional[str] = None, **attrs: Any) -> dict:
    """Append one typed event to the journal (and bump its counter).

    ``kind`` must be declared in ``EVENT_KINDS`` — an undeclared kind is
    a programming error and fails loudly HERE, at the emit site, instead
    of silently minting a new category no dashboard knows about. The
    active trace/request id (utils/tracectx) rides along so the event
    links back to the request's span tree and ledger; emit sites on
    background threads get it when the scheduler copied the requester's
    context onto the worker.
    """
    counter = _KIND_COUNTERS.get(kind)
    if counter is None:
        raise ValueError(
            f"undeclared event kind {kind!r}: add it to "
            "horaedb_tpu_torch.utils.events.EVENT_KINDS (and document it)"
        )
    counter.inc()
    from .tracectx import get_request_id

    entry = {
        "timestamp": int(time.time() * 1000),
        "kind": kind,
        "table": table or "",
        "trace_id": get_request_id(),
        "attrs": attrs,
    }
    return EVENT_STORE.record(entry)


def render_attrs(attrs: dict) -> str:
    """Stable one-string rendering of an event's attrs for the SQL
    column (JSON, sorted keys; non-serializable values become strings)."""
    try:
        return json.dumps(attrs, sort_keys=True, default=str)
    except (TypeError, ValueError):
        return str(attrs)
