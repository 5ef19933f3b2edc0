"""Engine instance — the storage engine facade
(ref: analytic_engine/src/instance/mod.rs, instance/engine.rs).

Owns every open table's runtime state and implements the table lifecycle
(create/open/drop) plus the write and read entry points. WAL durability is
layered in by the caller-supplied ``WalManager`` (None = the reference's
``disable_data_wal`` semantics, setup.rs:122-127 — memtable contents are
lost on crash, SSTs are not).
"""

from __future__ import annotations

import concurrent.futures as cf
import contextvars
import threading
import time as _time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from ..common_types.row_group import RowGroup
from ..common_types.schema import Schema
from ..table_engine.predicate import Predicate
from ..utils.events import record_event
from ..utils.metrics import REGISTRY
from ..utils.object_store import ObjectStore
from ..utils.tracectx import span
from .flush import FlushResult, Flusher
from .manifest import AlterOptions, AlterSchema, Manifest
from .merge import merge_read
from .options import TableOptions
from .table_data import TableData

# Registered at import so the series exist from the first scrape.
_M_WAL_APPEND_SECONDS = REGISTRY.histogram(
    "horaedb_wal_append_duration_seconds",
    "WAL append+fsync latency per commit group (any backend)",
)
_M_WAL_APPEND_ROWS = REGISTRY.counter(
    "horaedb_wal_append_rows_total", "rows made durable through the WAL"
)
_M_WAL_REPLAY_SECONDS = REGISTRY.histogram(
    "horaedb_wal_replay_duration_seconds",
    "WAL replay wall time per table open",
)
_M_WAL_REPLAY_ROWS = REGISTRY.counter(
    "horaedb_wal_replay_rows_total", "rows re-applied from the WAL at open"
)
_M_WRITE_STALL_SECONDS = REGISTRY.histogram(
    "horaedb_write_stall_seconds",
    "time writers spent blocked on the immutable-memtable backpressure "
    "bound waiting for a background flush",
)


# Writers that must never block behind the flush machinery they observe
# (the self-monitoring recorder measuring that very flush): under this
# flag the write-stall gate sheds IMMEDIATELY with the typed retryable
# OverloadedError instead of waiting out the deadline.
_NONBLOCKING_WRITES: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "horaedb_nonblocking_writes", default=False
)


@contextmanager
def nonblocking_backpressure():
    """Writes inside this context yield to write-stall backpressure:
    at the bound they shed instantly (retryable) rather than block."""
    token = _NONBLOCKING_WRITES.set(True)
    try:
        yield
    finally:
        _NONBLOCKING_WRITES.reset(token)


def _memtable_gauge(table: TableData):
    # One labeled gauge per table, cached on the TableData — the write
    # hot path must not pay a registry lock + label render per commit.
    g = getattr(table, "_m_memtable_bytes", None)
    if g is None:
        g = REGISTRY.gauge(
            "horaedb_memtable_bytes",
            "bytes held in mutable + immutable memtables",
            labels={"table": table.name},
        )
        table._m_memtable_bytes = g
    return g


@dataclass
class EngineConfig:
    # Space-level write buffer: flush the biggest table when the sum of
    # memtable bytes passes this (ref: space.rs should_flush_space).
    space_write_buffer_size: int = 256 << 20
    # Auto-compact after flush once any segment window holds this many L0
    # files (ref: the compaction scheduler's background picking loop).
    compaction_l0_trigger: int = 4
    # Run triggered compactions on the background scheduler (the
    # reference's scheduler.rs model: writes never block on a merge).
    # False = inline after flush (deterministic; some tests want it).
    background_compaction: bool = True
    # Periodic background pick (ref: scheduler.rs's loop, not just
    # flush-triggered): a table that stops receiving writes must still
    # expire TTL data and fold accumulated L0. 0 disables.
    compaction_interval_s: float = 60.0
    # Background compaction worker pool: >1 lets multi-table compactions
    # overlap (per-table dedupe + the table serial lock prevent two
    # merges racing on one table).
    compaction_workers: int = 2
    # Pipelined flush (the reference's flush scheduler model,
    # flush_compaction.rs): the write leader freezes the memtable and
    # REQUESTS a flush; a background worker dumps it to L0 while writes
    # keep committing into the fresh mutable memtable. False = the old
    # inline flush on the write leader (deterministic; some tests want
    # it).
    background_flush: bool = True
    flush_workers: int = 2
    # Write-stall backpressure: writers block once a table holds this
    # many frozen memtables (or this many frozen bytes) awaiting flush,
    # and shed with a retryable OverloadedError after the deadline
    # (ref: RocksDB's max_write_buffer_number stall, and the admission
    # discipline of wlm/ — HTTP 503, MySQL 1040, PG 53300).
    write_stall_immutable_count: int = 8
    write_stall_immutable_bytes: int = 1 << 30
    write_stall_deadline_s: float = 30.0


class Instance:
    def __init__(
        self,
        store: ObjectStore,
        device,
        config: EngineConfig | None = None,
        wal=None,  # Optional[WalManager]; wired in engine/wal
    ) -> None:
        self.store = store
        # where every table's compactions and read merges run (the
        # connection's device; "cpu" runs the kernels' plain versions)
        self.device = torch.device(device)
        self.config = config or EngineConfig()
        self.wal = wal
        self._tables: dict[tuple[int, int], TableData] = {}
        self._lock = threading.RLock()
        self._compactions = None  # lazy CompactionScheduler
        self._flushes = None  # lazy FlushScheduler
        self._closed = False
        # WAL-replay progress for the /debug/status readiness surface:
        # plain ints mutated around each replay (reads are advisory).
        self.wal_replays_inflight = 0
        self.wal_replayed_tables = 0
        self.wal_replayed_rows = 0

    # ---- lifecycle -----------------------------------------------------
    def create_table(
        self,
        space_id: int,
        table_id: int,
        name: str,
        schema: Schema,
        options: TableOptions | None = None,
    ) -> TableData:
        options = options or TableOptions()
        with self._lock:
            key = (space_id, table_id)
            if key in self._tables:
                raise ValueError(f"table already open: {name} ({key})")
            manifest = Manifest(self.store, space_id, table_id)
            if manifest.exists():
                raise ValueError(f"table already exists in storage: {name} ({key})")
            manifest.append_edits(
                [AlterSchema(schema), AlterOptions(options.to_dict())]
            )
            table = TableData(
                space_id, table_id, name, schema, options, manifest, self.store,
                device=self.device,
            )
            self._tables[key] = table
            # No eager scheduler here: a freshly-created table has no
            # data to expire or fold; the first flush request (or a
            # recovered-table open) starts the background machinery.
            return table

    def open_table(self, space_id: int, table_id: int, name: str) -> Optional[TableData]:
        with self._lock:
            key = (space_id, table_id)
            if key in self._tables:
                return self._tables[key]
            manifest = Manifest(self.store, space_id, table_id)
            if not manifest.exists():
                return None
            state = manifest.load()
            if state.schema is None:
                return None
            options = TableOptions.from_dict(state.options)
            table = TableData(
                space_id, table_id, name, state.schema, options, manifest, self.store,
                recovered_state=state, device=self.device,
            )
            self._tables[key] = table
            if self.wal is not None:
                self._replay_wal(table)
        # Outside the instance lock: sweeping walks the table's store
        # prefix and must not serialize other table opens behind it.
        self._sweep_orphan_ssts(table)
        # A recovered table may hold TTL-expired files or trigger-level
        # L0 and never see a flush — the periodic loop must be alive.
        self._ensure_background()
        return table

    def open_table_follower(
        self, space_id: int, table_id: int, name: str
    ) -> Optional[TableData]:
        """Open a table READ-ONLY from its manifest in the shared object
        store — the follower (read-replica) serving handle.

        Differences from ``open_table``, all deliberate:
        - no WAL replay (the leader owns the WAL; replaying it here
          would double rows once the leader's flush installs them);
        - no orphan sweep (an SST the LEADER is mid-flushing looks like
          an orphan from here — sweeping would delete live data);
        - no background flush/compaction (nothing to maintain; the
          leader mutates storage, we tail its manifest);
        - the handle is fenced: writes/flushes raise, refreshes come
          from ``TableData.refresh_from_manifest``."""
        with self._lock:
            key = (space_id, table_id)
            existing = self._tables.get(key)
            if existing is not None:
                if not existing.read_only:
                    # already open as the LEADER handle: a role conflict
                    # the caller must resolve (release then reopen) — a
                    # writable handle must never be served as a follower
                    return None
                return existing
            manifest = Manifest(self.store, space_id, table_id)
            if not manifest.exists():
                return None
            state = manifest.load()
            if state.schema is None:
                return None
            options = TableOptions.from_dict(state.options)
            table = TableData(
                space_id, table_id, name, state.schema, options, manifest,
                self.store, recovered_state=state, device=self.device,
            )
            table.read_only = True
            table._recompute_watermark_locked()
            self._tables[key] = table
            return table

    def _ensure_background(self) -> None:
        if self.config.background_compaction and self.config.compaction_interval_s > 0:
            self._compaction_scheduler()

    def _make_periodic_scan(self):
        """Weakref-wrapped tick: an Instance abandoned without close()
        must be collectable — the loop closure holding a strong ``self``
        would pin the instance (tables, store) and tick forever. The
        wrapper returns False once the instance is gone, which stops the
        scheduler's loop thread."""
        import weakref

        ref = weakref.WeakMethod(self._periodic_scan)

        def scan():
            fn = ref()
            if fn is None:
                return False
            fn()
            return True

        return scan

    def _sweep_orphan_ssts(self, table: TableData) -> None:
        """Delete SST objects not tracked by the manifest.

        A crash between SST write and manifest append leaves orphans
        (flush is crash-safe BECAUSE it writes data before metadata); they
        are never read, but without a sweep they leak storage forever.

        The table is already visible in ``_tables`` when this runs, so a
        concurrent flush could be mid-write (SST persisted, manifest edit
        not yet appended). Holding ``flush_lock`` excludes DUMPS for THIS
        table and ``serial_lock`` excludes installs (both are per-table,
        so other table opens don't serialize behind the sweep), and
        listing the store before computing the tracked set means anything
        written after the listing is invisible to the sweep either way.
        """
        prefix = f"{table.space_id}/{table.table_id}/"
        with table.flush_lock, table.serial_lock:
            listed = list(self.store.list(prefix))
            levels = table.version.levels
            # Purge-queued files are referenced (a pinned read may still
            # hold them) — referenced, not orphaned.
            tracked = {h.path for h in levels.all_files()} | levels.pending_purge_paths()
            for path in listed:
                if path.endswith(".sst") and path not in tracked:
                    self.store.delete(path)

    def close_table(self, table: TableData, flush: bool = True) -> None:
        # Lock order is always flush_lock -> serial_lock -> _lock
        # (flush_table takes the table's locks); never hold _lock across
        # a flush.
        if flush:
            # wait=True drains: a queued background flush for this table
            # either runs before ours (flush_lock serializes dumps) or
            # sees ``retired`` afterwards and bails.
            self.flush_table(table)
        # Fence background maintenance before the handle is released: the
        # close-time flush above may have QUEUED a merge. A merge already
        # running holds serial_lock, so acquiring it here blocks until
        # that merge completes; one not yet started sees ``retired`` and
        # bails. Without this, a shard handover's new owner would race
        # the stale worker's manifest appends (the fuzz-seed-2 loss).
        with table.serial_lock:
            table.retired = True
        table.notify_flush_waiters()
        with self._lock:
            self._tables.pop((table.space_id, table.table_id), None)
            if self._compactions is not None:
                self._compactions.forget((table.space_id, table.table_id))
            if self._flushes is not None:
                self._flushes.forget((table.space_id, table.table_id))

    def drop_table(self, table: TableData) -> None:
        if table.read_only:
            # Follower handle: detach WITHOUT touching storage — the
            # LEADER owns the objects (a follower deleting SSTs/manifest
            # would destroy the table under the real owner).
            with table.serial_lock:
                table.dropped = True
            with self._lock:
                self._tables.pop((table.space_id, table.table_id), None)
            return
        # flush_lock first: a dump mid-flight would otherwise write SSTs
        # AFTER the store prefix is cleared — its install re-check would
        # abandon them, but a dropped table never reopens, so nothing
        # would ever sweep those orphans.
        with table.flush_lock, table.serial_lock:
            table.dropped = True
            for h in table.version.levels.all_files():
                self.store.delete(h.path)
            table.manifest.destroy()
            if self.wal is not None:
                self.wal.delete_table(table.table_id)
            # create/drop churn must not pin stale per-table series in
            # the registry (and /metrics) forever
            REGISTRY.remove("horaedb_memtable_bytes", labels={"table": table.name})
            table._m_memtable_bytes = None
            with self._lock:
                self._tables.pop((table.space_id, table.table_id), None)
                if self._compactions is not None:
                    self._compactions.forget((table.space_id, table.table_id))
                if self._flushes is not None:
                    self._flushes.forget((table.space_id, table.table_id))
        table.notify_flush_waiters()

    def open_tables(self) -> list[TableData]:
        with self._lock:
            return list(self._tables.values())

    # ---- write path ----------------------------------------------------
    def write(self, table: TableData, rows: RowGroup) -> int:
        """Durable (WAL) write into the memtable; returns the sequence.

        Concurrent same-schema writers MERGE: one writer becomes the
        leader, drains the pending queue, and commits the whole group with
        ONE WAL append/fsync and one memtable insert (ref: the
        PendingWriteQueue, table/mod.rs:147-358). Writers of other schema
        versions fail fast, exactly like the single-writer path did.
        """
        if table.dropped:
            raise ValueError(f"table dropped: {table.name}")
        if table.read_only:
            raise ValueError(
                f"table {table.name} is a read-only follower replica "
                "(writes go to the shard leader)"
            )
        if rows.schema.version != table.schema.version:
            if table.schema.same_columns(rows.schema):
                # Metadata-only difference (the sampler's first-flush PK
                # reorder bumps the version without touching columns):
                # rewrap instead of failing writers that raced the flush.
                rows = RowGroup(table.schema, rows.columns, rows.validity)
            else:
                raise ValueError(
                    f"schema mismatch: table {table.name} "
                    f"v{table.schema.version}, write v{rows.schema.version}"
                )
        entry = (rows, cf.Future())
        with table.pending_lock:
            table.pending_writes.append(entry)
            if table.writer_active:
                follower = True
            else:
                follower = False
                table.writer_active = True
        if follower:
            # group-commit follower: the wall here is the LEADER's WAL
            # fsync + memtable insert — attributed so the profile plane
            # sees coalesced-write wait, not untracked time
            with span("write_wait", follower=1):
                return entry[1].result()

        try:
            with span("write_group"):
                while True:
                    with table.pending_lock:
                        batch = table.pending_writes
                        table.pending_writes = []
                        if not batch:
                            table.writer_active = False
                            break
                    if self._commit_write_group(table, batch):
                        # The buffer tripped: the leader REQUESTS a flush
                        # (the memtable is already frozen when background
                        # flush is on) and keeps draining — writes commit
                        # into the fresh mutable memtable while the dump
                        # runs on the flush scheduler. Inline mode flushes
                        # here, exactly as before.
                        self.request_flush(table)
        except BaseException:
            with table.pending_lock:
                table.writer_active = False
            raise
        return entry[1].result()

    def _commit_write_group(self, table: TableData, batch: list) -> bool:
        """One WAL append + memtable insert per schema-version group.

        EVERY future in ``batch`` is resolved before returning — a failure
        anywhere (including merge itself) becomes that group's exception,
        never a hung follower.
        """
        groups: dict[int, list] = {}
        for rows, fut in batch:
            groups.setdefault(rows.schema.version, []).append((rows, fut))
        needs_flush = False
        for _, entries in groups.items():
            try:
                # Backpressure BEFORE taking the serial lock: when frozen
                # memtables pile past the bound, block (bounded) for the
                # background flush to catch up, then shed retryably. The
                # exception resolves this group's futures below — leaders
                # and followers both see the typed OverloadedError.
                self._stall_for_flush(table)
                merged = (
                    entries[0][0]
                    if len(entries) == 1
                    else RowGroup.concat([rows for rows, _ in entries])
                )
                with table.serial_lock:
                    if table.dropped:
                        raise ValueError(f"table dropped: {table.name}")
                    if merged.schema.version != table.schema.version:
                        if table.schema.same_columns(merged.schema):
                            # first-flush PK reorder raced the queue:
                            # layout is identical, rewrap and proceed
                            merged = RowGroup(
                                table.schema, merged.columns, merged.validity
                            )
                        else:
                            raise ValueError(
                                f"schema changed mid-write for {table.name}"
                            )
                    seq = table.alloc_sequence()
                    if self.wal is not None:
                        t0 = _time.perf_counter()
                        with span("wal_append", rows=len(merged)):
                            self.wal.append(table.table_id, seq, merged)
                        _M_WAL_APPEND_SECONDS.observe(_time.perf_counter() - t0)
                        _M_WAL_APPEND_ROWS.inc(len(merged))
                    with span("memtable_write", rows=len(merged)):
                        table.put_rows(merged, seq)
                    _memtable_gauge(table).set(
                        table.version.total_memtable_bytes()
                    )
                    if table.should_flush():
                        if self.config.background_flush:
                            # FREEZE here (a cheap pointer swap — the dump
                            # happens on the flush scheduler): the next
                            # group commits into a fresh mutable memtable
                            # immediately instead of growing this one
                            # while the flush request waits for a worker.
                            table.version.switch_memtable()
                        needs_flush = True
            except BaseException as e:
                for _, fut in entries:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            # Live-window fold rides the committed group BEFORE any of its
            # writers is acknowledged, so a refresh right after an ack
            # sees the rows, and outside the serial lock (the state layer
            # orders itself): a cheap no-op when the table holds no
            # promoted state. It never raises for a failed fold: the
            # states that missed the batch are dropped and counted there,
            # and the write succeeds.
            try:
                from ..state.livewindow import on_write as _lw_on_write

                _lw_on_write(table, merged)
            finally:
                for _, fut in entries:
                    fut.set_result(seq)
        return needs_flush

    # ---- read path -----------------------------------------------------
    def read(
        self,
        table: TableData,
        predicate: Predicate | None = None,
        projection: Optional[Sequence[str]] = None,
    ) -> RowGroup:
        predicate = predicate or Predicate.all_time()
        # The pin keeps SSTs in the view on disk even if a concurrent
        # compaction replaces them mid-read (deferred purge, sst/manager).
        with table.version.levels.read_pin():
            view = table.version.pick_read_view(predicate.time_range)
            # max(0, ...): the view and the file listing are two lock
            # acquisitions — a compaction swap between them could make
            # the difference negative, which must never decrement the
            # monotonic horaedb_query_sst_pruned_total counter.
            pruned = max(0, len(table.version.levels.all_files()) - len(view.ssts))
            if pruned:
                # ledger + enclosing scan span: files the time range let
                # the query skip entirely (the "pruned vs read" truth)
                from ..utils.querystats import record as _qs_record
                from ..utils.tracectx import annotate

                _qs_record(sst_pruned=pruned)
                annotate(sst_pruned=pruned)
            return merge_read(
                view,
                table.schema,
                predicate,
                self.store,
                table.options.update_mode,
                projection=projection,
                device=table.device,
            )

    # ---- maintenance ---------------------------------------------------
    def flush_table(
        self, table: TableData, wait: bool = True
    ) -> Optional[FlushResult]:
        """Flush ``table``. With ``wait`` (the default — tests, close and
        ALTER depend on it) the call round-trips the whole completion:
        manifest appended, version installed, WAL ``mark_flushed``
        advanced. ``wait=False`` just queues a background request.

        Background mode routes through the FlushScheduler so explicit
        flushes and write-triggered ones share one per-table queue; the
        waiter attaches to an already-queued request when one exists (its
        freeze happens at run time, so it covers everything present now).
        """
        if table.read_only:
            # Follower handle: nothing to flush (no memtable mutations);
            # a no-op result keeps close_table's drain path uniform.
            return FlushResult(0, 0, table.version.flushed_sequence)
        if self.config.background_flush:
            scheduler = self._flush_scheduler()
            if scheduler is not None:
                if not wait:
                    scheduler.request(table)
                    return None
                fut: cf.Future = cf.Future()
                scheduler.request(table, waiter=fut)
                from .maintenance_scheduler import SchedulerClosed

                try:
                    return fut.result()
                except SchedulerClosed:
                    # shutdown raced the request — run it inline; a
                    # synchronous flush must never silently not happen
                    return self._do_flush(table)
        return self._do_flush(table)

    def request_flush(self, table: TableData, urgent: bool = False) -> None:
        """Fire-and-forget flush request (the write path's trigger).
        ``urgent`` (the stall loop) bypasses failure backoff — a stalled
        writer's re-request is the only path out of the stall."""
        if table.read_only:
            return
        if self.config.background_flush:
            scheduler = self._flush_scheduler()
            if scheduler is not None:
                scheduler.request(table, urgent=urgent)
                return
        self._do_flush(table)

    def _do_flush(self, table: TableData) -> FlushResult:
        """One complete flush: dump + the completion step (WAL
        ``mark_flushed`` strictly after the manifest append inside
        ``Flusher.flush`` — data before metadata before WAL truncation)."""
        result = Flusher(table).flush()
        if self.wal is not None and result.flushed_sequence:
            self.wal.mark_flushed(table.table_id, result.flushed_sequence)
        _memtable_gauge(table).set(table.version.total_memtable_bytes())
        self._purge(table)
        self.maybe_compact(table)
        # The install step may have frozen a mid-dump mutable (first-flush
        # PK reorder freezes rows written while the dump ran) — those
        # frozen rows still need a dump of their own. A loop, not
        # recursion: sustained writers can keep freezing while we dump.
        # Always INLINE, never a re-queue: a flush_table(wait=True)
        # waiter resolving while frozen memtables are merely re-queued
        # would let close_table retire the table before the re-queued run
        # starts — and with no WAL those acknowledged rows would be gone
        # after a clean close.
        while (
            not (table.dropped or table.retired)
            and table.version.immutable_stats()[0]
        ):
            more = Flusher(table).flush()
            if self.wal is not None and more.flushed_sequence:
                self.wal.mark_flushed(table.table_id, more.flushed_sequence)
            result = FlushResult(
                result.files_added + more.files_added,
                result.rows_flushed + more.rows_flushed,
                max(result.flushed_sequence, more.flushed_sequence),
            )
        return result

    def _flush_scheduler(self):
        # An EXISTING scheduler is returned even when closed (its own
        # request() rejects safely, and the close() drain path relies on
        # reaching it); _closed only prevents lazy rebirth — a
        # resurrected worker would race the next Instance.
        with self._lock:
            if self._flushes is not None:
                return self._flushes
            if self._closed:
                return None
            from .flush_scheduler import FlushScheduler

            self._flushes = FlushScheduler(
                self._do_flush, workers=self.config.flush_workers
            )
            return self._flushes

    def _stall_for_flush(self, table: TableData) -> None:
        """Write-stall backpressure: block while the table's frozen
        memtables exceed the configured bound (count or bytes), then shed
        with the typed retryable ``OverloadedError`` the protocol layers
        already map (HTTP 503 + Retry-After, MySQL 1040, PG 53300)."""
        cfg = self.config
        if not cfg.background_flush:
            return  # inline mode: the flush runs on this thread anyway
        count, nbytes = table.version.immutable_stats()
        if count < cfg.write_stall_immutable_count and \
                nbytes < cfg.write_stall_immutable_bytes:
            return
        if _NONBLOCKING_WRITES.get():
            # A writer that must not block behind the flush it observes
            # (the self-monitoring recorder): still nudge a dump onto the
            # queue, then shed NOW — never the deadline wait.
            self.request_flush(table, urgent=True)
            from ..wlm.admission import OverloadedError

            raise OverloadedError(
                f"write stall (nonblocking): table {table.name} holds "
                f"{count} frozen memtables ({nbytes} bytes) awaiting flush",
                reason="write_stall",
                retry_after_s=1.0,
            )
        deadline = _time.monotonic() + cfg.write_stall_deadline_s
        t0 = _time.perf_counter()
        record_event(
            "write_stall_enter", table=table.name,
            immutable_count=count, immutable_bytes=int(nbytes),
        )
        outcome = "resumed"
        try:
            while True:
                if table.dropped or table.retired:
                    return  # the commit below fails with the real reason
                # ensure a dump is actually queued (deduped when one is;
                # urgent so a transient failure's backoff cannot turn a
                # blip into an unescapable deadline-long stall)
                self.request_flush(table, urgent=True)
                count, nbytes = table.version.immutable_stats()
                if count < cfg.write_stall_immutable_count and \
                        nbytes < cfg.write_stall_immutable_bytes:
                    return
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    from ..wlm.admission import OverloadedError

                    outcome = "shed"
                    raise OverloadedError(
                        f"write stall: table {table.name} holds {count} "
                        f"frozen memtables ({nbytes} bytes) awaiting flush",
                        reason="write_stall",
                        retry_after_s=1.0,
                    )
                # short slices so a missed notify (or a failed flush that
                # never retires) degrades to latency, never to a hang
                with table.stall_cond:
                    table.stall_cond.wait(min(0.25, remaining))
        finally:
            waited = _time.perf_counter() - t0
            if waited > 0.001:
                _M_WRITE_STALL_SECONDS.observe(waited)
            record_event(
                "write_stall_exit", table=table.name,
                outcome=outcome, waited_s=round(waited, 4),
            )

    def maybe_compact(self, table: TableData) -> None:
        """Request compaction when some segment window accumulated enough
        L0 runs. The merge itself runs on the background scheduler so the
        flushing writer returns immediately (ref: compaction/scheduler.rs
        — flush requests, the scheduler's worker runs)."""
        from .compaction import Compactor

        if table.read_only:
            return  # the leader owns compaction of this table's storage
        if Compactor.needs_work(table, self.config.compaction_l0_trigger):
            if self.config.background_compaction:
                scheduler = self._compaction_scheduler()
                if scheduler is not None:
                    scheduler.request(table)
                # After close: skip. The trigger condition persists in the
                # L0 file set, so the next open's first flush re-requests.
            else:
                self.compact_table(table)

    def _compaction_scheduler(self):
        # Same contract as _flush_scheduler: existing scheduler returned
        # even when closed (the flush drain may still request merges);
        # _closed only prevents lazy rebirth.
        with self._lock:
            if self._compactions is not None:
                return self._compactions
            if self._closed:
                return None
            from .compaction_scheduler import CompactionScheduler

            self._compactions = CompactionScheduler(
                self.compact_table, workers=self.config.compaction_workers
            )
            if self.config.compaction_interval_s > 0:
                self._compactions.start_periodic(
                    self.config.compaction_interval_s,
                    self._make_periodic_scan(),
                )
            return self._compactions

    def _periodic_scan(self) -> None:
        """One tick of the background picking loop: request compaction
        for any open table with trigger-level L0 or TTL-expired files."""
        from .compaction import Compactor

        scheduler = self._compactions
        if scheduler is None:
            return
        for table in self.open_tables():
            if table.dropped or table.retired or table.read_only:
                continue
            if Compactor.needs_work(table, self.config.compaction_l0_trigger):
                scheduler.request(table)

    def compact_table(self, table: TableData):
        from .compaction import Compactor

        return Compactor(table).compact()

    def compaction_stats(self) -> dict:
        """Scheduler introspection (no scheduler yet -> an idle shape)."""
        from .compaction_scheduler import CompactionScheduler

        with self._lock:
            scheduler = self._compactions
        if scheduler is None:
            return CompactionScheduler.idle_stats(closed=self._closed)
        return scheduler.stats()

    def flush_stats(self) -> dict:
        """Flush scheduler introspection for /debug/flush (same key
        schema as compaction_stats)."""
        from .maintenance_scheduler import MaintenanceScheduler

        with self._lock:
            scheduler = self._flushes
        if scheduler is None:
            return MaintenanceScheduler.idle_stats(closed=self._closed)
        return scheduler.stats()

    def is_ready(self) -> bool:
        """Cheap readiness inputs for the /health?ready=1 probe: not
        closed, no WAL replay in flight — without the O(open tables)
        walk ``status()`` pays (k8s probes fire every few seconds)."""
        return not self._closed and self.wal_replays_inflight == 0

    def status(self) -> dict:
        """One-shot node-engine status for /debug/status: open tables,
        memtable pressure, WAL-replay progress, and both background
        schedulers' queue/backoff state."""
        tables = self.open_tables()
        memtable_bytes = 0
        immutable_count = 0
        for t in tables:
            try:
                memtable_bytes += t.version.total_memtable_bytes()
                immutable_count += t.version.immutable_stats()[0]
            except Exception:
                pass  # a table closing mid-walk must not fail status
        return {
            "open_tables": len(tables),
            "memtable_bytes": int(memtable_bytes),
            "immutable_memtables": int(immutable_count),
            "wal_backend": type(self.wal).__name__ if self.wal else None,
            "wal_replay_done": self.wal_replays_inflight == 0,
            "wal_replays_inflight": self.wal_replays_inflight,
            "wal_replayed_tables": self.wal_replayed_tables,
            "wal_replayed_rows": self.wal_replayed_rows,
            "flush": self.flush_stats(),
            "compaction": self.compaction_stats(),
            "closed": self._closed,
        }

    def close(self, wait: bool = True) -> None:
        """Stop background machinery; with ``wait`` drain queued flushes
        and compactions first (neither is ever abandoned silently).
        Flushes drain BEFORE the compaction scheduler closes — a draining
        flush may still request a merge.

        Close is TERMINAL: maybe_compact / request_flush after close fall
        back to no-op / inline rather than a lazy scheduler rebirth — a
        resurrected worker would race the next Instance over the same
        manifests."""
        with self._lock:
            self._closed = True
            flushes, self._flushes = self._flushes, None
        if flushes is not None:
            flushes.close(wait=wait)
        # Detach the compaction scheduler only AFTER the flush drain: a
        # draining flush's maybe_compact must still reach it (the
        # accessors return a live scheduler even when closed — the
        # _closed check only prevents lazy rebirth).
        with self._lock:
            scheduler, self._compactions = self._compactions, None
        if scheduler is not None:
            scheduler.close(wait=wait)

    def alter_schema(self, table: TableData, schema: Schema) -> None:
        # flush_lock FIRST (never after serial_lock): ALTER fences on a
        # drained flush — an in-flight dump completes its install before
        # the schema changes, and a queued background flush that starts
        # later just dumps the post-ALTER state.
        with table.flush_lock, table.serial_lock:
            if schema.version <= table.schema.version:
                raise ValueError(
                    f"stale schema version {schema.version} <= {table.schema.version}"
                )
            # Freeze old-schema rows, flush them, then install the new
            # schema — inline (both locks are reentrantly held), so no
            # writer can interleave an old-schema row mid-ALTER.
            self._do_flush(table)
            table.version.alter_schema(schema)
            table.manifest.append_edits([AlterSchema(schema)])

    def _replay_wal(self, table: TableData) -> None:
        """Re-apply WAL entries newer than the flushed sequence.

        Batches decode with the table's CURRENT schema: rows logged before
        an ALTER come back with NULL-filled new columns (same convention
        as reading pre-ALTER SSTs).
        """
        t0 = _time.perf_counter()
        replayed = 0
        self.wal_replays_inflight += 1
        try:
            with span("wal_replay", table=table.name) as sp:
                for seq, batch in self.wal.read_from(
                    table.table_id, table.version.flushed_sequence + 1
                ):
                    rows = RowGroup.from_arrow(table.schema, batch)
                    table.put_rows(rows, seq)
                    table.set_last_sequence(seq)
                    replayed += len(rows)
                sp.set(rows=replayed)
        finally:
            self.wal_replays_inflight -= 1
        self.wal_replayed_tables += 1
        self.wal_replayed_rows += replayed
        elapsed = _time.perf_counter() - t0
        _M_WAL_REPLAY_SECONDS.observe(elapsed)
        _M_WAL_REPLAY_ROWS.inc(replayed)
        if replayed:
            record_event(
                "wal_replay", table=table.name,
                rows=replayed, seconds=round(elapsed, 4),
            )

    def _purge(self, table: TableData) -> None:
        for h in table.version.levels.drain_purge_queue():
            self.store.delete(h.path)
