"""Per-table runtime state (ref: analytic_engine/src/table/data.rs).

Owns everything one table needs at runtime: schema/options, the MVCC
version, the manifest, id allocation, and the single-writer discipline
(one lock per table serializes write/flush/alter — ref: the per-table
``TableOpSerialExecutor``, instance/serial_executor.rs:78-143).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..common_types.row_group import RowGroup
from ..common_types.schema import Schema
from ..utils.object_store import ObjectStore
from .manifest import AlterOptions, AlterSchema, Manifest, TableManifestState
from .options import TableOptions
from .sst.meta import sst_path
from .version import TableVersion


class TableData:
    def __init__(
        self,
        space_id: int,
        table_id: int,
        name: str,
        schema: Schema,
        options: TableOptions,
        manifest: Manifest,
        store: ObjectStore,
        recovered_state: Optional[TableManifestState] = None,
    ) -> None:
        self.space_id = space_id
        self.table_id = table_id
        self.name = name
        self.options = options
        self.manifest = manifest
        self.store = store
        self.serial_lock = threading.RLock()  # single-writer per table
        # Serializes the SLOW flush phases (dump + install) plus ALTER and
        # the orphan sweep, WITHOUT blocking writers: flush takes
        # serial_lock only to freeze the memtable and to install the
        # result. Lock order is always flush_lock -> serial_lock; never
        # acquire flush_lock while holding serial_lock (except reentrantly
        # on the same thread — ALTER holds both and runs its drain-flush
        # inline).
        self.flush_lock = threading.RLock()
        # Write-stall backpressure: writers block here when frozen
        # memtables pile past the configured bound; flush completion (and
        # drop/retire) notify. Waits also use short timeout slices, so a
        # missed notify degrades to latency, never to a hang.
        self.stall_cond = threading.Condition(threading.Lock())
        # Pending-write queue: concurrent writers merge into one WAL batch
        # (ref: table/mod.rs:147-358 PendingWriteQueue).
        self.pending_lock = threading.Lock()
        self.pending_writes: list = []
        self.writer_active = False

        if recovered_state is not None:
            self.version = TableVersion(
                schema, recovered_state.levels, options=options, table_name=name
            )
            self.version.flushed_sequence = recovered_state.flushed_sequence
            self._next_file_id = recovered_state.next_file_id
            self._last_sequence = max(
                recovered_state.flushed_sequence, recovered_state.levels.max_sequence()
            )
            self.pk_sampler = None  # sampling covers the FIRST segment only
        else:
            self.version = TableVersion(schema, options=options, table_name=name)
            self._next_file_id = 1
            self._last_sequence = 0
            # Brand-new table: sample key cardinalities until first flush
            # picks the pruning-friendly sort order (sampler.rs:271).
            from .sampler import PrimaryKeySampler

            sampler = PrimaryKeySampler(schema)
            self.pk_sampler = sampler if sampler.has_candidates else None
        self.dropped = False
        # Set (under serial_lock) when this handle is released without a
        # drop — close_table / shard handover. A background merge queued
        # against a retired handle must not run: the next owner appends
        # manifest edits with its own log-sequence counter, and a stale
        # writer's edits would be skipped on load while its purges
        # survive (referenced-SST loss).
        self.retired = False
        # Follower (read-replica) handle: serves reads from the LEADER's
        # manifest state, refreshed by refresh_from_manifest(). Writes,
        # flushes, compactions, orphan sweeps and object deletions are
        # all fenced off — the leader owns every mutation of this
        # table's storage, including purges.
        self.read_only = False
        self._watermark_ms = 0

    # ---- follower (read-replica) support --------------------------------
    def follower_watermark_ms(self) -> int:
        """Freshness watermark of a follower handle: the newest data
        timestamp covered by INSTALLED (manifest-durable) SSTs — "last
        installed flush". Rows newer than this live only in the leader's
        memtable and must be served by the leader."""
        return self._watermark_ms

    def _recompute_watermark_locked(self) -> None:
        files = self.version.levels.all_files()
        self._watermark_ms = max(
            (h.time_range.exclusive_end for h in files), default=0
        )

    def refresh_from_manifest(self) -> bool:
        """Tail the leader's manifest: load the current state from the
        shared object store and install any file/schema/options delta
        into this read-only handle's version. Returns True when anything
        changed.

        Replaced files are NOT deleted here — the purge queue is drained
        and DISCARDED: the leader owns object deletion (its compaction
        already deletes swapped-out SSTs from the shared store; a
        follower deleting them too would race the leader's deferred
        purge discipline)."""
        if not self.read_only:
            raise RuntimeError(
                f"refresh_from_manifest on a non-follower handle: {self.name}"
            )
        state = self.manifest.load()
        changed = False
        with self.serial_lock:
            levels = self.version.levels
            current = {(h.level, h.file_id): h for h in levels.all_files()}
            fresh = {(h.level, h.file_id): h for h in state.levels.all_files()}
            adds = [
                (lvl, h)
                for (lvl, _fid), h in fresh.items()
                if (lvl, _fid) not in current
            ]
            removes = [k for k in current if k not in fresh]
            if adds or removes:
                levels.swap_files(adds, removes)
                # Discard — never delete — objects the leader swapped out.
                levels.drain_purge_queue()
                changed = True
            if state.flushed_sequence > self.version.flushed_sequence:
                self.version.flushed_sequence = state.flushed_sequence
                changed = True
            if (state.schema is not None
                    and state.schema.version > self.schema.version):
                self.version.alter_schema(state.schema)
                changed = True
            new_opts = TableOptions.from_dict(state.options)
            if new_opts.to_dict() != self.options.to_dict():
                self.options = new_opts
                self.version.set_options(new_opts)
            self._recompute_watermark_locked()
        return changed

    # ---- id / sequence allocation -------------------------------------
    def alloc_file_id(self) -> int:
        with self.serial_lock:
            fid = self._next_file_id
            self._next_file_id += 1
            return fid

    def alloc_sequence(self) -> int:
        with self.serial_lock:
            self._last_sequence += 1
            return self._last_sequence

    @property
    def last_sequence(self) -> int:
        return self._last_sequence

    def set_last_sequence(self, seq: int) -> None:
        """WAL replay fast-forwards the sequence counter."""
        with self.serial_lock:
            self._last_sequence = max(self._last_sequence, seq)

    # ---- schema --------------------------------------------------------
    @property
    def schema(self) -> Schema:
        return self.version.schema

    def sst_object_path(self, file_id: int) -> str:
        return sst_path(self.space_id, self.table_id, file_id)

    # ---- write ---------------------------------------------------------
    def put_rows(self, rows: RowGroup, sequence: int) -> None:
        if self.pk_sampler is not None:
            self.pk_sampler.collect(rows)
        self.version.mutable.put(rows, sequence)

    def should_flush(self) -> bool:
        return self.version.mutable_bytes() >= self.options.write_buffer_size

    def notify_flush_waiters(self) -> None:
        """Wake writers stalled on the immutable-memtable bound (flush
        completion retired memtables, or drop/retire made waiting moot)."""
        with self.stall_cond:
            self.stall_cond.notify_all()

    def metrics(self) -> dict:
        return {
            "table": self.name,
            "memtable_bytes": self.version.total_memtable_bytes(),
            "num_ssts": len(self.version.levels.all_files()),
            "sst_bytes": self.version.levels.total_size_bytes(),
            "last_sequence": self._last_sequence,
            "flushed_sequence": self.version.flushed_sequence,
        }
