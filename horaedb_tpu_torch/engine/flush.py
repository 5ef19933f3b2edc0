"""Flush: freeze memtables and dump them as time-bucketed L0 SSTs
(ref: analytic_engine/src/instance/flush_compaction.rs:199-717).

Pipeline (``FlushTask::run`` → ``dump_memtables`` in the reference),
split so writers never wait on an object-store upload:

1. FREEZE (``serial_lock``, a cheap pointer swap): switch the mutable
   memtable, snapshot the frozen list + schema/options/sampler decisions;
2. DUMP (``flush_lock`` only — writes keep committing into the fresh
   mutable memtable): gather frozen rows + per-row sequences, sort by
   (primary key, seq desc) — one vectorized lexsort over dense columns
   instead of the reference's DataFusion reorder stream
   (reorder_memtable.rs); auto-pick ``segment_duration`` on the first
   flush from the observed time span (ref: sampler.rs suggest_duration);
   split rows into aligned segment buckets and write one sorted L0 SST
   per non-empty bucket — CONCURRENTLY on the io pool (each bucket is an
   independent object; contexts are copied so ledger/span records from
   pool threads survive the hop);
3. INSTALL (``serial_lock`` again, re-checking ``dropped``/``retired``):
   append manifest edits (AddFile* + Flushed) durably, then swap the new
   files into the version and retire the flushed memtables.

``flush_lock`` serializes dumps per table (and fences ALTER + the orphan
sweep); lock order is always flush_lock -> serial_lock.

Crash safety: steps 1-2 leave orphan SSTs at worst (collected by the
open-time sweep); the version only changes after the manifest append
succeeds — data before metadata, same as before the split.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from time import perf_counter as _perf_counter

import numpy as np

from ..common_types.row_group import RowGroup
from ..utils.metrics import REGISTRY
from .manifest import AddFile, AlterOptions, AlterSchema, Flushed, MetaEdit
from .memtable import MemTable
from .options import TableOptions, UpdateMode, suggest_segment_duration
from .sst.manager import FileHandle
from .sst.writer import SstWriter, WriteOptions
from .table_data import TableData

# Registered at import so the series exist from the first scrape.
_M_FLUSH_SECONDS = REGISTRY.histogram(
    "horaedb_flush_duration_seconds", "memtable flush wall time"
)
_M_FLUSH_ROWS = REGISTRY.counter(
    "horaedb_flush_rows_total", "rows written to L0 by flush"
)
_M_FLUSH_BYTES = REGISTRY.counter(
    "horaedb_flush_bytes_total", "bytes written to L0 SSTs by flush"
)
_M_BUCKET_INFLIGHT = REGISTRY.gauge(
    "horaedb_flush_bucket_writes_inflight_total",
    "per-bucket SST writes currently in flight across all flushes",
)


@dataclass
class FlushResult:
    files_added: int
    rows_flushed: int
    flushed_sequence: int


@dataclass
class _FreezeSnapshot:
    """Everything the dump needs, captured under serial_lock at freeze so
    the slow phase never reads mutable table state. ``options`` is safe
    to hold whole: TableOptions is replaced, never mutated, on change."""

    memtables: list[MemTable]
    schema: object
    suggested: object  # sampler's PK reorder, or None
    options: TableOptions


class Flusher:
    def __init__(self, table: TableData) -> None:
        self.table = table

    def flush(self) -> FlushResult:
        """Flush everything currently in memory.

        Dumps are serialized per table by ``flush_lock``; ``serial_lock``
        is held only for the freeze and install steps, so writers commit
        into the fresh mutable memtable while the dump runs."""
        table = self.table
        with table.flush_lock:
            with table.serial_lock:
                if table.dropped or table.retired:
                    return FlushResult(0, 0, table.version.flushed_sequence)
                table.version.switch_memtable()
                frozen = table.version.immutables()
                if not frozen:
                    return FlushResult(0, 0, table.version.flushed_sequence)
                snap = _FreezeSnapshot(
                    memtables=frozen,
                    schema=table.schema,
                    suggested=(
                        table.pk_sampler.suggest(table.schema)
                        if table.pk_sampler is not None
                        else None
                    ),
                    options=table.options,
                )
            from ..utils.events import record_event
            from ..utils.tracectx import owned_trace

            record_event(
                "flush_freeze", table=table.name, memtables=len(frozen)
            )
            t0 = _perf_counter()
            try:
                # an OWNED trace round (profile route=flush): the dump's
                # spans (SST encode, store puts) fold into obs/profile
                # through the same machinery queries use
                with owned_trace(
                    "flush", route="flush", shape=table.name,
                    table=table.name,
                ) as sp:
                    result = self._dump_memtables(snap)
                    sp.set(rows=result.rows_flushed, files=result.files_added)
            except Exception as e:
                record_event(
                    "flush_failed", table=table.name, error=str(e)[:200]
                )
                raise
            _M_FLUSH_SECONDS.observe(_perf_counter() - t0)
            _M_FLUSH_ROWS.inc(result.rows_flushed)
        # Outside the locks: retiring memtables freed immutable budget —
        # wake any writer stalled on the backpressure bound.
        table.notify_flush_waiters()
        return result

    def _dump_memtables(self, snap: _FreezeSnapshot) -> FlushResult:
        table = self.table
        memtables = snap.memtables
        parts: list[RowGroup] = []
        seqs: list[np.ndarray] = []
        max_seq = 0
        for m in memtables:
            rows, seq = m.scan()
            if len(rows):
                if (
                    rows.schema.version != snap.schema.version
                    and snap.schema.same_columns(rows.schema)
                ):
                    # A memtable frozen across a metadata-only schema bump
                    # (the first-flush PK reorder): same columns, same
                    # uniqueness — rewrap under the snapshot schema so the
                    # concat below sees one schema.
                    rows = RowGroup(snap.schema, rows.columns, rows.validity)
                parts.append(rows)
                seqs.append(seq)
            max_seq = max(max_seq, m.last_sequence)
        if not parts:
            with table.serial_lock:
                if not (table.dropped or table.retired):
                    table.version.retire_immutables(
                        [m.id for m in memtables], max_seq
                    )
            return FlushResult(0, 0, table.version.flushed_sequence)

        all_rows = RowGroup.concat(parts) if len(parts) > 1 else parts[0]
        all_seq = np.concatenate(seqs)

        # First flush: apply the sampled primary-key order to the SORT and
        # the manifest edit NOW, but install it into the live version only
        # after the manifest append succeeds (below) — a failed flush must
        # not leave the table claiming a sort order its data and manifest
        # don't have (sampler.rs suggestion applied at
        # table/version.rs:670-674). The reorder changes only sort
        # priority — same columns, same uniqueness — so rows re-wrap
        # under the new schema as-is.
        suggested = snap.suggested
        if suggested is not None:
            all_rows = RowGroup(suggested, all_rows.columns, all_rows.validity)

        # Auto-pick segment duration on first flush (installed below,
        # under the lock, only if nothing else picked one meanwhile).
        seg_ms = snap.options.segment_duration_ms
        picked_seg = seg_ms is None
        if picked_seg:
            tr = all_rows.time_range()
            seg_ms = suggest_segment_duration(tr.exclusive_end - tr.inclusive_start)

        sorted_rows = all_rows.sorted_by_key(seq=all_seq)
        if snap.options.update_mode is UpdateMode.OVERWRITE:
            # Collapse intra-flush duplicates now so SSTs are dup-free runs;
            # the merge read path relies on file-granularity versioning.
            from .merge import dedup_sorted

            sorted_rows = dedup_sorted(sorted_rows)

        writer = SstWriter(
            table.store,
            WriteOptions(
                num_rows_per_row_group=snap.options.num_rows_per_row_group,
                compression=snap.options.compression,
            ),
        )

        # Segment split: bucket ids per row, then contiguous slices after a
        # stable sort by bucket (keeps key order within each bucket). File
        # ids are allocated up front (deterministic bucket -> id mapping),
        # then the independent per-bucket SSTs write concurrently.
        ts = sorted_rows.timestamps
        buckets = ts // seg_ms
        slices: list[tuple[int, RowGroup]] = []
        for b in np.unique(buckets):
            idx = np.nonzero(buckets == b)[0]
            slices.append((table.alloc_file_id(), sorted_rows.take(idx)))

        def write_one(item: tuple[int, RowGroup]):
            fid, part = item
            path = table.sst_object_path(fid)
            _M_BUCKET_INFLIGHT.inc()
            try:
                meta = writer.write(path, fid, part, max_sequence=max_seq)
            finally:
                _M_BUCKET_INFLIGHT.dec()
            return meta, path, len(part)

        if (
            len(slices) > 1
            and not threading.current_thread().name.startswith("sst-io")
        ):
            # io pool (shared with concurrent SST *fetches*), one slot per
            # bucket; contexts copied so the request ledger and any active
            # span keep accumulating from pool threads. The thread-name
            # guard keeps a flush that somehow runs ON the io pool from
            # deadlocking against its own slots.
            import contextvars

            from ..utils.runtime import io_pool

            ctxs = [contextvars.copy_context() for _ in slices]
            outs = list(
                io_pool().map(
                    lambda cw: cw[0].run(write_one, cw[1]), zip(ctxs, slices)
                )
            )
        else:
            outs = [write_one(s) for s in slices]

        file_edits: list[MetaEdit] = []
        new_handles: list[FileHandle] = []
        rows_flushed = 0
        bytes_flushed = 0
        for meta, path, n in outs:
            file_edits.append(AddFile(0, meta, path))
            new_handles.append(FileHandle(meta, path, 0))
            rows_flushed += n
            bytes_flushed += meta.size_bytes
            _M_FLUSH_BYTES.inc(meta.size_bytes)
        from ..utils.events import record_event

        record_event(
            "flush_dump", table=table.name,
            files=len(new_handles), rows=rows_flushed, bytes=int(bytes_flushed),
        )

        # INSTALL: manifest append + version swap + retire, re-checking
        # dropped/retired under the lock — a table dropped or handed off
        # mid-dump must not get fresh manifest edits (the next owner's
        # log-sequence counter would skip them while their purges
        # survive). The SSTs just written become orphans; the open-time
        # sweep collects them.
        with table.serial_lock:
            if table.dropped or table.retired:
                return FlushResult(0, 0, table.version.flushed_sequence)
            edits: list[MetaEdit] = []
            if suggested is not None:
                edits.append(AlterSchema(suggested))
            if picked_seg:
                if table.options.segment_duration_ms is None:
                    table.options = TableOptions.from_dict(
                        {**table.options.to_dict(), "segment_duration_ms": seg_ms}
                    )
                    edits.append(AlterOptions({"segment_duration_ms": seg_ms}))
                # else: an ALTER SET options raced the dump and picked its
                # own duration — keep the user's choice; our files are
                # bucketed by the sampled one, which compaction re-buckets.
            edits.extend(file_edits)
            edits.append(Flushed(max_seq))
            table.manifest.append_edits(edits)

            # Durable now: install the sampled key order and retire the
            # sampler (one-shot — it covers the first segment only).
            if suggested is not None:
                table.version.alter_schema(suggested)
            table.pk_sampler = None
            for h in new_handles:
                table.version.levels.add_file(0, h)
            table.version.retire_immutables([m.id for m in memtables], max_seq)
        record_event(
            "flush_install", table=table.name,
            files=len(new_handles), rows=rows_flushed, flushed_seq=int(max_seq),
        )
        return FlushResult(len(new_handles), rows_flushed, max_seq)
