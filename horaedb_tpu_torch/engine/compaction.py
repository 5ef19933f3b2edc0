"""Compaction: L0 -> L1 with a merge-dedup sort
(ref: analytic_engine/src/compaction/{mod,picker,scheduler}.rs and
runner/local_runner.rs).

Pickers (host-side policy, same two strategies as the reference):

- ``TimeWindowPicker`` (default, picker.rs:498): bucket L0 files by aligned
  segment window; any window with >1 file (or any L0 file overlapping an
  L1 file in its window) compacts into that window's single L1 run.
- ``SizeTieredPicker`` (picker.rs:211): within a window, group files of
  similar size; compact groups of >= min_threshold files.

The runner replaces the reference's BinaryHeap merge loop with one sort:
concatenate the input runs, one host lexsort over (tsid, ts, seq desc),
shift-compare dedup mask, gather of payload columns, write one L1 SST per
window. The sort moves to a device kernel when merge-dedup is ported.
TTL-expired files are dropped without rewriting (ref: sst/manager.rs:100-118).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..common_types.row_group import RowGroup
from ..common_types.time_range import TimeRange
from .manifest import AddFile, MetaEdit, RemoveFile
from .merge import dedup_keep_mask
from .options import UpdateMode
from .sst.manager import FileHandle
from .sst.reader import SstReader
from .sst.writer import SstWriter, WriteOptions
from .table_data import TableData
from ..utils.metrics import REGISTRY

# Registered at import so the series exist from the first scrape.
_M_COMPACT_SECONDS = REGISTRY.histogram(
    "horaedb_compaction_duration_seconds",
    "wall time of one table compaction pass (tasks > 0)",
)
_M_COMPACT_TASKS = REGISTRY.counter(
    "horaedb_compaction_tasks_total", "compaction merge tasks run"
)
_M_COMPACT_ROWS = REGISTRY.counter(
    "horaedb_compaction_rows_written_total",
    "rows written to merged output SSTs",
)
_M_COMPACT_IN_BYTES = REGISTRY.counter(
    "horaedb_compaction_input_bytes_total",
    "bytes of input SSTs consumed by compaction merges",
)
_M_COMPACT_OUT_BYTES = REGISTRY.counter(
    "horaedb_compaction_output_bytes_total",
    "bytes of merged output SSTs written by compaction",
)
_M_COMPACT_INFLIGHT = REGISTRY.gauge(
    "horaedb_compaction_inflight_total",
    "table compaction passes currently running",
)


@dataclass(frozen=True)
class CompactionTask:
    """One unit of work: merge ``inputs`` into one L1 SST for ``window``."""

    window: TimeRange
    inputs: tuple[FileHandle, ...]  # L0 + overlapping L1

    @property
    def total_bytes(self) -> int:
        return sum(h.meta.size_bytes for h in self.inputs)


@dataclass
class _StagedTask:
    """A merged-but-not-installed task: outputs finalized, uploads in
    flight on the io pool, metadata untouched."""

    task: CompactionTask
    outputs: list  # [(SstMeta, path)] in window order
    upload_futs: list  # concurrent.futures for the in-flight puts


@dataclass
class CompactionResult:
    tasks_run: int = 0
    files_removed: int = 0
    files_added: int = 0
    rows_written: int = 0
    expired_dropped: int = 0


# ---- pickers -----------------------------------------------------------


def bucket_by_window(
    files: list[FileHandle], seg_ms: int
) -> dict[int, list[FileHandle]]:
    """Group files by the aligned segment window of their start timestamp.

    THE window-assignment rule — the auto-compaction trigger
    (instance.maybe_compact) and both pickers must agree on it.
    """
    windows: dict[int, list[FileHandle]] = {}
    for h in files:
        start = (h.time_range.inclusive_start // seg_ms) * seg_ms
        windows.setdefault(start, []).append(h)
    return windows


class TimeWindowPicker:
    """Default picker: compact every window where L0 has anything to fold."""

    def pick(self, table: TableData) -> list[CompactionTask]:
        seg_ms = table.options.segment_duration_ms
        if not seg_ms:
            return []
        levels = table.version.levels
        l0 = levels.files_at(0)
        l1 = levels.files_at(1)
        if not l0:
            return []
        tasks = []
        for start, files in sorted(bucket_by_window(l0, seg_ms).items()):
            window = TimeRange(start, start + seg_ms)
            overlapping_l1 = [h for h in l1 if h.time_range.overlaps(window)]
            # A single L0 run with no L1 partner needs no rewrite.
            if len(files) + len(overlapping_l1) < 2:
                continue
            tasks.append(CompactionTask(window, tuple(files + overlapping_l1)))
        return tasks


class SizeTieredPicker:
    """Similar-size grouping within a window (ref picker.rs:211).

    SOUNDNESS CONSTRAINT: dedup resolves conflicting keys by FILE
    max_sequence (merge.py), so a merged group must be CONTIGUOUS in the
    sequence order of all files in the window — merging {seq 10, 40, 50}
    while seq 20 stays behind would stamp the old seq-10 rows with
    max_sequence 50 and resurrect stale values. Files are therefore walked
    in max_sequence order (L1 included) and groups only ever span a
    contiguous seq range; size similarity decides where groups break.
    """

    def __init__(self, min_threshold: int = 4, bucket_low: float = 0.5, bucket_high: float = 1.5):
        self.min_threshold = min_threshold
        self.bucket_low = bucket_low
        self.bucket_high = bucket_high

    def pick(self, table: TableData) -> list[CompactionTask]:
        seg_ms = table.options.segment_duration_ms
        if not seg_ms:
            return []
        levels = table.version.levels
        l0 = levels.files_at(0)
        l1 = levels.files_at(1)
        if not l0:
            return []
        tasks = []
        for start, files in sorted(bucket_by_window(l0, seg_ms).items()):
            window = TimeRange(start, start + seg_ms)
            in_window = files + [h for h in l1 if h.time_range.overlaps(window)]
            in_window.sort(key=lambda h: h.meta.max_sequence)
            group: list[FileHandle] = []
            for h in in_window:
                if not group:
                    group = [h]
                    continue
                avg = sum(g.meta.size_bytes for g in group) / len(group)
                if self.bucket_low * avg <= h.meta.size_bytes <= self.bucket_high * avg:
                    group.append(h)
                else:
                    if len(group) >= self.min_threshold:
                        tasks.append(CompactionTask(window, tuple(group)))
                    group = [h]
            if len(group) >= self.min_threshold:
                tasks.append(CompactionTask(window, tuple(group)))
        return tasks


def make_picker(strategy: str):
    if strategy == "size_tiered":
        return SizeTieredPicker()
    return TimeWindowPicker()


# ---- runner ------------------------------------------------------------


class Compactor:
    def __init__(self, table: TableData) -> None:
        self.table = table

    def compact(self, now_ms: int | None = None) -> CompactionResult:
        """Pick + run all pending compactions for this table (serialized)."""
        table = self.table
        result = CompactionResult()
        with table.serial_lock:
            if table.dropped or table.retired:
                # A background-scheduled compaction may fire after DROP
                # TABLE (files are gone) or after close_table/shard
                # handover retired the handle (the next owner's manifest
                # counter must not race a stale writer's).
                return result
            self._drop_expired(result, now_ms)
            picker = make_picker(table.options.compaction_strategy)
            # A file can land in two picked tasks (an L1 run spans several
            # windows after ALTER shrank segment_duration). Running both
            # would duplicate its rows across two L1 outputs and emit the
            # RemoveFile edit twice — skip any task touching an already
            # consumed input and RE-PICK until a pass completes without
            # skips (nothing else schedules a retry on an idle table).
            from ..utils.tracectx import owned_trace

            t0 = time.perf_counter()
            _M_COMPACT_INFLIGHT.inc()
            try:
                # an OWNED trace round (profile route=compaction): merge
                # and upload spans fold into obs/profile through the
                # same machinery queries use
                with owned_trace(
                    "compaction", route="compaction", shape=table.name,
                    table=table.name,
                ) as sp:
                    while True:
                        consumed: set[tuple[int, int]] = set()
                        skipped = False
                        # One-deep task pipeline: task i's output-SST
                        # uploads run on the io pool while task i+1's
                        # merge runs — the same dump/install
                        # overlap the flush path already has. Install
                        # (manifest append + version swap) stays on THIS
                        # thread, in task order, after uploads complete
                        # (data before metadata, as ever).
                        pending = None
                        try:
                            for task in picker.pick(table):
                                keys = {
                                    (h.level, h.file_id) for h in task.inputs
                                }
                                if keys & consumed:
                                    skipped = True
                                    continue
                                _M_COMPACT_IN_BYTES.inc(task.total_bytes)
                                staged = self._stage_task(task)
                                prev, pending = pending, None
                                if prev is not None:
                                    # if THIS install fails, `staged`'s
                                    # uploaded outputs become orphans the
                                    # open-time sweep collects — never a
                                    # double install (pending is cleared
                                    # before the attempt)
                                    self._install_task(prev, result)
                                pending = staged
                                consumed |= keys
                                result.tasks_run += 1
                        finally:
                            if pending is not None:
                                self._install_task(pending, result)
                        if not (skipped and consumed):
                            break
                    sp.set(tasks=result.tasks_run, rows=result.rows_written)
            except Exception as e:
                from ..utils.events import record_event

                record_event(
                    "compaction_failed", table=table.name, error=str(e)[:200]
                )
                raise
            finally:
                _M_COMPACT_INFLIGHT.dec()
            if result.tasks_run:
                _M_COMPACT_SECONDS.observe(time.perf_counter() - t0)
                _M_COMPACT_TASKS.inc(result.tasks_run)
                _M_COMPACT_ROWS.inc(result.rows_written)
            if result.tasks_run or result.expired_dropped:
                from ..utils.events import record_event

                record_event(
                    "compaction", table=table.name,
                    tasks=result.tasks_run, rows=result.rows_written,
                    expired_dropped=result.expired_dropped,
                )
        return result

    @staticmethod
    def needs_work(table: TableData, l0_trigger: int, now_ms: int | None = None) -> bool:
        """The ONE trigger predicate, shared by the flush path
        (maybe_compact) and the periodic scheduler loop (ref:
        scheduler.rs's background picking — flushless tables must still
        expire TTL data and fold L0). True when the trigger-level L0
        gate passes AND the table's actual picker would emit a task —
        gating on file count alone would re-request a size_tiered table
        whose files never group, running a futile pass every tick."""
        seg_ms = table.options.segment_duration_ms
        if seg_ms:
            windows = bucket_by_window(table.version.levels.files_at(0), seg_ms)
            if (
                windows
                and max(len(v) for v in windows.values()) >= l0_trigger
                and make_picker(table.options.compaction_strategy).pick(table)
            ):
                return True
        if table.options.enable_ttl:
            now = now_ms if now_ms is not None else int(time.time() * 1000)
            if table.version.levels.expired_files(now, table.options.ttl_ms):
                return True
        return False

    def _drop_expired(self, result: CompactionResult, now_ms: int | None) -> None:
        table = self.table
        if not table.options.enable_ttl:
            return
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        expired = table.version.levels.expired_files(now, table.options.ttl_ms)
        if not expired:
            return
        edits: list[MetaEdit] = [RemoveFile(h.level, h.file_id) for h in expired]
        table.manifest.append_edits(edits)
        for h in expired:
            table.version.levels.remove_files(h.level, [h.file_id])
        result.expired_dropped += len(expired)

    def _stage_task(self, task: CompactionTask) -> "_StagedTask":
        """Read + merge one task's inputs into finalized per-window SSTs
        and LAUNCH their uploads on the io pool. No metadata changes —
        the caller installs later (``_install_task``), typically after
        the NEXT task's merge has started, so uploads
        overlap merge compute the way flush's dump/install already do."""
        table = self.table
        schema = table.schema

        parts: list[RowGroup] = []
        versions: list[np.ndarray] = []
        max_seq = 0
        for h in task.inputs:
            rows = SstReader(table.store, h.path).read(schema)
            if len(rows):
                parts.append(rows)
                versions.append(
                    np.full(len(rows), h.meta.max_sequence, dtype=np.uint64)
                )
            max_seq = max(max_seq, h.meta.max_sequence)
        finalized: list[tuple] = []  # (writer, meta, raw)
        if parts:
            from .sst.writer import SstStreamWriter

            opts = WriteOptions(
                num_rows_per_row_group=table.options.num_rows_per_row_group,
                compression=table.options.compression,
            )
            # One output per segment window. An input (an L1 run written
            # before ALTER shrank segment_duration) may span several
            # current windows; folding its cross-window rows into ONE
            # output stamped with the task-wide max sequence would let a
            # stale version beat a genuinely newer row when the other
            # window compacts later. Splitting by window and stamping each
            # output with the max sequence of ITS OWN rows keeps
            # file-granularity versioning exact.
            #
            # The merge STREAMS: _merge_stream yields key-ordered parts
            # and each part's window slices append to that window's
            # incremental parquet writer immediately.
            writers: dict[int, SstStreamWriter] = {}
            for m_rows, m_seq in self._merge_stream(parts, versions):
                for w_start, w_rows, w_seq in self._split_by_window(
                    m_rows, m_seq
                ):
                    w = writers.get(w_start)
                    if w is None:
                        fid = table.alloc_file_id()
                        w = SstStreamWriter(
                            table.store, table.sst_object_path(fid), fid, opts
                        )
                        writers[w_start] = w
                    w.append(w_rows, max_sequence=int(w_seq.max()))
            for _, w in sorted(writers.items()):
                out = w.finalize()
                if out is not None:
                    finalized.append((w, *out))
        futs: list = []
        if finalized and not threading.current_thread().name.startswith(
            "sst-io"
        ):
            # io pool (shared with SST fetches and flush bucket writes):
            # every window output uploads concurrently, and the whole
            # batch overlaps the NEXT task's merge. Contexts copied so
            # span/ledger records survive the hop; the thread-name guard
            # keeps a compaction somehow running ON the pool from
            # deadlocking against its own slots.
            import contextvars

            from ..utils.runtime import io_pool

            for w, _meta, raw in finalized:
                ctx = contextvars.copy_context()
                futs.append(io_pool().submit(ctx.run, w.upload, raw))
        else:
            for w, _meta, raw in finalized:
                w.upload(raw)
        return _StagedTask(
            task=task,
            outputs=[(meta, w.path) for w, meta, _raw in finalized],
            upload_futs=futs,
        )

    def _install_task(
        self, staged: "_StagedTask", result: CompactionResult
    ) -> None:
        """Complete one staged task: wait out its uploads (data before
        metadata — an upload failure aborts BEFORE any manifest edit),
        append the manifest edits, and swap the file sets atomically."""
        table = self.table
        for f in staged.upload_futs:
            f.result()
        edits: list[MetaEdit] = []
        new_handles: list[FileHandle] = []
        for meta, path in staged.outputs:
            edits.append(AddFile(1, meta, path))
            new_handles.append(FileHandle(meta, path, 1))
            result.rows_written += meta.num_rows
            _M_COMPACT_OUT_BYTES.inc(meta.size_bytes)
        for h in staged.task.inputs:
            edits.append(RemoveFile(h.level, h.file_id))
        table.manifest.append_edits(edits)

        # One atomic swap: readers (which pin but don't take serial_lock)
        # must never see the L1 output AND the L0 inputs in one view.
        table.version.levels.swap_files(
            [(1, nh) for nh in new_handles],
            [(h.level, h.file_id) for h in staged.task.inputs],
        )
        result.files_added += len(new_handles)
        result.files_removed += len(staged.task.inputs)
        # Purge replaced objects.
        for h in table.version.levels.drain_purge_queue():
            table.store.delete(h.path)

    def _split_by_window(
        self, rows: RowGroup, seq: np.ndarray
    ) -> list[tuple[int, RowGroup, np.ndarray]]:
        """Bucket merged output rows by aligned segment window ->
        (window_start, rows, seq) per window."""
        seg_ms = self.table.options.segment_duration_ms
        ts = rows.timestamps
        if not seg_ms or len(rows) == 0:
            start = int(ts[0] // seg_ms * seg_ms) if seg_ms and len(rows) else 0
            return [(start, rows, seq)]
        starts = (ts // seg_ms) * seg_ms
        uniq = np.unique(starts)
        if len(uniq) == 1:
            return [(int(uniq[0]), rows, seq)]
        out = []
        for s in uniq:
            idx = np.nonzero(starts == s)[0]
            out.append((int(s), rows.take(idx), seq[idx]))
        return out

    def _merge_stream(self, parts: list[RowGroup], versions: list[np.ndarray]):
        """Yield key-ordered merged (rows, seq) parts: one host sort on
        (primary key, seq desc) plus the keep-first dedup mask on
        OVERWRITE tables. Returns each surviving row's input-file
        sequence (needed for per-window output stamping)."""
        rows = RowGroup.concat(parts) if len(parts) > 1 else parts[0]
        seq = np.concatenate(versions)
        order = rows.key_sort_permutation(seq=seq)
        srt, srt_seq = rows.take(order), seq[order]
        if self.table.options.update_mode is not UpdateMode.OVERWRITE:
            yield srt, srt_seq
            return
        keep = dedup_keep_mask(srt)
        yield srt.filter(keep), srt_seq[keep]
