"""Columnar memtable (ref: analytic_engine/src/memtable/).

The reference offers three memtable kinds — skiplist (row-ordered),
columnar, layered (memtable/mod.rs:193) — because its scan path wants
key-ordered row iterators. The TPU scan path wants dense column buffers, so
the native memtable here is columnar and *unordered*: appends are O(1)
chunk appends with a sequence number per row, and ordering is imposed
lazily (a device sort at flush/merge time, where it can batch). That trades
the skiplist's per-row insert cost for zero-cost ingest plus one vectorized
sort — the right trade when sorting is a TPU kernel.

Concurrency: appends take a lock (the engine already serializes writers
per table, ref: serial_executor.rs); scans snapshot the chunk list without
blocking writers.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..common_types.row_group import RowGroup
from ..common_types.schema import Schema
from ..common_types.time_range import TimeRange
from ..table_engine.predicate import Predicate


def _empty_rows(schema: Schema) -> tuple[RowGroup, np.ndarray]:
    empty = {c.name: np.empty(0, dtype=c.kind.numpy_dtype) for c in schema.columns}
    return RowGroup(schema, empty), np.empty(0, dtype=np.uint64)


def _time_filter(
    rows: RowGroup, seqs: np.ndarray, predicate: Predicate
) -> tuple[RowGroup, np.ndarray]:
    """Coarse [start, end) time-range mask shared by every memtable kind."""
    ts = rows.timestamps
    mask = (ts >= predicate.time_range.inclusive_start) & (
        ts < predicate.time_range.exclusive_end
    )
    idx = np.nonzero(mask)[0]
    return rows.take(idx), seqs[idx]


class ColumnarMemTable:
    def __init__(self, schema: Schema, id_: int = 0) -> None:
        self.schema = schema
        self.id = id_
        self._chunks: list[RowGroup] = []
        self._seq_chunks: list[np.ndarray] = []
        self._lock = threading.Lock()
        self._num_rows = 0
        self._approx_bytes = 0
        self._min_ts: Optional[int] = None
        self._max_ts: Optional[int] = None
        self._min_seq: Optional[int] = None
        self._max_seq = 0

    # ---- writes --------------------------------------------------------
    def put(self, rows: RowGroup, sequence: int) -> None:
        """Append a row group under one WAL sequence number."""
        if rows.schema.version != self.schema.version:
            raise ValueError(
                f"schema version mismatch: memtable v{self.schema.version}, "
                f"rows v{rows.schema.version}"
            )
        n = len(rows)
        if n == 0:
            return
        seq_arr = np.full(n, sequence, dtype=np.uint64)
        tr = rows.time_range()
        from ..common_types.dict_column import DictColumn

        size = 0
        for a in rows.columns.values():
            if isinstance(a, DictColumn) or a.dtype != object:
                size += a.nbytes
            else:
                size += sum(len(str(v)) for v in a)
        with self._lock:
            self._chunks.append(rows)
            self._seq_chunks.append(seq_arr)
            self._num_rows += n
            self._approx_bytes += size + seq_arr.nbytes
            self._min_ts = tr.inclusive_start if self._min_ts is None else min(self._min_ts, tr.inclusive_start)
            self._max_ts = tr.exclusive_end if self._max_ts is None else max(self._max_ts, tr.exclusive_end)
            self._min_seq = sequence if self._min_seq is None else min(self._min_seq, sequence)
            self._max_seq = max(self._max_seq, sequence)

    # ---- reads ---------------------------------------------------------
    def scan(self, predicate: Predicate | None = None) -> tuple[RowGroup, np.ndarray]:
        """Snapshot matching rows -> (rows, per-row sequence numbers).

        Rows come back in insertion order; coarse time-range filtering only
        (exact predicate evaluation belongs to the execution kernel).
        """
        with self._lock:
            chunks = list(self._chunks)
            seqs = list(self._seq_chunks)
        if not chunks:
            return _empty_rows(self.schema)
        rows = RowGroup.concat(chunks)
        seq = np.concatenate(seqs)
        if predicate is not None and not predicate.time_range.covers(self.time_range()):
            rows, seq = _time_filter(rows, seq, predicate)
        return rows, seq

    def snapshot(self) -> tuple[list["FrozenSegment"], RowGroup, np.ndarray]:
        """Uniform shape with LayeredMemTable.snapshot: no frozen
        segments, everything is 'head'."""
        rows, seq = self.scan(None)
        return [], rows, seq

    # ---- stats ---------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def approx_bytes(self) -> int:
        return self._approx_bytes

    @property
    def last_sequence(self) -> int:
        return self._max_seq

    def is_empty(self) -> bool:
        return self._num_rows == 0

    def time_range(self) -> TimeRange:
        with self._lock:
            if self._min_ts is None:
                return TimeRange.empty()
            return TimeRange(self._min_ts, self._max_ts)


# Global monotonic ids: segments stay unique across memtable switches of
# the same table, so (table, segment_id) is a safe downstream cache key.
_SEGMENT_IDS = itertools.count(1)


@dataclass(frozen=True, eq=False)  # identity semantics — ndarray fields
class FrozenSegment:
    """An immutable, pre-concatenated slab of rows inside a layered
    memtable. Immutability is the point: scans reuse the same RowGroup
    object every time, so downstream caches (e.g. the device scan cache)
    can key conversions on ``(table, segment_id)`` instead of re-reading
    rows. ``min_seq``/``max_seq`` are scalars so sequence-based skips
    (cache delta reads) never touch the row arrays."""

    segment_id: int
    rows: RowGroup
    seqs: np.ndarray
    time_range: TimeRange
    approx_bytes: int
    min_seq: int
    max_seq: int


def _dict_materialize_hinted(rows: RowGroup, table_name: str) -> RowGroup:
    """Freeze low-cardinality float columns dictionary-coded.

    The scan-cache layout tuner publishes per-(table, column) cardinality
    observations; a frozen segment built for a hinted column carries
    ``int32 codes + small vocabulary`` instead of a dense float column,
    so the device cache (and the SST writer) start from the compact form.
    Hints are advisory: any NaN or a vocabulary that outgrew the hint
    falls back to the plain column.
    """
    if not table_name:
        return rows
    from ..common_types.dict_column import DictColumn
    from ..common_types.layout_hints import low_cardinality_hint

    out = None
    for name, col in rows.columns.items():
        if isinstance(col, DictColumn) or col.dtype not in (
            np.float32,
            np.float64,
        ):
            continue
        hint = low_cardinality_hint(table_name, name)
        if not hint or np.isnan(col).any():
            continue
        values, codes = np.unique(col, return_inverse=True)
        if len(values) > max(2 * hint, 256):
            continue
        if out is None:
            out = dict(rows.columns)
        out[name] = DictColumn(codes.astype(np.int32), values)
    if out is None:
        return rows
    return RowGroup(rows.schema, out, rows.validity)


class LayeredMemTable:
    """Mutable head + immutable frozen segments
    (ref: analytic_engine/src/memtable/layered/ — a small mutable segment
    that switches to an immutable batch at ``mutable_segment_switch_
    threshold``, table_options.rs:416, lib.rs:94).

    The head is a plain ColumnarMemTable; once its approximate size
    crosses the threshold, its rows are concatenated into one
    FrozenSegment and the head restarts empty. Scans stitch segments
    (each one already a single dense RowGroup — no per-chunk concat) to
    the head's snapshot, so a big memtable re-converts only the small
    head on every query instead of the whole backlog.
    """

    def __init__(
        self,
        schema: Schema,
        id_: int = 0,
        switch_threshold: int = 4 << 20,
        table_name: str = "",
    ) -> None:
        self.schema = schema
        self.id = id_
        self.switch_threshold = max(1, int(switch_threshold))
        self.table_name = table_name
        self._lock = threading.Lock()
        self._head = ColumnarMemTable(schema)
        self._segments: list[FrozenSegment] = []

    # ---- writes --------------------------------------------------------
    def put(self, rows: RowGroup, sequence: int) -> None:
        with self._lock:
            self._head.put(rows, sequence)
            if self._head.approx_bytes >= self.switch_threshold:
                self._freeze_head_locked()

    def _freeze_head_locked(self) -> None:
        rows, seqs = self._head.scan(None)
        if len(rows) == 0:
            return
        rows = _dict_materialize_hinted(rows, self.table_name)
        self._segments.append(
            FrozenSegment(
                segment_id=next(_SEGMENT_IDS),
                rows=rows,
                seqs=seqs,
                time_range=self._head.time_range(),
                approx_bytes=self._head.approx_bytes,
                min_seq=int(seqs.min()),
                max_seq=int(seqs.max()),
            )
        )
        self._head = ColumnarMemTable(self.schema)

    # ---- reads ---------------------------------------------------------
    def scan(self, predicate: Predicate | None = None) -> tuple[RowGroup, np.ndarray]:
        """Snapshot -> (rows, seqs), insertion-ordered (segments oldest
        first, head last) so sequence-based dedup downstream is unchanged."""
        with self._lock:
            segments = list(self._segments)
            head_rows, head_seqs = self._head.scan(predicate)
        parts: list[RowGroup] = []
        seq_parts: list[np.ndarray] = []
        for seg in segments:
            rows, seqs = seg.rows, seg.seqs
            if predicate is not None and not predicate.time_range.covers(seg.time_range):
                rows, seqs = _time_filter(rows, seqs, predicate)
            if len(rows):
                parts.append(rows)
                seq_parts.append(seqs)
        if len(head_rows):
            parts.append(head_rows)
            seq_parts.append(head_seqs)
        if not parts:
            return _empty_rows(self.schema)
        if len(parts) == 1:
            return parts[0], seq_parts[0]
        return RowGroup.concat(parts), np.concatenate(seq_parts)

    def frozen_segments(self) -> list[FrozenSegment]:
        with self._lock:
            return list(self._segments)

    def snapshot(self) -> tuple[list[FrozenSegment], RowGroup, np.ndarray]:
        """Atomic (segments, head_rows, head_seqs): both sides captured
        under one lock so a concurrent head-freeze can't double-count or
        drop rows between the two reads (the delta path depends on this)."""
        with self._lock:
            head_rows, head_seqs = self._head.scan(None)
            return list(self._segments), head_rows, head_seqs

    # ---- stats ---------------------------------------------------------
    @property
    def num_rows(self) -> int:
        with self._lock:
            return self._head.num_rows + sum(len(s.rows) for s in self._segments)

    @property
    def approx_bytes(self) -> int:
        with self._lock:
            # frozen segments kept at their head-time estimate: rows are
            # the same buffers, just concatenated
            return self._head.approx_bytes + sum(
                s.approx_bytes for s in self._segments
            )

    @property
    def last_sequence(self) -> int:
        with self._lock:
            seqs = [self._head.last_sequence] + [s.max_seq for s in self._segments]
            return max(seqs)

    def is_empty(self) -> bool:
        return self.num_rows == 0

    def time_range(self) -> TimeRange:
        with self._lock:
            ranges = [s.time_range for s in self._segments]
            head_tr = self._head.time_range()
        ranges = [r for r in ranges if not r.is_empty()]
        if not head_tr.is_empty():
            ranges.append(head_tr)
        if not ranges:
            return TimeRange.empty()
        return TimeRange(
            min(r.inclusive_start for r in ranges),
            max(r.exclusive_end for r in ranges),
        )


# what flows through TableVersion / flush / the delta path
MemTable = ColumnarMemTable | LayeredMemTable


def make_memtable(
    schema: Schema, id_: int, options, table_name: str = ""
) -> "MemTable":
    """Factory honouring the table's ``memtable_type`` option."""
    if options is not None and getattr(options, "memtable_type", "columnar") == "layered":
        return LayeredMemTable(
            schema,
            id_,
            getattr(options, "mutable_segment_switch_threshold", 4 << 20),
            table_name=table_name,
        )
    return ColumnarMemTable(schema, id_)
