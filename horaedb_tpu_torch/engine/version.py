"""Table MVCC version (ref: analytic_engine/src/table/version.rs).

Tracks the live data layout of one table:

    mutable memtable  ->  immutable memtables  ->  L0 SSTs  ->  L1 SSTs

Reads pick a consistent view (every container overlapping the query's time
range); flush freezes the mutable memtable and later swaps frozen memtables
for L0 files; compaction swaps L0 groups for L1 files. All transitions are
small locked pointer swaps — data movement happens elsewhere.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass

from ..common_types.schema import Schema
from ..common_types.time_range import TimeRange
from .memtable import MemTable, make_memtable
from .sst.manager import FileHandle, LevelsController


@dataclass(frozen=True)
class ReadView:
    """A consistent snapshot for one scan."""

    memtables: tuple[MemTable, ...]  # newest last
    ssts: tuple[FileHandle, ...]

    def is_empty(self) -> bool:
        return not self.memtables and not self.ssts


class TableVersion:
    def __init__(
        self,
        schema: Schema,
        levels: LevelsController | None = None,
        options=None,
        table_name: str = "",
    ) -> None:
        self._lock = threading.RLock()
        self._schema = schema
        self._options = options  # drives memtable_type selection
        self._table_name = table_name  # layout hints key freezes by table
        self._memtable_ids = itertools.count(1)
        self._mutable = make_memtable(
            schema, next(self._memtable_ids), options, table_name
        )
        self._immutables: list[MemTable] = []
        self.levels = levels if levels is not None else LevelsController()
        self.flushed_sequence = 0

    def set_options(self, options) -> None:
        """Keep option-driven choices (memtable_type, switch threshold)
        in sync after ALTER TABLE SET options; applies to the NEXT
        memtable switch, never retroactively."""
        with self._lock:
            self._options = options

    # ---- schema --------------------------------------------------------
    @property
    def schema(self) -> Schema:
        with self._lock:
            return self._schema

    def alter_schema(self, schema: Schema) -> MemTable | None:
        """Install a new schema. The mutable memtable holds rows of the old
        schema version, so a non-empty one is frozen for flush first."""
        with self._lock:
            frozen = None
            if not self._mutable.is_empty():
                frozen = self._switch_memtable_locked()
            self._schema = schema
            self._mutable = make_memtable(
                schema, next(self._memtable_ids), self._options, self._table_name
            )
            return frozen

    # ---- memtables -----------------------------------------------------
    @property
    def mutable(self) -> MemTable:
        with self._lock:
            return self._mutable

    def switch_memtable(self) -> MemTable | None:
        """Freeze the mutable memtable (flush prep). None if empty."""
        with self._lock:
            if self._mutable.is_empty():
                return None
            return self._switch_memtable_locked()

    def _switch_memtable_locked(self) -> MemTable:
        frozen = self._mutable
        self._immutables.append(frozen)
        self._mutable = make_memtable(
            self._schema, next(self._memtable_ids), self._options, self._table_name
        )
        return frozen

    def immutables(self) -> list[MemTable]:
        with self._lock:
            return list(self._immutables)

    def immutable_stats(self) -> tuple[int, int]:
        """(count, bytes) of frozen memtables awaiting flush — the
        write-stall backpressure signal (frozen data the background dump
        hasn't made durable yet)."""
        with self._lock:
            return (
                len(self._immutables),
                sum(m.approx_bytes for m in self._immutables),
            )

    def retire_immutables(self, memtable_ids: list[int], flushed_sequence: int) -> None:
        """Called after a successful flush persisted these memtables."""
        with self._lock:
            ids = set(memtable_ids)
            self._immutables = [m for m in self._immutables if m.id not in ids]
            self.flushed_sequence = max(self.flushed_sequence, flushed_sequence)

    # ---- reads ---------------------------------------------------------
    def pick_read_view(self, time_range: TimeRange) -> ReadView:
        with self._lock:
            memtables = [
                m
                for m in [*self._immutables, self._mutable]
                if not m.is_empty() and m.time_range().overlaps(time_range)
            ]
            ssts = self.levels.pick_overlapping(time_range)
        return ReadView(tuple(memtables), tuple(ssts))

    # ---- stats ---------------------------------------------------------
    def mutable_bytes(self) -> int:
        with self._lock:
            return self._mutable.approx_bytes

    def total_memtable_bytes(self) -> int:
        with self._lock:
            return self._mutable.approx_bytes + sum(m.approx_bytes for m in self._immutables)

    def last_sequence(self) -> int:
        with self._lock:
            seqs = [self._mutable.last_sequence] + [m.last_sequence for m in self._immutables]
            return max([self.levels.max_sequence(), *seqs])
