"""Table interface (ref: src/table_engine/src/table.rs Table trait
:512-569 and engine.rs TableEngine :323-363).

The query layer programs against ``Table``; implementations:

- ``AnalyticTable``     — the LSM engine (engine/), the real thing
- ``PartitionedTable``  — virtual table fanning out to sub-tables by a
                          partition rule (ref: partition_table_engine)
- ``MemoryTable``       — dict-backed fake for tests / system tables
                          (ref: table_engine/src/memory.rs)
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Sequence

import numpy as np

from ..common_types.row_group import RowGroup
from ..common_types.schema import Schema, project_schema
from ..engine.options import TableOptions
from .predicate import Predicate


class Table(ABC):
    @property
    @abstractmethod
    def name(self) -> str: ...

    @property
    @abstractmethod
    def schema(self) -> Schema: ...

    @property
    @abstractmethod
    def options(self) -> TableOptions: ...

    @abstractmethod
    def write(self, rows: RowGroup) -> int:
        """Durable write; returns number of rows written."""

    @abstractmethod
    def read(
        self,
        predicate: Predicate | None = None,
        projection: Optional[Sequence[str]] = None,
    ) -> RowGroup: ...

    @abstractmethod
    def flush(self) -> None: ...

    @abstractmethod
    def compact(self) -> None: ...

    @abstractmethod
    def alter_schema(self, schema: Schema) -> None: ...

    def alter_options(self, options: TableOptions) -> None:
        raise NotImplementedError

    def physical_datas(self) -> list:
        """Engine-level TableData handles backing this table (empty for
        non-engine tables). Catalog close/drop iterate these uniformly."""
        return []

    def metrics(self) -> dict:
        return {"table": self.name}

    def read_windows(self, predicate=None, projection=None):
        """Yield the scan as BOUNDED per-segment-window row sets (the
        memory-capped aggregate path consumes these one at a time and
        combines AggStates instead of materializing the whole table; ref:
        instance/read.rs:165-190 returns N streams, not one array).
        Correct per window because the primary key includes the
        timestamp: duplicates of a key can never straddle segment
        windows. Default: one piece (non-engine tables are small)."""
        yield self.read(predicate, projection)

    def partial_agg(self, spec: dict):
        """Pushed-down partial aggregate over this table's OWN data
        (ref: dist_sql_query partial agg below the scan). Runs wherever
        the data lives — remote handles forward it over the wire.

        Returns (names, arrays, stage_metrics) — the metrics travel back
        to the coordinator for EXPLAIN ANALYZE (ref: the reference ships
        remote plan metrics in RemoteTaskContext.remote_metrics)."""
        import time

        from ..query.partial import compute_partial

        t0 = time.perf_counter()
        sub: dict = {}
        names, arrays = compute_partial(self, spec, sub)
        return names, arrays, [{
            "partition": self.name,
            "remote": False,
            **sub,  # scan_ms / rows_scanned / path / agg_ms — same span
            # shape as remote partitions, so stage trees stay uniform
            "elapsed_ms": round((time.perf_counter() - t0) * 1000, 3),
            "groups": int(len(arrays[0])) if arrays else 0,
        }]


class AnalyticTable(Table):
    """The storage engine behind the Table interface."""

    def __init__(self, instance, data) -> None:
        self.instance = instance
        self.data = data

    @property
    def name(self) -> str:
        return self.data.name

    @property
    def schema(self) -> Schema:
        return self.data.schema

    @property
    def options(self) -> TableOptions:
        return self.data.options

    def write(self, rows: RowGroup) -> int:
        self.instance.write(self.data, rows)
        return len(rows)

    def read(self, predicate=None, projection=None) -> RowGroup:
        return self.instance.read(self.data, predicate, projection=projection)

    def window_starts(self, predicate=None) -> list[int]:
        """Aligned segment-window starts the (time-pruned) file set and
        memtables cover — the unit of both the bounded scan and the
        remote streaming read. Empty when the table has no segment
        duration (callers fall back to one whole read)."""
        from ..table_engine.predicate import Predicate as P

        predicate = predicate or P.all_time()
        seg_ms = self.data.options.segment_duration_ms
        tr = predicate.time_range
        if not seg_ms:
            return []
        starts: set[int] = set()
        spans: list[tuple[int, int]] = []
        for h in self.data.version.levels.all_files():
            ftr = h.meta.time_range
            spans.append((ftr.inclusive_start, ftr.exclusive_end))
        for mem in [*self.data.version.immutables(), self.data.version.mutable]:
            if not mem.is_empty():
                mtr = mem.time_range()
                spans.append((mtr.inclusive_start, mtr.exclusive_end))
        for lo, hi in spans:
            lo = max(lo, tr.inclusive_start)
            hi = min(hi, tr.exclusive_end)
            if hi <= lo:
                continue
            w = (lo // seg_ms) * seg_ms
            while w < hi:
                starts.add(w)
                w += seg_ms
        return sorted(starts)

    def read_window(self, start: int, predicate=None, projection=None) -> RowGroup:
        """The normal merge read restricted to one aligned window — a
        complete, deduplicated answer for its time slice."""
        from ..common_types.time_range import TimeRange
        from ..table_engine.predicate import Predicate as P

        predicate = predicate or P.all_time()
        seg_ms = self.data.options.segment_duration_ms
        tr = predicate.time_range
        w_pred = P(
            TimeRange(
                max(start, tr.inclusive_start),
                min(start + seg_ms, tr.exclusive_end),
            ),
            predicate.filters,
        )
        return self.read(w_pred, projection)

    def read_windows(self, predicate=None, projection=None):
        """Per-segment-window reads (see window_starts/read_window)."""
        starts = self.window_starts(predicate)
        if not starts:
            yield self.read(predicate, projection)
            return
        for w in starts:
            rows = self.read_window(w, predicate, projection)
            if len(rows):
                yield rows

    def flush(self) -> None:
        self.instance.flush_table(self.data)

    def compact(self) -> None:
        self.instance.compact_table(self.data)

    def alter_schema(self, schema: Schema) -> None:
        self.instance.alter_schema(self.data, schema)

    def alter_options(self, options: TableOptions) -> None:
        from ..engine.manifest import AlterOptions

        with self.data.serial_lock:
            self.data.options = options
            self.data.version.set_options(options)
            self.data.manifest.append_edits([AlterOptions(options.to_dict())])

    def physical_datas(self) -> list:
        return [self.data]

    def metrics(self) -> dict:
        return self.data.metrics()


def read_one_page(table, predicate, projection, after):
    """ONE page of a stateless windowed read -> (rows | None, next_token).

    The single definition of the pagination protocol: the remote service
    answers ReadPage with it, and RoutedSubTable drives local resolutions
    through it page by page (so route retries and close-deferral guards
    hold per page). ``after`` is the previous page's token (an exclusive
    window-start lower bound); ``next=None`` terminates the stream.
    Tables without segment windows are one terminal page."""
    starts = (
        table.window_starts(predicate)
        if isinstance(table, AnalyticTable)
        else []
    )
    if not starts:
        if after is not None:
            return None, None
        return table.read(predicate, projection), None
    remaining = [w for w in starts if after is None or w > after]
    if not remaining:
        return None, None
    w = remaining[0]
    return (
        table.read_window(w, predicate, projection),
        w if len(remaining) > 1 else None,
    )


class MemoryTable(Table):
    """Unordered in-memory fake (ref: table_engine/src/memory.rs)."""

    def __init__(self, name: str, schema: Schema, options: TableOptions | None = None):
        self._name = name
        self._schema = schema
        self._options = options or TableOptions()
        self._parts: list[RowGroup] = []

    @property
    def name(self) -> str:
        return self._name

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def options(self) -> TableOptions:
        return self._options

    def write(self, rows: RowGroup) -> int:
        self._parts.append(rows)
        return len(rows)

    def read(self, predicate=None, projection=None) -> RowGroup:
        schema = project_schema(self._schema, projection)
        if not self._parts:
            empty = {c.name: np.empty(0, dtype=c.kind.numpy_dtype) for c in schema.columns}
            return RowGroup(schema, empty)
        rows = RowGroup.concat(self._parts)
        if predicate is not None:
            ts = rows.timestamps
            tr = predicate.time_range
            rows = rows.filter((ts >= tr.inclusive_start) & (ts < tr.exclusive_end))
        if projection is not None:
            names = schema.names()
            rows = RowGroup(
                schema,
                {k: rows.columns[k] for k in names},
                {k: v for k, v in rows.validity.items() if k in names},
            )
        return rows

    def flush(self) -> None:
        pass

    def compact(self) -> None:
        pass

    def alter_schema(self, schema: Schema) -> None:
        self._schema = schema
