"""Parquet SST reader with row-group pruning
(ref: analytic_engine/src/sst/parquet/async_reader.rs, row_group_pruner.rs).

Pruning happens at two granularities before any data IO:
1. file level — manifest ``SstMeta.column_ranges`` (callers prune before
   even constructing a reader);
2. row-group level — Parquet footer statistics (min/max per column),
   mirroring ``RowGroupPruner`` (row_group_pruner.rs:68-288).

Tag EQ/IN filters additionally consult per-row-group Bloom filters from
the SST footer (sst/filters.py — the reference's xor-filter role,
row_group_pruner.rs:283-288): min/max stats can't prune high-cardinality
tags whose values span every group. Exact filtering still happens on
device in the fused scan kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import pyarrow as pa
import pyarrow.parquet as pq


from ...common_types.row_group import RowGroup
from ...common_types.schema import Schema, project_schema
from ...common_types.time_range import TimeRange
from ...table_engine.predicate import Predicate
from ...utils.object_store import LocalDiskStore, ObjectStore
from .meta import SST_META_KEY, SstMeta


class SstReader:
    def __init__(self, store: ObjectStore, path: str) -> None:
        self.store = store
        self.path = path
        self._pf: Optional[pq.ParquetFile] = None

    # ---- low level -----------------------------------------------------
    def _parquet_file(self) -> pq.ParquetFile:
        if self._pf is None:
            # mmap straight from disk when the store allows it; otherwise a
            # zero-copy arrow buffer over the fetched bytes.
            if isinstance(self.store, LocalDiskStore):
                self._pf = pq.ParquetFile(self.store.local_path(self.path), memory_map=True)
            else:
                from ...utils.tracectx import span

                with span("store_get") as sp:
                    raw = self.store.get(self.path)
                    sp.set(bytes=len(raw))
                self._pf = pq.ParquetFile(pa.BufferReader(raw))
        return self._pf

    def read_meta(self) -> SstMeta:
        from .meta import footer_payload

        d = footer_payload(self._parquet_file(), self.path)
        # The footer is written before the final file size is known; the
        # store is authoritative for size.
        d["size_bytes"] = self.store.head(self.path)
        return SstMeta.from_dict(d)

    # ---- pruning -------------------------------------------------------
    def prune_row_groups(self, schema: Schema, predicate: Predicate) -> list[int]:
        """Indices of row groups that may contain matching rows."""
        pf = self._parquet_file()
        md = pf.metadata
        ts_name = schema.timestamp_name
        filters = self._group_filters(predicate)
        keep: list[int] = []
        for rg in range(md.num_row_groups):
            if self._row_group_may_match(
                md.row_group(rg), ts_name, predicate
            ) and self._bloom_may_match(filters, rg, predicate):
                keep.append(rg)
        return keep

    def _group_filters(self, predicate: Predicate) -> list[dict]:
        """Decoded per-row-group tag Bloom filters, when the predicate has
        EQ/IN filters that could consult them (ref: the xor filters of
        row_group_pruner.rs:283-288 — min/max can't prune a
        high-cardinality tag whose values span every group)."""
        from ...table_engine.predicate import FilterOp

        if not any(f.op in (FilterOp.EQ, FilterOp.IN) for f in predicate.filters):
            return []
        from .filters import decode_filters

        try:
            return decode_filters(self.read_meta().row_group_filters)
        except (ValueError, KeyError):
            return []

    def _bloom_may_match(
        self, filters: list[dict], rg: int, predicate: Predicate
    ) -> bool:
        if rg >= len(filters):
            return True
        from ...table_engine.predicate import FilterOp

        from .filters import might_contain

        group = filters[rg]
        for f in predicate.filters:
            filt = group.get(f.column)
            if filt is None:
                continue
            if f.op is FilterOp.EQ:
                if not might_contain(filt, str(f.value)):
                    return False
            elif f.op is FilterOp.IN:
                if not any(might_contain(filt, str(v)) for v in f.value):
                    return False
        return True

    def _row_group_may_match(self, rg_meta, ts_name: str, predicate: Predicate) -> bool:
        stats_by_col = {}
        for ci in range(rg_meta.num_columns):
            col = rg_meta.column(ci)
            name = col.path_in_schema.split(".")[0]
            st = col.statistics
            if st is not None and st.has_min_max:
                stats_by_col[name] = (st.min, st.max)
        ts_stats = stats_by_col.get(ts_name)
        if ts_stats is not None:
            lo, hi = _ts_to_ms(ts_stats[0]), _ts_to_ms(ts_stats[1])
            if not predicate.time_range.overlaps(TimeRange(lo, hi + 1)):
                return False
        for f in predicate.filters:
            st = stats_by_col.get(f.column)
            if st is None:
                continue
            lo, hi = st
            if isinstance(lo, bytes):
                lo, hi = lo.decode("utf-8", "replace"), hi.decode("utf-8", "replace")
            if not f.evaluate_min_max(lo, hi):
                return False
        return True

    # ---- reading -------------------------------------------------------
    def read(
        self,
        schema: Schema,
        predicate: Predicate | None = None,
        projection: Optional[Sequence[str]] = None,
    ) -> RowGroup:
        """Read matching row groups into one columnar RowGroup.

        ``projection`` limits columns fetched from the file; the returned
        RowGroup is padded back to the full schema only for columns read.
        Exact row filtering is NOT applied here — pruning keeps whole row
        groups and the caller (CPU fallback or TPU kernel) filters rows.
        """
        predicate = predicate or Predicate.all_time()
        pf = self._parquet_file()
        keep = self.prune_row_groups(schema, predicate)

        from ...utils.querystats import record as _qs_record

        read_schema = project_schema(schema, projection)
        columns = list(read_schema.names()) if projection is not None else None
        if not keep:
            import numpy as np

            # footer read only; every row group pruned
            _qs_record(sst_read=1)
            empty = {
                c.name: np.empty(0, dtype=c.kind.numpy_dtype) for c in read_schema.columns
            }
            return RowGroup(read_schema, empty)
        # ledger: COMPRESSED bytes of the column chunks actually fetched
        # (kept row groups × projected columns) — what this query pulled
        # from the object store; pruned groups and unprojected columns
        # cost nothing on remote stores.
        md = pf.metadata
        want = set(columns) if columns is not None else None
        fetched = 0
        for rg in keep:
            rg_meta = md.row_group(rg)
            for ci in range(rg_meta.num_columns):
                col = rg_meta.column(ci)
                if want is None or col.path_in_schema.split(".")[0] in want:
                    fetched += col.total_compressed_size
        _qs_record(sst_read=1, store_read_bytes=fetched)
        table = pf.read_row_groups(keep, columns=columns, use_threads=True)
        return RowGroup.from_arrow(read_schema, table)


def _ts_to_ms(v) -> int:
    """Parquet timestamp stats come back as datetime or int depending on
    the logical type; normalize to epoch ms."""
    import datetime

    if isinstance(v, datetime.datetime):
        if v.tzinfo is None:
            v = v.replace(tzinfo=datetime.timezone.utc)
        return int(v.timestamp() * 1000)
    return int(v)
