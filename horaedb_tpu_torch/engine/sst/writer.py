"""Parquet SST writer (ref: analytic_engine/src/sst/parquet/writer.rs).

Differences from the reference, by design for the TPU read path:

- rows are written already sorted by primary key (the flush path sorts on
  device or host before handing rows here), so SSTs are sorted runs the
  merge kernel can consume directly;
- tag columns are dictionary encoded in the Parquet schema (the reference
  *samples* data to decide encodings, writer.rs:553-614 — here tags are
  always dictionaries because the device kernels want integer codes);
- zstd compression, configurable rows per row group
  (`num_rows_per_row_group`, ref table_options.rs).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from ...common_types.row_group import RowGroup
from ...common_types.schema import Schema
from ...utils.object_store import ObjectStore
from .meta import SST_META_KEY, SstMeta

import json


@dataclass
class WriteOptions:
    num_rows_per_row_group: int = 8192
    compression: str = "zstd"


class SstWriter:
    def __init__(self, store: ObjectStore, options: WriteOptions | None = None) -> None:
        self.store = store
        self.options = options or WriteOptions()

    def write(
        self,
        path: str,
        file_id: int,
        data: RowGroup,
        max_sequence: int,
    ) -> SstMeta:
        """Serialize a (key-sorted) row group to a Parquet SST and store it."""
        schema = data.schema
        batch = data.to_arrow()
        table = pa.Table.from_batches([batch])

        column_ranges = _column_ranges(data)
        tr = data.time_range()

        meta = SstMeta(
            file_id=file_id,
            time_range=tr,
            max_sequence=max_sequence,
            num_rows=len(data),
            size_bytes=0,  # patched below once serialized
            schema_version=schema.version,
            column_ranges=column_ranges,
            row_group_filters=_row_group_filters(
                data, self.options.num_rows_per_row_group
            ),
        )
        existing = table.schema.metadata or {}
        # The embedded payload also carries the FULL schema (not just its
        # version) so an SST is self-describing: offline tools (sst_convert,
        # inspection) and disaster recovery can decode it without the
        # manifest (ref: the reference's custom parquet meta embeds schema,
        # sst/parquet/encoding.rs). Readers of the SstMeta dataclass ignore
        # the extra key — old files without it stay readable.
        table = table.replace_schema_metadata(
            {
                **existing,
                SST_META_KEY: json.dumps(
                    {**meta.to_dict(), "schema": schema.to_dict()}
                ).encode(),
            }
        )

        buf = io.BytesIO()
        pq.write_table(
            table,
            buf,
            row_group_size=self.options.num_rows_per_row_group,
            compression=self.options.compression,
            use_dictionary=True,
            write_statistics=True,
        )
        raw = buf.getvalue()
        from ...utils.tracectx import span

        with span("store_put", bytes=len(raw)):
            self.store.put(path, raw)
        return SstMeta(
            file_id=meta.file_id,
            time_range=meta.time_range,
            max_sequence=meta.max_sequence,
            num_rows=meta.num_rows,
            size_bytes=len(raw),
            schema_version=meta.schema_version,
            column_ranges=meta.column_ranges,
            row_group_filters=meta.row_group_filters,
        )


class SstStreamWriter:
    """Incremental SST writer: key-sorted PARTS append as parquet row
    groups while the producer (the chunked device merge) is still
    sorting later parts — write time overlaps kernel time instead of
    serializing after the full merge materializes. Footer metadata
    (column ranges, bloom filters, counts, time range) accumulates
    per part and lands at ``close()`` via the parquet file-level
    key-value metadata (the reference's writer also finalizes its custom
    meta at close, sst/parquet/writer.rs)."""

    def __init__(
        self,
        store: ObjectStore,
        path: str,
        file_id: int,
        options: WriteOptions | None = None,
    ) -> None:
        self.store = store
        self.path = path
        self.file_id = file_id
        self.options = options or WriteOptions()
        self._buf = io.BytesIO()
        self._writer: pq.ParquetWriter | None = None
        self._schema: Schema | None = None
        self._ranges: dict = {}
        self._filters: list = []
        self._num_rows = 0
        self._t_lo: int | None = None
        self._t_hi: int | None = None
        self._max_seq = 0

    def append(self, rows: RowGroup, max_sequence: int = 0) -> None:
        if len(rows) == 0:
            return
        self._schema = rows.schema
        self._max_seq = max(self._max_seq, int(max_sequence))
        batch = rows.to_arrow()
        table = pa.Table.from_batches([batch])
        if self._writer is None:
            self._writer = pq.ParquetWriter(
                self._buf,
                table.schema,
                compression=self.options.compression,
                use_dictionary=True,
                write_statistics=True,
            )
        n_per = self.options.num_rows_per_row_group
        self._writer.write_table(table, row_group_size=n_per)
        for col, (lo, hi) in _column_ranges(rows).items():
            prev = self._ranges.get(col)
            self._ranges[col] = (
                (lo, hi) if prev is None else (min(prev[0], lo), max(prev[1], hi))
            )
        # Per-part grouping matches the parquet row groups exactly: each
        # write_table call starts fresh groups, so the concatenated filter
        # list stays aligned with the file's actual row groups.
        self._filters.extend(_row_group_filters(rows, n_per))
        self._num_rows += len(rows)
        tr = rows.time_range()
        self._t_lo = tr.inclusive_start if self._t_lo is None else min(
            self._t_lo, tr.inclusive_start
        )
        self._t_hi = tr.exclusive_end if self._t_hi is None else max(
            self._t_hi, tr.exclusive_end
        )

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def max_sequence(self) -> int:
        return self._max_seq

    def finalize(self) -> tuple[SstMeta, bytes] | None:
        """Finish the parquet encode WITHOUT storing: returns the final
        meta plus the serialized bytes, or None when nothing was
        appended. ``upload`` (or ``close``) performs the store put —
        split so the compaction pipeline can overlap uploads of task i's
        outputs with task i+1's device merge on the io pool."""
        if self._writer is None:
            return None
        from ...common_types.time_range import TimeRange

        meta = SstMeta(
            file_id=self.file_id,
            time_range=TimeRange(self._t_lo, self._t_hi),
            max_sequence=self._max_seq,
            num_rows=self._num_rows,
            size_bytes=0,
            schema_version=self._schema.version,
            column_ranges=self._ranges,
            row_group_filters=self._filters,
        )
        self._writer.add_key_value_metadata(
            {
                SST_META_KEY.decode(): json.dumps(
                    {**meta.to_dict(), "schema": self._schema.to_dict()}
                )
            }
        )
        self._writer.close()
        self._writer = None
        raw = self._buf.getvalue()
        return (
            SstMeta(
                file_id=meta.file_id,
                time_range=meta.time_range,
                max_sequence=meta.max_sequence,
                num_rows=meta.num_rows,
                size_bytes=len(raw),
                schema_version=meta.schema_version,
                column_ranges=meta.column_ranges,
                row_group_filters=meta.row_group_filters,
            ),
            raw,
        )

    def upload(self, raw: bytes) -> None:
        from ...utils.tracectx import span

        with span("store_put", bytes=len(raw)):
            self.store.put(self.path, raw)

    def close(self) -> SstMeta | None:
        """Finalize + store; None when nothing was appended."""
        out = self.finalize()
        if out is None:
            return None
        meta, raw = out
        self.upload(raw)
        return meta


def _column_ranges(data: RowGroup) -> dict:
    """File-level min/max per numeric + string column for manifest pruning."""
    from ...common_types.dict_column import DictColumn

    out = {}
    if len(data) == 0:
        return out
    for col in data.schema.columns:
        arr = data.columns[col.name]
        mask = data.valid_mask(col.name)
        if not mask.any():
            continue
        if isinstance(arr, DictColumn):
            lo, hi = arr.min_max(mask)
            if lo is not None and not isinstance(lo, bytes):
                out[col.name] = (lo, hi)
            continue
        vals = arr[mask]
        try:
            if arr.dtype == object:
                lo, hi = min(vals), max(vals)
                # Footer meta is JSON; bytes ranges aren't representable
                # there, and pruning on varbinary isn't worth the encode.
                if isinstance(lo, bytes) or isinstance(hi, bytes):
                    continue
                out[col.name] = (lo, hi)
            else:
                out[col.name] = (vals.min().item(), vals.max().item())
        except (TypeError, ValueError):
            continue
    return out


def _row_group_filters(data: RowGroup, rows_per_group: int) -> list:
    """Bloom filter per (row group, tag column) for point-lookup pruning
    (ref: writer.rs row-group xor filters). Tag columns only: numeric
    fields prune fine via min/max stats."""
    from ...common_types.dict_column import as_values
    from .filters import build_filter, encode_filters

    schema = data.schema
    tag_cols = [schema.columns[i].name for i in schema.tag_indexes]
    if not tag_cols or len(data) == 0:
        return []
    import numpy as np

    from ...common_types.dict_column import DictColumn

    prepared = {}
    for col in tag_cols:
        arr = data.columns[col]
        valid = data.valid_mask(col)
        if isinstance(arr, DictColumn):
            # hash each window's UNIQUE vocabulary entries, not per row:
            # per-group distinct tags are tiny next to the row count
            prepared[col] = ("dict", arr.codes, np.asarray(arr.values, dtype=object), valid)
        else:
            prepared[col] = ("raw", as_values(arr), None, valid)
    groups: list[dict] = []
    for start in range(0, len(data), rows_per_group):
        end = min(start + rows_per_group, len(data))
        entry = {}
        for col, (kind, vals, vocab, valid) in prepared.items():
            win_valid = valid[start:end]
            if kind == "dict":
                codes = np.unique(vals[start:end][win_valid])
                uniques = vocab[codes]
            else:
                uniques = np.unique(vals[start:end][win_valid])
            entry[col] = build_filter(str(v) for v in uniques)
        groups.append(entry)
    return encode_filters(groups)
