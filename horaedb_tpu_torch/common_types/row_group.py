"""Columnar row groups — the ingest/scan unit.

The reference moves ``Row``/``RowGroup`` row structs through the write path
(src/common_types/src/row/) and converts to Arrow at the engine boundary.
Here the columnar form IS the native form: a ``RowGroup`` is a schema plus
aligned numpy arrays (one per column, plus optional validity masks), so the
path ingest -> memtable -> SST -> device needs no row pivot at all.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Optional, Sequence

import numpy as np
import pyarrow as pa

from .datum import DatumKind, arrow_to_kind
from .dict_column import DictColumn, as_values, concat_columns
from .schema import ColumnSchema, Schema, TSID_COLUMN, compute_tsid
from .time_range import TimeRange


class RowGroup:
    def __init__(
        self,
        schema: Schema,
        columns: Mapping[str, np.ndarray],
        validity: Optional[Mapping[str, np.ndarray]] = None,
    ) -> None:
        self.schema = schema
        self.columns: dict[str, np.ndarray] = dict(columns)
        self.validity: dict[str, np.ndarray] = dict(validity or {})
        lengths = {len(a) for a in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: {lengths}")
        self._n = lengths.pop() if lengths else 0
        for c in schema.columns:
            if c.name not in self.columns:
                raise ValueError(f"missing column {c.name!r}")

    # ---- constructors --------------------------------------------------
    @staticmethod
    def from_rows(schema: Schema, rows: Sequence[Mapping[str, Any]]) -> "RowGroup":
        """Build from row dicts (INSERT path). Computes tsid, fills NULLs."""
        n = len(rows)
        columns: dict[str, np.ndarray] = {}
        validity: dict[str, np.ndarray] = {}
        for col in schema.columns:
            if col.name == TSID_COLUMN and schema.tsid_index is not None:
                continue  # computed below
            dtype = col.kind.numpy_dtype
            arr = np.empty(n, dtype=dtype)
            valid = np.ones(n, dtype=np.bool_)
            default = col.default_value if col.default_value is not None else col.kind.default_value()
            for i, row in enumerate(rows):
                v = row.get(col.name)
                if v is None:
                    if not col.is_nullable:
                        raise ValueError(f"NULL in non-nullable column {col.name!r}")
                    valid[i] = False
                    arr[i] = default
                else:
                    arr[i] = v
            columns[col.name] = arr
            if not valid.all():
                validity[col.name] = valid
        if schema.tsid_index is not None:
            tags = [columns[schema.columns[i].name] for i in schema.tag_indexes]
            columns[TSID_COLUMN] = compute_tsid(tags, num_rows=n)
        return RowGroup(schema, columns, validity)

    @staticmethod
    def from_arrow(schema: Schema, batch: pa.RecordBatch | pa.Table) -> "RowGroup":
        columns: dict[str, np.ndarray] = {}
        validity: dict[str, np.ndarray] = {}
        for col in schema.columns:
            idx = batch.schema.get_field_index(col.name)
            if idx < 0:
                # Column added by ALTER after this batch was written: all-NULL.
                n = batch.num_rows
                fill = col.kind.default_value()
                columns[col.name] = np.full(n, fill, dtype=col.kind.numpy_dtype)
                validity[col.name] = np.zeros(n, dtype=np.bool_)
                continue
            arr = batch.column(idx)
            if isinstance(arr, pa.ChunkedArray):
                arr = arr.combine_chunks()
            if pa.types.is_dictionary(arr.type) and col.kind is DatumKind.STRING:
                # String tags stay dictionary-encoded: codes + small
                # vocabulary, never per-row Python objects (the scan hot
                # path). Non-string dictionary inputs fall through to the
                # decode path below.
                vocab = np.asarray(arr.dictionary.to_pylist(), dtype=object)
                default = col.kind.default_value()
                if arr.null_count:
                    validity[col.name] = np.asarray(arr.is_valid())
                    # NULL slots must encode the same default value the
                    # plain-array ingest path fills in, so tsid/partition
                    # hashing is representation-independent.
                    hits = np.nonzero(vocab == default)[0]
                    if len(hits):
                        default_code = int(hits[0])
                    else:
                        vocab = np.append(vocab, default)
                        default_code = len(vocab) - 1
                    codes = np.asarray(arr.indices.fill_null(default_code), dtype=np.int32)
                else:
                    codes = np.asarray(arr.indices.fill_null(0), dtype=np.int32)
                if len(vocab) == 0:
                    vocab = np.array([default], dtype=object)
                columns[col.name] = DictColumn(codes, vocab)
                continue
            if pa.types.is_dictionary(arr.type):
                arr = arr.cast(arr.type.value_type)
            if arr.null_count:
                validity[col.name] = np.asarray(arr.is_valid())
                arr = arr.fill_null(col.kind.default_value())
            if col.kind in (DatumKind.STRING, DatumKind.VARBINARY):
                columns[col.name] = np.asarray(arr.to_pylist(), dtype=object)
            elif col.kind is DatumKind.TIMESTAMP:
                columns[col.name] = np.asarray(arr.cast(pa.int64()))
            else:
                columns[col.name] = np.asarray(arr)
        return RowGroup(schema, columns, validity)

    @staticmethod
    def concat(parts: Sequence["RowGroup"]) -> "RowGroup":
        if not parts:
            raise ValueError("concat of zero row groups")
        schema = parts[0].schema
        columns = {
            name: concat_columns([p.columns[name] for p in parts])
            for name in parts[0].columns
        }
        validity = {}
        names_with_nulls = {n for p in parts for n in p.validity}
        for name in names_with_nulls:
            validity[name] = np.concatenate(
                [p.validity.get(name, np.ones(len(p), dtype=np.bool_)) for p in parts]
            )
        return RowGroup(schema, columns, validity)

    # ---- accessors -----------------------------------------------------
    def __len__(self) -> int:
        return self._n

    @property
    def num_rows(self) -> int:
        return self._n

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def valid_mask(self, name: str) -> np.ndarray:
        m = self.validity.get(name)
        return m if m is not None else np.ones(self._n, dtype=np.bool_)

    @property
    def timestamps(self) -> np.ndarray:
        return self.columns[self.schema.timestamp_name]

    def time_range(self) -> TimeRange:
        if self._n == 0:
            return TimeRange.empty()
        ts = self.timestamps
        return TimeRange(int(ts.min()), int(ts.max()) + 1)

    # ---- transforms ----------------------------------------------------
    def take(self, indices: np.ndarray) -> "RowGroup":
        return RowGroup(
            self.schema,
            {k: v[indices] for k, v in self.columns.items()},
            {k: v[indices] for k, v in self.validity.items()},
        )

    def filter(self, mask: np.ndarray) -> "RowGroup":
        return self.take(np.nonzero(mask)[0])

    def slice(self, start: int, stop: int) -> "RowGroup":
        return RowGroup(
            self.schema,
            {k: v[start:stop] for k, v in self.columns.items()},
            {k: v[start:stop] for k, v in self.validity.items()},
        )

    def key_sort_permutation(self, seq: Optional[np.ndarray] = None) -> np.ndarray:
        """Permutation that sorts rows by primary key columns (ascending).

        With ``seq`` given, later sequence numbers win ties *by coming
        first* — matching the merge-iterator's sequence ordering for
        overwrite tables (ref: row_iter/merge.rs sequence ordering).
        """
        keys: list[np.ndarray] = []
        if seq is not None:
            # Least-significant tiebreak: duplicate keys within ONE write
            # batch share a sequence — later rows win (the reference's
            # memtable applies rows in order, so last-write-wins).
            keys.append(-np.arange(len(self), dtype=np.int64))
            keys.append(-seq.astype(np.int64))
        for i in reversed(self.schema.primary_key_indexes):
            keys.append(self._sortable(self.schema.columns[i].name))
        return np.lexsort(tuple(keys))

    def sorted_by_key(self, seq: Optional[np.ndarray] = None) -> "RowGroup":
        return self.take(self.key_sort_permutation(seq=seq))

    def _sortable(self, name: str) -> np.ndarray:
        arr = self.columns[name]
        if isinstance(arr, DictColumn):
            return arr.sort_ranks()
        return arr

    def to_arrow(self) -> pa.RecordBatch:
        arrays = []
        fields = []
        for col in self.schema.columns:
            f = col.to_arrow_field()
            data = self.columns[col.name]
            mask = self.validity.get(col.name)
            np_mask = None if mask is None else ~mask
            if isinstance(data, DictColumn):
                # non-dictionary fields (e.g. a hinted float column frozen
                # dictionary-coded) keep the FIELD's value type
                arr = pa.DictionaryArray.from_arrays(
                    pa.array(data.codes, type=pa.int32(), mask=np_mask),
                    pa.array(list(data.values), type=f.type.value_type
                             if pa.types.is_dictionary(f.type) else f.type),
                )
                if not pa.types.is_dictionary(f.type):
                    arr = arr.cast(f.type)
            elif pa.types.is_dictionary(f.type):
                arr = pa.array(
                    [None if (np_mask is not None and np_mask[i]) else data[i] for i in range(self._n)]
                    if np_mask is not None
                    else list(data),
                    type=f.type.value_type,
                ).dictionary_encode()
            elif col.kind is DatumKind.TIMESTAMP:
                arr = pa.array(data, type=pa.int64(), mask=np_mask).cast(f.type)
            elif data.dtype == object:
                arr = pa.array(list(data), type=f.type, mask=np_mask)
            else:
                arr = pa.array(data, type=f.type, mask=np_mask)
            arrays.append(arr)
            fields.append(f)
        return pa.RecordBatch.from_arrays(arrays, schema=pa.schema(fields))

    def to_pylist(self) -> list[dict[str, Any]]:
        out = []
        decoded = {
            name: as_values(col) for name, col in self.columns.items()
        }
        for i in range(self._n):
            row = {}
            for col in self.schema.columns:
                if not self.valid_mask(col.name)[i]:
                    row[col.name] = None
                else:
                    v = decoded[col.name][i]
                    row[col.name] = v.item() if isinstance(v, np.generic) else v
            out.append(row)
        return out
