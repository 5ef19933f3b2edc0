"""Table schema (ref: src/common_types/src/schema.rs).

Model (same as the reference's):

- every table has exactly one TIMESTAMP KEY column;
- columns marked TAG form the series identity; a ``tsid`` uint64 column is
  auto-generated (hash of the tag values) when the user doesn't spell out a
  primary key, and the default primary key is ``(tsid, timestamp)``
  (ref: schema.rs:226,638-722);
- everything else is a field column.

TPU-first difference: tag columns are *dictionary encoded* at ingest time
(string -> int32 code) so that series identity and group-by keys are dense
integers on device; the string dictionary only exists at the edges
(SST metadata, query results).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import pyarrow as pa

from .datum import DatumKind

TSID_COLUMN = "tsid"


@dataclass(frozen=True, slots=True)
class ColumnSchema:
    name: str
    kind: DatumKind
    is_nullable: bool = True
    is_tag: bool = False
    is_dictionary: bool = False
    comment: str = ""
    default_value: Optional[Any] = None

    def to_arrow_field(self) -> pa.Field:
        t = self.kind.arrow_type
        if self.is_tag and self.kind is DatumKind.STRING:
            t = pa.dictionary(pa.int32(), pa.string())
        meta = {}
        if self.is_tag:
            meta[b"horaedb_tpu::tag"] = b"1"
        return pa.field(self.name, t, nullable=self.is_nullable, metadata=meta or None)


class Schema:
    """Immutable table schema with key/tag bookkeeping.

    ``columns`` always start with the primary-key columns:
    ``[tsid, timestamp, ...tags..., ...fields...]`` in the auto-tsid layout.
    """

    def __init__(
        self,
        columns: Sequence[ColumnSchema],
        timestamp_index: int,
        primary_key_indexes: Sequence[int],
        version: int = 1,
    ) -> None:
        names = [c.name for c in columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in schema: {names}")
        if not (0 <= timestamp_index < len(columns)):
            raise ValueError("timestamp_index out of range")
        if columns[timestamp_index].kind is not DatumKind.TIMESTAMP:
            raise ValueError("timestamp column must be TIMESTAMP kind")
        for i in primary_key_indexes:
            if not columns[i].kind.is_key_kind:
                raise ValueError(
                    f"column {columns[i].name} ({columns[i].kind}) cannot be a key"
                )
        self.columns: tuple[ColumnSchema, ...] = tuple(columns)
        self.timestamp_index = timestamp_index
        self.primary_key_indexes: tuple[int, ...] = tuple(primary_key_indexes)
        self.version = version
        self._index = {c.name: i for i, c in enumerate(self.columns)}

    # ---- construction --------------------------------------------------
    @staticmethod
    def build(
        columns: Sequence[ColumnSchema],
        timestamp_column: str,
        primary_key: Sequence[str] | None = None,
        version: int = 1,
    ) -> "Schema":
        """Build a schema the way CREATE TABLE does.

        With no explicit primary key, prepends an auto-generated ``tsid``
        column and uses ``(tsid, timestamp)`` (ref: schema.rs enable_tsid
        path). Tag string columns get dictionary encoding.
        """
        cols = [
            ColumnSchema(
                name=c.name,
                kind=c.kind,
                is_nullable=c.is_nullable and c.name != timestamp_column and not c.is_tag,
                is_tag=c.is_tag,
                is_dictionary=c.is_tag and c.kind is DatumKind.STRING,
                comment=c.comment,
                default_value=c.default_value,
            )
            for c in columns
        ]
        names = [c.name for c in cols]
        if timestamp_column not in names:
            raise ValueError(f"timestamp column {timestamp_column!r} not defined")
        if primary_key is None:
            if TSID_COLUMN in names:
                raise ValueError("tsid is a reserved column name")
            cols.insert(
                0,
                ColumnSchema(TSID_COLUMN, DatumKind.UINT64, is_nullable=False),
            )
            # tsid first, then timestamp right after (canonical key order).
            ts_i = [c.name for c in cols].index(timestamp_column)
            if ts_i != 1:
                ts_col = cols.pop(ts_i)
                cols.insert(1, ts_col)
            pk_idx = (0, 1)
        else:
            for k in primary_key:
                if k not in names:
                    raise ValueError(f"primary key column {k!r} not defined")
            pk_idx = tuple([c.name for c in cols].index(k) for k in primary_key)
        ts_index = [c.name for c in cols].index(timestamp_column)
        return Schema(cols, ts_index, pk_idx, version=version)

    # ---- lookups -------------------------------------------------------
    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def timestamp_name(self) -> str:
        return self.columns[self.timestamp_index].name

    @property
    def tsid_index(self) -> Optional[int]:
        return self._index.get(TSID_COLUMN)

    @property
    def tag_indexes(self) -> tuple[int, ...]:
        return tuple(i for i, c in enumerate(self.columns) if c.is_tag)

    @property
    def tag_names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns if c.is_tag)

    @property
    def field_indexes(self) -> tuple[int, ...]:
        """Non-key, non-tag, non-timestamp columns (the measured values)."""
        skip = set(self.primary_key_indexes) | set(self.tag_indexes)
        skip.add(self.timestamp_index)
        return tuple(i for i in range(len(self.columns)) if i not in skip)

    def index_of(self, name: str) -> int:
        try:
            return self._index[name]
        except KeyError:
            raise KeyError(f"no such column: {name!r}") from None

    def column(self, name: str) -> ColumnSchema:
        return self.columns[self.index_of(name)]

    def has_column(self, name: str) -> bool:
        return name in self._index

    def names(self) -> list[str]:
        return [c.name for c in self.columns]

    def same_columns(self, other: "Schema") -> bool:
        """Layout-compatible: identical column tuple and timestamp slot.
        Two such schemas differ only in metadata (primary-key ORDER,
        version) — rows written against one decode under the other
        unchanged (the PK-sampler reorder relies on this)."""
        return (
            self.columns == other.columns
            and self.timestamp_index == other.timestamp_index
        )

    # ---- evolution -----------------------------------------------------
    def with_added_column(self, col: ColumnSchema) -> "Schema":
        """ALTER TABLE ADD COLUMN — appends a nullable field column."""
        if col.name in self._index:
            raise ValueError(f"column {col.name!r} already exists")
        if col.is_tag:
            raise ValueError("cannot add a tag column after table creation")
        return Schema(
            (*self.columns, col),
            self.timestamp_index,
            self.primary_key_indexes,
            version=self.version + 1,
        )

    # ---- interop -------------------------------------------------------
    def to_arrow(self) -> pa.Schema:
        return pa.schema([c.to_arrow_field() for c in self.columns])

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "timestamp_index": self.timestamp_index,
            "primary_key_indexes": list(self.primary_key_indexes),
            "columns": [
                {
                    "name": c.name,
                    "kind": c.kind.value,
                    "is_nullable": c.is_nullable,
                    "is_tag": c.is_tag,
                    "is_dictionary": c.is_dictionary,
                    "comment": c.comment,
                    "default_value": c.default_value,
                }
                for c in self.columns
            ],
        }

    @staticmethod
    def from_dict(d: dict) -> "Schema":
        cols = [
            ColumnSchema(
                name=c["name"],
                kind=DatumKind(c["kind"]),
                is_nullable=c["is_nullable"],
                is_tag=c["is_tag"],
                is_dictionary=c.get("is_dictionary", False),
                comment=c.get("comment", ""),
                default_value=c.get("default_value"),
            )
            for c in d["columns"]
        ]
        return Schema(
            cols,
            d["timestamp_index"],
            d["primary_key_indexes"],
            version=d["version"],
        )

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Schema)
            and self.columns == other.columns
            and self.timestamp_index == other.timestamp_index
            and self.primary_key_indexes == other.primary_key_indexes
        )

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{c.name}:{c.kind.value}{'[tag]' if c.is_tag else ''}" for c in self.columns
        )
        return f"Schema(v{self.version}, ts={self.timestamp_name}, [{cols}])"


def project_schema(schema: "Schema", projection: Sequence[str] | None) -> "Schema":
    """Sub-schema for a projected read.

    The timestamp and primary-key columns are always force-included: every
    storage read needs them for time filtering and merge ordering. Shared by
    the SST reader and the memtable/merge path so both sides of a scan agree
    on the projected layout.
    """
    if projection is None:
        return schema
    names = list(dict.fromkeys(projection))
    if schema.timestamp_name not in names:
        names.insert(0, schema.timestamp_name)
    for i in reversed(schema.primary_key_indexes):
        pk = schema.columns[i].name
        if pk not in names:
            names.insert(0, pk)
    cols = [schema.column(n) for n in names]
    ts_index = names.index(schema.timestamp_name)
    pk_indexes = tuple(
        names.index(schema.columns[i].name) for i in schema.primary_key_indexes
    )
    return Schema(cols, ts_index, pk_indexes, version=schema.version)


def compute_tsid(tag_arrays: Sequence[np.ndarray], num_rows: int | None = None) -> np.ndarray:
    """Vectorized series-id hash over tag value columns.

    The reference hashes tag bytes into a u64 ``tsid`` per row
    (schema.rs TSID). Values are CANONICALIZED before hashing so that the
    same logical value hashes identically whether it arrives as a typed
    numpy column (write path), an object array, or a bare Python literal
    (partition-rule locate path): strings -> utf-8, bytes -> raw, bools ->
    one byte, every integer kind -> 8-byte little-endian two's complement.
    Per-column hashes combine with a 64-bit FNV-style mix (order-sensitive,
    stable across processes).
    """
    from ..utils import native

    if not tag_arrays:
        # Tag-less table: every row is the same (only) series, id 0.
        return np.zeros(num_rows or 0, dtype=np.uint64)
    n = len(tag_arrays[0])
    out = np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
    for arr in tag_arrays:
        native.fnv_mix(out, _column_hash(arr))
    return out


def _column_hash(arr) -> np.ndarray:
    """Raw per-row XXH64 of one column's canonical bytes.

    Dictionary columns hash the vocabulary once and gather through codes —
    identical results to hashing decoded values, O(|vocab|) work.
    """
    from ..utils import native
    from .dict_column import DictColumn

    if isinstance(arr, DictColumn):
        return _column_hash(arr.values)[arr.codes]
    n = len(arr)
    if arr.dtype == object:
        # Fast path: arrow encodes the whole column into ONE contiguous
        # utf-8 buffer + int64 offsets (C speed), which feeds the native
        # batch hasher directly — no per-value Python. Mixed-type or
        # null-bearing columns fall back to the canonical-bytes loop.
        import pyarrow as pa

        try:
            pa_arr = pa.array(arr, type=pa.large_string())
        except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
            pa_arr = None
        if pa_arr is not None and pa_arr.null_count == 0 and pa_arr.offset == 0:
            offsets = np.frombuffer(pa_arr.buffers()[1], dtype=np.int64)[: n + 1]
            data_buf = pa_arr.buffers()[2]
            data = (
                np.frombuffer(data_buf, dtype=np.uint8)
                if data_buf is not None
                else np.empty(0, dtype=np.uint8)
            )
            return native.hash_var(data, offsets)
        encoded = [_canonical_bytes(v) for v in arr]
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.fromiter((len(b) for b in encoded), np.int64, count=n), out=offsets[1:])
        return native.hash_var(b"".join(encoded), offsets)
    if arr.dtype == np.bool_:
        return native.hash_fixed(arr.astype(np.uint8))
    if np.issubdtype(arr.dtype, np.integer):
        canon = (
            arr if arr.dtype == np.uint64
            else arr.astype(np.int64, copy=False).view(np.uint64)
        )
        return native.hash_fixed(canon)
    return native.hash_fixed(arr)


def _canonical_bytes(v) -> bytes:
    """Type-canonical byte encoding — must agree with the typed-array
    branches of compute_tsid for every key kind."""
    if isinstance(v, str):
        return v.encode()
    if isinstance(v, bytes):
        return v
    if isinstance(v, (bool, np.bool_)):
        return b"\x01" if v else b"\x00"
    if isinstance(v, (int, np.integer)):
        return (int(v) & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
    return str(v).encode()
