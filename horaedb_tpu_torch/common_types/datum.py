"""Datum kinds — the scalar type system.

Mirrors the reference's ``DatumKind`` (src/common_types/src/datum.rs) but maps
every kind onto a numpy dtype + Arrow type so that column data lives in
contiguous buffers from ingest to device: there is no per-row boxed value in
the hot path (rows exist only at the API edge).
"""

from __future__ import annotations

import enum
from typing import Any

import numpy as np
import pyarrow as pa


class DatumKind(enum.Enum):
    NULL = "null"
    TIMESTAMP = "timestamp"  # int64 milliseconds since epoch
    DOUBLE = "double"
    FLOAT = "float"
    VARBINARY = "varbinary"
    STRING = "string"
    UINT64 = "uint64"
    UINT32 = "uint32"
    UINT16 = "uint16"
    UINT8 = "uint8"
    INT64 = "bigint"
    INT32 = "int"
    INT16 = "smallint"
    INT8 = "tinyint"
    BOOLEAN = "boolean"
    DATE = "date"  # int32 days since epoch
    TIME = "time"  # int64 nanos within day

    # ---- classification ------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self in _NUMERIC

    @property
    def is_integer(self) -> bool:
        return self in _INTEGER

    @property
    def is_float(self) -> bool:
        return self in (DatumKind.DOUBLE, DatumKind.FLOAT)

    @property
    def is_key_kind(self) -> bool:
        """Kinds usable as a primary-key / tag component."""
        return self in _KEY_KINDS

    @property
    def numpy_dtype(self) -> np.dtype:
        return NUMPY_DTYPES[self]

    @property
    def arrow_type(self) -> pa.DataType:
        return ARROW_TYPES[self]

    # ---- parsing -------------------------------------------------------
    @classmethod
    def from_sql_type(cls, name: str) -> "DatumKind":
        """Parse a SQL type name (as used in CREATE TABLE) into a kind."""
        key = name.strip().lower()
        try:
            return _SQL_NAMES[key]
        except KeyError:
            raise ValueError(f"unknown SQL type: {name!r}") from None

    def default_value(self) -> Any:
        """Value used for padding / NULL slots in dense device buffers."""
        if self in (DatumKind.STRING, DatumKind.VARBINARY):
            return b"" if self is DatumKind.VARBINARY else ""
        if self is DatumKind.BOOLEAN:
            return False
        if self is DatumKind.NULL:
            return None
        return self.numpy_dtype.type(0)


_NUMERIC = {
    DatumKind.TIMESTAMP, DatumKind.DOUBLE, DatumKind.FLOAT,
    DatumKind.UINT64, DatumKind.UINT32, DatumKind.UINT16, DatumKind.UINT8,
    DatumKind.INT64, DatumKind.INT32, DatumKind.INT16, DatumKind.INT8,
    DatumKind.DATE, DatumKind.TIME,
}
_INTEGER = {
    DatumKind.TIMESTAMP,
    DatumKind.UINT64, DatumKind.UINT32, DatumKind.UINT16, DatumKind.UINT8,
    DatumKind.INT64, DatumKind.INT32, DatumKind.INT16, DatumKind.INT8,
    DatumKind.DATE, DatumKind.TIME,
}
# Same set the reference accepts for keys/tags (datum.rs is_key_kind):
_KEY_KINDS = {
    DatumKind.TIMESTAMP, DatumKind.STRING, DatumKind.VARBINARY,
    DatumKind.UINT64, DatumKind.UINT32, DatumKind.UINT16, DatumKind.UINT8,
    DatumKind.INT64, DatumKind.INT32, DatumKind.INT16, DatumKind.INT8,
    DatumKind.BOOLEAN, DatumKind.DATE, DatumKind.TIME,
}

NUMPY_DTYPES: dict[DatumKind, np.dtype] = {
    DatumKind.TIMESTAMP: np.dtype(np.int64),
    DatumKind.DOUBLE: np.dtype(np.float64),
    DatumKind.FLOAT: np.dtype(np.float32),
    DatumKind.VARBINARY: np.dtype(object),
    DatumKind.STRING: np.dtype(object),
    DatumKind.UINT64: np.dtype(np.uint64),
    DatumKind.UINT32: np.dtype(np.uint32),
    DatumKind.UINT16: np.dtype(np.uint16),
    DatumKind.UINT8: np.dtype(np.uint8),
    DatumKind.INT64: np.dtype(np.int64),
    DatumKind.INT32: np.dtype(np.int32),
    DatumKind.INT16: np.dtype(np.int16),
    DatumKind.INT8: np.dtype(np.int8),
    DatumKind.BOOLEAN: np.dtype(np.bool_),
    DatumKind.DATE: np.dtype(np.int32),
    DatumKind.TIME: np.dtype(np.int64),
}

ARROW_TYPES: dict[DatumKind, pa.DataType] = {
    DatumKind.NULL: pa.null(),
    DatumKind.TIMESTAMP: pa.timestamp("ms"),
    DatumKind.DOUBLE: pa.float64(),
    DatumKind.FLOAT: pa.float32(),
    DatumKind.VARBINARY: pa.binary(),
    DatumKind.STRING: pa.string(),
    DatumKind.UINT64: pa.uint64(),
    DatumKind.UINT32: pa.uint32(),
    DatumKind.UINT16: pa.uint16(),
    DatumKind.UINT8: pa.uint8(),
    DatumKind.INT64: pa.int64(),
    DatumKind.INT32: pa.int32(),
    DatumKind.INT16: pa.int16(),
    DatumKind.INT8: pa.int8(),
    DatumKind.BOOLEAN: pa.bool_(),
    DatumKind.DATE: pa.date32(),
    DatumKind.TIME: pa.time64("ns"),
}

_SQL_NAMES: dict[str, DatumKind] = {
    "timestamp": DatumKind.TIMESTAMP,
    "double": DatumKind.DOUBLE,
    "float": DatumKind.FLOAT,
    "real": DatumKind.FLOAT,
    "varbinary": DatumKind.VARBINARY,
    "string": DatumKind.STRING,
    "varchar": DatumKind.STRING,
    "text": DatumKind.STRING,
    "uint64": DatumKind.UINT64,
    "uint32": DatumKind.UINT32,
    "uint16": DatumKind.UINT16,
    "uint8": DatumKind.UINT8,
    "bigint": DatumKind.INT64,
    "int64": DatumKind.INT64,
    "int": DatumKind.INT32,
    "int32": DatumKind.INT32,
    "integer": DatumKind.INT32,
    "smallint": DatumKind.INT16,
    "int16": DatumKind.INT16,
    "tinyint": DatumKind.INT8,
    "int8": DatumKind.INT8,
    "boolean": DatumKind.BOOLEAN,
    "bool": DatumKind.BOOLEAN,
    "date": DatumKind.DATE,
    "time": DatumKind.TIME,
}


def arrow_to_kind(t: pa.DataType) -> DatumKind:
    for kind, at in ARROW_TYPES.items():
        if at == t:
            return kind
    # Dictionary-encoded string columns round-trip to STRING.
    if pa.types.is_dictionary(t) and pa.types.is_string(t.value_type):
        return DatumKind.STRING
    if pa.types.is_timestamp(t):
        return DatumKind.TIMESTAMP
    raise ValueError(f"unsupported arrow type: {t}")
