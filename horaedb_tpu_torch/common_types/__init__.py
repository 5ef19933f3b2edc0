"""Type & schema core.

TPU-native re-design of the reference's ``src/common_types`` crate
(schema.rs, datum.rs, row/, column_block.rs, time.rs): columnar-first
(numpy/Arrow blocks instead of row structs), with tag columns dictionary
encoded to int32 codes so group-by keys are device-friendly integers.
"""

from .datum import DatumKind, NUMPY_DTYPES, ARROW_TYPES
from .schema import ColumnSchema, Schema, TSID_COLUMN, compute_tsid
from .time_range import TimeRange, TimestampMs
from .row_group import RowGroup

__all__ = [
    "DatumKind",
    "NUMPY_DTYPES",
    "ARROW_TYPES",
    "ColumnSchema",
    "Schema",
    "TSID_COLUMN",
    "compute_tsid",
    "TimeRange",
    "TimestampMs",
    "RowGroup",
]
