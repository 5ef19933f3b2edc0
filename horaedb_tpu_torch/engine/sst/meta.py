"""SST metadata (ref: analytic_engine/src/sst/{file.rs,meta_data/}).

Carried in the manifest (for pruning without touching the file) and embedded
in the Parquet footer's key-value metadata (for self-describing files).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ...common_types.time_range import TimeRange

SST_META_KEY = b"horaedb_tpu.sst_meta"


def footer_payload(parquet_file, path: str) -> dict:
    """The raw JSON payload embedded in an SST's Parquet footer — the ONE
    place that knows the key and the not-an-SST error. Callers: the
    engine reader (SstMeta), sst_metadata (inspection) and sst_convert
    (which also wants the embedded ``schema`` dict)."""
    import json

    kv = parquet_file.schema_arrow.metadata or {}
    raw = kv.get(SST_META_KEY)
    if raw is None:
        # Streamed SSTs attach the payload at close via the file-level
        # key-value metadata (the arrow schema was already serialized by
        # then); monolithic writes embed it in the schema. Accept both.
        kv = parquet_file.metadata.metadata or {}
        raw = kv.get(SST_META_KEY)
    if raw is None:
        raise ValueError(f"{path}: not a horaedb_tpu SST (missing footer meta)")
    return json.loads(raw)


@dataclass(frozen=True)
class SstMeta:
    file_id: int
    time_range: TimeRange
    max_sequence: int
    num_rows: int
    size_bytes: int
    schema_version: int
    # Per-column (min, max) for filter pruning at the file level; row-group
    # granularity pruning uses Parquet's own statistics.
    column_ranges: dict[str, tuple[Any, Any]]
    # Per row group, per tag column: base64 Bloom filter over the group's
    # values (ref: the xor filters of row_group_pruner.rs:283-288).
    row_group_filters: list = None

    def to_dict(self) -> dict:
        return {
            "file_id": self.file_id,
            "time_range": [self.time_range.inclusive_start, self.time_range.exclusive_end],
            "max_sequence": self.max_sequence,
            "num_rows": self.num_rows,
            "size_bytes": self.size_bytes,
            "schema_version": self.schema_version,
            "column_ranges": {k: list(v) for k, v in self.column_ranges.items()},
            "row_group_filters": self.row_group_filters or [],
        }

    @staticmethod
    def from_dict(d: dict) -> "SstMeta":
        return SstMeta(
            file_id=d["file_id"],
            time_range=TimeRange(*d["time_range"]),
            max_sequence=d["max_sequence"],
            num_rows=d["num_rows"],
            size_bytes=d["size_bytes"],
            schema_version=d["schema_version"],
            column_ranges={k: (v[0], v[1]) for k, v in d["column_ranges"].items()},
            row_group_filters=d.get("row_group_filters") or [],
        )


def sst_path(space_id: int, table_id: int, file_id: int) -> str:
    """Object-store key for an SST (ref: sst file path layout)."""
    return f"{space_id}/{table_id}/{file_id}.sst"
