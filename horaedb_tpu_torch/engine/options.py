"""Per-table options (ref: analytic_engine/src/table_options.rs).

Parsed from SQL ``CREATE TABLE ... WITH(key='value')`` strings, same option
vocabulary as the reference (table_options.rs:387-418): segment_duration,
update_mode, ttl, write_buffer_size, num_rows_per_row_group, compression,
memtable_type. Durations accept the reference's human format ("2h", "30m").
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field, replace
from typing import Optional


class UpdateMode(enum.Enum):
    OVERWRITE = "overwrite"  # dedup by primary key, newest sequence wins
    APPEND = "append"  # no dedup; scans concatenate (chain) instead of merge


_DUR_RE = re.compile(r"^\s*(\d+)\s*(ms|s|m|h|d)\s*$", re.IGNORECASE)
_DUR_UNITS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000}

_SIZE_RE = re.compile(r"^\s*(\d+)\s*(b|kb|mb|gb)?\s*$", re.IGNORECASE)
_SIZE_UNITS = {None: 1, "b": 1, "kb": 1 << 10, "mb": 1 << 20, "gb": 1 << 30}


def parse_duration_ms(s: str | int) -> int:
    if isinstance(s, int):
        return s
    m = _DUR_RE.match(s)
    if not m:
        raise ValueError(f"invalid duration: {s!r}")
    return int(m.group(1)) * _DUR_UNITS[m.group(2).lower()]


def format_duration(ms: int) -> str:
    for unit, scale in (("d", 86_400_000), ("h", 3_600_000), ("m", 60_000), ("s", 1000)):
        if ms % scale == 0 and ms >= scale:
            return f"{ms // scale}{unit}"
    return f"{ms}ms"


def parse_size_bytes(s: str | int) -> int:
    if isinstance(s, int):
        return s
    m = _SIZE_RE.match(s)
    if not m:
        raise ValueError(f"invalid size: {s!r}")
    unit = m.group(2).lower() if m.group(2) else None
    return int(m.group(1)) * _SIZE_UNITS[unit]


@dataclass(frozen=True)
class TableOptions:
    # None = auto-picked by the duration sampler on first flush
    # (ref: sampler.rs suggest_duration).
    segment_duration_ms: Optional[int] = None
    update_mode: UpdateMode = UpdateMode.OVERWRITE
    enable_ttl: bool = False
    ttl_ms: int = 7 * 86_400_000
    write_buffer_size: int = 32 << 20
    num_rows_per_row_group: int = 8192
    compression: str = "zstd"
    compaction_strategy: str = "time_window"  # or "size_tiered"
    # "columnar" (default) or "layered" — layered freezes the mutable
    # head into immutable pre-concatenated segments once it crosses
    # mutable_segment_switch_threshold, so repeated scans re-convert only
    # the small head (ref: memtable/layered/, table_options.rs:416,
    # mutable_segment_switch_threshold lib.rs:94). "skiplist" is accepted
    # as an alias for columnar: ordering here is imposed lazily by a
    # device sort, so a row-ordered insert structure buys nothing on TPU.
    memtable_type: str = "columnar"
    mutable_segment_switch_threshold: int = 4 << 20

    @staticmethod
    def from_kv(kv: dict[str, str]) -> "TableOptions":
        opts = TableOptions()
        changes: dict = {}
        for raw_key, value in kv.items():
            key = raw_key.strip().lower()
            if key == "segment_duration":
                changes["segment_duration_ms"] = parse_duration_ms(value)
            elif key == "update_mode":
                changes["update_mode"] = UpdateMode(value.strip().lower())
            elif key == "enable_ttl":
                changes["enable_ttl"] = str(value).strip().lower() in ("true", "1", "yes")
            elif key == "ttl":
                changes["ttl_ms"] = parse_duration_ms(value)
                changes.setdefault("enable_ttl", True)
            elif key == "write_buffer_size":
                changes["write_buffer_size"] = parse_size_bytes(value)
            elif key == "num_rows_per_row_group":
                changes["num_rows_per_row_group"] = int(value)
            elif key == "compression":
                changes["compression"] = str(value).strip().lower()
            elif key == "compaction_strategy":
                changes["compaction_strategy"] = str(value).strip().lower()
            elif key == "memtable_type":
                mt = str(value).strip().lower()
                if mt == "skiplist":
                    mt = "columnar"
                if mt not in ("columnar", "layered"):
                    raise ValueError(f"unknown memtable_type: {value!r}")
                changes["memtable_type"] = mt
            elif key == "mutable_segment_switch_threshold":
                changes["mutable_segment_switch_threshold"] = parse_size_bytes(value)
            else:
                raise ValueError(f"unknown table option: {raw_key!r}")
        return replace(opts, **changes)

    def to_dict(self) -> dict:
        return {
            "segment_duration_ms": self.segment_duration_ms,
            "update_mode": self.update_mode.value,
            "enable_ttl": self.enable_ttl,
            "ttl_ms": self.ttl_ms,
            "write_buffer_size": self.write_buffer_size,
            "num_rows_per_row_group": self.num_rows_per_row_group,
            "compression": self.compression,
            "compaction_strategy": self.compaction_strategy,
            "memtable_type": self.memtable_type,
            "mutable_segment_switch_threshold": self.mutable_segment_switch_threshold,
        }

    @staticmethod
    def from_dict(d: dict) -> "TableOptions":
        return TableOptions(
            segment_duration_ms=d.get("segment_duration_ms"),
            update_mode=UpdateMode(d.get("update_mode", "overwrite")),
            enable_ttl=d.get("enable_ttl", False),
            ttl_ms=d.get("ttl_ms", 7 * 86_400_000),
            write_buffer_size=d.get("write_buffer_size", 32 << 20),
            num_rows_per_row_group=d.get("num_rows_per_row_group", 8192),
            compression=d.get("compression", "zstd"),
            compaction_strategy=d.get("compaction_strategy", "time_window"),
            memtable_type=d.get("memtable_type", "columnar"),
            mutable_segment_switch_threshold=d.get(
                "mutable_segment_switch_threshold", 4 << 20
            ),
        )


# Candidate segment durations the sampler picks from
# (ref: sampler.rs:40-52 — eight candidates from 2h up).
SEGMENT_DURATION_CANDIDATES_MS = [
    2 * 3_600_000,
    4 * 3_600_000,
    6 * 3_600_000,
    8 * 3_600_000,
    12 * 3_600_000,
    24 * 3_600_000,
    7 * 86_400_000,
    30 * 86_400_000,
]


def suggest_segment_duration(observed_span_ms: int) -> int:
    """Pick the smallest candidate so the observed span fits in one segment,
    falling back to the largest (ref: sampler.rs suggest_duration picks the
    candidate matching the sampled write span)."""
    for c in SEGMENT_DURATION_CANDIDATES_MS:
        if observed_span_ms <= c:
            return c
    return SEGMENT_DURATION_CANDIDATES_MS[-1]
