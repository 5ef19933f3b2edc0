"""Timestamps and time ranges (ref: src/common_types/src/time.rs).

Timestamps are int64 milliseconds since the Unix epoch throughout the
framework. A ``TimeRange`` is half-open ``[inclusive_start, exclusive_end)``,
exactly like the reference's ``TimeRange`` — range math here must agree with
SST pruning and segment bucketing everywhere else.
"""

from __future__ import annotations

from dataclasses import dataclass

TimestampMs = int

MIN_TIMESTAMP: TimestampMs = -(2**63)
MAX_TIMESTAMP: TimestampMs = 2**63 - 1


@dataclass(frozen=True, slots=True)
class TimeRange:
    inclusive_start: TimestampMs
    exclusive_end: TimestampMs

    def __post_init__(self) -> None:
        if self.exclusive_end < self.inclusive_start:
            raise ValueError(
                f"invalid TimeRange [{self.inclusive_start}, {self.exclusive_end})"
            )

    # ---- constructors --------------------------------------------------
    @staticmethod
    def min_to_max() -> "TimeRange":
        return TimeRange(MIN_TIMESTAMP, MAX_TIMESTAMP)

    @staticmethod
    def empty() -> "TimeRange":
        return TimeRange(0, 0)

    @staticmethod
    def bucket_of(ts: TimestampMs, bucket_ms: int) -> "TimeRange":
        """The aligned bucket of width ``bucket_ms`` containing ``ts``.

        Floor-division alignment (correct for negative timestamps too) — the
        same alignment flush uses to split memtable rows into time-bucketed
        SSTs (ref: instance/flush_compaction.rs preprocess_flush).
        """
        start = (ts // bucket_ms) * bucket_ms
        return TimeRange(start, start + bucket_ms)

    # ---- predicates ----------------------------------------------------
    def is_empty(self) -> bool:
        return self.exclusive_end <= self.inclusive_start

    def contains(self, ts: TimestampMs) -> bool:
        return self.inclusive_start <= ts < self.exclusive_end

    def overlaps(self, other: "TimeRange") -> bool:
        return (
            self.inclusive_start < other.exclusive_end
            and other.inclusive_start < self.exclusive_end
        )

    def covers(self, other: "TimeRange") -> bool:
        return (
            self.inclusive_start <= other.inclusive_start
            and other.exclusive_end <= self.exclusive_end
        )

    # ---- combinators ---------------------------------------------------
    def intersect(self, other: "TimeRange") -> "TimeRange":
        start = max(self.inclusive_start, other.inclusive_start)
        end = min(self.exclusive_end, other.exclusive_end)
        return TimeRange(start, end) if start < end else TimeRange.empty()

    def union_merge(self, other: "TimeRange") -> "TimeRange":
        """Smallest range covering both (used for SST meta aggregation)."""
        if self.is_empty():
            return other
        if other.is_empty():
            return self
        return TimeRange(
            min(self.inclusive_start, other.inclusive_start),
            max(self.exclusive_end, other.exclusive_end),
        )

    def buckets(self, bucket_ms: int) -> list["TimeRange"]:
        """Aligned buckets of width ``bucket_ms`` overlapping this range."""
        if self.is_empty():
            return []
        out = []
        cur = (self.inclusive_start // bucket_ms) * bucket_ms
        while cur < self.exclusive_end:
            out.append(TimeRange(cur, cur + bucket_ms))
            cur += bucket_ms
        return out
