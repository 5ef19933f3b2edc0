"""Scan predicates (ref: src/table_engine/src/predicate.rs).

A ``Predicate`` is the filter contract between the query layer and storage:
a time range (always extracted — it drives segment/SST/row-group pruning)
plus a conjunction of simple column filters. Storage uses it for min-max
pruning; the device scan kernel evaluates the exact filters on device.

Filters are deliberately first-order (col op literal): that is what can be
pushed below the scan and compiled into the fused kernel. Anything richer
stays in the executor's post-filter.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from ..common_types.time_range import TimeRange

# THE comparison-op table — every layer that evaluates `col op literal`
# (host expression eval, delta fold, partial push-down) shares it so
# filter semantics cannot diverge.
NUMPY_CMP = {
    "=": np.equal,
    "!=": np.not_equal,
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
}


class FilterOp(enum.Enum):
    EQ = "="
    NE = "!="
    LT = "<"
    LE = "<="
    GT = ">"
    GE = ">="
    IN = "in"


@dataclass(frozen=True)
class ColumnFilter:
    column: str
    op: FilterOp
    value: Any  # literal, or tuple of literals for IN

    def evaluate_min_max(self, lo: Any, hi: Any) -> bool:
        """Can any row with column values in [lo, hi] satisfy this filter?

        Used for row-group pruning; must never return False for a group
        that contains a matching row (pruning is only an optimization).
        """
        if lo is None or hi is None:
            return True
        try:
            if self.op is FilterOp.EQ:
                return lo <= self.value <= hi
            if self.op is FilterOp.NE:
                return not (lo == hi == self.value)
            if self.op is FilterOp.LT:
                return lo < self.value
            if self.op is FilterOp.LE:
                return lo <= self.value
            if self.op is FilterOp.GT:
                return hi > self.value
            if self.op is FilterOp.GE:
                return hi >= self.value
            if self.op is FilterOp.IN:
                return any(lo <= v <= hi for v in self.value)
        except TypeError:
            return True  # incomparable types: don't prune
        return True


@dataclass(frozen=True)
class Predicate:
    time_range: TimeRange = field(default_factory=TimeRange.min_to_max)
    filters: tuple[ColumnFilter, ...] = ()
    # Scan hint: the reader may stop once this many matching rows are
    # collected (LIMIT pushdown, ref: the reference pushes fetch limits
    # into ScanRequest). Only set when every WHERE conjunct is already
    # captured by time_range/filters applied AT the scan — a residual
    # filter evaluated later would silently under-return.
    limit: "int | None" = None

    @staticmethod
    def all_time(filters: Sequence[ColumnFilter] = ()) -> "Predicate":
        return Predicate(TimeRange.min_to_max(), tuple(filters))

    def with_time_range(self, tr: TimeRange) -> "Predicate":
        return Predicate(tr, self.filters, self.limit)

    def with_limit(self, n: "int | None") -> "Predicate":
        return Predicate(self.time_range, self.filters, n)

    def restricted_to(self, columns: set[str]) -> "Predicate":
        """Keep only filters on the given columns (plus the time range).

        Used by dedup scans: pruning a row group by a VALUE filter may drop
        the newest version of a key while an older version survives in an
        unpruned group, resurfacing overwritten data. Key-column filters
        (and the time range — the timestamp is a key column) can never
        separate two versions of the same key, so they remain safe."""
        kept = tuple(f for f in self.filters if f.column in columns)
        if len(kept) == len(self.filters):
            return self
        return Predicate(self.time_range, kept)

    def filters_on(self, column: str) -> list[ColumnFilter]:
        return [f for f in self.filters if f.column == column]

    def referenced_columns(self) -> set[str]:
        return {f.column for f in self.filters}
