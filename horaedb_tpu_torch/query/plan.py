"""Plan sum type (ref: query_frontend/src/plan.rs:67).

Each variant carries everything its interpreter needs; ``QueryPlan``
additionally carries the extracted pushdown ``Predicate`` (time range +
simple filters — ref: table_engine predicate extraction) and a priority
decision (ref: plan.rs:105 ``decide_query_priority`` — long-time-range
queries are demoted to the low-priority runtime).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

from ..common_types.schema import Schema
from ..common_types.time_range import TimeRange
from ..engine.options import TableOptions
from ..table_engine.predicate import Predicate
from . import ast


class QueryPriority(enum.Enum):
    HIGH = "high"
    LOW = "low"


# Queries spanning more than this are "expensive" and run at low priority
# (the reference's threshold is config-driven; same default spirit).
EXPENSIVE_QUERY_RANGE_MS = 24 * 3_600_000


@dataclass(frozen=True)
class AggCall:
    """One aggregate in the select list."""

    func: str  # count | sum | min | max | avg | registry UDAF name
    column: Optional[str]  # None for count(*)
    output_name: str
    distinct: bool = False
    # Second column for binary aggregates (corr/covar: corr(x, y)).
    column2: Optional[str] = None
    # Trailing literal arguments (approx_percentile_cont(v, 0.9) -> (0.9,)).
    params: tuple = ()
    # agg(col) FILTER (WHERE cond) — evaluated per aggregate on the host
    # path (a filtered aggregate never rides the fused device kernel).
    filter_where: Optional[ast.Expr] = None


@dataclass(frozen=True)
class GroupKey:
    """A group-by key: a plain column or time_bucket(ts, interval)."""

    column: Optional[str] = None  # plain column grouping
    time_bucket_ms: Optional[int] = None  # time_bucket grouping width
    output_name: str = ""


@dataclass(frozen=True)
class QueryPlan:
    table: str
    schema: Schema
    select: ast.Select
    predicate: Predicate
    # Aggregation shape, filled when the query is scan+group+agg:
    aggs: tuple[AggCall, ...] = ()
    group_keys: tuple[GroupKey, ...] = ()
    is_aggregate: bool = False
    priority: QueryPriority = QueryPriority.HIGH
    # Arithmetic-over-aggregate select items: (output_name, expr) where
    # expr references hidden __aggN result columns; evaluated per group
    # AFTER aggregation (any path), then the hidden columns are dropped.
    agg_exprs: tuple[tuple[str, ast.Expr], ...] = ()


@dataclass(frozen=True)
class InsertPlan:
    table: str
    schema: Schema
    rows: tuple[dict, ...]


@dataclass(frozen=True)
class CreateTablePlan:
    table: str
    schema: Schema
    options: TableOptions
    raw_options: dict[str, str]
    if_not_exists: bool = False
    partition_by: Optional[ast.PartitionBy] = None


@dataclass(frozen=True)
class DropTablePlan:
    table: str
    if_exists: bool = False


@dataclass(frozen=True)
class DescribePlan:
    table: str


@dataclass(frozen=True)
class ShowTablesPlan:
    pass


@dataclass(frozen=True)
class ShowCreatePlan:
    table: str


@dataclass(frozen=True)
class ExistsPlan:
    table: str


@dataclass(frozen=True)
class ExplainPlan:
    inner: "QueryPlan | UnionPlan"
    analyze: bool = False


@dataclass(frozen=True)
class AlterTablePlan:
    table: str
    add_columns: tuple = ()
    set_options: dict[str, str] = field(default_factory=dict)


@dataclass(frozen=True)
class KillQueryPlan:
    """KILL QUERY <id>: flip the cancel flag on a live query in the
    process-global registry (utils/deadline.QUERY_REGISTRY)."""

    query_id: int


@dataclass(frozen=True)
class UnionPlan:
    """UNION [ALL]: branch plans executed independently, results aligned
    by position (names from the first branch), folded left-to-right —
    ``all_flags[i]`` is the i-th operator's ALL-ness; a distinct UNION
    dedups the accumulated result — then the union-level ORDER BY/LIMIT
    (ref: DataFusion's union plan surface,
    query_engine/src/datafusion_impl/mod.rs:54)."""

    branches: tuple[QueryPlan, ...]
    all_flags: tuple[bool, ...] = ()
    order_by: tuple = ()
    limit: "int | None" = None
    offset: int = 0


@dataclass(frozen=True)
class CTEPlan:
    """WITH bindings + the outer statement, both UNPLANNED: a cte's output
    schema only exists once it materializes, so interpreters plan lazily
    against the overlay of already-materialized ctes."""

    ctes: tuple  # ((name, ast.Select | ast.UnionSelect), ...)
    inner: object  # ast.Select | ast.UnionSelect (ctes stripped)


Plan = (
    QueryPlan
    | InsertPlan
    | CreateTablePlan
    | DropTablePlan
    | DescribePlan
    | ShowTablesPlan
    | ShowCreatePlan
    | ExistsPlan
    | AlterTablePlan
    | ExplainPlan
    | UnionPlan
    | CTEPlan
    | KillQueryPlan
)
