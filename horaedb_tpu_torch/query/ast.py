"""SQL AST nodes (expressions + statements).

Kept deliberately small: the expression grammar covers what the engine can
execute (arithmetic, comparisons, boolean logic, function calls, literals,
columns); statements cover the reference's Plan surface (plan.rs:67):
query, insert, create/drop/describe/alter/show/exists.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


# ---- expressions -------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    pass


@dataclass(frozen=True)
class Column(Expr):
    name: str
    # table qualifier from ``t.col`` syntax; resolution is by bare name,
    # but the planner validates the qualifier names a table in the query
    qualifier: Optional[str] = None

    def __str__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Literal(Expr):
    value: Any  # int | float | str | bool | None

    def __str__(self) -> str:
        if isinstance(self.value, str):
            return f"'{self.value}'"
        return str(self.value)


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str  # + - * / % = != < <= > >= AND OR
    left: Expr
    right: Expr

    def __str__(self) -> str:
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # NOT, -
    operand: Expr

    def __str__(self) -> str:
        return f"({self.op} {self.operand})"


@dataclass(frozen=True)
class Case(Expr):
    """CASE [operand] WHEN w THEN t ... [ELSE e] END.

    Simple CASE (with operand) is normalized by the parser into the
    searched form (operand = w -> operand IS NOT DISTINCT FROM w is not
    needed here: SQL simple CASE uses plain equality), so ``whens`` always
    holds boolean conditions."""

    whens: tuple[tuple[Expr, Expr], ...]  # (condition, result)
    else_: Optional[Expr] = None

    def __str__(self) -> str:
        parts = " ".join(f"WHEN {w} THEN {t}" for w, t in self.whens)
        tail = f" ELSE {self.else_}" if self.else_ is not None else ""
        return f"CASE {parts}{tail} END"


@dataclass(frozen=True)
class Cast(Expr):
    """CAST(expr AS type) — type is the SQL name, lowercased."""

    expr: Expr
    type_name: str

    def __str__(self) -> str:
        return f"CAST({self.expr} AS {self.type_name})"


@dataclass(frozen=True)
class Like(Expr):
    """expr [NOT] LIKE 'pattern' — % any run, _ one char; matches are
    case-sensitive (ILIKE relaxes)."""

    expr: Expr
    pattern: str
    negated: bool = False
    case_insensitive: bool = False

    def __str__(self) -> str:
        op = ("NOT " if self.negated else "") + ("ILIKE" if self.case_insensitive else "LIKE")
        return f"({self.expr} {op} '{self.pattern}')"


@dataclass(frozen=True)
class FuncCall(Expr):
    name: str  # lowercased
    args: tuple[Expr, ...]
    distinct: bool = False
    # agg(col) FILTER (WHERE cond) — standard SQL per-aggregate row filter
    filter_where: Optional["Expr"] = None

    def __str__(self) -> str:
        inner = ", ".join(str(a) for a in self.args)
        base = f"{self.name}({'DISTINCT ' if self.distinct else ''}{inner})"
        if self.filter_where is not None:
            base += f" FILTER (WHERE {self.filter_where})"
        return base


@dataclass(frozen=True)
class Star(Expr):
    def __str__(self) -> str:
        return "*"


@dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    values: tuple[Expr, ...]
    negated: bool = False

    def __str__(self) -> str:
        vals = ", ".join(str(v) for v in self.values)
        return f"({self.expr} {'NOT ' if self.negated else ''}IN ({vals}))"


@dataclass(frozen=True)
class Subquery(Expr):
    """Uncorrelated scalar subquery — evaluated once before the outer
    query and replaced with its single value."""

    select: "Select"

    def __str__(self) -> str:
        return f"(subquery:{self.select.table})"


class _CorrelatedDup:
    """Sentinel value for a correlation key whose non-aggregate scalar
    subquery matched more than one inner row. SQL errors only if such a
    key is actually PROBED by an outer row — so the error is raised at
    lookup time, not while materializing the inner result."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "<correlated-dup>"


CORRELATED_DUP = _CorrelatedDup()


@dataclass(frozen=True)
class CorrelatedLookup(Expr):
    """INTERNAL (never parsed): the decorrelated form of an
    equality-correlated scalar subquery. The inner aggregate has been
    computed once, grouped by its correlation keys; evaluation is a
    per-outer-row lookup on ``outer_cols`` (real Column nodes, so every
    expression walker — scan pruning, qualifier validation — sees them).
    ``default`` fills missing keys AND NULL-keyed outer rows (0 for
    COUNT, NULL otherwise — SQL's empty-group semantics)."""

    outer_cols: tuple["Column", ...]
    keys: tuple[tuple, ...]
    values: tuple
    default: object = None

    def __str__(self) -> str:
        return f"(corr-lookup:{','.join(c.name for c in self.outer_cols)})"


@dataclass(frozen=True)
class Exists(Expr):
    """[NOT handled by UnaryOp] EXISTS (SELECT ...) — a boolean semi-join
    probe. Uncorrelated: materializes to a constant. Equality-correlated:
    decorrelates into a distinct-key inner query + per-row membership
    lookup (the semi-join analog of the scalar decorrelation)."""

    select: "Select"

    def __str__(self) -> str:
        return f"EXISTS(subquery:{self.select.table})"


@dataclass(frozen=True)
class InSubquery(Expr):
    """expr [NOT] IN (SELECT col FROM ...) — uncorrelated; materialized
    into an InList before the outer query runs."""

    expr: Expr
    select: "Select"
    negated: bool = False

    def __str__(self) -> str:
        return f"({self.expr} {'NOT ' if self.negated else ''}IN subquery:{self.select.table})"


@dataclass(frozen=True)
class WindowSpec:
    """OVER (PARTITION BY ... ORDER BY ...) — no explicit frames; with an
    ORDER BY, aggregate windows use the SQL-default running frame (RANGE
    UNBOUNDED PRECEDING .. CURRENT ROW, peers included), without one the
    whole partition (the same defaults DataFusion gives the reference,
    query_engine/src/datafusion_impl/mod.rs:54)."""

    partition_by: tuple[Expr, ...] = ()
    order_by: tuple["OrderItem", ...] = ()


@dataclass(frozen=True)
class WindowFunc(Expr):
    """fn(args) OVER (spec). ``name`` is lowercased: row_number, rank,
    dense_rank, lag, lead, first_value, last_value, count, sum, avg,
    min, max."""

    name: str
    args: tuple[Expr, ...]
    spec: WindowSpec

    def __str__(self) -> str:
        inner = ", ".join(str(a) for a in self.args)
        return f"{self.name}({inner}) OVER (...)"


@dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr
    negated: bool = False


# ---- statements --------------------------------------------------------


@dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: Optional[str] = None

    @property
    def output_name(self) -> str:
        return self.alias if self.alias else str(self.expr)


@dataclass(frozen=True)
class OrderItem:
    expr: Expr
    ascending: bool = True
    # NULLS FIRST/LAST; None = SQL default (LAST when ASC, FIRST when DESC)
    nulls_last: Optional[bool] = None


@dataclass(frozen=True)
class Join:
    """Equi-key join: [LEFT|RIGHT|FULL [OUTER]] JOIN <table> ON
    <l.k1> = <r.k1> [AND ...].

    ``left_cols[i]`` pairs with ``right_cols[i]`` (conjunction of
    equalities; the reference gets arbitrary join conditions from
    DataFusion — this is the host-path equi-join subset). In a chain,
    ``left_cols`` may name columns from ANY earlier table (the combined
    row so far — standard left-to-right join evaluation)."""

    table: str
    left_cols: tuple[str, ...]
    right_cols: tuple[str, ...]
    kind: str = "inner"  # "inner" | "left" | "right" | "full"


@dataclass(frozen=True)
class Select:
    items: tuple[SelectItem, ...]
    table: Optional[str]
    where: Optional[Expr] = None
    group_by: tuple[Expr, ...] = ()
    order_by: tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0
    having: Optional[Expr] = None
    distinct: bool = False
    join: Optional[Join] = None
    # Joins AFTER the first (>2-table chains, folded left-to-right);
    # ``join`` stays the first so every `stmt.join is not None` presence
    # check keeps working.
    joins: tuple[Join, ...] = ()
    # WITH name AS (...) bindings visible to this select (and, through
    # the interpreter's overlay, to later ctes in the same statement)
    ctes: tuple[tuple[str, "Select | UnionSelect"], ...] = ()


@dataclass(frozen=True)
class UnionSelect:
    """s1 UNION [ALL] s2 [UNION ...] — columns align by position, names
    come from the first branch; a trailing ORDER BY/LIMIT applies to the
    combined result (standard SQL placement).

    ``all_flags[i]`` is the ALL-ness of the i-th UNION operator (between
    selects[i] and selects[i+1]); mixed chains evaluate left-to-right —
    a distinct UNION dedups everything accumulated so far, a UNION ALL
    appends (standard left-associative semantics)."""

    selects: tuple[Select, ...]
    all_flags: tuple[bool, ...] = ()
    order_by: tuple[OrderItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0
    ctes: tuple[tuple[str, "Select | UnionSelect"], ...] = ()

    @property
    def all(self) -> bool:
        return all(self.all_flags)


@dataclass(frozen=True)
class ColumnDef:
    name: str
    type_name: str
    is_tag: bool = False
    is_timestamp_key: bool = False
    not_null: bool = False
    comment: str = ""


@dataclass(frozen=True)
class CreateTable:
    table: str
    columns: tuple[ColumnDef, ...]
    timestamp_key: Optional[str]  # from inline `timestamp KEY` or TIMESTAMP KEY(col)
    primary_key: Optional[tuple[str, ...]]
    engine: str = "Analytic"
    options: dict[str, str] = field(default_factory=dict)
    if_not_exists: bool = False
    partition_by: Optional["PartitionBy"] = None


@dataclass(frozen=True)
class PartitionBy:
    """PARTITION BY KEY(cols) PARTITIONS n — ref: parser.rs partition DDL."""

    method: str  # "key" | "hash"
    columns: tuple[str, ...]
    num_partitions: int


@dataclass(frozen=True)
class Insert:
    table: str
    columns: tuple[str, ...]
    values: tuple[tuple[Any, ...], ...]  # literal rows


@dataclass(frozen=True)
class DropTable:
    table: str
    if_exists: bool = False


@dataclass(frozen=True)
class Describe:
    table: str


@dataclass(frozen=True)
class ShowTables:
    pass


@dataclass(frozen=True)
class ShowCreateTable:
    table: str


@dataclass(frozen=True)
class ExistsTable:
    table: str


@dataclass(frozen=True)
class AlterTableAddColumn:
    table: str
    columns: tuple[ColumnDef, ...]


@dataclass(frozen=True)
class AlterTableSetOptions:
    table: str
    options: dict[str, str]


@dataclass(frozen=True)
class Explain:
    inner: "Select | UnionSelect"
    analyze: bool = False


@dataclass(frozen=True)
class KillQuery:
    """KILL QUERY <id> — cooperative cancellation of a live query (the
    id from ``system.public.queries`` / ``/debug/queries?live=1``)."""

    query_id: int


Statement = (
    Select
    | UnionSelect
    | CreateTable
    | Insert
    | DropTable
    | Describe
    | ShowTables
    | ShowCreateTable
    | ExistsTable
    | AlterTableAddColumn
    | AlterTableSetOptions
    | KillQuery
)
