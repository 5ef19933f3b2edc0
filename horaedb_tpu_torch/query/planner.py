"""Planner: AST -> Plan (ref: query_frontend/src/planner.rs).

Besides shape-checking against the schema, the planner does the two
analyses the device executor depends on:

- predicate extraction: WHERE conjuncts on the timestamp column become the
  scan ``TimeRange``; ``col op literal`` conjuncts become pushable filters
  (ref: table_engine/src/predicate.rs time-range extraction);
- aggregation shape: aggregate calls + group keys (plain columns or
  ``time_bucket``) are lifted out of the select list so the executor can
  route the query to the fused device kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from ..common_types.datum import DatumKind
from ..common_types.schema import ColumnSchema, Schema
from ..common_types.time_range import MAX_TIMESTAMP, MIN_TIMESTAMP, TimeRange
from ..engine.options import TableOptions, parse_duration_ms
from ..table_engine.predicate import ColumnFilter, FilterOp, Predicate
from . import ast
from .plan import (
    AggCall,
    AlterTablePlan,
    CreateTablePlan,
    DescribePlan,
    DropTablePlan,
    EXPENSIVE_QUERY_RANGE_MS,
    ExistsPlan,
    GroupKey,
    InsertPlan,
    Plan,
    QueryPlan,
    QueryPriority,
    ShowCreatePlan,
    ShowTablesPlan,
)

AGG_FUNCS = {"count", "sum", "min", "max", "avg"}


def _is_agg_name(name: str) -> bool:
    """Core aggregates plus anything in the function registry (UDAFs —
    ref: df_operator registry.rs; e.g. thetasketch_distinct)."""
    if name in AGG_FUNCS:
        return True
    from .functions import REGISTRY

    return (
        REGISTRY.aggregate(name) is not None
        or REGISTRY.binary_aggregate(name) is not None
    )


class PlanError(ValueError):
    pass


class Planner:
    """``schema_of(table) -> Schema | None`` is the MetaProvider analog
    (ref: query_frontend/src/provider.rs)."""

    def __init__(self, schema_of: Callable[[str], Optional[Schema]]) -> None:
        self.schema_of = schema_of

    def plan(self, stmt: ast.Statement) -> Plan:
        if isinstance(stmt, ast.Explain):
            from .plan import ExplainPlan

            return ExplainPlan(self.plan(stmt.inner), analyze=stmt.analyze)
        if isinstance(stmt, (ast.Select, ast.UnionSelect)) and stmt.ctes:
            # CTE bodies and the outer statement plan lazily at execution:
            # each cte's output schema exists only once it materializes
            # (interpreters._cte).
            from .plan import CTEPlan
            import dataclasses as _dc

            return CTEPlan(ctes=stmt.ctes, inner=_dc.replace(stmt, ctes=()))
        if isinstance(stmt, ast.UnionSelect):
            from .plan import UnionPlan

            branches = tuple(self._plan_select(s) for s in stmt.selects)
            if not any(
                isinstance(i.expr, ast.Star)
                for b in branches
                for i in b.select.items
            ):
                if len({len(b.select.items) for b in branches}) > 1:
                    raise PlanError("UNION branches have different column counts")
            return UnionPlan(
                branches=branches,
                all_flags=stmt.all_flags,
                order_by=stmt.order_by,
                limit=stmt.limit,
                offset=stmt.offset,
            )
        if isinstance(stmt, ast.Select):
            return self._plan_select(stmt)
        if isinstance(stmt, ast.CreateTable):
            return self._plan_create(stmt)
        if isinstance(stmt, ast.Insert):
            return self._plan_insert(stmt)
        if isinstance(stmt, ast.DropTable):
            return DropTablePlan(stmt.table, stmt.if_exists)
        if isinstance(stmt, ast.Describe):
            self._require_schema(stmt.table)
            return DescribePlan(stmt.table)
        if isinstance(stmt, ast.ShowTables):
            return ShowTablesPlan()
        if isinstance(stmt, ast.ShowCreateTable):
            self._require_schema(stmt.table)
            return ShowCreatePlan(stmt.table)
        if isinstance(stmt, ast.ExistsTable):
            return ExistsPlan(stmt.table)
        if isinstance(stmt, ast.KillQuery):
            from .plan import KillQueryPlan

            return KillQueryPlan(stmt.query_id)
        if isinstance(stmt, ast.AlterTableAddColumn):
            schema = self._require_schema(stmt.table)
            cols = tuple(
                ColumnSchema(
                    c.name,
                    DatumKind.from_sql_type(c.type_name),
                    is_nullable=not c.not_null,
                    is_tag=c.is_tag,
                    comment=c.comment,
                )
                for c in stmt.columns
            )
            for c in cols:
                if c.is_tag:
                    raise PlanError("cannot ADD a TAG column")
                if not c.is_nullable:
                    # Existing rows can only surface NULL for the new column.
                    raise PlanError("added columns must be nullable")
                if schema.has_column(c.name):
                    raise PlanError(f"column {c.name!r} already exists")
            return AlterTablePlan(stmt.table, add_columns=cols)
        if isinstance(stmt, ast.AlterTableSetOptions):
            self._require_schema(stmt.table)
            return AlterTablePlan(stmt.table, set_options=dict(stmt.options))
        raise PlanError(f"unsupported statement: {type(stmt).__name__}")

    def _require_schema(self, table: str) -> Schema:
        schema = self.schema_of(table)
        if schema is None:
            raise PlanError(f"table not found: {table}")
        return schema

    # ---- CREATE ----------------------------------------------------------
    def _plan_create(self, stmt: ast.CreateTable) -> CreateTablePlan:
        if stmt.engine.lower() != "analytic":
            raise PlanError(f"unsupported engine {stmt.engine!r}")
        if stmt.timestamp_key is None:
            raise PlanError("CREATE TABLE requires a TIMESTAMP KEY column")
        cols = []
        for c in stmt.columns:
            kind = DatumKind.from_sql_type(c.type_name)
            if c.is_tag and not kind.is_key_kind:
                raise PlanError(f"column {c.name}: {c.type_name} cannot be TAG")
            cols.append(
                ColumnSchema(
                    c.name,
                    kind,
                    is_nullable=not c.not_null,
                    is_tag=c.is_tag,
                    comment=c.comment,
                )
            )
        schema = Schema.build(
            cols,
            timestamp_column=stmt.timestamp_key,
            primary_key=list(stmt.primary_key) if stmt.primary_key else None,
        )
        if stmt.partition_by is not None:
            for c in stmt.partition_by.columns:
                if not schema.has_column(c):
                    raise PlanError(f"partition column {c!r} not defined")
                if not schema.column(c).kind.is_key_kind:
                    raise PlanError(f"partition column {c!r} must be a key kind")
            if stmt.partition_by.method == "hash":
                if len(stmt.partition_by.columns) != 1:
                    raise PlanError("PARTITION BY HASH takes exactly one column")
                kind = schema.column(stmt.partition_by.columns[0]).kind
                if not kind.is_integer:
                    raise PlanError(
                        "PARTITION BY HASH requires an integer column; "
                        "use PARTITION BY KEY for strings"
                    )
            if stmt.partition_by.num_partitions < 1:
                raise PlanError("PARTITIONS must be >= 1")
        options = TableOptions.from_kv(stmt.options)
        return CreateTablePlan(
            table=stmt.table,
            schema=schema,
            options=options,
            raw_options=dict(stmt.options),
            if_not_exists=stmt.if_not_exists,
            partition_by=stmt.partition_by,
        )

    # ---- INSERT ----------------------------------------------------------
    def _plan_insert(self, stmt: ast.Insert) -> InsertPlan:
        schema = self._require_schema(stmt.table)
        columns = stmt.columns
        if not columns:
            # positional: all non-generated columns in schema order
            columns = tuple(
                c.name
                for c in schema.columns
                if schema.tsid_index is None or c.name != schema.columns[schema.tsid_index].name
            )
        for c in columns:
            if not schema.has_column(c):
                raise PlanError(f"unknown column {c!r} in INSERT")
        rows = []
        for vals in stmt.values:
            if len(vals) != len(columns):
                raise PlanError(
                    f"INSERT arity mismatch: {len(columns)} columns, {len(vals)} values"
                )
            rows.append(dict(zip(columns, vals)))
        return InsertPlan(stmt.table, schema, tuple(rows))

    # ---- SELECT ----------------------------------------------------------
    def _plan_select(self, stmt: ast.Select) -> QueryPlan:
        if stmt.table is None:
            raise PlanError("SELECT without FROM is not supported")
        if stmt.having is not None and not stmt.group_by:
            raise PlanError("HAVING requires GROUP BY (use WHERE for row filters)")
        self._check_qualifiers(stmt)
        if stmt.join is not None:
            # Joined queries validate against the COMBINED schema at
            # execution (query/join.py); the plan is a thin carrier.
            if stmt.group_by or any(
                isinstance(e, ast.FuncCall) and _is_agg_name(e.name)
                for item in stmt.items
                for e in _walk(item.expr)
            ):
                raise PlanError("aggregates over JOIN are not supported yet")
            schema = self._require_schema(stmt.table)
            from ..table_engine.predicate import Predicate

            return QueryPlan(
                table=stmt.table,
                schema=schema,
                select=stmt,
                predicate=Predicate.all_time(),
                aggs=(),
                group_keys=(),
                is_aggregate=False,
                priority=QueryPriority.HIGH,
            )
        schema = self._require_schema(stmt.table)
        stmt = self._resolve_group_by_aliases(stmt, schema)
        self._check_columns(stmt, schema)
        self._check_windows(stmt)

        predicate = extract_predicate(stmt.where, schema)
        aggs, group_keys, is_agg, agg_exprs = self._agg_shape(stmt, schema)

        tr = predicate.time_range
        span = tr.exclusive_end - tr.inclusive_start
        priority = (
            QueryPriority.LOW if span > EXPENSIVE_QUERY_RANGE_MS else QueryPriority.HIGH
        )
        return QueryPlan(
            table=stmt.table,
            schema=schema,
            select=stmt,
            predicate=predicate,
            aggs=aggs,
            group_keys=group_keys,
            is_aggregate=is_agg,
            priority=priority,
            agg_exprs=agg_exprs,
        )

    def _resolve_group_by_aliases(self, stmt: ast.Select, schema: Schema) -> ast.Select:
        """``GROUP BY b`` where ``b`` is a SELECT alias of an expression
        (``SELECT time_bucket(ts, '1m') AS b ... GROUP BY b``) substitutes
        the aliased expression — standard SQL/DataFusion behavior. A real
        schema column of the same name takes precedence (the standard's
        resolution order), so existing queries never change meaning."""
        if not stmt.group_by:
            return stmt
        alias_map = {
            item.alias: item.expr for item in stmt.items if item.alias
        }
        if not alias_map:
            return stmt
        new_gb = tuple(
            alias_map[g.name]
            if (
                isinstance(g, ast.Column)
                and g.qualifier is None
                and not schema.has_column(g.name)
                and g.name in alias_map
            )
            else g
            for g in stmt.group_by
        )
        if new_gb == stmt.group_by:
            return stmt
        return dataclasses.replace(stmt, group_by=new_gb)

    def _check_qualifiers(self, stmt: ast.Select) -> None:
        """``t.col`` qualifiers must name a table in the query — a silent
        wrong-table binding would mask user errors."""
        known = {stmt.table}
        if stmt.join is not None:
            known.add(stmt.join.table)
        for j in stmt.joins:
            known.add(j.table)
        # Qualified table names may be referenced by their last component
        # (FROM public.cpu ... WHERE cpu.usage > 0).
        for full in list(known):
            if "." in full:
                known.add(full.rsplit(".", 1)[-1])
        sources = [item.expr for item in stmt.items]
        sources += [e for e in (stmt.where, stmt.having, *stmt.group_by) if e is not None]
        sources += [o.expr for o in stmt.order_by]
        for src in sources:
            for e in _walk(src):
                if (
                    isinstance(e, ast.Column)
                    and e.qualifier is not None
                    and e.qualifier not in known
                ):
                    raise PlanError(
                        f"unknown table qualifier {e.qualifier!r} for column "
                        f"{e.name!r}"
                    )

    def _check_columns(self, stmt: ast.Select, schema: Schema) -> None:
        aliases = {item.alias for item in stmt.items if item.alias}
        for item in stmt.items:
            for e in _walk(item.expr):
                if isinstance(e, ast.Column) and not schema.has_column(e.name):
                    raise PlanError(f"unknown column {e.name!r}")
        for src in (stmt.where, *stmt.group_by):
            if src is None:
                continue
            for e in _walk(src):
                if isinstance(e, ast.Column) and not schema.has_column(e.name):
                    raise PlanError(f"unknown column {e.name!r}")
        # ORDER BY may reference select aliases as well as table columns.
        for o in stmt.order_by:
            for e in _walk(o.expr):
                if (
                    isinstance(e, ast.Column)
                    and not schema.has_column(e.name)
                    and e.name not in aliases
                ):
                    raise PlanError(f"unknown column {e.name!r}")

    _WINDOW_FUNCS = {
        "row_number", "rank", "dense_rank", "lag", "lead",
        "first_value", "last_value", "count", "sum", "avg", "min", "max",
    }

    def _check_windows(self, stmt: ast.Select) -> None:
        """Window functions may appear only in the select list (possibly
        inside larger expressions) — never in WHERE/GROUP BY/HAVING, and
        not mixed with grouped aggregation (windows run over scan rows)."""
        for src, where in (
            (stmt.where, "WHERE"),
            (stmt.having, "HAVING"),
            *((g, "GROUP BY") for g in stmt.group_by),
        ):
            if src is None:
                continue
            if any(isinstance(e, ast.WindowFunc) for e in _walk(src)):
                raise PlanError(f"window functions are not allowed in {where}")
        wfs = [
            e
            for item in stmt.items
            for e in _walk(item.expr)
            if isinstance(e, ast.WindowFunc)
        ]
        if not wfs:
            return
        if stmt.group_by or any(
            isinstance(e, ast.FuncCall) and _is_agg_name(e.name)
            for item in stmt.items
            for e in _walk(item.expr)
        ):
            raise PlanError(
                "window functions cannot be mixed with GROUP BY aggregation "
                "(wrap the aggregate in a WITH cte and window over it)"
            )
        for w in wfs:
            if w.name not in self._WINDOW_FUNCS:
                raise PlanError(f"unknown window function {w.name!r}")
            if w.name in ("row_number", "rank", "dense_rank"):
                if w.args:
                    raise PlanError(f"{w.name}() takes no arguments")
                if not w.spec.order_by:
                    raise PlanError(f"{w.name}() requires ORDER BY in OVER()")
            elif w.name in ("lag", "lead"):
                if not 1 <= len(w.args) <= 3:
                    raise PlanError(f"{w.name}(value[, offset[, default]])")
                if len(w.args) >= 2 and not (
                    isinstance(w.args[1], ast.Literal)
                    and isinstance(w.args[1].value, int)
                ):
                    raise PlanError(f"{w.name} offset must be an integer literal")
                if not w.spec.order_by:
                    raise PlanError(f"{w.name}() requires ORDER BY in OVER()")
            elif w.name in ("first_value", "last_value"):
                if len(w.args) != 1:
                    raise PlanError(f"{w.name}(value) expects one argument")
            elif w.name == "count":
                if len(w.args) > 1:
                    raise PlanError("count([value]) window expects <= 1 argument")
            else:  # sum/avg/min/max
                if len(w.args) != 1:
                    raise PlanError(f"{w.name}(value) window expects one argument")

    def _make_agg_call(
        self, e: ast.FuncCall, output_name: str, schema: Schema
    ) -> AggCall:
        from .functions import REGISTRY as _FN

        col = None
        col2 = None
        params: tuple = ()
        is_binary = _FN.binary_aggregate(e.name) is not None
        if e.args and not isinstance(e.args[0], ast.Star):
            if (
                e.name == "count"
                and isinstance(e.args[0], ast.Literal)
                and e.args[0].value is not None
            ):
                pass  # count(1) == count(*)
            elif not isinstance(e.args[0], ast.Column):
                raise PlanError(
                    f"aggregate over expression not supported: {e}"
                )
            else:
                col = e.args[0].name
        if e.name != "count" and col is None:
            raise PlanError(f"{e.name} requires a column argument")
        if is_binary:
            if len(e.args) != 2 or not isinstance(e.args[1], ast.Column):
                raise PlanError(
                    f"{e.name}(x, y) expects two column arguments"
                )
            col2 = e.args[1].name
        elif len(e.args) > 1:
            # Trailing literal parameters (approx_percentile_cont).
            extra = e.args[1:]
            if not all(isinstance(a, ast.Literal) for a in extra):
                raise PlanError(
                    f"extra arguments of {e.name} must be literals"
                )
            params = tuple(a.value for a in extra)
        numeric_required = e.name in ("sum", "avg") or _FN.numeric_only(e.name)
        if numeric_required:
            for c in (col, col2):
                if c is not None and not schema.column(c).kind.is_numeric:
                    raise PlanError(
                        f"{e.name}({c}) requires a numeric column"
                    )
        return AggCall(
            e.name, col, output_name, e.distinct,
            column2=col2, params=params, filter_where=e.filter_where,
        )

    def _agg_shape(
        self, stmt: ast.Select, schema: Schema
    ) -> tuple[tuple[AggCall, ...], tuple[GroupKey, ...], bool, tuple]:
        aggs: list[AggCall] = []
        has_agg = any(
            isinstance(e, ast.FuncCall) and _is_agg_name(e.name)
            for item in stmt.items
            for e in _walk(item.expr)
        )
        if not has_agg:
            if stmt.group_by:
                raise PlanError("GROUP BY without aggregates is not supported")
            return (), (), False, ()

        group_keys: list[GroupKey] = []
        for g in stmt.group_by:
            group_keys.append(_group_key(g, schema))
        group_names = {k.output_name for k in group_keys}

        # Hidden aggregates lifted out of arithmetic-over-aggregate select
        # items (sum(v) / count(*)); deduped by their SQL rendering, and
        # against identical SELECT-level aggregates (computed once). Names
        # must not collide with user aliases — '__aggN' is not reserved
        # syntax, so probe for a free name instead of assuming.
        hidden: dict[str, AggCall] = {}
        agg_exprs: list[tuple[str, ast.Expr]] = []
        plain_by_render: dict[str, str] = {
            str(item.expr): item.output_name
            for item in stmt.items
            if isinstance(item.expr, ast.FuncCall) and _is_agg_name(item.expr.name)
        }
        used_names = {item.output_name for item in stmt.items}

        def hidden_name() -> str:
            i = len(hidden)
            while f"__agg{i}" in used_names:
                i += 1
            name = f"__agg{i}"
            used_names.add(name)
            return name

        def lift(expr: ast.Expr) -> ast.Expr:
            """Replace aggregate calls with hidden result columns; validate
            the remaining leaves resolve per-group."""
            if isinstance(expr, ast.FuncCall) and _is_agg_name(expr.name):
                key = str(expr)
                if key in plain_by_render:
                    # The same aggregate is already a SELECT item — read
                    # its result column instead of computing it twice.
                    return ast.Column(plain_by_render[key])
                if key not in hidden:
                    hidden[key] = self._make_agg_call(expr, hidden_name(), schema)
                return ast.Column(hidden[key].output_name)
            if isinstance(expr, ast.Column):
                if expr.name not in group_names:
                    raise PlanError(
                        f"column {expr.name!r} must appear in GROUP BY "
                        f"or an aggregate"
                    )
                return expr
            if isinstance(expr, ast.Literal):
                return expr
            if isinstance(expr, ast.BinaryOp):
                return ast.BinaryOp(expr.op, lift(expr.left), lift(expr.right))
            if isinstance(expr, ast.UnaryOp):
                return ast.UnaryOp(expr.op, lift(expr.operand))
            if isinstance(expr, ast.Cast):
                return ast.Cast(lift(expr.expr), expr.type_name)
            if isinstance(expr, ast.Case):
                return ast.Case(
                    tuple((lift(w), lift(t)) for w, t in expr.whens),
                    lift(expr.else_) if expr.else_ is not None else None,
                )
            if isinstance(expr, ast.FuncCall):
                return ast.FuncCall(
                    expr.name, tuple(lift(a) for a in expr.args), expr.distinct
                )
            if isinstance(expr, ast.IsNull):
                return ast.IsNull(lift(expr.expr), expr.negated)
            if isinstance(expr, ast.Between):
                return ast.Between(
                    lift(expr.expr), lift(expr.low), lift(expr.high), expr.negated
                )
            if isinstance(expr, ast.InList):
                return ast.InList(
                    lift(expr.expr),
                    tuple(lift(v) for v in expr.values),
                    expr.negated,
                )
            if isinstance(expr, ast.Like):
                return ast.Like(
                    lift(expr.expr), expr.pattern, expr.negated,
                    expr.case_insensitive,
                )
            raise PlanError(
                f"unsupported expression over aggregates: {expr}"
            )

        for item in stmt.items:
            e = item.expr
            if isinstance(e, ast.FuncCall) and _is_agg_name(e.name):
                aggs.append(self._make_agg_call(e, item.output_name, schema))
            elif isinstance(e, ast.Column):
                if e.name not in group_names:
                    raise PlanError(
                        f"column {e.name!r} must appear in GROUP BY or an aggregate"
                    )
            elif isinstance(e, ast.FuncCall) and e.name in ("time_bucket", "date_trunc"):
                if e.filter_where is not None:
                    raise PlanError(
                        f"FILTER is only valid on aggregate functions, not {e.name}"
                    )
                key = _group_key(e, schema)
                if key.output_name not in {k.output_name for k in group_keys}:
                    raise PlanError(f"{e.name} in SELECT must also be in GROUP BY")
            elif any(
                isinstance(x, ast.FuncCall) and _is_agg_name(x.name)
                for x in _walk(e)
            ):
                # Arithmetic (or CASE/CAST/scalar calls) over aggregates:
                # evaluate per group AFTER aggregation.
                agg_exprs.append((item.output_name, lift(e)))
            else:
                raise PlanError(f"unsupported select item in aggregate query: {e}")
        aggs.extend(hidden.values())
        return tuple(aggs), tuple(group_keys), True, tuple(agg_exprs)


# Fixed-width date_trunc units map onto the bucket kernel; month/year are
# calendar-variable and stay unsupported (clear error beats wrong buckets).
_DATE_TRUNC_MS = {
    "millisecond": 1, "second": 1_000, "minute": 60_000, "hour": 3_600_000,
    "day": 86_400_000, "week": 7 * 86_400_000,
}


def _group_key(e: ast.Expr, schema: Schema) -> GroupKey:
    if isinstance(e, ast.Column):
        return GroupKey(column=e.name, output_name=e.name)
    if isinstance(e, ast.FuncCall) and e.name == "time_bucket":
        if len(e.args) != 2:
            raise PlanError("time_bucket(timestamp_col, 'interval') expects 2 args")
        col, interval = e.args
        if not isinstance(col, ast.Column) or col.name != schema.timestamp_name:
            raise PlanError("time_bucket must be applied to the timestamp key column")
        if isinstance(interval, ast.Literal) and isinstance(interval.value, str):
            width = parse_duration_ms(interval.value)
        elif (
            isinstance(interval, ast.Literal)
            and isinstance(interval.value, (int, float))
            and not isinstance(interval.value, bool)
            and interval.value > 0
            and int(interval.value) == interval.value
        ):
            width = int(interval.value)  # milliseconds (whole ms only —
            # a fractional width would truncate to a 0-width bucket)
        else:
            raise PlanError(
                "time_bucket interval must be a duration string like '1h' "
                "or a positive millisecond count"
            )
        return GroupKey(time_bucket_ms=width, output_name=str(e))
    if isinstance(e, ast.FuncCall) and e.name == "date_trunc":
        if len(e.args) != 2:
            raise PlanError("date_trunc('unit', timestamp_col) expects 2 args")
        unit, col = e.args
        if not isinstance(col, ast.Column) or col.name != schema.timestamp_name:
            raise PlanError("date_trunc must be applied to the timestamp key column")
        if not isinstance(unit, ast.Literal) or not isinstance(unit.value, str):
            raise PlanError("date_trunc unit must be a string literal")
        width = _DATE_TRUNC_MS.get(unit.value.lower())
        if width is None:
            raise PlanError(
                f"unsupported date_trunc unit {unit.value!r} "
                f"(supported: {', '.join(sorted(_DATE_TRUNC_MS))})"
            )
        return GroupKey(time_bucket_ms=width, output_name=str(e))
    raise PlanError(f"unsupported GROUP BY expression: {e}")


# ---- predicate extraction ----------------------------------------------

_CMP_TO_FILTER = {
    "=": FilterOp.EQ,
    "!=": FilterOp.NE,
    "<": FilterOp.LT,
    "<=": FilterOp.LE,
    ">": FilterOp.GT,
    ">=": FilterOp.GE,
}
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}


def extract_predicate(where: Optional[ast.Expr], schema: Schema) -> Predicate:
    """Time range + pushable filters from the WHERE conjunction.

    Only top-level AND conjuncts are pushable (a disjunct can't narrow the
    scan). Conjuncts that don't fit ``col op literal`` remain in the
    executor's exact post-filter — extraction here is sound, not complete.
    """
    if where is None:
        return Predicate.all_time()
    ts_name = schema.timestamp_name
    lo, hi = MIN_TIMESTAMP, MAX_TIMESTAMP
    filters: list[ColumnFilter] = []
    for conj in _conjuncts(where):
        simple = _as_simple_cmp(conj)
        if simple is None:
            if isinstance(conj, ast.Between) and not conj.negated:
                col = conj.expr
                if (
                    isinstance(col, ast.Column)
                    and isinstance(conj.low, ast.Literal)
                    and isinstance(conj.high, ast.Literal)
                ):
                    if col.name == ts_name:
                        lo = max(lo, int(conj.low.value))
                        hi = min(hi, int(conj.high.value) + 1)
                    else:
                        filters.append(ColumnFilter(col.name, FilterOp.GE, conj.low.value))
                        filters.append(ColumnFilter(col.name, FilterOp.LE, conj.high.value))
            elif isinstance(conj, ast.InList) and not conj.negated:
                col = conj.expr
                if isinstance(col, ast.Column) and all(
                    isinstance(v, ast.Literal) for v in conj.values
                ):
                    filters.append(
                        ColumnFilter(
                            col.name,
                            FilterOp.IN,
                            tuple(v.value for v in conj.values),
                        )
                    )
            continue
        col, op, value = simple
        if col == ts_name:
            v = int(value)
            if op == "=":
                lo, hi = max(lo, v), min(hi, v + 1)
            elif op == "<":
                hi = min(hi, v)
            elif op == "<=":
                hi = min(hi, v + 1)
            elif op == ">":
                lo = max(lo, v + 1)
            elif op == ">=":
                lo = max(lo, v)
            else:  # != — not range-expressible; leave to post-filter
                filters.append(ColumnFilter(col, FilterOp.NE, v))
        else:
            filters.append(ColumnFilter(col, _CMP_TO_FILTER[op], value))
    if hi < lo:
        return Predicate(TimeRange.empty(), tuple(filters))
    return Predicate(TimeRange(lo, hi), tuple(filters))


def _conjuncts(e: ast.Expr) -> list[ast.Expr]:
    if isinstance(e, ast.BinaryOp) and e.op.upper() == "AND":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _as_simple_cmp(e: ast.Expr) -> Optional[tuple[str, str, Any]]:
    if not isinstance(e, ast.BinaryOp) or e.op not in _CMP_TO_FILTER:
        return None
    l, r = e.left, e.right
    if isinstance(l, ast.Column) and isinstance(r, ast.Literal):
        return l.name, e.op, r.value
    if isinstance(l, ast.Literal) and isinstance(r, ast.Column):
        return r.name, _FLIP[e.op], l.value
    # fold unary minus literals
    if isinstance(l, ast.Column) and isinstance(r, ast.UnaryOp) and r.op == "-" and isinstance(r.operand, ast.Literal):
        return l.name, e.op, -r.operand.value
    return None


def _walk(e: ast.Expr):
    yield e
    if isinstance(e, ast.BinaryOp):
        yield from _walk(e.left)
        yield from _walk(e.right)
    elif isinstance(e, ast.UnaryOp):
        yield from _walk(e.operand)
    elif isinstance(e, ast.FuncCall):
        for a in e.args:
            yield from _walk(a)
        if e.filter_where is not None:
            yield from _walk(e.filter_where)
    elif isinstance(e, ast.Case):
        for w, t in e.whens:
            yield from _walk(w)
            yield from _walk(t)
        if e.else_ is not None:
            yield from _walk(e.else_)
    elif isinstance(e, ast.Cast):
        yield from _walk(e.expr)
    elif isinstance(e, ast.Like):
        yield from _walk(e.expr)
    elif isinstance(e, ast.InList):
        yield from _walk(e.expr)
        for v in e.values:
            yield from _walk(v)
    elif isinstance(e, ast.InSubquery):
        # the LEFT side lives in the outer scope; the inner select has its
        # own table scope and is validated when it is planned
        yield from _walk(e.expr)
    elif isinstance(e, ast.Between):
        yield from _walk(e.expr)
        yield from _walk(e.low)
        yield from _walk(e.high)
    elif isinstance(e, ast.IsNull):
        yield from _walk(e.expr)
    elif isinstance(e, ast.CorrelatedLookup):
        # the correlation columns are outer-scope references — scan
        # pruning and qualifier validation must see them
        for c in e.outer_cols:
            yield from _walk(c)
    elif isinstance(e, ast.WindowFunc):
        for a in e.args:
            yield from _walk(a)
        for p in e.spec.partition_by:
            yield from _walk(p)
        for o in e.spec.order_by:
            yield from _walk(o.expr)


def _walk_exprs(stmt: ast.Select):
    for item in stmt.items:
        yield from _walk(item.expr)
    if stmt.where is not None:
        yield from _walk(stmt.where)
    for g in stmt.group_by:
        yield from _walk(g)
    for o in stmt.order_by:
        yield from _walk(o.expr)
