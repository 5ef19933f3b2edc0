"""Transparent rollup serving — the query rewrite
(ref: materialized-view matching in every warehouse, scoped to the
dashboard shape this engine's ladder stores: ``SELECT time_bucket(ts, W),
tags..., agg(value) ... GROUP BY ...`` with W a multiple of a maintained
tier).

``rollup_decision_for`` is the ONE predicate deciding whether a plan can
be served from a rollup tier — the executor hook and EXPLAIN both call
it, so what EXPLAIN promises and what execution does cannot drift (the
``resolves_to_samples`` discipline). A decision splits the time range on
W-aligned COMPLETE-bucket boundaries (lo = start rounded UP to the step,
cut = the tier watermark rounded down):

    [start, lo)   -> raw (the partial HEAD bucket a non-aligned lower
                     bound truncates — stored whole-bucket partials
                     cannot represent it)
    [lo, cut)     -> the rollup table (partials re-aggregated: sum ==
                     sum(agg_sum), count == sum(agg_count), min/max fold,
                     avg == sum(agg_sum)/sum(agg_count))
    [cut, end)    -> raw (the still-open tail the maintainer hasn't
                     closed yet — a dashboard's 'now' edge stays fresh)

Both halves run as ordinary plans through the executor (each taking its
own best path — the rollup scan is the small one); the W-aligned cut
makes their group sets disjoint, so the results concatenate, then the
original ORDER BY / LIMIT / OFFSET apply to the combined set. The
rewrite is visible as ``route=rollup`` in the ledger/query_stats and as
a ``Rollup:`` line in EXPLAIN. ``HORAEDB_ROLLUP=0`` kills the rewrite.

Refused shapes (served raw, never wrong): a non-value aggregate column,
count(*) (the ladder stores count(value) — NULLs differ), DISTINCT
aggregates, FILTER clauses, HAVING, joins, arithmetic over aggregates,
residual WHERE on non-tag columns, a step that no tier divides, and
ORDER BY expressions that are not output columns.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from ..common_types.time_range import MAX_TIMESTAMP, MIN_TIMESTAMP
from ..query import ast
from ..query.plan import QueryPlan
from .rollup import ROLLUPS, AGG_COLS, RollupState, rollup_table_name

# aggregate func -> how it folds over the stored partials
_FOLDABLE = ("sum", "count", "min", "max", "avg")


def rollup_enabled() -> bool:
    return os.environ.get("HORAEDB_ROLLUP", "1") != "0"


@dataclass(frozen=True)
class RollupDecision:
    source: str
    rollup_table: str
    suffix: str
    tier_ms: int
    step_ms: int
    # W-aligned complete-bucket window: the rollup serves [lo, cut); raw
    # computes the partial HEAD [start, lo) (a non-aligned lower bound
    # truncates its first bucket — stored partials can't represent that)
    # and the still-open TAIL [cut, end)
    lo: int
    cut: int
    start: int
    end: int


def _is_bucket_expr(e: ast.Expr, ts_col: str) -> bool:
    return (
        isinstance(e, ast.FuncCall)
        and e.name in ("time_bucket", "date_trunc")
        and e.args
        and isinstance(e.args[0], ast.Column)
        and e.args[0].name == ts_col
    )


def _split_where(plan: QueryPlan, tags: set, ts_col: str):
    """-> (tag_conjuncts, ok): conjuncts usable verbatim on BOTH sides
    (tag-only), with pushed-to-storage ts range conjuncts dropped (the
    decision's [start, end) already carries them). Anything else — a
    residual value-column filter, an unpushable ts shape — refuses."""
    from ..query.planner import _as_simple_cmp, _conjuncts

    where = plan.select.where
    if where is None:
        return [], True
    from ..query.executor import _columns_of

    keep = []
    for conj in _conjuncts(where):
        cols = {c.name for c in _columns_of(conj)}
        if cols and cols <= tags:
            keep.append(conj)
            continue
        simple = _as_simple_cmp(conj)
        if simple is not None and simple[0] == ts_col and simple[1] != "!=":
            continue  # exact via the predicate time range
        if (
            isinstance(conj, ast.Between)
            and not conj.negated
            and isinstance(conj.expr, ast.Column)
            and conj.expr.name == ts_col
            and isinstance(conj.low, ast.Literal)
            and isinstance(conj.high, ast.Literal)
        ):
            continue
        return [], False
    return keep, True


def rollup_decision_for(
    catalog, plan
) -> Optional[RollupDecision]:
    """THE shared serve-from-rollup predicate (executor + EXPLAIN)."""
    if not rollup_enabled() or not isinstance(plan, QueryPlan):
        return None
    if not plan.is_aggregate or plan.agg_exprs:
        return None
    state: Optional[RollupState] = ROLLUPS.get(plan.table)
    if state is None:
        return None
    spec = state.spec
    if plan.schema.timestamp_name != spec.ts_col:
        return None
    sel = plan.select
    if (
        sel.join is not None
        or sel.joins
        or sel.distinct
        or sel.having is not None
    ):
        return None
    # group shape: exactly one time_bucket key + tag columns
    bucket_keys = [k for k in plan.group_keys if k.time_bucket_ms]
    if len(bucket_keys) != 1:
        return None
    step_ms = bucket_keys[0].time_bucket_ms
    tags = set(spec.tags)
    for k in plan.group_keys:
        if k.time_bucket_ms:
            continue
        if k.column is None or k.column not in tags:
            return None
    # aggregates: foldable funcs over THE value column only
    if not plan.aggs:
        return None
    for a in plan.aggs:
        if (
            a.func not in _FOLDABLE
            or a.distinct
            or a.filter_where is not None
            or a.column2 is not None
            or a.params
            or a.column != spec.value_col
        ):
            return None
    # select items must be group keys or plain aggs (no row arithmetic)
    out_names = []
    for item in sel.items:
        e = item.expr
        if _is_bucket_expr(e, spec.ts_col):
            pass
        elif isinstance(e, ast.Column) and e.name in tags:
            pass
        elif isinstance(e, ast.FuncCall) and e.name in _FOLDABLE:
            pass
        else:
            return None
        out_names.append(item.output_name)
    # ORDER BY must name output columns (applied after the combine)
    for o in sel.order_by:
        name = o.expr.name if isinstance(o.expr, ast.Column) else str(o.expr)
        if name not in out_names:
            return None
    _, where_ok = _split_where(plan, tags, spec.ts_col)
    if not where_ok:
        return None
    tr = plan.predicate.time_range
    start, end = tr.inclusive_start, tr.exclusive_end
    # first COMPLETE query bucket: a non-aligned start truncates its
    # bucket, which the stored whole-bucket partials cannot represent —
    # that partial head stays on the raw side
    lo = start if start == MIN_TIMESTAMP else -(-start // step_ms) * step_ms
    # coarsest tier dividing the step wins (fewest rows scanned); the
    # raw head/tail outside its window are the same either way
    for suffix, tier_ms in reversed(spec.tiers):
        if step_ms % tier_ms:
            continue
        wm = state.watermark(suffix)
        if wm is None:
            continue
        if catalog.open(rollup_table_name(spec.source, suffix)) is None:
            continue
        cut = (min(wm, end) // step_ms) * step_ms
        if cut <= lo:
            continue  # the rollup would contribute nothing
        return RollupDecision(
            source=spec.source,
            rollup_table=rollup_table_name(spec.source, suffix),
            suffix=suffix,
            tier_ms=tier_ms,
            step_ms=step_ms,
            lo=lo,
            cut=cut,
            start=start,
            end=end,
        )
    return None


def _and(conjuncts: list) -> Optional[ast.Expr]:
    out = None
    for c in conjuncts:
        out = c if out is None else ast.BinaryOp("AND", out, c)
    return out


def _map_agg_item(item: ast.SelectItem) -> ast.SelectItem:
    """One original select item -> its rollup-side form (aliased to the
    original output name so both halves align positionally)."""
    e = item.expr
    if isinstance(e, ast.FuncCall) and e.name in _FOLDABLE:
        col = {
            "sum": "agg_sum",
            "count": "agg_count",
            "min": "agg_min",
            "max": "agg_max",
        }
        if e.name == "avg":
            new: ast.Expr = ast.BinaryOp(
                "/",
                ast.FuncCall("sum", (ast.Column("agg_sum"),)),
                ast.FuncCall("sum", (ast.Column("agg_count"),)),
            )
        elif e.name in ("min", "max"):
            new = ast.FuncCall(e.name, (ast.Column(col[e.name]),))
        else:  # sum / count both fold by summing their partial
            new = ast.FuncCall("sum", (ast.Column(col[e.name]),))
        return ast.SelectItem(new, alias=item.output_name)
    return ast.SelectItem(e, alias=item.output_name)


def try_rollup_serve(factory, plan: QueryPlan):
    """Serve an eligible aggregate from the rollup ladder + raw tail;
    None when the shared predicate refuses (caller runs the normal
    path). ``factory`` is the InterpreterFactory (catalog + executor)."""
    decision = rollup_decision_for(factory.catalog, plan)
    if decision is None:
        return None
    import dataclasses

    from ..query.interpreters import _concat_results, _order_limit_result
    from ..query.planner import Planner
    from ..utils import querystats
    from ..utils.tracectx import span as _span

    state = ROLLUPS.get(plan.table)
    if state is None:  # unregistered between decision and serve
        return None
    spec = state.spec
    sel = plan.select
    tag_conjuncts, _ = _split_where(plan, set(spec.tags), spec.ts_col)
    ts = ast.Column(spec.ts_col)
    planner = Planner(factory.catalog.schema_of)

    # rollup half: the complete buckets [lo, cut) against the tier table
    roll_where = list(tag_conjuncts)
    if decision.lo > MIN_TIMESTAMP:
        roll_where.append(ast.BinaryOp(">=", ts, ast.Literal(decision.lo)))
    roll_where.append(ast.BinaryOp("<", ts, ast.Literal(decision.cut)))
    roll_select = ast.Select(
        items=tuple(_map_agg_item(i) for i in sel.items),
        table=decision.rollup_table,
        where=_and(roll_where),
        group_by=sel.group_by,
    )
    roll_plan = planner.plan(roll_select)
    roll_table = factory.catalog.open(decision.rollup_table)
    with _span("rollup_scan", table=decision.rollup_table):
        results = [factory.executor.execute(roll_plan, roll_table)]
    roll_metrics = factory.executor.last_metrics

    # raw halves against the source with the original aggregates: the
    # partial HEAD bucket [start, lo) and the still-open TAIL [cut, end)
    raw_metrics = None
    raw_ranges = []
    if decision.start < decision.lo:
        raw_ranges.append((decision.start, decision.lo))
    if decision.cut < decision.end:
        raw_ranges.append((decision.cut, decision.end))
    for r_start, r_end in raw_ranges:
        raw_where = list(tag_conjuncts)
        if r_start > MIN_TIMESTAMP:
            raw_where.append(ast.BinaryOp(">=", ts, ast.Literal(r_start)))
        if r_end < MAX_TIMESTAMP:
            raw_where.append(ast.BinaryOp("<", ts, ast.Literal(r_end)))
        raw_select = dataclasses.replace(
            sel,
            items=tuple(
                ast.SelectItem(i.expr, alias=i.output_name)
                for i in sel.items
            ),
            where=_and(raw_where),
            order_by=(),
            limit=None,
            offset=0,
        )
        raw_plan = planner.plan(raw_select)
        src_table = factory.catalog.open(plan.table)
        with _span("rollup_raw_part", table=plan.table):
            results.append(factory.executor.execute(raw_plan, src_table))
        m_part = factory.executor.last_metrics
        raw_metrics = (
            m_part if raw_metrics is None else {
                "rows_scanned": raw_metrics.get("rows_scanned", 0)
                + m_part.get("rows_scanned", 0)
            }
        )

    combined = results[0] if len(results) == 1 else _concat_results(results)
    combined = _order_limit_result(
        combined, sel.order_by, sel.limit, sel.offset
    )
    m = {
        "table": plan.table,
        "path": "rollup",
        "rollup_table": decision.rollup_table,
        "tier": decision.suffix,
        "cut": decision.cut,
        "rollup_rows": roll_metrics.get("result_rows", 0),
        "raw_tail_rows": (
            raw_metrics.get("rows_scanned", 0) if raw_metrics else 0
        ),
        "result_rows": combined.num_rows,
    }
    combined.metrics = m
    factory.executor.last_path = "rollup"
    factory.executor.last_metrics = m
    # The rewrite is a first-class route: ledger/query_stats show
    # route=rollup for the statement (set AFTER the halves so their
    # sub-executions' routes don't win).
    querystats.set_route("rollup")
    return combined
