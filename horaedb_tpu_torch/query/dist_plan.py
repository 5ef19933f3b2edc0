"""Distributed plan shipping — execute plan subtrees on partition owners
(ref: df_engine_extensions/src/dist_sql_query/resolver.rs:105-120 — the
reference resolves an UnresolvedPartitionedScan into per-partition remote
plan executions; remote_engine_client/src/client.rs:484
``execute_physical_plan``).

Before this module, only *partial aggregates* shipped (query/partial.py);
every other distributed query pulled raw rows across the DCN and computed
at the coordinator. Here whole plan shapes execute where the data lives:

- ``window``  — window functions whose every PARTITION BY covers the
  table's partition rule columns: rows of one window partition share the
  rule hash, so per-owner execution is exact; the coordinator just
  concatenates and re-applies the outer ORDER BY/LIMIT.
- ``agg``     — non-kernel aggregates (FILTER clauses, approx/statistical
  functions) whose GROUP BY covers the rule columns: every group lives in
  exactly one partition, so owners run the FULL aggregate (HAVING
  included) and the coordinator concatenates — no combine step at all.
- ``topk``    — ORDER BY + LIMIT: owners return their local top
  limit+offset rows, the coordinator merges and re-limits.
- ``distinct``— owners dedup locally, the coordinator dedups the union.
- ``filter``  — residual WHERE the storage predicate could not express
  (e.g. ``a + b > 3``): owners evaluate it exactly and return only
  matching rows instead of the whole partition.

The modes share one correctness obligation: the coordinator's combine
(concat [+ dedup] + outer ORDER BY/LIMIT/OFFSET) must be expressible over
the shipped results' OUTPUT columns — checked up front, falling back to
the raw-row path when it isn't.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..remote.plan_codec import PlanNotShippable, select_to_wire
from . import ast
from .plan import QueryPlan


def dist_plan_mode(executor, plan: QueryPlan, table) -> Optional[str]:
    """Which shipping mode (if any) this plan takes over this partitioned
    table. Pure analysis — EXPLAIN calls it too."""
    rule = getattr(table, "rule", None)
    if rule is None or not hasattr(table, "sub_tables"):
        return None
    stmt = plan.select
    if stmt is None or stmt.join is not None or stmt.ctes:
        return None
    # Embedded runtime state (correlated lookups) or pre-materialization
    # subqueries can't ship; planner/interpreter substitutions happen
    # before the executor, so anything left is a refusal.
    from .planner import _walk

    for src in _expr_sources(stmt):
        for e in _walk(src):
            if isinstance(
                e,
                (ast.Subquery, ast.InSubquery, ast.Exists, ast.CorrelatedLookup),
            ):
                return None

    windows = [
        e
        for item in stmt.items
        for e in _walk(item.expr)
        if isinstance(e, ast.WindowFunc)
    ]
    rule_cols = set(rule.columns)

    if plan.is_aggregate:
        if windows:
            return None
        # The partial-agg path (device kernel + combine) is preferred and
        # runs first; full-agg shipping handles the shapes it refuses,
        # provided groups are partition-local.
        if executor is not None and executor._agg_device_shape(plan) is not None:
            from .partial import spec_from_plan

            if spec_from_plan(executor, plan) is not None:
                return None
        group_cols = {k.column for k in plan.group_keys if k.column is not None}
        if not rule_cols or not rule_cols <= group_cols:
            return None
        if not _order_resolvable(stmt, plan):
            return None
        return "agg"

    if windows:
        for w in windows:
            part_cols = {
                p.name for p in w.spec.partition_by if isinstance(p, ast.Column)
            }
            if not rule_cols or not rule_cols <= part_cols:
                return None
        if not _order_resolvable(stmt, plan):
            return None
        return "window"

    if stmt.distinct:
        if not _order_resolvable(stmt, plan):
            return None
        return "distinct"

    if stmt.order_by and stmt.limit is not None:
        if not _order_resolvable(stmt, plan):
            return None
        return "topk"

    # Residual WHERE: filter on the owner instead of pulling every row.
    if (
        not stmt.order_by
        and executor is not None
        and executor._residual_where(plan) is not None
    ):
        return "filter"
    return None


def try_dist_plan(executor, plan: QueryPlan, table, m: dict):
    """Execute ``plan`` by shipping it to partition owners; None when the
    shape doesn't ship (caller falls back to the raw-row scan path)."""
    mode = dist_plan_mode(executor, plan, table)
    if mode is None:
        return None

    keep = table.rule.prune(plan.predicate)
    subs = (
        table.sub_tables
        if keep is None
        else [table.sub_tables[i] for i in keep]
    )
    sub_select = _sub_select(plan.select, mode)
    try:
        # Validate encodability ONCE before fanning out.
        select_to_wire(dataclasses.replace(sub_select, table="_"))
    except PlanNotShippable:
        return None

    import contextvars

    from ..utils.runtime import scatter_pool
    from ..utils.tracectx import span, wire_context

    def run_one(sub):
        # Runs inside a COPY of the coordinator's context: the partition
        # span lands under the dist_fanout span, and the wire context's
        # parent_span_id points at THIS partition's span — the owner's
        # subtree grafts back exactly where it belongs.
        with span("partition", partition=sub.name):
            wire = select_to_wire(
                dataclasses.replace(sub_select, table=sub.name)
            )
            shipped = getattr(sub, "execute_plan", None)
            if shipped is not None:
                out = shipped(
                    {"plan": wire, "trace": wire_context() or {"request_id": None}}
                )
                if out is not None:
                    return out  # (names, columns, nulls, metrics)
            sub_plan = dataclasses.replace(
                plan,
                table=sub.name,
                select=dataclasses.replace(sub_select, table=sub.name),
            )
            rs = executor.execute(sub_plan, sub)
            return rs.names, rs.columns, rs.nulls, {
                "partition": sub.name,
                "local": True,
                **{k: v for k, v in (rs.metrics or {}).items()
                   if k in ("path", "scan_ms", "rows_scanned", "total_ms")},
            }

    from ..utils.querystats import record as _qs_record

    _qs_record(fanout=len(subs))
    with span("dist_fanout", mode=mode, partitions=len(subs)):
        if len(subs) == 1:
            parts = [run_one(subs[0])]
        else:
            # one context copy per task — a single Context can't be
            # entered by two pool threads at once
            ctxs = [contextvars.copy_context() for _ in subs]
            parts = list(
                scatter_pool().map(
                    lambda cs: cs[0].run(run_one, cs[1]), zip(ctxs, subs)
                )
            )

    from .executor import ResultSet, _order_and_limit

    names = None
    col_parts: list[list[np.ndarray]] = []
    null_parts: list[dict] = []
    stage_metrics = []
    for p_names, p_cols, p_nulls, p_metrics in parts:
        stage_metrics.append(p_metrics)
        if names is None:
            names = p_names
        if p_cols and len(p_cols[0]):
            col_parts.append(p_cols)
            null_parts.append(p_nulls or {})
    m["dist_plan"] = mode
    m["partitions"] = len(subs)
    m["dist_stages"] = stage_metrics
    if names is None:
        # Every partition pruned away or returned empty: derive the output
        # shape from the select list, expanding ``*`` against the table
        # schema exactly as a sub-execution would have — the empty result
        # must not grow a column literally named "*".
        names = []
        for item in plan.select.items:
            if isinstance(item.expr, ast.Star):
                names.extend(
                    c.name for c in plan.schema.columns
                    if not c.name.startswith("__hidden_")
                )
            else:
                names.append(item.output_name)
    if not col_parts:
        result = ResultSet.empty(list(names))
    else:
        cols = [
            _concat_aligned([p[i] for p in col_parts])
            for i in range(len(names))
        ]
        nulls: dict[str, np.ndarray] = {}
        for i, name in enumerate(names):
            if any(name in np_ for np_ in null_parts):
                nulls[name] = np.concatenate(
                    [
                        np_.get(name, np.zeros(len(p[i]), dtype=bool))
                        for np_, p in zip(null_parts, col_parts)
                    ]
                )
        result = ResultSet(list(names), cols, nulls or None)

    # Owners already applied HAVING (mode "agg") — the coordinator only
    # dedups (stmt.distinct, handled once inside _order_and_limit: the
    # union of per-owner DISTINCT sets can repeat across partitions) and
    # re-sorts/limits over output columns.
    coord_plan = dataclasses.replace(
        plan, select=dataclasses.replace(plan.select, having=None)
    )
    return _order_and_limit(result, coord_plan)


def _concat_aligned(arrays: list[np.ndarray]) -> np.ndarray:
    """Concat per-partition result columns, unifying dtypes (an empty or
    all-NULL partition may have produced a narrower dtype)."""
    if len(arrays) == 1:
        return arrays[0]
    kinds = {a.dtype.kind for a in arrays}
    if len({a.dtype for a in arrays}) == 1:
        return np.concatenate(arrays)
    if kinds <= {"i", "u", "b"}:
        # Pure integer/bool mixes stay exact: routing them through
        # float64 would corrupt int64 values above 2^53. A uint64 value
        # past int64's range can't stay exact in EITHER fixed dtype next
        # to signed values — object preserves it instead of wrapping.
        if any(
            a.dtype == np.uint64 and len(a) and a.max() > np.iinfo(np.int64).max
            for a in arrays
        ):
            return np.concatenate([a.astype(object) for a in arrays])
        return np.concatenate([a.astype(np.int64) for a in arrays])
    if kinds <= {"i", "u", "f", "b"}:
        return np.concatenate([a.astype(np.float64) for a in arrays])
    return np.concatenate([a.astype(object) for a in arrays])


def _sub_select(stmt: ast.Select, mode: str) -> ast.Select:
    """The per-owner Select for a shipping mode (table patched later)."""
    if mode in ("window", "agg", "distinct"):
        # Coordinator re-applies ordering; owners need the full set (but
        # a DISTINCT owner without ordering can stop at limit+offset).
        limit = None
        if mode == "distinct" and not stmt.order_by and stmt.limit is not None:
            limit = stmt.limit + stmt.offset
        return dataclasses.replace(
            stmt, order_by=(), limit=limit, offset=0
        )
    if mode == "topk":
        return dataclasses.replace(
            stmt, limit=stmt.limit + stmt.offset, offset=0
        )
    # mode == "filter": push LIMIT when nothing else needs the full set.
    limit = None
    if stmt.limit is not None and not stmt.order_by:
        limit = stmt.limit + stmt.offset
    return dataclasses.replace(stmt, limit=limit, offset=0)


def _order_resolvable(stmt: ast.Select, plan: QueryPlan) -> bool:
    """Can the coordinator re-sort the combined output rows? Mirrors
    executor._order_and_limit's resolution: each ORDER BY key must name an
    output column (directly, by rendered expression, or by alias)."""
    if not stmt.order_by:
        return True
    outputs = set()
    star = False
    for item in stmt.items:
        if isinstance(item.expr, ast.Star):
            star = True
        else:
            outputs.add(item.output_name)
            if item.alias:
                outputs.add(item.alias)
    if star:
        outputs |= {c.name for c in plan.schema.columns}
    for o in stmt.order_by:
        if isinstance(o.expr, ast.Column) and o.expr.name in outputs:
            continue
        if str(o.expr) in outputs:
            continue
        return False
    return True


def _expr_sources(select: ast.Select) -> list:
    out = [item.expr for item in select.items]
    out += [
        e
        for e in (select.where, select.having, *select.group_by)
        if e is not None
    ]
    out += [o.expr for o in select.order_by]
    return out
