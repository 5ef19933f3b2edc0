"""Interpreters: Plan -> effect (ref: src/interpreters, factory.rs:70).

One interpreter per plan variant, dispatched by ``InterpreterFactory``;
outputs are either a ``ResultSet`` (queries, SHOW/DESCRIBE) or an affected
row count (writes, DDL) — mirroring the reference's ``Output`` enum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np

from ..catalog import Catalog
from ..common_types.row_group import RowGroup
from ..engine.options import format_duration
from . import ast
from .executor import Executor, ResultSet
from .plan import (
    AlterTablePlan,
    CTEPlan,
    CreateTablePlan,
    DescribePlan,
    DropTablePlan,
    ExistsPlan,
    ExplainPlan,
    InsertPlan,
    Plan,
    QueryPlan,
    ShowCreatePlan,
    ShowTablesPlan,
    UnionPlan,
)


def _walk_all(e):
    """Generic expression walker that also SEES subquery nodes (does not
    descend into their inner selects — those are separate scopes)."""
    yield e
    for name in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, name)
        if isinstance(v, ast.Expr):
            yield from _walk_all(v)
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, ast.Expr):
                    yield from _walk_all(x)


def _flatten_and(e: ast.Expr) -> list:
    if isinstance(e, ast.BinaryOp) and e.op == "AND":
        return _flatten_and(e.left) + _flatten_and(e.right)
    return [e]


def _inner_tables_of(select: ast.Select) -> set:
    # NOTE: keep in sync with the scope computation in
    # _materialize_subqueries — both must cover the full join chain.
    return {
        t
        for t in (select.table, select.join.table if select.join else None)
        if t
    } | {j.table for j in select.joins}


def _correlated_cols(exprs, scope, inner_tables) -> list:
    """Columns qualified by an OUTER-scope table (the correlation refs).
    Unqualified names always resolve inner — outer references must be
    qualified (documented restriction)."""
    return [
        x
        for src in exprs
        if src is not None
        for x in _walk_all(src)
        if isinstance(x, ast.Column)
        and x.qualifier
        and x.qualifier in scope
        and x.qualifier not in inner_tables
    ]


def _has_correlated_refs(select: ast.Select, scope) -> bool:
    inner = _inner_tables_of(select)
    sources = InterpreterFactory._expr_sources(select)
    return bool(_correlated_cols(sources, scope, inner))


@dataclass(frozen=True)
class AffectedRows:
    count: int


Output = Union[ResultSet, AffectedRows]


class InterpreterError(ValueError):
    pass


class InterpreterFactory:
    def __init__(self, catalog: Catalog, device) -> None:
        self.catalog = catalog
        self.executor = Executor(device)

    def execute(self, plan: Plan) -> Output:
        if isinstance(plan, QueryPlan):
            return self._select(plan)
        if isinstance(plan, InsertPlan):
            return self._insert(plan)
        if isinstance(plan, CreateTablePlan):
            return self._create(plan)
        if isinstance(plan, DropTablePlan):
            dropped = self.catalog.drop_table(plan.table, plan.if_exists)
            return AffectedRows(1 if dropped else 0)
        if isinstance(plan, DescribePlan):
            return self._describe(plan)
        if isinstance(plan, ShowTablesPlan):
            names = self.catalog.table_names()
            return ResultSet(["Tables"], [np.array(names, dtype=object)])
        if isinstance(plan, ShowCreatePlan):
            return self._show_create(plan)
        if isinstance(plan, ExistsPlan):
            return ResultSet(
                ["result"], [np.array([1 if self.catalog.exists(plan.table) else 0])]
            )
        if isinstance(plan, AlterTablePlan):
            return self._alter(plan)
        if isinstance(plan, ExplainPlan):
            return self._explain(plan)
        if isinstance(plan, UnionPlan):
            return self._union(plan)
        if isinstance(plan, CTEPlan):
            return self._cte(plan)
        from .plan import KillQueryPlan

        if isinstance(plan, KillQueryPlan):
            # cooperative kill: flip the cancel flag; the victim unwinds
            # at its next checkpoint and releases every slot it holds
            from ..utils.deadline import QUERY_REGISTRY

            if not QUERY_REGISTRY.kill(plan.query_id, source="kill"):
                raise InterpreterError(
                    f"no live query with id {plan.query_id} "
                    "(see system.public.queries)"
                )
            return AffectedRows(1)
        raise InterpreterError(f"no interpreter for {type(plan).__name__}")

    # ---- UNION / CTE -----------------------------------------------------
    def _union(self, plan: UnionPlan) -> ResultSet:
        """Branches execute independently (each on its own best path);
        results align by position, names from the first branch, folded
        left-to-right: each distinct UNION dedups everything accumulated
        so far, each UNION ALL appends (standard left-associative
        semantics — `a UNION b UNION ALL c` keeps c's duplicates)."""
        from .executor import _distinct_result

        results = [self._select(b) for b in plan.branches]
        combined = results[0]
        for i, res in enumerate(results[1:]):
            combined = _concat_results([combined, res])
            if not plan.all_flags[i]:
                combined = _distinct_result(combined)
        return _order_limit_result(combined, plan.order_by, plan.limit, plan.offset)

    def _cte(self, plan: CTEPlan) -> Output:
        """WITH bindings materialize in order into an overlay of in-memory
        tables (later ctes and the outer statement see earlier ones); the
        outer statement then plans + executes against the overlay (ref:
        DataFusion CTEs via LogicalPlan inlining; materialization keeps
        each cte single-execution like DataFusion's cte work-table)."""
        from .planner import Planner

        overlay: dict = {}

        def schema_of(name: str):
            t = overlay.get(name)
            if t is not None:
                return t.schema
            return self.catalog.schema_of(name)

        planner = Planner(schema_of)
        sub = self._overlay_factory(overlay)
        for name, stmt in plan.ctes:
            if name in overlay or self.catalog.exists(name):
                raise InterpreterError(f"cte name {name!r} shadows an existing table")
            p = planner.plan(stmt)
            res = sub.execute(p)
            overlay[name] = _result_to_table(name, res, p)
        return sub.execute(planner.plan(plan.inner))

    def _overlay_factory(self, overlay: dict) -> "InterpreterFactory":
        f = object.__new__(InterpreterFactory)
        f.catalog = _OverlayCatalog(self.catalog, overlay)
        f.executor = self.executor  # share scan cache / router state
        return f

    def _explain(self, plan: ExplainPlan) -> ResultSet:
        """Textual plan tree (ref: EXPLAIN over DataFusion plans)."""
        q = plan.inner
        if isinstance(q, UnionPlan):
            if plan.analyze:
                # guard HERE, where the capability gap lives (the parser
                # also rejects, but programmatic AST producers bypass it)
                raise InterpreterError("EXPLAIN ANALYZE over UNION is not supported")
            order = ", ".join(
                f"{o.expr}{'' if o.ascending else ' DESC'}" for o in q.order_by
            )
            lines = [
                f"Union: branches={len(q.branches)} "
                f"all_flags={list(q.all_flags)}"
                + (f" order_by=[{order}]" if order else "")
                + f" limit={q.limit} offset={q.offset}"
            ]
            for i, b in enumerate(q.branches):
                lines.append(f"  Branch {i}:")
                lines.extend(
                    "    " + l for l in self._explain_query_lines(b, analyze=False)
                )
            return ResultSet(["plan"], [np.array(lines, dtype=object)])
        return ResultSet(
            ["plan"],
            [np.array(self._explain_query_lines(q, plan.analyze), dtype=object)],
        )

    def _explain_query_lines(self, q: QueryPlan, analyze: bool) -> list[str]:
        table = self.catalog.open(q.table)
        lines = []
        tr = q.predicate.time_range
        lines.append(f"Query: table={q.table} priority={q.priority.value}")
        # the workload manager's verdict for this plan shape (wlm/admission)
        from ..wlm.admission import classify_plan, lane_for

        adm_class, est_ms = classify_plan(q)
        lines.append(
            f"  Admission: class={adm_class} lane={lane_for(adm_class)}"
            + (f" est_ms={est_ms:.1f}" if est_ms is not None else "")
        )
        lines.append(
            f"  TimeRange: [{tr.inclusive_start}, {tr.exclusive_end})"
        )
        # Follower-served EXPLAIN (gateway replica path): say so — the
        # plan below describes LOCAL read-only state, not the leader's.
        from ..cluster.replica import replica_context

        _rc = replica_context()
        if _rc is not None:
            lines.append(
                f"  Replica: route=follower epoch={_rc['epoch']} "
                f"watermark_lag_ms={_rc['lag_ms']}"
            )
        if q.predicate.filters:
            fs = ", ".join(
                f"{f.column} {f.op.value} {f.value!r}" for f in q.predicate.filters
            )
            lines.append(f"  PushedFilters: {fs}")
        if q.is_aggregate:
            keys = ", ".join(k.output_name for k in q.group_keys) or "(none)"
            aggs = ", ".join(
                f"{a.func}({a.column or '*'})"
                + (f" FILTER (WHERE {a.filter_where})" if a.filter_where is not None else "")
                for a in q.aggs
            )
            lines.append(f"  Aggregate: keys=[{keys}] aggs=[{aggs}]")
            # same shared predicate the executor hook serves from — what
            # this line promises is what execution does (route=rollup)
            from ..rules.rewrite import rollup_decision_for

            dec = rollup_decision_for(self.catalog, q)
            if dec is not None:
                lines.append(
                    f"  Rollup: table={dec.rollup_table} tier={dec.suffix} "
                    f"buckets<[{dec.cut}] served pre-aggregated, raw tail "
                    f"[{dec.cut}, {dec.end}) from {q.table} (route=rollup)"
                )
            # live window state: again the ONE executor predicate, so the
            # promise and the serve cannot drift (route=livewindow)
            from ..state.livewindow import livewindow_decision_for

            lw = livewindow_decision_for(self.catalog, q)
            if lw is not None:
                lines.append(
                    f"  LiveWindow: window={lw.step_ms}ms "
                    f"[{lw.s_lo}, {lw.s_hi}) served from device ring state "
                    f"({lw.n_buckets} buckets), raw head [{lw.start}, "
                    f"{lw.s_lo}) (route=livewindow)"
                )
            shape = self.executor._agg_device_shape(q)
            if shape is not None:
                path = "device (fused kernel; HBM-cached when table state is stable)"
                nullable_aggs = [
                    a.column
                    for a in q.aggs
                    if a.column is not None and q.schema.column(a.column).is_nullable
                ]
                if nullable_aggs:
                    path += f" [host fallback if NULLs in {nullable_aggs}]"
            else:
                path = "host"
            lines.append(f"  Execution: {path}")
        else:
            raw_shape, raw_reason = self.executor._raw_route(q, table)
            if raw_shape is not None and raw_reason is None:
                kind = "top-k" if raw_shape["topk_ok"] else "bounded selection"
                lines.append(
                    f"  Execution: raw device ({kind} over the resident scan "
                    "cache; host when the cache, the soundness checks or "
                    "the HORAEDB_RAW_MAX_ROWS budget refuse)"
                )
            else:
                lines.append("  Execution: projection scan (host)")
        from ..table_engine.partition import PartitionedTable

        if isinstance(table, PartitionedTable):
            keep = table.rule.prune(q.predicate)
            shown = "all" if keep is None else str(keep)
            lines.append(
                f"  Partitions: {table.rule.num_partitions} "
                f"({table.rule.method}) scan={shown}"
            )
            from .dist_plan import dist_plan_mode

            mode = dist_plan_mode(self.executor, q, table)
            if mode is not None:
                lines.append(
                    f"  Distributed: ship plan subtree to partition owners "
                    f"(mode={mode}; remote partitions execute via "
                    f"/horaedb.remote_engine/ExecutePlan, coordinator "
                    f"combines + re-applies ORDER/LIMIT)"
                )
        if analyze:
            # EXPLAIN ANALYZE: actually run the query and report observed
            # execution (ref: EXPLAIN ANALYZE carrying runtime metrics +
            # the formatted trace_metric span tree).
            import time as _time

            from ..utils.tracectx import (
                current_trace,
                finish_trace,
                render_tree,
                span,
                start_trace,
            )

            from ..utils.querystats import (
                current_ledger,
                finish_ledger,
                render_ledger,
                start_ledger,
            )

            trace = current_trace()
            handle = None
            if trace is None:
                # direct embedded call (no proxy): own the trace so the
                # tree still lands in TRACE_STORE / /debug/trace
                trace, handle = start_trace(
                    f"explain-{id(q):x}", "explain_analyze", table=q.table
                )
            # A NESTED ledger scoped to the analyzed execution: what this
            # one query cost, untangled from the proxy's statement-wide
            # ledger — then folded back so query_stats stays whole.
            outer_ledger = current_ledger()
            qledger, qtoken = start_ledger(trace.trace_id, "explain analyze")
            try:
                t0 = _time.perf_counter()
                with span("analyze", table=q.table):
                    out = self._execute_query(q, table)
                elapsed = (_time.perf_counter() - t0) * 1000
                lines.append(
                    f"  Analyzed: path={self.executor.last_path} "
                    f"rows={out.num_rows} elapsed={elapsed:.2f}ms"
                )
                m = out.metrics or {}
                detail = ", ".join(
                    f"{k}={v}" for k, v in m.items() if k not in ("table", "path")
                )
                if detail:
                    lines.append(f"  Metrics: {detail}")
                lines.append(f"  Ledger: {render_ledger(qledger)}")
                # Device plane: EXPLAIN ANALYZE dispatches are always
                # timed (obs/device forces sampling for explain runs),
                # so device_ms is present whenever a kernel ran; compile
                # events this run journaled render inline.
                dd = int(qledger.counts.get("device_dispatches", 0))
                if dd:
                    lines.append(
                        f"  Device: dispatches={dd} "
                        f"device_ms={qledger.counts.get('device_ms', 0.0):.3f} "
                        f"compile_hit={int(qledger.counts.get('compile_hit', 0))}"
                    )
                    from ..utils.events import EVENT_STORE

                    for ev in EVENT_STORE.list(kind="kernel_compile"):
                        if ev.get("trace_id") == trace.trace_id:
                            a = ev.get("attrs", {})
                            lines.append(
                                f"  Compile: kernel={a.get('kernel')} "
                                f"wall_ms={a.get('wall_ms')} "
                                f"shape={a.get('shape')}"
                            )
                # Decision plane: any adaptive decision journaled under
                # THIS run's trace (the kernel router's impl pick for a
                # routed aggregation) renders with its prediction and —
                # the run just finished, so the resolve landed — the
                # realized seconds and relative error.
                from ..obs.decisions import DECISION_JOURNAL

                for de in DECISION_JOURNAL.list():
                    if de.get("trace_id") == trace.trace_id:
                        parts = [
                            f"  Decision: loop={de['loop']} "
                            f"choice={de['choice']}"
                        ]
                        if de["predicted"] is not None:
                            parts.append(f"predicted={de['predicted']:.6f}")
                        if de["actual"] is not None:
                            parts.append(f"actual={de['actual']:.6f}")
                        if de["error"] is not None:
                            parts.append(f"error={de['error']:+.3f}")
                        if de["outcome"]:
                            parts.append(f"outcome={de['outcome']}")
                        lines.append(" ".join(parts))
                if handle is not None:
                    trace.root.finish()  # owned: closed before rendering
                tree = trace.to_dict()["root"]
                lines.append(f"  Trace: request_id={trace.trace_id}")
                lines.extend("    " + l for l in render_tree(tree, 0))
                # Profile plane: the max-time chain through this run's
                # tree — the hop where inclusive≈self is where the
                # wall-clock actually went.
                from ..obs.profile import render_critical_path

                cp = render_critical_path(tree)
                if cp:
                    lines.append(f"  Critical path: {cp}")
            finally:
                # an execute error must still reset the ContextVars — a
                # leaked trace would swallow every later query's spans
                finish_ledger(qledger, qtoken, 0.0, record_stats=False)
                if outer_ledger is not None:
                    outer_ledger.merge_remote(qledger.to_dict())
                    if qledger.route:
                        outer_ledger.set_route(qledger.route)
                if handle is not None:
                    finish_trace(handle)
        return lines

    # ---- variants -----------------------------------------------------------
    def _select(self, plan: QueryPlan) -> ResultSet:
        rewritten = self._materialize_subqueries(plan)
        if rewritten is not None:
            plan = rewritten
        if plan.select.join is not None:
            from .join import execute_join

            return execute_join(self.catalog, self.executor, plan.select)
        table = self.catalog.open(plan.table)
        if table is None:
            raise InterpreterError(f"table not found: {plan.table}")
        return self._execute_query(plan, table)

    def execute_cohort(self, plans: list) -> list:
        """Execute a cohort of shape-identical SELECT plans (wlm/batch
        hands cohorts here through the proxy). Returns one
        Output-or-exception per plan, positionally — a member whose
        execution fails poisons only its own slot. Members needing
        machinery the executor's cohort path cannot serve (subqueries,
        joins, rollup or live-window serves, unknown tables) execute solo
        in place."""
        outcomes: list = [None] * len(plans)
        by_table: dict[str, list] = {}
        for i, plan in enumerate(plans):
            try:
                rewritten = self._materialize_subqueries(plan)
                p = rewritten if rewritten is not None else plan
                if p.select.join is not None:
                    outcomes[i] = self._select(p)
                    continue
                from ..rules.rewrite import try_rollup_serve
                from ..state.livewindow import try_livewindow_serve

                out = try_livewindow_serve(self, p)
                if out is None:
                    out = try_rollup_serve(self, p)
                if out is not None:
                    outcomes[i] = out
                    continue
                by_table.setdefault(p.table, []).append((i, p))
            except BaseException as e:
                outcomes[i] = e
        for table_name, grp in by_table.items():
            table = self.catalog.open(table_name)
            if table is None:
                err = InterpreterError(f"table not found: {table_name}")
                for i, _ in grp:
                    outcomes[i] = err
                continue
            results = self.executor.execute_cohort([p for _, p in grp], table)
            for (i, _), r in zip(grp, results):
                outcomes[i] = r
        return outcomes

    def _execute_query(self, plan: QueryPlan, table) -> ResultSet:
        """One door to query execution (SELECT and EXPLAIN ANALYZE both
        pass through): a step-compatible dashboard aggregate over a
        rollup-maintained table serves from the tier tables
        (rules/rewrite, ``route=rollup``); an eligible open-tail window
        aggregate serves head-from-rollup + tail-from-state
        (state/livewindow, ``route=livewindow``); everything else takes
        the executor's normal paths."""
        from ..rules.rewrite import try_rollup_serve
        from ..state.livewindow import try_livewindow_serve

        out = try_livewindow_serve(self, plan)
        if out is not None:
            return out
        out = try_rollup_serve(self, plan)
        if out is not None:
            return out
        return self.executor.execute(plan, table)

    @staticmethod
    def _expr_sources(select: ast.Select) -> list:
        """Every expression-bearing position of a Select — the ONE list
        subquery materialization and correlation checking both walk (a
        new expr-bearing clause must be added here once, not N times)."""
        out = [item.expr for item in select.items]
        out += [
            e
            for e in (select.where, select.having, *select.group_by)
            if e is not None
        ]
        out += [o.expr for o in select.order_by]
        return out

    def _materialize_subqueries(self, plan: QueryPlan, outer_scope=frozenset()):
        """Uncorrelated subqueries run FIRST and substitute as literals
        (ref: the reference gets subqueries from DataFusion; this is the
        uncorrelated subset): ``IN (SELECT ...)`` becomes an InList of the
        inner result's values, a scalar ``(SELECT ...)`` becomes one
        Literal. Returns a re-planned QueryPlan, or None if the statement
        has no subqueries."""
        stmt = plan.select
        sources = self._expr_sources(stmt)
        if not any(
            isinstance(e, (ast.InSubquery, ast.Subquery, ast.Exists))
            for src in sources
            for e in _walk_all(src)
        ):
            return None

        from .planner import Planner

        planner = Planner(self.catalog.schema_of)
        # the full outer scope: every enclosing query's tables, so nested
        # subqueries still get the clear correlation error
        scope = set(outer_scope) | {
            t for t in (stmt.table, stmt.join.table if stmt.join else None) if t
        } | {j.table for j in stmt.joins}

        def run_inner(select: ast.Select) -> list:
            # A qualifier naming an OUTER-scope table means the subquery
            # is correlated — say so directly instead of letting the inner
            # planner report a baffling "unknown qualifier".
            inner_tables = _inner_tables_of(select)
            for src in self._expr_sources(select):
                for e in _walk_all(src):
                    if (
                        isinstance(e, ast.Column)
                        and e.qualifier
                        and e.qualifier in scope
                        and e.qualifier not in inner_tables
                    ):
                        raise InterpreterError(
                            f"correlated subqueries are not supported: "
                            f"{e.qualifier}.{e.name} references the outer "
                            f"query's table {e.qualifier!r}"
                        )
            inner_plan = planner.plan(select)
            nested = self._materialize_subqueries(inner_plan, outer_scope=scope)
            inner = self.execute(nested if nested is not None else inner_plan)
            if not isinstance(inner, ResultSet):
                raise InterpreterError("subquery must be a SELECT")
            if len(inner.names) != 1:
                raise InterpreterError(
                    f"subquery must return one column, got {inner.names}"
                )
            nulls = (inner.nulls or {}).get(inner.names[0])
            col = inner.columns[0]
            return [
                v.item() if isinstance(v, np.generic) else v
                for i, v in enumerate(col)
                if nulls is None or not nulls[i]
            ]

        import dataclasses

        def subst(e: ast.Expr) -> ast.Expr:
            if isinstance(e, ast.InSubquery):
                vals = run_inner(e.select)
                return ast.InList(
                    subst(e.expr), tuple(ast.Literal(v) for v in vals), e.negated
                )
            if isinstance(e, ast.Exists):
                if _has_correlated_refs(e.select, scope):
                    # Equality-correlated semi-join: decorrelate into a
                    # distinct-key inner query + boolean membership lookup.
                    return self._decorrelate_exists(e.select, scope, planner)
                # Uncorrelated: EXISTS is a constant — one row after the
                # subquery's own LIMIT/OFFSET decides it (LIMIT 0 stays
                # empty; OFFSET is honored by the probe).
                import dataclasses as _dc

                probe = _dc.replace(
                    e.select,
                    limit=1 if e.select.limit is None else min(e.select.limit, 1),
                )
                inner_plan = planner.plan(probe)
                nested = self._materialize_subqueries(
                    inner_plan, outer_scope=scope
                )
                inner = self.execute(
                    nested if nested is not None else inner_plan
                )
                if not isinstance(inner, ResultSet):
                    raise InterpreterError("EXISTS subquery must be a SELECT")
                return ast.Literal(inner.num_rows > 0)
            if isinstance(e, ast.Subquery):
                if _has_correlated_refs(e.select, scope):
                    # Equality-correlated scalar aggregate: decorrelate
                    # into one grouped inner query + per-row lookup.
                    return self._decorrelate_scalar(e.select, scope, planner)
                vals = run_inner(e.select)
                if len(vals) > 1:
                    raise InterpreterError(
                        f"scalar subquery returned {len(vals)} rows"
                    )
                return ast.Literal(vals[0] if vals else None)
            # Generic rebuild mirroring _walk_all: any Expr-typed field
            # (or tuple of them) may hide a subquery — FuncCall args,
            # InList values, IsNull, everything current and future.
            if dataclasses.is_dataclass(e):
                changes = {}
                for name in e.__dataclass_fields__:
                    v = getattr(e, name)
                    if isinstance(v, ast.Expr):
                        nv = subst(v)
                        if nv is not v:
                            changes[name] = nv
                    elif isinstance(v, tuple) and any(
                        isinstance(x, ast.Expr) for x in v
                    ):
                        nv = tuple(
                            subst(x) if isinstance(x, ast.Expr) else x for x in v
                        )
                        if nv != v:
                            changes[name] = nv
                if changes:
                    return dataclasses.replace(e, **changes)
            return e

        new_stmt = dataclasses.replace(
            stmt,
            items=tuple(
                dataclasses.replace(item, expr=subst(item.expr))
                for item in stmt.items
            ),
            where=subst(stmt.where) if stmt.where is not None else None,
            having=subst(stmt.having) if stmt.having is not None else None,
            group_by=tuple(subst(g) for g in stmt.group_by),
            order_by=tuple(
                dataclasses.replace(o, expr=subst(o.expr)) for o in stmt.order_by
            ),
        )
        return planner.plan(new_stmt)

    def _decorrelate_scalar(
        self, select: ast.Select, scope, planner
    ) -> ast.CorrelatedLookup:
        """Rewrite an equality-correlated scalar aggregate subquery
        (ref: DataFusion's scalar-subquery decorrelation; the classic
        Kim/Neumann unnesting for the equality case):

            (SELECT agg(x) FROM inner
              WHERE inner.k = outer.k [AND uncorrelated...])

        becomes one grouped inner query ``SELECT k, agg(x) ... GROUP BY
        k`` run ONCE, substituted as a per-outer-row lookup on the
        correlation columns. Anything beyond ANDed equality correlation
        raises the established clear error."""
        import dataclasses

        inner_tables = _inner_tables_of(select)

        def unsupported(why: str):
            return InterpreterError(
                f"correlated subquery not supported: {why} (only a single "
                "scalar aggregate with ANDed `inner_col = outer.col` "
                "correlation is decorrelated)"
            )

        if len(select.items) != 1:
            raise unsupported("subquery must select exactly one expression")
        if (
            select.group_by
            or select.having is not None
            or select.order_by
            or select.limit is not None
            or select.offset
            or select.distinct
            or select.join is not None
        ):
            raise unsupported(
                "GROUP BY/HAVING/ORDER BY/LIMIT/OFFSET/DISTINCT/JOIN in the subquery"
            )
        item = select.items[0]
        non_where = [item.expr, *select.group_by]
        if _correlated_cols(non_where, scope, inner_tables):
            raise unsupported("outer reference outside the WHERE clause")

        pairs: list[tuple[str, ast.Column]] = []  # (inner col, outer Column)
        residual: list[ast.Expr] = []
        for conj in _flatten_and(select.where) if select.where is not None else []:
            corr = _correlated_cols([conj], scope, inner_tables)
            if not corr:
                residual.append(conj)
                continue
            ok = (
                isinstance(conj, ast.BinaryOp)
                and conj.op == "="
                and isinstance(conj.left, ast.Column)
                and isinstance(conj.right, ast.Column)
            )
            if not ok:
                raise unsupported(f"non-equality outer reference: {conj}")
            sides = {True: None, False: None}
            for col in (conj.left, conj.right):
                is_outer = bool(
                    col.qualifier
                    and col.qualifier in scope
                    and col.qualifier not in inner_tables
                )
                sides[is_outer] = col
            if sides[True] is None or sides[False] is None:
                raise unsupported(f"both sides of {conj} bind to one scope")
            pairs.append((sides[False].name, sides[True]))

        # One grouped query: correlation keys become GROUP BY columns.
        key_items = tuple(
            ast.SelectItem(ast.Column(inner_col), alias=f"__ck{i}")
            for i, (inner_col, _) in enumerate(pairs)
        )
        where = None
        for conj in residual:
            where = conj if where is None else ast.BinaryOp("AND", where, conj)
        value_item = dataclasses.replace(item, alias="__cv")
        grouped = True
        try:
            inner_plan = planner.plan(
                dataclasses.replace(
                    select,
                    items=(*key_items, value_item),
                    where=where,
                    group_by=tuple(ast.Column(c) for c, _ in pairs),
                )
            )
            grouped = bool(getattr(inner_plan, "is_aggregate", False))
        except Exception:
            grouped = False
        if not grouped:
            # Non-aggregate correlated scalar (SELECT col FROM ... WHERE
            # k = outer.k): legal SQL — fails only if some correlated
            # group yields more than one row (checked below).
            inner_plan = planner.plan(
                dataclasses.replace(
                    select,
                    items=(*key_items, value_item),
                    where=where,
                    group_by=(),
                )
            )
        nested = self._materialize_subqueries(inner_plan, outer_scope=scope)
        res = self.execute(nested if nested is not None else inner_plan)
        if not isinstance(res, ResultSet):
            raise unsupported("subquery must be a SELECT")

        def py(v):
            return v.item() if isinstance(v, np.generic) else v

        nulls = res.nulls or {}
        k = len(pairs)
        key_cols = res.columns[:k]
        val_col = res.columns[k]
        val_null = nulls.get(res.names[k])
        key_nulls = [nulls.get(res.names[i]) for i in range(k)]
        keys, values = [], []
        keyed: dict = {}
        for i in range(len(val_col)):
            if any(kn is not None and kn[i] for kn in key_nulls):
                # `inner.k = outer.k` is NULL (not true) when the inner
                # key is NULL — such rows can never match any outer row,
                # and must not surface as their column's fill value.
                continue
            key = tuple(py(col[i]) for col in key_cols)
            if not grouped and key in keyed:
                # SQL errors only when this key is actually probed by an
                # outer row — mark it and let the lookup raise then.
                values[keyed[key]] = ast.CORRELATED_DUP
                continue
            keyed[key] = len(keys)
            keys.append(key)
            values.append(
                None if (val_null is not None and val_null[i]) else py(val_col[i])
            )
        # SQL empty-group semantics: COUNT over no rows is 0, any other
        # aggregate is NULL.
        is_count = (
            isinstance(item.expr, ast.FuncCall) and item.expr.name == "count"
        )
        return ast.CorrelatedLookup(
            outer_cols=tuple(outer for _, outer in pairs),  # Column nodes
            keys=tuple(keys),
            values=tuple(values),
            default=0 if is_count else None,
        )

    def _decorrelate_exists(
        self, select: ast.Select, scope, planner
    ) -> ast.CorrelatedLookup:
        """Rewrite an equality-correlated EXISTS (the semi-join analog of
        _decorrelate_scalar): ``EXISTS (SELECT ... WHERE inner.k =
        outer.k [AND uncorrelated...])`` runs ONE distinct-key inner
        query and substitutes a per-outer-row boolean membership lookup
        (present -> True; missing or NULL outer key -> False, which NOT
        then flips for anti-join semantics)."""
        import dataclasses

        inner_tables = _inner_tables_of(select)

        def unsupported(why: str):
            return InterpreterError(
                f"correlated EXISTS not supported: {why} (only ANDed "
                "`inner_col = outer.col` correlation in the WHERE is "
                "decorrelated)"
            )

        if (
            select.group_by
            or select.having is not None
            or select.join is not None
            or select.offset
        ):
            raise unsupported("GROUP BY/HAVING/JOIN/OFFSET in the subquery")
        if select.limit is not None and select.limit <= 0:
            return ast.CorrelatedLookup(
                outer_cols=(), keys=(), values=(), default=False
            )
        from .planner import _is_agg_name, _walk

        if any(
            isinstance(x, ast.FuncCall) and _is_agg_name(x.name)
            for item in select.items
            for x in _walk(item.expr)
        ):
            # An ungrouped aggregate subquery yields EXACTLY one row for
            # every outer row (NULL aggregate over the empty group
            # included) — EXISTS is unconditionally TRUE.
            return ast.Literal(True)
        # The select items are irrelevant to EXISTS; only the WHERE's
        # correlation matters (outer refs anywhere else are unsupported).
        if _correlated_cols(
            [i.expr for i in select.items] + [o.expr for o in select.order_by],
            scope,
            inner_tables,
        ):
            raise unsupported("outer reference outside the WHERE clause")

        pairs: list[tuple[str, ast.Column]] = []  # (inner col, outer Column)
        residual: list[ast.Expr] = []
        for conj in _flatten_and(select.where) if select.where is not None else []:
            corr = _correlated_cols([conj], scope, inner_tables)
            if not corr:
                residual.append(conj)
                continue
            ok = (
                isinstance(conj, ast.BinaryOp)
                and conj.op == "="
                and isinstance(conj.left, ast.Column)
                and isinstance(conj.right, ast.Column)
            )
            if not ok:
                raise unsupported(f"non-equality outer reference: {conj}")
            sides = {True: None, False: None}
            for col in (conj.left, conj.right):
                is_outer = bool(
                    col.qualifier
                    and col.qualifier in scope
                    and col.qualifier not in inner_tables
                )
                sides[is_outer] = col
            if sides[True] is None or sides[False] is None:
                raise unsupported(f"both sides of {conj} bind to one scope")
            pairs.append((sides[False].name, sides[True]))
        if not pairs:
            raise unsupported("no equality correlation found")

        where = None
        for conj in residual:
            where = conj if where is None else ast.BinaryOp("AND", where, conj)
        inner_plan = planner.plan(
            dataclasses.replace(
                select,
                items=tuple(
                    ast.SelectItem(ast.Column(c), alias=f"__ek{i}")
                    for i, (c, _) in enumerate(pairs)
                ),
                where=where,
                group_by=(),
                order_by=(),
                limit=None,
                distinct=True,  # membership needs each key once
            )
        )
        nested = self._materialize_subqueries(inner_plan, outer_scope=scope)
        res = self.execute(nested if nested is not None else inner_plan)
        if not isinstance(res, ResultSet):
            raise unsupported("subquery must be a SELECT")

        def py(v):
            return v.item() if isinstance(v, np.generic) else v

        nulls = res.nulls or {}
        key_nulls = [nulls.get(n) for n in res.names]
        keys = []
        for i in range(res.num_rows):
            if any(kn is not None and kn[i] for kn in key_nulls):
                continue  # NULL inner key matches no outer row
            keys.append(tuple(py(col[i]) for col in res.columns))
        return ast.CorrelatedLookup(
            outer_cols=tuple(outer for _, outer in pairs),
            keys=tuple(keys),
            values=(True,) * len(keys),
            default=False,
        )

    def _insert(self, plan: InsertPlan) -> AffectedRows:
        table = self.catalog.open(plan.table)
        if table is None:
            raise InterpreterError(f"table not found: {plan.table}")
        rows = RowGroup.from_rows(table.schema, list(plan.rows))
        table.write(rows)
        return AffectedRows(len(rows))

    def _create(self, plan: CreateTablePlan) -> AffectedRows:
        partition_info = None
        if plan.partition_by is not None:
            partition_info = {
                "method": plan.partition_by.method,
                "columns": list(plan.partition_by.columns),
                "num_partitions": plan.partition_by.num_partitions,
            }
        self.catalog.create_table(
            plan.table,
            plan.schema,
            plan.options,
            if_not_exists=plan.if_not_exists,
            partition_info=partition_info,
        )
        return AffectedRows(0)

    def _describe(self, plan: DescribePlan) -> ResultSet:
        table = self.catalog.open(plan.table)
        if table is None:
            raise InterpreterError(f"table not found: {plan.table}")
        schema = table.schema
        names, types, keys, tags, nullables = [], [], [], [], []
        for i, c in enumerate(schema.columns):
            names.append(c.name)
            types.append(c.kind.value)
            keys.append(i in schema.primary_key_indexes)
            tags.append(c.is_tag)
            nullables.append(c.is_nullable)
        return ResultSet(
            ["name", "type", "is_primary", "is_nullable", "is_tag"],
            [
                np.array(names, dtype=object),
                np.array(types, dtype=object),
                np.array(keys),
                np.array(nullables),
                np.array(tags),
            ],
        )

    def _show_create(self, plan: ShowCreatePlan) -> ResultSet:
        table = self.catalog.open(plan.table)
        if table is None:
            raise InterpreterError(f"table not found: {plan.table}")
        schema = table.schema
        cols = []
        for i, c in enumerate(schema.columns):
            parts = [f"`{c.name}` {c.kind.value}"]
            if c.is_tag:
                parts.append("TAG")
            if not c.is_nullable:
                parts.append("NOT NULL")
            if c.comment:
                parts.append(f"COMMENT '{c.comment}'")
            cols.append(" ".join(parts))
        cols.append(f"TIMESTAMP KEY({schema.timestamp_name})")
        opts = table.options
        with_parts = [
            f"update_mode='{opts.update_mode.value.upper()}'",
            f"enable_ttl='{str(opts.enable_ttl).lower()}'",
        ]
        if opts.enable_ttl and opts.ttl_ms:
            with_parts.append(f"ttl='{format_duration(opts.ttl_ms)}'")
        if opts.memtable_type != "columnar":
            with_parts.append(f"memtable_type='{opts.memtable_type}'")
        if opts.segment_duration_ms:
            with_parts.insert(0, f"segment_duration='{format_duration(opts.segment_duration_ms)}'")
        sql = (
            f"CREATE TABLE `{plan.table}` ({', '.join(cols)}) "
            f"ENGINE=Analytic WITH ({', '.join(with_parts)})"
        )
        return ResultSet(
            ["Table", "Create Table"],
            [np.array([plan.table], dtype=object), np.array([sql], dtype=object)],
        )

    def _alter(self, plan: AlterTablePlan) -> AffectedRows:
        table = self.catalog.open(plan.table)
        if table is None:
            raise InterpreterError(f"table not found: {plan.table}")
        if plan.add_columns:
            schema = table.schema
            for c in plan.add_columns:
                schema = schema.with_added_column(c)
            table.alter_schema(schema)
        if plan.set_options:
            from ..engine.options import TableOptions

            merged = {**table.options.to_dict()}
            new = TableOptions.from_kv(plan.set_options).to_dict()
            for k in plan.set_options:
                key = {
                    "segment_duration": "segment_duration_ms",
                    "ttl": "ttl_ms",
                }.get(k.lower(), k.lower())
                if key in new:
                    merged[key] = new[key]
            table.alter_options(TableOptions.from_dict(merged))
        from ..utils.events import record_event

        record_event(
            "ddl_alter_table", table=plan.table,
            added_columns=len(plan.add_columns or ()),
            set_options=sorted(plan.set_options or ()),
        )
        return AffectedRows(0)


# ---- UNION / CTE helpers --------------------------------------------------


def _concat_results(results: list[ResultSet]) -> ResultSet:
    """Positional concatenation; names from the first result. Mismatched
    column dtypes widen to object (SQL's union type coercion, minus the
    numeric-promotion lattice DataFusion has)."""
    first = results[0]
    n_cols = len(first.names)
    for r in results[1:]:
        if len(r.names) != n_cols:
            raise InterpreterError("UNION branches produced different column counts")
    names = list(first.names)
    columns: list[np.ndarray] = []
    nulls: dict[str, np.ndarray] = {}
    for i in range(n_cols):
        parts = []
        mask_parts = []
        for r in results:
            col = r.columns[i]
            parts.append(col)
            m = (r.nulls or {}).get(r.names[i])
            mask_parts.append(
                m if m is not None else np.zeros(len(col), dtype=bool)
            )
        try:
            col = np.concatenate(parts)
        except (ValueError, TypeError):
            col = np.concatenate([p.astype(object) for p in parts])
        if col.dtype.kind not in "OUSb" and any(
            p.dtype.kind == "f" for p in parts
        ) and any(p.dtype.kind in "iu" for p in parts):
            col = col.astype(np.float64)
        columns.append(col)
        mask = np.concatenate(mask_parts)
        if mask.any():
            nulls[names[i]] = mask
    return ResultSet(names, columns, nulls or None)


def _order_limit_result(result: ResultSet, order_by, limit, offset: int = 0) -> ResultSet:
    """ORDER BY/LIMIT/OFFSET over a bare ResultSet (union output): order
    keys must name output columns of the first branch."""
    from .executor import _desc_key, _null_rank, _slice_result

    if order_by and result.num_rows:
        keys = []
        for o in reversed(order_by):
            name = o.expr.name if isinstance(o.expr, ast.Column) else str(o.expr)
            if name not in result.names:
                raise InterpreterError(
                    f"ORDER BY column {name!r} is not in the UNION output"
                )
            col = result.column(name)
            null_mask = (result.nulls or {}).get(name)
            valid = (
                np.ones(len(col), dtype=bool) if null_mask is None else ~null_mask
            )
            keys.append(col if o.ascending else _desc_key(col))
            keys.append(_null_rank(valid, o))
        order = np.lexsort(tuple(keys))
        result = ResultSet(
            result.names,
            [c[order] for c in result.columns],
            {k: v[order] for k, v in (result.nulls or {}).items()} or None,
        )
    if limit is not None or offset:
        result = _slice_result(result, offset, limit)
    return result


_HIDDEN_TS = "__hidden_ts"


def _result_to_table(name: str, res: ResultSet, plan):
    """Materialize a cte's ResultSet as an in-memory table.

    Column kinds come from the source schema when the output column is a
    plain (possibly aliased) source column, else from the numpy dtype.
    Derived columns are all plain fields (no tags/tsid — a cte output has
    no series identity), so queries over it take the host path. A result
    with no TIMESTAMP column gets a hidden zero timestamp column
    (schemas require one); SELECT * skips hidden columns.
    """
    from ..common_types.datum import DatumKind
    from ..common_types.dict_column import DictColumn, as_values
    from ..common_types.schema import ColumnSchema, Schema
    from ..table_engine.table import MemoryTable

    src_schema = plan.schema if isinstance(plan, QueryPlan) else None
    src_items: dict[str, ast.Expr] = {}
    if isinstance(plan, QueryPlan):
        for item in plan.select.items:
            if not isinstance(item.expr, ast.Star):
                src_items[item.output_name] = item.expr

    _DTYPE_KIND = {
        "f": DatumKind.DOUBLE,
        "i": DatumKind.INT64,
        "u": DatumKind.UINT64,
        "b": DatumKind.BOOLEAN,
    }
    cols: list[ColumnSchema] = []
    data: dict[str, np.ndarray] = {}
    validity: dict[str, np.ndarray] = {}
    seen = set()
    for out_name, col in zip(res.names, res.columns):
        if out_name in seen:
            raise InterpreterError(
                f"cte {name!r} has duplicate output column {out_name!r} "
                "(alias the expressions uniquely)"
            )
        seen.add(out_name)
        kind = None
        src = src_items.get(out_name)
        if (
            isinstance(src, ast.Column)
            and src_schema is not None
            and src_schema.has_column(src.name)
        ):
            kind = src_schema.column(src.name).kind
        elif src_schema is not None and src_schema.has_column(out_name):
            kind = src_schema.column(out_name).kind
        elif (
            isinstance(src, ast.FuncCall)
            and src.name == "time_bucket"
        ):
            kind = DatumKind.TIMESTAMP
        if kind is None:
            if isinstance(col, DictColumn):
                kind = DatumKind.STRING
            else:
                kind = _DTYPE_KIND.get(np.asarray(col).dtype.kind, DatumKind.STRING)
        cols.append(ColumnSchema(out_name, kind, is_nullable=True))
        data[out_name] = col
        m = (res.nulls or {}).get(out_name)
        if m is not None:
            validity[out_name] = ~m
    ts_name = next(
        (c.name for c in cols if c.kind is DatumKind.TIMESTAMP), None
    )
    n = res.num_rows
    if ts_name is None:
        ts_name = _HIDDEN_TS
        cols.append(ColumnSchema(ts_name, DatumKind.TIMESTAMP, is_nullable=False))
        data[ts_name] = np.zeros(n, dtype=np.int64)
    else:
        # a NULL timestamp row would break time filtering; coerce to 0
        vm = validity.get(ts_name)
        if vm is not None and not vm.all():
            vals = as_values(data[ts_name]).copy()
            vals[~vm] = 0
            data[ts_name] = vals
    schema = Schema.build(cols, timestamp_column=ts_name, primary_key=(ts_name,))
    table = MemoryTable(name, schema)
    if n:
        table.write(RowGroup(schema, data, validity))
    return table


class _OverlayCatalog:
    """Catalog view layering cte temp tables over the real catalog —
    reads resolve overlay-first; everything else passes through."""

    def __init__(self, base, overlay: dict) -> None:
        self._base = base
        self._overlay = overlay

    def open(self, name: str):
        t = self._overlay.get(name)
        return t if t is not None else self._base.open(name)

    def schema_of(self, name: str):
        t = self._overlay.get(name)
        return t.schema if t is not None else self._base.schema_of(name)

    def exists(self, name: str) -> bool:
        return name in self._overlay or self._base.exists(name)

    def table_names(self) -> list[str]:
        return sorted(set(self._base.table_names()) | set(self._overlay))

    def __getattr__(self, item):
        return getattr(self._base, item)
