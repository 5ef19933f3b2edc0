"""Query executor (ref: src/query_engine + DataFusion's operators).

Two execution paths, chosen per plan — mirroring the reference's
``ExecutableScanBuilder``/Resolver plugin boundary (dist_sql_query/mod.rs)
where the device backend plugs in:

- **fused device path**: scan + filter + group-by(tags, time_bucket) +
  {count,sum,min,max,avg} runs as the single ops.scan_agg kernel launch.
  Numeric field filters evaluate on device; tag/string filters and
  anything non-simple evaluate host-side as a row mask feeding the kernel.
- **host fallback**: vectorized numpy evaluation (projection, exact
  filters, sort, limit) — the CPU executor the device path is diffed and
  benchmarked against.

SQL NULL semantics: expression evaluation tracks a validity mask alongside
values; WHERE treats NULL comparisons as false (3-valued logic collapsed),
aggregates skip NULL inputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

from ..common_types.dict_column import DictColumn, as_values, unique_inverse
from ..common_types.row_group import RowGroup
from ..common_types.schema import Schema
from ..common_types.time_range import MAX_TIMESTAMP, MIN_TIMESTAMP
from ..engine.options import parse_duration_ms
from ..ops import ScanAggSpec, encode_group_codes, scan_aggregate
from ..ops.encoding import build_padded_batch, time_buckets
from ..table_engine.predicate import NUMPY_CMP, FilterOp, Predicate
from ..utils import querystats
from . import ast
from .plan import AggCall, GroupKey, QueryPlan

@dataclass
class ResultSet:
    """Query output: named columns + optional per-column NULL masks."""

    names: list[str]
    columns: list[np.ndarray]
    nulls: dict[str, np.ndarray] | None = None
    # per-request metric tree, attached by the executor (ref: trace_metric)
    metrics: dict | None = None

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def to_pylist(self) -> list[dict[str, Any]]:
        out = []
        nulls = self.nulls or {}
        for i in range(self.num_rows):
            row = {}
            for name, col in zip(self.names, self.columns):
                m = nulls.get(name)
                if m is not None and m[i]:
                    row[name] = None
                else:
                    v = col[i]
                    row[name] = v.item() if isinstance(v, np.generic) else v
            out.append(row)
        return out

    def column(self, name: str) -> np.ndarray:
        return self.columns[self.names.index(name)]

    @staticmethod
    def empty(names: list[str]) -> "ResultSet":
        return ResultSet(names, [np.empty(0, dtype=object) for _ in names])


class ExprError(ValueError):
    pass


# ---- host expression evaluation (values + validity) ---------------------


def eval_expr(e: ast.Expr, rows: RowGroup) -> tuple[np.ndarray, np.ndarray]:
    """-> (values, valid mask). Vectorized over all rows."""
    n = len(rows)
    if isinstance(e, ast.Column):
        return rows.column(e.name), rows.valid_mask(e.name)
    if isinstance(e, ast.Literal):
        if e.value is None:
            return np.zeros(n), np.zeros(n, dtype=bool)
        return np.full(n, e.value), np.ones(n, dtype=bool)
    if isinstance(e, ast.UnaryOp):
        v, m = eval_expr(e.operand, rows)
        if e.op == "-":
            return -v, m
        if e.op == "NOT":
            return ~v.astype(bool), m
        raise ExprError(f"unknown unary op {e.op}")
    if isinstance(e, ast.BinaryOp):
        return _eval_binary(e, rows)
    if isinstance(e, ast.WindowFunc):
        from .window import eval_window

        return eval_window(e, rows, eval_expr)
    if isinstance(e, ast.FuncCall):
        return _eval_func(e, rows)
    if isinstance(e, ast.CorrelatedLookup):
        return _eval_correlated_lookup(e, rows)
    if isinstance(e, ast.InList):
        v, m = eval_expr(e.expr, rows)
        lits = [
            lit.value for lit in e.values if isinstance(lit, ast.Literal)
        ]
        if isinstance(v, DictColumn) and len(lits) == len(e.values):
            hit = v.map_values(lambda vals: np.isin(vals, lits))
        else:
            v = as_values(v)
            hit = np.zeros(n, dtype=bool)
            for lit in e.values:
                lv, _ = eval_expr(lit, rows)
                hit |= v == as_values(lv)
        if e.negated:
            hit = ~hit
        return hit, m
    if isinstance(e, ast.Between):
        v, m = eval_expr(e.expr, rows)
        lo, ml = eval_expr(e.low, rows)
        hi, mh = eval_expr(e.high, rows)
        res = (v >= lo) & (v <= hi)
        if e.negated:
            res = ~res
        return res, m & ml & mh
    if isinstance(e, ast.IsNull):
        _, m = eval_expr(e.expr, rows)
        res = m if e.negated else ~m
        return res, np.ones(n, dtype=bool)
    if isinstance(e, ast.Like):
        return _eval_like(e, rows)
    if isinstance(e, ast.Case):
        return _eval_case(e, rows)
    if isinstance(e, ast.Cast):
        return _eval_cast(e, rows)
    raise ExprError(f"unsupported expression: {e}")


def _eval_like(e: ast.Like, rows: RowGroup) -> tuple[np.ndarray, np.ndarray]:
    """LIKE via one compiled regex over the column's UNIQUE values (dict
    columns match on the dictionary, not the rows)."""
    import re

    v, m = eval_expr(e.expr, rows)
    # % -> .*, _ -> . — everything else regex-escaped; anchored both ends.
    rx = re.compile(
        "".join(
            ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
            for ch in e.pattern
        )
        + r"\Z",
        re.DOTALL | (re.IGNORECASE if e.case_insensitive else 0),
    )

    def match_values(vals: np.ndarray) -> np.ndarray:
        return np.fromiter(
            (isinstance(x, str) and rx.match(x) is not None for x in vals),
            dtype=bool,
            count=len(vals),
        )

    if isinstance(v, DictColumn):
        hit = v.map_values(match_values)
    else:
        hit = match_values(as_values(v))
    return (~hit if e.negated else hit), m


def _eval_case(e: ast.Case, rows: RowGroup) -> tuple[np.ndarray, np.ndarray]:
    """First-match-wins; rows matching no branch (and no ELSE) are NULL."""
    n = len(rows)
    taken = np.zeros(n, dtype=bool)
    out = None
    valid = np.zeros(n, dtype=bool)
    branches = list(e.whens) + (
        [(None, e.else_)] if e.else_ is not None else []
    )
    for cond, result in branches:
        if cond is None:
            sel = ~taken
        else:
            cv, cm = eval_expr(cond, rows)
            sel = ~taken & cm & as_values(cv).astype(bool)
        if not sel.any():
            continue
        rv, rm = eval_expr(result, rows)
        rv = as_values(rv)
        if out is None:
            # Allocate from the first taken branch's dtype; mixed branch
            # types promote to object below.
            out = np.zeros(n, dtype=rv.dtype)
        if out.dtype != rv.dtype:
            out = out.astype(object)
        out[sel] = rv[sel]
        valid[sel] = rm[sel]
        taken |= sel
    if out is None:
        out = np.zeros(n)
    return out, valid


_CAST_NUMPY = {
    "bigint": np.int64, "int": np.int64, "integer": np.int64, "int64": np.int64,
    "smallint": np.int64, "tinyint": np.int64, "uint64": np.int64,
    "double": np.float64, "float": np.float64, "real": np.float64,
    "boolean": np.bool_, "bool": np.bool_,
    "timestamp": np.int64,
    "string": None, "varchar": None, "text": None,  # None -> str()
}


def _eval_cast(e: ast.Cast, rows: RowGroup) -> tuple[np.ndarray, np.ndarray]:
    v, m = eval_expr(e.expr, rows)
    v = as_values(v)
    if e.type_name not in _CAST_NUMPY:
        raise ExprError(f"unsupported CAST target type {e.type_name!r}")
    target = _CAST_NUMPY[e.type_name]
    if target is None:
        out = np.array([str(x) for x in v], dtype=object)
        return out, m
    try:
        if v.dtype == object or v.dtype.kind in "US":
            # String -> number errors on bad VALID strings (SQL casts are
            # strict), but NULL rows carry the '' kind-default fill and
            # are masked out — neutralize them before the strict cast.
            filled = np.where(m, v, "0")
            if target is np.int64:
                # Integer strings above 2^53 lose precision through
                # float64; parse directly and only route decimal/exponent
                # forms through the float path. Out-of-range integers must
                # ERROR (strict cast), not wrap through the float detour.
                try:
                    out = filled.astype(np.int64)
                except (ValueError, TypeError):
                    # Per-ELEMENT fallback: one decimal/exponent string in
                    # the column must not send the exact integer strings
                    # beside it through the lossy float64 detour. A cheap
                    # digit test (no per-element exceptions) picks the
                    # exact path; everything else parses as float and
                    # truncates on store. 'nan'/'inf' strings error here
                    # (strict cast) — the old whole-array C cast silently
                    # produced INT64_MIN garbage for them.
                    out = np.empty(len(filled), dtype=np.int64)
                    for i, s in enumerate(filled):
                        t = str(s)
                        body = t[1:] if t[:1] in "+-" else t
                        if body.isdigit():
                            out[i] = int(t)
                        else:
                            out[i] = np.float64(s)  # truncating int store
            else:
                out = filled.astype(np.float64).astype(target)
        elif target is np.int64 and v.dtype.kind == "f":
            out = np.trunc(np.where(m, v, 0)).astype(np.int64)
        else:
            out = np.where(m, v, 0).astype(target) if v.dtype.kind != "b" else v.astype(target)
    except (ValueError, TypeError, OverflowError) as ex:
        raise ExprError(f"CAST failed: {ex}")
    return out, m


def _eval_correlated_lookup(
    e: "ast.CorrelatedLookup", rows: RowGroup
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row lookup of a decorrelated scalar subquery's result by the
    outer correlation columns. Fully vectorized for any key arity via the
    same composite-code factorization the join uses. Semantics:

    - missing key OR NULL outer key  -> ``default`` (0 for COUNT, else NULL):
      a NULL key equality matches nothing, i.e. the empty group;
    - key whose value is NULL        -> NULL;
    - key marked CORRELATED_DUP      -> error, but ONLY if probed.
    """
    n = len(rows)
    m = len(e.keys)
    k = len(e.outer_cols)

    vals = list(e.values)
    null_v = np.array([v is None for v in vals], dtype=bool)
    dup_v = np.array([v is ast.CORRELATED_DUP for v in vals], dtype=bool)
    clean = [v for v in vals if v is not None and v is not ast.CORRELATED_DUP]
    if all(
        isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))
        for v in clean
    ) and (e.default is None or isinstance(e.default, int)):
        dtype = np.dtype(np.int64)
    elif all(
        isinstance(v, (int, float, np.number)) and not isinstance(v, (bool, np.bool_))
        for v in clean
    ):
        dtype = np.dtype(np.float64)
    else:
        dtype = np.dtype(object)
    # NULL/missing slots carry a well-typed fill (the engine-wide
    # convention — see RowGroup): "" for object/string values, 0 for
    # numerics. An arbitrary 0 inside an object column would break
    # downstream sorts/uniques with a str-vs-int TypeError.
    fill = "" if dtype == object else 0
    val_arr = np.full(m, fill, dtype=dtype)
    for i, v in enumerate(vals):
        if not (null_v[i] or dup_v[i]):
            val_arr[i] = v

    out = np.full(n, fill, dtype=dtype)
    mask = np.zeros(n, dtype=bool)
    if n == 0:
        return out, mask

    valid = np.ones(n, dtype=bool)
    for c in e.outer_cols:
        valid &= rows.valid_mask(c.name)

    hit = np.zeros(n, dtype=bool)
    idx = np.zeros(n, dtype=np.int64)
    if m:
        outer_arrays = [
            np.asarray(as_values(rows.column(c.name)), dtype=object)
            for c in e.outer_cols
        ]
        key_arrays = [
            np.array([key[j] for key in e.keys], dtype=object) for j in range(k)
        ]
        from .join import _composite_codes

        lc, rc = _composite_codes(outer_arrays, key_arrays)
        order = np.argsort(rc, kind="stable")
        rc_s = rc[order]
        pos = np.minimum(np.searchsorted(rc_s, lc, side="left"), m - 1)
        hit = (rc_s[pos] == lc) & valid
        idx = order[pos]
        if dup_v.any():
            probed_dup = hit & dup_v[idx]
            if probed_dup.any():
                j = int(idx[np.nonzero(probed_dup)[0][0]])
                raise ExprError(
                    "correlated scalar subquery returned more than one "
                    f"row for correlation key {e.keys[j]}"
                )
        real = hit & ~null_v[idx]
        out[real] = val_arr[idx[real]]
        mask[real] = True
    miss = ~hit
    if e.default is not None:
        out[miss] = e.default
        mask[miss] = True
    return out, mask


def _eval_binary(e: ast.BinaryOp, rows: RowGroup) -> tuple[np.ndarray, np.ndarray]:
    op = e.op.upper()
    lv, lm = eval_expr(e.left, rows)
    rv, rm = eval_expr(e.right, rows)
    # Dictionary fast path: compare the VOCABULARY against the literal and
    # gather through codes (O(|vocab|) compares instead of O(n)).
    if op in NUMPY_CMP:
        fn = NUMPY_CMP[op]
        if isinstance(lv, DictColumn) and isinstance(e.right, ast.Literal):
            return lv.map_values(lambda vals: fn(vals, e.right.value)), lm & rm
        if isinstance(rv, DictColumn) and isinstance(e.left, ast.Literal):
            return rv.map_values(lambda vals: fn(e.left.value, vals)), lm & rm
    lv, rv = as_values(lv), as_values(rv)
    if op == "AND":
        # NULL AND false == false: a side that is definitively false wins.
        l = lv.astype(bool) & lm
        r = rv.astype(bool) & rm
        return l & r, np.ones(len(rows), dtype=bool)
    if op == "OR":
        l = lv.astype(bool) & lm
        r = rv.astype(bool) & rm
        return l | r, np.ones(len(rows), dtype=bool)
    valid = lm & rm
    if op == "+":
        return lv + rv, valid
    if op == "-":
        return lv - rv, valid
    if op == "*":
        return lv * rv, valid
    if op == "/":
        with np.errstate(divide="ignore", invalid="ignore"):
            out = lv / rv
        return out, valid & (rv != 0)
    if op == "%":
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.mod(lv, rv)
        return out, valid & (rv != 0)
    if op in NUMPY_CMP:
        return NUMPY_CMP[op](lv, rv), valid
    raise ExprError(f"unknown binary op {e.op}")


def _eval_func(e: ast.FuncCall, rows: RowGroup) -> tuple[np.ndarray, np.ndarray]:
    """Scalar function dispatch through the registry (ref: df_operator
    FunctionRegistry — time_bucket/abs are built-ins, users register more)."""
    from .functions import REGISTRY

    entry = REGISTRY.scalar(e.name)
    if entry is None:
        raise ExprError(f"unsupported function {e.name!r} in row expression")
    if e.filter_where is not None:
        raise ExprError(f"FILTER is only valid on aggregate functions, not {e.name!r}")
    fn, raw_args = entry
    if raw_args:
        # first arg evaluated; the rest pass as raw AST (literal params)
        args = [eval_expr(e.args[0], rows), *e.args[1:]]
    else:
        args = [eval_expr(a, rows) for a in e.args]
    return fn(args, rows)


# ---- executor ------------------------------------------------------------


def _translate_code_literal(dict_host: np.ndarray, op: str, lit) -> float:
    """Pre-translate a numeric filter literal into the CODE domain of a
    dictionary-encoded column: the dictionary is sorted, so
    code order == value order and every comparison op maps onto the same
    op over code indices — the kernel filters bit-packed codes without
    ever touching the dictionary. The op never changes; only the
    literal moves, and literals ride the dynamic buffer. Codes are
    < 2^16, exact in f32."""
    lit32 = np.float32(lit) if dict_host.dtype.kind == "f" else lit
    if op == "<" or op == ">=":
        # value < lit  <=>  code < left;  value >= lit  <=>  code >= left
        return float(np.searchsorted(dict_host, lit32, "left"))
    if op == "<=" or op == ">":
        # value <= lit <=> code <= right-1; value > lit <=> code > right-1
        return float(np.searchsorted(dict_host, lit32, "right") - 1)
    # "=" / "!=": the exact code, or a sentinel no code (>= 0) can equal
    i = int(np.searchsorted(dict_host, lit32, "left"))
    if i < len(dict_host) and dict_host[i] == lit32:
        return float(i)
    return -1.0


@dataclass
class CachedAggPrep:
    """A fully-prepared cached-aggregate device dispatch — the output of
    the "plan -> device spec" half (Executor.prepare_cached_agg) and the
    input of the "spec -> dispatch" half. Everything per-query the
    kernel needs is HERE (small host arrays + scalars), so shape-
    identical preps could be merged into one batched dispatch before any
    device work happens (Executor.dispatch_cached_agg)."""

    plan: Any
    m: dict
    entry: Any  # scan-cache entry holding the HBM-resident columns
    spec: Any  # padded ScanAggSpec with the CONCRETE segment impl
    krec: Any  # kernel-router token (None when routing doesn't apply)
    value_names: list
    literals: list
    device_filters: list
    gos: np.ndarray  # series -> group map (+ pad slot)
    allow: np.ndarray  # tag-filter allow-list (+ pad slot; delta fold)
    allow_scan: np.ndarray  # allow AND value-stat pruning (scan only)
    row_idx: Optional[np.ndarray]  # selective gather index, or None
    lo: int
    hi: int
    t0: int
    width: Optional[int]
    n_buckets: int
    empty_range: bool
    lo_rel: int
    hi_rel: int
    t0_rel: int
    width_i: int
    kernel_key: tuple
    tag_keys: list
    key_values: tuple
    agg_cols: list
    num_groups: int
    delta: Any
    # static per-field layout descriptors of the resident value columns
    value_layouts: tuple = ()


class Executor:
    """Executes QueryPlans against Tables (AnalyticTable / PartitionedTable
    / MemoryTable — anything behind the table_engine.Table interface)."""

    def __init__(self, device) -> None:
        # the connection's device: the scan cache and every kernel call
        # place their tensors on it
        self.device = device
        # observability: which path ran last
        # ("device-cached" | "device" | "host")
        self.last_path: str = ""
        # per-request metric tree (ref: trace_metric MetricsCollector —
        # stage timings threaded through the read path)
        self.last_metrics: dict = {}
        from .scan_cache import ScanCache

        self.scan_cache = ScanCache(device)

    def execute(
        self, plan: QueryPlan, table, _skip_cached_agg: bool = False
    ) -> ResultSet:
        """``_skip_cached_agg``: execute_cohort's fallback for a member
        whose cached-path prepare already bailed — the bail is
        deterministic for the same state, so retrying it here would
        only double the prepare work and the cache_misses count."""
        import time as _time

        from ..utils.deadline import checkpoint as _deadline_checkpoint

        # Cooperative checkpoint at executor entry (and again before
        # each scan batch / window / device dispatch below): a cancelled
        # or expired query unwinds HERE, with the admission slot
        # released by the admit context manager's finally.
        _deadline_checkpoint("executing")
        t_start = _time.perf_counter()
        # Per-call dict threaded through the stages and attached to the
        # RESULT — concurrent queries never share mutable metric state.
        m: dict = {"table": plan.table}
        import os as _os

        cache_on = _os.environ.get("HORAEDB_SCAN_CACHE", "1") != "0"
        # Every aggregate shape the kernels can serve runs on the
        # connection's device: the port has no measured device/host
        # routing, so no query moves to the CPU while its table is resident.

        # Memory bound: when pruned SST metadata says the scan would
        # materialize more than HORAEDB_AGG_MEMORY_MB, aggregate per
        # segment window through the partial machinery instead — checked
        # BEFORE the cache path, whose build would materialize the whole
        # table (ref: instance/read.rs:165-190 streaming reads).
        bounded = False
        if plan.is_aggregate and table.physical_datas():
            from .partial import _agg_memory_cap_bytes, _scan_estimate_bytes

            cap = _agg_memory_cap_bytes()
            bounded = bool(cap) and _scan_estimate_bytes(
                table, plan.predicate, self._projection(plan)
            ) > cap
        if (
            plan.is_aggregate and cache_on and not bounded
            and not _skip_cached_agg
        ):
            cached = self._try_cached_agg(plan, table, m)
            if cached is not None:
                path = "device-cached"
                return self._finish_metrics(m, t_start, path, cached)
        # Partitioned tables: push the aggregate DOWN to each partition
        # (local kernel per partition; remote partitions over the wire —
        # ref: dist_sql_query resolver push-down) and combine partials.
        if plan.is_aggregate and hasattr(table, "sub_tables"):
            out = self._try_partitioned_agg(plan, table, m)
            if out is not None:
                return self._finish_metrics(m, t_start, "device-partial", out)
        # Bounded plain-table aggregate: same partial machinery the
        # partitioned scatter uses (Table.partial_agg -> compute_partial,
        # which iterates per-window pieces under the cap). The hint rides
        # in the spec so compute_partial neither re-walks the metadata
        # nor can disagree near the cap boundary; partitioned scatters
        # never set it — each owner estimates its OWN data.
        if bounded and not hasattr(table, "sub_tables"):
            out = self._try_partitioned_agg(plan, table, m, bounded_hint=True)
            if out is not None:
                return self._finish_metrics(m, t_start, "device-partial", out)
        # Plan-subtree shipping: window/topk/distinct/full-agg/filter
        # shapes execute on partition owners instead of pulling raw rows
        # (ref: dist_sql_query resolver execute_physical_plan push-down).
        if hasattr(table, "sub_tables"):
            from .dist_plan import try_dist_plan

            out = try_dist_plan(self, plan, table, m)
            if out is not None:
                return self._finish_metrics(m, t_start, "dist-plan", out)
        from ..utils.tracectx import span as _span

        t_scan = _time.perf_counter()
        projection = self._projection(plan)
        predicate = plan.predicate
        if not plan.is_aggregate and self._limit_pushdown_safe(plan):
            # LIMIT pushdown: the scan may stop early. Only when no
            # residual WHERE / ORDER BY / DISTINCT needs the complete set.
            # OFFSET rows are still scanned (then skipped in assembly).
            predicate = predicate.with_limit(
                plan.select.limit + plan.select.offset
            )
            from ..engine.options import UpdateMode

            if getattr(
                getattr(table, "options", None), "update_mode", None
            ) is UpdateMode.APPEND:
                # only the append scan actually early-stops; don't claim
                # the optimization on dedup scans that ignore the hint
                m["limit_pushdown"] = plan.select.limit
        with _span("scan", table=plan.table) as sp:
            rows = table.read(predicate, projection=projection)
            sp.set(rows=len(rows))
        m["scan_ms"] = round((_time.perf_counter() - t_scan) * 1000, 3)
        m["rows_scanned"] = len(rows)
        querystats.record(scan_rows=len(rows))
        if plan.is_aggregate and self._device_capable(plan, rows):
            with _span("aggregate", path="device"):
                out = self._execute_agg_device(plan, rows, m)
            path = "device"
        elif plan.is_aggregate:
            path = "host"
            with _span("aggregate", path="host"):
                out = self._execute_agg_host(plan, rows)
        else:
            path = "host"
            with _span("project"):
                out = self._execute_projection(plan, rows, m)
        return self._finish_metrics(m, t_start, path, out)

    def _finish_metrics(
        self, m: dict, t_start: float, path: str, out: ResultSet
    ) -> ResultSet:
        import time as _time

        m["path"] = path
        m["result_rows"] = out.num_rows
        m["total_ms"] = round((_time.perf_counter() - t_start) * 1000, 3)
        # The ledger's route is which of the six executor paths actually
        # served the request (the cost side of the span tree).
        querystats.set_route(path)
        out.metrics = m
        # Observability conveniences; atomic rebinds (read-only snapshots
        # for tests/dashboards — per-request truth travels on the result).
        self.last_path = path
        self.last_metrics = m
        return out

    # ---- common ----------------------------------------------------------
    def _projection(self, plan: QueryPlan) -> Optional[list[str]]:
        """Columns the query touches (None = all, for SELECT *)."""
        names: list[str] = []
        stmt = plan.select
        for item in stmt.items:
            if isinstance(item.expr, ast.Star):
                return None
            names.extend(c.name for c in _columns_of(item.expr))
        for e in (stmt.where, *stmt.group_by):
            if e is not None:
                names.extend(c.name for c in _columns_of(e))
        # ORDER BY may name select aliases — only real columns join the scan.
        for o in stmt.order_by:
            names.extend(
                c.name for c in _columns_of(o.expr) if plan.schema.has_column(c.name)
            )
        return list(dict.fromkeys(names))

    def _residual_where(self, plan: QueryPlan) -> Optional[ast.Expr]:
        """WHERE minus what the predicate captured == what must still be
        evaluated exactly. Conservative: everything except pure timestamp
        range conjuncts (storage applies the time range exactly)."""
        where = plan.select.where
        if where is None:
            return None
        ts = plan.schema.timestamp_name
        from .planner import _as_simple_cmp, _conjuncts

        keep = []
        for conj in _conjuncts(where):
            simple = _as_simple_cmp(conj)
            if simple is not None and simple[0] == ts and simple[1] != "!=":
                continue  # exact via storage time filter
            if (
                isinstance(conj, ast.Between)
                and not conj.negated
                and isinstance(conj.expr, ast.Column)
                and conj.expr.name == ts
                # Must match extract_predicate's pushdown condition exactly:
                # only plain-literal bounds were turned into the time range.
                and isinstance(conj.low, ast.Literal)
                and isinstance(conj.high, ast.Literal)
            ):
                continue
            keep.append(conj)
        if not keep:
            return None
        out = keep[0]
        for c in keep[1:]:
            out = ast.BinaryOp("AND", out, c)
        return out

    def _limit_pushdown_safe(self, plan: QueryPlan) -> bool:
        """True when the scan may stop at LIMIT rows without changing the
        result: no ORDER BY / DISTINCT / join / GROUP BY (those need every
        row), and no residual WHERE — _residual_where is the single source
        of truth for "what storage did NOT apply", so a limit pushes down
        exactly when the projection has nothing left to filter."""
        sel = plan.select
        if sel is None or sel.limit is None:
            return False
        if sel.order_by or sel.distinct or sel.join is not None or sel.group_by:
            return False
        from .planner import _walk

        if any(
            isinstance(e, ast.WindowFunc)
            for item in sel.items
            for e in _walk(item.expr)
        ):
            return False  # window frames need the complete row set
        return self._residual_where(plan) is None

    def _try_partitioned_agg(
        self, plan: QueryPlan, table, m: dict, bounded_hint: bool = False
    ) -> Optional[ResultSet]:
        from .partial import assemble_result, combine_partials, spec_from_plan

        spec = spec_from_plan(self, plan)
        if spec is None:
            return None  # shape not pushable: gather-rows fallback below
        if bounded_hint:
            spec["bounded_hint"] = True
        from ..utils.tracectx import span as _span, wire_context

        wire = wire_context()
        if wire is not None:
            # remote partitions serve under the coordinator's trace id and
            # ship their span subtree home in the RPC response
            spec["trace"] = wire
            m["request_id"] = wire["request_id"]
        with _span("partial_agg", table=plan.table):
            names, arrays, stage_metrics = table.partial_agg(spec)
        with _span("combine") as sp:
            combined, n_groups = combine_partials([(names, arrays)], spec)
            sp.set(groups=n_groups)
            rule = getattr(table, "rule", None)  # plain tables: bounded path
            if rule is not None:
                keep = rule.prune(plan.predicate)
                m["partitions"] = (
                    len(keep) if keep is not None else len(table.sub_tables)
                )
            m["partial_stages"] = stage_metrics
            return assemble_result(plan, combined, n_groups, spec)

    # ---- learned kernel routing --------------------------------------------
    def _route_kernel(self, plan: QueryPlan, spec, n_rows: int,
                      est_distinct):
        """Learned segment-impl choice for a padded spec (the "database
        picks its own data structures" loop): seed from estimated group
        cardinality + observed query_stats history, then serve the
        measured winner with periodic re-probes. Returns (spec, token);
        token is None when routing doesn't apply (n_seg == 1, pinned
        HORAEDB_SEGMENT_IMPL, or router disabled)."""
        from .path_router import plan_shape_key

        ledger = querystats.current_ledger()
        return route_segment_kernel(
            plan_shape_key(plan), spec, n_rows, est_distinct,
            sql=ledger.sql if ledger else "", device=self.device,
        )

    def _finish_kernel(self, krec, spec, m: dict, state,
                       seconds: float, n_valid=None) -> None:
        finish_segment_kernel(krec, spec, m, state, seconds, n_valid)

    # ---- device path -------------------------------------------------------
    def _agg_device_shape(self, plan: QueryPlan):
        """(tag_keys, bucket_key, agg_cols) when the aggregation shape fits
        the device kernels, else None. Shared by the cached and uncached
        device paths — eligibility rules live HERE only."""
        schema = plan.schema
        tag_names = set(schema.tag_names)
        bucket_keys = [k for k in plan.group_keys if k.time_bucket_ms is not None]
        if len(bucket_keys) > 1:
            return None
        for k in plan.group_keys:
            if k.column is not None and k.column not in tag_names:
                return None
        for a in plan.aggs:
            if a.distinct or a.func not in ("count", "sum", "min", "max", "avg"):
                return None  # registry aggregates run on the host path
            if a.filter_where is not None:
                return None  # per-aggregate FILTER masks run on the host path
            if a.column is not None and not schema.column(a.column).kind.is_numeric:
                return None
        tag_keys = [k for k in plan.group_keys if k.column is not None]
        agg_cols = list(dict.fromkeys(a.column for a in plan.aggs if a.column))
        return tag_keys, (bucket_keys[0] if bucket_keys else None), agg_cols

    def _split_residual_filters(self, plan: QueryPlan):
        """Residual WHERE conjuncts -> (numeric device filters, the rest).

        Shared classification: a conjunct becomes a device filter when it
        is ``float_column op numeric_literal``; everything else stays an
        AST conjunct for the caller to evaluate (host mask, or per-series
        for the cached path)."""
        from .planner import _as_simple_cmp, _conjuncts

        schema = plan.schema
        device_filters: list[tuple[str, str, float]] = []
        other: list[ast.Expr] = []
        residual = self._residual_where(plan)
        if residual is not None:
            for conj in _conjuncts(residual):
                simple = _as_simple_cmp(conj)
                if (
                    simple is not None
                    and schema.has_column(simple[0])
                    and schema.column(simple[0]).kind.is_float
                    and isinstance(simple[2], (int, float))
                ):
                    device_filters.append(simple)
                else:
                    other.append(conj)
        return device_filters, other

    def _device_capable(self, plan: QueryPlan, rows: RowGroup) -> bool:
        if self._agg_device_shape(plan) is None:
            return False
        for a in plan.aggs:
            # One shared device mask can't express per-field NULL sets; a
            # NULL in any aggregated column routes to the host path where
            # aggregates skip NULLs per field.
            if a.column is not None and not rows.valid_mask(a.column).all():
                return False
        return True

    def _execute_agg_device(
        self, plan: QueryPlan, rows: RowGroup, m: dict | None = None
    ) -> ResultSet:
        from ..utils.deadline import checkpoint as _deadline_checkpoint

        # last cheap exit before committing to a device dispatch
        _deadline_checkpoint("dispatch")
        tag_keys, bucket_key, agg_cols = self._agg_device_shape(plan)
        # Numeric field filters -> device; the rest -> host row mask.
        device_filters, host_residue = self._split_residual_filters(plan)

        n = len(rows)
        mask = np.ones(n, dtype=bool)
        for conj in host_residue:
            v, valid = eval_expr(conj, rows)
            mask &= v.astype(bool) & valid

        enc = encode_group_codes(rows, [k.column for k in tag_keys])

        if bucket_key is not None:
            width = bucket_key.time_bucket_ms
            tr = plan.predicate.time_range
            t0 = tr.inclusive_start if tr.inclusive_start != MIN_TIMESTAMP else (
                int(rows.timestamps.min()) if n else 0
            )
            t0 = (t0 // width) * width
            bucket_ids, n_buckets = (
                time_buckets(rows.timestamps, t0, width) if n else (np.zeros(0, np.int32), 1)
            )
        else:
            width = None
            t0 = 0
            bucket_ids, n_buckets = np.zeros(n, dtype=np.int32), 1

        filter_cols = [f[0] for f in device_filters]
        value_names = list(dict.fromkeys(agg_cols + filter_cols))
        value_arrays = [as_values(rows.column(c)) for c in value_names]
        batch = build_padded_batch(enc.codes, bucket_ids, mask, value_arrays)
        spec = ScanAggSpec(
            n_groups=max(enc.num_groups, 1),
            n_buckets=n_buckets,
            n_agg_fields=len(agg_cols),
            numeric_filters=tuple(
                (value_names.index(col), op) for col, op, _ in device_filters
            ),
            need_minmax=_plan_needs_minmax(plan),
        ).padded()
        literals = [lit for _, _, lit in device_filters]

        # Learned kernel choice. Group codes are dense (np.unique), so
        # groups x buckets is an exact ceiling on live segments; bucket
        # sparsity (and router history) can only pull it down.
        spec, krec = self._route_kernel(
            plan, spec, n_rows=n,
            est_distinct=max(enc.num_groups, 1) * n_buckets,
        )

        import time as _time

        t_kernel = _time.perf_counter()
        state = scan_aggregate(batch, spec, literals, device=self.device)
        if m is not None:
            self._finish_kernel(
                krec, spec, m, state,
                _time.perf_counter() - t_kernel, n_valid=batch.n_valid,
            )

        return self._assemble_agg_result(
            plan, tag_keys, enc.key_values, agg_cols, state,
            max(enc.num_groups, 1), n_buckets, t0, width,
        )

    def _assemble_agg_result(
        self, plan, tag_keys, key_values, agg_cols, state, G, B, t0, width
    ) -> ResultSet:
        counts = state.counts[:G, :B]
        sums = state.sums[:, :G, :B]
        mins = state.mins[:, :G, :B]
        maxs = state.maxs[:, :G, :B]

        live = counts > 0  # (G, B)
        g_idx, b_idx = np.nonzero(live)
        if len(g_idx) == 0 and not plan.group_keys:
            # SQL: an ungrouped aggregate over zero rows yields ONE row
            # (count 0, other aggregates NULL).
            return _order_and_limit(_empty_ungrouped_agg_row(plan), plan)

        names: list[str] = []
        columns: list[np.ndarray] = []
        nulls: dict[str, np.ndarray] = {}
        agg_expr_map = dict(plan.agg_exprs)
        computed = None
        if agg_expr_map:
            base = {
                k.column: (np.asarray(key_values[ki])[g_idx], None)
                for ki, k in enumerate(tag_keys)
            }
            for a in plan.aggs:
                base[a.output_name] = (
                    _agg_output(a, agg_cols, counts, sums, mins, maxs, g_idx, b_idx),
                    None,
                )
            computed = eval_agg_exprs(plan, base)
        for item in plan.select.items:
            out_name = item.output_name
            e = item.expr
            if out_name in agg_expr_map:
                v, nm = computed[out_name]
                columns.append(v)
                if nm is not None:
                    nulls[out_name] = nm
                names.append(out_name)
            elif isinstance(e, ast.Column):
                ki = [k.column for k in tag_keys].index(e.name)
                columns.append(np.asarray(key_values[ki])[g_idx])
                names.append(out_name)
            elif isinstance(e, ast.FuncCall) and e.name in ("time_bucket", "date_trunc"):
                columns.append(t0 + b_idx.astype(np.int64) * (width or 1))
                names.append(out_name)
            else:
                agg_i = [a.output_name for a in plan.aggs].index(out_name)
                a = plan.aggs[agg_i]
                col = _agg_output(a, agg_cols, counts, sums, mins, maxs, g_idx, b_idx)
                columns.append(col)
                names.append(out_name)
        result = ResultSet(names, columns, nulls or None)
        return _order_and_limit(result, plan)

    # ---- device-cached path (HBM-resident columns) ---------------------------
    #
    # Split into "plan -> device spec" (prepare_cached_agg: eligibility,
    # cache entry, per-series filters, time math, kernel routing — pure
    # host work producing a CachedAggPrep) and "spec -> dispatch"
    # (dispatch_cached_agg: the kernel launch, delta fold, result
    # assembly).

    def _try_cached_agg(self, plan: QueryPlan, table, m: dict) -> Optional[ResultSet]:
        """Serve an aggregate from device-resident scan state, or None.

        Ships only O(series)+O(1) data per query; see query/scan_cache.py.
        """
        prep = self.prepare_cached_agg(plan, table, m)
        if prep is None:
            return None
        return self.dispatch_cached_agg(prep)

    def prepare_cached_agg(
        self, plan: QueryPlan, table, m: dict
    ) -> Optional["CachedAggPrep"]:
        """The "plan -> device spec" half: everything up to (but not
        including) the kernel dispatch. Returns None exactly where the
        cached path bails (caller falls through to the uncached
        paths)."""
        schema = plan.schema
        if schema.tsid_index is None or not table.physical_datas():
            return None
        if hasattr(table, "sub_tables") and len(table.physical_datas()) != len(
            table.sub_tables
        ):
            # Remote partitions: their writes are invisible to the local
            # fingerprint/delta — caching would serve stale aggregates
            # forever. The partitioned push-down path handles these.
            return None
        shape = self._agg_device_shape(plan)
        if shape is None:
            return None
        tag_keys, bucket_key, agg_cols = shape
        if bucket_key is not None and bucket_key.time_bucket_ms > 2**31 - 1:
            return None  # relative-int32 bucket math can't express it

        # Residual conjuncts must all be numeric device filters or
        # series-level (tag-only) filters; anything else -> uncached paths.
        tag_names = set(schema.tag_names)
        device_filters, other = self._split_residual_filters(plan)
        series_filters: list = []
        for conj in other:
            if _is_series_conjunct(conj, tag_names):
                series_filters.append(conj)
            else:
                return None

        filter_cols = [f[0] for f in device_filters]
        value_names = list(dict.fromkeys(agg_cols + filter_cols))

        # Dtype auto-tuning feedback: which aggregates/filters touch each
        # value column decides whether its resident copy may be bf16
        # (HORAEDB_CACHE_DTYPE=auto) — see ScanCache.note_usage.
        self.scan_cache.note_usage(
            table.name,
            value_names,
            sum_cols={
                a.column for a in plan.aggs
                if a.column and a.func in ("sum", "avg")
            },
            filter_cols=set(filter_cols),
        )

        entry, built, delta = self.scan_cache.get(
            table, value_names, read_rows=lambda: table.read(Predicate.all_time())
        )
        if entry is None or delta is None:
            # an ELIGIBLE query the cache couldn't serve (first sighting,
            # raced write, budget refusal) — a miss in the ledger's terms
            querystats.record(cache_misses=1)
            return None
        # NULL agg inputs need per-field masks — not expressible here.
        for c in agg_cols:
            if not entry.all_valid.get(c, False):
                return None
        # Unflushed delta rows fold into the aggregate ON TOP of the HBM
        # base — but only when provably sound (see _delta_soundness).
        if len(delta) and not self._delta_soundness(table, entry, delta, agg_cols):
            return None
        # Eligibility confirmed: only now record cache facts (a bail-out
        # above must not leave 'cache' lying in a host-path metric tree).
        m["cache"] = "build" if built else ("hit+delta" if len(delta) else "hit")
        m["rows_scanned"] = entry.n_valid + len(delta)
        querystats.record(scan_rows=entry.n_valid + len(delta))
        if built:
            querystats.record(cache_misses=1)
        else:
            querystats.record(cache_hits=1, cache_bytes=entry.device_bytes)
        if len(delta):
            m["delta_rows"] = len(delta)
            querystats.record(memtable_rows=len(delta))

        # Series-level small arrays (one row per unique series); validity
        # slices carry over so NULL-tag semantics match the host path.
        S = entry.n_series
        series_rows = None
        if tag_keys or series_filters:
            series_rows = entry.series_rows  # derived at build, one row/series
        if tag_keys:
            from ..ops.encoding import _codes_from_columns

            series_group, key_values = _codes_from_columns(
                [series_rows.columns[k.column] for k in tag_keys]
            )
            num_groups = len(key_values[0])
        else:
            series_group = np.zeros(S, dtype=np.int64)
            key_values = ()
            num_groups = 1
        allowed = np.ones(S, dtype=bool)
        for conj in series_filters:
            v, valid = eval_expr(conj, series_rows)
            allowed &= np.asarray(as_values(v)).astype(bool) & valid
        # Value-stat series pruning (the cached analog of row-group
        # min/max pruning): a series none of whose BASE values can pass a
        # numeric filter is excluded from the scan — but NOT from the
        # delta fold, whose fresh rows the base stats don't cover; the
        # delta applies the filters exactly per row.
        scan_allowed = allowed
        stats = entry.series_value_stats or {}
        for col, op, lit in device_filters:
            st = stats.get(col)
            if st is None:
                continue
            mins, maxs = st
            could = _series_could_match(mins, maxs, op, lit)
            if could is not None:
                if scan_allowed is allowed:
                    scan_allowed = allowed.copy()
                scan_allowed &= could

        # Time range + bucketing, relative to the cache origin. An empty
        # intersection keeps rel bounds at (0, 0) — NOT raw epoch deltas,
        # which overflow int32. Data bounds include the delta (fresh rows
        # usually extend past the cached max timestamp).
        tr = plan.predicate.time_range
        data_min, data_max = entry.min_ts, entry.max_ts
        if len(delta):
            # span already validated by _delta_soundness
            d_ts = delta.timestamps
            data_min = min(data_min, int(d_ts.min()))
            data_max = max(data_max, int(d_ts.max()))
        lo = max(tr.inclusive_start, data_min)
        hi = min(tr.exclusive_end, data_max + 1)
        empty_range = hi <= lo
        width = bucket_key.time_bucket_ms if bucket_key is not None else None
        if empty_range:
            t0 = entry.min_ts
            lo = hi = entry.min_ts
            n_buckets = 1
        elif width is not None:
            t0 = (lo // width) * width
            n_buckets = max(1, -(-(hi - t0) // width))
        else:
            t0 = lo
            n_buckets = 1

        spec = ScanAggSpec(
            n_groups=max(num_groups, 1),
            n_buckets=n_buckets,
            n_agg_fields=len(agg_cols),
            numeric_filters=tuple(
                (value_names.index(col), op) for col, op, _ in device_filters
            ),
            need_minmax=_plan_needs_minmax(plan),
        ).padded()

        # Learned kernel choice. Unlike the direct path, the cached
        # domain spans EVERY group in the table while the allow-list may
        # keep a handful of series. Estimate live segments from the
        # groups the allowed series can actually reach (exact on the
        # group axis, ceiling on the bucket axis).
        if scan_allowed.any():
            active_groups = len(np.unique(series_group[scan_allowed]))
        else:
            active_groups = 1
        spec, krec = self._route_kernel(
            plan, spec, n_rows=entry.n_valid,
            est_distinct=max(active_groups, 1) * n_buckets,
        )
        # Resolve "auto"/pin to the CONCRETE arm on host: the launch
        # below takes it as an argument.
        import dataclasses

        from ..ops.scan_agg import resolve_segment_impl

        spec = dataclasses.replace(
            spec,
            segment_impl=resolve_segment_impl(
                spec.n_groups * spec.n_buckets, spec.segment_impl,
                spec.n_agg_fields, spec.need_minmax,
            ),
        )

        gos = np.append(series_group, 0).astype(np.int32)  # pad series -> masked
        allow = np.append(allowed, False)  # delta fold: NO value pruning
        allow_scan = (
            allow
            if scan_allowed is allowed
            else np.append(scan_allowed, False)
        )
        if scan_allowed is not allowed:
            # value-stat prunes only — not series tag filters excluded
            m["series_pruned"] = int(allowed.sum() - scan_allowed.sum())
        # Compressed-layout routing: per-field static layout
        # descriptors. Aggregated fields fully decode on device; a field
        # only FILTERS touch stays in the bit-packed code domain — its
        # literals pre-translate against the sorted dictionary here, so
        # the kernel compares codes and never materializes the column.
        agg_set = set(agg_cols)
        value_layouts = tuple(
            entry.value_layout(c, full_decode=(c in agg_set))
            for c in value_names
        )
        literals = [
            _translate_code_literal(
                entry.value_cols_dev[col].dict_host, op, lit
            )
            if (lay := value_layouts[value_names.index(col)])[0] == "dict"
            and not lay[2]
            else lit
            for col, op, lit in device_filters
        ]
        lo_rel = lo - entry.min_ts
        hi_rel = hi - entry.min_ts
        t0_rel = max(t0 - entry.min_ts, -(2**31) + 1) if not empty_range else 0
        width_i = width if width else 1
        kernel_key = (
            spec.n_groups, spec.n_buckets, spec.n_agg_fields,
            spec.numeric_filters, spec.need_minmax, spec.segment_impl,
            value_layouts, entry.ts_layout, entry.series_layout,
        )
        row_idx = None
        if not empty_range:
            row_idx = self._selective_row_idx(entry, scan_allowed, lo, hi)
            if row_idx is not None:
                m["cache_rows"] = int((row_idx != entry.n_valid).sum())
        return CachedAggPrep(
            plan=plan, m=m, entry=entry, spec=spec, krec=krec,
            value_names=value_names, literals=literals,
            device_filters=device_filters,
            gos=gos, allow=allow, allow_scan=allow_scan, row_idx=row_idx,
            lo=lo, hi=hi, t0=t0, width=width, n_buckets=n_buckets,
            empty_range=empty_range,
            lo_rel=lo_rel, hi_rel=hi_rel, t0_rel=t0_rel, width_i=width_i,
            kernel_key=kernel_key,
            tag_keys=tag_keys, key_values=key_values, agg_cols=agg_cols,
            num_groups=num_groups, delta=delta,
            value_layouts=value_layouts,
        )

    def dispatch_cached_agg(self, prep: "CachedAggPrep") -> ResultSet:
        """The "spec -> dispatch" half for ONE prepared query: the packed
        kernel launch (one content-cached session upload, one dyn upload,
        one launch, one packed fetch), delta fold, result assembly."""
        from ..utils.deadline import checkpoint as _deadline_checkpoint

        # last cheap exit before committing to the device dispatch
        _deadline_checkpoint("dispatch")
        import time as _time

        from ..obs.device import timed_dispatch
        from ..ops.scan_agg import (
            cached_scan_agg_packed,
            encode_filter_ops,
            pack_dyn,
            unpack_packed_state,
        )
        from .scan_cache import _to_device

        plan, m, entry, spec = prep.plan, prep.m, prep.entry, prep.spec
        row_idx = prep.row_idx
        values_dev = entry.values_for(prep.value_names)
        t_kernel = _time.perf_counter()
        session_dev = entry.session_for(prep.gos, prep.allow_scan)
        dyn = pack_dyn(
            prep.literals, prep.lo_rel, prep.hi_rel, prep.t0_rel, prep.width_i,
            row_idx,
        )
        dyn_dev = _to_device(dyn, self.device)
        packed = timed_dispatch(
            "cached_packed",
            lambda: cached_scan_agg_packed(
                entry.series_parts,
                entry.ts_parts,
                values_dev,
                session_dev,
                dyn_dev,
                n_groups=spec.n_groups,
                n_buckets=spec.n_buckets,
                n_agg_fields=spec.n_agg_fields,
                numeric_filters=encode_filter_ops(spec.numeric_filters),
                need_minmax=spec.need_minmax,
                segment_impl=spec.segment_impl,
                selective=row_idx is not None,
                value_layouts=prep.value_layouts,
                ts_layout=entry.ts_layout,
                series_layout=entry.series_layout,
            ),
            self.device,
        )
        state = unpack_packed_state(packed, spec)
        querystats.note_kernel_dispatch(
            ("cached-packed", row_idx is not None, *prep.kernel_key),
            _time.perf_counter() - t_kernel,
            kind="cached_packed",
        )
        self._finish_kernel(
            prep.krec, spec, m, state, _time.perf_counter() - t_kernel
        )
        if len(prep.delta) and not prep.empty_range:
            self._fold_delta(
                state, prep.delta, entry, plan.schema, prep.gos, prep.allow,
                prep.agg_cols, prep.value_names, prep.device_filters,
                prep.lo, prep.hi, prep.t0, prep.width, prep.n_buckets,
            )
        return self._assemble_agg_result(
            plan, prep.tag_keys, prep.key_values, prep.agg_cols, state,
            max(prep.num_groups, 1), prep.n_buckets, prep.t0, prep.width,
        )

    def execute_cohort(self, plans: list, table) -> list:
        """Execute a cohort of shape-identical plans against one table
        (wlm/batch hands cohorts here via the interpreter). Each member is
        served by ``execute`` — one kernel launch per query until the
        batched cohort kernel is ported. Returns one ResultSet-or-exception
        per plan, positionally; error isolation is per member."""
        outcomes: list = []
        for plan in plans:
            try:
                outcomes.append(self.execute(plan, table))
            except BaseException as e:
                outcomes.append(e)
        return outcomes

    def _selective_row_idx(
        self, entry, allowed: np.ndarray, lo: int, hi: int
    ) -> Optional[np.ndarray]:
        """Gather indices for a selective query, or None for a full scan.

        Worth it when tag filters keep few series AND those series' rows
        (narrowed by time inside each sorted series range) are a small
        fraction of the table — then shipping an M-row index beats making
        the kernel chew N rows (ref analog: pruning to relevant SSTs).
        """
        offsets = entry.series_offsets
        if offsets is None or entry.built_seqs is None:
            return None
        sel = np.nonzero(allowed)[0]
        S = entry.n_series
        # All (or most) series selected: the full-scan kernel wins.
        if len(sel) == 0 or len(sel) > 256 or len(sel) * 4 > S:
            return None
        # int32 relative timestamps survive the host-rows drop; clamp the
        # bounds into their domain before searching.
        ts_rel = entry.ts_rel_host  # sorted within each series range
        lo_rel = int(np.clip(lo - entry.min_ts, -(2**31) + 1, 2**31 - 1))
        hi_rel = int(np.clip(hi - entry.min_ts, -(2**31) + 1, 2**31 - 1))
        parts = []
        total = 0
        for s in sel:
            s0, s1 = int(offsets[s]), int(offsets[s + 1])
            a = s0 + int(np.searchsorted(ts_rel[s0:s1], lo_rel, "left"))
            b = s0 + int(np.searchsorted(ts_rel[s0:s1], hi_rel, "left"))
            if b > a:
                parts.append(np.arange(a, b, dtype=np.int32))
                total += b - a
        if total == 0 or total * 4 > entry.n_valid:
            return None  # selected rows not sparse enough to pay gather
        from ..ops.encoding import pad_to_bucket

        idx = np.concatenate(parts) if len(parts) > 1 else parts[0]
        # pad slots point at the explicit pad row (code n_series, masked)
        return pad_to_bucket(idx, total, fill=np.int32(entry.n_valid))

    def _delta_soundness(self, table, entry, delta, agg_cols) -> bool:
        """May ``delta`` be ADDED on top of the cached base aggregate?

        Sound when: no NULL agg inputs, every delta series already exists
        in the base (group mapping is per-series), and — for OVERWRITE
        tables — no delta row can overwrite a base row (strictly newer
        timestamps) nor another delta row (unique keys within the delta).
        """
        from ..engine.options import UpdateMode

        for c in agg_cols:
            if not delta.valid_mask(c).all():
                return False
        d_ts_all = delta.timestamps
        if (
            max(entry.max_ts, int(d_ts_all.max()))
            - min(entry.min_ts, int(d_ts_all.min()))
            >= 2**31 - 1
        ):
            return False  # delta pushes the span past int32-relative math
        schema = delta.schema
        tsid_name = schema.columns[schema.tsid_index].name
        d_tsid = delta.columns[tsid_name]
        n_series = len(entry.series_tsids)
        sidx = np.searchsorted(entry.series_tsids, d_tsid)
        known = sidx < n_series
        safe_idx = np.clip(sidx, 0, n_series - 1)
        known &= entry.series_tsids[safe_idx] == d_tsid
        if not known.all():
            return False  # brand-new series: base group mapping can't place it
        if table.options.update_mode is not UpdateMode.APPEND:
            d_ts = delta.timestamps
            if int(d_ts.min()) <= entry.max_ts:
                return False  # could overwrite a base row
            pairs = np.stack([d_tsid.astype(np.int64), d_ts.astype(np.int64)])
            if np.unique(pairs, axis=1).shape[1] != len(delta):
                return False  # delta overwrites within itself
        return True

    def _fold_delta(
        self, state, delta, entry, schema, gos, allow,
        agg_cols, value_names, device_filters,
        lo, hi, t0, width, n_buckets,
    ) -> None:
        """Accumulate unflushed rows into the kernel's host-side partials.

        The delta is small (one memtable's worth at most), so vectorized
        numpy accumulation costs microseconds while the many-million-row
        base stays in HBM untouched."""
        tsid_name = schema.columns[schema.tsid_index].name
        sidx = np.searchsorted(entry.series_tsids, delta.columns[tsid_name])
        d_ts = delta.timestamps
        mask = allow[sidx] & (d_ts >= lo) & (d_ts < hi)
        for col, op, lit in device_filters:
            v = as_values(delta.column(col)).astype(np.float64)
            mask &= NUMPY_CMP[op](v, lit) & delta.valid_mask(col)
        if not mask.any():
            return
        idx = np.nonzero(mask)[0]
        g = gos[sidx[idx]].astype(np.int64)
        if width is not None:
            b = np.clip((d_ts[idx] - t0) // width, 0, n_buckets - 1).astype(np.int64)
        else:
            b = np.zeros(len(idx), dtype=np.int64)
        np.add.at(state.counts, (g, b), 1)
        for fi, col in enumerate(agg_cols):
            v = as_values(delta.column(col))[idx].astype(np.float64)
            np.add.at(state.sums[fi], (g, b), v)
            np.minimum.at(state.mins[fi], (g, b), v)
            np.maximum.at(state.maxs[fi], (g, b), v)

    def _execute_agg_host(self, plan: QueryPlan, rows: RowGroup) -> ResultSet:
        from ..utils.deadline import checkpoint as _deadline_checkpoint

        _deadline_checkpoint("executing")
        residual = self._residual_where(plan)
        if residual is not None and len(rows):
            v, m = eval_expr(residual, rows)
            rows = rows.filter(v.astype(bool) & m)

        # Group keys as value arrays. NULL keys form their own group
        # (standard SQL) — validity joins the grouping code so NULL never
        # collapses into the column's fill value.
        key_arrays: list = []
        key_valids: list = []  # None when every row is valid
        key_names: list[str] = []
        for k in plan.group_keys:
            if k.column is not None:
                key_arrays.append(rows.column(k.column))
                vm = rows.valid_mask(k.column)
                key_valids.append(None if vm.all() else vm)
            else:
                key_arrays.append((rows.timestamps // k.time_bucket_ms) * k.time_bucket_ms)
                key_valids.append(None)
            key_names.append(k.output_name)

        n = len(rows)
        if key_arrays:
            combined = np.zeros(n, dtype=np.int64)
            for arr, vm in zip(key_arrays, key_valids):
                u, inv = unique_inverse(arr)
                if vm is not None:
                    inv = np.where(vm, inv + 1, 0)  # code 0 = the NULL group
                    combined = combined * (len(u) + 2) + inv
                else:
                    combined = combined * (len(u) + 1) + inv
            uniq_comb, first_idx, codes = np.unique(
                combined, return_index=True, return_inverse=True
            )
            group_count = len(uniq_comb)
        else:
            if n == 0:
                return _order_and_limit(_empty_ungrouped_agg_row(plan), plan)
            codes = np.zeros(n, dtype=np.int64)
            first_idx = np.zeros(1, dtype=np.int64)
            group_count = 1

        names: list[str] = []
        columns: list[np.ndarray] = []
        nulls: dict[str, np.ndarray] = {}
        agg_expr_map = dict(plan.agg_exprs)
        computed = None
        base: dict = {}
        if agg_expr_map:
            for ki, gk in enumerate(plan.group_keys):
                if gk.column is None:
                    continue
                vm = key_valids[ki]
                base[gk.column] = (
                    as_values(key_arrays[ki][first_idx]),
                    None if vm is None else ~vm[first_idx],
                )
            for a in plan.aggs:
                base[a.output_name] = _host_agg(a, rows, codes, group_count)
            computed = eval_agg_exprs(plan, base)
        for item in plan.select.items:
            out_name = item.output_name
            e = item.expr
            if out_name in agg_expr_map:
                v, nm = computed[out_name]
                columns.append(v)
                if nm is not None:
                    nulls[out_name] = nm
                names.append(out_name)
            elif isinstance(e, ast.Column) or (
                isinstance(e, ast.FuncCall) and e.name in ("time_bucket", "date_trunc")
            ):
                # Resolve by the EXPRESSION, not the select item's output
                # name: an aliased key (SELECT host AS h ... GROUP BY
                # host) has output_name 'h' while the GroupKey carries
                # the column name.
                if isinstance(e, ast.Column):
                    ki = next(
                        (
                            i
                            for i, gk in enumerate(plan.group_keys)
                            if gk.column == e.name
                        ),
                        None,
                    )
                    if ki is None:
                        ki = key_names.index(out_name)
                else:
                    ki = key_names.index(str(e))
                columns.append(as_values(key_arrays[ki][first_idx]))
                vmk = key_valids[ki]
                if vmk is not None and not vmk[first_idx].all():
                    nulls[out_name] = ~vmk[first_idx]
                names.append(out_name)
            else:
                agg_i = [a.output_name for a in plan.aggs].index(out_name)
                a = plan.aggs[agg_i]
                # The agg_exprs base already paid for every aggregate —
                # don't run _host_agg (O(rows)) a second time.
                col, null = (
                    base[out_name]
                    if out_name in base
                    else _host_agg(a, rows, codes, group_count)
                )
                columns.append(col)
                if null is not None:
                    nulls[out_name] = null
                names.append(out_name)
        result = ResultSet(names, columns, nulls or None)
        return _order_and_limit(result, plan)

    def _execute_projection(
        self, plan: QueryPlan, rows: RowGroup, m: dict | None = None
    ) -> ResultSet:
        from ..utils.deadline import checkpoint as _deadline_checkpoint

        _deadline_checkpoint("executing")
        residual = self._residual_where(plan)
        if residual is not None and len(rows):
            v, vm = eval_expr(residual, rows)
            rows = rows.filter(v.astype(bool) & vm)

        # Sort BEFORE projecting: ORDER BY may reference any table column
        # or expression, not just select-list outputs. Select aliases are
        # resolved back to their expressions first.
        stmt = plan.select
        if stmt.order_by and len(rows):
            aliases = {
                item.alias: item.expr for item in stmt.items if item.alias
            }
            keys = []
            for o in reversed(stmt.order_by):
                expr = o.expr
                if isinstance(expr, ast.Column) and expr.name in aliases and not rows.schema.has_column(expr.name):
                    expr = aliases[expr.name]
                kv, km = eval_expr(expr, rows)
                if isinstance(kv, DictColumn):
                    kv = kv.sort_ranks()
                keys.append(kv if o.ascending else _desc_key(kv))
                keys.append(_null_rank(km, o))
            # Rows already in the requested order skip the sort entirely:
            # storage hands over presorted rows for the common dashboard
            # shapes (ORDER BY ts within one series; ORDER BY matching
            # the (series, ts) stored order; the raw device path's
            # resident-order selections) and a stable sort of a sorted
            # sequence is the identity — one O(n·k) adjacent-compare
            # pass replaces the O(n log n) lexsort.
            if _lex_presorted(keys):
                if m is not None:
                    m["sort_skipped"] = True
            else:
                rows = rows.take(np.lexsort(tuple(keys)))
        from .planner import _walk

        has_window = any(
            isinstance(e, ast.WindowFunc)
            for item in stmt.items
            for e in _walk(item.expr)
        )
        if (stmt.limit is not None or stmt.offset) and not stmt.distinct and not has_window:
            # DISTINCT must dedupe BEFORE the limit applies; window frames
            # must see the complete (sorted) row set before truncation
            stop = (stmt.offset + stmt.limit) if stmt.limit is not None else len(rows)
            rows = rows.slice(stmt.offset, stop)

        names: list[str] = []
        columns: list[np.ndarray] = []
        nulls: dict[str, np.ndarray] = {}
        for item in plan.select.items:
            if isinstance(item.expr, ast.Star):
                for c in rows.schema.columns:
                    if c.name.startswith("__hidden_"):
                        continue  # cte-internal synthesized columns
                    names.append(c.name)
                    columns.append(as_values(rows.column(c.name)))
                    vm = rows.valid_mask(c.name)
                    if not vm.all():
                        nulls[c.name] = ~vm
                continue
            v, vm = eval_expr(item.expr, rows)
            names.append(item.output_name)
            columns.append(as_values(v))
            if not vm.all():
                nulls[item.output_name] = ~vm
        result = ResultSet(names, columns, nulls or None)
        if stmt.distinct:
            result = _distinct_result(result)
        if (stmt.distinct or has_window) and (stmt.limit is not None or stmt.offset):
            result = _slice_result(result, stmt.offset, stmt.limit)
        return result


def route_segment_kernel(shape_key, spec, n_rows: int, est_distinct,
                         sql: str = "", device=None):
    """Module-level core of the learned segment-impl choice — shared by
    the executor's direct/cached/dist paths AND the partial-agg
    push-down (query/partial.py runs on partition owners with no
    Executor instance in scope). Returns (spec, token); token is None
    when routing doesn't apply (n_seg == 1, pinned HORAEDB_SEGMENT_IMPL,
    or router disabled)."""
    from ..ops.scan_agg import pinned_segment_impl
    from .path_router import (
        KERNEL_ROUTER,
        bootstrap_observed_segments,
        candidate_kernels,
        kernel_routing_enabled,
        seed_kernel,
    )

    n_seg = spec.n_groups * spec.n_buckets
    if n_seg <= 1 or pinned_segment_impl() or not kernel_routing_enabled():
        return spec, None
    key = (shape_key, n_seg.bit_length())
    obs = KERNEL_ROUTER.observed_segments(key)
    if obs is None and sql:
        # never-seen key: the query_stats ring may remember how many
        # live segments this SQL shape produced before (agg_segments)
        obs = bootstrap_observed_segments(sql)
        if obs is not None:
            KERNEL_ROUTER.note_segments(key, obs)
    est = obs if obs is not None else est_distinct
    if est is not None:
        est = max(1, min(int(est), n_seg, max(int(n_rows), 1)))
    import dataclasses

    candidates = candidate_kernels(n_seg, spec.n_agg_fields, spec.need_minmax)
    impl = KERNEL_ROUTER.choose(key, seed_kernel(device), candidates)
    spec = dataclasses.replace(spec, segment_impl=impl)
    # Decision plane: journal the pick with the EWMA's own prediction of
    # what this impl costs for this shape (None until the impl has a
    # clean sample — those picks resolve ungraded). The id rides the
    # router token to finish_segment_kernel, where the same amortized
    # dispatch seconds that feed the EWMA also grade the prediction.
    from ..obs.decisions import record_decision

    predicted = KERNEL_ROUTER.stats(key).get("t", {}).get(impl)
    dec_id = record_decision(
        "kernel_router",
        key=f"{shape_key[0] if shape_key else ''}#b{n_seg.bit_length()}",
        choice=impl,
        features={
            "n_seg": n_seg,
            "est_segments": est,
            "candidates": list(candidates),
        },
        predicted=predicted,
    )
    return spec, (key, impl, dec_id)


def finish_segment_kernel(krec, spec, m: dict, state,
                          seconds: float, n_valid=None) -> None:
    """Close one aggregation dispatch: feed the router's EWMA and
    observed-cardinality loop, stamp the metric tree, the ledger
    ``kernel`` field, and the horaedb_agg_kernel_total family."""
    from ..ops.scan_agg import resolve_segment_impl
    from .path_router import KERNEL_ROUTER

    n_seg = spec.n_groups * spec.n_buckets
    impl = resolve_segment_impl(
        n_seg, spec.segment_impl, spec.n_agg_fields, spec.need_minmax
    )
    live = int((state.counts > 0).sum())
    if krec is not None:
        from ..obs.decisions import resolve_decision

        key, routed, dec_id = krec
        if live > 0:
            # Degenerate dispatches (empty time range, filter matching
            # nothing) are excluded from BOTH feedback loops: their
            # near-zero latency would make whichever impl served them
            # look unbeatable under the min-biased estimator, and a
            # live count of 0 would skew the cardinality estimate.
            KERNEL_ROUTER.record(key, routed, seconds)
            KERNEL_ROUTER.note_segments(key, live)
            resolve_decision(
                dec_id, actual=seconds, outcome="served",
                loop="kernel_router",
            )
        else:
            # degenerate: the decision closes (no leaked pending entry)
            # but must not grade the EWMA's prediction
            resolve_decision(
                dec_id, actual=seconds, outcome="degenerate",
                loop="kernel_router", calibrate=False,
            )
    m["kernel"] = impl
    querystats.note_agg_kernel(impl, segments=live)


def _series_could_match(
    mins: np.ndarray, maxs: np.ndarray, op: str, lit: float
) -> Optional[np.ndarray]:
    """Per-series bool: could ANY value in [min, max] satisfy ``op lit``?
    Conservative (False only when provably no row passes); None for
    operators without a sound interval rule."""
    if op == ">":
        return maxs > lit
    if op == ">=":
        return maxs >= lit
    if op == "<":
        return mins < lit
    if op == "<=":
        return mins <= lit
    if op in ("=", "=="):
        return (mins <= lit) & (maxs >= lit)
    # No != rule: stats ignore NaN samples (fmin/fmax), but the kernel's
    # IEEE compare counts NaN rows for `v != lit` — a min==max==lit series
    # holding a NaN would prune rows the unpruned paths return.
    return None


def _plan_needs_minmax(plan) -> bool:
    """False when no aggregate in the plan reads min/max — the device
    kernel then skips those reductions entirely."""
    return any(a.func in ("min", "max") for a in plan.aggs)


def _is_series_conjunct(conj: ast.Expr, tag_names: set) -> bool:
    """True when the conjunct only references tag columns — its value is
    constant per series, so it can evaluate on the (small) series set."""
    cols = _columns_of(conj)
    return bool(cols) and all(c.name in tag_names for c in cols)


def _empty_ungrouped_agg_row(plan: QueryPlan) -> ResultSet:
    agg_expr_map = dict(plan.agg_exprs)
    computed = None
    if agg_expr_map:
        # SQL zero-row defaults per aggregate (count 0, others NULL),
        # then the expression evaluates over that one row.
        base = {
            a.output_name: (
                (np.array([0], dtype=np.int64), None)
                if a.func == "count"
                else (np.array([np.nan]), np.array([True]))
            )
            for a in plan.aggs
        }
        computed = eval_agg_exprs(plan, base)
    names, columns, nulls = [], [], {}
    for item in plan.select.items:
        out_name = item.output_name
        names.append(out_name)
        if out_name in agg_expr_map:
            v, nm = computed[out_name]
            columns.append(v)
            if nm is not None:
                nulls[out_name] = nm
            continue
        agg = next((a for a in plan.aggs if a.output_name == out_name), None)
        if agg is not None and agg.func == "count":
            columns.append(np.array([0], dtype=np.int64))
        else:
            columns.append(np.array([np.nan]))
            nulls[out_name] = np.array([True])
    return ResultSet(names, columns, nulls or None)


def _agg_output(
    a: AggCall,
    agg_cols: list[str],
    counts: np.ndarray,
    sums: np.ndarray,
    mins: np.ndarray,
    maxs: np.ndarray,
    g_idx: np.ndarray,
    b_idx: np.ndarray,
) -> np.ndarray:
    if a.func == "count":
        return counts[g_idx, b_idx].astype(np.int64)
    fi = agg_cols.index(a.column)
    if a.func == "sum":
        return sums[fi, g_idx, b_idx]
    if a.func == "min":
        return mins[fi, g_idx, b_idx]
    if a.func == "max":
        return maxs[fi, g_idx, b_idx]
    if a.func == "avg":
        with np.errstate(divide="ignore", invalid="ignore"):
            return sums[fi, g_idx, b_idx] / counts[g_idx, b_idx]
    raise ExprError(f"unknown aggregate {a.func}")


def _host_agg(
    a: AggCall, rows: RowGroup, codes: np.ndarray, group_count: int
) -> tuple[np.ndarray, Optional[np.ndarray]]:
    # agg(col) FILTER (WHERE cond): rows failing the per-aggregate filter
    # are invisible to THIS aggregate only (SQL NULL semantics: a NULL
    # condition fails the filter).
    fmask = None
    if a.filter_where is not None:
        fv, fm = eval_expr(a.filter_where, rows)
        fmask = fm & as_values(fv).astype(bool)
    if a.func == "count" and a.column is None:
        counted = codes if fmask is None else codes[fmask]
        return np.bincount(counted, minlength=group_count).astype(np.int64), None
    if a.func not in ("count", "sum", "min", "max", "avg"):
        from .functions import REGISTRY

        if a.distinct:
            # Silent DISTINCT-dropping would be a wrong answer, not a
            # missing feature.
            raise ExprError(f"DISTINCT is not supported with {a.func}")
        binary_fn = REGISTRY.binary_aggregate(a.func)
        if binary_fn is not None:
            v1, v2 = rows.valid_mask(a.column), rows.valid_mask(a.column2)
            if fmask is not None:
                v1, v2 = v1 & fmask, v2 & fmask
            return binary_fn(
                as_values(rows.column(a.column)), v1,
                as_values(rows.column(a.column2)), v2,
                codes, group_count,
            )
        agg_fn = REGISTRY.aggregate(a.func)
        if agg_fn is None:
            raise ExprError(f"unknown aggregate {a.func}")
        v1 = rows.valid_mask(a.column)
        if fmask is not None:
            v1 = v1 & fmask
        return agg_fn(
            rows.column(a.column), v1, codes, group_count, *a.params,
        )
    col = as_values(rows.column(a.column))
    valid = rows.valid_mask(a.column)
    if fmask is not None:
        valid = valid & fmask
    if a.distinct:
        if a.func != "count":
            raise ExprError("DISTINCT only supported with count")
        out = np.zeros(group_count, dtype=np.int64)
        for g in range(group_count):
            out[g] = len(np.unique(col[(codes == g) & valid]))
        return out, None
    vals = col.astype(np.float64) if col.dtype != object else col
    out = np.zeros(group_count, dtype=np.float64)
    nullmask = np.zeros(group_count, dtype=bool)
    cnt = np.bincount(codes, weights=valid.astype(np.float64), minlength=group_count)
    if a.func == "count":
        return cnt.astype(np.int64), None
    if a.func == "sum":
        out = np.bincount(codes, weights=np.where(valid, vals, 0.0), minlength=group_count)
        nullmask = cnt == 0
        return out, nullmask if nullmask.any() else None
    if a.func in ("min", "max"):
        nullmask = cnt == 0
        if vals.dtype == object:
            # Strings: per-group python reduction (group count is small).
            out_obj = np.empty(group_count, dtype=object)
            for g in range(group_count):
                gv = vals[(codes == g) & valid]
                out_obj[g] = (min(gv) if a.func == "min" else max(gv)) if len(gv) else None
            return out_obj, nullmask if nullmask.any() else None
        fill = np.inf if a.func == "min" else -np.inf
        masked = np.where(valid, vals, fill)
        out = np.full(group_count, fill)
        np.minimum.at(out, codes, masked) if a.func == "min" else np.maximum.at(
            out, codes, masked
        )
        return out, nullmask if nullmask.any() else None
    if a.func == "avg":
        s = np.bincount(codes, weights=np.where(valid, vals, 0.0), minlength=group_count)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = s / cnt
        nullmask = cnt == 0
        return out, nullmask if nullmask.any() else None
    raise ExprError(f"unknown aggregate {a.func}")


def _lex_presorted(keys: list) -> bool:
    """True when rows are ALREADY in ``np.lexsort(keys)`` order, i.e.
    the stable sort would be the identity permutation. One vectorized
    adjacent-compare pass per key — O(n·k) against the sort's
    O(n log n). Conservative: incomparable keys (mixed-type object
    columns) and NaN pairs report unsorted and fall through to lexsort.
    """
    n = len(keys[0])
    if n <= 1:
        return True
    strict = np.zeros(n - 1, dtype=bool)
    eq = np.ones(n - 1, dtype=bool)
    try:
        for key in reversed(keys):  # np.lexsort: the LAST key is primary
            key = np.asarray(key)
            a, b = key[:-1], key[1:]
            strict |= eq & (a < b)
            eq &= a == b
    except TypeError:
        return False
    return bool((strict | eq).all())


def _desc_key(arr: np.ndarray) -> np.ndarray:
    """A lexsort key sorting ``arr`` descending (strings via code negate)."""
    if arr.dtype == object:
        _, inv = np.unique(arr, return_inverse=True)
        return -inv
    if arr.dtype.kind in "fiu":
        return -arr.astype(np.float64)
    return arr  # bool/other: DESC not meaningfully supported


def eval_agg_exprs(
    plan: QueryPlan, base: dict[str, tuple[np.ndarray, Optional[np.ndarray]]]
) -> dict[str, tuple[np.ndarray, Optional[np.ndarray]]]:
    """Evaluate the plan's arithmetic-over-aggregate select items per
    group. ``base`` maps group-key column names and (hidden + named)
    aggregate output names to (values, nullmask|None); returns the same
    shape for each computed output."""
    names, cols, nulls = [], [], {}
    for name, (v, nm) in base.items():
        names.append(name)
        cols.append(np.asarray(v))
        if nm is not None:
            nulls[name] = nm
    shim = _ResultRows(ResultSet(names, cols, nulls or None))
    out = {}
    for name, expr in plan.agg_exprs:
        v, m = eval_expr(expr, shim)
        out[name] = (as_values(v), None if m.all() else ~m)
    return out


class _ResultRows:
    """Row-like shim so eval_expr can run over a ResultSet (HAVING)."""

    def __init__(self, result: ResultSet) -> None:
        self._r = result
        self._nulls = result.nulls or {}

    def __len__(self) -> int:
        return self._r.num_rows

    def column(self, name: str):
        return self._r.column(name)

    def valid_mask(self, name: str) -> np.ndarray:
        null = self._nulls.get(name)
        if null is None:
            return np.ones(self._r.num_rows, dtype=bool)
        return ~null


def _subst_having(e: ast.Expr, mapping: dict[str, str]) -> ast.Expr:
    """Rewrite select-list expressions in HAVING into result columns."""
    key = str(e)
    if key in mapping:
        return ast.Column(mapping[key])
    if isinstance(e, ast.Column) and e.name in mapping:
        return ast.Column(mapping[e.name])
    if isinstance(e, ast.BinaryOp):
        return ast.BinaryOp(
            e.op, _subst_having(e.left, mapping), _subst_having(e.right, mapping)
        )
    if isinstance(e, ast.UnaryOp):
        return ast.UnaryOp(e.op, _subst_having(e.operand, mapping))
    if isinstance(e, ast.FuncCall):
        raise ExprError(
            f"HAVING references {e} which is not in the SELECT list — "
            "add it (optionally aliased) to SELECT"
        )
    return e


def _apply_having(result: ResultSet, plan: QueryPlan) -> ResultSet:
    having = plan.select.having
    if having is None or result.num_rows == 0:
        return result
    mapping: dict[str, str] = {}
    for item in plan.select.items:
        mapping[str(item.expr)] = item.output_name
        if item.alias:
            mapping[item.alias] = item.output_name
    expr = _subst_having(having, mapping)
    shim = _ResultRows(result)
    v, m = eval_expr(expr, shim)
    mask = np.asarray(as_values(v)).astype(bool) & m
    if mask.all():
        return result
    idx = np.nonzero(mask)[0]
    return ResultSet(
        result.names,
        [c[idx] for c in result.columns],
        {k: n[idx] for k, n in (result.nulls or {}).items()} or None,
        result.metrics,
    )


def _distinct_result(result: ResultSet) -> ResultSet:
    """SELECT DISTINCT: drop duplicate output rows, keep first occurrence.

    NULLs participate as their own key bit — a NULL row must not collapse
    with a real row that happens to hold the null-fill value."""
    n = result.num_rows
    if n <= 1:
        return result
    nulls = result.nulls or {}
    combined = np.zeros(n, dtype=np.int64)
    for name, col in zip(result.names, result.columns):
        _, inv = unique_inverse(as_values(col))
        combined = combined * (int(inv.max()) + 2) + inv
        null = nulls.get(name)
        combined = combined * 2 + (null.astype(np.int64) if null is not None else 0)
    _, first = np.unique(combined, return_index=True)
    idx = np.sort(first)
    if len(idx) == n:
        return result
    return ResultSet(
        result.names,
        [c[idx] for c in result.columns],
        {k: m[idx] for k, m in (result.nulls or {}).items()} or None,
        result.metrics,
    )


def _order_and_limit(result: ResultSet, plan: QueryPlan) -> ResultSet:
    result = _apply_having(result, plan)
    stmt = plan.select
    if stmt.distinct:
        # Aggregate paths: DISTINCT over the grouped output rows, before
        # ORDER/LIMIT (group keys are unique, but aggregates may not be
        # selected alongside them).
        result = _distinct_result(result)
    if stmt.order_by and result.num_rows:
        keys = []
        for o in reversed(stmt.order_by):
            name = None
            if isinstance(o.expr, ast.Column):
                name = o.expr.name
            key_src = None
            resolved = None
            if name is not None and name in result.names:
                resolved = name
            elif str(o.expr) in result.names:
                resolved = str(o.expr)
            else:
                # order by an alias
                for item in stmt.items:
                    if item.alias and str(o.expr) == item.alias:
                        resolved = item.alias
                        break
            if resolved is None:
                raise ExprError(f"ORDER BY expression not in select list: {o.expr}")
            key_src = result.column(resolved)
            null_mask = (result.nulls or {}).get(resolved)
            valid = (
                np.ones(len(key_src), dtype=bool)
                if null_mask is None
                else ~null_mask
            )
            keys.append(key_src if o.ascending else _desc_key(key_src))
            keys.append(_null_rank(valid, o))
        order = np.lexsort(tuple(keys))
        result = ResultSet(
            result.names,
            [c[order] for c in result.columns],
            {k: v[order] for k, v in (result.nulls or {}).items()} or None,
        )
    if stmt.limit is not None or stmt.offset:
        result = _slice_result(result, stmt.offset, stmt.limit)
    return result


def _null_rank(valid: np.ndarray, o: ast.OrderItem) -> np.ndarray:
    """Sort key placing NULLs per NULLS FIRST/LAST (SQL default: LAST
    when ASC, FIRST when DESC). Appended AFTER the value key, so it is
    the more significant of the pair in np.lexsort."""
    nulls_last = o.nulls_last if o.nulls_last is not None else o.ascending
    nullness = (~valid).astype(np.int8)
    return nullness if nulls_last else -nullness


def _slice_result(result: ResultSet, offset: int, limit: Optional[int]) -> ResultSet:
    stop = (offset + limit) if limit is not None else result.num_rows
    return ResultSet(
        result.names,
        [c[offset:stop] for c in result.columns],
        {k: v[offset:stop] for k, v in (result.nulls or {}).items()} or None,
    )


def _columns_of(e: ast.Expr) -> list[ast.Column]:
    from .planner import _walk

    return [x for x in _walk(e) if isinstance(x, ast.Column)]
