"""Function registry — scalar + aggregate UDFs
(ref: src/df_operator/src/registry.rs:48-65 — FunctionRegistry loaded at
startup, setup.rs:203; built-ins time_bucket and thetasketch_distinct
under df_operator/src/udfs/).

Scalar functions evaluate vectorized on host rows (and the planner folds
``time_bucket`` into the device kernel's bucket stage — registration here
is the EXTENSIBILITY point, not the fast path). Aggregate functions plug
into the host aggregation fallback; the (count,sum,min,max,avg) core runs
fused on device and is not routed through the registry.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np


class FunctionError(ValueError):
    pass


class FunctionRegistry:
    """name -> implementation, for scalars and aggregates.

    Scalar signature:   fn(args, rows) -> (values, valid_mask)
        where ``args`` is a list of (values, valid_mask) pairs already
        evaluated, and ``rows`` the source RowGroup (for length/schema).
    Aggregate signature: fn(values, valid, codes, n_groups, *params)
        -> (per-group values, per-group null mask | None)
        where ``params`` are trailing LITERAL arguments from the call
        (e.g. the 0.9 of approx_percentile_cont(v, 0.9)).
    Binary aggregate signature (two-column aggregates — corr, covar):
        fn(v1, valid1, v2, valid2, codes, n_groups)
        -> (per-group values, per-group null mask | None)
    """

    def __init__(self) -> None:
        self._scalars: dict[str, Callable] = {}
        self._aggregates: dict[str, Callable] = {}
        self._binary_aggregates: dict[str, Callable] = {}
        self._numeric_only: set[str] = set()
        self._lock = threading.Lock()

    # ---- registration ---------------------------------------------------
    def register_scalar(self, name: str, fn: Callable, raw_args: bool = False) -> None:
        with self._lock:
            self._scalars[name.lower()] = (fn, raw_args)

    def register_aggregate(
        self, name: str, fn: Callable, numeric_only: bool = False
    ) -> None:
        with self._lock:
            self._aggregates[name.lower()] = fn
            if numeric_only:
                self._numeric_only.add(name.lower())

    def register_binary_aggregate(
        self, name: str, fn: Callable, numeric_only: bool = True
    ) -> None:
        with self._lock:
            self._binary_aggregates[name.lower()] = fn
            if numeric_only:
                self._numeric_only.add(name.lower())

    def numeric_only(self, name: str) -> bool:
        """True if the aggregate's column arguments must be numeric — the
        planner rejects string columns up front instead of letting numpy
        die mid-execution."""
        return name.lower() in self._numeric_only

    # ---- lookup ---------------------------------------------------------
    def scalar(self, name: str):
        return self._scalars.get(name.lower())

    def aggregate(self, name: str):
        return self._aggregates.get(name.lower())

    def binary_aggregate(self, name: str):
        return self._binary_aggregates.get(name.lower())

    def aggregate_names(self) -> set[str]:
        return set(self._aggregates) | set(self._binary_aggregates)


# ---- built-ins -----------------------------------------------------------


def _time_bucket(args, rows):
    """time_bucket(ts, '1h' | <ms>) — ALSO compiled into the device
    kernel's bucket stage when it appears as a group key; this host form
    covers projections and fallbacks."""
    from ..engine.options import parse_duration_ms
    from . import ast

    # raw_args: receives the unevaluated exprs for the literal width
    (ts_vals, ts_valid), width_expr = args
    if not isinstance(width_expr, ast.Literal):
        raise FunctionError("time_bucket width must be a literal duration")
    if isinstance(width_expr.value, str):
        width = parse_duration_ms(width_expr.value)
    else:
        width = int(width_expr.value)
    if width <= 0:
        raise FunctionError("time_bucket width must be positive")
    return (ts_vals // width) * width, ts_valid


def _date_trunc(args, rows):
    """date_trunc('minute', ts) — the fixed-width units, truncating to the
    bucket start in ms (the group-key form rides the device bucket stage).

    Registered raw_args: the convention evaluates args[0] and passes the
    rest as raw AST, so the evaluated unit arrives as a broadcast string
    array and the timestamp expression is evaluated here."""
    from . import ast
    from .executor import eval_expr

    (unit_vals, _), ts_expr = args
    if len(unit_vals) == 0:
        # Zero input rows: the unit broadcast is empty too — an empty
        # result, not a type error.
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=bool)
    unit = unit_vals[0]
    if not isinstance(unit, str):
        raise FunctionError("date_trunc unit must be a string literal")
    from .planner import _DATE_TRUNC_MS

    width = _DATE_TRUNC_MS.get(unit.lower())
    if width is None:
        raise FunctionError(f"unsupported date_trunc unit {unit!r}")
    if not isinstance(ts_expr, ast.Column):
        raise FunctionError("date_trunc expects a timestamp column")
    ts_vals, ts_valid = eval_expr(ts_expr, rows)
    return (ts_vals // width) * width, ts_valid


def _abs(args, rows):
    v, m = args[0]
    return np.abs(v), m


def _vals(pair):
    from ..common_types.dict_column import as_values

    v, m = pair
    return as_values(v), m


def _coalesce(args, rows):
    """First non-NULL argument per row."""
    n = len(rows)
    out = None
    valid = np.zeros(n, dtype=bool)
    for pair in args:
        v, m = _vals(pair)
        if out is None:
            out = np.zeros(n, dtype=v.dtype)
        if out.dtype != v.dtype:
            out = out.astype(object)
        take = ~valid & m
        out[take] = v[take]
        valid |= m
        if valid.all():
            break
    if out is None:
        out = np.zeros(n)
    return out, valid


def _make_str_fn(fn):
    def impl(args, rows):
        v, m = _vals(args[0])
        # Non-string VALID values cast implicitly (upper(1.5) -> '1.5',
        # the common engine behavior); invalid rows keep a placeholder
        # and stay masked.
        out = np.array(
            [fn(x if isinstance(x, str) else str(x)) if ok else ""
             for x, ok in zip(v, m)],
            dtype=object,
        )
        return out, m

    return impl


def _length(args, rows):
    v, m = _vals(args[0])
    out = np.fromiter(
        (len(x if isinstance(x, str) else str(x)) if ok else 0
         for x, ok in zip(v, m)),
        dtype=np.int64, count=len(v),
    )
    return out, m


def _concat(args, rows):
    """NULL arguments concatenate as empty and the result is never NULL
    (Postgres concat semantics: all-NULL args yield '')."""
    n = len(rows)
    parts = []
    for pair in args:
        v, m = _vals(pair)
        parts.append([str(x) if ok else "" for x, ok in zip(v, m)])
    out = np.array(["".join(p[i] for p in parts) for i in range(n)], dtype=object)
    return out, np.ones(n, dtype=bool)


def _make_math_fn(fn, domain=None):
    def impl(args, rows):
        v, m = _vals(args[0])
        vf = v.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = fn(vf)
        if domain is not None:
            m = m & domain(vf)
        return out, m

    return impl


def _round(args, rows):
    """round(v [, digits]) — registered raw_args, so ``digits`` arrives
    as raw AST and non-literal precision is rejected loudly instead of
    silently applying row 0's value to every row."""
    from . import ast

    (v, m), *rest = args
    from ..common_types.dict_column import as_values

    v = as_values(v)
    digits = 0
    if rest:
        d = rest[0]
        if not isinstance(d, ast.Literal) or not isinstance(d.value, int):
            raise FunctionError("round() digits must be an integer literal")
        digits = d.value
    return np.round(v.astype(np.float64), digits), m


def _power(args, rows):
    b, mb = _vals(args[0])
    e, me = _vals(args[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.power(b.astype(np.float64), e.astype(np.float64))
    return out, mb & me & np.isfinite(out)


def _now(args, rows):
    import time as _t

    n = len(rows)
    return np.full(n, int(_t.time() * 1000), dtype=np.int64), np.ones(n, dtype=bool)


def _thetasketch_distinct(values, valid, codes, n_groups):
    """Approximate-distinct analog (ref: udfs/thetasketch_distinct.rs).

    The reference uses a theta sketch to bound memory on huge
    cardinalities; columnar numpy counts distinct exactly in one
    sort-unique pass — same answer, no sketch error, acceptable memory at
    the scales a single node aggregates post-scan."""
    from ..common_types.dict_column import DictColumn, unique_inverse

    out = np.zeros(n_groups, dtype=np.int64)
    idx = np.nonzero(valid)[0]
    if len(idx):
        if isinstance(values, DictColumn):
            val_codes = values.codes[idx]
        else:
            _, val_codes = unique_inverse(np.asarray(values)[idx])
        pairs = np.unique(
            np.stack([codes[idx].astype(np.int64), val_codes.astype(np.int64)]),
            axis=1,
        )
        grp, cnt = np.unique(pairs[0], return_counts=True)
        out[grp] = cnt
    return out, None


# ---- statistical aggregates ----------------------------------------------
# (ref surface: the reference exposes DataFusion's built-in statistical
# aggregates through SQL — stddev/variance/median/approx_* families,
# datafusion/physical-expr aggregates; exact column shapes here since a
# single node aggregates post-scan.)


def _moments(values, valid, codes, n_groups):
    vals = np.asarray(values, dtype=np.float64)
    w = valid.astype(np.float64)
    n = np.bincount(codes, weights=w, minlength=n_groups)
    s1 = np.bincount(codes, weights=np.where(valid, vals, 0.0), minlength=n_groups)
    s2 = np.bincount(codes, weights=np.where(valid, vals * vals, 0.0), minlength=n_groups)
    return n, s1, s2


def _variance(values, valid, codes, n_groups, ddof: int):
    n, s1, s2 = _moments(values, valid, codes, n_groups)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = s1 / n
        # Centered form: E[x^2] - mean^2 scaled to the ddof denominator;
        # clip the tiny negatives f64 cancellation can produce.
        var = np.maximum(s2 / n - mean * mean, 0.0) * (n / (n - ddof))
    null = n <= ddof
    return np.where(null, np.nan, var), (null if null.any() else None)


def _make_variance(ddof: int, sqrt: bool):
    def agg(values, valid, codes, n_groups):
        var, null = _variance(values, valid, codes, n_groups, ddof)
        return (np.sqrt(var) if sqrt else var), null

    return agg


def _per_group_reduce(values, valid, codes, n_groups, fn):
    """``fn`` maps each group's non-empty f64 slice to a scalar. One
    argsort partitions the rows so total cost is O(n log n + n_groups),
    not O(n_groups * n) full-array masks per group."""
    vals = np.asarray(values, dtype=np.float64)
    out = np.full(n_groups, np.nan)
    null = np.ones(n_groups, dtype=bool)
    idx = np.nonzero(valid)[0]
    if len(idx):
        c = codes[idx]
        order = np.argsort(c, kind="stable")
        sv = vals[idx][order]
        sc = c[order]
        gids = np.arange(n_groups)
        starts = np.searchsorted(sc, gids)
        ends = np.searchsorted(sc, gids, side="right")
        for g in gids:
            if ends[g] > starts[g]:
                out[g] = fn(sv[starts[g]:ends[g]])
                null[g] = False
    return out, (null if null.any() else None)


def _median(values, valid, codes, n_groups):
    return _per_group_reduce(values, valid, codes, n_groups, np.median)


def _make_percentile():
    def agg(values, valid, codes, n_groups, q=0.5):
        q = float(q)
        if not 0.0 <= q <= 1.0:
            raise FunctionError("percentile must be in [0, 1]")
        return _per_group_reduce(
            values, valid, codes, n_groups, lambda gv: np.quantile(gv, q)
        )

    return agg


def _covar(v1, valid1, v2, valid2, codes, n_groups, ddof: int):
    both = valid1 & valid2
    x = np.asarray(v1, dtype=np.float64)
    y = np.asarray(v2, dtype=np.float64)
    w = both.astype(np.float64)
    n = np.bincount(codes, weights=w, minlength=n_groups)
    sx = np.bincount(codes, weights=np.where(both, x, 0.0), minlength=n_groups)
    sy = np.bincount(codes, weights=np.where(both, y, 0.0), minlength=n_groups)
    sxy = np.bincount(codes, weights=np.where(both, x * y, 0.0), minlength=n_groups)
    with np.errstate(divide="ignore", invalid="ignore"):
        cov = (sxy / n - (sx / n) * (sy / n)) * (n / (n - ddof))
    null = n <= ddof
    return np.where(null, np.nan, cov), null, (n, sx, sy, sxy, both, x, y)


def _make_covar(ddof: int):
    def agg(v1, valid1, v2, valid2, codes, n_groups):
        cov, null, _ = _covar(v1, valid1, v2, valid2, codes, n_groups, ddof)
        return cov, (null if null.any() else None)

    return agg


def _corr(v1, valid1, v2, valid2, codes, n_groups):
    cov, null, (n, sx, sy, sxy, both, x, y) = _covar(
        v1, valid1, v2, valid2, codes, n_groups, 0
    )
    sx2 = np.bincount(codes, weights=np.where(both, x * x, 0.0), minlength=n_groups)
    sy2 = np.bincount(codes, weights=np.where(both, y * y, 0.0), minlength=n_groups)
    with np.errstate(divide="ignore", invalid="ignore"):
        vx = np.maximum(sx2 / n - (sx / n) ** 2, 0.0)
        vy = np.maximum(sy2 / n - (sy / n) ** 2, 0.0)
        out = cov / np.sqrt(vx * vy)
    null = null | ~np.isfinite(out)
    return np.where(null, np.nan, out), (null if null.any() else None)


def default_registry() -> FunctionRegistry:
    reg = FunctionRegistry()
    reg.register_scalar("time_bucket", _time_bucket, raw_args=True)
    reg.register_scalar("date_trunc", _date_trunc, raw_args=True)
    reg.register_scalar("abs", _abs)
    reg.register_scalar("coalesce", _coalesce)
    reg.register_scalar("upper", _make_str_fn(str.upper))
    reg.register_scalar("lower", _make_str_fn(str.lower))
    reg.register_scalar("trim", _make_str_fn(str.strip))
    reg.register_scalar("length", _length)
    reg.register_scalar("char_length", _length)
    reg.register_scalar("concat", _concat)
    reg.register_scalar("round", _round, raw_args=True)
    reg.register_scalar("floor", _make_math_fn(np.floor))
    reg.register_scalar("ceil", _make_math_fn(np.ceil))
    reg.register_scalar("ceiling", _make_math_fn(np.ceil))
    reg.register_scalar("sqrt", _make_math_fn(np.sqrt, domain=lambda v: v >= 0))
    reg.register_scalar("exp", _make_math_fn(np.exp))
    reg.register_scalar("ln", _make_math_fn(np.log, domain=lambda v: v > 0))
    reg.register_scalar("log10", _make_math_fn(np.log10, domain=lambda v: v > 0))
    reg.register_scalar("log2", _make_math_fn(np.log2, domain=lambda v: v > 0))
    reg.register_scalar("power", _power)
    reg.register_scalar("pow", _power)
    reg.register_scalar("now", _now)
    reg.register_aggregate("thetasketch_distinct", _thetasketch_distinct)
    # approx_distinct: same exact-count analog (see _thetasketch_distinct
    # docstring for why exact is the right trade at post-scan scale).
    reg.register_aggregate("approx_distinct", _thetasketch_distinct)
    reg.register_aggregate("stddev", _make_variance(1, sqrt=True), numeric_only=True)
    reg.register_aggregate("stddev_samp", _make_variance(1, sqrt=True), numeric_only=True)
    reg.register_aggregate("stddev_pop", _make_variance(0, sqrt=True), numeric_only=True)
    reg.register_aggregate("variance", _make_variance(1, sqrt=False), numeric_only=True)
    reg.register_aggregate("var_samp", _make_variance(1, sqrt=False), numeric_only=True)
    reg.register_aggregate("var_pop", _make_variance(0, sqrt=False), numeric_only=True)
    reg.register_aggregate("median", _median, numeric_only=True)
    reg.register_aggregate("approx_median", _median, numeric_only=True)
    reg.register_aggregate("approx_percentile_cont", _make_percentile(), numeric_only=True)
    reg.register_binary_aggregate("corr", _corr)
    reg.register_binary_aggregate("covar", _make_covar(1))
    reg.register_binary_aggregate("covar_samp", _make_covar(1))
    reg.register_binary_aggregate("covar_pop", _make_covar(0))
    return reg


REGISTRY = default_registry()
