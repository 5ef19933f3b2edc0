"""PromQL subset: parse + translate to the SQL engine
(ref: query_frontend/src/promql/{convert,pushdown}.rs — the reference
translates PromQL into DataFusion plans; here PromQL translates into the
same Plan/executor pipeline SQL uses, so prom queries ride the fused
device kernels).

Supported grammar:

    expr     := cmpexpr
    cmpexpr  := addexpr (('>' | '<' | '>=' | '<=' | '==' | '!=') addexpr)*
    addexpr  := mulexpr (('+' | '-') mulexpr)*
    mulexpr  := unary (('*' | '/' | '%') unary)*
    unary    := number | '(' expr ')' | vector
    vector   := agg [mod] '(' [param ','] expr ')' [mod]
              | func '(' [phi ','] (selector | subquery) ')'
              | vfunc '(' ... )'            -- per-function signature
              | selector
              | subquery
    subquery := expr '[' duration ':' [duration] ']'
                ( 'offset' duration | '@' unix )*
                -- inner expr instant-evaluates at step-aligned times
                -- within (t-range, t]; must feed a range function
    mod      := ('by' | 'without') '(' labels ')'
    agg      := sum | avg | min | max | count | stddev | stdvar
              | topk | bottomk | quantile   -- the last three take a param
    func     := rate | increase | delta | irate | idelta
              | changes | resets
              | avg_over_time | min_over_time | max_over_time
              | sum_over_time | count_over_time
              | quantile_over_time | stddev_over_time | last_over_time
    vfunc    := histogram_quantile(phi, expr)
              | label_replace(expr, dst, repl, src, regex)
              | label_join(expr, dst, sep, src...)
              | abs | ceil | floor | round | clamp_min | clamp_max
    selector := metric [ '{' matcher (',' matcher)* '}' ]
                [ '[' duration ']' ] ( 'offset' duration | '@' unix )*
    matcher  := label ('=' | '!=' | '=~' | '!~') 'value'

Aggregations nest (max(sum by (h) (m)) works) and accept both prefix and
suffix by/without placement, like prom.

Binary expressions follow prom's arithmetic semantics: scalar/scalar,
vector/scalar (applied per sample), and vector/vector one-to-one
matching on identical label sets (samples without a partner drop out;
``__name__`` is dropped from arithmetic results, like prom).
Comparison operators (> < >= <= == !=) follow prom's FILTER semantics
over vectors — samples for which the comparison is false drop out, the
surviving samples keep their values (what alert rules are made of:
``rate(errors_total[1m]) > 5`` yields the offending series). A
scalar/scalar comparison yields 1.0/0.0 (the ``bool`` modifier is
implied — this subset has no unmodified scalar comparison error).

Semantics notes:
- the metric name maps to a table; its single DOUBLE field (or a column
  literally named ``value``) is the sample value, the timestamp key is
  the sample time — exactly the shape OpenTSDB/Influx ingestion creates;
- equality matchers push into the scan; regex matchers (fully anchored,
  like prom) post-filter the series set host-side;
- ``rate``/``increase`` fold consecutive raw samples with counter-reset
  correction (a drop restarts the counter near zero), each delta
  attributed to the later sample's step bucket;
- ``offset`` evaluates a window shifted into the past and stamps results
  back at the requested times;
- range queries evaluate per aligned ``step`` bucket; instant queries use
  a 5m lookback window.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

from ..engine.options import parse_duration_ms

AGG_FUNCS = {"sum", "avg", "min", "max", "count", "stddev", "stdvar"}
PARAM_AGGS = {"topk", "bottomk", "quantile"}  # aggregators with a scalar param
# Range-function families — ONE place; the parser's range requirement,
# the exact-window instant routing and the range dispatch all derive
# from these (hand-maintained parallel lists drifted once already).
_COUNTER_FUNCS = frozenset({"rate", "increase"})
# raw per-window folds: order statistics, gauge deltas, instant
# variants (last two samples), change/reset counts
_RAW_FOLD_FUNCS = frozenset({
    "quantile_over_time", "stddev_over_time", "last_over_time",
    "delta", "irate", "idelta", "changes", "resets",
})
# folds that push into the SQL kernel per step bucket
_SQL_FOLD_FUNCS = frozenset({
    "avg_over_time", "min_over_time", "max_over_time",
    "sum_over_time", "count_over_time",
})
RANGE_FUNCS = _COUNTER_FUNCS | _RAW_FOLD_FUNCS | _SQL_FOLD_FUNCS
# these three accept a missing [range] (they fold the default lookback)
_OPTIONAL_RANGE_FUNCS = frozenset(
    {"avg_over_time", "min_over_time", "max_over_time"}
)
# comparison/filter binary operators (prom semantics: false samples
# drop out of the vector; the alert evaluator's threshold surface)
COMPARE_OPS = frozenset({">", "<", ">=", "<=", "==", "!="})
# funcs over a full evaluated vector (ref surface: promql/udf.rs:50-97 +
# the IOx function table the reference inherits)
VECTOR_FUNCS = {
    "histogram_quantile", "label_replace", "label_join",
    "abs", "ceil", "floor", "round", "clamp_min", "clamp_max",
}


class PromQLError(ValueError):
    pass


@dataclass
class PromQuery:
    metric: str
    matchers: list[tuple[str, str, str]] = field(default_factory=list)  # (label, op, value)
    range_ms: Optional[int] = None
    func: Optional[str] = None  # RANGE_FUNCS
    offset_ms: int = 0  # `offset 1h` shifts the evaluated window back
    at_ms: Optional[int] = None  # `@ <unix>` pins the evaluation time
    param: Optional[float] = None  # quantile_over_time's φ


@dataclass
class PromScalar:
    """A number literal in an expression (e.g. the 100 in x * 100)."""

    value: float


@dataclass
class PromSubquery:
    """``expr[range:step]`` — the inner expression instant-evaluates at
    step-aligned times within (t-range, t]; the samples feed the
    enclosing range function (max_over_time(rate(x[1m])[5m:1m]))."""

    expr: "PromExpr"
    range_ms: int
    step_ms: Optional[int] = None  # None -> DEFAULT_SUBQUERY_STEP_MS
    func: Optional[str] = None  # the enclosing RANGE_FUNC
    param: Optional[float] = None
    offset_ms: int = 0
    at_ms: Optional[int] = None


@dataclass
class PromBin:
    """Arithmetic or comparison over sub-expressions: vector/scalar
    applies per sample, vector/vector matches one-to-one on identical
    label sets. COMPARE_OPS members filter (false samples drop out)."""

    op: str  # + - * / % or COMPARE_OPS
    lhs: "PromExpr"
    rhs: "PromExpr"


@dataclass
class PromAgg:
    """Cross-series aggregation over a full sub-expression: sum/avg/min/
    max/count/stddev/stdvar, parameterized quantile/topk/bottomk, with
    ``by`` (keep listed labels) or ``without`` (drop listed labels)."""

    op: str
    arg: "PromExpr"
    param: Optional[float] = None
    by_labels: Optional[list[str]] = None
    without_labels: Optional[list[str]] = None


@dataclass
class PromCall:
    """Vector-transform function: histogram_quantile, label_replace,
    label_join, and the per-sample math funcs (abs/ceil/floor/round/
    clamp_min/clamp_max)."""

    name: str
    arg: "PromExpr"
    params: tuple = ()  # scalars/strings, meaning depends on name


PromExpr = PromQuery | PromScalar | PromBin | PromAgg | PromCall | PromSubquery


_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:.]*"
_TOKENS = re.compile(
    rf"""\s*(?:
      (?P<name>{_NAME})
    | (?P<dur>\d+(?:ms|s|m|h|d))
    | (?P<number>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
    | (?P<string>'(?:[^'])*'|"(?:[^"])*")
    | (?P<op>!=|=~|!~|>=|<=|==|[<>={{}}()\[\],+\-*/%@])
    )""",
    re.VERBOSE,
)


def _tokenize(q: str):
    out, i = [], 0
    while i < len(q):
        m = _TOKENS.match(q, i)
        if not m:
            if q[i:].strip() == "":
                break
            raise PromQLError(f"unexpected character {q[i]!r} at {i}")
        if m.lastgroup:
            out.append((m.lastgroup, m.group().strip()))
        i = m.end()
    return out


class _Parser:
    def __init__(self, q: str) -> None:
        self.q = q
        self.toks = _tokenize(q)
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        if t[0] is None:
            raise PromQLError(f"unexpected end of query: {self.q!r}")
        self.i += 1
        return t

    def expect(self, text: str):
        kind, tok = self.next()
        if tok != text:
            raise PromQLError(f"expected {text!r}, found {tok!r} in {self.q!r}")

    def parse(self) -> PromExpr:
        pq = self.cmpexpr()
        if self.peek()[0] is not None:
            raise PromQLError(f"trailing input after query: {self.q!r}")
        return pq

    # precedence climbing: * / % bind tighter than + -, which bind
    # tighter than the comparison/filter operators (prom's ladder)
    def cmpexpr(self) -> PromExpr:
        node = self.addexpr()
        while self.peek()[0] == "op" and self.peek()[1] in COMPARE_OPS:
            op = self.next()[1]
            node = PromBin(op, node, self.addexpr())
        return node

    def addexpr(self) -> PromExpr:
        node = self.mulexpr()
        while self.peek() == ("op", "+") or self.peek() == ("op", "-"):
            op = self.next()[1]
            node = PromBin(op, node, self.mulexpr())
        return node

    def mulexpr(self) -> PromExpr:
        node = self.unary()
        while self.peek()[1] in ("*", "/", "%") and self.peek()[0] == "op":
            op = self.next()[1]
            node = PromBin(op, node, self.unary())
        return node

    def unary(self) -> PromExpr:
        kind, tok = self.peek()
        if kind == "number":
            self.next()
            return PromScalar(float(tok))
        if (kind, tok) == ("op", "-"):
            self.next()
            inner = self.unary()
            if isinstance(inner, PromScalar):
                return PromScalar(-inner.value)
            return PromBin("*", PromScalar(-1.0), inner)
        if (kind, tok) == ("op", "("):
            self.next()
            node = self.cmpexpr()
            self.expect(")")
            return self._maybe_subquery(node)
        return self._maybe_subquery(self.expr())

    def _maybe_subquery(self, node: PromExpr) -> PromExpr:
        """Trailing ``[range:step]`` turns any expression into a
        subquery (a bare metric's subquery is handled inside selector(),
        which owns its '[' — this covers functions and parens)."""
        while self.peek() == ("op", "[") and not (
            # a RAW range selector (cpu[5m]) takes no second range; a
            # range FUNCTION result (rate(cpu[5m])) does — that's the
            # subquery form
            isinstance(node, PromQuery)
            and node.range_ms is not None
            and node.func is None
        ):
            self.next()
            kind, dur = self.next()
            if kind != "dur":
                raise PromQLError(f"expected a duration, found {dur!r}")
            rng = parse_duration_ms(dur)
            step = self._subquery_step()
            self.expect("]")
            node = PromSubquery(node, rng, step)
            self._selector_modifiers(node)
        return node

    def _subquery_step(self) -> Optional[int]:
        """The ':step' tail of a subquery range. The tokenizer fuses
        ':1m' into one name token (prom metric names may contain colons);
        a spaced ': 1m' arrives as ':' then a duration."""
        k, t = self.peek()
        if k != "name" or not t.startswith(":"):
            raise PromQLError("expected ':' in subquery range [range:step]")
        self.next()
        if len(t) > 1:
            return parse_duration_ms(t[1:])
        if self.peek()[0] == "dur":
            return parse_duration_ms(self.next()[1])
        return None

    def _selector_modifiers(self, node) -> None:
        """offset/@ suffixes, shared by selectors and subqueries."""
        while True:
            if self.peek() == ("name", "offset"):
                self.next()
                kind, dur = self.next()
                if kind != "dur":
                    raise PromQLError(f"offset expects a duration, found {dur!r}")
                node.offset_ms = parse_duration_ms(dur)
                continue
            if self.peek() == ("op", "@"):
                self.next()
                kind, num = self.next()
                if kind != "number":
                    raise PromQLError(f"@ expects a unix timestamp, found {num!r}")
                node.at_ms = int(float(num) * 1000)
                continue
            break

    def _label_list(self) -> list[str]:
        self.expect("(")
        out = []
        if self.peek()[1] != ")":
            out.append(self._ident())
            while self.peek()[1] == ",":
                self.next()
                out.append(self._ident())
        self.expect(")")
        return out

    def _number(self) -> float:
        neg = False
        if self.peek() == ("op", "-"):
            self.next()
            neg = True
        kind, tok = self.next()
        if kind != "number":
            raise PromQLError(f"expected a number, found {tok!r}")
        return -float(tok) if neg else float(tok)

    def _string(self) -> str:
        kind, tok = self.next()
        if kind != "string":
            raise PromQLError(f"expected a quoted string, found {tok!r}")
        return tok[1:-1]

    def expr(self) -> PromExpr:
        kind, tok = self.peek()
        if kind == "name" and (tok in AGG_FUNCS or tok in PARAM_AGGS):
            self.next()
            by = without = None
            k2, t2 = self.peek()
            if (k2, t2) == ("name", "by"):
                self.next()
                by = self._label_list()
            elif (k2, t2) == ("name", "without"):
                self.next()
                without = self._label_list()
            self.expect("(")
            param = None
            if tok in PARAM_AGGS:
                param = self._number()
                self.expect(",")
            inner = self.cmpexpr()
            self.expect(")")
            # suffix form: sum(...) by (x) / without (x)
            if by is None and without is None:
                k2, t2 = self.peek()
                if (k2, t2) == ("name", "by"):
                    self.next()
                    by = self._label_list()
                elif (k2, t2) == ("name", "without"):
                    self.next()
                    without = self._label_list()
            if tok in ("topk", "bottomk") and (
                param is None or param != int(param) or param < 1
            ):
                raise PromQLError(f"{tok} expects a positive integer k")
            return PromAgg(
                tok, inner, param=param, by_labels=by, without_labels=without
            )
        if kind == "name" and tok in RANGE_FUNCS:
            self.next()
            self.expect("(")
            param = None
            if tok == "quantile_over_time":
                param = self._number()
                self.expect(",")
            inner = self.unary()
            self.expect(")")
            if not isinstance(inner, (PromQuery, PromSubquery)):
                raise PromQLError(
                    f"{tok}() expects a range selector or subquery argument"
                )
            if inner.func is not None:
                # rate(cpu[1m]) is already consumed by rate — silently
                # overwriting would drop the inner fold. The composable
                # form is a subquery: max_over_time(rate(cpu[1m])[5m:1m]).
                raise PromQLError(
                    f"{tok}() over {inner.func}(...) needs a subquery "
                    f"range, e.g. {tok}({inner.func}(...)[5m:1m])"
                )
            needs_range = tok not in _OPTIONAL_RANGE_FUNCS
            if needs_range and inner.range_ms is None:
                raise PromQLError(f"{tok}() requires a range selector like [5m]")
            inner.func = tok
            inner.param = param
            return inner
        if kind == "name" and tok in VECTOR_FUNCS:
            return self._vector_func(tok)
        return self.selector()

    def _vector_func(self, name: str) -> PromCall:
        self.next()
        self.expect("(")
        params: list = []
        if name == "histogram_quantile":
            params.append(self._number())
            self.expect(",")
            arg = self.cmpexpr()
        elif name == "label_replace":
            arg = self.cmpexpr()
            for _ in range(4):  # dst, replacement, src, regex
                self.expect(",")
                params.append(self._string())
            try:
                compiled = re.compile(params[3])
            except re.error as e:
                raise PromQLError(f"bad regex {params[3]!r}: {e}")
            # numeric $N refs must name a real capture group (parse-time
            # 400, not an evaluation-time 500)
            for m in _DOLLAR_REF.finditer(params[1]):
                ref = m.group(1).strip("{}")
                if ref.isdigit() and int(ref) > compiled.groups:
                    raise PromQLError(
                        f"label_replace replacement references group "
                        f"${ref} but the regex has {compiled.groups}"
                    )
        elif name == "label_join":
            arg = self.cmpexpr()
            self.expect(",")
            params.append(self._string())  # dst
            self.expect(",")
            params.append(self._string())  # separator
            while self.peek()[1] == ",":
                self.next()
                params.append(self._string())  # source labels
        elif name in ("clamp_min", "clamp_max"):
            arg = self.cmpexpr()
            self.expect(",")
            params.append(self._number())
        elif name == "round":
            arg = self.cmpexpr()
            if self.peek()[1] == ",":
                self.next()
                params.append(self._number())
        else:  # abs / ceil / floor
            arg = self.cmpexpr()
        self.expect(")")
        return PromCall(name, arg, tuple(params))

    def _ident(self) -> str:
        kind, tok = self.next()
        if kind != "name":
            raise PromQLError(f"expected identifier, found {tok!r}")
        return tok

    def selector(self) -> PromQuery:
        metric = self._ident()
        if metric in AGG_FUNCS or metric in RANGE_FUNCS:
            raise PromQLError(f"{metric!r} used as a metric name")
        pq = PromQuery(metric=metric)
        if self.peek()[1] == "{":
            self.next()
            while True:
                label = self._ident()
                kind, op = self.next()
                if op not in ("=", "!=", "=~", "!~"):
                    raise PromQLError(f"unsupported matcher op {op!r}")
                skind, sval = self.next()
                if skind != "string":
                    raise PromQLError(f"matcher value must be quoted: {sval!r}")
                value = sval[1:-1]
                if op in ("=~", "!~"):
                    try:
                        re.compile(value)
                    except re.error as e:
                        raise PromQLError(f"bad regex {value!r}: {e}")
                pq.matchers.append((label, op, value))
                kind, tok = self.next()
                if tok == "}":
                    break
                if tok != ",":
                    raise PromQLError(f"expected ',' or '}}', found {tok!r}")
        sub = None
        if self.peek()[1] == "[":
            self.next()
            kind, dur = self.next()
            if kind != "dur":
                raise PromQLError(f"expected a duration like 5m, found {dur!r}")
            rng = parse_duration_ms(dur)
            k2, t2 = self.peek()
            if k2 == "name" and t2.startswith(":"):
                # bare-metric subquery: cpu_usage[5m:1m]
                step = self._subquery_step()
                self.expect("]")
                sub = PromSubquery(pq, rng, step)
            else:
                pq.range_ms = rng
                self.expect("]")
        node = sub if sub is not None else pq
        self._selector_modifiers(node)
        return node


def parse_promql(query: str) -> PromExpr:
    return _Parser(query).parse()


# ---- evaluation ---------------------------------------------------------


def sql_str_literal(v: str) -> str:
    """Quote a string for SQL interpolation (doubling embedded quotes) —
    EVERY protocol front end that builds WHERE clauses from client data
    must use this, or apostrophes break the query (and worse)."""
    return "'" + str(v).replace("'", "''") + "'"


def resolves_to_samples(conn, metric: str) -> bool:
    """True when a selector on ``metric`` will evaluate against the
    self-monitoring history table — exported so HTTP prom routing uses
    the SAME predicate as evaluation (``_metric_table``) and the two
    can't drift on where a metric resolves."""
    from ..engine.metrics_recorder import SAMPLES_TABLE

    return (
        conn.catalog.open(metric) is None
        and conn.catalog.open(SAMPLES_TABLE) is not None
    )


def _metric_table(conn, pq: PromQuery):
    """Resolve a selector's metric to a table: the table of that name
    when one exists, else the self-monitoring history table
    ``system_metrics.samples`` with a pushed ``name = <metric>`` matcher
    (engine/metrics_recorder) — so ``rate(horaedb_flush_rows_total[5m])``
    works over the node's own stored telemetry even though no table named
    ``horaedb_flush_rows_total`` exists. Returns ``(pq, table, inner,
    folded)`` — ``pq`` rewritten when the fallback applied — with
    ``table=None`` when neither resolves. ``inner`` holds the caller's
    matchers on the ORIGINAL family's labels (e.g. ``{protocol="http"}``),
    which a samples-shaped table folds into its ``labels`` string tag:
    they must post-filter series via ``_inner_match``, not push into the
    scan. ``folded`` is True whenever the table stores series labels that
    way — the samples fallback AND recording-rule output tables (rules/)
    — telling callers to lift the folded labels back into first-class
    keys via ``_expand_folded_keys``."""
    import dataclasses

    table = conn.catalog.open(pq.metric)
    if table is not None:
        tags = set(table.schema.tag_names)
        # The EXACT samples shape only (a recording rule's output, or
        # the samples table addressed by name): a user table that merely
        # HAS a tag called "labels" alongside its own tags must keep
        # plain-tag semantics — lifting would rewrite its series
        # identity and silently collapse distinct series.
        if "labels" in tags and tags <= {"name", "labels", "node"}:
            # matchers on the result series' own (folded) labels
            # post-filter after lifting
            inner = [m for m in pq.matchers if m[0] not in tags]
            if inner:
                pq = dataclasses.replace(
                    pq,
                    matchers=[m for m in pq.matchers if m[0] in tags],
                )
            return pq, table, inner, True
        return pq, table, [], False
    from ..engine.metrics_recorder import SAMPLES_TABLE

    samples = conn.catalog.open(SAMPLES_TABLE)
    if samples is None:
        return pq, None, [], False
    sample_tags = set(samples.schema.tag_names)
    inner = [m for m in pq.matchers if m[0] not in sample_tags]
    pq = dataclasses.replace(
        pq,
        metric=SAMPLES_TABLE,
        matchers=[m for m in pq.matchers if m[0] in sample_tags]
        + [("name", "=", pq.metric)],
    )
    return pq, samples, inner, True


def _parse_rendered_labels(s: str) -> dict:
    """Inverse of utils.metrics._render_labels for the samples table's
    folded ``labels`` tag: ``''`` or ``{k="v",...}`` with backslash,
    quote, and newline escaped inside values."""
    out: dict = {}
    for m in re.finditer(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"', s or ""):
        # single-pass unescape: ordered str.replace would mis-decode a
        # literal backslash before 'n' (\\n -> backslash+LF)
        out[m.group(1)] = re.sub(
            r"\\(.)",
            lambda e: "\n" if e.group(1) == "n" else e.group(1),
            m.group(2),
        )
    return out


def _expand_folded_keys(per_series: dict) -> dict:
    """Samples-table fallback: lift each series' folded ``labels``
    string into first-class key labels (dropping the redundant ``name``
    — ``__name__`` already carries it), so downstream machinery —
    aggregation BY an original label, binary-op join matching,
    ``_histogram_quantile``'s ``le`` pop — sees the family's own labels
    exactly as it would over a live scrape."""
    out = {}
    for key, pts in per_series.items():
        kd = dict(key)
        folded = _parse_rendered_labels(kd.pop("labels", ""))
        kd.pop("name", None)
        for k, v in folded.items():
            kd.setdefault(k, v)  # the samples node label wins a collision
        out[tuple(sorted(kd.items()))] = pts
    return out


def _inner_match(labels: dict, matchers: list[tuple[str, str, str]]) -> bool:
    """Prom matcher semantics over a series' expanded label dict: an
    absent label is the empty string (so ``{k=""}`` matches series
    WITHOUT ``k``, and ``!=``/``!~`` pass on absent labels)."""
    for label, op, val in matchers:
        current = str(labels.get(label, ""))
        if op == "=" and current != val:
            return False
        if op == "!=" and current == val:
            return False
        if op == "=~" and re.fullmatch(val, current) is None:
            return False
        if op == "!~" and re.fullmatch(val, current) is not None:
            return False
    return True


def _value_column(schema) -> str:
    if schema.has_column("value"):
        return "value"
    fields = [schema.columns[i] for i in schema.field_indexes]
    doubles = [c.name for c in fields if c.kind.value in ("double", "float")]
    if len(doubles) == 1:
        return doubles[0]
    raise PromQLError(
        f"metric table needs a 'value' column or exactly one double field; "
        f"found {doubles}"
    )


_QUOTE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _q(name: str) -> str:
    return name if _QUOTE.match(name) else f'"{name}"'


def evaluate_range(
    conn,
    pq: PromQuery,
    start_ms: int,
    end_ms: int,
    step_ms: int,
) -> list[dict]:
    """-> prom 'matrix' result list for [start, end] at step resolution."""
    combined = _range_series(conn, pq, start_ms, end_ms, step_ms)
    out = []
    for key, points in sorted(combined.items()):
        out.append(
            {
                "metric": {"__name__": pq.metric, **{l: v for l, v in key}},
                "values": [
                    # repr = shortest round-trip form (full precision,
                    # like prom's Go 'g' formatting)
                    [b / 1000.0, repr(float(points[b]))]
                    for b in sorted(points)
                ],
            }
        )
    return out


def _range_series(
    conn,
    pq: PromQuery,
    start_ms: int,
    end_ms: int,
    step_ms: int,
) -> dict[tuple, dict[int, float]]:
    """Per-series step-bucket values in REQUESTED-time space (offset
    already stamped back), keyed by ((label, value), ...)."""
    if pq.at_ms is not None:
        return _at_series(conn, pq, start_ms, end_ms, step_ms)
    pq, table, inner_matchers, fallback = _metric_table(conn, pq)
    if table is None:
        return {}
    schema = table.schema
    value_col = _value_column(schema)
    tag_names = list(schema.tag_names)

    for label, _, _ in pq.matchers:
        if label not in tag_names:
            raise PromQLError(f"unknown label {label!r} on metric {pq.metric!r}")
    # offset: evaluate a window shifted into the past, then stamp results
    # back at the requested times (prom's `offset` modifier).
    start_ms -= pq.offset_ms
    end_ms -= pq.offset_ms
    # Equality matchers push into the scan; regex matchers post-filter the
    # (small) series set host-side.
    push_matchers = [m for m in pq.matchers if m[1] in ("=", "!=")]
    regex_matchers = [m for m in pq.matchers if m[1] in ("=~", "!~")]
    # Per-SERIES temporal aggregation per step bucket — always at full tag
    # granularity, exactly prom's model (cross-series combine is PromAgg's
    # job, _combine_agg).
    group_labels = tag_names

    # Inner temporal aggregation per step bucket.
    func = pq.func
    if func == "min_over_time":
        sel = f"min({_q(value_col)}) AS v"
    elif func == "max_over_time":
        sel = f"max({_q(value_col)}) AS v"
    elif func == "sum_over_time":
        sel = f"sum({_q(value_col)}) AS v"
    elif func == "count_over_time":
        sel = f"count({_q(value_col)}) AS v"
    else:  # raw selector / avg_over_time: average within the bucket
        sel = f"avg({_q(value_col)}) AS v"

    where = [f"{_q(schema.timestamp_name)} >= {start_ms}",
             f"{_q(schema.timestamp_name)} <= {end_ms}"]
    for label, op, val in push_matchers:
        sval = str(val).replace("'", "''")  # keep in sync w/ sql_str_literal
        where.append(f"{_q(label)} {'=' if op == '=' else '!='} '{sval}'")

    if func in _COUNTER_FUNCS:
        # Counter semantics need consecutive samples (reset detection) —
        # scan raw rows and fold host-side (samples per window are small
        # next to the table; the fused path keeps serving the rest).
        per_series = _counter_series(
            conn, pq, where, schema, value_col, group_labels, step_ms, func,
            table=table, start_ms=start_ms, end_ms=end_ms,
        )
    elif func in _RAW_FOLD_FUNCS:
        # Raw folds evaluate per step over the SLIDING left-open
        # (b-range, b] window (prom semantics) — the scan must reach back
        # one window before the first step (the >= here only over-fetches
        # the one boundary row the fold then excludes).
        window = pq.range_ms or DEFAULT_LOOKBACK_MS
        raw_where = [f"{_q(schema.timestamp_name)} >= {start_ms - window}"] + where[1:]
        per_series = _raw_window_series(
            conn, pq, raw_where, schema, value_col, group_labels,
            start_ms, end_ms, step_ms, window, func, pq.param,
        )
    else:
        keys = [f"time_bucket({_q(schema.timestamp_name)}, '{step_ms}ms')"] + [
            _q(l) for l in group_labels
        ]
        label_sel = ", ".join(_q(l) for l in group_labels)
        sql = (
            f"SELECT {keys[0]} AS bucket"
            + (f", {label_sel}" if group_labels else "")
            + f", {sel} FROM {_q(pq.metric)} WHERE {' AND '.join(where)} "
            + f"GROUP BY {', '.join(keys)}"
        )
        rows = conn.execute(sql).to_pylist()

        # per-series value per bucket; keys CANONICAL (label-sorted) so
        # binary-op matching and label-transform outputs line up across
        # metrics regardless of tag declaration order
        per_series = {}
        for r in rows:
            key = tuple(sorted((l, r[l]) for l in group_labels))
            per_series.setdefault(key, {})[r["bucket"]] = r["v"]

    if regex_matchers:
        per_series = {
            key: pts
            for key, pts in per_series.items()
            if _regex_match(dict(key), regex_matchers)
        }
    if fallback:
        # Lift the folded labels into real key labels, then apply the
        # matchers on the original family's own labels.
        per_series = _expand_folded_keys(per_series)
        if inner_matchers:
            per_series = {
                key: pts
                for key, pts in per_series.items()
                if _inner_match(dict(key), inner_matchers)
            }
    combined = per_series

    if pq.offset_ms:
        # offset stamps the shifted window back at the requested times
        combined = {
            key: {b + pq.offset_ms: v for b, v in points.items()}
            for key, points in combined.items()
        }
    return combined


def _at_series(
    conn, pq: PromQuery, start_ms: int, end_ms: int, step_ms: int
) -> dict[tuple, dict[int, float]]:
    """``metric @ t``: the value is pinned at ``t`` — one evaluation
    there, replicated across every requested step (prom's @ modifier
    semantics: the same sample answers every step)."""
    import dataclasses

    fixed = dataclasses.replace(pq, at_ms=None, offset_ms=0)
    at = pq.at_ms - pq.offset_ms  # offset still shifts the pinned time
    window = pq.range_ms or DEFAULT_LOOKBACK_MS
    inner_step = window if pq.func is not None else min(window, 60_000)
    pts = _range_series(conn, fixed, at - window, at, inner_step)
    # the SAME floor-aligned grid _range_series derives from data
    # ((ts//step)*step): a ceil-aligned grid would miss the other side's
    # first bucket in binary expressions when start isn't step-aligned
    first = (start_ms // step_ms) * step_ms
    buckets = list(range(first, end_ms + 1, step_ms))
    out = {}
    for key, series in pts.items():
        if not series:
            continue
        v = series[max(series)]  # latest resolvable value at the pin
        out[key] = {b: v for b in buckets}
    return out


def _regex_match(labels: dict, matchers: list[tuple[str, str, str]]) -> bool:
    """Prom regex matchers are fully anchored."""
    for label, op, pattern in matchers:
        current = str(labels.get(label) or "")  # NULL tag == absent label
        hit = re.fullmatch(pattern, current) is not None
        if op == "=~" and not hit:
            return False
        if op == "!~" and hit:
            return False
    return True


def _counter_series(
    conn, pq: PromQuery, where: list, schema, value_col: str,
    group_labels: list, step_ms: int, func: str,
    table=None, start_ms=None, end_ms=None,
) -> dict:
    """Reset-aware rate/increase: fold raw samples per series.

    Prom counters only move up; a drop means the process restarted and
    the counter began again near zero. increase = Σ over consecutive
    in-bucket samples of (vᵢ - vᵢ₋₁), with a reset contributing vᵢ (the
    counter re-accumulated from 0). rate = increase / step_seconds —
    min/max-based deltas would silently UNDERCOUNT across resets.

    When live window state (state/livewindow) holds the open tail, the
    resident complete buckets read write-time folded increments instead
    of raw: the scan shrinks to the head ``ts < serve_lo`` plus the
    partial-bucket tail ``ts >= tail_lo``, and the chain is stitched at
    both boundaries — a boundary delta counts only when the raw side
    has samples for the series, exactly the in-range pair rule above.
    """
    state_part = None
    if table is not None and start_ms is not None and end_ms is not None:
        from ..state.livewindow import try_livewindow_counter

        push = [m for m in pq.matchers if m[1] in ("=", "!=")]
        state_part = try_livewindow_counter(
            pq.metric, table, value_col, start_ms, end_ms, step_ms, push
        )
    scan_where = where
    serve_lo = None
    if state_part is not None:
        serve_lo = state_part["serve_lo"]
        tail_lo = state_part["tail_lo"]
        ts_q = _q(schema.timestamp_name)
        if tail_lo <= end_ms:
            scan_where = where + [f"({ts_q} < {serve_lo} OR {ts_q} >= {tail_lo})"]
        else:
            scan_where = where + [f"{ts_q} < {serve_lo}"]
    samples = _series_scan(
        conn, pq, scan_where, schema, value_col, group_labels
    )
    st_series = state_part["series"] if state_part else {}
    out: dict[tuple, dict[int, float]] = {}
    for key in set(samples) | set(st_series):
        pts = sorted(samples.get(key, ()))
        buckets: dict[int, float] = {}
        prev_v = None

        def _fold(seq):
            nonlocal prev_v
            for ts, v in seq:
                if prev_v is not None:
                    delta = v - prev_v
                    if delta < 0:
                        delta = v  # counter reset: it restarted from ~0
                    # every consecutive-sample delta counts ONCE,
                    # attributed to the later sample's bucket — a delta
                    # straddling a bucket boundary must not vanish
                    # (scrape intervals rarely align with steps). A
                    # single-sample bucket emits no point, like prom
                    # (two samples make an increase).
                    b = (ts // step_ms) * step_ms
                    buckets[b] = buckets.get(b, 0.0) + delta
                prev_v = v

        st = st_series.get(key)
        head = pts if serve_lo is None else [p for p in pts if p[0] < serve_lo]
        _fold(head)
        if st is not None:
            # head->state boundary pair, then the write-time folded
            # increments, then the chain continues from the state's
            # last sample into the partial-bucket tail
            _fold([st["first"]])
            for b, d in st["buckets"].items():
                buckets[b] = buckets.get(b, 0.0) + d
            prev_v = st["last"][1]
        if serve_lo is not None:
            _fold([p for p in pts if p[0] >= serve_lo])
        if func == "rate":
            buckets = {b: d / (step_ms / 1000.0) for b, d in buckets.items()}
        out[key] = buckets
    return out


def _raw_window_series(
    conn, pq: PromQuery, where: list, schema, value_col: str,
    group_labels: list, start_ms: int, end_ms: int, step_ms: int,
    window_ms: int, func: str, param,
) -> dict:
    """Raw-fold functions (order statistics, gauge deltas, instant
    variants, change counts): at every aligned step b the fold sees the
    SLIDING window (b-window, b] — prom's semantics. Step-sized buckets
    would show each step only its own slice (irate at a step finer than
    the scrape interval would see < 2 samples and vanish)."""
    series = _series_scan(conn, pq, where, schema, value_col, group_labels)
    first = (start_ms // step_ms) * step_ms
    if first < start_ms:
        first += step_ms
    steps = list(range(first, end_ms + 1, step_ms))
    out: dict[tuple, dict[int, float]] = {}
    for key, tv_list in series.items():
        tv_list.sort()
        ts_arr = [t for t, _ in tv_list]
        import bisect

        folded: dict[int, float] = {}
        for b in steps:
            # LEFT-OPEN window (b-window, b], Prometheus's convention — a
            # sample landing exactly on a boundary belongs to one window
            # only. The instant path (_instant_over_time) uses the same
            # open left bound so instant/range answers agree.
            lo = bisect.bisect_right(ts_arr, b - window_ms)
            hi = bisect.bisect_right(ts_arr, b)
            if lo >= hi:
                continue
            v = _fold_window(func, param, tv_list[lo:hi])
            if v is not None:
                folded[b] = v
        out[key] = folded
    return out


def _series_scan(
    conn, pq: PromQuery, where: list, schema, value_col: str, group_labels: list
) -> dict[tuple, list]:
    """Raw (ts, value) samples per CANONICAL (label-sorted) series key —
    the single scan both counter folds and order-statistic folds use."""
    label_sel = ", ".join(_q(l) for l in group_labels)
    sql = (
        f"SELECT {label_sel + ', ' if group_labels else ''}"
        f"{_q(schema.timestamp_name)} AS __ts, {_q(value_col)} AS __v "
        f"FROM {_q(pq.metric)} WHERE {' AND '.join(where)}"
    )
    rows = conn.execute(sql).to_pylist()
    samples: dict[tuple, list] = {}
    for r in rows:
        key = tuple(sorted((l, r[l]) for l in group_labels))
        samples.setdefault(key, []).append((r["__ts"], r["__v"]))
    return samples


def _fold_window(func: str, param, tv: list) -> float:
    """One window's worth of raw (ts, value) samples -> one value."""
    import math

    vals = [v for _, v in tv]
    if func == "delta":
        # gauge delta: newest minus oldest sample in the window (no
        # counter-reset folding — deltas of gauges go down legitimately).
        # <2 samples -> None: NO sample, like prom (a NaN would poison
        # downstream min/max folds).
        if len(tv) < 2:
            return None
        s = sorted(tv)
        return s[-1][1] - s[0][1]
    if func in ("irate", "idelta"):
        # instant variants: the LAST TWO samples only
        if len(tv) < 2:
            return None
        s = sorted(tv)
        (t0, v0), (t1, v1) = s[-2], s[-1]
        if t1 == t0:
            return None
        d = v1 - v0
        if func == "idelta":
            return d
        if d < 0:
            d = v1  # counter reset between the two samples
        return d / ((t1 - t0) / 1000.0)
    if func == "changes":
        # prom compares bit patterns: NaN -> NaN is NO change, NaN <-> x is
        # one (Python NaN != NaN would count every NaN pair)
        s = sorted(tv)
        n = 0
        for i in range(1, len(s)):
            a, b = s[i - 1][1], s[i][1]
            a_nan, b_nan = a != a, b != b
            if (a_nan and b_nan) or (not a_nan and not b_nan and a == b):
                continue
            n += 1
        return float(n)
    if func == "resets":
        s = sorted(tv)
        return float(sum(
            1
            for i in range(1, len(s))
            if s[i][1] == s[i][1] and s[i - 1][1] == s[i - 1][1]
            and s[i][1] < s[i - 1][1]
        ))
    if func == "last_over_time":
        return max(tv)[1]
    if func == "stddev_over_time":
        mean = sum(vals) / len(vals)
        return math.sqrt(sum((v - mean) ** 2 for v in vals) / len(vals))
    if func == "quantile_over_time":
        return _quantile(param, vals)
    if func == "sum_over_time":
        return float(sum(vals))
    if func == "count_over_time":
        return float(len(vals))
    if func == "avg_over_time":
        return sum(vals) / len(vals)
    if func == "min_over_time":
        return min(vals)
    if func == "max_over_time":
        return max(vals)
    raise PromQLError(f"unknown window function {func!r}")


DEFAULT_SUBQUERY_STEP_MS = 60_000  # prom's default evaluation interval


def _subquery_points(
    conn, node: "PromSubquery", time_ms: int, instant_cache: Optional[dict] = None
) -> dict:
    """-> {label_key: [(t, value), ...]} — the inner expression
    instant-evaluated at step-aligned times within (t-range, t].

    ``instant_cache`` memoizes per aligned instant across calls: a range
    evaluation's consecutive windows share all but one instant, and
    re-running the inner expression (>= one SQL scan each) per overlap
    would multiply the work ~range/step times."""
    t_eval = (node.at_ms if node.at_ms is not None else time_ms) - node.offset_ms
    step = node.step_ms or DEFAULT_SUBQUERY_STEP_MS
    start = t_eval - node.range_ms
    t = (start // step + 1) * step  # first aligned instant AFTER start
    out: dict = {}
    while t <= t_eval:
        vec = instant_cache.get(t) if instant_cache is not None else None
        if vec is None:
            vec = {}
            for s in evaluate_expr_instant(conn, node.expr, t):
                key = tuple(
                    sorted((k, v) for k, v in s["metric"].items() if k != "__name__")
                )
                vec[key] = float(s["value"][1])
            if instant_cache is not None:
                instant_cache[t] = vec
        for key, v in vec.items():
            out.setdefault(key, []).append((t, v))
        t += step
    return out


def _fold_subquery(func: str, param, tv: list) -> Optional[float]:
    """Fold one series' subquery samples; None -> no output sample.
    rate/increase over subquery output get counter semantics over the
    sampled points (resets folded like prom's extrapolation-free core);
    delta gets gauge semantics; *_over_time delegates to the shared
    window fold."""
    if not tv:
        return None
    if func in ("rate", "increase", "delta"):
        if len(tv) < 2:
            return None
        tv = sorted(tv)
        t0, v0 = tv[0]
        t1, _ = tv[-1]
        if t1 == t0:
            return None
        if func == "delta":
            return tv[-1][1] - v0  # gauge semantics, no reset folding
        inc = 0.0
        prev = v0
        for _, v in tv[1:]:
            inc += (v - prev) if v >= prev else v  # counter reset
            prev = v
        if func == "increase":
            return inc
        return inc / ((t1 - t0) / 1000.0)
    return _fold_window(func, param, tv)


def _subquery_vector(
    conn, node: "PromSubquery", time_ms: int, instant_cache: Optional[dict] = None
) -> dict:
    if node.func is None:
        raise PromQLError(
            "a subquery result must be consumed by a range function "
            "(e.g. max_over_time(expr[5m:1m]))"
        )
    out = {}
    for key, tv in _subquery_points(conn, node, time_ms, instant_cache).items():
        v = _fold_subquery(node.func, node.param, tv)
        if v is not None:
            out[key] = v
    return out


def _quantile(phi: float, vals: list) -> float:
    """Prom's φ-quantile: linear interpolation between closest ranks;
    φ outside [0,1] yields ∓/±Inf like prom."""
    import math

    if phi < 0:
        return -math.inf
    if phi > 1:
        return math.inf
    s = sorted(vals)
    if not s:
        return math.nan
    rank = phi * (len(s) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (rank - lo)


# ---- binary expressions --------------------------------------------------


def _apply_cmp(op: str, a: float, b: float) -> bool:
    """One comparison (filter) operator over two sample values."""
    if op == ">":
        return a > b
    if op == "<":
        return a < b
    if op == ">=":
        return a >= b
    if op == "<=":
        return a <= b
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    raise PromQLError(f"unsupported comparison {op!r}")


def _compare_series(op: str, lk, lv, rk, rv):
    """Prom filter semantics for ('scalar'|'vector') operand pairs in
    RANGE space ({key: {bucket: value}}): the surviving samples keep the
    LEFT side's values (vector OP scalar and vector OP vector), or the
    right vector's values for scalar OP vector; empty series drop out."""
    if lk == "scalar" and rk == "scalar":
        return "scalar", 1.0 if _apply_cmp(op, lv, rv) else 0.0
    if lk == "vector" and rk == "scalar":
        out = {
            key: {b: v for b, v in pts.items() if _apply_cmp(op, v, rv)}
            for key, pts in lv.items()
        }
        return "vector", {k: p for k, p in out.items() if p}
    if lk == "scalar" and rk == "vector":
        out = {
            key: {b: v for b, v in pts.items() if _apply_cmp(op, lv, v)}
            for key, pts in rv.items()
        }
        return "vector", {k: p for k, p in out.items() if p}
    out: dict = {}
    for key, lpts in lv.items():
        rpts = rv.get(key)
        if rpts is None:
            continue
        pts = {
            b: v
            for b, v in lpts.items()
            if b in rpts and _apply_cmp(op, v, rpts[b])
        }
        if pts:
            out[key] = pts
    return "vector", out


def _apply_op(op: str, a: float, b: float) -> float:
    import math

    try:
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "%":
            if b == 0:
                return math.nan  # prom: x % 0 -> NaN (fmod would raise)
            return math.fmod(a, b)
    except ZeroDivisionError:
        # prom arithmetic: x/0 -> ±Inf, 0/0 -> NaN (never an error)
        if a > 0:
            return math.inf
        if a < 0:
            return -math.inf
        return math.nan
    raise PromQLError(f"unsupported operator {op!r}")


def _eval_series(conn, node: PromExpr, start_ms: int, end_ms: int, step_ms: int):
    """-> ('scalar', float) or ('vector', {key: {bucket: value}})."""
    if isinstance(node, PromScalar):
        return "scalar", node.value
    if isinstance(node, PromSubquery):
        first = (start_ms // step_ms) * step_ms
        if first < start_ms:
            first += step_ms
        vec: dict = {}
        instant_cache: dict = {}  # consecutive windows share instants
        for b in range(first, end_ms + 1, step_ms):
            for key, v in _subquery_vector(conn, node, b, instant_cache).items():
                vec.setdefault(key, {})[b] = v
        return "vector", vec
    if isinstance(node, PromQuery):
        return "vector", _range_series(conn, node, start_ms, end_ms, step_ms)
    if isinstance(node, PromAgg):
        k, vec = _eval_series(conn, node.arg, start_ms, end_ms, step_ms)
        if k != "vector":
            raise PromQLError(f"{node.op}() expects a vector argument")
        return "vector", _combine_agg(node, vec)
    if isinstance(node, PromCall):
        k, vec = _eval_series(conn, node.arg, start_ms, end_ms, step_ms)
        if k != "vector":
            raise PromQLError(f"{node.name}() expects a vector argument")
        return "vector", _apply_call(node, vec)
    lk, lv = _eval_series(conn, node.lhs, start_ms, end_ms, step_ms)
    rk, rv = _eval_series(conn, node.rhs, start_ms, end_ms, step_ms)
    op = node.op
    if op in COMPARE_OPS:
        return _compare_series(op, lk, lv, rk, rv)
    if lk == "scalar" and rk == "scalar":
        return "scalar", _apply_op(op, lv, rv)
    if rk == "scalar":
        return "vector", {
            key: {b: _apply_op(op, v, rv) for b, v in pts.items()}
            for key, pts in lv.items()
        }
    if lk == "scalar":
        return "vector", {
            key: {b: _apply_op(op, lv, v) for b, v in pts.items()}
            for key, pts in rv.items()
        }
    # vector/vector: one-to-one on identical label sets; samples without
    # a partner (either side) drop out, matching prom's default matching
    out: dict[tuple, dict[int, float]] = {}
    for key, lpts in lv.items():
        rpts = rv.get(key)
        if rpts is None:
            continue
        pts = {
            b: _apply_op(op, v, rpts[b]) for b, v in lpts.items() if b in rpts
        }
        if pts:
            out[key] = pts
    return "vector", out


def leaf_metrics(node: PromExpr) -> list[str]:
    """Metric names referenced by an expression, left to right."""
    if isinstance(node, PromQuery):
        return [node.metric]
    if isinstance(node, PromBin):
        return leaf_metrics(node.lhs) + leaf_metrics(node.rhs)
    if isinstance(node, (PromAgg, PromCall)):
        return leaf_metrics(node.arg)
    if isinstance(node, PromSubquery):
        return leaf_metrics(node.expr)
    return []


def _combine_agg(node: PromAgg, vec: dict) -> dict:
    """Cross-series combine of {key: {bucket: v}} (ref surface: prom's
    aggregation operators via the IOx planner the reference forks).

    ``by`` keeps listed labels, ``without`` drops listed labels, neither
    collapses everything. topk/bottomk differ: they SELECT input series
    (full original labels survive), per bucket, within each group.
    """
    import math

    def out_key(key: tuple) -> tuple:
        if node.without_labels is not None:
            drop = set(node.without_labels)
            return tuple((l, v) for l, v in key if l not in drop)
        if node.by_labels is not None:
            keep = set(node.by_labels)
            return tuple((l, v) for l, v in key if l in keep)
        return ()

    if node.op in ("topk", "bottomk"):
        k = int(node.param)
        largest = node.op == "topk"
        # group -> bucket -> [(value, key)]
        ranked: dict[tuple, dict[int, list]] = {}
        for key, pts in vec.items():
            g = out_key(key)
            for b, v in pts.items():
                ranked.setdefault(g, {}).setdefault(b, []).append((v, key))
        out: dict[tuple, dict[int, float]] = {}
        for g, buckets in ranked.items():
            for b, pairs in buckets.items():
                pairs.sort(key=lambda t: t[0], reverse=largest)
                for v, key in pairs[:k]:
                    out.setdefault(key, {})[b] = v
        return out

    grouped: dict[tuple, dict[int, list]] = {}
    for key, pts in vec.items():
        g = out_key(key)
        dst = grouped.setdefault(g, {})
        for b, v in pts.items():
            dst.setdefault(b, []).append(v)

    def fn(vs: list) -> float:
        if node.op == "sum":
            return sum(vs)
        if node.op == "avg":
            return sum(vs) / len(vs)
        if node.op == "min":
            return min(vs)
        if node.op == "max":
            return max(vs)
        if node.op == "count":
            return float(len(vs))
        if node.op in ("stddev", "stdvar"):
            mean = sum(vs) / len(vs)
            var = sum((v - mean) ** 2 for v in vs) / len(vs)
            return var if node.op == "stdvar" else math.sqrt(var)
        if node.op == "quantile":
            return _quantile(node.param, vs)
        raise PromQLError(f"unknown aggregator {node.op!r}")

    return {
        g: {b: fn(vs) for b, vs in buckets.items()}
        for g, buckets in grouped.items()
    }


_DOLLAR_REF = re.compile(r"\$(\d+|\{\w+\})")


def _apply_call(node: PromCall, vec: dict) -> dict:
    """histogram_quantile / label manipulation / per-sample math."""
    import math

    name = node.name
    if name == "histogram_quantile":
        return _histogram_quantile(node.params[0], vec)
    if name in ("label_replace", "label_join"):
        out: dict = {}
        for key, pts in vec.items():
            labels = dict(key)
            if name == "label_replace":
                dst, repl, src, pattern = node.params
                current = str(labels.get(src) or "")
                m = re.fullmatch(pattern, current)
                if m is not None:
                    def _ref(g, _m=m):
                        ref = g.group(1).strip("{}")
                        try:
                            got = _m.group(int(ref) if ref.isdigit() else ref)
                        except (IndexError, re.error):
                            raise PromQLError(
                                f"label_replace: no capture group ${ref}"
                            )
                        return got or ""

                    new = _DOLLAR_REF.sub(_ref, repl)
                    if new:
                        labels[dst] = new
                    else:
                        labels.pop(dst, None)
            else:
                dst, sep, *srcs = node.params
                new = sep.join(str(labels.get(s) or "") for s in srcs)
                if new:
                    labels[dst] = new
                else:
                    labels.pop(dst, None)
            new_key = tuple(sorted(labels.items()))
            if new_key in out:
                raise PromQLError(
                    f"{name} produced duplicate series for labels {labels}"
                )
            out[new_key] = pts
        return out

    # per-sample math
    p = node.params[0] if node.params else None
    if name == "abs":
        f = abs
    elif name == "ceil":
        f = math.ceil
    elif name == "floor":
        f = math.floor
    elif name == "round":
        nearest = p if p else 1.0
        f = lambda v: math.floor(v / nearest + 0.5) * nearest
    elif name == "clamp_min":
        f = lambda v: max(v, p)
    elif name == "clamp_max":
        f = lambda v: min(v, p)
    else:
        raise PromQLError(f"unknown function {name!r}")
    return {
        key: {b: float(f(v)) for b, v in pts.items()} for key, pts in vec.items()
    }


def _histogram_quantile(phi: float, vec: dict) -> dict:
    """Prom's histogram_quantile over conventional `_bucket` series:
    groups by labels-minus-`le`, linear interpolation inside the target
    bucket, +Inf bucket answers with the highest finite bound. Bucket
    counts are made monotone first (float scrapes can jitter)."""
    import math

    groups: dict[tuple, dict[int, list]] = {}
    for key, pts in vec.items():
        labels = dict(key)
        le = labels.pop("le", None)
        if le is None:
            continue  # not a histogram series
        try:
            bound = math.inf if str(le) in ("+Inf", "Inf", "inf") else float(le)
        except ValueError:
            continue
        g = tuple(sorted(labels.items()))
        for b, v in pts.items():
            groups.setdefault(g, {}).setdefault(b, []).append((bound, v))
    out: dict[tuple, dict[int, float]] = {}
    for g, buckets in groups.items():
        pts = {}
        for b, pairs in buckets.items():
            q = _hq_one(phi, pairs)
            if q is not None:
                pts[b] = q
        if pts:
            out[g] = pts
    return out


def _hq_one(phi: float, pairs: list) -> "float | None":
    import math

    if phi < 0:
        return -math.inf
    if phi > 1:
        return math.inf
    pairs.sort()
    if len(pairs) < 2 or not math.isinf(pairs[-1][0]):
        return None  # prom requires an +Inf bucket
    # enforce monotone cumulative counts
    mono = []
    prev = 0.0
    for le, c in pairs:
        prev = max(prev, c)
        mono.append((le, prev))
    total = mono[-1][1]
    if total == 0:
        return None
    rank = phi * total
    for i, (le, c) in enumerate(mono):
        if c >= rank:
            if math.isinf(le):
                # quantile in the +Inf bucket: highest finite bound
                return mono[i - 1][0]
            lower_le = mono[i - 1][0] if i > 0 else 0.0
            lower_c = mono[i - 1][1] if i > 0 else 0.0
            if c == lower_c:
                return le
            return lower_le + (le - lower_le) * (rank - lower_c) / (c - lower_c)
    return None


def evaluate_expr_range(
    conn, node: PromExpr, start_ms: int, end_ms: int, step_ms: int
) -> list[dict]:
    """Range-evaluate any expression -> prom 'matrix'. Leaf queries keep
    their metric name; arithmetic results drop __name__ (like prom)."""
    if isinstance(node, PromQuery):
        return evaluate_range(conn, node, start_ms, end_ms, step_ms)
    kind, val = _eval_series(conn, node, start_ms, end_ms, step_ms)
    if kind == "scalar":
        # a constant series sampled at each aligned step
        first = (start_ms // step_ms) * step_ms
        if first < start_ms:
            first += step_ms
        buckets = list(range(first, end_ms + 1, step_ms))
        return [
            {
                "metric": {},
                "values": [[b / 1000.0, repr(float(val))] for b in buckets],
            }
        ]
    out = []
    for key, points in sorted(val.items()):
        out.append(
            {
                "metric": {l: v for l, v in key},
                "values": [
                    [b / 1000.0, repr(float(points[b]))] for b in sorted(points)
                ],
            }
        )
    return out


def _instant_value(conn, node: PromExpr, time_ms: int):
    """-> ('scalar', float) or ('vector', {label_key: float}).

    Every metric leaf evaluates with ITS OWN instant semantics (its own
    range window; rate folds its whole range, raw selectors take the
    latest sample) — mixing rate(x[4m]) with a raw selector never shrinks
    the rate's window. Keys exclude __name__, matching prom's one-to-one
    rule that arithmetic ignores the metric name."""
    if isinstance(node, PromScalar):
        return "scalar", node.value
    if isinstance(node, PromSubquery):
        return "vector", _subquery_vector(conn, node, time_ms)
    if isinstance(node, PromQuery):
        vec = {}
        for s in evaluate_instant(conn, node, time_ms):
            key = tuple(
                sorted((k, v) for k, v in s["metric"].items() if k != "__name__")
            )
            vec[key] = float(s["value"][1])
        return "vector", vec
    if isinstance(node, (PromAgg, PromCall)):
        k, vec = _instant_value(conn, node.arg, time_ms)
        if k != "vector":
            raise PromQLError("vector argument expected")
        # reuse the range combinators through a single synthetic bucket
        as_pts = {key: {0: v} for key, v in vec.items()}
        combined = (
            _combine_agg(node, as_pts)
            if isinstance(node, PromAgg)
            else _apply_call(node, as_pts)
        )
        return "vector", {
            key: pts[0] for key, pts in combined.items() if 0 in pts
        }
    lk, lv = _instant_value(conn, node.lhs, time_ms)
    rk, rv = _instant_value(conn, node.rhs, time_ms)
    op = node.op
    if op in COMPARE_OPS:
        # reuse the range-space filter through a single synthetic bucket
        as_pts = lambda vec: {key: {0: v} for key, v in vec.items()}
        kind, out = _compare_series(
            op,
            lk, as_pts(lv) if lk == "vector" else lv,
            rk, as_pts(rv) if rk == "vector" else rv,
        )
        if kind == "scalar":
            return "scalar", out
        return "vector", {key: pts[0] for key, pts in out.items()}
    if lk == "scalar" and rk == "scalar":
        return "scalar", _apply_op(op, lv, rv)
    if rk == "scalar":
        return "vector", {k: _apply_op(op, v, rv) for k, v in lv.items()}
    if lk == "scalar":
        return "vector", {k: _apply_op(op, lv, v) for k, v in rv.items()}
    return "vector", {
        k: _apply_op(op, v, rv[k]) for k, v in lv.items() if k in rv
    }


def evaluate_expr_instant(conn, node: PromExpr, time_ms: int) -> list[dict]:
    """Instant-evaluate any expression -> prom 'vector'."""
    if isinstance(node, PromQuery):
        return evaluate_instant(conn, node, time_ms)
    kind, val = _instant_value(conn, node, time_ms)
    if kind == "scalar":
        return [{"metric": {}, "value": [time_ms / 1000.0, repr(float(val))]}]
    return [
        {"metric": dict(key), "value": [time_ms / 1000.0, repr(float(v))]}
        for key, v in sorted(val.items())
    ]


DEFAULT_LOOKBACK_MS = 5 * 60_000  # prom's 5m instant lookback


_OVER_TIME_FUNCS = frozenset(
    f for f in RANGE_FUNCS if f.endswith("_over_time")
)
# Functions that must fold the EXACT (t-range, t] window at instant
# evaluation (epoch-aligned buckets cover only a fraction of the window
# whenever t isn't step-aligned): the *_over_time family plus delta.
_EXACT_WINDOW_FUNCS = _OVER_TIME_FUNCS | _RAW_FOLD_FUNCS


def evaluate_instant(conn, pq: PromQuery, time_ms: int) -> list[dict]:
    """-> prom 'vector': latest resolvable value per series in the lookback
    (steps at scrape-ish resolution so 'latest' means latest, not a
    whole-window average). ``*_over_time`` functions fold their EXACT
    left-open window (t-range, t] (not an epoch-aligned bucket containing
    t — an aligned bucket would cover a fraction of the window whenever t
    isn't step-aligned)."""
    if pq.func in _EXACT_WINDOW_FUNCS:
        return _instant_over_time(conn, pq, time_ms)
    window = pq.range_ms or DEFAULT_LOOKBACK_MS
    # rate/increase aggregate over their whole window; only a raw selector
    # walks in scrape-resolution steps to find the latest sample.
    step = window if pq.func is not None else min(window, 60_000)
    matrix = evaluate_range(conn, pq, time_ms - window, time_ms, step)
    out = []
    for series in matrix:
        if not series["values"]:
            continue
        ts, val = series["values"][-1]
        out.append({"metric": series["metric"], "value": [time_ms / 1000.0, val]})
    return out


def _instant_over_time(conn, pq: PromQuery, time_ms: int) -> list[dict]:
    """One raw fold per series over exactly (t-range, t] (after @/offset) —
    Prometheus's left-open window, matching _raw_window_series."""
    orig_metric = pq.metric  # the fallback rewrite must not leak into __name__
    pq, table, inner_matchers, fallback = _metric_table(conn, pq)
    if table is None:
        return []
    schema = table.schema
    value_col = _value_column(schema)
    tag_names = list(schema.tag_names)
    for label, _, _ in pq.matchers:
        if label not in tag_names:
            raise PromQLError(f"unknown label {label!r} on metric {pq.metric!r}")
    t_eval = (pq.at_ms if pq.at_ms is not None else time_ms) - pq.offset_ms
    window = pq.range_ms or DEFAULT_LOOKBACK_MS
    where = [
        f"{_q(schema.timestamp_name)} > {t_eval - window}",
        f"{_q(schema.timestamp_name)} <= {t_eval}",
    ]
    for label, op, val in pq.matchers:
        if op in ("=", "!="):
            sval = str(val).replace("'", "''")
            where.append(f"{_q(label)} {'=' if op == '=' else '!='} '{sval}'")
    regex_matchers = [m for m in pq.matchers if m[1] in ("=~", "!~")]
    series = _series_scan(conn, pq, where, schema, value_col, tag_names)
    if regex_matchers:
        series = {
            key: tv for key, tv in series.items()
            if _regex_match(dict(key), regex_matchers)
        }
    if fallback:
        series = _expand_folded_keys(series)
        if inner_matchers:
            series = {
                key: tv for key, tv in series.items()
                if _inner_match(dict(key), inner_matchers)
            }
    out = []
    for key, tv in sorted(series.items()):
        v = _fold_window(pq.func, pq.param, tv)
        if v is None:
            continue  # e.g. delta over a single sample: no output point
        out.append(
            {
                "metric": {"__name__": orig_metric, **{l: x for l, x in key}},
                "value": [time_ms / 1000.0, repr(float(v))],
            }
        )
    return out
