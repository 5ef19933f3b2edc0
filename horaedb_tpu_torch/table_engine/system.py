"""System catalog virtual tables
(ref: src/system_catalog/src/tables.rs — ``system.public.tables`` lists
every user table as rows (timestamp, catalog, schema, table_name,
table_id, engine); served straight from the catalog manager, never
stored).

Virtual tables implement the same ``Table`` interface real tables do, so
the whole query layer — projections, filters, aggregates, EXPLAIN, every
wire protocol (HTTP SQL, MySQL, PostgreSQL) — works on them unchanged.
Reads materialize a fresh RowGroup on every scan (the listing IS the
current state).

The tables:

- ``system.public.tables``      — the catalog registry
- ``system.public.query_stats`` — the bounded ring of finalized per-query
  cost ledgers (utils/querystats.STATS_STORE), joinable on request_id;
  one row per recent query with route + every ledger cost field
- ``system.public.metrics``     — a live snapshot of the Prometheus
  registry (one row per sample: family, kind, labels, value)
- ``system.public.workload``    — the workload manager's live state
  (admission slots/queues, dedup flights, quota buckets) plus every
  ``horaedb_admission_*`` counter, as (category, name, label, value)
  rows — the SQL face of /debug/workload
- ``system.public.events``      — the engine event journal
  (utils/events.EVENT_STORE): typed lifecycle events (flush freeze/dump/
  install, compaction, write-stall enter/exit, sheds, WAL replay, DDL,
  shard freeze/thaw), each carrying the trace_id of the request that
  caused it — joinable against query_stats.request_id and the
  /debug/trace store
- ``system.public.alerts``      — the rule engine's alert state
  (rules/engine.RuleEngine): one row per live pending/firing alert
  series plus the recently-resolved ring, labels rendered in the
  standard folded form — the SQL face of /debug/alerts on every wire
- ``system.public.slo``         — the SLO plane's verdicts
  (slo/evaluator.SloEvaluator): one row per objective with its state
  (ok|burning|no_data), current indicator value vs bound, fast/slow
  burn rates over the sliding windows, and the breach count — the SQL
  face of /debug/slo; the tenant simulator's acceptance gate reads it
- ``system.public.device``      — the device telemetry plane's HBM
  residency inventory (obs/device.device_inventory): one row per
  (table, column, component) with dtype, resident bytes, rows,
  last-hit age, and eviction counts; ``component='column'`` rows sum
  exactly to the scan cache's own device_bytes accounting — the usage
  map the dtype/layout auto-tuners read, the SQL face of /debug/device
- ``system.public.decisions``   — the decision plane's journal
  (obs/decisions.DECISION_JOURNAL): one row per adaptive-loop decision
  (kernel router, admission, elastic, dtype tuner, deadline sheds) with
  its choice, features, predicted value, realized outcome, and relative
  error; trace-linked like events — the SQL face of /debug/decisions
- ``system.public.calibration`` — the decision plane's per-loop grading
  (signed/abs relative-error EWMA + fast/slow windows) plus the exact
  issued/resolved/expired/missed/unresolved accounting ledger — the
  tenant simulator's reconciliation gate reads it
- ``system.public.profile``     — the continuous profile plane
  (obs/profile.PROFILE): one row per live (span path, route, shape)
  key with count, total/exclusive milliseconds, EWMA + fast/slow
  window means, and a last-exemplar trace_id linking to
  /debug/trace/{id}; ``<root>/(untracked)`` rows carry the wall time
  no child span covered — the coverage contract the tenantsim gate
  asserts from this table
- ``system.public.traces``      — the bounded trace store
  (utils/tracectx.TRACE_STORE): one row per recent/slow finished
  trace (trace_id, name, at, duration_ms, spans, slow) — the SQL face
  of /debug/trace on every wire
"""

from __future__ import annotations

import numpy as np

from ..common_types import ColumnSchema, DatumKind, RowGroup, Schema
from ..utils.querystats import FLOAT_FIELDS, NUMERIC_FIELDS, STATS_STORE
from .table import Table, TableOptions

TABLES_NAME = "system.public.tables"
QUERY_STATS_NAME = "system.public.query_stats"
METRICS_NAME = "system.public.metrics"
WORKLOAD_NAME = "system.public.workload"
EVENTS_NAME = "system.public.events"
ALERTS_NAME = "system.public.alerts"
SLO_NAME = "system.public.slo"
QUERIES_NAME = "system.public.queries"
DEVICE_NAME = "system.public.device"
DECISIONS_NAME = "system.public.decisions"
CALIBRATION_NAME = "system.public.calibration"
PROFILE_NAME = "system.public.profile"
TRACES_NAME = "system.public.traces"


class _VirtualTable(Table):
    """Read-only table materialized from in-process state on every scan."""

    def __init__(self) -> None:
        self._options = TableOptions()

    @property
    def options(self) -> TableOptions:
        return self._options

    def write(self, rows) -> int:
        raise ValueError(f"{self.name} is read-only")

    def _materialize(self) -> RowGroup:
        raise NotImplementedError

    def read(self, predicate=None, projection=None) -> RowGroup:
        rows = self._materialize()
        if predicate is not None:
            # The executor drops timestamp conjuncts from its residual
            # WHERE on the promise that storage applied the time range
            # exactly — honor that promise here too.
            tr = predicate.time_range
            ts = rows.timestamps
            mask = (ts >= tr.inclusive_start) & (ts < tr.exclusive_end)
            if not mask.all():
                rows = rows.take(np.nonzero(mask)[0])
        if projection is not None:
            from ..engine.merge import project_schema

            proj = project_schema(rows.schema, projection)
            rows = RowGroup(
                proj, {c.name: rows.columns[c.name] for c in proj.columns},
                {k: v for k, v in rows.validity.items()
                 if any(c.name == k for c in proj.columns)},
            )
        return rows

    def flush(self) -> None:
        pass

    def compact(self) -> None:
        pass

    def alter_schema(self, schema) -> None:
        raise ValueError(f"{self.name} is read-only")


_TABLES_SCHEMA = Schema.build(
    [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("catalog", DatumKind.STRING, is_nullable=False),
        ColumnSchema("schema", DatumKind.STRING, is_nullable=False),
        ColumnSchema("table_name", DatumKind.STRING, is_nullable=False),
        ColumnSchema("table_id", DatumKind.UINT64, is_nullable=False),
        ColumnSchema("engine", DatumKind.STRING, is_nullable=False),
    ],
    timestamp_column="timestamp",
    primary_key=["timestamp", "catalog", "schema", "table_name"],
)


class SystemTablesTable(_VirtualTable):
    """``system.public.tables`` (read-only)."""

    def __init__(self, catalog) -> None:
        super().__init__()
        self.catalog = catalog

    @property
    def name(self) -> str:
        return TABLES_NAME

    @property
    def schema(self) -> Schema:
        return _TABLES_SCHEMA

    def _materialize(self) -> RowGroup:
        names = sorted(self.catalog.table_names())
        ids = []
        for n in names:
            e = self.catalog.entry(n)
            ids.append(int(e.table_id) if e is not None else 0)
        return RowGroup(
            _TABLES_SCHEMA,
            {
                "timestamp": np.zeros(len(names), dtype=np.int64),
                "catalog": np.array(["horaedb"] * len(names), dtype=object),
                "schema": np.array(["public"] * len(names), dtype=object),
                "table_name": np.array(names, dtype=object),
                "table_id": np.array(ids, dtype=np.uint64),
                "engine": np.array(["Analytic"] * len(names), dtype=object),
            },
        )


def _query_stats_schema() -> Schema:
    """Derived from the ledger field registry — a new ledger field gets
    its column here without a second list to forget."""
    cols = [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("request_id", DatumKind.UINT64, is_nullable=False),
        ColumnSchema("sql", DatumKind.STRING),
        ColumnSchema("route", DatumKind.STRING),
        ColumnSchema("kernel", DatumKind.STRING),
        ColumnSchema("table_name", DatumKind.STRING),
        ColumnSchema("duration_ms", DatumKind.DOUBLE),
    ]
    cols += [ColumnSchema(f, DatumKind.INT64) for f in NUMERIC_FIELDS]
    cols += [ColumnSchema(f, DatumKind.DOUBLE) for f in FLOAT_FIELDS]
    return Schema.build(
        cols,
        timestamp_column="timestamp",
        primary_key=["timestamp", "request_id"],
    )


_QUERY_STATS_SCHEMA = _query_stats_schema()


class QueryStatsTable(_VirtualTable):
    """``system.public.query_stats``: recent finalized query ledgers."""

    @property
    def name(self) -> str:
        return QUERY_STATS_NAME

    @property
    def schema(self) -> Schema:
        return _QUERY_STATS_SCHEMA

    def _materialize(self) -> RowGroup:
        entries = STATS_STORE.list()
        n = len(entries)

        def ints(key, coerce=int) -> np.ndarray:
            out = np.zeros(n, dtype=np.int64)
            for i, e in enumerate(entries):
                v = e.get(key, 0)
                try:
                    out[i] = coerce(v)
                except (TypeError, ValueError):
                    out[i] = 0
            return out

        data: dict[str, np.ndarray] = {
            "timestamp": ints("timestamp"),
            # request ids are the proxy's integer counter; anything else
            # (embedded callers) coerces to 0 rather than failing the scan
            "request_id": ints("request_id").astype(np.uint64),
            "sql": np.array([str(e.get("sql", "")) for e in entries], dtype=object),
            "route": np.array([str(e.get("route", "")) for e in entries], dtype=object),
            "kernel": np.array(
                [str(e.get("kernel", "")) for e in entries], dtype=object
            ),
            "table_name": np.array(
                [str(e.get("table_name", "")) for e in entries], dtype=object
            ),
            "duration_ms": np.array(
                [float(e.get("duration_ms", 0.0)) for e in entries], dtype=np.float64
            ),
        }
        for f in NUMERIC_FIELDS:
            data[f] = ints(f)
        for f in FLOAT_FIELDS:
            data[f] = np.array(
                [float(e.get(f, 0.0)) for e in entries], dtype=np.float64
            )
        return RowGroup(_QUERY_STATS_SCHEMA, data)


_METRICS_SCHEMA = Schema.build(
    [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("name", DatumKind.STRING, is_nullable=False),
        ColumnSchema("kind", DatumKind.STRING, is_nullable=False),
        ColumnSchema("labels", DatumKind.STRING),
        ColumnSchema("value", DatumKind.DOUBLE),
    ],
    timestamp_column="timestamp",
    primary_key=["timestamp", "name", "labels"],
)


class MetricsTable(_VirtualTable):
    """``system.public.metrics``: live registry snapshot as rows.

    Counters/gauges contribute one row each; histograms contribute
    ``<name>_count`` and ``<name>_sum`` rows (bucket vectors stay on
    /metrics — SQL dashboards want the scalars)."""

    @property
    def name(self) -> str:
        return METRICS_NAME

    @property
    def schema(self) -> Schema:
        return _METRICS_SCHEMA

    def _materialize(self) -> RowGroup:
        import time

        from ..utils.metrics import Histogram, _render_labels, REGISTRY

        now = int(time.time() * 1000)
        names, kinds, labels, values = [], [], [], []
        for family, members in sorted(REGISTRY.families().items()):
            for m in members:
                rendered = _render_labels(m.labels)
                if isinstance(m, Histogram):
                    with m._lock:
                        total, sum_ = m._total, m._sum
                    names += [f"{family}_count", f"{family}_sum"]
                    kinds += ["histogram", "histogram"]
                    labels += [rendered, rendered]
                    values += [float(total), float(sum_)]
                else:
                    names.append(family)
                    kinds.append(m.TYPE)
                    labels.append(rendered)
                    values.append(float(m.value))
        n = len(names)
        return RowGroup(
            _METRICS_SCHEMA,
            {
                "timestamp": np.full(n, now, dtype=np.int64),
                "name": np.array(names, dtype=object),
                "kind": np.array(kinds, dtype=object),
                "labels": np.array(labels, dtype=object),
                "value": np.array(values, dtype=np.float64),
            },
        )


_WORKLOAD_SCHEMA = Schema.build(
    [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("category", DatumKind.STRING, is_nullable=False),
        ColumnSchema("name", DatumKind.STRING, is_nullable=False),
        ColumnSchema("label", DatumKind.STRING),
        ColumnSchema("value", DatumKind.DOUBLE),
    ],
    timestamp_column="timestamp",
    primary_key=["timestamp", "category", "name", "label"],
)


class WorkloadTable(_VirtualTable):
    """``system.public.workload``: the workload manager's live state as
    rows, observable over every wire protocol.

    Live gauges (slots in use, queue depths, dedup flights, quota bucket
    tokens) read from the process's registered WorkloadManagers (summed
    when several proxies coexist); every ``horaedb_admission_*`` metric
    family contributes counter rows under category ``counters`` (name =
    family, so the lint contract 'family -> system-table row' is
    mechanical). Histogram families surface as ``count``/``sum`` labeled
    rows under the family name."""

    @property
    def name(self) -> str:
        return WORKLOAD_NAME

    @property
    def schema(self) -> Schema:
        return _WORKLOAD_SCHEMA

    def _materialize(self) -> RowGroup:
        import time

        from ..utils.metrics import Histogram, _render_labels, REGISTRY
        from ..wlm import registered_managers

        now = int(time.time() * 1000)
        # (category, name, label) -> summed value
        rows: dict[tuple[str, str, str], float] = {}

        def add(category: str, name: str, label: str, value: float) -> None:
            key = (category, name, label)
            rows[key] = rows.get(key, 0.0) + float(value)

        for mgr in registered_managers():
            adm = mgr.admission.snapshot()
            for k in ("total_units", "units_in_use", "memory_budget_bytes",
                      "memory_in_use_bytes", "expensive_cap", "queue_limit"):
                add("admission", k, "", adm[k])
            for cls, units in adm["class_units"].items():
                add("admission", "class_units", cls, units)
            for cls, depth in adm["queue_depth"].items():
                add("admission", "queue_depth", cls, depth)
            ded = mgr.dedup.snapshot()
            for k in ("inflight_leaders", "waiting_followers", "write_epoch"):
                add("dedup", k, "", ded[k])
            q = mgr.quota.snapshot()
            for t in q["blocked"]:
                add("quota", "blocked", t, 1)
            for b in q["quotas"]:
                label = f"{b['scope']}:{b['name']}:{b['kind']}"
                add("quota", "bucket_rate", label, b["rate"])
                add("quota", "bucket_tokens", label, b["tokens"])
        for family, members in sorted(REGISTRY.families().items()):
            if not family.startswith("horaedb_admission_"):
                continue
            for m in members:
                rendered = _render_labels(m.labels)
                if isinstance(m, Histogram):
                    with m._lock:
                        total, sum_ = m._total, m._sum
                    add("counters", family, "count", total)
                    add("counters", family, "sum", sum_)
                else:
                    add("counters", family, rendered, m.value)
        keys = sorted(rows)
        n = len(keys)
        return RowGroup(
            _WORKLOAD_SCHEMA,
            {
                "timestamp": np.full(n, now, dtype=np.int64),
                "category": np.array([k[0] for k in keys], dtype=object),
                "name": np.array([k[1] for k in keys], dtype=object),
                "label": np.array([k[2] for k in keys], dtype=object),
                "value": np.array([rows[k] for k in keys], dtype=np.float64),
            },
        )


_EVENTS_SCHEMA = Schema.build(
    [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("seq", DatumKind.UINT64, is_nullable=False),
        ColumnSchema("kind", DatumKind.STRING, is_nullable=False),
        ColumnSchema("table_name", DatumKind.STRING),
        ColumnSchema("trace_id", DatumKind.UINT64),
        ColumnSchema("attrs", DatumKind.STRING),
    ],
    timestamp_column="timestamp",
    primary_key=["timestamp", "seq"],
)


class EventsTable(_VirtualTable):
    """``system.public.events``: the engine event journal as rows.

    ``attrs`` is the event's attribute dict rendered as sorted-key JSON
    (utils/events.render_attrs); ``trace_id`` is 0 when the event fired
    outside any traced request (periodic scans, lease watch)."""

    @property
    def name(self) -> str:
        return EVENTS_NAME

    @property
    def schema(self) -> Schema:
        return _EVENTS_SCHEMA

    def _materialize(self) -> RowGroup:
        from ..utils.events import EVENT_STORE, render_attrs

        entries = EVENT_STORE.list()

        def tid(e) -> int:
            # embedded callers may trace with non-integer ids; the
            # UINT64 column coerces those to 0 rather than failing scans
            try:
                return int(e["trace_id"] or 0)
            except (TypeError, ValueError):
                return 0

        return RowGroup(
            _EVENTS_SCHEMA,
            {
                "timestamp": np.array(
                    [e["timestamp"] for e in entries], dtype=np.int64
                ),
                "seq": np.array([e["seq"] for e in entries], dtype=np.uint64),
                "kind": np.array([e["kind"] for e in entries], dtype=object),
                "table_name": np.array(
                    [e["table"] for e in entries], dtype=object
                ),
                "trace_id": np.array(
                    [tid(e) for e in entries], dtype=np.uint64
                ),
                "attrs": np.array(
                    [render_attrs(e["attrs"]) for e in entries], dtype=object
                ),
            },
        )


_ALERTS_SCHEMA = Schema.build(
    [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("rule", DatumKind.STRING, is_nullable=False),
        ColumnSchema("labels", DatumKind.STRING),
        ColumnSchema("state", DatumKind.STRING, is_nullable=False),
        ColumnSchema("value", DatumKind.DOUBLE),
        ColumnSchema("active_since", DatumKind.INT64),
        ColumnSchema("fired_at", DatumKind.INT64),
        ColumnSchema("resolved_at", DatumKind.INT64),
    ],
    timestamp_column="timestamp",
    primary_key=["timestamp", "rule", "labels"],
)


class AlertsTable(_VirtualTable):
    """``system.public.alerts``: the rule engine's alert lifecycle state
    as rows (pending/firing live, recently-resolved ring), summed over
    every registered RuleEngine in the process. ``timestamp`` is the
    instance's state-entry time (fired_at for firing, resolved_at for
    resolved, active_since for pending) so dashboards sort naturally."""

    @property
    def name(self) -> str:
        return ALERTS_NAME

    @property
    def schema(self) -> Schema:
        return _ALERTS_SCHEMA

    def _materialize(self) -> RowGroup:
        from ..rules import registered_engines
        from ..utils.metrics import _render_labels

        entries = []
        for eng in registered_engines():
            entries.extend(eng.alerts_snapshot())

        def ts_of(e: dict) -> int:
            if e["state"] == "resolved":
                return e["resolved_at_ms"]
            if e["state"] == "firing":
                return e["fired_at_ms"]
            return e["active_since_ms"]

        return RowGroup(
            _ALERTS_SCHEMA,
            {
                "timestamp": np.array(
                    [ts_of(e) for e in entries], dtype=np.int64
                ),
                "rule": np.array([e["rule"] for e in entries], dtype=object),
                "labels": np.array(
                    [_render_labels(e["labels"]) for e in entries], dtype=object
                ),
                "state": np.array([e["state"] for e in entries], dtype=object),
                "value": np.array(
                    [float(e["value"]) for e in entries], dtype=np.float64
                ),
                "active_since": np.array(
                    [e["active_since_ms"] for e in entries], dtype=np.int64
                ),
                "fired_at": np.array(
                    [e["fired_at_ms"] for e in entries], dtype=np.int64
                ),
                "resolved_at": np.array(
                    [e["resolved_at_ms"] for e in entries], dtype=np.int64
                ),
            },
        )


_SLO_SCHEMA = Schema.build(
    [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("objective", DatumKind.STRING, is_nullable=False),
        ColumnSchema("node", DatumKind.STRING),
        ColumnSchema("state", DatumKind.STRING, is_nullable=False),
        ColumnSchema("value", DatumKind.DOUBLE),
        ColumnSchema("bound", DatumKind.DOUBLE),
        ColumnSchema("target", DatumKind.DOUBLE),
        ColumnSchema("burn_fast", DatumKind.DOUBLE),
        ColumnSchema("burn_slow", DatumKind.DOUBLE),
        ColumnSchema("good_fast", DatumKind.DOUBLE),
        ColumnSchema("good_slow", DatumKind.DOUBLE),
        ColumnSchema("breaches", DatumKind.INT64),
        ColumnSchema("since", DatumKind.INT64),
        ColumnSchema("expr", DatumKind.STRING),
    ],
    timestamp_column="timestamp",
    primary_key=["timestamp", "objective"],
)


class SloTable(_VirtualTable):
    """``system.public.slo``: the SLO plane's verdicts as rows, summed
    over every registered SloEvaluator in the process. ``timestamp`` is
    the objective's last evaluation time; ``state`` is ok|burning|
    no_data; ``value`` is the indicator's worst series at that round
    (NaN while no data has ever arrived); burn rates are the sliding
    fast/slow window burn rates against the error budget ``1-target``."""

    @property
    def name(self) -> str:
        return SLO_NAME

    @property
    def schema(self) -> Schema:
        return _SLO_SCHEMA

    def _materialize(self) -> RowGroup:
        from ..slo import registered_evaluators

        entries = []
        for ev in registered_evaluators():
            entries.extend(ev.snapshot())

        def val(e) -> float:
            return float("nan") if e["value"] is None else float(e["value"])

        return RowGroup(
            _SLO_SCHEMA,
            {
                "timestamp": np.array(
                    [e["last_eval_ms"] for e in entries], dtype=np.int64
                ),
                "objective": np.array(
                    [e["name"] for e in entries], dtype=object
                ),
                "node": np.array([e["node"] for e in entries], dtype=object),
                "state": np.array([e["state"] for e in entries], dtype=object),
                "value": np.array([val(e) for e in entries], dtype=np.float64),
                "bound": np.array(
                    [float(e["bound"]) for e in entries], dtype=np.float64
                ),
                "target": np.array(
                    [float(e["target"]) for e in entries], dtype=np.float64
                ),
                "burn_fast": np.array(
                    [float(e["burn_fast"]) for e in entries], dtype=np.float64
                ),
                "burn_slow": np.array(
                    [float(e["burn_slow"]) for e in entries], dtype=np.float64
                ),
                "good_fast": np.array(
                    [float(e["good_fast"]) for e in entries], dtype=np.float64
                ),
                "good_slow": np.array(
                    [float(e["good_slow"]) for e in entries], dtype=np.float64
                ),
                "breaches": np.array(
                    [int(e["breaches"]) for e in entries], dtype=np.int64
                ),
                "since": np.array(
                    [int(e["since_ms"]) for e in entries], dtype=np.int64
                ),
                "expr": np.array([e["expr"] for e in entries], dtype=object),
            },
        )


_QUERIES_SCHEMA = Schema.build(
    [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("query_id", DatumKind.UINT64, is_nullable=False),
        ColumnSchema("request_id", DatumKind.UINT64),
        ColumnSchema("sql", DatumKind.STRING),
        ColumnSchema("tenant", DatumKind.STRING),
        ColumnSchema("protocol", DatumKind.STRING),
        ColumnSchema("class", DatumKind.STRING),
        ColumnSchema("state", DatumKind.STRING),
        ColumnSchema("elapsed_ms", DatumKind.DOUBLE),
        ColumnSchema("deadline_ms", DatumKind.INT64),
        ColumnSchema("remaining_ms", DatumKind.INT64),
        ColumnSchema("cancelled", DatumKind.INT64),
    ],
    timestamp_column="timestamp",
    primary_key=["timestamp", "query_id"],
)


class QueriesTable(_VirtualTable):
    """``system.public.queries``: the live in-flight query registry
    (utils/deadline.QUERY_REGISTRY) — one row per running statement with
    its budget, remaining time, coarse state (running/queued/executing/
    cancelled) and the ``query_id`` that ``KILL QUERY <id>`` /
    ``horaectl query kill`` / ``DELETE /debug/queries/{id}`` target.
    ``remaining_ms`` is -1 for unbounded queries. The statement reading
    this table appears in it too (it is itself a live query)."""

    @property
    def name(self) -> str:
        return QUERIES_NAME

    @property
    def schema(self) -> Schema:
        return _QUERIES_SCHEMA

    def _materialize(self) -> RowGroup:
        from ..utils.deadline import QUERY_REGISTRY

        entries = QUERY_REGISTRY.list()
        return RowGroup(
            _QUERIES_SCHEMA,
            {
                "timestamp": np.array(
                    [int(e["started_ms"]) for e in entries], dtype=np.int64
                ),
                "query_id": np.array(
                    [int(e["query_id"]) for e in entries], dtype=np.uint64
                ),
                "request_id": np.array(
                    [int(e["request_id"] or 0) for e in entries],
                    dtype=np.uint64,
                ),
                "sql": np.array([e["sql"] for e in entries], dtype=object),
                "tenant": np.array(
                    [e["tenant"] for e in entries], dtype=object
                ),
                "protocol": np.array(
                    [e["protocol"] for e in entries], dtype=object
                ),
                "class": np.array(
                    [e["class"] for e in entries], dtype=object
                ),
                "state": np.array(
                    [e["state"] for e in entries], dtype=object
                ),
                "elapsed_ms": np.array(
                    [float(e["elapsed_ms"]) for e in entries],
                    dtype=np.float64,
                ),
                "deadline_ms": np.array(
                    [int(e["deadline_ms"]) for e in entries], dtype=np.int64
                ),
                "remaining_ms": np.array(
                    [int(e["remaining_ms"]) for e in entries], dtype=np.int64
                ),
                "cancelled": np.array(
                    [int(e["cancelled"]) for e in entries], dtype=np.int64
                ),
            },
        )


_DEVICE_SCHEMA = Schema.build(
    [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("table_name", DatumKind.STRING, is_nullable=False),
        ColumnSchema("column_name", DatumKind.STRING),
        ColumnSchema("component", DatumKind.STRING, is_nullable=False),
        ColumnSchema("dtype", DatumKind.STRING),
        ColumnSchema("bytes", DatumKind.INT64),
        ColumnSchema("rows", DatumKind.INT64),
        ColumnSchema("last_hit_age_ms", DatumKind.INT64),
        ColumnSchema("evictions", DatumKind.INT64),
        # compressed-layout inventory: the resident encoding
        # (raw|bf16|dict8|dict16|delta) and the LOGICAL rows the encoded
        # bytes serve — rows-per-HBM-byte reads straight off this table
        ColumnSchema("encoding", DatumKind.STRING),
        ColumnSchema("logical_rows", DatumKind.INT64),
    ],
    timestamp_column="timestamp",
    primary_key=["timestamp", "table_name", "column_name", "component"],
)


class DeviceTable(_VirtualTable):
    """``system.public.device``: per-(table, column, dtype) HBM residency
    from the device telemetry plane (obs/device) — resident bytes, row
    counts, last-hit age, per-table eviction counts. ``component``
    distinguishes the scan cache's resident columns (whose bytes sum to
    its internal ``device_bytes`` accounting) from session uploads
    and zero-byte rows for evicted tables. ``last_hit_age_ms`` is -1
    when the entry was never served."""

    @property
    def name(self) -> str:
        return DEVICE_NAME

    @property
    def schema(self) -> Schema:
        return _DEVICE_SCHEMA

    def _materialize(self) -> RowGroup:
        import time

        from ..obs.device import device_inventory

        entries = device_inventory()
        now = int(time.time() * 1000)
        n = len(entries)
        return RowGroup(
            _DEVICE_SCHEMA,
            {
                "timestamp": np.full(n, now, dtype=np.int64),
                "table_name": np.array(
                    [str(e.get("table_name", "")) for e in entries],
                    dtype=object,
                ),
                "column_name": np.array(
                    [str(e.get("column_name", "")) for e in entries],
                    dtype=object,
                ),
                "component": np.array(
                    [str(e.get("component", "")) for e in entries],
                    dtype=object,
                ),
                "dtype": np.array(
                    [str(e.get("dtype", "")) for e in entries], dtype=object
                ),
                "bytes": np.array(
                    [int(e.get("bytes", 0)) for e in entries], dtype=np.int64
                ),
                "rows": np.array(
                    [int(e.get("rows", 0)) for e in entries], dtype=np.int64
                ),
                "last_hit_age_ms": np.array(
                    [int(e.get("last_hit_age_ms", -1)) for e in entries],
                    dtype=np.int64,
                ),
                "evictions": np.array(
                    [int(e.get("evictions", 0)) for e in entries],
                    dtype=np.int64,
                ),
                "encoding": np.array(
                    [str(e.get("encoding", "")) for e in entries],
                    dtype=object,
                ),
                "logical_rows": np.array(
                    [int(e.get("logical_rows", 0)) for e in entries],
                    dtype=np.int64,
                ),
            },
        )


_DECISIONS_SCHEMA = Schema.build(
    [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("id", DatumKind.UINT64, is_nullable=False),
        ColumnSchema("loop", DatumKind.STRING, is_nullable=False),
        ColumnSchema("decision_key", DatumKind.STRING),
        ColumnSchema("choice", DatumKind.STRING),
        ColumnSchema("features", DatumKind.STRING),
        ColumnSchema("predicted", DatumKind.DOUBLE),
        ColumnSchema("resolved", DatumKind.BOOLEAN),
        ColumnSchema("resolved_at", DatumKind.INT64),
        ColumnSchema("actual", DatumKind.DOUBLE),
        ColumnSchema("outcome", DatumKind.STRING),
        ColumnSchema("error", DatumKind.DOUBLE),
        ColumnSchema("trace_id", DatumKind.UINT64),
    ],
    timestamp_column="timestamp",
    primary_key=["timestamp", "id"],
)


class DecisionsTable(_VirtualTable):
    """``system.public.decisions``: the decision journal as rows — one
    per adaptive-loop decision with the choice, features-at-decision-
    time (sorted-key JSON like events.attrs), the predicted value, and
    — once resolved — the realized outcome and relative error. NULL
    ``predicted``/``actual``/``error`` mean "not numeric-graded";
    ``outcome='expired'`` rows aged out or were evicted unresolved."""

    @property
    def name(self) -> str:
        return DECISIONS_NAME

    @property
    def schema(self) -> Schema:
        return _DECISIONS_SCHEMA

    def _materialize(self) -> RowGroup:
        from ..obs.decisions import DECISION_JOURNAL
        from ..utils.events import render_attrs

        entries = DECISION_JOURNAL.list()

        def tid(e) -> int:
            try:
                return int(e["trace_id"] or 0)
            except (TypeError, ValueError):
                return 0

        def opt(field) -> tuple[np.ndarray, np.ndarray]:
            vals = np.array(
                [
                    0.0 if e[field] is None else float(e[field])
                    for e in entries
                ],
                dtype=np.float64,
            )
            mask = np.array(
                [e[field] is not None for e in entries], dtype=bool
            )
            return vals, mask

        predicted, predicted_ok = opt("predicted")
        actual, actual_ok = opt("actual")
        error, error_ok = opt("error")
        return RowGroup(
            _DECISIONS_SCHEMA,
            {
                "timestamp": np.array(
                    [e["timestamp"] for e in entries], dtype=np.int64
                ),
                "id": np.array([e["id"] for e in entries], dtype=np.uint64),
                "loop": np.array([e["loop"] for e in entries], dtype=object),
                "decision_key": np.array(
                    [e["key"] for e in entries], dtype=object
                ),
                "choice": np.array(
                    [e["choice"] for e in entries], dtype=object
                ),
                "features": np.array(
                    [render_attrs(e["features"]) for e in entries],
                    dtype=object,
                ),
                "predicted": predicted,
                "resolved": np.array(
                    [bool(e["resolved"]) for e in entries], dtype=bool
                ),
                "resolved_at": np.array(
                    [int(e["resolved_at"] or 0) for e in entries],
                    dtype=np.int64,
                ),
                "actual": actual,
                "outcome": np.array(
                    [e["outcome"] for e in entries], dtype=object
                ),
                "error": error,
                "trace_id": np.array(
                    [tid(e) for e in entries], dtype=np.uint64
                ),
            },
            validity={
                "predicted": predicted_ok,
                "actual": actual_ok,
                "error": error_ok,
            },
        )


_CALIBRATION_SCHEMA = Schema.build(
    [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("loop", DatumKind.STRING, is_nullable=False),
        ColumnSchema("samples", DatumKind.INT64),
        ColumnSchema("ewma_signed", DatumKind.DOUBLE),
        ColumnSchema("ewma_abs", DatumKind.DOUBLE),
        ColumnSchema("fast_signed", DatumKind.DOUBLE),
        ColumnSchema("fast_abs", DatumKind.DOUBLE),
        ColumnSchema("fast_n", DatumKind.INT64),
        ColumnSchema("slow_signed", DatumKind.DOUBLE),
        ColumnSchema("slow_abs", DatumKind.DOUBLE),
        ColumnSchema("slow_n", DatumKind.INT64),
        ColumnSchema("miscalibrated", DatumKind.BOOLEAN),
        ColumnSchema("issued", DatumKind.INT64),
        ColumnSchema("resolved", DatumKind.INT64),
        ColumnSchema("expired", DatumKind.INT64),
        ColumnSchema("missed", DatumKind.INT64),
        ColumnSchema("unresolved", DatumKind.INT64),
    ],
    timestamp_column="timestamp",
    primary_key=["timestamp", "loop"],
)


class CalibrationTable(_VirtualTable):
    """``system.public.calibration``: one row per adaptive loop with the
    decision plane's grading (relative-error EWMA + fast/slow window
    means; NULL until the loop has a graded sample) and the exact
    accounting ledger — ``issued == resolved + expired + unresolved``
    holds on every read, the reconciliation the tenantsim gate asserts
    from this table."""

    @property
    def name(self) -> str:
        return CALIBRATION_NAME

    @property
    def schema(self) -> Schema:
        return _CALIBRATION_SCHEMA

    def _materialize(self) -> RowGroup:
        import time

        from ..obs.decisions import DECISION_JOURNAL

        rows = DECISION_JOURNAL.calibration()
        now = int(time.time() * 1000)
        n = len(rows)

        def opt(field) -> tuple[np.ndarray, np.ndarray]:
            vals = np.array(
                [
                    0.0 if r[field] is None else float(r[field])
                    for r in rows
                ],
                dtype=np.float64,
            )
            mask = np.array([r[field] is not None for r in rows], dtype=bool)
            return vals, mask

        cols: dict = {
            "timestamp": np.full(n, now, dtype=np.int64),
            "loop": np.array([r["loop"] for r in rows], dtype=object),
            "miscalibrated": np.array(
                [bool(r["miscalibrated"]) for r in rows], dtype=bool
            ),
        }
        for f in ("samples", "fast_n", "slow_n", "issued", "resolved",
                  "expired", "missed", "unresolved"):
            cols[f] = np.array([int(r[f]) for r in rows], dtype=np.int64)
        validity = {}
        for f in ("ewma_signed", "ewma_abs", "fast_signed", "fast_abs",
                  "slow_signed", "slow_abs"):
            cols[f], validity[f] = opt(f)
        return RowGroup(_CALIBRATION_SCHEMA, cols, validity=validity)


_PROFILE_SCHEMA = Schema.build(
    [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("path", DatumKind.STRING, is_nullable=False),
        ColumnSchema("route", DatumKind.STRING),
        ColumnSchema("shape", DatumKind.STRING),
        ColumnSchema("count", DatumKind.INT64),
        ColumnSchema("total_ms", DatumKind.DOUBLE),
        ColumnSchema("exclusive_ms", DatumKind.DOUBLE),
        ColumnSchema("ewma_ms", DatumKind.DOUBLE),
        ColumnSchema("fast_ms", DatumKind.DOUBLE),
        ColumnSchema("fast_n", DatumKind.INT64),
        ColumnSchema("slow_ms", DatumKind.DOUBLE),
        ColumnSchema("slow_n", DatumKind.INT64),
        ColumnSchema("trace_id", DatumKind.STRING),
    ],
    timestamp_column="timestamp",
    primary_key=["timestamp", "path"],
)


class ProfileTable(_VirtualTable):
    """``system.public.profile``: the streaming profile aggregator as
    rows — one per live (path, route, shape) key, exclusive-heavy
    first. ``timestamp`` is the key's last fold; ``trace_id`` the last
    exemplar (join against system.public.traces or /debug/trace/{id}).
    The ``<root>/(untracked)`` rows are the accounting remainder —
    ``sum(exclusive_ms)`` over a root's non-root paths equals the
    root's ``total_ms`` exactly (the fold invariant)."""

    @property
    def name(self) -> str:
        return PROFILE_NAME

    @property
    def schema(self) -> Schema:
        return _PROFILE_SCHEMA

    def _materialize(self) -> RowGroup:
        from ..obs.profile import PROFILE

        rows = PROFILE.list()

        def opt(field) -> tuple[np.ndarray, np.ndarray]:
            vals = np.array(
                [0.0 if r[field] is None else float(r[field]) for r in rows],
                dtype=np.float64,
            )
            mask = np.array([r[field] is not None for r in rows], dtype=bool)
            return vals, mask

        ewma, ewma_ok = opt("ewma_ms")
        return RowGroup(
            _PROFILE_SCHEMA,
            {
                "timestamp": np.array(
                    [int(r["last_at"] * 1000) for r in rows], dtype=np.int64
                ),
                "path": np.array([r["path"] for r in rows], dtype=object),
                "route": np.array([r["route"] for r in rows], dtype=object),
                "shape": np.array([r["shape"] for r in rows], dtype=object),
                "count": np.array(
                    [int(r["count"]) for r in rows], dtype=np.int64
                ),
                "total_ms": np.array(
                    [float(r["total_ms"]) for r in rows], dtype=np.float64
                ),
                "exclusive_ms": np.array(
                    [float(r["exclusive_ms"]) for r in rows],
                    dtype=np.float64,
                ),
                "ewma_ms": ewma,
                "fast_ms": np.array(
                    [float(r["fast_ms"]) for r in rows], dtype=np.float64
                ),
                "fast_n": np.array(
                    [int(r["fast_n"]) for r in rows], dtype=np.int64
                ),
                "slow_ms": np.array(
                    [float(r["slow_ms"]) for r in rows], dtype=np.float64
                ),
                "slow_n": np.array(
                    [int(r["slow_n"]) for r in rows], dtype=np.int64
                ),
                "trace_id": np.array(
                    [str(r["last_trace_id"]) for r in rows], dtype=object
                ),
            },
            validity={"ewma_ms": ewma_ok},
        )


_TRACES_SCHEMA = Schema.build(
    [
        ColumnSchema("timestamp", DatumKind.TIMESTAMP, is_nullable=False),
        ColumnSchema("trace_id", DatumKind.STRING, is_nullable=False),
        ColumnSchema("name", DatumKind.STRING, is_nullable=False),
        ColumnSchema("duration_ms", DatumKind.DOUBLE),
        ColumnSchema("spans", DatumKind.INT64),
        ColumnSchema("slow", DatumKind.BOOLEAN),
    ],
    timestamp_column="timestamp",
    primary_key=["timestamp", "trace_id"],
)


class TracesTable(_VirtualTable):
    """``system.public.traces``: the bounded in-process trace store as
    rows (newest first in the underlying listing, dedup'd across the
    recent and slow rings). ``timestamp`` is the trace's start;
    ``trace_id`` joins /debug/trace/{id} and the profile plane's
    exemplars."""

    @property
    def name(self) -> str:
        return TRACES_NAME

    @property
    def schema(self) -> Schema:
        return _TRACES_SCHEMA

    def _materialize(self) -> RowGroup:
        from ..utils.tracectx import TRACE_STORE

        rows = TRACE_STORE.list()
        return RowGroup(
            _TRACES_SCHEMA,
            {
                "timestamp": np.array(
                    [int(float(r["at"]) * 1000) for r in rows],
                    dtype=np.int64,
                ),
                "trace_id": np.array(
                    [str(r["trace_id"]) for r in rows], dtype=object
                ),
                "name": np.array([r["name"] for r in rows], dtype=object),
                "duration_ms": np.array(
                    [float(r["duration_ms"] or 0.0) for r in rows],
                    dtype=np.float64,
                ),
                "spans": np.array(
                    [int(r["spans"]) for r in rows], dtype=np.int64
                ),
                "slow": np.array(
                    [bool(r["slow"]) for r in rows], dtype=bool
                ),
            },
        )


def open_system_table(catalog, name: str):
    """The catalog's virtual-table hook: a Table for system names, else
    None (regular resolution proceeds)."""
    low = name.lower()
    if low == TABLES_NAME:
        return SystemTablesTable(catalog)
    if low == QUERY_STATS_NAME:
        return QueryStatsTable()
    if low == METRICS_NAME:
        return MetricsTable()
    if low == WORKLOAD_NAME:
        return WorkloadTable()
    if low == EVENTS_NAME:
        return EventsTable()
    if low == ALERTS_NAME:
        return AlertsTable()
    if low == SLO_NAME:
        return SloTable()
    if low == QUERIES_NAME:
        return QueriesTable()
    if low == DEVICE_NAME:
        return DeviceTable()
    if low == DECISIONS_NAME:
        return DecisionsTable()
    if low == CALIBRATION_NAME:
        return CalibrationTable()
    if low == PROFILE_NAME:
        return ProfileTable()
    if low == TRACES_NAME:
        return TracesTable()
    return None
