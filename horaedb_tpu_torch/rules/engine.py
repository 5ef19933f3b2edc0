"""Continuous-query engine: recording rules, tiered rollups, alerting
(ref: prometheus's rule evaluator, re-homed INSIDE the database — the
PR-5 self-monitoring recorder is the template: a ``PeriodicLoop`` that
writes through the normal ingest path under nonblocking backpressure,
node-labeled rows, and non-owner forwarding; StreamBox-HBM's continuous
queries over hybrid memory are the design stance, PAPERS.md).

One ``RuleEngine`` per node runs every ``[rules] eval_interval``:

- **rollups** — each ``rollup_tables`` entry gets a RollupMaintainer
  (rules/rollup.py): raw -> 1m -> 1h with TTL laddering and the
  watermark/catch-up protocol; the query layer transparently serves
  step-compatible range queries from the tiers (rules/rewrite.py,
  ``route=rollup``);
- **recording rules** — PromQL expressions instant-evaluated and written
  as rows of a REAL table named after the rule (labels folded into a
  ``labels`` string tag like ``system_metrics.samples``; the PromQL
  layer lifts them back so matchers on result labels keep working);
- **alert rules** — PromQL threshold expressions (the comparison
  operators: ``rate(errors[1m]) > 5``) driving a per-series
  pending -> firing -> resolved state machine with a ``for`` duration,
  journaled as typed ``alert_fired``/``alert_resolved`` events (trace
  linked) and served as ``system.public.alerts`` on every wire.

Rules come from the ``[rules]`` config section and from the runtime
``/admin/rules`` endpoint; runtime rules and rollup watermarks persist
in ``<data_dir>/rules_state.json`` beside ``wlm_state.json``. Cluster
discipline: a rule evaluates only on the node that OWNS its source
tables (eval-on-owner — every node loads the same config, exactly one
evaluates each rule); output tables that route elsewhere are forwarded
to the owner through the ordinary ``/write`` path.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Optional

from ..common_types import ColumnSchema, DatumKind, RowGroup, Schema
from ..engine.maintenance_scheduler import PeriodicLoop
from ..engine.metrics_recorder import forward_rows
from ..engine.options import TableOptions
from ..utils.events import record_event
from ..utils.metrics import REGISTRY, _render_labels
from .model import Rule, RuleError, parse_rule_line, rule_from_dict
from .rollup import ROLLUPS, RollupMaintainer, rollup_table_name

logger = logging.getLogger("horaedb_tpu_torch.rules")

STATE_FILE = "rules_state.json"

# Declared registry of the rules/alerts metric families — the lint in
# tests/test_observability.py checks each is registered live,
# convention-clean, and documented in docs/OBSERVABILITY.md, and that no
# stray horaedb_rules_* / horaedb_alerts_* family exists outside it.
RULES_METRIC_FAMILIES = (
    "horaedb_rules_eval_total",
    "horaedb_rules_eval_failures_total",
    "horaedb_rules_eval_duration_seconds",
    "horaedb_rules_rows_total",
    "horaedb_rules_loaded_total",
    "horaedb_rules_watermark_lag_seconds",
    "horaedb_alerts_pending_total",
    "horaedb_alerts_firing_total",
    "horaedb_alerts_fired_total",
    "horaedb_alerts_resolved_total",
)

RULE_EVAL_KINDS = ("recording", "alert", "rollup")

# Eager registration: series exist from the first scrape and for the lint.
_M_EVAL = {
    k: REGISTRY.counter(
        "horaedb_rules_eval_total",
        "rule evaluations by kind (recording|alert|rollup)",
        labels={"kind": k},
    )
    for k in RULE_EVAL_KINDS
}
_M_EVAL_FAILURES = REGISTRY.counter(
    "horaedb_rules_eval_failures_total",
    "rule evaluations that raised (per rule, isolated per round)",
)
_M_EVAL_SECONDS = REGISTRY.histogram(
    "horaedb_rules_eval_duration_seconds",
    "wall time of one full rule-evaluation round",
)
_M_ROWS = REGISTRY.counter(
    "horaedb_rules_rows_total",
    "rows written by recording rules and rollup maintenance",
)
_M_LOADED = REGISTRY.gauge(
    "horaedb_rules_loaded_total",
    "rules currently loaded (config + runtime)",
)
_M_WM_LAG = REGISTRY.gauge(
    "horaedb_rules_watermark_lag_seconds",
    "worst rollup watermark lag behind now across maintained tiers",
)
_M_PENDING = REGISTRY.gauge(
    "horaedb_alerts_pending_total", "alert series currently pending"
)
_M_FIRING = REGISTRY.gauge(
    "horaedb_alerts_firing_total", "alert series currently firing"
)
_M_FIRED = REGISTRY.counter(
    "horaedb_alerts_fired_total", "pending -> firing transitions"
)
_M_RESOLVED = REGISTRY.counter(
    "horaedb_alerts_resolved_total", "firing -> resolved transitions"
)

_BACKOFF_CAP_S = 300.0

# Engines register here so system.public.alerts (table_engine/system.py)
# can materialize current alert state without a handle on the server.
_ENGINES: "weakref.WeakSet[RuleEngine]" = weakref.WeakSet()


def registered_engines() -> list["RuleEngine"]:
    return list(_ENGINES)


@dataclass
class AlertInstance:
    """One alert series' live state."""

    rule: str
    labels: dict[str, str]
    state: str  # "pending" | "firing" | "resolved"
    value: float
    active_since_ms: int
    fired_at_ms: int = 0
    resolved_at_ms: int = 0

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "labels": dict(self.labels),
            "state": self.state,
            "value": self.value,
            "active_since_ms": self.active_since_ms,
            "fired_at_ms": self.fired_at_ms,
            "resolved_at_ms": self.resolved_at_ms,
        }


def recording_schema() -> Schema:
    """A recording rule's output table: the samples-table shape minus the
    family tag (the table name IS the metric name). The folded ``labels``
    tag is what the PromQL layer lifts back into first-class labels."""
    return Schema.build(
        [
            ColumnSchema("labels", DatumKind.STRING, is_tag=True),
            ColumnSchema("node", DatumKind.STRING, is_tag=True),
            ColumnSchema("value", DatumKind.DOUBLE),
            ColumnSchema("ts", DatumKind.TIMESTAMP),
        ],
        timestamp_column="ts",
    )


def _recording_create_sql(name: str, ttl_s: float) -> str:
    """The forwarded-DDL form of recording_schema() — what a non-owner
    sends the owning node before forwarding rows."""
    opts = "update_mode='append', segment_duration='2h'"
    if ttl_s > 0:
        opts += f", enable_ttl='true', ttl='{max(1, int(ttl_s))}s'"
    return (
        f"CREATE TABLE IF NOT EXISTS {name} (labels string TAG, "
        "node string TAG, value double, ts timestamp NOT NULL, "
        f"TIMESTAMP KEY(ts)) ENGINE=Analytic WITH ({opts})"
    )


class RuleEngine:
    """Background continuous-query loop over a Connection."""

    def __init__(
        self,
        conn,
        section=None,
        node: str = "standalone",
        router=None,
        state_path: Optional[str] = None,
        cluster=None,
        slo=None,
    ) -> None:
        """``cluster`` (coordinator mode): output-table DDL is serialized
        through the coordinator (``cluster.meta.create_table``) instead
        of the local catalog — local creation would mint colliding table
        ids in the shared store — and ownership questions ask the live
        shard set, not the router's meta-unknown fallback.
        ``slo``: an slo.SloEvaluator ticked at the end of every round —
        the SLO plane rides THIS cadence by design (no second loop to
        drift against the rules/alerts it judges)."""
        from ..utils.config import RulesSection

        self.conn = conn
        self.section = section if section is not None else RulesSection()
        self.node = node
        self.router = router
        self.cluster = cluster
        self.slo = slo
        if state_path is None:
            root = getattr(conn.store, "root", None)
            if root:
                state_path = os.path.join(root, STATE_FILE)
        self.state_path = state_path
        self.interval_s = max(0.05, float(self.section.eval_interval_s))
        self.rules: dict[str, Rule] = {}
        self._parsed: dict[str, object] = {}  # name -> PromExpr
        # per-rule cadence bookkeeping (Rule.every_s): name -> last eval
        # wall-clock ms; a rule is due when now - last >= every_s
        self._rule_last_eval_ms: dict[str, int] = {}
        self.rollup_sources: list[str] = list(self.section.rollup_tables)
        self._maintainers: dict[str, RollupMaintainer] = {}
        self._wm_seed: dict[str, dict[str, int]] = {}  # source -> suffix -> ms
        # alert book: rule -> labelkey -> AlertInstance; recently-resolved
        # ring for the alerts table
        self._alerts: dict[str, dict[tuple, AlertInstance]] = {}
        self._resolved: deque = deque(maxlen=64)
        self._alerts_lock = threading.Lock()
        self.loaded = False
        self.rounds = 0
        self.rows_written = 0
        self.last_eval_ms = 0
        self.last_errors: dict[str, str] = {}
        self._fails = 0
        self._backoff_until = 0.0
        # remote tables whose CREATE IF NOT EXISTS already succeeded —
        # without this every round re-forwards idempotent DDL (a 10s
        # urllib round-trip per output table per eval_interval, forever)
        self._remote_ensured: set[str] = set()
        self._loop: Optional[PeriodicLoop] = None
        self._state_lock = threading.Lock()
        # rule-eval trace ids: high base so they can't collide with the
        # proxy's per-request counter in the trace store
        self._trace_ids = itertools.count((1 << 40) + (os.getpid() << 16))
        for line in self.section.recording:
            self._add(parse_rule_line(line, "recording", source="config"))
        for line in self.section.alerts:
            self._add(parse_rule_line(line, "alert", source="config"))
        _ENGINES.add(self)

    # ---- lifecycle ------------------------------------------------------

    def _add(self, rule: Rule) -> Rule:
        from ..proxy.promql import parse_promql

        self.rules[rule.name] = rule
        self._parsed[rule.name] = parse_promql(rule.expr)
        _M_LOADED.set(len(self.rules))
        return rule

    def load(self) -> "RuleEngine":
        """Load runtime rules + persisted watermarks; readiness
        (``/health?ready=1``) gates on this completing."""
        if self.state_path and os.path.exists(self.state_path):
            try:
                with open(self.state_path, "r", encoding="utf-8") as f:
                    data = json.load(f)
                for d in data.get("rules", []):
                    try:
                        self._add(rule_from_dict(d, source="runtime"))
                    except RuleError as e:
                        logger.warning("skipping persisted rule: %s", e)
                for key, ms in (data.get("watermarks") or {}).items():
                    source, _, suffix = key.rpartition("|")
                    if source:
                        self._wm_seed.setdefault(source, {})[suffix] = int(ms)
            except (OSError, ValueError) as e:
                logger.warning(
                    "could not load rules state %s: %s", self.state_path, e
                )
        self.loaded = True
        _M_LOADED.set(len(self.rules))
        return self

    def start(self) -> "RuleEngine":
        if self._loop is not None:
            return self
        if not self.loaded:
            self.load()
        ref = weakref.WeakMethod(self.tick)

        def tick():
            fn = ref()
            if fn is None:
                return False
            fn()
            return True

        self._loop = PeriodicLoop(self.interval_s, tick, "rules-eval").start()
        return self

    def close(self) -> None:
        if self._loop is not None:
            self._loop.close()
            self._loop = None

    # ---- admin surface --------------------------------------------------

    def add_rule(self, d: dict) -> Rule:
        rule = rule_from_dict(d, source="runtime")
        existing = self.rules.get(rule.name)
        if existing is not None and existing.source == "config":
            raise RuleError(
                f"rule {rule.name!r} is config-defined; edit the [rules] "
                "section instead"
            )
        self._add(rule)
        self._save_state()
        return rule

    def remove_rule(self, name: str) -> bool:
        rule = self.rules.get(name)
        if rule is None:
            return False
        if rule.source == "config":
            raise RuleError(
                f"rule {name!r} is config-defined; remove it from the "
                "[rules] section instead"
            )
        del self.rules[name]
        self._parsed.pop(name, None)
        self._rule_last_eval_ms.pop(name, None)
        with self._alerts_lock:
            self._alerts.pop(name, None)
        self.last_errors.pop(name, None)
        _M_LOADED.set(len(self.rules))
        self._save_state()
        return True

    def list_rules(self) -> list[dict]:
        out = []
        for rule in self.rules.values():
            d = rule.to_dict()
            d["last_error"] = self.last_errors.get(rule.name, "")
            out.append(d)
        return sorted(out, key=lambda d: d["name"])

    def alerts_snapshot(self) -> list[dict]:
        """Live pending/firing instances plus the recently-resolved ring
        (newest last) — /debug/alerts and system.public.alerts."""
        with self._alerts_lock:
            live = [
                inst.to_dict()
                for book in self._alerts.values()
                for inst in book.values()
            ]
            done = [inst.to_dict() for inst in self._resolved]
        return sorted(done + live, key=lambda d: (d["rule"], sorted(d["labels"].items())))

    def stats(self) -> dict:
        with self._alerts_lock:
            pending = sum(
                1
                for book in self._alerts.values()
                for i in book.values()
                if i.state == "pending"
            )
            firing = sum(
                1
                for book in self._alerts.values()
                for i in book.values()
                if i.state == "firing"
            )
        return {
            "enabled": bool(self.section.enabled),
            "loaded": self.loaded,
            "running": self._loop is not None and self._loop.is_alive(),
            "interval_s": self.interval_s,
            "rules_loaded": len(self.rules),
            "recording": sum(1 for r in self.rules.values() if r.kind == "recording"),
            "alerts": sum(1 for r in self.rules.values() if r.kind == "alert"),
            "rollup_tables": list(self.rollup_sources),
            "rounds": self.rounds,
            "rows_written": self.rows_written,
            "last_eval_ms": self.last_eval_ms,
            "consecutive_failures": self._fails,
            "backoff_s": round(max(0.0, self._backoff_until - time.monotonic()), 2),
            "watermark_lag_s": self._watermark_lag_s(),
            "alerts_pending": pending,
            "alerts_firing": firing,
            "last_errors": dict(self.last_errors),
        }

    def _watermark_lag_s(self) -> Optional[float]:
        now_ms = time.time() * 1000
        worst = None
        for m in self._maintainers.values():
            for ms in m.state.watermarks().values():
                lag = (now_ms - ms) / 1000.0
                if worst is None or lag > worst:
                    worst = lag
        return round(worst, 3) if worst is not None else None

    # ---- one round ------------------------------------------------------

    def tick(self) -> None:
        """One periodic firing: honor failure backoff, evaluate, never
        raise (the loop keeps ticking through shed rounds)."""
        now = time.monotonic()
        if now < self._backoff_until:
            return
        from ..wlm.admission import OverloadedError

        try:
            self.run_once()
        except OverloadedError as e:
            self._note_skip("write_stall", str(e))
            return
        except Exception as e:
            self._note_skip("error", str(e))
            return
        self._fails = 0

    def _note_skip(self, reason: str, msg: str) -> None:
        self._fails += 1
        delay = min(self.interval_s * (2 ** self._fails), _BACKOFF_CAP_S)
        self._backoff_until = time.monotonic() + delay
        _M_EVAL_FAILURES.inc()
        record_event(
            "rule_eval_failed", table="",
            rule="(round)", reason=reason, error=msg[:200],
            backoff_s=round(delay, 2),
        )
        logger.warning(
            "rules eval round skipped (%s); backing off %.1fs: %s",
            reason, delay, msg,
        )

    def run_once(self, now_ms: Optional[int] = None) -> None:
        """One full evaluation round under its own trace (so the typed
        alert events cross-link to a stored span tree). Per-rule errors
        are isolated; a backpressure shed (OverloadedError) propagates —
        ``tick`` owns that backoff policy."""
        from ..utils.tracectx import finish_trace, start_trace, tag_trace
        from ..wlm.admission import OverloadedError

        t0 = time.perf_counter()
        now_ms = int(time.time() * 1000) if now_ms is None else now_ms
        trace_id = next(self._trace_ids)
        _trace, handle = start_trace(trace_id, "rules-eval", node=self.node)
        tag_trace(route="rules")
        wm_dirty = False
        try:
            for source in self.rollup_sources:
                if not self._owns(source):
                    continue
                try:
                    from ..utils.tracectx import span as _span

                    m = self._maintainer(source)
                    with _span("rollup", source=source):
                        written = m.run_once(now_ms)
                    if written:
                        self.rows_written += written
                        _M_ROWS.inc(written)
                        wm_dirty = True
                    _M_EVAL["rollup"].inc()
                    self.last_errors.pop(source, None)
                except OverloadedError:
                    raise
                except Exception as e:
                    self._note_rule_error(source, "rollup", e)
            for rule in list(self.rules.values()):
                # snapshot the parsed expr: a concurrent /admin/rules
                # DELETE may race this round (skip, don't abort the
                # round — per-rule isolation must cover the lookup too)
                parsed = self._parsed.get(rule.name)
                if parsed is None:
                    continue
                try:
                    if not self._rule_due(rule, now_ms):
                        continue
                    if not self._rule_local(rule, parsed):
                        continue
                    from ..utils.tracectx import span as _span

                    with _span(rule.kind, rule=rule.name):
                        if rule.kind == "recording":
                            self._eval_recording(rule, parsed, now_ms)
                        else:
                            self._eval_alert(rule, parsed, now_ms)
                    self._rule_last_eval_ms[rule.name] = now_ms
                    _M_EVAL[rule.kind].inc()
                    self.last_errors.pop(rule.name, None)
                except OverloadedError:
                    raise
                except Exception as e:
                    self._note_rule_error(rule.name, rule.kind, e)
        finally:
            if self.slo is not None and self._owns_samples():
                # the SLO plane rides this cadence ON THE NODE OWNING the
                # samples history its indicators read (eval-on-owner, the
                # same discipline rules use — a non-owner's local view of
                # system_metrics.samples is flushed-only, stale by up to
                # the flush lag). evaluate_round only READS and isolates
                # its own per-objective errors, so it runs even on rounds
                # a rule write shed — the verdict must not pause because
                # ingest stalled (that stall is exactly what it judges)
                self.slo.evaluate_round(now_ms)
            finish_trace(handle)
            self.rounds += 1
            self.last_eval_ms = now_ms
            lag = self._watermark_lag_s()
            if lag is not None:
                _M_WM_LAG.set(lag)
            with self._alerts_lock:
                _M_PENDING.set(sum(
                    1 for b in self._alerts.values()
                    for i in b.values() if i.state == "pending"
                ))
                _M_FIRING.set(sum(
                    1 for b in self._alerts.values()
                    for i in b.values() if i.state == "firing"
                ))
            _M_EVAL_SECONDS.observe(time.perf_counter() - t0)
        if wm_dirty:
            self._save_state()

    def _rule_due(self, rule: Rule, now_ms: int) -> bool:
        """Per-rule cadence gate (Rule.every_s; 0 = every round). A tiny
        epsilon absorbs loop-tick jitter so ``every = eval_interval``
        still evaluates every round instead of every other one."""
        if rule.every_s <= 0:
            return True
        last = self._rule_last_eval_ms.get(rule.name)
        if last is None:
            return True
        return (now_ms - last) >= rule.every_s * 1000 - 50

    def _note_rule_error(self, name: str, kind: str, e: Exception) -> None:
        self.last_errors[name] = f"{type(e).__name__}: {e}"[:200]
        _M_EVAL_FAILURES.inc()
        # NB: ``kind`` is record_event's own first argument — the rule's
        # kind ships as rule_kind (the same collision quota_reject hit)
        record_event(
            "rule_eval_failed", table="",
            rule=name, rule_kind=kind, error=str(e)[:200],
        )
        logger.warning("rule %s (%s) evaluation failed: %s", name, kind, e)

    # ---- ownership (eval-on-owner) --------------------------------------

    def _owns_samples(self) -> bool:
        from ..engine.metrics_recorder import SAMPLES_TABLE

        return self._owns(SAMPLES_TABLE)

    def _owns(self, table: str) -> bool:
        if self.cluster is not None:
            # ask the live shard set, not the router: the router answers
            # is_local=True for meta-UNKNOWN tables (standalone fallback),
            # which here would make every node think it owns a
            # not-yet-created output table
            return self.cluster.owns_table(table)
        if self.router is None:
            return True
        return self.router.route(table).is_local

    def _rule_local(self, rule: Rule, parsed) -> bool:
        """A rule evaluates on the node owning ALL of its leaf source
        tables (a metric resolving to the samples fallback routes on
        where system_metrics.samples lives — the same predicate HTTP prom
        routing uses, so the evaluating node can actually read it)."""
        if self.router is None:
            return True
        from ..engine.metrics_recorder import SAMPLES_TABLE
        from ..proxy.promql import leaf_metrics, resolves_to_samples

        for m in set(leaf_metrics(parsed)):
            key = SAMPLES_TABLE if resolves_to_samples(self.conn, m) else m
            if not self._owns(key):
                return False
        return True

    # ---- rollups --------------------------------------------------------

    def _maintainer(self, source: str) -> RollupMaintainer:
        m = self._maintainers.get(source)
        if m is None:
            m = RollupMaintainer(
                self.conn,
                source,
                grace_ms=int(self.section.grace_s * 1000),
                raw_ttl_s=self.section.rollup_raw_ttl_s,
                tier_ttl_s={
                    "1m": self.section.rollup_1m_ttl_s,
                    "1h": self.section.rollup_1h_ttl_s,
                },
                write_rows=self._write_rollup_rows,
                ensure_table=self._ensure_rollup_table,
            )
            for suffix, ms in self._wm_seed.get(source, {}).items():
                # persisted watermark never overrides a LIVE registry
                # state that is already ahead (another engine round)
                cur = m.state.watermark(suffix)
                if cur is None or ms > cur:
                    m.state.set_watermark(suffix, ms)
            self._maintainers[source] = m
        return m

    def _ensure_rollup_table(self, name: str, schema, options) -> None:
        if self.cluster is not None:
            # coordinator mode: the COORDINATOR places the table and
            # allocates its id (local creation would mint colliding
            # sequential ids in the shared store — the reason rules were
            # disabled in this mode before the SLO plane needed them)
            self._ensure_meta_table(name, _create_sql_for(name, schema, options))
            if self._owns(name):
                table = self.conn.catalog.open(name)
                if table is not None:
                    from .rollup import _sync_ttl

                    _sync_ttl(
                        table,
                        (options.ttl_ms / 1000.0) if options.enable_ttl else 0.0,
                    )
            return
        if self._owns(name):
            table = self.conn.catalog.open(name)
            if table is None:
                self.conn.catalog.create_table(
                    name, schema, options, if_not_exists=True
                )
            else:
                from .rollup import _sync_ttl

                _sync_ttl(
                    table,
                    (options.ttl_ms / 1000.0) if options.enable_ttl else 0.0,
                )
            return
        # non-owner: the owning node must hold the table — forward the
        # DDL as ordinary SQL (IF NOT EXISTS makes it idempotent)
        self._forward_sql(name, _create_sql_for(name, schema, options))

    def _write_rollup_rows(self, table_name: str, rows: list[dict]) -> None:
        if self._owns(table_name):
            table = self.conn.catalog.open(table_name)
            rg = RowGroup.from_rows(table.schema, rows)
            from ..engine.instance import nonblocking_backpressure

            with nonblocking_backpressure():
                table.write(rg)
        else:
            forward_rows(
                self.router.route(table_name).endpoint, table_name, rows
            )

    # ---- recording rules ------------------------------------------------

    def _eval_recording(self, rule: Rule, parsed, now_ms: int) -> None:
        from ..proxy.promql import evaluate_expr_instant

        vec = evaluate_expr_instant(self.conn, parsed, now_ms)
        rows = []
        for s in vec:
            labels = {
                k: v for k, v in s["metric"].items() if k != "__name__"
            }
            labels.update(rule.labels)
            rows.append(
                {
                    "ts": now_ms,
                    "labels": _render_labels(labels),
                    "node": self.node,
                    "value": float(s["value"][1]),
                }
            )
        if not rows:
            return
        create_sql = _recording_create_sql(
            rule.name, self.section.recording_ttl_s
        )
        if self.cluster is not None:
            self._ensure_meta_table(rule.name, create_sql)
        if self._owns(rule.name):
            table = self.conn.catalog.open(rule.name)
            if table is None:
                if self.cluster is not None:
                    # never catalog-create here: coordinator-allocated
                    # tables must come from the meta DDL above (a local
                    # create would mint a colliding id); an open miss is
                    # a transient shard race — isolate and retry next round
                    raise RuntimeError(
                        f"recording table {rule.name!r} not open yet "
                        "(shard assignment in flight)"
                    )
                opts = {"update_mode": "append", "segment_duration": "2h"}
                if self.section.recording_ttl_s > 0:
                    opts["ttl"] = f"{max(1, int(self.section.recording_ttl_s))}s"
                table = self.conn.catalog.create_table(
                    rule.name, recording_schema(),
                    TableOptions.from_kv(opts), if_not_exists=True,
                )
            rg = RowGroup.from_rows(table.schema, rows)
            from ..engine.instance import nonblocking_backpressure

            with nonblocking_backpressure():
                table.write(rg)
        else:
            if self.cluster is None:
                self._forward_sql(rule.name, create_sql)
            forward_rows(
                self.router.route(rule.name).endpoint, rule.name, rows
            )
        self.rows_written += len(rows)
        _M_ROWS.inc(len(rows))

    def _ensure_meta_table(self, name: str, sql: str) -> None:
        from ..engine.metrics_recorder import ensure_meta_table

        ensure_meta_table(
            self.cluster, self.router, name, sql, self._remote_ensured
        )

    def _forward_sql(self, table: str, sql: str) -> None:
        """Idempotent DDL on the owning node over its /sql endpoint,
        once per engine lifetime per table (later TTL-knob changes apply
        on the owner's next restart — the ensure here is existence)."""
        if table in self._remote_ensured:
            return
        import urllib.error
        import urllib.request

        endpoint = self.router.route(table).endpoint
        req = urllib.request.Request(
            f"http://{endpoint}/sql",
            json.dumps({"query": sql}).encode(),
            {"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=10):
                pass
        except urllib.error.HTTPError as e:
            body = e.read().decode("utf-8", "replace")[:200]
            raise RuntimeError(
                f"rule DDL forward to {endpoint} failed ({e.code}): {body}"
            ) from None
        self._remote_ensured.add(table)

    # ---- alert rules ----------------------------------------------------

    def _eval_alert(self, rule: Rule, parsed, now_ms: int) -> None:
        from ..proxy.promql import evaluate_expr_instant

        vec = evaluate_expr_instant(self.conn, parsed, now_ms)
        active: dict[tuple, tuple[dict, float]] = {}
        for s in vec:
            labels = {
                k: v for k, v in s["metric"].items() if k != "__name__"
            }
            labels.update(rule.labels)
            labels["alertname"] = rule.name
            active[tuple(sorted(labels.items()))] = (labels, float(s["value"][1]))
        for_ms = int(rule.for_s * 1000)
        with self._alerts_lock:
            book = self._alerts.setdefault(rule.name, {})
            for key, (labels, value) in active.items():
                inst = book.get(key)
                if inst is None:
                    inst = AlertInstance(
                        rule=rule.name, labels=labels, state="pending",
                        value=value, active_since_ms=now_ms,
                    )
                    book[key] = inst
                inst.value = value
                if (
                    inst.state == "pending"
                    and now_ms - inst.active_since_ms >= for_ms
                ):
                    inst.state = "firing"
                    inst.fired_at_ms = now_ms
                    _M_FIRED.inc()
                    record_event(
                        "alert_fired", table="",
                        rule=rule.name, labels=_render_labels(labels),
                        value=value, for_s=rule.for_s,
                    )
            for key in [k for k in book if k not in active]:
                inst = book.pop(key)
                if inst.state == "firing":
                    inst.state = "resolved"
                    inst.resolved_at_ms = now_ms
                    self._resolved.append(inst)
                    _M_RESOLVED.inc()
                    record_event(
                        "alert_resolved", table="",
                        rule=rule.name, labels=_render_labels(inst.labels),
                        after_s=round((now_ms - inst.fired_at_ms) / 1000.0, 3),
                    )
                # a pending series that stopped matching simply resets

    # ---- persistence ----------------------------------------------------

    def _save_state(self) -> None:
        if not self.state_path:
            return
        with self._state_lock:
            watermarks = {}
            for source, m in self._maintainers.items():
                for suffix, ms in m.state.watermarks().items():
                    watermarks[f"{source}|{suffix}"] = ms
            data = {
                "rules": [
                    r.to_dict()
                    for r in self.rules.values()
                    if r.source == "runtime"
                ],
                "watermarks": watermarks,
            }
            tmp = self.state_path + ".tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(data, f, indent=1, sort_keys=True)
                os.replace(tmp, self.state_path)
            except OSError as e:
                logger.warning(
                    "could not persist rules state %s: %s", self.state_path, e
                )


def _create_sql_for(name: str, schema, options) -> str:
    """CREATE TABLE IF NOT EXISTS text for a rollup tier table — the
    forwarded-DDL form of rules/rollup.rollup_schema."""
    cols = []
    for c in schema.columns:
        if c.name == "tsid":
            continue
        part = f"{c.name} {c.kind.value}"
        if c.is_tag:
            part += " TAG"
        if c.name == schema.timestamp_name:
            part += " NOT NULL"
        cols.append(part)
    opts = [f"update_mode='{options.update_mode.value}'"]
    if options.segment_duration_ms:
        opts.append(f"segment_duration='{options.segment_duration_ms}ms'")
    if options.enable_ttl and options.ttl_ms:
        opts.append("enable_ttl='true'")
        opts.append(f"ttl='{options.ttl_ms}ms'")
    return (
        f"CREATE TABLE IF NOT EXISTS {name} ({', '.join(cols)}, "
        f"TIMESTAMP KEY({schema.timestamp_name})) ENGINE=Analytic "
        f"WITH ({', '.join(opts)})"
    )
