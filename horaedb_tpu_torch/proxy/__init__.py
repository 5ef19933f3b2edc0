"""Proxy: request orchestration in front of the query stack
(ref: src/proxy — Proxy::handle_*, Context, limiter.rs, the slow-query log
in read.rs:177-183, and hotspot tracking).

This package also holds ``promql`` (the PromQL parser and evaluator).
With ``[wlm.batch]`` enabled (``utils.config.BatchSection``), cohorts of
shape-identical SELECTs reach ``Executor.execute_cohort``, which serves
them with one launch of the cohort scan-aggregate kernel
(``ops.scan_agg.cached_scan_agg_cohort``). The HTTP server and the
InfluxQL, OpenTSDB and remote-write front ends are not ported yet.

The proxy is a workload manager, not just a router: every SQL statement
passes through the ``wlm`` subsystem — per-tenant/per-table quotas and
the block-list (wlm/quota), cost-based admission control with weighted
slots + bounded wait queues (wlm/admission), and single-flight dedup of
identical in-flight SELECTs (wlm/dedup) — before it reaches the
priority runtime and the executor. Request ids, per-request
timing/metrics, the slow-query log, and LRU-bounded hotspot tracking
ride the same path.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Optional

from ..db import Connection
from ..query.interpreters import AffectedRows, Output
from ..query.plan import InsertPlan, QueryPlan
from ..utils.metrics import REGISTRY
from ..utils.runtime import PriorityRuntime
from ..wlm.admission import CLASSES as ADMISSION_CLASSES
from ..wlm import (
    BlockedError,
    COST_HISTORY,
    OverloadedError,
    QuotaExceededError,
    WorkloadManager,
    classify_plan,
    lane_for,
    normalize_shape,
)

__all__ = [
    "BlockedError",
    "OverloadedError",
    "QuotaExceededError",
    "Hotspot",
    "Proxy",
    "RequestContext",
]

logger = logging.getLogger("horaedb_tpu_torch.proxy")

# Per-admission-class end-to-end SELECT latency, eagerly registered (one
# labeled histogram per class so the series — and their samples-table
# history — exist from the first scrape). This is the SLO plane's
# canonical indicator: "cheap-class p99 stays flat during an
# expensive-scan storm" is only measurable when latency is bucketed by
# the class admission chose. Declared + linted like the other family
# registries (tests/test_observability.TestSloRegistryLint).
QUERY_CLASS_METRIC_FAMILIES = ("horaedb_query_class_duration_seconds",)

_M_CLASS_LATENCY = {
    c: REGISTRY.histogram(
        "horaedb_query_class_duration_seconds",
        "end-to-end SELECT latency by admission class (queue wait included)",
        labels={"class": c},
    )
    for c in ADMISSION_CLASSES
}


@dataclass
class RequestContext:
    request_id: int
    sql: str
    start: float = field(default_factory=time.perf_counter)


class _LruTally:
    """Bounded most-recently-bumped tally (the LRU half of
    hotspot_lru.rs): at most ``capacity`` keys; bumping revives a key,
    overflow evicts the least-recently-bumped one."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._counts: "OrderedDict[str, float]" = OrderedDict()

    def bump(self, key: str, n: float = 1.0) -> None:
        self._counts[key] = self._counts.get(key, 0.0) + n
        self._counts.move_to_end(key)
        while len(self._counts) > self.capacity:
            self._counts.popitem(last=False)

    def decay(self, factor: float) -> None:
        for k in list(self._counts):
            v = self._counts[k] * factor
            if v < 1.0:
                del self._counts[k]
            else:
                self._counts[k] = v

    def most_common(self, n: int) -> list[tuple[str, int]]:
        top = sorted(self._counts.items(), key=lambda kv: kv[1], reverse=True)
        return [(k, int(v)) for k, v in top[:n]]

    def __len__(self) -> int:
        return len(self._counts)


class Hotspot:
    """Per-table op tallies, LRU-bounded with periodic decay (ref:
    proxy/src/hotspot_lru.rs — the reference caps the map and ages
    counts so high-cardinality table names can't grow it forever and a
    burst from last week doesn't read as hot today)."""

    def __init__(
        self,
        capacity: int = 512,
        decay_interval_s: float = 60.0,
        decay_factor: float = 0.5,
    ) -> None:
        self.reads = _LruTally(capacity)
        self.writes = _LruTally(capacity)
        self.decay_interval_s = decay_interval_s
        self.decay_factor = decay_factor
        self._last_decay = time.monotonic()
        self._lock = threading.Lock()

    def record(self, table: str, is_write: bool) -> None:
        with self._lock:
            now = time.monotonic()
            if now - self._last_decay >= self.decay_interval_s:
                self.reads.decay(self.decay_factor)
                self.writes.decay(self.decay_factor)
                self._last_decay = now
            (self.writes if is_write else self.reads).bump(table)

    def top(self, n: int = 10) -> dict:
        with self._lock:
            return {
                "reads": dict(self.reads.most_common(n)),
                "writes": dict(self.writes.most_common(n)),
            }


class Proxy:
    def __init__(
        self,
        conn: Connection,
        slow_threshold_s: float = 1.0,
        limits=None,
        persist_path: Optional[str] = None,
        batch_cfg=None,
    ) -> None:
        self.conn = conn
        if persist_path is None:
            # operator-applied block/quota state survives a restart when
            # the node has a data dir to keep it in
            import os

            root = getattr(conn.store, "root", None)
            if root:
                persist_path = os.path.join(root, "wlm_state.json")
        self.wlm = WorkloadManager.from_limits(
            limits, persist_path=persist_path, batch_cfg=batch_cfg
        )
        # default per-query time budget ([limits] query_timeout; 0 =
        # unbounded) — the gateway's header/session knobs override it
        # per request by passing an explicit Deadline
        self.default_timeout_ms: float = (
            getattr(limits, "query_timeout_s", 60.0) if limits is not None
            else 60.0
        ) * 1000.0
        # the old Limiter surface (block/unblock/blocked/check) lives on,
        # served by the quota manager that subsumed it
        self.limiter = self.wlm.quota
        self.hotspot = Hotspot()
        self.slow_threshold_s = slow_threshold_s
        # Expensive (long-range / history-proven-slow) queries run on the
        # small low-priority pool (ref: SelectInterpreter spawning on the
        # priority runtime); the lane now follows the ADMISSION class.
        self.runtime = PriorityRuntime()
        # Recent per-query metric trees (ref: trace_metric; surfaced at
        # /debug/queries).
        self.recent_queries: deque = deque(maxlen=64)
        # Slow-query ring (ref: the slow log + SlowTimer, read.rs:177-183)
        # — persists across requests, surfaced at /debug/slow_log.
        self.slow_queries: deque = deque(maxlen=128)
        self._req_ids = itertools.count(1)
        self._m_queries = REGISTRY.counter("horaedb_queries_total", "SQL statements handled")
        self._m_errors = REGISTRY.counter("horaedb_query_errors_total", "SQL statements failed")
        self._m_latency = REGISTRY.histogram(
            "horaedb_query_duration_seconds", "SQL statement latency"
        )
        self._m_class_latency = _M_CLASS_LATENCY

    @property
    def slow_threshold_s(self) -> float:
        return self._slow_threshold_s

    @slow_threshold_s.setter
    def slow_threshold_s(self, seconds: float) -> None:
        """The live slow-log threshold also drives the device plane's
        always-time rule (obs/device): a query about to be slow-logged
        must carry a measured device_ms whatever threshold the operator
        dialed in at PUT /debug/slow_threshold — a sampled-out dispatch
        would render the misleading ``device_ms=0`` this field exists
        to prevent."""
        self._slow_threshold_s = seconds
        from ..obs.device import set_slow_candidate_s

        set_slow_candidate_s(seconds)

    def close(self) -> None:
        self.runtime.shutdown()
        self.wlm.close()

    def handle_sql(
        self, sql: str, tenant: str = "default", deadline=None
    ) -> Output:
        ctx = RequestContext(next(self._req_ids), sql)
        self._m_queries.inc()
        # The span tree travels by context: priority-pool threads run the
        # executor inside a COPY of this context, and remote calls ship
        # (trace_id, parent_span_id) in their wire spec (utils/tracectx).
        import contextvars

        from ..utils.deadline import (
            QUERY_REGISTRY,
            Deadline,
            DeadlineExceeded,
            QueryCancelled,
            deadline_scope,
            observe_budget,
        )
        from ..utils.querystats import finish_ledger, start_ledger
        from ..utils.tracectx import finish_trace, span, start_trace, tag_trace

        # The time budget opens HERE, at ingress, and rides the same
        # ContextVar discipline as the trace/ledger — every layer below
        # (admission, executor checkpoints, remote RPC envelopes,
        # forwarding hops, store waits) charges the one object. The
        # gateway installs its Deadline (header/session knob, a
        # forwarded hop's remaining budget) into the calling context
        # (utils/deadline.bind) so handle_sql keeps its historical
        # signature; embedded callers get the [limits] query_timeout
        # default.
        if deadline is None:
            from ..utils.deadline import current_deadline

            deadline = current_deadline()
        if deadline is None:
            deadline = Deadline(self.default_timeout_ms)
        observe_budget(deadline.budget_ms)
        trace, handle = start_trace(ctx.request_id, "sql", sql=sql[:200])
        # The cost ledger rides the same context: every stage the request
        # touches (scans, cache, kernels, remote fan-out) accounts into
        # it, and finalization feeds system.public.query_stats + the
        # horaedb_query_* metric families (utils/querystats).
        ledger, ltoken = start_ledger(ctx.request_id, sql)
        ledger.add(deadline_ms=deadline.budget_ms or 0)
        dtoken = None
        live = QUERY_REGISTRY.register(
            ctx.request_id, sql, tenant, deadline,
            protocol=getattr(deadline, "proto", "sql"),
        )
        shape = None  # set for executed SELECTs; feeds the EWMA history
        exec_elapsed: list = [None]  # leader execution seconds (EWMA input)
        admission_class = None  # set for executed SELECTs (class latency)
        adm_decision = 0  # decision-plane id for the est_cost_s admit
        ok = False
        try:
            dtoken = deadline_scope(deadline)
            dtoken.__enter__()
            # refuse already-expired work before doing ANY of it (a
            # forwarded hop may arrive with <= 0 remaining)
            deadline.check("ingress")
            # The plan cache is what makes repeated dashboard text cheap
            # at serving latency — the gateway is its target workload.
            with span("parse_plan"):
                plan = self.conn._cached_plan(sql)
            table = getattr(plan, "table", None)
            ledger.set_table(table)
            # Profile-plane dimensions (obs/profile): the serving plane
            # and — for SELECTs, below — the normalized plan-key class.
            if isinstance(plan, InsertPlan):
                tag_trace(route="ingest", shape=f"insert {plan.table}")
            elif isinstance(plan, QueryPlan):
                tag_trace(route="query")
            else:
                tag_trace(route="ddl")
            self.limiter.check(table)
            if table:
                self.hotspot.record(table, isinstance(plan, InsertPlan))
            if isinstance(plan, InsertPlan):
                self.wlm.quota.charge_write(tenant, plan.table, len(plan.rows))
            if isinstance(plan, QueryPlan):
                self.wlm.quota.charge_read(tenant, plan.table)
                shape = normalize_shape(sql)
                tag_trace(shape=shape[:160])
                admission_class, est_ms = classify_plan(plan, shape=shape)
                live.admission_class = admission_class
                lane = lane_for(admission_class)
                est_cost_s = (est_ms / 1000.0) if est_ms else None
                if est_cost_s is not None:
                    # Decision plane: the classifier predicted this
                    # shape's cost and admission will act on it; the
                    # finally below grades the prediction against the
                    # leader's realized execution seconds (the same
                    # sample the cost EWMA learns from).
                    from ..obs.decisions import record_decision

                    adm_decision = record_decision(
                        "admission",
                        key=shape,
                        choice=admission_class,
                        features={
                            "est_ms": round(est_ms, 3),
                            "budget_ms": int(deadline.budget_ms or 0),
                        },
                        predicted=est_cost_s,
                    )

                def run_leader():
                    # admission wraps only the LEADER: followers coalesce
                    # onto its slot instead of taking their own; the
                    # queue wait charges the time budget, and a budget
                    # that cannot fit the shape's expected cost sheds
                    # immediately (utils/deadline)
                    with self.wlm.admission.admit(
                        admission_class, est_cost_s=est_cost_s, shape=shape
                    ):
                        with span(
                            "execute", priority=lane, admission=admission_class
                        ):
                            cctx = contextvars.copy_context()
                            t0 = time.perf_counter()
                            try:
                                return self.runtime.run(
                                    lane,
                                    lambda: cctx.run(
                                        self.conn.interpreters.execute, plan
                                    ),
                                )
                            finally:
                                exec_elapsed[0] = time.perf_counter() - t0

                def run_solo():
                    return self.wlm.dedup.run(sql.strip(), run_leader)

                batcher = self.wlm.batch
                if batcher.enabled and batcher.eligible(plan, shape):
                    # Cohort batching (wlm/batch): shape-identical
                    # in-flight SELECTs with differing literals gather
                    # for the micro-batching window and serve from ONE
                    # fused device dispatch. The key carries the dedup
                    # write epoch — a write landing mid-window fences
                    # later members into a fresh cohort (read-your-
                    # writes, same contract as the flight table).
                    from ..wlm import batch_plan_key

                    out = batcher.run(
                        key=(self.wlm.dedup.epoch(), batch_plan_key(plan)),
                        sql=sql.strip(),
                        plan=plan,
                        solo=run_solo,
                        cohort_exec=lambda members: self._execute_cohort(
                            members, admission_class, exec_elapsed
                        ),
                    )
                else:
                    out = run_solo()
                self.recent_queries.append(
                    {
                        "request_id": ctx.request_id,
                        "sql": sql[:200],
                        "priority": plan.priority.value,
                        "admission": admission_class,
                        **(getattr(out, "metrics", None) or {}),
                    }
                )
                ok = True
                return out
            # any non-SELECT may change visible state: later identical
            # reads must start a fresh single-flight execution. Bump
            # AFTER the statement runs (in the finally, so a failed
            # attempt still invalidates conservatively): bumping before
            # would let a SELECT issued after this write COMMITS join a
            # pre-write flight opened in the new epoch.
            try:
                with span("execute"):
                    out = self.conn.interpreters.execute(plan)
                    ok = True
                    return out
            finally:
                self.wlm.dedup.bump_epoch()
        except DeadlineExceeded as e:
            # the ledger marks + typed journal event ARE the audit trail
            # the tenantsim gates read from the database's own tables
            ledger.add(timed_out=1)
            from ..utils.events import record_event

            record_event(
                "query_timeout",
                table=ledger.table_name or None,
                stage=e.stage,
                budget_ms=int(deadline.budget_ms or 0),
            )
            self._m_errors.inc()
            raise
        except QueryCancelled as e:
            ledger.add(cancelled=1)
            from ..utils.events import record_event

            record_event(
                "query_cancelled",
                table=ledger.table_name or None,
                source=e.source,
                query_id=live.query_id,
            )
            self._m_errors.inc()
            raise
        except Exception:
            self._m_errors.inc()
            raise
        finally:
            QUERY_REGISTRY.deregister(live)
            if dtoken is not None:
                dtoken.__exit__(None, None, None)
            elapsed = time.perf_counter() - ctx.start
            self._m_latency.observe(elapsed)
            if ok and admission_class is not None:
                # end-to-end latency AS THE TENANT SEES IT (queue wait
                # included), bucketed by admission class — the SLO
                # plane's "cheap p99 stays flat under an expensive
                # storm" indicator reads this family's history
                self._m_class_latency[admission_class].observe(elapsed)
            # Follower-served statement (gateway replica path): the route
            # truth is "follower" whatever executor path ran underneath,
            # and the watermark lag rides the ledger so query_stats
            # carries it on every wire.
            from ..cluster.replica import replica_context

            rc = replica_context()
            if rc is not None:
                ledger.set_route("follower")
                ledger.add(replica_lag_ms=rc["lag_ms"])
            if ok and shape is not None and exec_elapsed[0] is not None:
                # the EWMA only learns from completed LEADER executions —
                # failures/sheds would teach it queries are "fast", and
                # queue or follower wait would teach cheap shapes they
                # are "slow" under load (a self-sustaining demotion)
                COST_HISTORY.observe(shape, exec_elapsed[0])
                from ..obs.decisions import DECISION_JOURNAL, resolve_decision

                resolve_decision(
                    adm_decision, actual=exec_elapsed[0], outcome="ok",
                    loop="admission",
                )
                # a completed same-shape execution grades any pending
                # deadline_budget sheds of this shape: the shed was
                # "doomed" if the realized cost really would not have
                # fit the budget remaining at shed time, else premature
                DECISION_JOURNAL.resolve_matching(
                    "deadline",
                    shape,
                    actual=exec_elapsed[0],
                    outcome=lambda e: (
                        "doomed"
                        if exec_elapsed[0]
                        >= e["features"].get("remaining_s", 0.0)
                        else "premature"
                    ),
                )
            elif adm_decision:
                # shed/failed/timed out before a leader execution
                # completed: close the decision ungraded — a realized
                # cost never arrived, so there is nothing to grade the
                # estimator against (and "fast because it died" would
                # poison the calibration the same way it would poison
                # the EWMA)
                from ..obs.decisions import resolve_decision

                resolve_decision(
                    adm_decision,
                    outcome="failed" if exec_elapsed[0] is None else "aborted",
                    loop="admission",
                    calibrate=False,
                )
            slow = elapsed >= self.slow_threshold_s
            finish_trace(handle, slow=slow)
            finish_ledger(ledger, ltoken, elapsed)
            if slow:
                # device-plane facts at a glance: a compile-stall query
                # (compile_hit>0, device_ms small) reads differently
                # from a slow scan without opening the full ledger
                device_ms = round(ledger.counts.get("device_ms", 0.0), 3)
                compile_hit = int(ledger.counts.get("compile_hit", 0))
                logger.warning(
                    "slow query (request %d, %.3fs, device_ms=%s"
                    " compile_hit=%d): %s",
                    ctx.request_id, elapsed, device_ms, compile_hit,
                    sql[:500],
                )
                self.slow_queries.append(
                    {
                        "request_id": ctx.request_id,
                        "elapsed_s": round(elapsed, 4),
                        "sql": sql[:500],
                        "at": time.time(),
                        "device_ms": device_ms,
                        "compile_hit": compile_hit,
                        # the request's whole span tree rides with the
                        # slow-log entry (ref: SlowTimer + trace_metric)
                        "trace": trace.to_dict(),
                        # ...and its cost ledger (route + nonzero costs)
                        "ledger": ledger.to_dict(),
                    }
                )

    def _execute_cohort(
        self, members: list, admission_class: str, exec_elapsed=None
    ) -> list:
        """Execute a gathered cohort (wlm/batch) under ONE admission slot
        — members coalesce onto the leader's slot exactly like dedup
        followers — on the leader's priority lane. Returns one
        Output-or-exception per member, positionally (the interpreter
        isolates member failures). ``exec_elapsed[0]`` gets the
        AMORTIZED per-member execution seconds so the leader's shape
        keeps feeding the admission cost EWMA (the fused dispatch serves
        B queries in one execution; per-member cost is what classifies
        one query of the shape)."""
        import contextvars

        from ..utils.tracectx import span

        lane = lane_for(admission_class)
        plans = [plan for _, plan in members]
        with self.wlm.admission.admit(admission_class):
            with span(
                "execute_cohort",
                priority=lane,
                admission=admission_class,
                cohort=len(members),
            ):
                cctx = contextvars.copy_context()
                t0 = time.perf_counter()
                try:
                    return self.runtime.run(
                        lane,
                        lambda: cctx.run(
                            self.conn.interpreters.execute_cohort, plans
                        ),
                    )
                finally:
                    if exec_elapsed is not None:
                        exec_elapsed[0] = (
                            time.perf_counter() - t0
                        ) / max(len(members), 1)
