"""Self-monitoring metrics recorder — the node scrapes itself through
the normal write path
(ref: StreamBox-HBM treats telemetry as just another high-rate stream;
"Fine-Tuning Data Structures for Analytical Query Processing" argues
your workload data belongs in a first-class table).

Every ``[observability] self_scrape_interval`` seconds a ``PeriodicLoop``
(the maintenance-scheduler core) snapshots ``Registry.families()``
into the **real** table ``system_metrics.samples`` — WAL, memtable,
flush, SSTs, the whole pipeline — so the node's own telemetry becomes
queryable history: SQL (``SELECT value FROM system_metrics.samples WHERE
name='horaedb_write_stall_seconds_sum' AND ts > now()-3600000``) and
PromQL (``rate(horaedb_flush_rows_total[5m])`` resolves against the
samples table when no table of that name exists) both work, over all
three wire protocols, and in cluster mode the coordinator reads every
node's rows through the ordinary distributed read path (rows are
node-labeled; non-owner nodes forward their samples to the table's
owner over the standard ``/write`` endpoint).

Schema (one row per sample):

    ts      timestamp KEY
    name    string TAG   -- metric family; histograms decompose into
                         -- <family>_bucket / <family>_sum / <family>_count
    labels  string TAG   -- rendered label set, {k="v",...} ('' when none)
    node    string TAG   -- this node's endpoint ("standalone" embedded)
    value   double

Retention: the table carries ``enable_ttl`` with ``ttl_ms =
self_metrics_retention``; the recorder periodically flushes and drops
expired SSTs whole (SST-level drop of expired time buckets — the same
TTL machinery compaction uses), so history is bounded by construction.

Backpressure: self-scrape writes must never deadlock or stall behind
the flush activity they are measuring, so they run under
``nonblocking_backpressure()`` — at the write-stall bound they shed
IMMEDIATELY with the typed retryable ``OverloadedError`` instead of
blocking out the deadline; the recorder records a ``self_scrape_skipped``
event, backs off exponentially, and retries later. A dropped scrape
round during overload is the correct trade: the stall histogram and the
event journal already tell that story.
"""

from __future__ import annotations

import logging
import time
import weakref
from typing import Optional

from ..common_types import ColumnSchema, DatumKind, RowGroup, Schema
from ..utils.events import record_event
from ..utils.metrics import Histogram, REGISTRY, _render_labels
from .maintenance_scheduler import PeriodicLoop
from .options import TableOptions

logger = logging.getLogger("horaedb_tpu_torch.engine.metrics_recorder")

SAMPLES_TABLE = "system_metrics.samples"

# Declared registry of the self-monitoring metric families — the lint in
# tests/test_observability.py checks each is registered live,
# convention-clean, and documented in docs/OBSERVABILITY.md, and that no
# stray horaedb_self_* family exists outside this list.
SELF_MONITORING_METRIC_FAMILIES = (
    "horaedb_self_scrape_rounds_total",
    "horaedb_self_scrape_rows_total",
    "horaedb_self_scrape_skipped_total",
    "horaedb_self_scrape_duration_seconds",
    "horaedb_self_retention_dropped_total",
)

# Registered at import so the series exist from the first scrape.
_M_ROUNDS = REGISTRY.counter(
    "horaedb_self_scrape_rounds_total",
    "self-monitoring scrape rounds written through the write path",
)
_M_ROWS = REGISTRY.counter(
    "horaedb_self_scrape_rows_total",
    "sample rows the recorder wrote into system_metrics.samples",
)
_M_SKIPPED = REGISTRY.counter(
    "horaedb_self_scrape_skipped_total",
    "scrape rounds skipped (backpressure shed or write failure)",
)
_M_SECONDS = REGISTRY.histogram(
    "horaedb_self_scrape_duration_seconds",
    "wall time of one scrape round (snapshot + write)",
)
_M_RETENTION_DROPPED = REGISTRY.counter(
    "horaedb_self_retention_dropped_total",
    "expired system_metrics.samples SSTs dropped by retention",
)

_BACKOFF_CAP_S = 300.0


def samples_schema() -> Schema:
    return Schema.build(
        [
            ColumnSchema("name", DatumKind.STRING, is_tag=True),
            ColumnSchema("labels", DatumKind.STRING, is_tag=True),
            ColumnSchema("node", DatumKind.STRING, is_tag=True),
            ColumnSchema("value", DatumKind.DOUBLE),
            ColumnSchema("ts", DatumKind.TIMESTAMP),
        ],
        timestamp_column="ts",
    )


def snapshot_samples(now_ms: int, node: str, registry=REGISTRY) -> list[dict]:
    """One scrape round: every live family as sample rows. Counters and
    gauges contribute one row; histograms decompose into the Prometheus
    series convention — cumulative ``_bucket`` rows (le folded into the
    label string), ``_sum`` and ``_count`` — so histogram_quantile over
    the stored history works like it does over a live scrape. All reads
    go through the locked ``snapshot()`` accessors: a scrape racing
    ``inc()``/``observe()`` can never tear."""
    rows: list[dict] = []

    def add(name: str, labels: str, value: float) -> None:
        rows.append(
            {"ts": now_ms, "name": name, "labels": labels, "node": node,
             "value": float(value)}
        )

    for family, members in sorted(registry.families().items()):
        for m in members:
            if isinstance(m, Histogram):
                counts, sum_, total = m.snapshot()
                acc = 0
                for le, c in zip(m.buckets, counts):
                    acc += c
                    add(f"{family}_bucket",
                        _render_labels({**m.labels, "le": str(le)}), acc)
                add(f"{family}_bucket",
                    _render_labels({**m.labels, "le": "+Inf"}), total)
                add(f"{family}_sum", _render_labels(m.labels), sum_)
                add(f"{family}_count", _render_labels(m.labels), total)
            else:
                add(family, _render_labels(m.labels), m.snapshot())
    return rows


def ensure_meta_table(cluster, router, name: str, create_sql: str,
                      ensured: set) -> None:
    """Coordinator-serialized CREATE (idempotent — the coordinator
    answers ``existed`` for known tables), once per ``ensured`` memo
    lifetime; invalidates the route cache so the first forward after
    creation sees the fresh owner instead of a cached meta-unknown
    self-route. Shared by the self-monitoring recorder and the rules
    engine — the meta-serialized-id + cache-invalidate protocol must
    not fork (the reason local catalog creation is refused in
    coordinator mode is exactly that two copies of this drift)."""
    if name in ensured:
        return
    cluster.meta.create_table(name, create_sql)
    if router is not None:
        router.invalidate(name)
    ensured.add(name)


def forward_rows(endpoint: str, table: str, rows: list[dict]) -> None:
    """Cluster mode, non-owner: ship one round of rows to the owning
    node's ordinary ``/write`` endpoint. ``nonblocking=1`` makes the
    owner shed at ITS stall bound instead of blocking our timeout out
    against its stall deadline; a 503/429 maps back to the same typed
    retryable OverloadedError the local path raises. Shared by the
    self-monitoring recorder and the rules engine (recording-rule and
    rollup output forwarding)."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://{endpoint}/write?nonblocking=1",
        json.dumps({"table": table, "rows": rows}).encode(),
        {"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=10):
            pass
    except urllib.error.HTTPError as e:
        body = e.read().decode("utf-8", "replace")[:200]
        if e.code in (503, 429):
            from ..wlm.admission import OverloadedError

            raise OverloadedError(
                f"owner {endpoint} shed forwarded write to {table}: {body}",
                reason="write_stall", retry_after_s=1.0,
            ) from None
        raise RuntimeError(
            f"forward to {endpoint} for {table} failed ({e.code}): {body}"
        ) from None


def rows_to_rowgroup(schema, rows: list[dict]) -> "RowGroup":
    """Columnar RowGroup straight from sample dicts — the recorder fires
    every interval on the serving node, so it skips ``from_rows``'s
    generic per-cell loop (scrape cost is the one overhead the <3%
    ingest-impact budget pays for)."""
    import numpy as np

    from ..common_types.schema import compute_tsid

    names = np.array([r["name"] for r in rows], dtype=object)
    labels = np.array([r["labels"] for r in rows], dtype=object)
    nodes = np.array([r["node"] for r in rows], dtype=object)
    return RowGroup(
        schema,
        {
            "tsid": compute_tsid([names, labels, nodes], num_rows=len(rows)),
            "ts": np.array([r["ts"] for r in rows], dtype=np.int64),
            "name": names,
            "labels": labels,
            "node": nodes,
            "value": np.array([r["value"] for r in rows], dtype=np.float64),
        },
    )


class MetricsRecorder:
    """Background self-scrape loop over a Connection.

    ``router`` (cluster mode): when the samples table routes to another
    node, rows forward to the owner's ``/write`` endpoint — the ordinary
    ingest path — instead of writing into a locally-unowned table.
    """

    def __init__(
        self,
        conn,
        interval_s: float = 10.0,
        retention_s: float = 24 * 3600.0,
        node: str = "standalone",
        router=None,
        cluster=None,
    ) -> None:
        """``cluster`` (coordinator mode): the samples table is created
        through the COORDINATOR (``cluster.meta.create_table`` —
        meta-serialized id allocation in the shared store; the reason
        self-monitoring was disabled in this mode before), ownership asks
        the live shard set, and non-owner rounds forward to the
        meta-assigned owner like the static-cluster path always did."""
        self.conn = conn
        self.interval_s = max(0.05, float(interval_s))
        self.retention_s = float(retention_s)
        self.node = node
        self.router = router
        self.cluster = cluster
        self._meta_ensured: set[str] = set()
        self.started_at: Optional[float] = None
        self.rounds = 0
        self.rows_written = 0
        self.skipped = 0
        self.retention_dropped = 0
        self._fails = 0
        self._backoff_until = 0.0
        # retention sweeps are much rarer than scrapes: every ~32
        # intervals, floored so short test intervals still sweep.
        self._retention_every_s = max(self.interval_s * 32, 1.0)
        self._last_retention = time.monotonic()
        self._loop: Optional[PeriodicLoop] = None

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> "MetricsRecorder":
        """Start the periodic loop (idempotent). The tick closure holds a
        weakref — an abandoned recorder must not pin its Connection."""
        if self._loop is not None:
            return self
        ref = weakref.WeakMethod(self.tick)

        def tick():
            fn = ref()
            if fn is None:
                return False
            fn()
            return True

        self.started_at = time.time()
        self._loop = PeriodicLoop(self.interval_s, tick, "self-scrape").start()
        return self

    def close(self) -> None:
        if self._loop is not None:
            self._loop.close()
            self._loop = None

    def stats(self) -> dict:
        return {
            "node": self.node,
            "interval_s": self.interval_s,
            "retention_s": self.retention_s,
            "running": self._loop is not None and self._loop.is_alive(),
            "rounds": self.rounds,
            "rows_written": self.rows_written,
            "skipped": self.skipped,
            "retention_dropped": self.retention_dropped,
            "consecutive_failures": self._fails,
            "backoff_s": round(max(0.0, self._backoff_until - time.monotonic()), 2),
        }

    # ---- one round ------------------------------------------------------

    def tick(self) -> None:
        """One periodic firing: honor failure backoff, scrape, and run
        the retention sweep when due. Never raises (the loop must keep
        ticking through shed rounds and transient write failures)."""
        now = time.monotonic()
        if now < self._backoff_until:
            return
        from ..wlm.admission import OverloadedError

        try:
            self.run_once()
        except OverloadedError as e:
            # Shed rounds must escalate the backoff AND skip the
            # retention sweep — enforce_retention flushes into the very
            # stall the write just shed from.
            self._note_skip("write_stall", str(e))
            return
        except Exception as e:
            # e.g. cluster owner hasn't created the table yet, forward
            # target unreachable, close racing the tick
            self._note_skip("error", str(e))
            return
        self._fails = 0
        if (
            self.retention_s > 0
            and now - self._last_retention >= self._retention_every_s
        ):
            self._last_retention = now
            try:
                self.enforce_retention()
            except Exception:
                logger.exception("self-monitoring retention sweep failed")

    def _note_skip(self, reason: str, msg: str) -> None:
        self.skipped += 1
        self._fails += 1
        delay = min(self.interval_s * (2 ** self._fails), _BACKOFF_CAP_S)
        self._backoff_until = time.monotonic() + delay
        _M_SKIPPED.inc()
        record_event(
            "self_scrape_skipped", table=SAMPLES_TABLE,
            reason=reason, error=msg[:200], backoff_s=round(delay, 2),
        )
        logger.warning(
            "self-scrape round skipped (%s); backing off %.1fs: %s",
            reason, delay, msg,
        )

    def run_once(self, now_ms: Optional[int] = None) -> int:
        """Scrape the registry and write one round of sample rows through
        the normal write path. Returns rows written. Raises on shed or
        failure — ``tick`` owns the backoff policy."""
        t0 = time.perf_counter()
        now_ms = int(time.time() * 1000) if now_ms is None else now_ms
        rows = snapshot_samples(now_ms, self.node)
        if self.cluster is not None:
            self._ensure_meta_table()
        if self._is_local():
            table = self._ensure_table()
            rg = rows_to_rowgroup(table.schema, rows)
            from .instance import nonblocking_backpressure

            with nonblocking_backpressure():
                table.write(rg)
        else:
            self._forward(rows)
        self.rounds += 1
        self.rows_written += len(rows)
        _M_ROUNDS.inc()
        _M_ROWS.inc(len(rows))
        _M_SECONDS.observe(time.perf_counter() - t0)
        return len(rows)

    def _is_local(self) -> bool:
        if self.cluster is not None:
            # the live shard set, NOT the router: the router's
            # meta-unknown fallback answers is_local=True for a table
            # that doesn't exist yet, which here would catalog-create it
            # locally with a colliding id on every node
            return self.cluster.owns_table(SAMPLES_TABLE)
        if self.router is None:
            return True
        return self.router.route(SAMPLES_TABLE).is_local

    def _samples_create_sql(self) -> str:
        """The meta-DDL form of samples_schema() + retention options —
        what coordinator mode sends through cluster.meta.create_table."""
        opts = "update_mode='append', segment_duration='2h'"
        if self.retention_s > 0:
            opts += f", enable_ttl='true', ttl='{max(1, int(self.retention_s))}s'"
        return (
            f"CREATE TABLE IF NOT EXISTS `{SAMPLES_TABLE}` ("
            "name string TAG, labels string TAG, node string TAG, "
            "value double, ts timestamp NOT NULL, TIMESTAMP KEY(ts)) "
            f"ENGINE=Analytic WITH ({opts})"
        )

    def _ensure_meta_table(self) -> None:
        ensure_meta_table(
            self.cluster, self.router, SAMPLES_TABLE,
            self._samples_create_sql(), self._meta_ensured,
        )

    def _ensure_table(self):
        table = self.conn.catalog.open(SAMPLES_TABLE)
        if table is not None:
            self._sync_ttl(table)
            return table
        if self.cluster is not None:
            # never catalog-create in coordinator mode (colliding ids —
            # see _ensure_meta_table); an open miss right after the meta
            # DDL is a transient shard race: skip this round and retry
            raise RuntimeError(
                f"{SAMPLES_TABLE} not open yet (shard assignment in flight)"
            )
        opts = {"update_mode": "append", "segment_duration": "2h"}
        if self.retention_s > 0:
            opts["ttl"] = f"{max(1, int(self.retention_s))}s"
        return self.conn.catalog.create_table(
            SAMPLES_TABLE, samples_schema(), TableOptions.from_kv(opts),
            if_not_exists=True,
        )

    def _sync_ttl(self, table) -> None:
        """The configured retention must WIN over whatever TTL the table
        was created with — the knob would otherwise be silently ignored
        across restarts (a table created at 24h keeps deleting at 24h
        after the operator sets 72h, or 0 = keep forever, and the
        regular compaction's TTL drop reads the table options too)."""
        datas = table.physical_datas()
        if not datas:
            return
        cur = datas[0].options
        want_enable = self.retention_s > 0
        want_ttl_ms = int(self.retention_s * 1000) if want_enable else cur.ttl_ms
        if cur.enable_ttl == want_enable and cur.ttl_ms == want_ttl_ms:
            return
        import dataclasses

        table.alter_options(
            dataclasses.replace(
                cur, enable_ttl=want_enable, ttl_ms=want_ttl_ms
            )
        )

    def _forward(self, rows: list[dict]) -> None:
        """Cluster mode, non-owner: ship this round to the owner via the
        shared ``forward_rows`` helper (503 there is the owner's stall
        shed, mapped back to the retryable OverloadedError)."""
        forward_rows(self.router.route(SAMPLES_TABLE).endpoint, SAMPLES_TABLE, rows)

    # ---- retention ------------------------------------------------------

    def enforce_retention(self, now_ms: Optional[int] = None) -> int:
        """Bounded history: flush buffered samples, then drop expired
        SSTs whole (files entirely older than the retention horizon) via
        the compaction TTL machinery. Returns SSTs dropped. No-op on a
        non-owner node — the owner sweeps for the whole cluster."""
        if not self._is_local() or self.retention_s <= 0:
            return 0
        table = self.conn.catalog.open(SAMPLES_TABLE)
        if table is None:
            return 0
        datas = table.physical_datas()
        if not datas:
            return 0
        from .compaction import Compactor

        td = datas[0]
        instance = self.conn.instance
        if td.version.total_memtable_bytes() > 0:
            instance.flush_table(td, wait=True)
        now = int(time.time() * 1000) if now_ms is None else now_ms
        if not td.version.levels.expired_files(now, td.options.ttl_ms):
            return 0
        result = Compactor(td).compact(now_ms=now)
        dropped = result.expired_dropped
        if dropped:
            self.retention_dropped += dropped
            _M_RETENTION_DROPPED.inc(dropped)
            record_event(
                "self_retention", table=SAMPLES_TABLE,
                dropped_ssts=dropped,
                retention_s=self.retention_s,
            )
        return dropped
