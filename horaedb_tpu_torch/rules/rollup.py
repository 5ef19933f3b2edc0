"""Tiered rollup tables with TTL laddering — incrementally maintained
downsampling over the mutable memtable
(ref: StreamBox-HBM's stream analytics over hybrid memory, PAPERS.md —
pre-aggregate at ingest so the dashboard-shaped range query reads the
small table; the raw/1m/1h ladder is the classic Prometheus/Influx
retention-policy shape: raw 24h -> 1m rollup 30d -> 1h rollup kept).

For a source table ``t`` (tags + one DOUBLE value column + timestamp
key), the maintainer keeps:

    t_rollup_1m   one row per (tags..., 1m bucket):  agg_sum, agg_count,
                  agg_min, agg_max   (ttl: rollup_1m_ttl, default 30d)
    t_rollup_1h   the same, folded FROM the 1m tier  (ttl: rollup_1h_ttl,
                  default 0 = kept)

and optionally applies ``rollup_raw_ttl`` (default 24h) to the source so
the ladder bounds total storage by construction. Those four partials
reconstruct every rewritable aggregate: sum == sum(agg_sum), count ==
sum(agg_count), min/max fold, avg == sum(agg_sum)/sum(agg_count).

Watermark / catch-up protocol (restarts and WAL replay can neither
double-count nor leave gaps):

- the watermark per (source, tier) is the exclusive end of COMPLETE
  buckets already rolled up; only buckets entirely older than
  ``now - grace`` close (late arrivals inside the grace window are
  captured; later ones are the documented streaming trade-off);
- each round recomputes ``[watermark, closed_end)`` FROM THE SOURCE with
  one grouped scan (memtable + SSTs — the mutable tail is included), so
  a round is a pure function of source state;
- rollup tables are ``update_mode=overwrite`` keyed (tags, bucket): a
  recomputed bucket REPLACES its previous row, so replaying a round
  (crash between write and watermark persist, WAL replay after restart)
  is idempotent;
- the watermark advances only after the rows are written (write-ahead:
  rows are WAL-durable before the state file moves), and on a cold start
  with no state file it re-derives from ``max(ts)`` of the rollup table
  itself — catch-up then recomputes forward from the last durable
  bucket, never skipping a gap.

The process-global ``ROLLUPS`` registry is how the query layer finds a
maintained rollup: the rewrite (rules/rewrite.py) consults the spec and
the live watermark to decide whether a range query's buckets can be
served from the tier, with the raw tail above the cut computed from the
source.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..common_types import ColumnSchema, DatumKind, RowGroup, Schema
from ..engine.options import TableOptions
from ..proxy.promql import _q, _value_column

logger = logging.getLogger("horaedb_tpu_torch.rules.rollup")

# (suffix, bucket width ms), finest first. The ladder is fixed; TTLs are
# the [rules] knobs.
TIERS: tuple[tuple[str, int], ...] = (("1m", 60_000), ("1h", 3_600_000))

AGG_COLS = ("agg_sum", "agg_count", "agg_min", "agg_max")


def rollup_table_name(source: str, suffix: str) -> str:
    return f"{source}_rollup_{suffix}"


@dataclass(frozen=True)
class RollupSpec:
    """What the rewrite and the maintainer both need to know about one
    source table's ladder — derived once from the source schema."""

    source: str
    ts_col: str
    value_col: str
    tags: tuple[str, ...]
    tiers: tuple[tuple[str, int], ...] = TIERS


class RollupState:
    """Spec + live watermarks (exclusive end of completed buckets per
    tier suffix). The maintainer writes, the query rewrite reads."""

    def __init__(self, spec: RollupSpec) -> None:
        self.spec = spec
        self._lock = threading.Lock()
        self._watermarks: dict[str, int] = {}

    def watermark(self, suffix: str) -> Optional[int]:
        with self._lock:
            return self._watermarks.get(suffix)

    def set_watermark(self, suffix: str, ms: int) -> None:
        with self._lock:
            self._watermarks[suffix] = int(ms)

    def watermarks(self) -> dict[str, int]:
        with self._lock:
            return dict(self._watermarks)


class RollupRegistry:
    """Process-global source -> RollupState map (same discipline as
    EVENT_STORE / STATS_STORE: tests reset() between connections)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._states: dict[str, RollupState] = {}

    def register(self, state: RollupState) -> RollupState:
        with self._lock:
            self._states[state.spec.source] = state
            return state

    def get(self, source: str) -> Optional[RollupState]:
        with self._lock:
            return self._states.get(source)

    def unregister(self, source: str) -> None:
        with self._lock:
            self._states.pop(source, None)

    def reset(self) -> None:
        with self._lock:
            self._states.clear()


ROLLUPS = RollupRegistry()


def spec_for(conn, source: str) -> RollupSpec:
    """Derive the ladder spec from the source schema; raises ValueError
    for shapes the ladder cannot represent (no single value column, or a
    tag colliding with the partial-aggregate column names)."""
    schema = conn.catalog.schema_of(source)
    if schema is None:
        raise ValueError(f"rollup source table not found: {source}")
    value_col = _value_column(schema)  # raises PromQLError (a ValueError)
    tags = tuple(schema.tag_names)
    taken = set(tags) | {schema.timestamp_name, value_col}
    collide = taken & set(AGG_COLS)
    if collide:
        raise ValueError(
            f"rollup for {source!r}: column(s) {sorted(collide)} collide "
            "with the rollup partial columns"
        )
    return RollupSpec(
        source=source,
        ts_col=schema.timestamp_name,
        value_col=value_col,
        tags=tags,
    )


def rollup_schema(conn, spec: RollupSpec) -> Schema:
    """Tags copied from the source; the four partial columns DOUBLE; the
    timestamp keeps the source's name so group exprs rewrite verbatim."""
    src = conn.catalog.schema_of(spec.source)
    cols = [
        ColumnSchema(t, src.column(t).kind, is_tag=True) for t in spec.tags
    ]
    cols += [ColumnSchema(c, DatumKind.DOUBLE) for c in AGG_COLS]
    cols.append(ColumnSchema(spec.ts_col, DatumKind.TIMESTAMP, is_nullable=False))
    return Schema.build(cols, timestamp_column=spec.ts_col)


class RollupMaintainer:
    """The per-engine maintenance half: ensure tables + TTL ladder, then
    advance each tier's watermark every round. Owned by the RuleEngine
    (which provides persistence for the watermarks and the write path —
    local or forwarded to the owning node)."""

    def __init__(
        self,
        conn,
        source: str,
        grace_ms: int = 5_000,
        raw_ttl_s: float = 24 * 3600.0,
        tier_ttl_s: Optional[dict[str, float]] = None,
        write_rows=None,
        ensure_table=None,
    ) -> None:
        self.conn = conn
        self.source = source
        self.grace_ms = max(0, int(grace_ms))
        self.raw_ttl_s = float(raw_ttl_s)
        self.tier_ttl_s = dict(tier_ttl_s or {})
        # injection points for the engine's cluster forwarding; defaults
        # are the local write path
        self._write_rows = write_rows
        self._ensure_table = ensure_table
        self.spec = spec_for(conn, source)
        # a FRESH state replaces any prior registration for the source:
        # watermarks from another connection's lifetime (tests, embedded
        # + server on one process) must not leak — cold-start derivation
        # from the rollup table itself covers genuine restarts
        self.state = ROLLUPS.register(RollupState(self.spec))
        self.rows_written = 0
        self.last_error: str = ""

    # ---- tables ---------------------------------------------------------

    def ensure_tables(self) -> None:
        schema = rollup_schema(self.conn, self.spec)
        for suffix, tier_ms in self.spec.tiers:
            name = rollup_table_name(self.source, suffix)
            ttl = self.tier_ttl_s.get(suffix, 0.0)
            opts = {
                "update_mode": "overwrite",
                # coarse tiers get coarse segments: whole-SST TTL drops
                # stay cheap at 30d retention
                "segment_duration": "2h" if tier_ms < 3_600_000 else "1d",
            }
            if ttl > 0:
                opts["ttl"] = f"{max(1, int(ttl))}s"
            if self._ensure_table is not None:
                self._ensure_table(name, schema, TableOptions.from_kv(opts))
            else:
                table = self.conn.catalog.open(name)
                if table is None:
                    self.conn.catalog.create_table(
                        name, schema, TableOptions.from_kv(opts),
                        if_not_exists=True,
                    )
                else:
                    _sync_ttl(table, ttl)
        if self.raw_ttl_s > 0:
            src = self.conn.catalog.open(self.source)
            if src is not None:
                _sync_ttl(src, self.raw_ttl_s)

    # ---- one round ------------------------------------------------------

    def run_once(self, now_ms: Optional[int] = None) -> int:
        """Advance every tier; returns rollup rows written. Raises on
        write shed/failure — the engine owns backoff policy."""
        now_ms = int(time.time() * 1000) if now_ms is None else now_ms
        self.ensure_tables()
        written = 0
        fine_suffix = None
        for suffix, tier_ms in self.spec.tiers:
            if fine_suffix is None:
                # finest tier folds the raw source, closed at now - grace
                closed_end = ((now_ms - self.grace_ms) // tier_ms) * tier_ms
                written += self._advance(
                    suffix, tier_ms, self.source, self.spec.value_col,
                    raw_source=True, closed_end=closed_end,
                )
            else:
                # coarser tiers fold the next-finer tier, closed at the
                # finer watermark (its buckets are final below it)
                fine_wm = self.state.watermark(fine_suffix)
                if fine_wm is None:
                    continue
                closed_end = (fine_wm // tier_ms) * tier_ms
                written += self._advance(
                    suffix, tier_ms,
                    rollup_table_name(self.source, fine_suffix),
                    None, raw_source=False, closed_end=closed_end,
                )
            fine_suffix = suffix
        self.rows_written += written
        return written

    def _advance(
        self, suffix: str, tier_ms: int, src_table: str,
        value_col: Optional[str], raw_source: bool, closed_end: int,
    ) -> int:
        wm = self.state.watermark(suffix)
        if wm is None:
            wm = self._derive_watermark(suffix, tier_ms, src_table)
            if wm is None:
                return 0  # source empty — nothing to roll yet
        if closed_end <= wm:
            return 0
        if closed_end - wm > 5 * tier_ms:
            # a normal round closes ~1 bucket; a multi-bucket advance is
            # restart catch-up or initial backfill — journal it so an
            # operator can see the recovery (and that it happened ONCE)
            from ..utils.events import record_event

            record_event(
                "rollup_catchup",
                table=rollup_table_name(self.source, suffix),
                tier=suffix,
                buckets=(closed_end - wm) // tier_ms,
                from_ms=wm, to_ms=closed_end,
            )
        ts = self.spec.ts_col
        keys = [f"time_bucket({_q(ts)}, '{tier_ms}ms')"] + [
            _q(t) for t in self.spec.tags
        ]
        if raw_source:
            v = _q(value_col)
            aggs = (
                f"sum({v}) AS agg_sum, count({v}) AS agg_count, "
                f"min({v}) AS agg_min, max({v}) AS agg_max"
            )
        else:
            aggs = (
                "sum(agg_sum) AS agg_sum, sum(agg_count) AS agg_count, "
                "min(agg_min) AS agg_min, max(agg_max) AS agg_max"
            )
        tag_sel = "".join(f", {_q(t)}" for t in self.spec.tags)
        sql = (
            f"SELECT {keys[0]} AS __bucket{tag_sel}, {aggs} "
            f"FROM {_q(src_table)} "
            f"WHERE {_q(ts)} >= {wm} AND {_q(ts)} < {closed_end} "
            f"GROUP BY {', '.join(keys)}"
        )
        out = self.conn.execute(sql).to_pylist()
        rows = []
        for r in out:
            if not r.get("agg_count"):
                # a bucket whose every value is NULL has no partials to
                # store (the rewrite serves such groups as absent —
                # documented edge; raw SQL would show NULL aggregates)
                continue
            row = {t: r[t] for t in self.spec.tags}
            row[ts] = int(r["__bucket"])
            row["agg_sum"] = float(r["agg_sum"])
            row["agg_count"] = float(r["agg_count"])
            row["agg_min"] = float(r["agg_min"])
            row["agg_max"] = float(r["agg_max"])
            rows.append(row)
        if rows:
            self._write(rollup_table_name(self.source, suffix), rows)
        self.state.set_watermark(suffix, closed_end)
        return len(rows)

    def _derive_watermark(
        self, suffix: str, tier_ms: int, src_table: str
    ) -> Optional[int]:
        """Cold start (no persisted state): resume from the last durable
        rollup bucket when the table has rows (crash recovery — never
        re-derive from 'now', that would GAP the history), else begin at
        the source's first bucket (initial backfill)."""
        name = rollup_table_name(self.source, suffix)
        ts = self.spec.ts_col
        if self.conn.catalog.open(name) is not None:
            out = self.conn.execute(
                f"SELECT max({_q(ts)}) AS m FROM {_q(name)}"
            ).to_pylist()
            if out and out[0]["m"] is not None:
                return int(out[0]["m"]) + tier_ms
        out = self.conn.execute(
            f"SELECT min({_q(ts)}) AS m FROM {_q(src_table)}"
        ).to_pylist()
        if not out or out[0]["m"] is None:
            return None
        return (int(out[0]["m"]) // tier_ms) * tier_ms

    def _write(self, table_name: str, rows: list[dict]) -> None:
        if self._write_rows is not None:
            self._write_rows(table_name, rows)
            return
        table = self.conn.catalog.open(table_name)
        rg = RowGroup.from_rows(table.schema, rows)
        from ..engine.instance import nonblocking_backpressure

        with nonblocking_backpressure():
            table.write(rg)


def _sync_ttl(table, ttl_s: float) -> None:
    """The configured ladder TTL wins over whatever the table carries
    (same contract as the self-monitoring retention knob): 0 = keep
    forever (disables enable_ttl)."""
    datas = table.physical_datas()
    if not datas:
        return
    cur = datas[0].options
    want_enable = ttl_s > 0
    want_ttl_ms = int(ttl_s * 1000) if want_enable else cur.ttl_ms
    if cur.enable_ttl == want_enable and cur.ttl_ms == want_ttl_ms:
        return
    import dataclasses

    table.alter_options(
        dataclasses.replace(cur, enable_ttl=want_enable, ttl_ms=want_ttl_ms)
    )
