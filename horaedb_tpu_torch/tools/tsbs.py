"""TSBS devops cpu-only workload: data generator + benchmark queries
(ref: the reference's TSBS harness, scripts/run-tsbs.sh:36-46 — cpu-only,
N hosts, 10s interval — and BASELINE.md's target query configs).

The generator reproduces the *shape* of tsbs cpu-only: one ``cpu`` table,
``hostname``/``region``/``datacenter`` tags, ten usage_* fields in [0,100],
one point per host per 10s. Values follow a clipped random walk like TSBS
(exact values don't matter for perf; distributions do).

Queries (BASELINE.md configs):
- single-groupby-1-1-1: 1 metric, 1 host, 1 hour,  per-minute max
- single-groupby-5-8-1: 5 metrics, 8 hosts, 1 hour, per-minute max
- double-groupby-all:   10 metrics, all hosts, group by (host, hour)
- high-cpu-all:         rows where usage_user > 90, 12 hours
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..common_types import ColumnSchema, DatumKind, RowGroup, Schema
from ..common_types.schema import compute_tsid

CPU_FIELDS = [
    "usage_user", "usage_system", "usage_idle", "usage_nice", "usage_iowait",
    "usage_irq", "usage_softirq", "usage_steal", "usage_guest", "usage_guest_nice",
]

REGIONS = ["us-east-1", "us-west-1", "eu-west-1", "ap-southeast-1"]
INTERVAL_MS = 10_000  # one point per host per 10s, like TSBS


def cpu_schema() -> Schema:
    cols = [
        ColumnSchema("hostname", DatumKind.STRING, is_tag=True),
        ColumnSchema("region", DatumKind.STRING, is_tag=True),
        ColumnSchema("datacenter", DatumKind.STRING, is_tag=True),
    ]
    cols += [ColumnSchema(f, DatumKind.DOUBLE) for f in CPU_FIELDS]
    cols.append(ColumnSchema("ts", DatumKind.TIMESTAMP))
    return Schema.build(cols, timestamp_column="ts")


def generate_cpu(
    scale: int,
    span_ms: int,
    t0: int = 0,
    seed: int = 123,
    n_fields: int = 10,
) -> RowGroup:
    """All points for ``scale`` hosts over ``span_ms``, time-ordered,
    columnar from the start (no per-row Python)."""
    schema = cpu_schema()
    rng = np.random.default_rng(seed)
    n_ticks = max(1, span_ms // INTERVAL_MS)
    n = scale * n_ticks

    host_ids = np.tile(np.arange(scale), n_ticks)
    tick_ids = np.repeat(np.arange(n_ticks), scale)
    ts = (t0 + tick_ids * INTERVAL_MS).astype(np.int64)

    hostnames = np.array([f"host_{i}" for i in range(scale)], dtype=object)
    regions = np.array([REGIONS[i % len(REGIONS)] for i in range(scale)], dtype=object)
    dcs = np.array(
        [f"{REGIONS[i % len(REGIONS)]}{(i // len(REGIONS)) % 3}" for i in range(scale)],
        dtype=object,
    )

    columns = {
        "hostname": hostnames[host_ids],
        "region": regions[host_ids],
        "datacenter": dcs[host_ids],
        "ts": ts,
    }
    # Clipped random walk per host, vectorized over the (tick, host) grid.
    for fi, fname in enumerate(CPU_FIELDS):
        if fi >= n_fields:
            columns[fname] = np.zeros(n)
            continue
        start = rng.uniform(0, 100, scale)
        steps = rng.normal(0, 1.0, (n_ticks, scale))
        walk = np.clip(start[None, :] + np.cumsum(steps, axis=0), 0, 100)
        columns[fname] = walk.reshape(-1)  # (tick-major, host-minor) == row order
    # one hash per host, broadcast to its rows: the same ids as hashing
    # every row's tags, at O(hosts) cost
    columns["tsid"] = compute_tsid([hostnames, regions, dcs])[host_ids]
    return RowGroup(schema, columns)


@dataclass(frozen=True)
class TsbsQuery:
    name: str
    sql: str


def single_groupby(metrics: int, hosts: int, hours: int, t0: int = 0) -> TsbsQuery:
    """tsbs single-groupby-{m}-{h}-{hr}: per-minute max of m metrics over
    h hosts for hr hours."""
    sel_fields = ", ".join(f"max({f}) AS max_{f}" for f in CPU_FIELDS[:metrics])
    host_list = ", ".join(f"'host_{i}'" for i in range(hosts))
    end = t0 + hours * 3_600_000
    return TsbsQuery(
        f"single-groupby-{metrics}-{hosts}-{hours}",
        f"SELECT time_bucket(ts, '1m') AS minute, {sel_fields} FROM cpu "
        f"WHERE hostname IN ({host_list}) AND ts >= {t0} AND ts < {end} "
        f"GROUP BY time_bucket(ts, '1m') ORDER BY minute",
    )


def double_groupby_all(hours: int, t0: int = 0) -> TsbsQuery:
    sel_fields = ", ".join(f"avg({f}) AS avg_{f}" for f in CPU_FIELDS)
    end = t0 + hours * 3_600_000
    return TsbsQuery(
        "double-groupby-all",
        f"SELECT hostname, time_bucket(ts, '1h') AS hour, {sel_fields} FROM cpu "
        f"WHERE ts >= {t0} AND ts < {end} "
        f"GROUP BY hostname, time_bucket(ts, '1h') ORDER BY hostname, hour",
    )


def high_cpu_all(hours: int, t0: int = 0) -> TsbsQuery:
    end = t0 + hours * 3_600_000
    return TsbsQuery(
        "high-cpu-all",
        f"SELECT count(*) AS c, max(usage_user) AS peak FROM cpu "
        f"WHERE usage_user > 90 AND ts >= {t0} AND ts < {end}",
    )
