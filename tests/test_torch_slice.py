"""The port's main path against the JAX package's, as SQL.

The four BASELINE queries (TSBS single-groupby-5-8-1, double-groupby-all
and high-cpu-all, and the README's avg(value) GROUP BY name) run four
times each through ``horaedb_tpu.connect(None)`` and through
``horaedb_tpu_torch.connect(None, device="cpu")`` on the same generated
rows. The rows must match under the shared tolerances, and the port must
serve the first run through the direct kernel path and the later runs
from the resident cache (``device-cached``), as the plain versions' call
counters show.
"""

from __future__ import annotations

import numpy as np
import pytest

import horaedb_tpu
import horaedb_tpu_torch
from horaedb_tpu.tools import tsbs as ref_tsbs
from horaedb_tpu_torch.ops import scan_agg as port_kernels
from horaedb_tpu_torch.tools import tsbs

from torch_parity import rows_match

HOSTS = 40  # > 4 x 8, so single-groupby-5-8-1 takes the selective gather
HOURS = 2
DEMO_ROWS = 5000


def _cpu_table_sql() -> str:
    return (
        "CREATE TABLE cpu (hostname string TAG, region string TAG, "
        "datacenter string TAG, "
        + ", ".join(f"{f} double" for f in tsbs.CPU_FIELDS)
        + ", ts timestamp NOT NULL, TIMESTAMP KEY(ts)) "
        "ENGINE=Analytic WITH (segment_duration='2h')"
    )


def _demo_columns():
    rng = np.random.default_rng(123)
    names = np.array([f"host_{i}" for i in rng.integers(0, 100, DEMO_ROWS)], dtype=object)
    return {
        "t": rng.integers(0, 3_600_000, DEMO_ROWS).astype(np.int64),
        "name": names,
        "value": rng.normal(10.0, 3.0, DEMO_ROWS),
    }


def _load(pkg, db):
    ct = pkg.common_types
    db.execute(_cpu_table_sql())
    src = tsbs.generate_cpu(HOSTS, HOURS * 3_600_000)
    t = db.catalog.open("cpu")
    t.write(ct.RowGroup(t.schema, dict(src.columns)))
    t.flush()
    db.execute(
        "CREATE TABLE demo (name string TAG, value double, t timestamp KEY) "
        "ENGINE=Analytic WITH (segment_duration='2h')"
    )
    cols = _demo_columns()
    d = db.catalog.open("demo")
    cols["tsid"] = ct.schema.compute_tsid([cols["name"]])
    d.write(ct.RowGroup(d.schema, cols))
    d.flush()


@pytest.fixture(scope="module")
def dbs():
    mp = pytest.MonkeyPatch()
    # device-first routing, as the JAX package's own tests pin it
    mp.setenv("HORAEDB_ADAPTIVE_PATH", "0")
    ref = horaedb_tpu.connect(None)
    port = horaedb_tpu_torch.connect(None, device="cpu")
    _load(horaedb_tpu, ref)
    _load(horaedb_tpu_torch, port)
    yield ref, port, set()  # tables queried so far
    mp.undo()


def _abs_means():
    """Per-group mean |x| in float64 from the generated rows: the scale of
    the avg tolerance (sum|x| / count)."""
    src = tsbs.generate_cpu(HOSTS, HOURS * 3_600_000)
    ts = src.columns["ts"]
    host = src.columns["hostname"]
    out = {}

    def add(key, field, mask):
        v = np.abs(np.asarray(src.columns[field], dtype=np.float64)[mask])
        out[(key, field)] = v.mean() if len(v) else 0.0

    # single-groupby: per minute over 8 hosts, first hour
    sel = np.isin(host, [f"host_{i}" for i in range(8)]) & (ts < 3_600_000)
    for minute in np.unique(ts[sel] // 60_000 * 60_000):
        m = sel & (ts // 60_000 * 60_000 == minute)
        for f in tsbs.CPU_FIELDS[:5]:
            add(("sg", int(minute)), f, m)
    for h in np.unique(host):
        for hour in range(HOURS):
            m = (host == h) & (ts // 3_600_000 == hour)
            for f in tsbs.CPU_FIELDS:
                add(("dg", h, hour * 3_600_000), f, m)
    demo = _demo_columns()
    for name in np.unique(demo["name"]):
        v = np.abs(demo["value"][demo["name"] == name])
        out[(("demo", name), "value")] = v.mean()
    return out


SCALES = None


def _scale(query: str):
    global SCALES
    if SCALES is None:
        SCALES = _abs_means()

    def scale(row, col):
        if col.startswith("avg_") and query == "double-groupby-all":
            return SCALES[(("dg", row["hostname"], row["hour"]), col[4:])]
        if col == "a" and query == "readme":
            return SCALES[(("demo", row["name"]), "value")]
        return None  # counts, maxes and keys: exact

    return scale


QUERIES = {
    "single-groupby-5-8-1": tsbs.single_groupby(5, 8, 1).sql,
    "double-groupby-all": tsbs.double_groupby_all(HOURS).sql,
    "high-cpu-all": tsbs.high_cpu_all(HOURS).sql,
    "readme": "SELECT name, avg(value) AS a FROM demo GROUP BY name ORDER BY name",
}


@pytest.mark.parametrize("query", list(QUERIES))
def test_baseline_query_matches_reference(dbs, query):
    ref, port, seen = dbs
    sql = QUERIES[query]
    assert sql == {
        "single-groupby-5-8-1": ref_tsbs.single_groupby(5, 8, 1).sql,
        "double-groupby-all": ref_tsbs.double_groupby_all(HOURS).sql,
        "high-cpu-all": ref_tsbs.high_cpu_all(HOURS).sql,
        "readme": sql,
    }[query]
    table = "demo" if query == "readme" else "cpu"
    first_on_table = table not in seen
    seen.add(table)
    paths = []
    for run in range(4):
        before = dict(port_kernels.PLAIN_CALLS)
        want = ref.execute(sql).to_pylist()
        got_rs = port.execute(sql)
        got = got_rs.to_pylist()
        path = port.interpreters.executor.last_path
        paths.append(path)
        calls = {k: port_kernels.PLAIN_CALLS[k] - before[k] for k in before}
        assert len(got) > 0
        rows_match(want, got, _scale(query))
        if path == "device":
            assert calls == {"direct": 1, "cached": 0, "cached_selective": 0,
                             "cached_cohort": 0}
        else:
            assert path == "device-cached", path
            assert calls["direct"] == 0
            assert calls["cached"] + calls["cached_selective"] == 1
            if query == "single-groupby-5-8-1":
                assert calls["cached_selective"] == 1
    if first_on_table:
        # first sighting of the table: the direct kernel; then the cache
        # builds and serves every later run
        assert paths == ["device"] + ["device-cached"] * 3
    else:
        assert paths == ["device-cached"] * 4


def test_ingest_after_build_folds_the_delta(dbs):
    """Memtable rows written after the cache build are folded on the host
    on top of the kernel's state, in both packages alike."""
    ref, port, seen = dbs
    seen.add("demo")
    sql = "SELECT name, count(*) AS c, max(value) AS m FROM demo GROUP BY name ORDER BY name"
    for db in (ref, port):
        db.execute(sql)
        db.execute(sql)
        db.execute("INSERT INTO demo (name, value, t) VALUES ('host_1', 99.5, 3600001)")
    want = ref.execute(sql).to_pylist()
    got = port.execute(sql).to_pylist()
    assert port.interpreters.executor.last_path == "device-cached"
    rows_match(want, got, lambda r, c: None)
    assert [r for r in got if r["name"] == "host_1"][0]["m"] == 99.5


def test_aggregates_never_move_to_the_host(monkeypatch):
    """The reference's measured device/host routing (HORAEDB_ADAPTIVE_PATH)
    sends some runs of a shape to a numpy aggregate; the port serves every
    run of a kernel-eligible aggregate on the connection's device, whatever
    the knob says."""
    monkeypatch.setenv("HORAEDB_ADAPTIVE_PATH", "1")
    port = horaedb_tpu_torch.connect(None, device="cpu")
    port.execute(
        "CREATE TABLE demo (name string TAG, value double, t timestamp KEY) "
        "ENGINE=Analytic WITH (segment_duration='2h')"
    )
    cols = _demo_columns()
    d = port.catalog.open("demo")
    cols["tsid"] = horaedb_tpu_torch.common_types.schema.compute_tsid([cols["name"]])
    d.write(horaedb_tpu_torch.common_types.RowGroup(d.schema, cols))
    d.flush()
    paths = []
    for _ in range(40):  # past the reference's host sample and two re-probes
        port.execute(QUERIES["readme"])
        paths.append(port.interpreters.executor.last_path)
    assert paths == ["device"] + ["device-cached"] * 39
