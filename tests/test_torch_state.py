"""State carried across from the JAX package to the port.

A data directory the JAX package wrote (WAL, manifest, Parquet SSTs) opens
in the port and returns the same rows; a JAX scan-cache entry's resident
columns rebuild on a torch device (``convert.entry_from_reference``) and
give the port's kernel the same answer as the JAX kernel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horaedb_tpu
import horaedb_tpu_torch
from horaedb_tpu.ops import scan_agg as ref_kernels
from horaedb_tpu_torch.convert import entry_from_reference
from horaedb_tpu_torch.ops import scan_agg as port_kernels

from torch_parity import assert_bit_equal, assert_sums_close, rows_match

DDL = (
    "CREATE TABLE m (host string TAG, dc string TAG, cpu double, mem double, "
    "ts timestamp NOT NULL, TIMESTAMP KEY(ts)) ENGINE=Analytic "
    "WITH (segment_duration='1h')"
)
QUERIES = [
    "SELECT host, ts, cpu, mem FROM m ORDER BY host, ts",
    "SELECT host, count(*) AS c, min(cpu) AS lo, max(mem) AS hi FROM m GROUP BY host ORDER BY host",
    "SELECT dc, time_bucket(ts, '30m') AS b, max(cpu) AS p FROM m "
    "WHERE mem > 40 GROUP BY dc, time_bucket(ts, '30m') ORDER BY dc, b",
]


def _insert_sql(rng, start: int, n: int) -> str:
    vals = []
    for i in range(n):
        h = int(rng.integers(0, 6))
        vals.append(
            f"('h{h}', 'dc{h % 2}', {float(rng.integers(0, 1000)) / 10}, "
            f"{float(rng.integers(0, 1000)) / 10}, {start + i * 7_001})"
        )
    return "INSERT INTO m (host, dc, cpu, mem, ts) VALUES " + ", ".join(vals)


@pytest.fixture()
def reference_dir(tmp_path, monkeypatch):
    """A data directory written by the JAX package: two flushed SSTs and
    unflushed rows that live only in the WAL. Returns (path, rows the JAX
    package answered before closing)."""
    monkeypatch.setenv("HORAEDB_ADAPTIVE_PATH", "0")
    path = str(tmp_path / "data")
    rng = np.random.default_rng(9)
    db = horaedb_tpu.connect(path)
    db.execute(DDL)
    db.execute(_insert_sql(rng, 0, 300))
    db.catalog.open("m").flush()
    db.execute(_insert_sql(rng, 2_500_000, 300))
    db.catalog.open("m").flush()
    db.execute(_insert_sql(rng, 5_000_000, 120))  # WAL only
    want = [db.execute(q).to_pylist() for q in QUERIES]
    db.close()
    return path, want


def test_port_opens_reference_data_directory(reference_dir):
    path, want = reference_dir
    db = horaedb_tpu_torch.connect(path, device="cpu")
    try:
        for q, w in zip(QUERIES, want):
            for _ in range(3):  # direct, then the cache build and hits
                rows_match(w, db.execute(q).to_pylist(), lambda r, c: None)
    finally:
        db.close()


def test_port_writes_stay_readable_by_reference(reference_dir):
    """The port appends and flushes into the same directory; the JAX
    package reads both generations back."""
    path, _ = reference_dir
    rng = np.random.default_rng(10)
    db = horaedb_tpu_torch.connect(path, device="cpu")
    db.execute(_insert_sql(rng, 7_000_000, 50))
    db.catalog.open("m").flush()
    want = [db.execute(q).to_pylist() for q in QUERIES]
    db.close()
    ref = horaedb_tpu.connect(path)
    try:
        for q, w in zip(QUERIES, want):
            rows_match(w, ref.execute(q).to_pylist(), lambda r, c: None)
    finally:
        ref.close()


def _reference_entry(db, table: str, names: list[str], agg: set):
    """A JAX scan-cache entry's resident parts as numpy, plus layouts."""
    entry = db.interpreters.executor.scan_cache._entries[table]
    arrays = {}
    for k, p in enumerate(entry.series_parts):
        arrays[f"series_codes/{k}"] = np.asarray(p)
    for k, p in enumerate(entry.ts_parts):
        arrays[f"ts_rel/{k}"] = np.asarray(p)
    layouts = {
        "series_codes": entry.series_layout,
        "ts_rel": entry.ts_layout,
        "value": [],
    }
    jvalues = []
    for f, name in enumerate(names):
        dev = entry.value_cols_dev[name]
        parts = dev.parts if hasattr(dev, "parts") else (dev,)
        jvalues.append(tuple(parts))
        for k, p in enumerate(parts):
            arrays[f"value/{f}/{k}"] = np.asarray(p)
        layouts["value"].append(entry.value_layout(name, full_decode=name in agg))
    return entry, arrays, layouts, tuple(jvalues)


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16"])
def test_entry_from_reference_feeds_identical_columns(monkeypatch, cache_dtype):
    """Encoded resident columns built by the JAX package's cache (delta
    series codes, delta or dict timestamps, dict or bf16 values) convert
    to the port's entry; both kernels give the same packed state."""
    monkeypatch.setenv("HORAEDB_ADAPTIVE_PATH", "0")
    monkeypatch.setenv("HORAEDB_CACHE_DTYPE", cache_dtype)
    from horaedb_tpu.tools import tsbs

    db = horaedb_tpu.connect(None)
    db.execute(
        "CREATE TABLE cpu (hostname string TAG, region string TAG, "
        "datacenter string TAG, "
        + ", ".join(f"{f} double" for f in tsbs.CPU_FIELDS)
        + ", ts timestamp NOT NULL, TIMESTAMP KEY(ts)) ENGINE=Analytic"
    )
    src = tsbs.generate_cpu(30, 3_600_000)
    src.columns["usage_nice"] = np.round(src.columns["usage_nice"])  # dict-coded
    t = db.catalog.open("cpu")
    t.write(src)
    t.flush()
    sql = (
        "SELECT hostname, max(usage_user) AS a, max(usage_nice) AS b FROM cpu "
        "WHERE usage_nice > 40 GROUP BY hostname"
    )
    for _ in range(3):
        db.execute(sql)
    names = ["usage_user", "usage_nice"]
    entry, arrays, layouts, jvalues = _reference_entry(db, "cpu", names, set(names))
    port_entry = entry_from_reference(arrays, layouts, "cpu")
    assert port_entry.padded_rows == entry.padded_rows
    S = entry.n_series
    gos = np.append(np.arange(S) % 8, 0).astype(np.int32)
    allow = np.append(np.arange(S) % 3 != 0, False)
    session = ref_kernels.pack_session(gos, allow)
    dyn = ref_kernels.pack_dyn([40.0], 0, 3_000_000, 0, 600_000)
    kw = dict(
        n_groups=8, n_buckets=8, n_agg_fields=2,
        numeric_filters=ref_kernels.encode_filter_ops(((1, ">"),)), need_minmax=True,
        segment_impl="scatter",
    )
    want = ref_kernels.cached_scan_agg_packed(
        entry.series_parts, entry.ts_parts, jvalues, jnp.asarray(session), jnp.asarray(dyn),
        value_layouts=tuple(layouts["value"]), ts_layout=entry.ts_layout,
        series_layout=entry.series_layout, **kw,
    )
    got = port_kernels.cached_scan_agg_packed(
        *port_entry.kernel_args().values(), torch.from_numpy(session), torch.from_numpy(dyn),
        **port_entry.layout_kwargs(), **kw,
    )
    gb = 64
    want = np.asarray(want)
    got = got.numpy()
    assert_bit_equal(got[:gb], want[:gb], "counts")
    # TSBS values are >= 0, so sum|x| is the sum itself
    assert_sums_close(got[gb:3 * gb], want[gb:3 * gb], np.abs(want[gb:3 * gb]), "sums")
    assert_bit_equal(got[3 * gb:], want[3 * gb:], "mins/maxs")
    assert got[:gb].view(np.int32).sum() > 0


def test_compaction_host_merge_matches_reference(monkeypatch):
    """Overlapping L0 runs (overwrites included) compact into the same rows
    in both packages: the port merges on the host until its device
    merge-dedup kernel lands."""
    monkeypatch.setenv("HORAEDB_ADAPTIVE_PATH", "0")
    out = []
    for pkg, kw in ((horaedb_tpu, {}), (horaedb_tpu_torch, {"device": "cpu"})):
        rng = np.random.default_rng(21)
        # compaction runs only when asked, so both packages merge the same runs
        config = pkg.engine.instance.EngineConfig(background_compaction=False)
        db = pkg.connect(None, engine_config=config, **kw)
        db.execute(DDL)
        for k in range(5):
            # the same timestamps each round: later rounds overwrite
            db.execute(_insert_sql(rng, k * 50_000, 200))
            db.catalog.open("m").flush()
        table = db.catalog.open("m")
        data = table.physical_datas()[0]
        db.instance.compact_table(data)
        assert len(data.version.levels.all_files()) < 5
        out.append([db.execute(q).to_pylist() for q in QUERIES])
    for want, got in zip(*out):
        rows_match(want, got, lambda r, c: None)
