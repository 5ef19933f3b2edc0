"""Compaction and the read-path merge of the port against the JAX package's.

The same overlapping L0 runs (made from a seed with numpy) are written and
flushed into a table of each package, then ``Compactor(table).compact()``
runs in each. The compacted L1 SSTs must hold the same rows in the same
(tsid, t) order. The port's merges run on ``device="cpu"``, through the
plain versions of the merge-dedup kernel, as the counters show.
"""

from __future__ import annotations

import numpy as np
import pytest

import horaedb_tpu
import horaedb_tpu_torch
from horaedb_tpu.common_types import ColumnSchema as RefColumn, DatumKind as RefKind
from horaedb_tpu.common_types import RowGroup as RefRows, Schema as RefSchema
from horaedb_tpu.engine.compaction import Compactor as RefCompactor
from horaedb_tpu.engine.instance import EngineConfig as RefConfig, Instance as RefInstance
from horaedb_tpu.engine.options import TableOptions as RefOptions
from horaedb_tpu.engine.sst.reader import SstReader as RefReader
from horaedb_tpu.utils.object_store import MemoryStore as RefStore
from horaedb_tpu_torch.common_types import ColumnSchema, DatumKind, RowGroup, Schema
from horaedb_tpu_torch.engine import compaction as port_compaction
from horaedb_tpu_torch.engine.compaction import Compactor
from horaedb_tpu_torch.engine.instance import EngineConfig, Instance
from horaedb_tpu_torch.engine.options import TableOptions
from horaedb_tpu_torch.engine.sst.reader import SstReader
from horaedb_tpu_torch.ops import merge_dedup as md
from horaedb_tpu_torch.utils.object_store import MemoryStore

from torch_parity import rows_match

HOUR = 3_600_000
RUNS, PER, SERIES = 8, 800, 7

REF = (RefColumn, RefKind, RefRows, RefSchema, RefCompactor, RefConfig, RefInstance,
       RefOptions, RefReader, RefStore)
PORT = (ColumnSchema, DatumKind, RowGroup, Schema, Compactor, EngineConfig, Instance,
        TableOptions, SstReader, MemoryStore)


def _runs(seed=3):
    rng = np.random.default_rng(seed)
    return [
        [{"name": f"h{rng.integers(0, SERIES)}", "value": float(rng.random()),
          "t": int(rng.integers(0, HOUR))} for _ in range(PER)]
        for _ in range(RUNS)
    ]


def _compacted(pkg, runs, primary_key=None, **opts):
    """Write and flush ``runs`` as L0 SSTs, compact, and return the L1
    SSTs' rows in file order plus the compaction result."""
    Column, Kind, Rows, Schema_, Compactor_, Config, Instance_, Options, Reader, Store = pkg
    schema = Schema_.build(
        [Column("name", Kind.STRING, is_tag=True), Column("value", Kind.DOUBLE),
         Column("t", Kind.TIMESTAMP)],
        timestamp_column="t", primary_key=primary_key,
    )
    config = Config(compaction_l0_trigger=1000)
    inst = Instance_(Store(), config) if pkg is REF else Instance_(Store(), "cpu", config)
    table = inst.create_table(
        0, 1, "demo", schema, Options.from_kv({"segment_duration": "1h", **opts}))
    for rows in runs:
        inst.write(table, Rows.from_rows(table.schema, rows))
        inst.flush_table(table)
    assert len(table.version.levels.files_at(0)) == len(runs)
    result = Compactor_(table).compact()
    out = []
    for h in table.version.levels.files_at(1):
        out += Reader(table.store, h.path).read(table.schema).to_pylist()
    return out, result


@pytest.mark.parametrize("chunk_rows", [None, "500"])
@pytest.mark.parametrize("mode,kind", [("overwrite", "rk"), ("append", "f32")])
def test_compaction_matches_reference(monkeypatch, chunk_rows, mode, kind):
    if chunk_rows:  # the tsid-range chunked, pipelined merge
        monkeypatch.setenv("HORAEDB_MERGE_CHUNK_ROWS", chunk_rows)
    runs = _runs()
    want, want_res = _compacted(REF, runs, update_mode=mode)
    md.reset_counts()
    got, got_res = _compacted(PORT, runs, update_mode=mode)
    n_chunks = port_compaction.merge_chunk_count(RUNS * PER)
    assert (n_chunks > 1) == bool(chunk_rows)
    # one launch of the kind per chunk (a chunk can be empty), none else
    assert 1 <= md.PLAIN_CALLS[kind] <= n_chunks and sum(md.PLAIN_CALLS.values()) == \
        md.PLAIN_CALLS[kind]
    assert not any(md.LAUNCHES.values())
    assert got_res.rows_written == want_res.rows_written == len(want)
    assert got == want  # every column, exactly, in file order
    keys = [(r["tsid"], r["t"]) for r in got]
    assert keys == sorted(keys)  # globally (tsid, t)-sorted across chunks
    if mode == "overwrite":
        assert len(set(keys)) == len(keys)
        last = {}
        for run in runs:
            for r in run:
                last[(r["name"], r["t"])] = r["value"]
        assert {(r["name"], r["t"]): r["value"] for r in got} == last
    else:
        assert len(got) == RUNS * PER


def test_explicit_primary_key_takes_the_host_path():
    """No tsid column: compaction sorts on the host in both packages (no
    merge kind runs) and they agree."""
    runs = _runs(seed=5)
    want, _ = _compacted(REF, runs, primary_key=["name", "t"])
    md.reset_counts()
    got, _ = _compacted(PORT, runs, primary_key=["name", "t"])
    assert not any(md.PLAIN_CALLS.values()) and not any(md.LAUNCHES.values())
    assert got == want
    keys = [(r["name"], r["t"]) for r in got]
    assert keys == sorted(keys) and len(set(keys)) == len(keys)


_QUERIES = (
    "SELECT name, count(1) AS c, sum(value) AS s, max(t) AS m FROM demo "
    "GROUP BY name ORDER BY name",
    "SELECT name, value, t FROM demo WHERE t < 1800000 ORDER BY name, t",
)


def _sql_answers(pkg_db, runs):
    db = pkg_db
    db.execute("CREATE TABLE demo (name string TAG, value double, t timestamp KEY) "
               "ENGINE=Analytic WITH (segment_duration='2h')")
    table = db.catalog.open("demo")
    for rows in runs:
        table.write(rows_of(db, table, rows))
        table.flush()
    return [db.execute(q).to_pylist() for q in _QUERIES]


def rows_of(db, table, rows):
    pkg = horaedb_tpu_torch if isinstance(db, horaedb_tpu_torch.db.Connection) else horaedb_tpu
    return pkg.common_types.RowGroup.from_rows(table.schema, rows)


@pytest.mark.parametrize("min_rows,routed", [("0", True), (None, False)])
def test_read_merge_matches_reference(monkeypatch, min_rows, routed):
    """SQL over overlapping SSTs: with HORAEDB_DEVICE_MERGE_MIN_ROWS=0 the
    port's read merge takes the device route (the f32 kind's plain version
    on a CPU table); unset, a CPU table keeps the host lexsort. The
    answers match the JAX package's either way."""
    if min_rows is not None:
        monkeypatch.setenv("HORAEDB_DEVICE_MERGE_MIN_ROWS", min_rows)
    monkeypatch.setenv("HORAEDB_ADAPTIVE_PATH", "0")
    runs = _runs(seed=9)
    # no compaction: the reads merge all eight L0 runs
    quiet = dict(compaction_l0_trigger=10**9, compaction_interval_s=0)
    want = _sql_answers(horaedb_tpu.connect(None, engine_config=RefConfig(**quiet)), runs)
    md.reset_counts()
    got = _sql_answers(
        horaedb_tpu_torch.connect(None, device="cpu", engine_config=EngineConfig(**quiet)),
        runs)
    assert (md.PLAIN_CALLS["f32"] > 0) == routed
    assert sum(md.PLAIN_CALLS.values()) == md.PLAIN_CALLS["f32"]
    rows_match(want[0], got[0], lambda r, k: 1.0 * r["c"] if k == "s" else None)
    assert got[1] == want[1]


def test_tables_carry_the_connection_device():
    db = horaedb_tpu_torch.connect(None, device="cpu")
    db.execute("CREATE TABLE x (h string TAG, v double, t timestamp KEY) ENGINE=Analytic")
    assert db.instance.device.type == "cpu"
    assert all(td.device == db.device for td in db.catalog.open("x").physical_datas())
    with pytest.raises(TypeError):
        Instance(MemoryStore())  # no default device


def test_background_compaction_runs_on_the_table_device():
    """A compaction requested from the background scheduler runs on its
    worker thread, through the merge kind of the table's device."""
    from concurrent.futures import Future

    inst = Instance(MemoryStore(), "cpu", EngineConfig(compaction_l0_trigger=1000))
    schema = Schema.build(
        [ColumnSchema("name", DatumKind.STRING, is_tag=True),
         ColumnSchema("value", DatumKind.DOUBLE), ColumnSchema("t", DatumKind.TIMESTAMP)],
        timestamp_column="t",
    )
    table = inst.create_table(0, 1, "demo", schema,
                              TableOptions.from_kv({"segment_duration": "1h"}))
    for rows in _runs(seed=4)[:3]:
        inst.write(table, RowGroup.from_rows(table.schema, rows))
        inst.flush_table(table)
    md.reset_counts()
    done = Future()
    assert inst._compaction_scheduler().request(table, waiter=done)
    done.result(timeout=120)
    assert md.PLAIN_CALLS["rk"] == 1
    assert len(table.version.levels.files_at(0)) == 0
    assert len(table.version.levels.files_at(1)) == 1
    inst.close()
