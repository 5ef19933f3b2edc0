"""Parity of the port's hash segment arm (B2d) with the JAX package's.

- ``hash_segment_agg_plain`` against the reference's jitted
  ``hash_segment_agg`` on the same numpy inputs: counts, mins and maxs
  bit-equal, sums within ``torch_parity.SUM_RTOL`` of the segment's sum
  of |x|. Few shapes: the reference's per-slot aggregate is a one-hot
  over H slots, O(N * H) memory on the CPU.
- ``hash_slots_for``/``default_hash_slots`` and the router's ``hash``
  candidacy and seed against the reference's over a grid.
- The ``HORAEDB_SEGMENT_IMPL=hash`` pin in every wrapper, B1d included.
- The special-float rule: the port's hash arm follows the scatter arm
  (ROADMAP queue C); the reference's spreads NaN through its one-hot.
- The sparse-domain panels as SQL at 64 hosts x 2 h against the
  reference's ``connect()``.
"""

from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horaedb_tpu
import horaedb_tpu_torch
from horaedb_tpu.ops import encoding as jenc
from horaedb_tpu.ops import hash_agg as ref_hash
from horaedb_tpu.ops import scan_agg as ref
from horaedb_tpu.query import path_router as ref_router
from horaedb_tpu_torch.ops import hash_agg as port_hash
from horaedb_tpu_torch.ops import scan_agg as port
from horaedb_tpu_torch.query import path_router as port_router
from horaedb_tpu_torch.tools import tsbs

from torch_parity import assert_bit_equal, assert_state_equal, rows_match, segment_abs_sums

# one jitted reference program; the probe rounds are read while tracing,
# so each shape below has one rounds value
_ref_hash = jax.jit(ref_hash.hash_segment_agg, static_argnums=(3, 4, 5))

# (rows, n_seg, H, F, need_minmax, rounds): N * H stays <= 2**21
SHAPES = {
    "dense-256": (4096, 4096, 256, 3, True, 2),
    "overflow-16": (2048, 65536, 16, 1, True, 1),
    "wide-512": (4096, 262144, 512, 0, False, 4),
}


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


def _inputs(rng, n, n_seg, live, F, sort):
    """``n`` rows over ``live`` segments scattered across [0, n_seg), 80%
    kept; values with no NaN or zero (the reference's arms differ there)."""
    segs = rng.choice(n_seg, size=live, replace=False)
    seg = segs[rng.integers(0, live, n)].astype(np.int32)
    if sort:
        seg = np.sort(seg)
    m = rng.random(n) < 0.8
    vals = (rng.normal(0, 20, (F, n)) + 0.25).astype(np.float32)
    return seg, m, vals


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("live,sort", [(40, False), (700, True), (3000, False)])
def test_plain_hash_matches_reference(monkeypatch, shape, live, sort):
    n, n_seg, H, F, need_minmax, rounds = SHAPES[shape]
    monkeypatch.setenv("HORAEDB_HASH_PROBE_ROUNDS", str(rounds))
    rng = np.random.default_rng(_seed(shape, live, sort))
    seg, m, vals = _inputs(rng, n, n_seg, live, F, sort)
    want = _ref_hash(jnp.asarray(seg), jnp.asarray(m), jnp.asarray(vals) if F else None,
                     n_seg, need_minmax, H)
    overflow = torch.zeros(1, dtype=torch.int64)
    got = port_hash.hash_segment_agg_plain(
        torch.from_numpy(seg), torch.from_numpy(m), torch.from_numpy(vals) if F else None,
        n_seg, need_minmax, H, overflow=overflow)
    assert_bit_equal(got[0].numpy(), np.asarray(want[0]), f"{shape} counts")
    if F:
        abs_sums = segment_abs_sums(seg, m, vals, n_seg)
        assert_state_equal([g.numpy() for g in got], [np.asarray(w) for w in want], abs_sums,
                           need_minmax, shape)
    # every kept row is counted once, in a slot or through the overflow
    assert int(got[0].sum()) == int(m.sum())
    if live > H:
        assert int(overflow) > 0  # more live segments than slots


def test_overflow_counts_the_unplaced_rows(monkeypatch):
    """Rows of one segment place together or not at all; with one probe
    round and two segments hashing to one slot, the larger id overflows."""
    monkeypatch.setenv("HORAEDB_HASH_PROBE_ROUNDS", "1")
    H = 16
    ids = np.arange(1, 5000)
    h = ((ids.astype(np.uint64) * 2654435769) & 0xFFFFFFFF) >> np.uint64(28)
    a = int(ids[0])
    b = int(ids[1:][h[1:] == h[0]][0])  # the next id sharing a's slot
    seg = torch.tensor([b, a, b, a, b], dtype=torch.int32)
    m = torch.ones(5, dtype=torch.bool)
    overflow = torch.zeros(1, dtype=torch.int64)
    counts, _, _, _ = port_hash.hash_segment_agg_plain(seg, m, None, b + 1, True, H, overflow)
    assert int(overflow) == 3 and counts[a] == 2 and counts[b] == 3


@pytest.mark.parametrize("cap", [None, "16", "256", "100000"])
def test_hash_slot_sizing_matches_reference(monkeypatch, cap):
    if cap is None:
        monkeypatch.delenv("HORAEDB_HASH_MAX_SLOTS", raising=False)
    else:
        monkeypatch.setenv("HORAEDB_HASH_MAX_SLOTS", cap)
    for n_seg in (1, 8, 64, 100, 4096, 65536, 262144, 4_194_304):
        assert port_hash.default_hash_slots(n_seg) == ref_hash.default_hash_slots(n_seg)
        for est in (None, 0, 1, 4, 100, 480, 960, 11_520, 10**6):
            assert port_hash.hash_slots_for(n_seg, est) == ref_hash.hash_slots_for(n_seg, est), (
                n_seg, est)


def test_router_hash_candidacy_and_seed_match_reference():
    for n_seg in (8, 64, 65, 128, 512, 513, 1024, 8192, 65536, 262144, 4_194_304):
        for est in (None, 1, 8, 16, 64, 100, 480, 960, 1920, 4000, 11_520, 96_000):
            for n_rows in (100, 10**6):
                want = "hash" in ref_router.candidate_kernels(n_seg, n_rows, est)
                got = "hash" in port_router.candidate_kernels(n_seg, n_rows, est, 5, True)
                assert got == want, (n_seg, est, n_rows)
            assert (port_router.seed_kernel(n_seg, est, torch.device("cpu"))
                    == ref_router.seed_kernel(n_seg, est, "cpu")), (n_seg, est)


@pytest.mark.parametrize("name,n_seg,est", [
    ("single-groupby-5-8-1", 64, 60),
    ("double-groupby-all", 4096 * 32, 96_000),
    ("flood", 4096, 4000),
    ("readme", 128, 100),
])
def test_earlier_queries_keep_their_arms(name, n_seg, est):
    """No query of the earlier chip phases is a hash candidate, so their
    routing does not change."""
    assert "hash" not in port_router.candidate_kernels(n_seg, 34_560_000, est, 10, True)
    assert port_router.seed_kernel(n_seg, est, torch.device("cpu")) == "scatter"


def test_sparse_panels_seed_hash():
    # sparse-8x1h and sparse-16x12h on the 4000-host table
    assert port_router.seed_kernel(4096 * 64, 480, torch.device("cuda")) == "hash"
    assert port_hash.hash_slots_for(4096 * 64, 480) == 2048
    assert port_router.seed_kernel(4096 * 1024, 11_520, torch.device("cuda")) == "hash"
    assert port_hash.hash_slots_for(4096 * 1024, 11_520) == 4096
    assert port.block_hash_slots(4096, 5, True) == 2048
    assert port.block_hash_slots(2048, 5, True) == 2048
    assert port.block_hash_slots(4096, 10, True) == 1024
    assert port.block_hash_slots(4096, 0, True) == 4096


# ---- the pin in every wrapper ------------------------------------------------


def _cached_parts(rng, n_series=12, per=300):
    codes = np.append(np.repeat(np.arange(n_series), per), n_series).astype(np.int32)
    n = n_series * per
    ts = np.append(np.tile(np.arange(per) * 100, n_series), -1).astype(np.int32)
    vals = np.round(rng.normal(0, 20, (2, n + 1))).astype(np.float32)
    gos = np.append(rng.integers(0, 512, n_series), 0).astype(np.int32)
    allow = np.append(np.ones(n_series, bool), False)
    return codes, ts, vals, gos, allow


def _call_wrapper(wrapper, rng, impl, overflow=None):
    kw = dict(n_groups=512, n_buckets=16, n_agg_fields=2, numeric_filters=(),
              need_minmax=True, segment_impl=impl)
    if wrapper == "fused":
        g = rng.integers(0, 512, 3000).astype(np.int32)
        b = rng.integers(0, 16, 3000).astype(np.int32)
        batch = jenc.build_padded_batch(g, b, rng.random(3000) < 0.9,
                                        list(rng.normal(0, 9, (2, 3000)).astype(np.float32)))
        out = port.fused_scan_agg(
            torch.from_numpy(batch.group_codes), torch.from_numpy(batch.bucket_ids),
            torch.from_numpy(batch.mask), torch.from_numpy(batch.values),
            torch.zeros(0), overflow=overflow, **kw)
        return [o.reshape(-1) for o in out]
    codes, ts, vals, gos, allow = _cached_parts(rng)
    n = len(codes) - 1
    idx = np.arange(5, n - 7, 3, dtype=np.int32)
    if wrapper == "b1d":
        out = port.selective_cached_scan_agg(
            torch.from_numpy(idx), torch.from_numpy(codes), torch.from_numpy(ts),
            torch.from_numpy(vals), torch.from_numpy(gos), torch.from_numpy(allow),
            torch.zeros(0), 0, 30_000, 0, 2_000, overflow=overflow, **kw)
        return [o.reshape(-1) for o in out]
    selective = wrapper == "cached_selective"
    dyn = port.pack_dyn([], 0, 30_000, 0, 2_000, idx if selective else None)
    packed = port.cached_scan_agg_packed(
        (torch.from_numpy(codes),), (torch.from_numpy(ts),),
        tuple((torch.from_numpy(v.copy()),) for v in vals),
        torch.from_numpy(port.pack_session(gos, allow)), torch.from_numpy(dyn),
        selective=selective, overflow=overflow, **kw)
    return [packed]


@pytest.mark.parametrize("wrapper", ["fused", "cached", "cached_selective", "b1d"])
def test_pin_runs_the_hash_arm_in_every_wrapper(monkeypatch, wrapper):
    seen = []

    def spy(*a, **k):
        seen.append(a[5])  # n_slots
        return port_hash.hash_segment_agg_plain(*a, **k)

    monkeypatch.setattr(port, "hash_segment_agg_plain", spy)
    monkeypatch.delenv("HORAEDB_SEGMENT_IMPL", raising=False)
    want = _call_wrapper(wrapper, np.random.default_rng(_seed(wrapper)), "scatter")
    assert seen == []
    monkeypatch.setenv("HORAEDB_SEGMENT_IMPL", "hash")
    overflow = torch.zeros(1, dtype=torch.int64)
    got = _call_wrapper(wrapper, np.random.default_rng(_seed(wrapper)), "auto", overflow)
    assert seen == [port_hash.default_hash_slots(512 * 16)]
    for g, w in zip(got, want):
        assert_bit_equal(g.numpy(), w.numpy(), wrapper)  # one slot a segment: same sums


def test_scan_aggregate_passes_the_routed_slots(monkeypatch):
    seen = []
    monkeypatch.setattr(port, "hash_segment_agg_plain",
                        lambda *a, **k: seen.append(a[5]) or port_hash.hash_segment_agg_plain(
                            *a, **k))
    monkeypatch.delenv("HORAEDB_SEGMENT_IMPL", raising=False)
    rng = np.random.default_rng(3)
    batch = jenc.build_padded_batch(rng.integers(0, 300, 900).astype(np.int32),
                                    np.zeros(900, np.int32), np.ones(900, bool),
                                    [rng.normal(size=900).astype(np.float32)])
    spec = port.ScanAggSpec(n_groups=300, n_buckets=1, n_agg_fields=1,
                            segment_impl="hash", hash_slots=64).padded()
    assert spec.hash_slots == 64 and spec.n_groups == 512
    state = port.scan_aggregate(batch, spec, device=torch.device("cpu"))
    assert seen == [64] and int(state.counts.sum()) == 900


def test_cohort_takes_shared_or_scatter_for_hash():
    assert port.cohort_arm("hash", 4, 2, 64, 1, True) == "shared"
    assert port.cohort_arm("hash", 32, 2, 64, 10, True) == "scatter"  # beside the tile: no room
    assert port.cohort_arm("hash", 2, 2, 4096 * 64, 5, True) == "scatter"


# ---- special floats ------------------------------------------------------------


def test_special_floats_follow_the_scatter_arm():
    """The port's hash arm gives the reference's scatter answer with NaN
    and +-0 among kept and dropped rows; the reference's hash arm spreads
    a NaN through its per-slot one-hot to every occupied segment's sum."""
    rng = np.random.default_rng(11)
    n, G = 3000, 128
    g = rng.integers(0, 40, n).astype(np.int32)
    m = rng.random(n) < 0.8
    v = np.round(rng.normal(0, 5, (2, n))).astype(np.float32)
    v[:, 5], v[:, 6], v[:, 7] = np.nan, -0.0, 0.0
    m[5:8] = True
    g[5:8] = 3
    v[0, 9] = np.nan
    m[9] = False  # a dropped NaN
    batch = jenc.build_padded_batch(g, np.zeros(n, np.int32), m, list(v))
    kw = dict(n_groups=G, n_buckets=1, n_agg_fields=2, numeric_filters=(), need_minmax=True)
    want = ref._fused_scan_agg(batch.group_codes, batch.bucket_ids, batch.mask, batch.values,
                               jnp.zeros(0), segment_impl="scatter", **kw)
    got = port.fused_scan_agg(
        torch.from_numpy(batch.group_codes), torch.from_numpy(batch.bucket_ids),
        torch.from_numpy(batch.mask), torch.from_numpy(batch.values), torch.zeros(0),
        segment_impl="hash", hash_slots=16, **kw)
    abs_sums = segment_abs_sums(g, m, v, G).reshape(2, G, 1)
    assert_state_equal([x.numpy() for x in got], [np.asarray(w) for w in want], abs_sums, True,
                       "hash vs reference scatter")
    assert torch.isnan(got[1][0, 3, 0]) and not torch.isnan(got[1][0, 4, 0])
    ref_hash_out = ref._fused_scan_agg(batch.group_codes, batch.bucket_ids, batch.mask,
                                       batch.values, jnp.zeros(0), segment_impl="hash",
                                       hash_slots=16, **kw)
    clean = (np.asarray(ref_hash_out[0])[:, 0] > 0) & ~np.isnan(np.asarray(got[1])[0, :, 0])
    assert np.isnan(np.asarray(ref_hash_out[1])[0, :, 0][clean]).any()


# ---- the sparse-domain panels as SQL --------------------------------------------

HOSTS, HOURS = 64, 2


def _sparse_sql(hosts, hours) -> str:
    fields = ", ".join(f"max({f}) AS max_{f}" for f in tsbs.CPU_FIELDS[:5])
    host_list = ", ".join(f"'host_{h}'" for h in hosts)
    return (f"SELECT hostname, time_bucket(ts, '1m') AS minute, {fields} FROM cpu "
            f"WHERE hostname IN ({host_list}) AND ts >= 0 AND ts < {hours * 3_600_000} "
            "GROUP BY hostname, time_bucket(ts, '1m') ORDER BY hostname, minute")


SPARSE_8 = _sparse_sql(range(8), HOURS)  # n_seg 64 x 128 = 8192, est 960: seeds hash
SPARSE_16 = _sparse_sql(range(0, HOSTS, 4), HOURS)  # est 1920: a candidate, not the seed


def _load(pkg, db):
    ct = pkg.common_types
    db.execute(
        "CREATE TABLE cpu (hostname string TAG, region string TAG, datacenter string TAG, "
        + ", ".join(f"{f} double" for f in tsbs.CPU_FIELDS)
        + ", ts timestamp NOT NULL, TIMESTAMP KEY(ts)) "
        "ENGINE=Analytic WITH (segment_duration='2h')")
    src = tsbs.generate_cpu(HOSTS, HOURS * 3_600_000)
    t = db.catalog.open("cpu")
    t.write(ct.RowGroup(t.schema, dict(src.columns)))
    t.flush()


@pytest.fixture(scope="module")
def sparse_dbs():
    mp = pytest.MonkeyPatch()
    mp.setenv("HORAEDB_ADAPTIVE_PATH", "0")  # device-first, as the reference's tests pin it
    mp.setenv("HORAEDB_HASH_HOST_MAX_ROWS", "0")  # the reference's hash arm on its device
    # a small table keeps the reference's one-hot over H slots small: at
    # this cap the 8-host panel's 960 segments overflow most of the 256 slots
    mp.setenv("HORAEDB_HASH_MAX_SLOTS", "256")
    mp.delenv("HORAEDB_SEGMENT_IMPL", raising=False)
    ref_db = horaedb_tpu.connect(None)
    port_db = horaedb_tpu_torch.connect(None, device="cpu")
    _load(horaedb_tpu, ref_db)
    _load(horaedb_tpu_torch, port_db)
    want8 = [ref_db.execute(SPARSE_8) for _ in range(3)]
    yield ref_db, port_db, want8
    mp.undo()


def _exact(row, col):
    return None  # keys and maxes: bit-equal


def test_sparse_panel_seeds_hash_in_both_packages(sparse_dbs):
    ref_db, port_db, want8 = sparse_dbs
    assert [w.metrics.get("kernel") for w in want8[1:]] == ["hash", "hash"]
    before = dict(port.PLAIN_CALLS)
    runs, paths = [], []
    for _ in range(3):
        runs.append(port_db.execute(SPARSE_8))
        paths.append(port_db.interpreters.executor.last_path)
    # the first sighting takes the direct path (8 dense groups: scatter),
    # then the cache builds and the router seeds hash
    assert paths == ["device", "device-cached", "device-cached"]
    assert [r.metrics.get("kernel") for r in runs] == ["scatter", "hash", "hash"]
    assert port.PLAIN_CALLS["cached_selective"] - before["cached_selective"] == 2
    for w, r in zip(want8, runs):
        rows = r.to_pylist()
        assert len(rows) == 8 * 120
        rows_match(w.to_pylist(), rows, _exact)


def test_sparse_panel_pinned_to_hash_matches(sparse_dbs, monkeypatch):
    """Pinned, the hash arm takes default_hash_slots (4096, no overflow)
    and gives the same rows."""
    ref_db, port_db, want8 = sparse_dbs
    monkeypatch.setenv("HORAEDB_SEGMENT_IMPL", "hash")
    port_db.execute(SPARSE_8)
    got = port_db.execute(SPARSE_8)
    assert got.metrics.get("kernel") == "hash"
    rows_match(want8[-1].to_pylist(), got.to_pylist(), _exact)


def test_sixteen_host_panel_pinned_to_hash(sparse_dbs, monkeypatch):
    """The 16-host panel is a hash candidate but not its seed: pinned to
    hash it equals the reference's answer and the port's scatter answer."""
    ref_db, port_db, _ = sparse_dbs
    want = ref_db.execute(SPARSE_16).to_pylist()
    monkeypatch.setenv("HORAEDB_SEGMENT_IMPL", "scatter")
    port_db.execute(SPARSE_16)
    scatter = port_db.execute(SPARSE_16)
    assert scatter.metrics.get("kernel") == "scatter"
    monkeypatch.setenv("HORAEDB_SEGMENT_IMPL", "hash")
    got = port_db.execute(SPARSE_16)
    assert port_db.interpreters.executor.last_path == "device-cached"
    assert got.metrics.get("kernel") == "hash"
    assert got.num_rows == 16 * 120
    rows_match(want, got.to_pylist(), _exact)
    rows_match(scatter.to_pylist(), got.to_pylist(), _exact)
