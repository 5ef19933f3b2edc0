"""Sharded serving over a device mesh: the port's ``parallel/`` against the
JAX package's.

JAX's mesh is the 8 forced CPU devices of ``tests/conftest.py``; the port
runs the same shards on a logical CPU mesh (``use_mesh(Mesh.logical("cpu",
S))``), where every shard's kernel and the ``mesh_combine`` combine run
their plain versions. ``HORAEDB_DIST_MIN_ROWS`` is set low where a test
needs small tables sharded, as the reference's own tests do.

- The sharded aggregate (direct and cached) against the reference's
  ``dist_scan_aggregate`` / ``make_cached_dist_scan_agg`` (the port's
  ``dist_scan_aggregate`` / ``dist_cached_step``) and against the port's
  single-device kernels: counts bit-equal, sums within
  ``torch_parity.SUM_RTOL``, mins and maxs bit-equal to the port's
  single-device answer, and to the reference's sharded answer except where
  +-0 or NaN cross shards; those cases pin both packages' answers.
- The sharded top-k against the reference's SINGLE-device
  ``raw_topk_packed`` (its sharded top-k does not run under the installed
  jax: ``shard_map(check_rep=...)``) and the port's single-device top-k;
  the sharded selection against the reference's ``dist_raw_select``.
- ``dist_merge_dedup`` against the reference's and the port's single-device
  merge, bit-equal.
- SQL on ``connect(device="cpu")`` under the logical mesh against the
  reference's ``connect()`` on its mesh; the cache's and the executor's
  mesh rules.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import horaedb_tpu
import horaedb_tpu_torch
from horaedb_tpu.ops import encoding as jenc, scan_agg as rS, scan_topk as rT
from horaedb_tpu.parallel import dist_merge as r_merge, dist_raw as r_raw
from horaedb_tpu.parallel.dist_agg import dist_scan_aggregate as r_dist
from horaedb_tpu.parallel.dist_agg import make_cached_dist_scan_agg as r_make_cached
from horaedb_tpu_torch.ops import encoding as penc, merge_dedup as pM, scan_agg as pS
from horaedb_tpu_torch.ops import scan_topk as pT
from horaedb_tpu_torch.parallel import dist_agg, dist_merge, dist_raw
from horaedb_tpu_torch.parallel import mesh as pm
from horaedb_tpu_torch.tools import tsbs

from torch_parity import (
    assert_bit_equal,
    assert_state_equal,
    rows_match,
    segment_abs_sums,
)

OPS = ("=", "!=", "<", "<=", ">", ">=")


def _jmesh(n: int) -> JMesh:
    devs = np.array(jax.devices()[:n])
    assert len(devs) == n, "tests/conftest.py provides 8 CPU devices"
    return JMesh(devs, ("shard",))


# one object: the scan cache keeps an entry while its mesh is the installed one
MESH8 = pm.Mesh.logical("cpu", 8)


@pytest.fixture()
def mesh8():
    with pm.use_mesh(MESH8) as m:
        yield m


# ---- the mesh ------------------------------------------------------------------


def test_serving_mesh_needs_two_cards(monkeypatch):
    """No mesh on the CPU or on one card; all cards from two on, the same
    object while the card set is unchanged; never a logical mesh."""
    assert pm.serving_mesh(device="cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pm.serving_mesh() is None and pm.serving_mesh(device="cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = pm.serving_mesh(device="cuda")
    assert m.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert pm.serving_mesh() is m
    assert pm.serving_mesh(device="cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pm.serving_mesh().size == 2


def test_use_mesh_installs_and_restores():
    assert pm.serving_mesh(device="cpu") is None
    m = pm.Mesh.logical("cpu", 3)
    with pm.use_mesh(m):
        assert pm.serving_mesh(device="cpu") is m and m.size == 3
        with pytest.raises(ValueError, match="installed"):
            pm.serving_mesh(device="cuda")
    assert pm.serving_mesh(device="cpu") is None
    with pytest.raises(ValueError):
        pm.Mesh([])


def test_use_mesh_none_pins_one_device(monkeypatch):
    """``use_mesh(None)`` serves from one device on a host of several cards,
    and an inner ``use_mesh`` still wins inside it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    every = pm.serving_mesh(device="cuda")
    assert every.size == 4
    with pm.use_mesh(None) as m:
        assert m is None
        assert pm.serving_mesh() is None and pm.serving_mesh(device="cuda") is None
        inner = pm.Mesh.logical("cpu", 2)
        with pm.use_mesh(inner):
            assert pm.serving_mesh(device="cpu") is inner
        assert pm.serving_mesh(device="cuda") is None
    assert pm.serving_mesh(device="cuda") is every


# ---- mesh_combine's plain version ------------------------------------------------


def _state(rng, G, B, F, empty=()):
    c = rng.integers(0, 50, (G, B)).astype(np.int32)
    s = rng.normal(0, 10, (F, G, B)).astype(np.float32)
    mn = rng.normal(-5, 3, (F, G, B)).astype(np.float32)
    mx = rng.normal(5, 3, (F, G, B)).astype(np.float32)
    for g in empty:  # an empty segment: the kernels' initial values
        c[g], s[:, g], mn[:, g], mx[:, g] = 0, 0.0, np.inf, -np.inf
    return c, s, mn, mx


@pytest.mark.parametrize("S", [1, 2, 3, 8])
@pytest.mark.parametrize("F", [0, 1, 4])
@pytest.mark.parametrize("need_minmax", [True, False])
def test_combine_both_forms(S, F, need_minmax):
    """Counts add, sums add in shard order, mins/maxs are the extremes; an
    empty segment in some shards takes the others' values; the packed form
    equals the state form."""
    rng = np.random.default_rng(S * 10 + F)
    G, B = 3, 4
    states = [_state(rng, G, B, F, empty=(d % G,)) for d in range(S)]
    got = pS.mesh_combine_state([tuple(torch.from_numpy(x) for x in st) for st in states],
                                need_minmax=need_minmax)
    want_c = sum(st[0] for st in states)
    want_s = states[0][1].copy()
    for st in states[1:]:
        want_s += st[1]  # f32, shard order
    assert_bit_equal(got[0].numpy(), want_c, "counts")
    assert_bit_equal(got[1].numpy(), want_s, "sums")
    if need_minmax:
        assert_bit_equal(got[2].numpy(), np.min([st[2] for st in states], 0), "mins")
        assert_bit_equal(got[3].numpy(), np.max([st[3] for st in states], 0), "maxs")
    else:
        assert not got[2].any() and not got[3].any()
    n_seg = G * B
    packs = []
    for c, s, mn, mx in states:
        parts = [c.reshape(-1).view(np.float32), s.reshape(-1)]
        if need_minmax:
            parts += [mn.reshape(-1), mx.reshape(-1)]
        packs.append(torch.from_numpy(np.concatenate(parts)))
    packed = pS.mesh_combine(torch.stack(packs), n_seg=n_seg, n_agg_fields=F,
                             need_minmax=need_minmax)
    assert packed.shape[0] == pS.packed_len(G, B, F, need_minmax)
    spec = pS.ScanAggSpec(G, B, F, need_minmax=need_minmax)
    un = pS.unpack_packed_state(packed, spec)
    assert_bit_equal(un.counts, got[0].numpy(), "packed counts")
    assert_bit_equal(un.sums.astype(np.float32), got[1].numpy(), "packed sums")
    if need_minmax:
        assert_bit_equal(un.mins.astype(np.float32), got[2].numpy(), "packed mins")
        assert_bit_equal(un.maxs.astype(np.float32), got[3].numpy(), "packed maxs")


def test_combine_keeps_the_single_device_order():
    """-0.0 below +0.0 and NaN winning, in whichever shard they lie, as
    ``fmin_t``/``fmax_t`` do; counts wrap as int32."""
    z, nz, nan = np.float32(0.0), np.float32(-0.0), np.float32("nan")
    cols = [np.array([z, nz, 1.0, nan], np.float32), np.array([nz, z, nan, 2.0], np.float32)]
    for order in (cols, cols[::-1]):
        planes = [[torch.tensor([2**31 - 1, 5], dtype=torch.int32),
                   torch.tensor([1, 5], dtype=torch.int32)], [],
                  [torch.from_numpy(c) for c in order], [torch.from_numpy(c) for c in order]]
        c, _, mn, mx = pS.combine_planes_plain(planes)
        assert c.tolist() == [-(2**31), 10]
        assert_bit_equal(mn.numpy(), np.array([nz, nz, nan, nan], np.float32), "mins")
        assert_bit_equal(mx.numpy(), np.array([z, z, nan, nan], np.float32), "maxs")


def test_combine_checks_its_inputs():
    a = torch.zeros(pS.packed_len(1, 4, 1, True))
    with pytest.raises(ValueError):
        pS.mesh_combine([a, a[:-1]], n_seg=4, n_agg_fields=1, need_minmax=True)
    with pytest.raises(ValueError):
        pS.mesh_combine([], n_seg=4, n_agg_fields=1, need_minmax=True)


# ---- the sharded direct aggregate ------------------------------------------------


def _batches(rng, n, G, B, F, n_fields, special=None):
    g = rng.integers(0, G, n).astype(np.int32)
    b = rng.integers(0, B, n).astype(np.int32)
    m = rng.random(n) < 0.85
    v = np.round(rng.normal(0, 5, (n_fields, n))).astype(np.float32)
    if special is not None:
        g[:], b[:], m[:] = 0, 0, True
        per = n // len(special)
        for d, x in enumerate(special):
            v[:, d * per:(d + 1) * per] = x
    return (jenc.build_padded_batch(g, b, m, list(v)),
            penc.build_padded_batch(g, b, m, list(v)))


def _kept(batch, lits, filters, n_seg, n_buckets):
    m = batch.mask.copy()
    for (fi, op), lit in zip(filters, lits):
        v = batch.values[fi]
        m &= {"=": v == lit, "!=": v != lit, "<": v < lit, "<=": v <= lit, ">": v > lit,
              ">=": v >= lit}[op]
    seg = batch.group_codes.astype(np.int64) * n_buckets + batch.bucket_ids
    return seg, m & (seg >= 0) & (seg < n_seg)


def _as_state(st):
    return (st.counts, st.sums.astype(np.float32), st.mins.astype(np.float32),
            st.maxs.astype(np.float32))


def _dist_case(rng, n, G, B, F, n_fields, filters, need_minmax, shards):
    rb, pb = _batches(rng, n, G, B, F, n_fields)
    lits = [float(rng.integers(-3, 4)) for _ in filters]
    r_spec = rS.ScanAggSpec(G, B, F, filters, need_minmax).padded()
    p_spec = pS.ScanAggSpec(G, B, F, filters, need_minmax).padded()
    want = _as_state(r_dist(_jmesh(shards), rb, r_spec, lits))
    single = _as_state(pS.scan_aggregate(pb, p_spec, lits, device=torch.device("cpu")))
    before = pS.COMBINE_PLAIN_CALLS["state"]
    direct = pS.PLAIN_CALLS["direct"]
    got = _as_state(dist_agg.dist_scan_aggregate(pm.Mesh.logical("cpu", shards), pb, p_spec,
                                                 lits))
    assert pS.PLAIN_CALLS["direct"] == direct + shards
    assert pS.COMBINE_PLAIN_CALLS["state"] == before + 1
    n_seg = p_spec.n_groups * p_spec.n_buckets
    seg, kept = _kept(pb, lits, filters, n_seg, p_spec.n_buckets)
    abs_sums = segment_abs_sums(seg, kept, pb.values[:F], n_seg).reshape(
        F, p_spec.n_groups, p_spec.n_buckets)
    assert_state_equal(got, single, abs_sums, need_minmax, "sharded vs single-device")
    assert_state_equal(got, want, abs_sums, need_minmax, "port vs reference, sharded")


@pytest.mark.parametrize("need_minmax", [True, False])
@pytest.mark.parametrize("F", [0, 2])
@pytest.mark.parametrize("op", OPS)
def test_dist_scan_aggregate_matches_reference(op, F, need_minmax):
    rng = np.random.default_rng(OPS.index(op) * 7 + F * 3 + need_minmax)
    _dist_case(rng, 4000, 5, 6, F, F + 1, ((F, op),), need_minmax, 8)


def test_dist_scan_aggregate_global_and_unfiltered():
    rng = np.random.default_rng(11)
    _dist_case(rng, 3000, 1, 1, 2, 2, (), True, 8)
    _dist_case(rng, 3000, 7, 3, 1, 1, (), True, 8)


def test_non_power_of_two_mesh_pads():
    """8192 rows over 3 shards: the pad rows are masked, so neither counts
    nor min/max see them (reference ``tests/test_parallel.py:149``)."""
    _dist_case(np.random.default_rng(3), 8192, 5, 3, 1, 1, (), True, 3)


# The probe of the reference's combine on its CPU mesh: pmin/pmax do not
# keep the single-device order. (values by shard, reference's min, max;
# the port's min, max — its single-device answer)
_Z, _NZ, _NAN = 0.0, -0.0, float("nan")
PROBES = {
    "pmin-zeros": ([_Z, _NZ, _Z, _Z], (_Z, _Z), (_NZ, _Z)),
    "pmax-zeros": ([_NZ, _Z, _NZ, _NZ], (_NZ, _NZ), (_NZ, _Z)),
    "nan-dropped": ([1.0, _NAN, 2.0, 0.5], (0.5, 2.0), (_NAN, _NAN)),
}


@pytest.mark.parametrize("probe", list(PROBES))
def test_special_floats_across_shards_pin_both_answers(probe):
    """A segment whose rows lie in four shards holding the probe's values.
    The reference's sharded min/max drop NaN and order +-0 by shard; the
    port's equal its single-device answer (NaN wins, -0.0 < +0.0)."""
    values, ref_mm, port_mm = PROBES[probe]
    rb, pb = _batches(np.random.default_rng(0), 4096, 2, 1, 1, 1, special=values)
    r_spec = rS.ScanAggSpec(2, 1, 1, segment_impl="scatter").padded()
    p_spec = pS.ScanAggSpec(2, 1, 1, segment_impl="scatter").padded()
    want = _as_state(r_dist(_jmesh(4), rb, r_spec))
    got = _as_state(dist_agg.dist_scan_aggregate(pm.Mesh.logical("cpu", 4), pb, p_spec))
    single = _as_state(pS.scan_aggregate(pb, p_spec, device=torch.device("cpu")))
    assert got[0][0, 0] == want[0][0, 0] == 4096
    assert_bit_equal(got[2][0, 0, 0], np.float32(port_mm[0]), "port min")
    assert_bit_equal(got[3][0, 0, 0], np.float32(port_mm[1]), "port max")
    assert_bit_equal(got[2], single[2], "port min vs single-device")
    assert_bit_equal(got[3], single[3], "port max vs single-device")
    assert_bit_equal(want[2][0, 0, 0], np.float32(ref_mm[0]), "reference min")
    assert_bit_equal(want[3][0, 0, 0], np.float32(ref_mm[1]), "reference max")
    assert np.isnan(got[1][0, 0, 0]) == np.isnan(want[1][0, 0, 0]) == (probe == "nan-dropped")


# ---- the sharded cached step -----------------------------------------------------


def _resident(rng, n_series, per, n_fields, shards):
    """Rows sorted by (series, ts), one pad row (code S, ts -1), padded to a
    multiple of ``shards`` as the scan cache pads them."""
    codes = np.repeat(np.arange(n_series, dtype=np.int32), per)
    ts = np.tile(np.arange(per, dtype=np.int32) * 10, n_series)
    n = len(codes) + 1
    n_pad = -(-n // shards) * shards
    codes = np.concatenate([codes, np.full(n_pad - len(codes), n_series, np.int32)])
    ts = np.concatenate([ts, np.full(n_pad - len(ts), -1, np.int32)])
    vals = np.round(rng.normal(0, 8, (n_fields, n_pad))).astype(np.float32)
    return codes, ts, vals


def _shards(arr, shards):
    per = arr.shape[-1] // shards
    return [torch.from_numpy(np.ascontiguousarray(arr[..., d * per:(d + 1) * per]))
            for d in range(shards)]


@pytest.mark.parametrize("G,B,need_minmax", [(1, 1, True), (4, 5, True), (4, 5, False),
                                             (13, 30, True)])
def test_cached_step_matches_reference(G, B, need_minmax):
    rng = np.random.default_rng(G * 100 + B)
    S, shards = 13, 8
    codes, ts, vals = _resident(rng, S, 300, 3, shards)
    gos = np.append(rng.integers(0, G, S), 0).astype(np.int32)
    allow = np.append(rng.random(S) < 0.8, False)
    allow[0] = True
    filters = ((2, ">="),)
    lits = [-2.0]
    lo, hi, width = 200, 2600, 100
    t0 = lo
    r_spec = rS.ScanAggSpec(G, B, 2, filters, need_minmax).padded()
    p_spec = pS.ScanAggSpec(G, B, 2, filters, need_minmax).padded()
    want = r_make_cached(_jmesh(shards), r_spec)(
        jnp.asarray(codes), jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(gos),
        jnp.asarray(allow), jnp.asarray(np.float32(lits)), np.int32(lo), np.int32(hi),
        np.int32(t0), np.int32(width))
    want = tuple(np.asarray(x) for x in want)
    session = torch.from_numpy(pS.pack_session(gos, allow))
    dyn = torch.from_numpy(pS.pack_dyn(lits, lo, hi, t0, width))
    cached = pS.PLAIN_CALLS["cached"]
    packed = dist_agg.dist_cached_step(
        pm.Mesh.logical("cpu", shards), p_spec, [(t,) for t in _shards(codes, shards)],
        [(t,) for t in _shards(ts, shards)],
        [tuple((v,) for v in sh) for sh in _shards(vals, shards)], session, dyn)
    assert pS.PLAIN_CALLS["cached"] == cached + shards
    got = _as_state(pS.unpack_packed_state(packed, p_spec))
    kw = dict(n_groups=p_spec.n_groups, n_buckets=p_spec.n_buckets, n_agg_fields=2,
              numeric_filters=pS.encode_filter_ops(filters), need_minmax=need_minmax,
              segment_impl=dist_agg._resolved(p_spec).segment_impl)
    single = _as_state(pS.unpack_packed_state(pS.cached_scan_agg_packed(
        (torch.from_numpy(codes),), (torch.from_numpy(ts),),
        tuple((torch.from_numpy(v),) for v in vals), session, dyn, **kw), p_spec))
    # the rows the reference keeps, for the sums' scale
    keep = allow[codes] & (ts >= lo) & (ts < hi) & (vals[2] >= lits[0])
    bucket = np.clip((ts.astype(np.int64) - t0) // width, 0, p_spec.n_buckets - 1)
    seg = gos[codes].astype(np.int64) * p_spec.n_buckets + bucket
    n_seg = p_spec.n_groups * p_spec.n_buckets
    abs_sums = segment_abs_sums(seg, keep, vals[:2], n_seg).reshape(
        2, p_spec.n_groups, p_spec.n_buckets)
    assert_state_equal(got, single, abs_sums, need_minmax, "sharded vs single-device")
    assert_state_equal(got, want, abs_sums, need_minmax, "port vs reference, sharded")


# ---- sharded raw reads -----------------------------------------------------------

KEYS = [(True, True), (True, False), (False, True), (False, False)]  # (ts key, desc)


def _raw_table(rng, n=2048, n_series=6):
    """Raw resident columns: sorted codes, a pad tail, ts with ties, values
    with ties, +-0 and NaN."""
    codes = np.sort(rng.integers(0, n_series, n)).astype(np.int32)
    codes[n - 9:] = n_series
    rank = np.arange(n) - np.searchsorted(codes, codes, "left")
    ts = (rank * 10 + rng.integers(0, 9, n)).astype(np.int32)
    v = np.round(rng.normal(0, 60, (2, n))).clip(-250, 250).astype(np.float32)
    pick = rng.random((2, n))
    v[pick < 0.04] = -0.0
    v[(pick >= 0.04) & (pick < 0.08)] = 0.0
    v[(pick >= 0.08) & (pick < 0.1)] = np.nan
    return codes, ts, v, n_series


def _raw_args(codes, ts, v, shards):
    return ([(t,) for t in _shards(codes, shards)], [(t,) for t in _shards(ts, shards)],
            [tuple((x,) for x in sh) for sh in _shards(v, shards)])


@pytest.mark.parametrize("k", [1, 16, 300, 2048])
@pytest.mark.parametrize("key_is_ts,desc", KEYS, ids=["ts-desc", "ts-asc", "f32-desc",
                                                      "f32-asc"])
def test_sharded_topk_matches_single_device(key_is_ts, desc, k, mesh8):
    """k = 300 and 2048 exceed a shard's 256 rows: every shard is clamped to
    its length and the merge is cut at k, losing no row (reference
    ``tests/test_raw_device.py:257``). Slots bit-equal to the port's and the
    reference's single-device top-k, order included."""
    rng = np.random.default_rng(k + 10 * key_is_ts + desc)
    codes, ts, v, S = _raw_table(rng)
    allow = np.append(rng.random(S) < 0.8, False).astype(np.int32)
    allow[0] = 1
    lo, hi = 30, int(ts.max()) - 40
    key_lo, key_hi = rT.topk_key_bounds(desc, key_is_ts, lo, hi)
    dyn = rT.pack_raw_dyn([0.0], lo, hi, key_lo, key_hi)
    kw = dict(k=k, descending=desc, key_is_ts=key_is_ts, key_field=0,
              numeric_filters=((1, 5),))
    want = np.asarray(rT.raw_topk_packed(jnp.asarray(codes), jnp.asarray(ts), jnp.asarray(v),
                                         jnp.asarray(allow), jnp.asarray(dyn), **kw))
    single = pT.raw_topk_packed((torch.from_numpy(codes),), (torch.from_numpy(ts),),
                                tuple((torch.from_numpy(x),) for x in v),
                                torch.from_numpy(allow), torch.from_numpy(dyn), **kw).numpy()
    assert np.array_equal(want, single)
    spec = pT.RawScanSpec(k=min(k, len(codes) // 8), descending=desc, key_is_ts=key_is_ts,
                          key_field=0, numeric_filters=((1, ">="),))
    topk = pT.PLAIN_CALLS["raw_topk"]
    got = dist_raw.dist_raw_topk(mesh8, spec, *_raw_args(codes, ts, v, 8),
                                 torch.from_numpy(allow), torch.from_numpy(dyn), need=k,
                                 key_lo=key_lo)
    assert pT.PLAIN_CALLS["raw_topk"] == topk + 8
    assert np.array_equal(got, single[single >= 0]), (got, single)


@pytest.mark.parametrize("k", [1, 16, 300, 2048])
@pytest.mark.parametrize("key_is_ts,desc", KEYS, ids=["ts-desc", "ts-asc", "f32-desc",
                                                      "f32-asc"])
def test_topk_keys_match_the_reference_body(key_is_ts, desc, k):
    """``with_keys``: the slots and the keys the top-k ranked them by, as the
    reference's ``raw_topk_body`` returns them (INT32_MIN in empty slots);
    the slots are those of the plain call without keys."""
    rng = np.random.default_rng(k + 20 * key_is_ts + desc)
    codes, ts, v, S = _raw_table(rng)
    allow = np.append(rng.random(S) < 0.8, False).astype(np.int32)
    allow[0] = 1
    lo, hi = 30, int(ts.max()) - 40
    key_lo, key_hi = rT.topk_key_bounds(desc, key_is_ts, lo, hi)
    kw = dict(k=k, descending=desc, key_is_ts=key_is_ts, key_field=0,
              numeric_filters=((1, 5),))
    want_keys, want_idx = rT.raw_topk_body(
        jnp.asarray(codes), jnp.asarray(ts), jnp.asarray(v), jnp.asarray(allow != 0),
        jnp.asarray(np.float32([0.0])), np.int32(lo), np.int32(hi), np.int32(key_lo),
        np.int32(key_hi), **kw)
    args = ((torch.from_numpy(codes),), (torch.from_numpy(ts),),
            tuple((torch.from_numpy(x),) for x in v), torch.from_numpy(allow),
            torch.from_numpy(rT.pack_raw_dyn([0.0], lo, hi, key_lo, key_hi)))
    got = pT.raw_topk_packed(*args, with_keys=True, **kw).numpy()
    assert got.shape == (2, k) and got.dtype == np.int32
    assert np.array_equal(got[0], pT.raw_topk_packed(*args, **kw).numpy())
    assert np.array_equal(got[0], np.asarray(want_idx))
    assert np.array_equal(got[1], np.asarray(want_keys))


@pytest.mark.parametrize("slots", [5, 37, 4096])
def test_sharded_selection_matches_reference(slots, mesh8):
    """Global ids in resident order and the true total, as the reference's
    ``dist_raw_select``; a shard past its buffer shows in the total."""
    rng = np.random.default_rng(slots)
    codes, ts, v, S = _raw_table(rng)
    allow = np.append(rng.random(S) < 0.7, False).astype(np.int32)
    lo, hi = 0, 900
    spec_r = rT.RawScanSpec(select_slots=slots, numeric_filters=((0, ">"),))
    want_ids, want_total = r_raw.dist_raw_select(
        _jmesh(8), spec_r, jnp.asarray(codes), jnp.asarray(ts), jnp.asarray(v),
        jnp.asarray(allow), [1.0], lo, hi)
    spec = pT.RawScanSpec(select_slots=slots, numeric_filters=((0, ">"),))
    dyn = torch.from_numpy(rT.pack_raw_dyn([1.0], lo, hi))
    ids, total = dist_raw.dist_raw_select(mesh8, spec, *_raw_args(codes, ts, v, 8),
                                          torch.from_numpy(allow), dyn)
    assert total == want_total > 0
    if total <= len(ids):
        assert np.array_equal(ids, np.asarray(want_ids))
    else:
        assert slots < 4096 and len(np.asarray(want_ids)) == 0  # the reference bails


@pytest.mark.parametrize("seed", range(4))
def test_sharded_selection_over_clipped_windows(seed, mesh8):
    """The executor's global windows (the allowed series' rows inside the
    time range), clipped to each of the 8 shards and shifted to its local
    rows, cover every row that shard's mask passes and lie inside it; the
    sharded selection over them gives the reference's ids and total, each
    launched shard's buffer holding exactly its windows' rows."""
    rng = np.random.default_rng(40 + seed)
    codes, ts, v, S = _raw_table(rng)
    allow = np.append(rng.random(S) < 0.5, False).astype(np.int32)
    allow[seed % S] = 1
    lo, hi = int(rng.integers(0, 300)), int(rng.integers(500, 1400))
    keep = (allow[codes] != 0) & (ts >= lo) & (ts < hi)
    f = np.concatenate([[False], keep, [False]])
    windows = np.flatnonzero(f[1:] != f[:-1]).reshape(-1, 2).astype(np.int64)
    lits, filters = [1.0], ((0, ">"),)
    per = len(codes) // 8
    passing = keep & (v[0] > 1.0)
    for d in range(8):
        local = dist_raw.shard_windows(windows, d * per, per)
        assert ((local >= 0) & (local <= per)).all()
        inside = np.zeros(per + 1, np.int64)
        np.add.at(inside, local[:, 0], 1)
        np.add.at(inside, local[:, 1], -1)
        assert (np.cumsum(inside)[:per] > 0)[passing[d * per:(d + 1) * per]].all()
    want_ids, want_total = r_raw.dist_raw_select(
        _jmesh(8), rT.RawScanSpec(select_slots=int(keep.sum()), numeric_filters=filters),
        jnp.asarray(codes), jnp.asarray(ts), jnp.asarray(v), jnp.asarray(allow), lits, lo, hi)
    spec = pT.RawScanSpec(select_slots=int(keep.sum()), numeric_filters=filters)
    dyn = torch.from_numpy(rT.pack_raw_dyn(lits, lo, hi))
    seen = []
    real = pT.raw_select_packed

    def spy(*a, **k):
        seen.append(k)
        return real(*a, **k)

    pT.raw_select_packed = spy
    try:
        ids, total = dist_raw.dist_raw_select(mesh8, spec, *_raw_args(codes, ts, v, 8),
                                              torch.from_numpy(allow), dyn, windows=windows)
    finally:
        pT.raw_select_packed = real
    assert total == want_total and np.array_equal(ids, np.asarray(want_ids))
    # a shard whose part holds no row is not launched
    assert [k["select_slots"] for k in seen] == [
        n for n in (int(keep[d * per:(d + 1) * per].sum()) for d in range(8)) if n]


WINDOW_SETS = ("one-shard", "straddle", "empty", "every-row")


def _window_query(codes, ts, S, case):
    """(allow list, lo, hi) of a query whose allowed rows in [lo, hi) -- the
    executor's windows -- lie inside one of the 8 shards, straddle a shard
    boundary, hold no row, or are every real row of ``_raw_table``."""
    n = len(codes)
    per = n // 8
    allow = np.zeros(S + 1, np.int32)
    if case == "every-row":
        allow[:S] = 1
        return allow, 0, int(ts.max()) + 1
    if case == "empty":
        allow[S // 2] = 1
        return allow, int(ts.max()) + 1, int(ts.max()) + 50
    for s in range(S):
        a, b = np.searchsorted(codes, [s, s + 1])
        for edge in range(per, n, per):
            if case == "straddle" and a + 20 <= edge <= b - 20:
                lo, hi = edge - 20, edge + 20
                break
            if case == "one-shard" and a + 40 <= edge <= b:
                lo, hi = edge - 35, edge - 5
                break
        else:
            continue
        allow[s] = 1
        return allow, int(ts[lo]), int(ts[hi - 1]) + 1
    raise AssertionError(f"no series for {case}")


def _windows_of(keep):
    f = np.concatenate([[False], keep, [False]])
    return np.flatnonzero(f[1:] != f[:-1]).reshape(-1, 2).astype(np.int64)


def _check_shard_windows(windows, passing, per, seen):
    """Every row a shard's mask passes lies in its clipped windows, and
    exactly the shards whose clipped windows hold rows were launched, each
    with its part. Returns the shards with rows."""
    parts = []
    for d in range(8):
        local = dist_raw.shard_windows(windows, d * per, per)
        inside = np.zeros(per + 1, np.int64)
        np.add.at(inside, local[:, 0], 1)
        np.add.at(inside, local[:, 1], -1)
        assert (np.cumsum(inside)[:per] > 0)[passing[d * per:(d + 1) * per]].all()
        if int((local[:, 1] - local[:, 0]).sum()):
            parts.append(local)
    assert len(seen) == len(parts)
    for k, local in zip(seen, parts):
        assert np.array_equal(np.asarray(k["windows"]).reshape(-1, 2), local)
    return len(parts)


def _spy(monkeypatch, name):
    seen = []
    real = getattr(pT, name)

    def spy(*a, **k):
        seen.append(k)
        return real(*a, **k)

    monkeypatch.setattr(pT, name, spy)
    return seen


@pytest.mark.parametrize("k", [16, 300])
@pytest.mark.parametrize("key_is_ts,desc", KEYS, ids=["ts-desc", "ts-asc", "f32-desc",
                                                      "f32-asc"])
@pytest.mark.parametrize("case", WINDOW_SETS)
def test_sharded_topk_over_clipped_windows(case, key_is_ts, desc, k, mesh8, monkeypatch):
    """The sharded top-k given the executor's windows: each shard visits its
    clipped part, a shard with none is not launched, and the answer is the
    reference's and the port's single-device top-k, order included."""
    rng = np.random.default_rng(60 + k + 10 * key_is_ts + desc)
    codes, ts, v, S = _raw_table(rng)
    allow, lo, hi = _window_query(codes, ts, S, case)
    keep = (allow[codes] != 0) & (ts >= lo) & (ts < hi)
    windows = _windows_of(keep)
    key_lo, key_hi = rT.topk_key_bounds(desc, key_is_ts, lo, hi)
    dyn = rT.pack_raw_dyn([0.0], lo, hi, key_lo, key_hi)
    kw = dict(k=k, descending=desc, key_is_ts=key_is_ts, key_field=0,
              numeric_filters=((1, 5),))
    want = np.asarray(rT.raw_topk_packed(jnp.asarray(codes), jnp.asarray(ts), jnp.asarray(v),
                                         jnp.asarray(allow), jnp.asarray(dyn), **kw))
    single = pT.raw_topk_packed((torch.from_numpy(codes),), (torch.from_numpy(ts),),
                                tuple((torch.from_numpy(x),) for x in v),
                                torch.from_numpy(allow), torch.from_numpy(dyn), windows=windows,
                                **kw).numpy()
    assert np.array_equal(want, single)
    per = len(codes) // 8
    spec = pT.RawScanSpec(k=min(k, per), descending=desc, key_is_ts=key_is_ts, key_field=0,
                          numeric_filters=((1, ">="),))
    calls = pT.PLAIN_CALLS["raw_topk"]
    seen = _spy(monkeypatch, "raw_topk_packed")
    got = dist_raw.dist_raw_topk(mesh8, spec, *_raw_args(codes, ts, v, 8),
                                 torch.from_numpy(allow), torch.from_numpy(dyn), need=k,
                                 key_lo=key_lo, windows=windows)
    assert np.array_equal(got, single[single >= 0]), (got, single)
    launched = _check_shard_windows(windows, keep & (v[1] >= 0.0), per, seen)
    assert pT.PLAIN_CALLS["raw_topk"] == calls + launched
    assert launched == {"one-shard": 1, "straddle": 2, "empty": 0, "every-row": 8}[case]


@pytest.mark.parametrize("case", WINDOW_SETS)
def test_sharded_selection_launches_only_shards_with_window_rows(case, mesh8, monkeypatch):
    """The sharded selection given the executor's windows launches exactly
    the shards whose clipped windows hold rows, and answers as the
    reference's ``dist_raw_select``."""
    rng = np.random.default_rng(70 + WINDOW_SETS.index(case))
    codes, ts, v, S = _raw_table(rng)
    allow, lo, hi = _window_query(codes, ts, S, case)
    keep = (allow[codes] != 0) & (ts >= lo) & (ts < hi)
    windows = _windows_of(keep)
    lits, filters = [-20.0], ((0, ">"),)
    slots = max(int(keep.sum()), 1)
    want_ids, want_total = r_raw.dist_raw_select(
        _jmesh(8), rT.RawScanSpec(select_slots=slots, numeric_filters=filters),
        jnp.asarray(codes), jnp.asarray(ts), jnp.asarray(v), jnp.asarray(allow), lits, lo, hi)
    spec = pT.RawScanSpec(select_slots=slots, numeric_filters=filters)
    dyn = torch.from_numpy(rT.pack_raw_dyn(lits, lo, hi))
    calls = pT.PLAIN_CALLS["raw_select"]
    seen = _spy(monkeypatch, "raw_select_packed")
    ids, total = dist_raw.dist_raw_select(mesh8, spec, *_raw_args(codes, ts, v, 8),
                                          torch.from_numpy(allow), dyn, windows=windows)
    assert total == want_total and np.array_equal(ids, np.asarray(want_ids))
    assert ids.dtype == np.int64
    launched = _check_shard_windows(windows, keep & (v[0] > -20.0), len(codes) // 8, seen)
    assert pT.PLAIN_CALLS["raw_select"] == calls + launched
    assert [k["select_slots"] for k in seen] == [
        int((w[:, 1] - w[:, 0]).sum()) for w in (np.asarray(k["windows"]) for k in seen)]


def test_merge_topk_cuts_at_need_in_slot_order():
    keys = np.array([5, 9, 5, 7, 9, 1], np.int64)
    ids = np.array([40, 3, 2, 8, 30, 0], np.int64)
    # strict (> 5) in row order, then the lowest-id tie of 5
    assert dist_raw.merge_topk(keys, ids, 4, key_lo=-10).tolist() == [3, 8, 30, 2]
    # fewer candidates than need: the threshold is key_lo + 1
    assert dist_raw.merge_topk(keys[:2], ids[:2], 4, key_lo=4).tolist() == [3, 40]


# ---- the sharded merge -----------------------------------------------------------


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("shards", [3, 8])
def test_dist_merge_dedup_matches_reference(dedup, shards):
    rng = np.random.default_rng(shards + dedup)
    n = 6000
    tsid = rng.integers(0, 2**63, 90, dtype=np.uint64)[rng.integers(0, 90, n)]
    ts = rng.integers(0, 400, n).astype(np.int64)
    seq = rng.integers(1, 9, n).astype(np.uint64)
    want = r_merge.dist_merge_dedup(_jmesh(shards), tsid, ts, seq, dedup=dedup)
    perm, keep = pM.merge_dedup_permutation(tsid, ts, seq, dedup=dedup, device="cpu")
    f32 = pM.PLAIN_CALLS["f32"]
    got = dist_merge.dist_merge_dedup(pm.Mesh.logical("cpu", shards), tsid, ts, seq,
                                      dedup=dedup)
    assert pM.PLAIN_CALLS["f32"] == f32 + shards
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, perm[keep])
    assert (len(got) == n) != dedup


@pytest.mark.parametrize("dedup", [True, False])
def test_dist_merge_dedup_with_empty_shards_matches_reference(dedup):
    """Three distinct tsids over eight shards: the empty shards are neither
    staged nor sorted, and the answer is the reference's and the one-device
    merge's."""
    rng = np.random.default_rng(31 + dedup)
    n = 3000
    tsid = rng.integers(0, 2**63, 3, dtype=np.uint64)[rng.integers(0, 3, n)]
    ts = rng.integers(0, 200, n).astype(np.int64)
    seq = rng.integers(1, 5, n).astype(np.uint64)
    mesh = pm.Mesh.logical("cpu", 8)
    idxs, _, _ = dist_merge.shard_words(mesh, tsid, ts, seq)
    full = sum(1 for i in idxs if len(i))
    assert full <= 3
    want = r_merge.dist_merge_dedup(_jmesh(8), tsid, ts, seq, dedup=dedup)
    perm, keep = pM.merge_dedup_permutation(tsid, ts, seq, dedup=dedup, device="cpu")
    f32 = pM.PLAIN_CALLS["f32"]
    got = dist_merge.dist_merge_dedup(mesh, tsid, ts, seq, dedup=dedup)
    assert pM.PLAIN_CALLS["f32"] == f32 + full
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, perm[keep])


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_shard_words_stage_exactly_each_shards_rows(shards):
    """Each shard's staged words are its own rows and no pad: its tsid split
    into (hi, lo) and its packed rest word, in reversed input order; the
    shards' rows partition the input, each in input order, every key of a
    tsid on one shard."""
    rng = np.random.default_rng(shards)
    n = 5000
    tsid = rng.integers(0, 2**63, 40, dtype=np.uint64)[rng.integers(0, 40, n)]
    ts = rng.integers(0, 900, n).astype(np.int64)
    seq = rng.integers(1, 9, n).astype(np.uint64)
    idxs, host, masks = dist_merge.shard_words(pm.Mesh.logical("cpu", shards), tsid, ts, seq)
    assert len(idxs) == len(host) == shards
    assert np.array_equal(np.sort(np.concatenate(idxs)), np.arange(n))
    kind, (rest, mask) = pM._pack_rest(ts, seq)
    assert kind == "f32" and masks == (0xFFFFFFFF, 0xFFFFFFFF, int(mask))
    seen = set()
    for idx, h in zip(idxs, host):
        assert np.all(np.diff(idx) > 0)
        assert h.dtype == torch.int32 and tuple(h.shape) == (3, len(idx)) and h.is_contiguous()
        hi, lo = penc.split_u64(tsid[idx[::-1]])
        words = h.numpy().view(np.uint32)
        assert np.array_equal(words[0], hi) and np.array_equal(words[1], lo)
        assert np.array_equal(words[2], rest[idx[::-1]])
        mine = set(tsid[idx].tolist())
        assert not mine & seen
        seen |= mine


def test_dist_merge_dedup_wide_spans_raise():
    tsid = np.arange(10, dtype=np.uint64)
    ts = np.array([0, 2**40] * 5, np.int64)
    with pytest.raises(ValueError, match="pre-chunk"):
        dist_merge.dist_merge_dedup(pm.Mesh.logical("cpu", 2), tsid, ts, np.ones(10, np.uint64))


# ---- the slice as SQL ------------------------------------------------------------

HOSTS = 40
HOURS = 2


def _cpu_sql() -> str:
    return (
        "CREATE TABLE cpu (hostname string TAG, region string TAG, datacenter string TAG, "
        + ", ".join(f"{f} double" for f in tsbs.CPU_FIELDS)
        + ", ts timestamp NOT NULL, TIMESTAMP KEY(ts)) ENGINE=Analytic "
        "WITH (segment_duration='2h')"
    )


def _load(pkg, db):
    ct = pkg.common_types
    db.execute(_cpu_sql())
    src = tsbs.generate_cpu(HOSTS, HOURS * 3_600_000)
    t = db.catalog.open("cpu")
    t.write(ct.RowGroup(t.schema, dict(src.columns)))
    t.flush()
    db.execute("CREATE TABLE demo (name string TAG, value double, t timestamp KEY) "
               "ENGINE=Analytic WITH (segment_duration='2h')")
    rng = np.random.default_rng(123)
    cols = {"t": rng.choice(3_600_000, 5000, replace=False).astype(np.int64),
            "name": np.array([f"host_{i}" for i in rng.integers(0, 100, 5000)], dtype=object),
            "value": rng.normal(10.0, 3.0, 5000)}
    cols["tsid"] = ct.schema.compute_tsid([cols["name"]])
    d = db.catalog.open("demo")
    d.write(ct.RowGroup(d.schema, cols))
    d.flush()


def _sparse_sql(hosts, hours):
    fields = ", ".join(f"max({f}) AS max_{f}" for f in tsbs.CPU_FIELDS[:3])
    names = ", ".join(f"'host_{h}'" for h in hosts)
    return (f"SELECT hostname, time_bucket(ts, '1m') AS minute, {fields} FROM cpu "
            f"WHERE hostname IN ({names}) AND ts >= 0 AND ts < {hours * 3_600_000} "
            "GROUP BY hostname, time_bucket(ts, '1m') ORDER BY hostname, minute")


AGG_QUERIES = {
    "single-groupby-5-8-1": tsbs.single_groupby(5, 8, 1).sql,
    "double-groupby-all": tsbs.double_groupby_all(HOURS).sql,
    "high-cpu-all": tsbs.high_cpu_all(HOURS).sql,
    "readme": "SELECT name, avg(value) AS a FROM demo GROUP BY name ORDER BY name",
    "sparse-2x1h": _sparse_sql([3, 17], 1),
}
RAW_QUERIES = {
    "lastpoint-host": ("SELECT * FROM cpu WHERE hostname = 'host_7' ORDER BY ts DESC "
                       "LIMIT 10", "topk"),
    "high-cpu-16": ("SELECT * FROM cpu WHERE hostname IN ("
                    + ", ".join(f"'host_{i}'" for i in range(16))
                    + ") AND usage_user > 50 AND ts >= 0 AND ts < 3600000", "select"),
    "hottest-3-hosts": ("SELECT hostname, ts, usage_user FROM cpu WHERE hostname IN "
                        "('host_3', 'host_21', 'host_38') AND ts >= 1800000 "
                        "ORDER BY usage_user DESC LIMIT 12", "topk"),
}


@pytest.fixture(scope="module")
def sql_dbs():
    mp = pytest.MonkeyPatch()
    mp.setenv("HORAEDB_ADAPTIVE_PATH", "0")
    ref = horaedb_tpu.connect(None)
    single = horaedb_tpu.connect(None)
    port = horaedb_tpu_torch.connect(None, device="cpu")
    for pkg, db in ((horaedb_tpu, ref), (horaedb_tpu, single), (horaedb_tpu_torch, port)):
        _load(pkg, db)
    yield ref, single, port
    for db in (ref, single, port):
        db.close()
    mp.undo()


@pytest.fixture()
def sharded(monkeypatch, mesh8):
    """Small tables sharded: the port's over the logical mesh, the
    reference's over its CPU mesh."""
    monkeypatch.setenv("HORAEDB_DIST_MIN_ROWS", "1")


def _single_device(db, sql, monkeypatch, runs=3):
    """The reference on one device: its entry built, and its direct path
    run, above the sharding floor."""
    with monkeypatch.context() as mp:
        mp.setenv("HORAEDB_DIST_MIN_ROWS", str(1 << 30))
        for _ in range(runs):
            out = db.execute(sql)
    assert "mesh_devices" not in out.metrics
    return out


def _scale(rows):
    """The sums' scale: a float column other than a min/max/count is an
    avg; its scale is the largest |value| of the answer (per-group mean
    |x| is at most that), as a bound on SUM_RTOL's reach."""
    big = max((abs(v) for r in rows for v in r.values() if isinstance(v, float)), default=1.0)

    def scale(row, col):
        if col == "a" or col.startswith("avg_"):
            return big
        return None

    return scale


@pytest.mark.parametrize("query", list(AGG_QUERIES))
def test_sql_aggregates_on_the_mesh_match_the_reference(sql_dbs, query, sharded, monkeypatch):
    """Each run against the reference on its mesh; the sparse GROUP BY
    (its router seeds the hash arm) against the reference on one device:
    the reference's hash arm does not run under ``shard_map`` here."""
    ref, single, port = sql_dbs
    sql = AGG_QUERIES[query]
    paths = []
    for _ in range(3):
        got_rs = port.execute(sql)
        got = got_rs.to_pylist()
        assert got and got_rs.metrics.get("mesh_devices") == 8, got_rs.metrics
        paths.append(port.interpreters.executor.last_path)
        if query.startswith("sparse"):
            want = _single_device(single, sql, monkeypatch, runs=1).to_pylist()
        else:
            want = ref.execute(sql).to_pylist()
        rows_match(want, got, _scale(want))
    assert paths[-1] == "device-cached"
    table = "demo" if query == "readme" else "cpu"
    entry = port.interpreters.executor.scan_cache._entries[table]
    assert entry.mesh is MESH8
    assert entry.series_layout == entry.ts_layout == ("raw",)


def test_first_query_takes_the_sharded_direct_path(monkeypatch):
    monkeypatch.setenv("HORAEDB_DIST_MIN_ROWS", "1")
    port = horaedb_tpu_torch.connect(None, device="cpu")
    with pm.use_mesh(pm.Mesh.logical("cpu", 8)):
        _load(horaedb_tpu_torch, port)
        direct = pS.PLAIN_CALLS["direct"]
        out = port.execute(AGG_QUERIES["high-cpu-all"])
        assert port.interpreters.executor.last_path == "device-dist"
        assert out.metrics["mesh_devices"] == 8
        assert pS.PLAIN_CALLS["direct"] == direct + 8
    port.close()


def _shard_passing(a, k) -> np.ndarray:
    """The rows a shard's raw call's mask passes (its plain version's)."""
    sp, tp, vals, session, dyn = a
    lits, lo, hi, _, _ = pT._unpack_dyn(dyn, k["numeric_filters"])
    sc, tr, dv = penc.decode_layouts(sp, tp, vals, k["series_layout"], k["ts_layout"],
                                     k["value_layouts"])
    return pT._raw_mask(sc, tr, dv, session != 0, lits, lo, hi,
                        k["numeric_filters"]).numpy()


@pytest.mark.parametrize("query", list(RAW_QUERIES))
def test_sql_raw_reads_on_the_mesh_match_the_reference(sql_dbs, query, sharded, monkeypatch):
    """The selection against the reference on its mesh; the top-k against
    the reference on one device (its sharded top-k does not run here).
    The last run's windows: the executor hands the mesh its global row
    windows; exactly the shards whose clipped part holds rows are
    launched, each with that part, and every row a shard's mask passes
    lies in it."""
    ref, single, port = sql_dbs
    sql, kind = RAW_QUERIES[query]
    for _ in range(2):
        port.execute(sql)
    name = f"raw_{kind}_packed"
    shard_calls, global_windows = [], []
    real_shard, real_dist = getattr(pT, name), getattr(dist_raw, f"dist_raw_{kind}")

    def shard(*a, **k):
        shard_calls.append((a, k))
        return real_shard(*a, **k)

    def dist(*a, **k):
        global_windows.append(k["windows"])
        return real_dist(*a, **k)

    with monkeypatch.context() as mp:
        mp.setattr(pT, name, shard)
        mp.setattr(dist_raw, f"dist_raw_{kind}", dist)
        got_rs = port.execute(sql)
    per = port.interpreters.executor.scan_cache._entries["cpu"].padded_rows // 8
    (windows,) = global_windows
    parts = [dist_raw.shard_windows(windows, d * per, per) for d in range(8)]
    launched = [w for w in parts if int((w[:, 1] - w[:, 0]).sum())]
    assert 1 <= len(shard_calls) == len(launched) < 8
    for w, (a, k) in zip(launched, shard_calls):
        assert np.array_equal(np.asarray(k["windows"]).reshape(-1, 2), w)
        inside = np.zeros(per + 1, np.int64)
        np.add.at(inside, w[:, 0], 1)
        np.add.at(inside, w[:, 1], -1)
        assert (np.cumsum(inside)[:per] > 0)[_shard_passing(a, k)].all()
    m = got_rs.metrics
    assert m.get("path") == "raw_device" and m.get("raw_kernel") == kind, m
    assert m.get("mesh_devices") == 8
    if kind == "select":
        for _ in range(3):
            want = ref.execute(sql)
        assert want.metrics.get("mesh_devices") == 8
    else:
        want = _single_device(single, sql, monkeypatch)
    assert want.metrics.get("path") == "raw_device"
    assert got_rs.to_pylist() == want.to_pylist()


def test_small_table_stays_single_device(mesh8):
    """At the default HORAEDB_DIST_MIN_ROWS a small table is cached and
    served on one device, mesh or not."""
    port = horaedb_tpu_torch.connect(None, device="cpu")
    _load(horaedb_tpu_torch, port)
    for _ in range(3):
        out = port.execute(AGG_QUERIES["readme"])
    assert "mesh_devices" not in out.metrics
    assert port.interpreters.executor.scan_cache._entries["demo"].mesh is None
    port.close()


def test_mesh_entry_is_neither_fused_nor_gathered(sql_dbs, sharded):
    """A cohort of shape-identical queries on a sharded entry is served
    member by member with full scans: no cohort launch, no selective
    gather, each member one launch a shard and one combine."""
    _, _, port = sql_dbs
    sqls = [tsbs.single_groupby(5, 8, 1, t0=h * 3_600_000).sql for h in range(2)]
    for s in sqls:
        port.execute(s)
        port.execute(s)
    ex = port.interpreters.executor
    plans = [port._cached_plan(s) for s in sqls]
    table = port.catalog.open("cpu")
    m = {"table": "cpu"}
    prep = ex.prepare_cached_agg(plans[0], table, m, allow_selective=True)
    assert prep.entry.mesh is not None and prep.row_idx is None
    assert prep.fuse_key(0) == ("solo", 0)
    before = dict(pS.PLAIN_CALLS)
    combines = pS.COMBINE_PLAIN_CALLS["packed"]
    outs = ex.execute_cohort(plans, table)
    assert not any(isinstance(o, BaseException) for o in outs), outs
    calls = {k: pS.PLAIN_CALLS[k] - before[k] for k in before}
    assert calls["cached_cohort"] == 0 and calls["cached_selective"] == 0
    assert calls["cached"] == 16 and pS.COMBINE_PLAIN_CALLS["packed"] == combines + 2
    for o, s in zip(outs, sqls):
        assert o.metrics["mesh_devices"] == 8
        assert o.to_pylist() == port.execute(s).to_pylist()


def test_mesh_change_rebuilds_the_entry(monkeypatch):
    monkeypatch.setenv("HORAEDB_DIST_MIN_ROWS", "1")
    port = horaedb_tpu_torch.connect(None, device="cpu")
    sql = AGG_QUERIES["readme"]
    cache = port.interpreters.executor.scan_cache
    answers = []
    with pm.use_mesh(pm.Mesh.logical("cpu", 8)) as m8:
        _load(horaedb_tpu_torch, port)
        for _ in range(3):
            out = port.execute(sql)
        assert cache._entries["demo"].mesh is m8
        answers.append(out.to_pylist())
    with pm.use_mesh(pm.Mesh.logical("cpu", 4)) as m4:
        out = port.execute(sql)  # the old entry is dropped; this read rebuilds
        out = port.execute(sql)
        assert cache._entries["demo"].mesh is m4 and out.metrics["mesh_devices"] == 4
        answers.append(out.to_pylist())
    out = port.execute(sql)
    out = port.execute(sql)
    assert cache._entries["demo"].mesh is None and "mesh_devices" not in out.metrics
    answers.append(out.to_pylist())
    for a in answers[1:]:
        rows_match(answers[0], a, _scale(answers[0]))
    port.close()


def test_partial_pushdown_shards(monkeypatch, mesh8):
    """An aggregate over the memory cap takes the partial machinery, whose
    kernel step shards over the mesh like the direct path."""
    monkeypatch.setenv("HORAEDB_DIST_MIN_ROWS", "1")
    monkeypatch.setenv("HORAEDB_SCAN_CACHE", "0")
    port = horaedb_tpu_torch.connect(None, device="cpu")
    _load(horaedb_tpu_torch, port)
    sql = AGG_QUERIES["double-groupby-all"]
    want = port.execute(sql).to_pylist()
    monkeypatch.setenv("HORAEDB_AGG_MEMORY_MB", "0.01")
    direct = pS.PLAIN_CALLS["direct"]
    got = port.execute(sql).to_pylist()
    assert pS.PLAIN_CALLS["direct"] >= direct + 8
    rows_match(want, got, _scale(want))
    port.close()



def test_shard_real_rows():
    """Each shard's prefix of the table's first n_valid real rows."""
    from horaedb_tpu_torch.parallel.dist_agg import shard_real_rows

    assert [shard_real_rows(10, 4, d) for d in range(4)] == [4, 4, 2, 0]
    assert [shard_real_rows(8, 4, d) for d in range(3)] == [4, 4, 0]
    assert [shard_real_rows(0, 4, d) for d in range(2)] == [0, 0]


def test_sharded_full_scan_reads_each_shard_real_rows(sql_dbs, sharded, monkeypatch):
    """``dist_cached_step`` gives each shard's launch its part of the
    entry's real rows, and the answer stays the reference's."""
    from horaedb_tpu_torch.ops import scan_agg
    from horaedb_tpu_torch.parallel.dist_agg import shard_real_rows

    ref, _, port = sql_dbs
    sql = AGG_QUERIES["double-groupby-all"]
    for _ in range(2):
        port.execute(sql)
    seen = []
    orig = scan_agg.cached_scan_agg_packed

    def spy(*a, **k):
        seen.append(k.get("n_rows"))
        return orig(*a, **k)

    monkeypatch.setattr(scan_agg, "cached_scan_agg_packed", spy)
    got = port.execute(sql)
    entry = port.interpreters.executor.scan_cache._entries["cpu"]
    per = entry.series_parts[0].shape[0]
    assert seen == [shard_real_rows(entry.n_valid, per, d) for d in range(8)]
    assert sum(seen) == entry.n_valid < 8 * per
    rows_match(ref.execute(sql).to_pylist(), got.to_pylist(), _scale(got.to_pylist()))
