"""The port's cohort kernels and cohort executor against the JAX package's.

The same numpy inputs, made from a seed, go through the reference's jitted
programs and through the port's wrappers on CPU tensors (their plain
PyTorch versions):

- ``cached_scan_agg_cohort`` (B1e) against the reference's and, member by
  member, against the port's solo ``cached_scan_agg_packed``: every
  resident layout, each arm, both ``need_minmax`` values, F = 0, B in
  {1, 2, 5}, members with an empty allow list or time range, NaN and
  +-0. Counts, mins and maxs bit-equal; sums within ``SUM_RTOL`` of the
  segment's sum of |x| (tests/torch_parity.py); against the port's solo
  version the whole packed row is bit-equal (the same arithmetic).
- ``raw_topk_cohort`` (B4c) against the reference's and against the
  port's ``raw_topk_packed`` per member: slots bit-equal, order included;
  with per-member row windows from the executor's candidate estimate
  (overlapping, disjoint, empty), which must cover every row a member's
  mask passes; malformed windows refused; the kernel's tile table
  (``cohort_tiles``, its member masks and item lists) against a direct
  count.
- ``selective_cached_scan_agg`` (B1d) against the reference's.
- ``Executor.execute_cohort`` against the reference's on the same table
  and plans, row for row: a fused cohort, a lone member that regains the
  selective gather, a member whose prepare bailed, and a fused dispatch
  that raises (``COHORT_FALLBACKS`` counts it; every member is answered).

The kernels themselves are held to these plain versions on the card
(chip_smoke.py phase 17).
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horaedb_tpu
import horaedb_tpu_torch
from horaedb_tpu.ops import encoding as jenc
from horaedb_tpu.ops import scan_agg as ref
from horaedb_tpu.ops import scan_topk as ref_topk
from horaedb_tpu_torch.convert import entry_from_reference
from horaedb_tpu_torch.ops import scan_agg as port
from horaedb_tpu_torch.ops import scan_topk as port_topk
from horaedb_tpu_torch.query import executor as port_executor

from test_torch_scan_agg import LAYOUT_TUPLES, PER, S, _expected_rows, _resident
from test_torch_scan_topk import KEYS, LAYOUTS, N, _columns, _port_parts, _ref_parts
from torch_parity import SUM_RTOL, assert_state_equal, segment_abs_sums

OPS = ("=", "!=", "<", "<=", ">", ">=")
# arm -> (groups, buckets): one segment, a few, many
ARM_SHAPES = {"single": (1, 1), "shared": (8, 8), "scatter": (64, 8)}


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


# ---- B1e: the cohort scan-aggregate ------------------------------------------


def _members(rng, B, G, nb, n_filters):
    """B members' (gos, allow, lits, lo, hi, t0, width): member 1 allows
    no series, member 2 has an empty time range."""
    out = []
    for b in range(B):
        gos = np.append(rng.integers(0, G, S), 0).astype(np.int32)
        allow = np.append(rng.random(S) < 0.75, False)
        allow[0] = b != 1
        if b == 1:
            allow[:] = False
        lo = int(rng.integers(-200, 8_000))
        hi = lo if b == 2 else lo + int(rng.integers(5_000, 40_000))
        t0 = lo - int(rng.integers(0, 700))
        width = max(1, (hi - t0) // nb + 1)
        lits = [float(rng.integers(-12, 13)) for _ in range(n_filters)]
        out.append((gos, allow, lits, lo, hi, t0, width))
    return out


def _cohort_case(rng, layouts_case, arm, need_minmax, B, n_agg=None, special=False):
    series_layout, ts_layout, kinds = layouts_case
    arrays, layouts, host = _resident(rng, series_layout, ts_layout, kinds)
    if special:
        # NaN and signed zeros among rows the members keep (field 0 is raw)
        for rows, val in ((slice(5, 9), np.nan), (slice(40, 47), -0.0),
                          (slice(47, 52), 0.0), (slice(PER + 3, PER + 5), -0.0)):
            arrays["value/0/0"][rows] = val
            host["values"][0][rows] = val
    nf = len(kinds)
    n_agg = nf - 1 if n_agg is None else n_agg
    G, nb = ARM_SHAPES[arm]
    filters = ((nf - 1, OPS[_seed(layouts_case, arm, B) % 6]),)
    members = _members(rng, B, G, nb, len(filters))
    sessions = np.stack([ref.pack_session(m[0], m[1]) for m in members])
    dyns = np.stack([ref.pack_dyn(m[2], *m[3:]) for m in members])
    kw = dict(n_groups=G, n_buckets=nb, n_agg_fields=n_agg,
              numeric_filters=ref.encode_filter_ops(filters), need_minmax=need_minmax)

    def jparts(prefix):
        return tuple(jnp.asarray(arrays[f"{prefix}/{k}"]) for k in range(2)
                     if f"{prefix}/{k}" in arrays)

    jvalues = tuple(jparts(f"value/{f}") for f in range(nf))
    lay = dict(value_layouts=tuple(layouts["value"]), ts_layout=layouts["ts_rel"],
               series_layout=layouts["series_codes"])
    want = np.asarray(ref.cached_scan_agg_cohort(
        jparts("series_codes"), jparts("ts_rel"), jvalues, jnp.asarray(sessions),
        jnp.asarray(dyns), segment_impl="scatter", **lay, **kw,
    ))
    entry = entry_from_reference(arrays, layouts, "cpu")
    before = dict(port.PLAIN_CALLS)
    got = port.cached_scan_agg_cohort(
        *entry.kernel_args().values(), torch.from_numpy(sessions), torch.from_numpy(dyns),
        segment_impl=arm, **entry.layout_kwargs(), **kw,
    )
    assert port.PLAIN_CALLS["cached_cohort"] == before["cached_cohort"] + 1
    assert got.shape == (B, port.packed_len(G, nb, n_agg, need_minmax)) == want.shape
    spec = ref.ScanAggSpec(G, nb, n_agg, filters, need_minmax)
    counted = 0
    for j, (gos, allow, lits, lo, hi, t0, width) in enumerate(members):
        ws = ref.unpack_packed_state(want[j], spec)
        gs = port.unpack_packed_state(got[j], spec)
        seg, m, vals = _expected_rows(host, gos, allow, np.float32(lits), filters, lo, hi, t0,
                                      width, nb, None, n_agg)
        abs_sums = segment_abs_sums(seg, m, vals, G * nb).reshape(n_agg, G, nb)
        assert_state_equal(
            (gs.counts, gs.sums, gs.mins, gs.maxs), (ws.counts, ws.sums, ws.mins, ws.maxs),
            abs_sums, need_minmax, f"{layouts_case} {arm} member {j}",
        )
        solo = port.cached_scan_agg_packed(
            *entry.kernel_args().values(), torch.from_numpy(sessions[j]),
            torch.from_numpy(dyns[j]), segment_impl=arm, selective=False,
            **entry.layout_kwargs(), **kw,
        )
        assert torch.equal(solo.view(torch.int32), got[j].view(torch.int32)), j
        counted += int(gs.counts.sum())
        if j in (1, 2):  # the empty members count nothing
            assert gs.counts.sum() == 0
    return counted


COHORT_CASES = [
    (li, arm, need_minmax, (1, 2, 5)[(li + i + need_minmax) % 3])
    for li in range(len(LAYOUT_TUPLES))
    for i, arm in enumerate(ARM_SHAPES)
    for need_minmax in (True, False)
]


@pytest.mark.parametrize(
    "li,arm,need_minmax,B", COHORT_CASES,
    ids=lambda v: str(v),
)
def test_cohort_matches_reference_and_solo(li, arm, need_minmax, B):
    rng = np.random.default_rng(_seed(li, arm, need_minmax, B))
    counted = _cohort_case(rng, LAYOUT_TUPLES[li], arm, need_minmax, B)
    assert counted > 0  # member 0 always keeps rows


@pytest.mark.parametrize("arm", list(ARM_SHAPES))
@pytest.mark.parametrize("B", [2, 5])
def test_cohort_special_floats(arm, B):
    """NaN propagates and -0.0 < +0.0 in every member's min/max (the
    reference's scatter arm)."""
    rng = np.random.default_rng(_seed("special", arm, B))
    _cohort_case(rng, ("raw", "raw", ("raw", "raw")), arm, True, B, special=True)


@pytest.mark.parametrize("B", [1, 2, 5])
def test_cohort_count_only(B):
    """F = 0: the packed rows hold counts only."""
    rng = np.random.default_rng(_seed("count", B))
    _cohort_case(rng, ("delta", "delta", ("raw",)), "scatter", True, B, n_agg=0)


def test_cohort_of_no_members():
    rng = np.random.default_rng(5)
    arrays, layouts, _ = _resident(rng, "raw", "raw", ("raw", "raw"))
    entry = entry_from_reference(arrays, layouts, "cpu")
    out = port.cached_scan_agg_cohort(
        *entry.kernel_args().values(), torch.zeros((0, 2 * (S + 1)), dtype=torch.int32),
        torch.zeros((0, 5), dtype=torch.int32), n_groups=8, n_buckets=2, n_agg_fields=1,
        numeric_filters=((1, 4),), need_minmax=True, **entry.layout_kwargs(),
    )
    assert out.shape == (0, port.packed_len(8, 2, 1, True))


def test_cohort_wrapper_refuses_other_devices_before_any_build():
    """A tensor neither on the CPU nor on a card is refused before any
    kernel is built: no plain version runs for it."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.cached_scan_agg_cohort(
            (torch.zeros(4, dtype=torch.int32, device=meta),),
            (torch.zeros(4, dtype=torch.int32, device=meta),), (),
            torch.zeros((2, 4), dtype=torch.int32, device=meta),
            torch.zeros((2, 4), dtype=torch.int32, device=meta),
            n_groups=1, n_buckets=1, n_agg_fields=0, numeric_filters=(), need_minmax=False,
        )


# ---- B4c: the cohort top-k ------------------------------------------------------


def _topk_cohort_case(rng, cols, B, k, key_is_ts, desc, op):
    filters = ((1, OPS.index(op)),)
    allows, dyns = [], []
    for b in range(B):
        allow = np.append(rng.random(cols["S"]) < 0.8, False).astype(np.int32)
        allow[0] = 1
        lo, hi = 0, cols["ts_max"] + 1
        if b == 1:
            allow[:] = 0  # no series
        if b == 2:
            lo = hi = 50  # no time
        if b >= 3:
            lo = int(rng.integers(0, 200))
            hi = lo + int(rng.integers(100, cols["ts_max"] + 2))
        key_lo, key_hi = ref_topk.topk_key_bounds(desc, key_is_ts, lo, hi)
        allows.append(allow)
        dyns.append(ref_topk.pack_raw_dyn([cols["lits"][1]], lo, hi, key_lo, key_hi))
    sessions, dyns = np.stack(allows), np.stack(dyns)
    layouts = dict(value_layouts=cols["value_layouts"], ts_layout=cols["ts_layout"],
                   series_layout=cols["series_layout"])
    kw = dict(k=k, descending=desc, key_is_ts=key_is_ts, key_field=0,
              numeric_filters=filters)
    bf = [lay[0] == "bf16" for lay in cols["value_layouts"]]
    r_vals = tuple((_ref_parts(p, b),) if len(p) == 1 else _ref_parts(p)
                   for p, b in zip(cols["values"], bf))
    if all(lay == ("raw",) for lay in cols["value_layouts"]):
        r_vals = jnp.asarray(np.stack([p[0] for p in cols["values"]]))
    want = np.asarray(ref_topk.raw_topk_cohort(
        _ref_parts(cols["series"]), _ref_parts(cols["ts"]), r_vals, jnp.asarray(sessions),
        jnp.asarray(dyns), **kw, **layouts))
    p_args = (_port_parts(cols["series"]), _port_parts(cols["ts"]),
              tuple(_port_parts(p, b) for p, b in zip(cols["values"], bf)))
    before = dict(port_topk.PLAIN_CALLS)
    got = port_topk.raw_topk_cohort(*p_args, torch.from_numpy(sessions),
                                    torch.from_numpy(dyns), **kw, **layouts)
    assert port_topk.PLAIN_CALLS["raw_topk_cohort"] == before["raw_topk_cohort"] + 1
    assert np.array_equal(want, got.numpy()), (want, got)
    for b in range(B):
        solo = port_topk.raw_topk_packed(*p_args, torch.from_numpy(sessions[b]),
                                         torch.from_numpy(dyns[b]), **kw, **layouts)
        assert torch.equal(solo, got[b]), b
    if B > 2:
        assert (got[1] == -1).all() and (got[2] == -1).all()
    return got


@pytest.mark.parametrize("key_is_ts,desc", KEYS, ids=["ts-desc", "ts-asc", "f32-desc", "f32-asc"])
@pytest.mark.parametrize("li", range(len(LAYOUTS)), ids=lambda i: "-".join(
    [LAYOUTS[i][0], LAYOUTS[i][1], *LAYOUTS[i][2]]))
def test_topk_cohort_matches_reference_and_solo(li, key_is_ts, desc):
    rng = np.random.default_rng(_seed("topk", li, key_is_ts, desc))
    cols = _columns(rng, N, LAYOUTS[li])
    i = li * 4 + KEYS.index((key_is_ts, desc))
    B = (1, 3, 5)[i % 3]
    k = (16, 128, 1)[(i // 3) % 3]
    got = _topk_cohort_case(rng, cols, B, k, key_is_ts, desc, OPS[i % 6])
    assert got.shape == (B, k)


@pytest.mark.parametrize("k", [1, 2, 5, 12])
def test_topk_cohort_signed_zeros_at_the_threshold(k):
    """The padded-k rule for +-0: -0.0 ranks below +0.0 in every member."""
    key = [-0.0, -0.0, -0.0, -0.0, -5.0, 0.0, -1.0, -2.0, -3.0, -4.0, -6.0, -7.0]
    n = len(key)
    cols = {"S": 1, "ts_max": n - 1, "series": (np.zeros(n, np.int32),),
            "series_layout": ("raw",), "ts": (np.arange(n, dtype=np.int32),),
            "ts_layout": ("raw",),
            "values": [(np.asarray(key, np.float32),), (np.arange(n, dtype=np.float32),)],
            "value_layouts": (("raw",), ("raw",)), "lits": [0.0, -1.0]}
    rng = np.random.default_rng(k)
    for desc in (True, False):
        _topk_cohort_case(rng, cols, 3, k, False, desc, ">")


def _decoded(cols):
    """The columns' series codes, relative timestamps and values, decoded
    by the port (torch tensors) as a launch reads them."""
    from horaedb_tpu_torch.ops import encoding as penc

    bf = [lay[0] == "bf16" for lay in cols["value_layouts"]]
    return penc.decode_layouts(_port_parts(cols["series"]), _port_parts(cols["ts"]),
                               tuple(_port_parts(p, b) for p, b in zip(cols["values"], bf)),
                               cols["series_layout"], cols["ts_layout"], cols["value_layouts"])


def _estimate_windows(cols, sessions, dyns, n_f):
    """Each member's windows as the executor computes them for a top-k
    (``_raw_candidate_estimate(..., exact=False)``), over an entry whose
    series time index is built from the columns' real rows."""
    from types import SimpleNamespace

    from horaedb_tpu_torch.query.scan_cache import SeriesTimeIndex

    sc, tr, _ = _decoded(cols)
    codes, ts = sc.numpy().astype(np.int64), tr.numpy().astype(np.int32)
    S = cols["S"]
    n_valid = int((codes < S).sum())
    offsets = np.searchsorted(codes[:n_valid], np.arange(S + 1))
    entry = SimpleNamespace(n_valid=n_valid, min_ts=0,
                            max_ts=int(ts[:n_valid].max()) if n_valid else 0,
                            time_index=SeriesTimeIndex(ts[:n_valid], offsets))
    out = []
    for b in range(len(sessions)):
        allowed = sessions[b, :S] != 0
        # the executor's range, clamped to the entry's timestamps
        lo, hi = max(int(dyns[b, n_f]), entry.min_ts), min(int(dyns[b, n_f + 1]), entry.max_ts + 1)
        if hi <= lo or not allowed.any():  # the executor launches nothing here
            out.append(np.empty((0, 2), np.int64))
            continue
        out.append(port_executor.Executor._raw_candidate_estimate(
            None, entry, allowed, lo, hi, exact=False)[1])
    return out


def _window_members(rng, cols, kind, B):
    """B members' allow lists and (lo, hi): ``overlapping`` members allow
    overlapping series sets over overlapping time ranges; ``disjoint`` one
    series each, every member another; ``empty`` members with no series, no
    time and a range past the data beside one that passes rows."""
    S, ts_max = cols["S"], cols["ts_max"]
    out = []
    for b in range(B):
        allow = np.zeros(S + 1, np.int32)
        lo, hi = 0, ts_max + 1
        if kind == "overlapping":
            allow[:S] = rng.random(S) < 0.5
            allow[b % S] = 1
            lo = int(rng.integers(0, ts_max // 2 + 1))
            hi = lo + int(rng.integers(1, ts_max + 2))
        elif kind == "disjoint":
            allow[b % S] = 1
        else:
            allow[:S] = b != 1
            if b == 2:
                lo = hi = 50
            if b == 3:
                lo, hi = ts_max + 1, ts_max + 100
        out.append((allow, lo, hi))
    return out


@pytest.mark.parametrize("kind", ["overlapping", "disjoint", "empty"])
@pytest.mark.parametrize("key_is_ts,desc", KEYS, ids=["ts-desc", "ts-asc", "f32-desc", "f32-asc"])
@pytest.mark.parametrize("li", range(len(LAYOUTS)), ids=lambda i: "-".join(
    [LAYOUTS[i][0], LAYOUTS[i][1], *LAYOUTS[i][2]]))
def test_topk_cohort_windows_from_the_candidate_estimate(li, key_is_ts, desc, kind):
    """Per-member windows from the executor's candidate estimate cover every
    row each member's mask passes; the windowed cohort answers as the
    unwindowed one and the reference's; its tile table marks each tile with
    the members whose windows meet it."""
    rng = np.random.default_rng(_seed("windows", li, key_is_ts, desc, kind))
    cols = _columns(rng, N, LAYOUTS[li])
    i = li * 4 + KEYS.index((key_is_ts, desc))
    B = {"overlapping": 5, "disjoint": 6, "empty": 4}[kind]
    k = (16, 128, 1)[i % 3]
    op = OPS[i % 6]
    filters = ((1, OPS.index(op)),)
    members = _window_members(rng, cols, kind, B)
    sessions = np.stack([a for a, _, _ in members])
    dyns = np.stack([ref_topk.pack_raw_dyn([cols["lits"][1]], lo, hi,
                                           *ref_topk.topk_key_bounds(desc, key_is_ts, lo, hi))
                     for _, lo, hi in members])
    windows = _estimate_windows(cols, sessions, dyns, 1)
    sc, tr, vals = _decoded(cols)
    n = len(sc)
    for b in range(B):
        lits, lo, hi, _, _ = port_topk._unpack_dyn(torch.from_numpy(dyns[b]), filters)
        m = port_topk._raw_mask(sc, tr, vals, torch.from_numpy(sessions[b] != 0), lits, lo, hi,
                                filters).numpy()
        inside = np.zeros(n, bool)
        for a, e in windows[b]:
            inside[a:e] = True
        assert inside[m].all(), f"member {b}'s windows miss a passing row"
    if kind == "empty":
        assert all(len(windows[b]) == 0 for b in (1, 2, 3)) and len(windows[0])
    layouts = dict(value_layouts=cols["value_layouts"], ts_layout=cols["ts_layout"],
                   series_layout=cols["series_layout"])
    kw = dict(k=k, descending=desc, key_is_ts=key_is_ts, key_field=0, numeric_filters=filters,
              **layouts)
    bf = [lay[0] == "bf16" for lay in cols["value_layouts"]]
    p_args = (_port_parts(cols["series"]), _port_parts(cols["ts"]),
              tuple(_port_parts(p, b) for p, b in zip(cols["values"], bf)))
    r_vals = tuple((_ref_parts(p, b),) if len(p) == 1 else _ref_parts(p)
                   for p, b in zip(cols["values"], bf))
    if all(lay == ("raw",) for lay in cols["value_layouts"]):
        r_vals = jnp.asarray(np.stack([p[0] for p in cols["values"]]))
    want = np.asarray(ref_topk.raw_topk_cohort(
        _ref_parts(cols["series"]), _ref_parts(cols["ts"]), r_vals, jnp.asarray(sessions),
        jnp.asarray(dyns), **kw))
    s_t, d_t = torch.from_numpy(sessions), torch.from_numpy(dyns)
    got = port_topk.raw_topk_cohort(*p_args, s_t, d_t, windows=windows, **kw)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, port_topk.raw_topk_cohort(*p_args, s_t, d_t, **kw))
    for b in range(B):
        solo = port_topk.raw_topk_packed(*p_args, s_t[b], d_t[b], windows=windows[b], **kw)
        assert torch.equal(solo, got[b]), b
    if kind == "empty":
        assert (got[1:] == -1).all()
    _check_cohort_tiles(windows, n)


def _check_cohort_tiles(windows, n):
    """``cohort_tiles`` against a direct count: the tiles cut the union of
    the windows in row order, at most TILE rows each and inside one union
    window; bit m of a tile's mask is set exactly where a window of member
    m meets it; the item lists enumerate (member, tile) pairs member by
    member, and each tile's items in bit order."""
    tiles, tile_p, member_off, member_tiles = port_topk.cohort_tiles(windows, n)
    B = len(windows)
    union = np.zeros(n, bool)
    for w in windows:
        for a, e in w:
            union[a:e] = True
    covered = np.zeros(n, bool)
    for row0, row1, _, _ in tiles:
        assert 0 < row1 - row0 <= port_topk.TILE and union[row0:row1].all()
        assert not covered[row0:row1].any()
        covered[row0:row1] = True
    assert np.array_equal(covered, union)
    assert np.all(np.diff(tiles[:, 0]) > 0)
    pairs = []
    for t, (row0, row1, mask, item_off) in enumerate(tiles):
        mask = int(np.uint32(mask))
        for m, w in enumerate(windows):
            meets = any(a < row1 and e > row0 for a, e in w)
            assert bool(mask >> m & 1) == meets, (t, m)
        bits = [m for m in range(B) if mask >> m & 1]
        assert item_off == len(pairs)
        pairs += [(m, t) for m in bits]
    assert len(tile_p) == len(member_tiles) == len(pairs)
    by_member = sorted(pairs)
    assert np.array_equal(member_tiles, [t for _, t in by_member])
    assert np.array_equal(member_off, np.searchsorted([m for m, _ in by_member],
                                                      np.arange(B + 1)))
    assert [by_member[p] for p in tile_p] == pairs


def test_cohort_tiles_of_overlapping_windows():
    """32 members, windows that overlap across members, touch, start inside
    a 128-row block, span several tiles or hold one row; a member with
    none; the scratch they need grows with their tiles, not the rows."""
    rng = np.random.default_rng(5)
    n = 1 << 17
    windows = []
    for m in range(32):
        edges = np.unique(rng.integers(0, n + 1, 2 * int(rng.integers(1, 9))))
        w = edges[: len(edges) // 2 * 2].reshape(-1, 2)
        windows.append(np.empty((0, 2), np.int64) if m == 7 else w)
    windows[3] = np.array([[100, 101], [4095, 4097], [9000, 9000], [9001, 20_000]])
    windows[4] = np.array([[0, 4096], [4096, 8192]])  # touching: one union window
    _check_cohort_tiles(windows, n)
    member_off = port_topk.cohort_tiles(windows, n)[2]
    assert member_off[8] == member_off[7]  # no items for member 7
    small = port_topk.cohort_scratch_words(32, 3, 3)
    assert small[1] < 64 << 10 and small[0] % 4 == 0
    # two union windows of three members: items member by member, and each
    # tile's in bit order
    t, p, off, mt = port_topk.cohort_tiles(
        [np.array([[10, 20]]), np.array([[0, 5]]), np.array([[15, 40]])], 100)
    assert t.tolist() == [[0, 5, 0b010, 0], [10, 40, 0b101, 1]]
    assert p.tolist() == [1, 0, 2] and off.tolist() == [0, 1, 2, 3] and mt.tolist() == [1, 0, 1]


@pytest.mark.parametrize("bad", [
    "unsorted", "overlapping", "past_the_rows", "negative", "reversed", "members"])
def test_topk_cohort_refuses_malformed_windows(bad):
    """Windows that are unsorted, overlap within a member, reach past the
    rows or below 0, end before they start, or do not give one list a
    member raise on the CPU, as they would before a launch."""
    rng = np.random.default_rng(9)
    cols = _columns(rng, N, LAYOUTS[0])
    sessions = np.ones((2, cols["S"] + 1), np.int32)
    dyns = np.stack([ref_topk.pack_raw_dyn([0.0], 0, cols["ts_max"] + 1,
                                           *ref_topk.topk_key_bounds(True, True, 0,
                                                                     cols["ts_max"] + 1))] * 2)
    good = np.array([[0, 100], [200, N]], np.int64)
    wrong = {"unsorted": [[200, 300], [0, 100]], "overlapping": [[0, 150], [100, 300]],
             "past_the_rows": [[0, N + 1]], "negative": [[-1, 10]], "reversed": [[50, 40]]}
    windows = [good] if bad == "members" else [good, np.array(wrong[bad], np.int64)]
    p_args = (_port_parts(cols["series"]), _port_parts(cols["ts"]),
              tuple(_port_parts(p) for p in cols["values"]))
    with pytest.raises(ValueError):
        port_topk.raw_topk_cohort(*p_args, torch.from_numpy(sessions), torch.from_numpy(dyns),
                                  k=16, descending=True, key_is_ts=True, key_field=0,
                                  numeric_filters=(), value_layouts=cols["value_layouts"],
                                  ts_layout=cols["ts_layout"], series_layout=cols["series_layout"],
                                  windows=windows)


# ---- B1d: the selective cached scan-aggregate ----------------------------------


@pytest.mark.parametrize("need_minmax", [True, False])
@pytest.mark.parametrize("impl", ["auto", "scatter", "hash"])
def test_selective_cached_scan_agg_matches_reference(need_minmax, impl):
    rng = np.random.default_rng(_seed("b1d", need_minmax, impl))
    n = S * PER
    codes = np.append(np.repeat(np.arange(S), PER), S).astype(np.int32)
    ts = np.append(np.tile(np.arange(PER) * 100, S) + rng.integers(0, 90, n), -1)
    ts = ts.astype(np.int32)
    vals = np.round(rng.normal(0, 20, (3, n + 1))).astype(np.float32)
    G, nb = 8, 4
    gos = np.append(rng.integers(0, G, S), 0).astype(np.int32)
    allow = np.append(rng.random(S) < 0.8, False)
    allow[2] = True
    pick = [2, 5, 9]
    idx = np.concatenate([np.arange(s * PER + 11, s * PER + 240, dtype=np.int32)
                          for s in pick])
    idx = jenc.pad_to_bucket(idx, len(idx), fill=np.int32(n))
    filters = ((2, ">="), (0, "!="))
    lits = np.array([-4.0, 3.0], dtype=np.float32)
    lo, hi, t0, width = 1_500, 26_000, 1_000, 6_300
    kw = dict(n_groups=G, n_buckets=nb, n_agg_fields=2,
              numeric_filters=ref.encode_filter_ops(filters), need_minmax=need_minmax,
              segment_impl=impl)
    want = ref.selective_cached_scan_agg(
        jnp.asarray(idx), jnp.asarray(codes), jnp.asarray(ts), jnp.asarray(vals),
        jnp.asarray(gos), jnp.asarray(allow), jnp.asarray(lits), np.int32(lo), np.int32(hi),
        np.int32(t0), np.int32(width), **kw)
    before = port.PLAIN_CALLS["cached_selective"]
    got = port.selective_cached_scan_agg(
        torch.from_numpy(idx), torch.from_numpy(codes), torch.from_numpy(ts),
        torch.from_numpy(vals), torch.from_numpy(gos), torch.from_numpy(allow),
        torch.from_numpy(lits), lo, hi, t0, width, **kw)
    assert port.PLAIN_CALLS["cached_selective"] == before + 1
    host = {"codes": codes, "ts": ts, "values": list(vals)}
    seg, m, agg = _expected_rows(host, gos, allow, lits, filters, lo, hi, t0, width, nb, idx, 2)
    abs_sums = segment_abs_sums(seg, m, agg, G * nb).reshape(2, G, nb)
    assert_state_equal([g.numpy() for g in got], [np.asarray(w) for w in want], abs_sums,
                       need_minmax, f"B1d {impl}")
    assert int(got[0].sum()) > 0


# ---- Executor.execute_cohort ----------------------------------------------------

DDL = ("CREATE TABLE dash (host string TAG, v double, w double, "
       "ts timestamp NOT NULL, TIMESTAMP KEY(ts)) ENGINE=Analytic")


def _fill(db, hosts=40, rows=60, seed=11):
    rng = np.random.default_rng(seed)
    vals = []
    for h in range(hosts):
        for i in range(rows):
            vals.append(f"('h{h}', {float(np.round(rng.normal(0, 30), 2))}, "
                        f"{float(rng.integers(-9, 10))}, {1000 + i * 10})")
    db.execute(DDL)
    db.execute("INSERT INTO dash (host, v, w, ts) VALUES " + ",".join(vals))
    db.flush_all()


@pytest.fixture()
def dbs(monkeypatch):
    monkeypatch.setenv("HORAEDB_ADAPTIVE_PATH", "0")
    from horaedb_tpu.query.path_router import KERNEL_ROUTER

    KERNEL_ROUTER.reset()
    ref_db = horaedb_tpu.connect(None)
    port_db = horaedb_tpu_torch.connect(None, device="cpu")
    for db in (ref_db, port_db):
        _fill(db)
    yield ref_db, port_db
    ref_db.close()
    port_db.close()
    KERNEL_ROUTER.reset()


def _same_rows(ref_out, port_out, what):
    """Row for row: keys and counts exact, sums/avgs within SUM_RTOL of the
    answer's magnitude (the two packages sum in different orders)."""
    want = sorted(tuple(r.values()) for r in ref_out.to_pylist())
    got = sorted(tuple(r.values()) for r in port_out.to_pylist())
    assert len(want) == len(got), what
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            if isinstance(a, float) and isinstance(b, float):
                assert b == pytest.approx(a, rel=SUM_RTOL, abs=1e-3), (what, w, g)
            else:
                assert a == b, (what, w, g)


def _cohort(db, sqls):
    plans = [db._cached_plan(s) for s in sqls]
    table = db.catalog.open(plans[0].table)
    return db.interpreters.executor.execute_cohort(plans, table)


FLOOD = [
    f"SELECT host, count(v), sum(v), max(v), min(w) FROM dash "
    f"WHERE ts >= {1000 + 40 * i} AND ts < 1600 AND w >= {i - 4} GROUP BY host"
    for i in range(5)
]


def test_execute_cohort_fuses_and_matches_reference(dbs):
    ref_db, port_db = dbs
    for db in dbs:  # warm: the first sighting misses, the second builds
        for s in FLOOD[:2]:
            db.execute(s)
    before = dict(port.PLAIN_CALLS)
    want = _cohort(ref_db, FLOOD)
    got = _cohort(port_db, FLOOD)
    assert port.PLAIN_CALLS["cached_cohort"] == before["cached_cohort"] + 1
    for s, w, g in zip(FLOOD, want, got):
        assert not isinstance(g, BaseException), g
        _same_rows(w, g, s)
        assert g.metrics["batch_cohort"] == len(FLOOD)
        assert g.metrics["path"] == "device-cached"


def test_lone_member_regains_the_selective_gather(dbs):
    ref_db, port_db = dbs
    sql = "SELECT host, sum(v) FROM dash WHERE host = 'h3' GROUP BY host"
    for db in dbs:
        db.execute(sql)
        db.execute(sql)
    before = dict(port.PLAIN_CALLS)
    (want,), (got,) = _cohort(ref_db, [sql]), _cohort(port_db, [sql])
    _same_rows(want, got, sql)
    assert port.PLAIN_CALLS["cached_selective"] == before["cached_selective"] + 1
    assert port.PLAIN_CALLS["cached_cohort"] == before["cached_cohort"]
    assert got.metrics["cache_rows"] == want.metrics["cache_rows"] > 0


def test_bailed_prepare_serves_solo(dbs):
    """A cold table: the first member's prepare misses the cache (a first
    sighting) and that member runs solo; the second builds the entry, and
    it and the third fuse. Answers as the reference's."""
    ref_db, port_db = dbs
    before = dict(port.PLAIN_CALLS)
    want, got = _cohort(ref_db, FLOOD[:3]), _cohort(port_db, FLOOD[:3])
    for s, w, g in zip(FLOOD, want, got):
        _same_rows(w, g, s)
    assert "batch_cohort" not in got[0].metrics and "cache" not in got[0].metrics
    assert [g.metrics["batch_cohort"] for g in got[1:]] == [2, 2]
    assert [w.metrics.get("batch_cohort") for w in want] == [None, 2, 2]
    assert port.PLAIN_CALLS["cached_cohort"] == before["cached_cohort"] + 1


def test_fused_failure_falls_back_solo_and_is_counted(dbs, monkeypatch):
    ref_db, port_db = dbs
    for db in dbs:
        for s in FLOOD[:2]:
            db.execute(s)

    def broken(self, preps):
        raise RuntimeError("injected fused failure")

    monkeypatch.setattr(port_executor.Executor, "dispatch_cached_agg_cohort", broken)
    before = port_executor.COHORT_FALLBACKS
    want, got = _cohort(ref_db, FLOOD), _cohort(port_db, FLOOD)
    assert port_executor.COHORT_FALLBACKS == before + 1
    for s, w, g in zip(FLOOD, want, got):
        assert not isinstance(g, BaseException), g
        _same_rows(w, g, s)
    port_executor.reset_counts()
    assert port_executor.COHORT_FALLBACKS == 0


def test_members_routed_to_different_arms_share_one_launch(dbs, monkeypatch):
    """The router sends every other member to another arm, as its probes
    do: the cohort still takes one launch, with its first member's arm,
    and answers as the reference's."""
    from horaedb_tpu_torch.query import path_router as port_router

    ref_db, port_db = dbs
    for db in dbs:
        for s in FLOOD[:2]:
            db.execute(s)
    arms = iter(["scatter", "shared"] * len(FLOOD))
    monkeypatch.setattr(port_router.KERNEL_ROUTER, "choose",
                        lambda key, seed, candidates: next(arms))
    before = dict(port.PLAIN_CALLS)
    want, got = _cohort(ref_db, FLOOD), _cohort(port_db, FLOOD)
    assert port.PLAIN_CALLS["cached_cohort"] == before["cached_cohort"] + 1
    assert port.PLAIN_CALLS["cached"] == before["cached"]
    for s, w, g in zip(FLOOD, want, got):
        assert not isinstance(g, BaseException), g
        _same_rows(w, g, s)
        assert g.metrics["batch_cohort"] == len(FLOOD)
        assert g.metrics["kernel"] == "scatter"


def test_group_codes_are_computed_once_per_entry(dbs, monkeypatch):
    """The GROUP BY codes of the entry's series rows are computed at its
    first grouped query and reused, read-only, by every later one."""
    from horaedb_tpu_torch.ops import encoding as port_encoding

    _, port_db = dbs
    for s in FLOOD[:2]:
        port_db.execute(s)
    entry = port_db.interpreters.executor.scan_cache._entries["dash"]
    codes, (hosts,) = entry._group_codes[("host",)]
    assert not codes.flags.writeable and len(hosts) == 40

    def recomputed(cols):
        raise AssertionError("group codes recomputed")

    monkeypatch.setattr(port_encoding, "_codes_from_columns", recomputed)
    got = _cohort(port_db, FLOOD)
    assert all(not isinstance(g, BaseException) for g in got), got
    assert entry._group_codes[("host",)][0] is codes


def test_shape_keys_are_memoized_per_plan(monkeypatch):
    """plan_shape_key and batch_plan_key are computed once per plan object,
    mask literals (and, for the batch key, LIMIT), equal the reference's
    keys, and the memo is bounded."""
    from horaedb_tpu.query import path_router as ref_router
    from horaedb_tpu.wlm import batch_plan_key as ref_batch_key
    from horaedb_tpu_torch.query import path_router as port_router
    from horaedb_tpu_torch.wlm import batch_plan_key

    ref_db = horaedb_tpu.connect(None)
    port_db = horaedb_tpu_torch.connect(None, device="cpu")
    try:
        for db in (ref_db, port_db):
            _fill(db, hosts=2, rows=3)
        limited = FLOOD[0].replace("GROUP BY host", "GROUP BY host LIMIT 3")
        p0, p1, pl = (port_db._cached_plan(s) for s in (FLOOD[0], FLOOD[1], limited))
        assert port_db._cached_plan(FLOOD[0]) is p0
        k0 = port_router.plan_shape_key(p0)
        assert port_router.plan_shape_key(p0) is k0
        assert k0 == port_router.plan_shape_key(p1) != port_router.plan_shape_key(pl)
        assert batch_plan_key(p0) is batch_plan_key(p0)
        assert batch_plan_key(p0) == batch_plan_key(p1) == batch_plan_key(pl)
        for s in (FLOOD[0], limited):
            assert port_router.plan_shape_key(port_db._cached_plan(s)) == \
                ref_router.plan_shape_key(ref_db._cached_plan(s))
            assert batch_plan_key(port_db._cached_plan(s)) == \
                ref_batch_key(ref_db._cached_plan(s))
        monkeypatch.setattr(port_router, "MEMO_PLANS", 2)
        port_router._PLAN_SHAPES.clear()
        for p in (p0, p1, pl):
            port_router.plan_shape_key(p)
        assert len(port_router._PLAN_SHAPES) <= 2
    finally:
        ref_db.close()
        port_db.close()


@pytest.mark.parametrize("seed", range(4))
def test_duplicate_delta_keys_found_as_np_unique_finds_them(seed):
    """The delta's (tsid, ts) duplicate check against the reference's
    ``np.unique(pairs, axis=1)``: uint64 tsids past 2^63, keys repeated in
    one column only, and true duplicates."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 50))
    tsid = rng.choice(np.array([1, 2, 2**63 + 5, 2**64 - 1], dtype=np.uint64), n)
    ts = rng.integers(0, 4, n).astype(np.int64)
    for a, b in ((tsid, ts), (np.arange(n, dtype=np.uint64), ts), (tsid[:1], ts[:1])):
        pairs = np.stack([a.astype(np.int64), b.astype(np.int64)])
        want = len(a) > 0 and np.unique(pairs, axis=1).shape[1] != len(a)
        assert port_executor._has_duplicate_pairs(a, b) == want


def test_unflushed_key_written_twice_matches_reference(dbs):
    """An unflushed delta that writes one key twice cannot be added to the
    cached base; the answer is the reference's (the later write wins)."""
    ref_db, port_db = dbs
    sql = FLOOD[0].replace("ts < 1600", "ts < 9000")
    for db in dbs:
        db.execute(sql)
        db.execute(sql)
        for v in (5.0, 7.0):
            db.execute(f"INSERT INTO dash (host, v, w, ts) VALUES ('h1', {v}, 1.0, 5000)")
    got = port_db.execute(sql)
    assert "cache" not in got.metrics  # the cached path refused the delta
    _same_rows(ref_db.execute(sql), got, sql)


def test_launch_counters_lose_no_update_across_threads():
    """The wrappers run on the proxy's pool threads: 16 threads x 40 plain
    calls under a tiny switch interval must count 640, not fewer."""
    import sys
    import threading

    rng = np.random.default_rng(9)
    arrays, layouts, _ = _resident(rng, "raw", "raw", ("raw", "raw"))
    entry = entry_from_reference(arrays, layouts, "cpu")
    gos, allow = np.zeros(S + 1, np.int32), np.ones(S + 1, bool)
    sessions = torch.from_numpy(np.stack([ref.pack_session(gos, allow)]))
    dyns = torch.from_numpy(np.stack([ref.pack_dyn([0.0], 0, 10, 0, 10)]))
    kw = dict(n_groups=1, n_buckets=1, n_agg_fields=0, numeric_filters=((1, 4),),
              need_minmax=False, **entry.layout_kwargs())
    cols = tuple(entry.kernel_args().values())
    before = port.PLAIN_CALLS["cached_cohort"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            port.cached_scan_agg_cohort(*cols, sessions, dyns, **kw) for _ in range(40)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert port.PLAIN_CALLS["cached_cohort"] == before + 640


def test_cohort_tile_and_arm():
    """The tile fits 48 KB of decoded rows; single and shared hold only
    where every member's partials fit shared memory beside the tile."""
    assert [port.cohort_tile(f) for f in (0, 1, 10, 32)] == [4096, 4096, 1024, 256]
    assert port.cohort_arm("shared", 1, 1, 4096, 1, True) == "shared"
    assert port.cohort_arm("shared", 32, 1, 4096, 1, True) == "scatter"
    assert port.cohort_arm("shared", 32, 3, 128, 2, True) == "shared"
    assert port.cohort_arm("single", 32, 2, 1, 1, True) == "single"
    assert port.cohort_arm("scatter", 2, 2, 8, 1, False) == "scatter"
    with pytest.raises(ValueError, match="single arm"):
        port.cohort_arm("single", 2, 2, 8, 1, False)


def test_cohort_dispatch_hands_the_real_rows_to_the_kernel(dbs, monkeypatch):
    """``Executor.dispatch_cached_agg_cohort`` passes the entry's real
    rows; the answers stay the reference's."""
    ref_db, port_db = dbs
    for db in dbs:
        for s in FLOOD[:2]:
            db.execute(s)
    seen = []
    orig = port.cached_scan_agg_cohort

    def spy(*a, **k):
        seen.append(k.get("n_rows"))
        return orig(*a, **k)

    monkeypatch.setattr(port, "cached_scan_agg_cohort", spy)
    got = _cohort(port_db, FLOOD)
    entry = port_db.interpreters.executor.scan_cache._entries["dash"]
    assert seen == [entry.n_valid] and entry.n_valid == 40 * 60 < entry.padded_rows
    for s, w, g in zip(FLOOD, _cohort(ref_db, FLOOD), got):
        _same_rows(w, g, s)


def test_cohort_records_and_their_room():
    """A member's record: a segment and a count a pass of FCAP fields, then
    every field's sum (and min and max); the records of the 8 warps take
    room after the tile and the arm's partials, and carry holds only where
    they fit."""
    assert port.cohort_record_words(0, False) == 2
    assert port.cohort_record_words(1, True) == 5
    assert port.cohort_record_words(10, False) == 12
    assert port.cohort_record_words(11, True) == 4 + 33
    assert port.cohort_record_words(31, True) == 8 + 93
    # the flood's launch: a 4096-row tile of 3 words and 8 x 32 records of 5
    assert port.cohort_smem("scatter", 32, 1, 4096, 1, True, True) == 4096 * 12 + 8 * 32 * 20
    assert port.cohort_smem("scatter", 32, 1, 4096, 1, True, False) == 4096 * 12
    assert port.cohort_smem("shared", 2, 3, 8, 2, True, True) == (
        2048 * 20 + 2 * 8 * 7 * 4 + 8 * 2 * 8 * 4)
    assert port.cohort_carry("scatter", 32, 1, 4096, 1, True)
    assert port.cohort_carry("shared", 33, 11, 64, 10, False)
    assert not port.cohort_carry("scatter", 64, 32, 1024, 31, True)


def test_cohort_chunks():
    """A chunk is a warp's part of the tile; the chunks cover the rows."""
    assert port.cohort_chunks(34_560_000, 1) == (512, 67_500)
    assert port.cohort_chunks(0, 1) == (512, 0)
    assert port.cohort_chunks(513, 10) == (128, 5)
    assert port.cohort_chunks(4096, 32) == (32, 128)


def test_cohort_args_mirror_the_kernel_layout():
    """``CohortArgs`` keeps its older fields first (an older launcher reads
    only those), then the statistics pointer and the carry flag;
    ``scan_agg_abi`` checks the whole size against the kernel's at load."""
    import ctypes

    A = port._CohortArgs
    assert A.sessions.offset == ctypes.sizeof(port._CachedArgs)
    assert A.stats.offset == A.pad_.offset + 4 == A.out_w.offset + 8 + 6 * 4
    assert A.carry.offset == A.stats.offset + 8
    assert ctypes.sizeof(A) == A.carry.offset + 8
    assert port.COHORT_STATS == ("chunks", "member_chunks", "member_chunks_skipped", "commits")
