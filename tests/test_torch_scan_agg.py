"""Parity of the port's fused scan-aggregate with the JAX package's.

The port's wrappers run their plain PyTorch versions for CPU tensors;
these tests hand the same numpy inputs to the JAX programs and to the
port: ``_fused_scan_agg`` (every JAX segment arm) against ``fused_scan_agg``,
and ``cached_scan_agg_packed`` (full and selective) against its port, over
all six filter ops, both ``need_minmax`` values, F = 0, every resident
layout tuple, empty segments, a negative ``t0_rel`` and pad rows.
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from horaedb_tpu.ops import encoding as jenc
from horaedb_tpu.ops import scan_agg as ref
from horaedb_tpu_torch.convert import entry_from_reference
from horaedb_tpu_torch.ops import scan_agg as port

from torch_parity import (
    assert_bit_equal,
    assert_state_equal,
    segment_abs_sums,
)

OPS = ("=", "!=", "<", "<=", ">", ">=")


def _seed(*parts) -> int:
    """A seed from the case's parameters, the same in every process."""
    return zlib.crc32(repr(parts).encode())


def _direct_inputs(rng, n, G, B, F, n_fields, filters, special=False):
    g = rng.integers(0, G, n).astype(np.int32)
    b = rng.integers(0, B, n).astype(np.int32)
    m = rng.random(n) < 0.8
    # integer-valued columns make `=` / `!=` filters bite
    v = np.round(rng.normal(0, 5, (n_fields, n))).astype(np.float32)
    if special:
        # NaN and signed zeros among the kept rows
        v[:, 1] = np.nan
        v[:, 2] = -0.0
        v[:, 3] = 0.0
        m[1:4] = True
    batch = jenc.build_padded_batch(g, b, m, list(v))
    lits = np.array([rng.integers(-3, 4) for _ in filters], dtype=np.float32)
    return batch, lits


def _ref_mask(batch, lits, filters):
    m = batch.mask.copy()
    for (fi, op), lit in zip(filters, lits):
        v = batch.values[fi]
        m &= {
            "=": v == lit, "!=": v != lit, "<": v < lit,
            "<=": v <= lit, ">": v > lit, ">=": v >= lit,
        }[op]
    return m


def _run_direct(batch, lits, spec_kw, jax_impl, port_impl):
    kw = dict(spec_kw)
    filters = kw.pop("numeric_filters")
    codes = ref.encode_filter_ops(filters)
    want = ref._fused_scan_agg(
        batch.group_codes, batch.bucket_ids, batch.mask, batch.values,
        jnp.asarray(lits), numeric_filters=codes, segment_impl=jax_impl, **kw,
    )
    got = port.fused_scan_agg(
        torch.from_numpy(batch.group_codes), torch.from_numpy(batch.bucket_ids),
        torch.from_numpy(batch.mask), torch.from_numpy(batch.values),
        torch.from_numpy(lits), numeric_filters=codes, segment_impl=port_impl, **kw,
    )
    G, B, F = kw["n_groups"], kw["n_buckets"], kw["n_agg_fields"]
    seg = batch.group_codes * B + batch.bucket_ids
    kept = _ref_mask(batch, lits, filters) & (seg >= 0) & (seg < G * B)
    abs_sums = segment_abs_sums(seg, kept, batch.values[:F], G * B)
    assert_state_equal(
        [x.numpy() for x in got], [np.asarray(x) for x in want],
        abs_sums.reshape(F, G, B), kw["need_minmax"], f"{jax_impl}/{port_impl}",
    )
    return got


@pytest.mark.parametrize("jax_impl", ["scatter", "mxu"])
@pytest.mark.parametrize("need_minmax", [True, False])
@pytest.mark.parametrize("F", [0, 1, 3])
@pytest.mark.parametrize("op", OPS)
def test_direct_grouped_matches_reference(jax_impl, need_minmax, F, op):
    rng = np.random.default_rng(_seed(jax_impl, need_minmax, F, op))
    filters = ((F, op),)  # a filter-only field after the agg fields
    batch, lits = _direct_inputs(rng, 3000, 5, 6, F, F + 1, filters)
    spec = ref.ScanAggSpec(5, 6, F, filters, need_minmax).padded()
    kw = dict(
        n_groups=spec.n_groups, n_buckets=spec.n_buckets, n_agg_fields=F,
        numeric_filters=filters, need_minmax=need_minmax,
    )
    counts = _run_direct(batch, lits, kw, jax_impl, "scatter")[0].numpy()
    # padded groups 5..7 and bucket 6..7 stay empty
    assert (counts[5:] == 0).all() and (counts[:, 6:] == 0).all()
    if F and port.shared_fits(spec.n_groups * spec.n_buckets, F, need_minmax):
        _run_direct(batch, lits, kw, jax_impl, "shared")


@pytest.mark.parametrize("need_minmax", [True, False])
@pytest.mark.parametrize("F", [0, 2])
@pytest.mark.parametrize("op", OPS)
def test_direct_single_matches_reference(need_minmax, F, op):
    rng = np.random.default_rng(_seed("single", need_minmax, F, op))
    filters = ((F, op),)
    batch, lits = _direct_inputs(rng, 2000, 1, 1, F, F + 1, filters)
    kw = dict(
        n_groups=1, n_buckets=1, n_agg_fields=F,
        numeric_filters=filters, need_minmax=need_minmax,
    )
    _run_direct(batch, lits, kw, "single", "single")


@pytest.mark.parametrize("G,B,port_impl", [(1, 1, "single"), (8, 4, "scatter"), (8, 4, "shared")])
def test_special_floats_follow_scatter_arm(G, B, port_impl):
    """NaN propagates into sums, mins and maxs; -0.0 is the min and +0.0
    the max of {-0.0, +0.0}: the reference's scatter arm (its arms differ
    here — see ROADMAP queue C)."""
    rng = np.random.default_rng(G)
    batch, lits = _direct_inputs(rng, 1000, G, B, 2, 2, (), special=True)
    kw = dict(n_groups=G, n_buckets=B, n_agg_fields=2, numeric_filters=(), need_minmax=True)
    _run_direct(batch, lits, kw, "scatter", port_impl)


def test_out_of_range_segments_drop_like_a_scatter():
    rng = np.random.default_rng(3)
    batch, lits = _direct_inputs(rng, 500, 8, 2, 1, 1, ())
    batch.group_codes[:7] = 9  # beyond n_groups: dropped, as XLA's scatter drops
    kw = dict(n_groups=8, n_buckets=2, n_agg_fields=1, numeric_filters=(), need_minmax=True)
    _run_direct(batch, lits, kw, "scatter", "scatter")


# ---- the cached (resident) kernel ------------------------------------------


S = 13  # series
PER = 300  # rows per series (before the time cut)


def _resident(rng, series_layout, ts_layout, value_kinds):
    """Sorted (series, ts) resident columns with one pad row, encoded
    under the requested layouts with the JAX package's codecs; returns
    (numpy parts dict, layouts, decoded host columns)."""
    n = S * PER
    codes = np.repeat(np.arange(S), PER).astype(np.int32)
    # aligned timestamps (a dictionary fits) or jittered ones (delta fits)
    if ts_layout == "dict":
        ts = np.tile(np.arange(PER) * 100, S).astype(np.int32)
    else:
        ts = (np.tile(np.arange(PER) * 100, S) + rng.integers(0, 90, n)).astype(np.int32)
    padded = jenc.shape_bucket(n + 1)
    codes_p = jenc.pad_to_bucket(np.append(codes, np.int32(S)), n + 1, fill=S)
    ts_p = jenc.pad_to_bucket(np.append(ts, np.int32(-1)), n + 1, fill=np.int32(-1))
    arrays, layouts, host = {}, {"value": []}, {"codes": codes_p, "ts": ts_p, "values": []}
    if series_layout == "delta":
        d = jenc.delta_for_encode(codes_p, 8)
        arrays["series_codes/0"], arrays["series_codes/1"] = d.words, d.base
        layouts["series_codes"] = ("delta", d.width)
    else:
        arrays["series_codes/0"] = codes_p
        layouts["series_codes"] = ("raw",)
    ts_src = ts_p.copy()
    ts_src[n:] = ts_src[n - 1]  # pad rows are series-masked
    if ts_layout == "delta":
        d = jenc.delta_for_encode(ts_src, 16)
        arrays["ts_rel/0"], arrays["ts_rel/1"] = d.words, d.base
        layouts["ts_rel"] = ("delta", d.width)
        host["ts"] = ts_src
    elif ts_layout == "dict":
        d = jenc.dict_encode(ts_src, 4096)
        arrays["ts_rel/0"], arrays["ts_rel/1"] = d.words, d.dictionary
        layouts["ts_rel"] = ("dict", d.width)
        host["ts"] = ts_src
    else:
        arrays["ts_rel/0"] = ts_p
        layouts["ts_rel"] = ("raw",)
    for f, kind in enumerate(value_kinds):
        if kind in ("dict", "codes"):
            vocab = rng.choice(np.arange(-50, 50), 40, replace=False).astype(np.float32)
            col = np.pad(vocab[rng.integers(0, len(vocab), n)], (0, padded - n))
            d = jenc.dict_encode(col, 4096)
            arrays[f"value/{f}/0"], arrays[f"value/{f}/1"] = d.words, d.dictionary
            layouts["value"].append(("dict", d.width, kind == "dict"))
            decoded = (
                np.searchsorted(d.dict_host, col).astype(np.float32)
                if kind == "codes" else col
            )
        else:
            col = np.pad(np.round(rng.normal(0, 20, n)).astype(np.float32), (0, padded - n))
            if kind == "bf16":
                col = np.asarray(jnp.asarray(col).astype(jnp.bfloat16))
                layouts["value"].append(("bf16",))
            else:
                layouts["value"].append(("raw",))
            arrays[f"value/{f}/0"] = col
            decoded = col.astype(np.float32)
        host["values"].append(decoded)
    return arrays, layouts, host


def _session(rng):
    gos = np.append(rng.integers(0, 3, S), 0).astype(np.int32)
    allow = np.append(rng.random(S) < 0.75, False)
    allow[0] = True
    return gos, allow


def _expected_rows(host, gos, allow, lits, filters, lo, hi, t0, width, nb, idx, n_agg):
    rows = np.arange(len(host["codes"])) if idx is None else idx
    c = host["codes"][rows]
    t = host["ts"][rows].astype(np.int64)
    vals = np.stack([v[rows] for v in host["values"]])
    m = allow[c] & (t >= lo) & (t < hi)
    for (fi, op), lit in zip(filters, lits):
        v = vals[fi]
        m &= {
            "=": v == lit, "!=": v != lit, "<": v < lit,
            "<=": v <= lit, ">": v > lit, ">=": v >= lit,
        }[op]
    d = ((t - t0 + 2**31) % 2**32) - 2**31
    b = np.clip(np.floor_divide(d, width), 0, nb - 1)
    seg = gos[c].astype(np.int64) * nb + b
    return seg, m, vals[:n_agg]


LAYOUT_TUPLES = [
    ("raw", "raw", ("raw", "raw")),
    ("delta", "delta", ("raw", "bf16")),
    ("delta", "dict", ("dict", "codes")),
    ("raw", "dict", ("bf16", "dict", "codes")),
    ("delta", "raw", ("dict", "raw")),
]


def _run_cached(rng, layouts_case, need_minmax, selective, filters, n_agg, t0, width, lo, hi,
                prefix=None):
    """``filters``: ((value field, op), ...); ``prefix``: the port's full
    scan reads the "real" rows or the "padded" layout's (the reference
    reads every row)."""
    series_layout, ts_layout, kinds = layouts_case
    arrays, layouts, host = _resident(rng, series_layout, ts_layout, kinds)
    gos, allow = _session(rng)
    nf = len(kinds)
    lits = [float(rng.integers(-10, 11)) for _ in filters]
    n = S * PER
    nb = 8
    G = 8
    idx = None
    if selective:
        pick = np.nonzero(allow[:S])[0][:3]
        idx = np.concatenate(
            [np.arange(s * PER + 20, s * PER + 140, dtype=np.int32) for s in pick]
        )
        idx = jenc.pad_to_bucket(idx, len(idx), fill=np.int32(n))
    kw = dict(
        n_groups=G, n_buckets=nb, n_agg_fields=n_agg,
        numeric_filters=ref.encode_filter_ops(filters), need_minmax=need_minmax,
    )
    session = ref.pack_session(gos, allow)
    dyn = ref.pack_dyn(lits, lo, hi, t0, width, idx)
    jvalues = tuple(
        tuple(jnp.asarray(arrays[f"value/{f}/{k}"]) for k in range(2) if f"value/{f}/{k}" in arrays)
        for f in range(nf)
    )

    def jparts(prefix):
        return tuple(jnp.asarray(arrays[f"{prefix}/{k}"]) for k in range(2) if f"{prefix}/{k}" in arrays)

    want = ref.cached_scan_agg_packed(
        jparts("series_codes"), jparts("ts_rel"), jvalues,
        jnp.asarray(session), jnp.asarray(dyn),
        segment_impl="scatter", selective=selective,
        value_layouts=tuple(layouts["value"]), ts_layout=layouts["ts_rel"],
        series_layout=layouts["series_codes"], **kw,
    )
    entry = entry_from_reference(arrays, layouts, "cpu")
    before = dict(port.PLAIN_CALLS)
    rows = {None: None, "real": n, "padded": len(host["codes"])}[prefix]
    got = port.cached_scan_agg_packed(
        *entry.kernel_args().values(), torch.from_numpy(session), torch.from_numpy(dyn),
        segment_impl="scatter", selective=selective, n_rows=rows, **entry.layout_kwargs(), **kw,
    )
    form = "cached_selective" if selective else "cached"
    assert port.PLAIN_CALLS[form] == before[form] + 1
    spec = ref.ScanAggSpec(G, nb, n_agg, filters, need_minmax)
    ws = ref.unpack_packed_state(want, spec)
    gs = port.unpack_packed_state(got, spec)
    seg, m, vals = _expected_rows(
        host, gos, allow, np.float32(lits), filters, lo, hi, t0, width, nb, idx, n_agg
    )
    abs_sums = segment_abs_sums(seg, m, vals, G * nb).reshape(n_agg, G, nb)
    assert_state_equal(
        (gs.counts, gs.sums, gs.mins, gs.maxs), (ws.counts, ws.sums, ws.mins, ws.maxs),
        abs_sums, need_minmax, f"{layouts_case} sel={selective}",
    )
    # the raw packed buffers agree bit for bit outside the sums
    gb = G * nb
    assert_bit_equal(got.numpy()[:gb], np.asarray(want)[:gb], "packed counts")
    if need_minmax:
        assert_bit_equal(
            got.numpy()[gb + n_agg * gb:], np.asarray(want)[gb + n_agg * gb:], "packed min/max"
        )
    return gs


@pytest.mark.parametrize("layouts_case", LAYOUT_TUPLES, ids=lambda c: "-".join([c[0], c[1], *c[2]]))
@pytest.mark.parametrize("need_minmax", [True, False])
@pytest.mark.parametrize("selective", [False, True])
def test_cached_packed_matches_reference(layouts_case, need_minmax, selective):
    rng = np.random.default_rng(_seed(layouts_case, need_minmax, selective))
    nf = len(layouts_case[2])
    n_agg = nf - 1  # the last field is filter-only
    ops = ("!=", ">=") if selective else ("<=", ">")
    gs = _run_cached(
        rng, layouts_case, need_minmax, selective,
        ((0, ops[0]), (nf - 1, ops[1])), n_agg,
        t0=-500, width=4_000, lo=1_000, hi=25_000,
    )
    assert gs.counts.sum() > 0


@pytest.mark.parametrize("op", OPS)
def test_cached_each_filter_op(op):
    rng = np.random.default_rng(len(op) * 31 + ord(op[0]))
    _run_cached(
        rng, ("delta", "delta", ("raw", "dict", "codes")), True, False,
        ((0, op), (1, op), (2, op)) if op == "!=" else ((2, op),), 2, t0=0, width=6_000, lo=0, hi=30_000,
    )


def test_cached_count_only_and_wrapping_t0():
    """F = 0 (count only) with the lowest bucket origin the executor sends
    (-2**31 + 1): the int32 subtraction wraps and floors like JAX's."""
    rng = np.random.default_rng(17)
    _run_cached(
        rng, ("raw", "delta", ("raw",)), True, False, ((0, ">"),), 0,
        t0=-(2**31) + 1, width=700, lo=-100, hi=2**31 - 1,
    )


@settings(max_examples=12, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    width=st.integers(1, 9_000),
    t0=st.integers(-(2**31) + 1, 40_000),
    case=st.sampled_from(LAYOUT_TUPLES),
    selective=st.booleans(),
)
def test_cached_random_buckets(seed, width, t0, case, selective):
    rng = np.random.default_rng(seed)
    lo = int(rng.integers(-100, 20_000))
    hi = lo + int(rng.integers(0, 30_000))
    _run_cached(
        rng, case, bool(seed % 2), selective, ((len(case[2]) - 1, OPS[seed % 6]),),
        len(case[2]) - 1, t0=t0, width=width, lo=lo, hi=hi,
    )


def test_resolve_segment_impl_arms(monkeypatch):
    monkeypatch.delenv("HORAEDB_SEGMENT_IMPL", raising=False)
    assert port.resolve_segment_impl(1) == "single"
    assert port.resolve_segment_impl(64, "shared", 5) == "shared"
    assert port.resolve_segment_impl(4096 * 32, "shared", 10) == "scatter"
    assert port.resolve_segment_impl(64) == "scatter"
    monkeypatch.setenv("HORAEDB_SEGMENT_IMPL", "mxu")
    assert port.resolve_segment_impl(64, "scatter", 5) == "shared"
    monkeypatch.setenv("HORAEDB_SEGMENT_IMPL", "hash")  # the pin wins on every shape
    assert port.resolve_segment_impl(64, "scatter", 5) == "hash"
    assert port.resolve_segment_impl(1) == "hash"
    monkeypatch.delenv("HORAEDB_SEGMENT_IMPL")
    assert port.resolve_segment_impl(64, "hash", 5) == "hash"
    assert port.resolve_segment_impl(1, "hash") == "single"


def test_cuda_wrapper_rejects_bad_inputs_before_launch():
    """Input checks run before any kernel is built or launched: a tensor
    on the wrong device or of the wrong type raises ValueError."""
    meta = torch.device("meta")
    g = torch.zeros(8, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        port.fused_scan_agg(
            g, g, g.bool(), torch.zeros((1, 8), device=meta), torch.zeros(0, device=meta),
            n_groups=1, n_buckets=1, n_agg_fields=1,
        )


# ---- the segmented launches' geometry ----------------------------------------


def _smem_resident(per_slot: int, regs_limit: int = 3):
    """Blocks a SM holds: ``regs_limit`` by registers, fewer where a table
    of ``per_slot`` B a slot leaves less shared memory (228 KB a SM)."""
    return lambda slots: max(0, min(regs_limit, 233_472 // max(1, 16 + slots * per_slot)))


@pytest.mark.parametrize("n_rows", [0, 1, 255, 256, 257, 2880, 4096, 69_120, 131_072,
                                    1 << 18, 1 << 24])
@pytest.mark.parametrize("sms", [1, 4, 132])
@pytest.mark.parametrize("max_slots", [0, 16, 2048, 4096])
def test_segmented_geometry_whole_steps_all_resident(n_rows, sms, max_slots):
    """A block takes whole 32-row steps of its 8 warps (a multiple of
    BLOCK rows, a power of two of steps), every block is resident at once,
    and no fewer rows would do; a table is a power of two of at least
    twice the rows (or its limit) and at most the limit."""
    resident = _smem_resident(72)
    rows, slots = port.segmented_geometry(n_rows, sms, max_slots, resident)
    steps = rows // port.BLOCK
    assert rows % port.BLOCK == 0 and steps & (steps - 1) == 0
    blocks = -(-max(n_rows, 1) // rows)
    assert blocks <= sms * max(1, resident(slots))
    if rows > port.BLOCK:
        fewer = port.fitted_hash_slots(max_slots, rows // 2) if max_slots else 0
        assert -(-n_rows // (rows // 2)) > sms * max(1, resident(fewer))
    if max_slots:
        assert slots == port.fitted_hash_slots(max_slots, rows)
    else:
        assert slots == 0


def test_segmented_geometry_at_the_main_path_shapes():
    """On 132 SMs holding 3 blocks each: single-groupby-5-8-1's and
    sparse-8x1h's 4,096 gathered rows take one step a warp (16 blocks; the
    hash table 512 slots); sparse-16x12h's 131,072 (69,120
    real, padded) take two (256 blocks, 1,024 slots); bench.py's 2**18-row
    groupby shapes four."""
    resident = _smem_resident(72)
    assert port.segmented_geometry(4096, 132, 0, resident) == (256, 0)
    assert port.segmented_geometry(4096, 132, 2048, resident) == (256, 512)
    assert port.segmented_geometry(131_072, 132, 2048, resident) == (512, 1024)
    assert port.segmented_geometry(1 << 18, 132, 32, resident) == (1024, 32)
    # one block a SM (a 2048-slot table's shared memory) over 2**24 rows
    assert port.segmented_geometry(1 << 24, 132, 2048, lambda h: 1)[0] == 131_072


@pytest.mark.parametrize("max_slots", [2, 16, 256, 2048, 4096])
@pytest.mark.parametrize("rows", [256, 512, 768, 2048, 1 << 20])
def test_fitted_hash_slots(max_slots, rows):
    """A power of two, at least 2, at most the block's limit, and at least
    twice the rows a block takes unless the limit is lower."""
    h = port.fitted_hash_slots(max_slots, rows)
    assert h >= 2 and h & (h - 1) == 0
    assert h <= max_slots
    assert h >= 2 * rows or h == max_slots
    assert h < 4 * rows  # the least power of two that holds 2 x rows


def test_block_hash_slots_leave_room_for_the_claim_list():
    """The table fits shared memory with its claim count, keys, claim list
    and partials; the next power of two would not."""
    for slots in (16, 2048, 4096, 1 << 16):
        for F in (0, 1, 5, 10, 32):
            for minmax in (True, False):
                h = port.block_hash_slots(slots, F, minmax)
                per = 8 + (1 + (3 if minmax else 1) * F) * 4
                assert 16 + h * per <= port.SHARED_MEM_BYTES or h == 2
                assert h == slots or 16 + 2 * h * per > port.SHARED_MEM_BYTES


# ---- the full scan's real-row prefix -----------------------------------------


@pytest.mark.parametrize("layouts_case", LAYOUT_TUPLES, ids=lambda c: "-".join([c[0], c[1], *c[2]]))
@pytest.mark.parametrize("prefix", ["real", "padded"])
def test_cached_full_scan_over_a_prefix_matches_reference(layouts_case, prefix):
    """``n_rows`` (the rows a full scan reads: the real rows or all of
    the layout's) against the reference's program over every row."""
    rng = np.random.default_rng(_seed(layouts_case, prefix))
    nf = len(layouts_case[2])
    gs = _run_cached(rng, layouts_case, True, False, ((nf - 1, ">="),), nf - 1,
                     t0=-500, width=4_000, lo=0, hi=10**9, prefix=prefix)
    assert gs.counts.sum() > 0


def _prefix_table(rng):
    arrays, layouts, host = _resident(rng, "delta", "delta", ("raw", "raw"))
    entry = entry_from_reference(arrays, layouts, "cpu")
    sessions = np.stack([ref.pack_session(*_session(rng)) for _ in range(3)])
    dyns = np.stack([ref.pack_dyn([-5.0], lo, 10**9, 0, 3_000) for lo in (0, 700, 40_000)])
    kw = dict(n_groups=8, n_buckets=8, n_agg_fields=1, numeric_filters=((1, 5),),
              need_minmax=True, **entry.layout_kwargs())
    return entry, torch.from_numpy(sessions), torch.from_numpy(dyns), kw, len(host["codes"])


def test_plain_versions_give_one_answer_with_the_prefix_given_or_omitted():
    """The plain versions take ``n_rows`` and ignore it: the reference's
    function over every row, whatever the kernel's prefix."""
    entry, sessions, dyns, kw, padded = _prefix_table(np.random.default_rng(5))
    args = tuple(entry.kernel_args().values())
    for b in range(sessions.shape[0]):
        want = port.cached_scan_agg_packed(*args, sessions[b], dyns[b], **kw)
        for rows in (S * PER, padded):
            got = port.cached_scan_agg_packed(*args, sessions[b], dyns[b], n_rows=rows, **kw)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    want = port.cached_scan_agg_cohort(*args, sessions, dyns, **kw)
    assert want.view(torch.int32).any()
    for rows in (S * PER, padded):
        got = port.cached_scan_agg_cohort(*args, sessions, dyns, n_rows=rows, **kw)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("rows", [-1, "past"])
def test_a_prefix_outside_the_layout_raises(rows):
    entry, sessions, dyns, kw, padded = _prefix_table(np.random.default_rng(6))
    args = tuple(entry.kernel_args().values())
    rows = padded + 1 if rows == "past" else rows
    with pytest.raises(ValueError, match="n_rows"):
        port.cached_scan_agg_packed(*args, sessions[0], dyns[0], n_rows=rows, **kw)
    with pytest.raises(ValueError, match="n_rows"):
        port.cached_scan_agg_cohort(*args, sessions, dyns, n_rows=rows, **kw)


def test_executor_hands_the_real_rows_to_the_full_scan(monkeypatch):
    """``Executor.dispatch_cached_agg`` passes the entry's real rows: a
    prefix of the padded layout that holds every row."""
    import horaedb_tpu_torch

    monkeypatch.setenv("HORAEDB_ADAPTIVE_PATH", "0")
    db = horaedb_tpu_torch.connect(None, device="cpu")
    db.execute("CREATE TABLE t (host string TAG, v double, ts timestamp KEY) "
               "ENGINE=Analytic WITH (segment_duration='2h')")
    rng = np.random.default_rng(7)
    db.execute("INSERT INTO t (host, v, ts) VALUES " + ",".join(
        f"('h{h}', {float(rng.integers(-9, 10))}, {1000 + i * 10})"
        for h in range(7) for i in range(150)))
    db.flush_all()
    sql = "SELECT host, sum(v) AS s, count(v) AS c FROM t WHERE ts >= 0 GROUP BY host"
    seen = []
    orig = port.cached_scan_agg_packed

    def spy(*a, **k):
        seen.append((k.get("selective"), k.get("n_rows")))
        return orig(*a, **k)

    monkeypatch.setattr(port, "cached_scan_agg_packed", spy)
    for _ in range(3):
        out = db.execute(sql)
    entry = db.interpreters.executor.scan_cache._entries["t"]
    assert entry.n_valid == 1050 < entry.padded_rows
    assert seen and seen[-1] == (False, 1050)
    assert sum(r["c"] for r in out.to_pylist()) == 1050
    db.close()
