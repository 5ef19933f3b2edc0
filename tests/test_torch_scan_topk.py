"""The port's raw-read kernels (ops/scan_topk) against the JAX package's.

The same numpy inputs, made from a seed, go through the reference's jitted
``raw_topk_packed``/``raw_select_packed`` and through the port's wrappers
on CPU tensors (their plain PyTorch versions), with the same k and the
same resident layouts. Row indices and counts must be bit-equal, slot
order included, over every layout and the trap cases of the slice: NaN
last both ways, ties past k, fewer passing rows than k, +-0.0 at the
threshold, +-inf, an empty allow list or time range, k = n, one row, a
dictionary-coded key, delta timestamps and more than 2**24 rows. The
kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 14).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horaedb_tpu
import horaedb_tpu_torch
from horaedb_tpu.ops import scan_topk as ref
from horaedb_tpu_torch.ops import encoding as E, scan_topk as port

OPS = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
# (series layout, ts layout, (key field kind, filter field kind)); "codes"
# is a dictionary field kept in code space, as raw reads keep the sort key
LAYOUTS = [
    ("raw", "raw", ("raw", "raw")),
    ("delta", "delta", ("codes", "raw")),
    ("delta", "dict", ("raw", "codes")),
    ("raw", "delta", ("bf16", "dict")),
    ("delta", "raw", ("dict", "bf16")),
]
KEYS = [(True, True), (True, False), (False, True), (False, False)]  # (ts key, desc)
N = 3072


def _floats(rng, n, kind):
    """Integer-valued floats (exact in bf16) with ties, +-0, NaN and +-inf;
    dictionary kinds hold neither NaN nor both zeros (the codec refuses)."""
    if kind in ("dict", "codes"):
        vocab = rng.choice(np.arange(-200, 200), 90, replace=False).astype(np.float32)
        return vocab[rng.integers(0, len(vocab), n)]
    v = np.round(rng.normal(0, 60, n)).clip(-250, 250).astype(np.float32)
    pick = rng.random(n)
    specials = [(0.10, 100.0), (0.04, -0.0), (0.04, 0.0), (0.03, np.nan), (0.01, np.inf),
                (0.01, -np.inf)]
    lo = 0.0
    for p, val in specials:
        v[(pick >= lo) & (pick < lo + p)] = val
        lo += p
    return v


def _columns(rng, n, layout, n_series=6):
    """n resident rows sorted by (series, ts), a pad tail on series S, in
    ``layout``; numpy parts per column with their layout descriptors."""
    series_layout, ts_layout, kinds = layout
    codes = np.sort(rng.integers(0, n_series, n)).astype(np.int32)
    codes[n - min(7, n // 10):] = n_series
    rank = np.arange(n) - np.searchsorted(codes, codes, "left")
    jitter = 0 if ts_layout == "dict" else rng.integers(0, 9, n)
    ts = (rank * 10 + jitter).astype(np.int32)
    cols = {"S": n_series, "ts_max": int(ts.max()) if n else 0}
    if series_layout == "delta":
        d = E.delta_for_encode(codes, 8)
        cols["series"], cols["series_layout"] = (d.words, d.base), ("delta", d.width)
    else:
        cols["series"], cols["series_layout"] = (codes,), ("raw",)
    if ts_layout == "delta":
        d = E.delta_for_encode(ts, 16)
        cols["ts"], cols["ts_layout"] = (d.words, d.base), ("delta", d.width)
    elif ts_layout == "dict":
        d = E.dict_encode(ts, 4096)
        cols["ts"], cols["ts_layout"] = (d.words, d.dictionary), ("dict", d.width)
    else:
        cols["ts"], cols["ts_layout"] = (ts,), ("raw",)
    values, layouts = [], []
    for kind in kinds:
        v = _floats(rng, n, kind)
        if kind in ("dict", "codes"):
            d = E.dict_encode(v, 4096)
            values.append((d.words, d.dictionary))
            layouts.append(("dict", d.width, kind == "dict"))
            if kind == "codes":  # compared in code space
                v = np.searchsorted(d.dict_host, v).astype(np.float32)
        else:
            values.append((v,))
            layouts.append((kind,))
        # a literal the field holds, so that = selects rows
        cols.setdefault("lits", []).append(float(v[n // 2]) if n else 0.0)
    cols["values"], cols["value_layouts"] = values, tuple(layouts)
    return cols


def _raw_columns(key, w=None):
    """One series, ts = row number: a raw table of the key values."""
    n = len(key)
    w = np.arange(n, dtype=np.float32) if w is None else np.asarray(w, np.float32)
    return {"S": 1, "ts_max": n - 1, "series": (np.zeros(n, np.int32),),
            "series_layout": ("raw",), "ts": (np.arange(n, dtype=np.int32),),
            "ts_layout": ("raw",), "values": [(np.asarray(key, np.float32),), (w,)],
            "value_layouts": (("raw",), ("raw",))}


def _ref_parts(parts, bf16=False):
    if bf16:
        return jnp.asarray(parts[0]).astype(jnp.bfloat16)
    return tuple(jnp.asarray(p) for p in parts) if len(parts) > 1 else jnp.asarray(parts[0])


def _port_parts(parts, bf16=False):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32
                                                     else a))

    if bf16:
        return (t(parts[0]).to(torch.bfloat16),)
    return tuple(t(p) for p in parts)


def _run(cols, kind, allow, dyn, **kw):
    """(reference output, port output) as numpy, for ``kind``."""
    bf = [lay[0] == "bf16" for lay in cols["value_layouts"]]
    if all(lay == ("raw",) for lay in cols["value_layouts"]):
        r_vals = jnp.asarray(np.stack([p[0] for p in cols["values"]]))
    else:
        r_vals = tuple(
            (_ref_parts(p, b),) if len(p) == 1 else _ref_parts(p)
            for p, b in zip(cols["values"], bf)
        )
    layouts = dict(value_layouts=cols["value_layouts"], ts_layout=cols["ts_layout"],
                   series_layout=cols["series_layout"])
    r_fn = ref.raw_topk_packed if kind == "topk" else ref.raw_select_packed
    p_fn = port.raw_topk_packed if kind == "topk" else port.raw_select_packed
    want = r_fn(_ref_parts(cols["series"]), _ref_parts(cols["ts"]), r_vals,
                jnp.asarray(allow), jnp.asarray(dyn), **kw, **layouts)
    got = p_fn(_port_parts(cols["series"]), _port_parts(cols["ts"]),
               tuple(_port_parts(p, b) for p, b in zip(cols["values"], bf)),
               torch.from_numpy(allow), torch.from_numpy(dyn), **kw, **layouts)
    return np.asarray(want), got.numpy()


def _allow(rng, cols, frac=0.8):
    allow = np.append(rng.random(cols["S"]) < frac, False).astype(np.int32)
    allow[0] = 1
    return allow


def _topk(cols, allow, k, desc, key_is_ts=False, filters=(), lits=(), lo=0, hi=None):
    hi = cols["ts_max"] + 1 if hi is None else hi
    key_lo, key_hi = ref.topk_key_bounds(desc, key_is_ts, lo, hi)
    dyn = ref.pack_raw_dyn(list(lits), lo, hi, key_lo, key_hi)
    want, got = _run(cols, "topk", allow, dyn, k=k, descending=desc, key_is_ts=key_is_ts,
                     key_field=0, numeric_filters=filters)
    assert np.array_equal(want, got), (want, got)
    return got


def _select(cols, allow, slots, filters=(), lits=(), lo=0, hi=None):
    hi = cols["ts_max"] + 1 if hi is None else hi
    dyn = ref.pack_raw_dyn(list(lits), lo, hi)
    want, got = _run(cols, "select", allow, dyn, select_slots=slots, numeric_filters=filters)
    assert np.array_equal(want, got), (want, got)
    return got


def _count(cols, allow, filters=(), lits=(), lo=0, hi=None):
    hi = cols["ts_max"] + 1 if hi is None else hi
    dyn = torch.from_numpy(ref.pack_raw_dyn(list(lits), lo, hi))
    out = port.raw_select_plain(
        _port_parts(cols["series"]), _port_parts(cols["ts"]),
        tuple(_port_parts(p, lay[0] == "bf16")
              for p, lay in zip(cols["values"], cols["value_layouts"])),
        torch.from_numpy(allow), dyn, select_slots=0, numeric_filters=filters,
        value_layouts=cols["value_layouts"], ts_layout=cols["ts_layout"],
        series_layout=cols["series_layout"])
    return int(out[0])


# ---- every layout, key and k --------------------------------------------------


@pytest.mark.parametrize("k", ["1", "16", "128", "n"])
@pytest.mark.parametrize("key_is_ts,desc", KEYS, ids=["ts-desc", "ts-asc", "f32-desc", "f32-asc"])
@pytest.mark.parametrize("li", range(len(LAYOUTS)), ids=lambda i: "-".join(
    [LAYOUTS[i][0], LAYOUTS[i][1], *LAYOUTS[i][2]]))
def test_topk_bit_equal(li, key_is_ts, desc, k):
    rng = np.random.default_rng(100 + li)
    cols = _columns(rng, N, LAYOUTS[li])
    op = list(OPS)[(li + 2 * key_is_ts + desc) % len(OPS)]
    window = (li + desc) % 2 == 1
    lo, hi = (15, cols["ts_max"] - 25) if window else (0, None)
    kk = N if k == "n" else int(k)
    lits = [cols["lits"][1]]
    got = _topk(cols, _allow(rng, cols), kk, desc, key_is_ts, ((1, OPS[op]),), lits, lo, hi)
    assert (got >= 0).any()


@pytest.mark.parametrize("slots", ["exact", "above", "below", "zero"])
@pytest.mark.parametrize("li", range(len(LAYOUTS)), ids=lambda i: "-".join(
    [LAYOUTS[i][0], LAYOUTS[i][1], *LAYOUTS[i][2]]))
def test_select_bit_equal(li, slots):
    rng = np.random.default_rng(200 + li)
    cols = _columns(rng, N, LAYOUTS[li])
    allow = _allow(rng, cols)
    filters, lits = ((1, OPS[list(OPS)[li % 6]]),), [cols["lits"][1]]
    count = _count(cols, allow, filters, lits, 15, cols["ts_max"] - 25)
    assert count > 0
    n_slots = {"exact": count, "above": count + 5, "below": count - 1, "zero": 0}[slots]
    got = _select(cols, allow, n_slots, filters, lits, 15, cols["ts_max"] - 25)
    assert got[0] == count and len(got) == 1 + n_slots


@pytest.mark.parametrize("op", list(OPS))
def test_every_filter_op(op):
    rng = np.random.default_rng(7)
    cols = _columns(rng, N, LAYOUTS[0])
    allow = _allow(rng, cols)
    filters = ((1, OPS[op]),)
    for desc in (True, False):
        _topk(cols, allow, 64, desc, False, filters, [0.0])
    _select(cols, allow, _count(cols, allow, filters, [0.0]), filters, [0.0])


# ---- the selection over row windows ---------------------------------------------


def _decoded(cols):
    """(series codes, timestamps) of ``cols`` as numpy, decoded by the port."""
    sp, tp = _port_parts(cols["series"]), _port_parts(cols["ts"])
    n = E.layout_rows(sp, cols["series_layout"])
    sc = E.decode_series(sp, cols["series_layout"], n)
    return sc.numpy().astype(np.int64), E.decode_ts(tp, cols["ts_layout"], n).numpy()


def _runs(flags):
    f = np.concatenate([[False], flags, [False]])
    return np.flatnonzero(f[1:] != f[:-1]).reshape(-1, 2).astype(np.int64)


def _windows(rng, cols, allow, lo, hi, kind):
    """Windows that hold every row of an allowed series inside [lo, hi):
    ``series`` those rows' runs (the executor's windows); ``real`` every
    real row; ``singles`` one row a window; ``short`` the series runs cut
    into pieces of 1-40 rows; ``none`` no windows (the wrapper's default)."""
    codes, ts = _decoded(cols)
    keep = (allow[codes] != 0) & (ts >= lo) & (ts < hi)
    if kind == "none":
        return None
    if kind == "real":
        n_real = int((codes < cols["S"]).sum())
        return np.array([[0, n_real]] if n_real else [], np.int64).reshape(-1, 2)
    if kind == "singles":
        hit = np.flatnonzero(keep)
        return np.stack([hit, hit + 1], axis=1)
    runs = _runs(keep)
    if kind == "series":
        return runs
    pieces = [np.empty((0, 2), np.int64)]
    for a, b in runs:
        edges = np.unique(np.concatenate([[a, b], a + np.cumsum(rng.integers(1, 41, b - a))]))
        edges = edges[edges <= b]
        pieces.append(np.stack([edges[:-1], edges[1:]], axis=1))
    return np.concatenate(pieces)


@pytest.mark.parametrize("kind", ["none", "series", "real", "singles", "short"])
@pytest.mark.parametrize("li", range(len(LAYOUTS)), ids=lambda i: "-".join(
    [LAYOUTS[i][0], LAYOUTS[i][1], *LAYOUTS[i][2]]))
def test_select_over_windows_bit_equal(li, kind):
    """The selection with the executor's kinds of row windows (or none)
    equals the reference's selection over every row: windows are a hint
    the answer never depends on, in every layout, with an empty allow list
    and an empty window list too."""
    rng = np.random.default_rng(300 + li)
    cols = _columns(rng, N, LAYOUTS[li])
    filters, lits = ((1, OPS[list(OPS)[li % 6]]),), [cols["lits"][1]]
    lo, hi = 15, cols["ts_max"] - 25
    for allow in (_allow(rng, cols, 0.5), np.zeros(cols["S"] + 1, np.int32)):
        count = _count(cols, allow, filters, lits, lo, hi)
        windows = _windows(rng, cols, allow, lo, hi, kind)
        dyn = ref.pack_raw_dyn(lits, lo, hi)
        want, _ = _run(cols, "select", allow, dyn, select_slots=count,
                       numeric_filters=filters)
        got = port.raw_select_packed(
            _port_parts(cols["series"]), _port_parts(cols["ts"]),
            tuple(_port_parts(p, lay[0] == "bf16")
                  for p, lay in zip(cols["values"], cols["value_layouts"])),
            torch.from_numpy(allow), torch.from_numpy(dyn), select_slots=count,
            numeric_filters=filters, windows=windows, value_layouts=cols["value_layouts"],
            ts_layout=cols["ts_layout"], series_layout=cols["series_layout"])
        assert np.array_equal(want, got.numpy()), (kind, want[:8], got[:8])


def _port_args(cols, allow, dyn):
    return (_port_parts(cols["series"]), _port_parts(cols["ts"]),
            tuple(_port_parts(p, lay[0] == "bf16")
                  for p, lay in zip(cols["values"], cols["value_layouts"])),
            torch.from_numpy(allow), torch.from_numpy(dyn))


def _topk_on_window_rows(cols, allow, dyn, windows, **kw):
    """The plain top-k over only the rows of ``windows``: those rows'
    decoded columns gathered into raw ones, the answer's slots mapped back
    to resident row ids (a slot past the tie stream holds the full row
    count, as it would over every row)."""
    args = _port_args(cols, allow, dyn)
    n = E.layout_rows(args[0], cols["series_layout"])
    sc, tr, vals = E.decode_layouts(args[0], args[1], args[2], cols["series_layout"],
                                    cols["ts_layout"], cols["value_layouts"])
    rows = np.concatenate([np.arange(a, b) for a, b in windows] + [np.empty(0, np.int64)])
    pick = torch.from_numpy(rows.astype(np.int64))
    raw = {**kw, "value_layouts": tuple(("raw",) for _ in vals), "ts_layout": ("raw",),
           "series_layout": ("raw",)}
    got = port.raw_topk_plain((sc[pick].to(torch.int32),), (tr[pick].to(torch.int32),),
                              tuple((v.float()[pick],) for v in vals), args[3], args[4],
                              **raw).numpy()
    idx = got[0] if got.ndim == 2 else got
    mapped = np.where(idx < 0, -1, np.where(idx >= len(rows), n, rows[np.clip(idx, 0, max(
        len(rows) - 1, 0))] if len(rows) else n))
    return np.stack([mapped, got[1]]) if got.ndim == 2 else mapped


@pytest.mark.parametrize("k", [16, 128, 1024, 1 << 18])
@pytest.mark.parametrize("key_is_ts,desc", KEYS, ids=["ts-desc", "ts-asc", "f32-desc", "f32-asc"])
def test_topk_over_windows_equals_the_unwindowed_answer(key_is_ts, desc, k):
    """A top-k given row windows that hold every row its mask can pass
    (the executor's series windows, windows of one row, short windows that
    start inside a 128-row delta block and end inside a tile) answers as
    the unwindowed plain version, slots and keys: its answer over only the
    windows' rows is the answer over every row. ts and f32 keys both ways,
    ties across the limit, +-0 and NaN, at k from 16 to 2**18."""
    rng = np.random.default_rng(k + 2 * key_is_ts + desc)
    # whole delta blocks, not whole tiles; more rows than k
    n = max(k, 1 << 15) + 4096 + 3 * 128
    # a dictionary of timestamps holds at most 4096: not LAYOUTS[2] here
    cols = _columns(rng, n, LAYOUTS[(1, 3, 4, 0)[k.bit_length() % 4]], n_series=80)
    allow = _allow(rng, cols, 0.7)
    filters, lits = ((1, OPS[">="]),), [-40.0]
    lo, hi = 35, cols["ts_max"] - 95
    key_lo, key_hi = port.topk_key_bounds(desc, key_is_ts, lo, hi)
    dyn = port.pack_raw_dyn(lits, lo, hi, key_lo, key_hi)
    kw = dict(k=k, descending=desc, key_is_ts=key_is_ts, key_field=0, numeric_filters=filters,
              value_layouts=cols["value_layouts"], ts_layout=cols["ts_layout"],
              series_layout=cols["series_layout"], with_keys=True)
    want = port.raw_topk_packed(*_port_args(cols, allow, dyn), **kw).numpy()
    assert (want[0] >= 0).sum() == min(k, int((want[0] >= 0).sum()))
    for kind in ("series", "singles", "short"):
        windows = _windows(rng, cols, allow, lo, hi, kind)
        got = port.raw_topk_packed(*_port_args(cols, allow, dyn), windows=windows, **kw).numpy()
        assert np.array_equal(got, want), kind
        assert np.array_equal(_topk_on_window_rows(cols, allow, dyn, windows, **kw), want), kind


def test_plain_select_with_and_without_windows_is_the_reference_body():
    """``raw_select_plain`` takes the windows and ignores them: with them,
    without them and with a window list that misses passing rows, it is
    the reference's ``raw_select_body`` over every row."""
    rng = np.random.default_rng(11)
    cols = _columns(rng, N, LAYOUTS[0])
    codes, ts = cols["series"][0], cols["ts"][0]
    values = np.stack([p[0] for p in cols["values"]])
    allow = _allow(rng, cols, 0.6)
    filters, lits, lo, hi = ((0, OPS[">"]),), [0.0], 40, cols["ts_max"] - 60
    count = _count(cols, allow, filters, lits, lo, hi)
    idx, n = ref.raw_select_body(
        jnp.asarray(codes), jnp.asarray(ts), jnp.asarray(values), jnp.asarray(allow != 0),
        jnp.asarray(np.float32(lits)), np.int32(lo), np.int32(hi), select_slots=count + 3,
        numeric_filters=filters)
    want = np.concatenate([[int(n)], np.asarray(idx)])
    args = ((torch.from_numpy(codes),), (torch.from_numpy(ts),),
            tuple((torch.from_numpy(v),) for v in values), torch.from_numpy(allow),
            torch.from_numpy(ref.pack_raw_dyn(lits, lo, hi)))
    for windows in (None, _windows(rng, cols, allow, lo, hi, "series"),
                    np.array([[0, 1]], np.int64)):
        got = port.raw_select_plain(*args, select_slots=count + 3, numeric_filters=filters,
                                    windows=windows)
        assert np.array_equal(got.numpy(), want)


def test_select_tiles_walk_the_windows_only():
    """The launch geometry: ceil(rows / TILE) tiles a window, each at most
    TILE rows inside its window, in row order, together exactly the
    windows' rows; windows that overlap, run backwards or leave the rows
    are refused."""
    rng = np.random.default_rng(5)
    n = 1 << 20
    for _ in range(20):
        edges = np.unique(rng.integers(0, n + 1, 2 * int(rng.integers(1, 40))))
        windows = edges[: len(edges) // 2 * 2].reshape(-1, 2)
        tiles = port.select_tiles(windows, n)
        rows = windows[:, 1] - windows[:, 0]
        assert len(tiles) == int(((rows + port.TILE - 1) // port.TILE).sum())
        assert tiles.dtype == np.int32 and ((tiles[:, 1] - tiles[:, 0]) >= 1).all()
        assert ((tiles[:, 1] - tiles[:, 0]) <= port.TILE).all()
        assert (tiles[1:, 0] >= tiles[:-1, 1]).all()
        covered = np.zeros(n + 1, np.int64)
        np.add.at(covered, tiles[:, 0], 1)
        np.add.at(covered, tiles[:, 1], -1)
        want = np.zeros(n + 1, np.int64)
        np.add.at(want, windows[:, 0], 1)
        np.add.at(want, windows[:, 1], -1)
        assert np.array_equal(np.cumsum(covered), np.cumsum(want))
    assert port.select_tiles(None, 10_000).tolist() == [[0, 4096], [4096, 8192], [8192, 10_000]]
    assert port.select_tiles(np.empty((0, 2), np.int64), 10).shape == (0, 2)
    for bad in ([[5, 9], [8, 12]], [[9, 5]], [[0, 11]], [[-1, 3]], [[6, 8], [0, 2]]):
        with pytest.raises(ValueError):
            port.select_tiles(bad, 10)


# ---- the traps ------------------------------------------------------------------

_PM0 = [-0.0, -0.0, -0.0, -0.0, -5.0, 0.0, -1.0, -2.0, -3.0, -4.0, -6.0, -7.0]


@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("k", [1, 2, 5, 12])
def test_signed_zeros_at_the_threshold(k, desc):
    """-0.0 ranks below +0.0 in the device key: with k = 2 the +0.0 row is
    a strict row and takes slot 0."""
    got = _topk(_raw_columns(_PM0), np.array([1, 0], np.int32), k, desc)
    if k == 2 and desc:
        assert list(got) == [5, 0]


@pytest.mark.parametrize("k", [1, 16, 21, 40, 48])
def test_signed_zeros_of_both_signs(k):
    cols = _raw_columns([-0.0] * 20 + [0.0] * 20 + [-1.0 - i for i in range(8)])
    for desc in (True, False):
        _topk(cols, np.array([1, 0], np.int32), k, desc)


def _nan_table():
    v = np.arange(60, dtype=np.float32)
    v[::4] = np.nan
    v[5], v[6] = np.inf, -np.inf
    return _raw_columns(v)


@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("k", [8, 16, 60])
def test_nan_last_and_infinities(k, desc):
    got = _topk(_nan_table(), np.array([1, 0], np.int32), k, desc)
    v = _nan_table()["values"][0][0]
    real = [i for i in got if i >= 0 and not np.isnan(v[i])]
    assert len(real) == min(k, 45)  # 15 NaN rows come only after every real one
    assert (np.inf if desc else -np.inf) in v[got[got >= 0]]


@pytest.mark.parametrize("desc", [True, False])
def test_fewer_passing_rows_than_k_with_nan(desc):
    got = _topk(_nan_table(), np.array([1, 0], np.int32), 32, desc, lo=40, hi=60)
    assert (got >= 0).sum() == 20 and (got[20:] == -1).all()


@pytest.mark.parametrize("desc", [True, False])
def test_fewer_passing_rows_than_k_without_nan(desc):
    got = _topk(_nan_table(), np.array([1, 0], np.int32), 16, desc, filters=((0, OPS[">="]),),
                lits=[52.0])
    assert (got >= 0).sum() == 7  # 53-59 but 56 (NaN), and +inf


@pytest.mark.parametrize("k", [1, 128, 4096])
def test_more_ties_at_the_kth_key_than_slots(k):
    rng = np.random.default_rng(11)
    v = np.where(rng.random(5000) < 0.7, 100.0,
                 np.minimum(np.round(rng.normal(50, 20, 5000)), 99.0))
    cols = _raw_columns(v.astype(np.float32))
    for desc in (True, False):
        got = _topk(cols, np.array([1, 0], np.int32), k, desc)
        if desc and k < (v == 100.0).sum():  # every slot a tie at 100.0, lowest rows first
            assert list(got) == list(np.flatnonzero(v == 100.0)[:k])


def test_empty_allow_list():
    cols = _columns(np.random.default_rng(3), N, LAYOUTS[1])
    allow = np.zeros(cols["S"] + 1, np.int32)
    assert (_topk(cols, allow, 16, True) == -1).all()
    got = _select(cols, allow, 8)
    assert got[0] == 0 and (got[1:] == -1).all()


@pytest.mark.parametrize("key_is_ts", [True, False])
def test_empty_time_range(key_is_ts):
    cols = _columns(np.random.default_rng(4), N, LAYOUTS[2])
    allow = _allow(np.random.default_rng(4), cols)
    assert (_topk(cols, allow, 16, True, key_is_ts, lo=50, hi=50) == -1).all()
    assert _select(cols, allow, 4, lo=50, hi=50)[0] == 0


@pytest.mark.parametrize("li", [0, 1, 3])
def test_k_equals_rows(li):
    rng = np.random.default_rng(5)
    cols = _columns(rng, N, LAYOUTS[li])
    allow = np.append(np.ones(cols["S"], np.int32), 1)  # every row, pads too
    for key_is_ts, desc in KEYS:
        got = _topk(cols, allow, N, desc, key_is_ts)
        assert sorted(got) == list(range(N))


def test_one_row():
    cols = _raw_columns([3.5])
    for desc in (True, False):
        assert list(_topk(cols, np.array([1, 0], np.int32), 1, desc)) == [0]
        assert list(_topk(cols, np.array([0, 0], np.int32), 1, desc)) == [-1]
    assert list(_select(cols, np.array([1, 0], np.int32), 1)) == [1, 0]


def test_no_rows():
    """The reference's programs do not trace at n = 0; the port answers
    it: no slot holds a row and nothing passes."""
    z = torch.zeros(0, dtype=torch.int32)
    vals = ((torch.zeros(0),),)
    dyn = torch.from_numpy(port.pack_raw_dyn([], 0, 10, -1, 10))
    allow = torch.tensor([1, 0], dtype=torch.int32)
    got = port.raw_topk_packed((z,), (z,), vals, allow, dyn, k=1, descending=True,
                               key_is_ts=True, key_field=0, numeric_filters=())
    assert got.tolist() == [-1]
    got = port.raw_select_packed((z,), (z,), vals, allow, dyn, select_slots=3,
                                 numeric_filters=())
    assert got.tolist() == [0, -1, -1, -1]


@pytest.mark.parametrize("desc", [True, False])
def test_dictionary_coded_key(desc):
    rng = np.random.default_rng(6)
    cols = _columns(rng, N, ("raw", "raw", ("codes", "raw")))
    assert cols["value_layouts"][0][0] == "dict"
    _topk(cols, _allow(rng, cols), 100, desc)


@pytest.mark.parametrize("desc", [True, False])
def test_delta_coded_timestamps(desc):
    rng = np.random.default_rng(8)
    cols = _columns(rng, N, ("raw", "delta", ("raw", "raw")))
    assert cols["ts_layout"][0] == "delta"
    _topk(cols, _allow(rng, cols), 50, desc, True, lo=100, hi=20_000)
    _select(cols, _allow(rng, cols), N, lo=100, hi=20_000)


def test_more_than_2_24_rows():
    """Row ids past 2**24 stay exact (int32 slots, no float round trip)."""
    n = (1 << 24) + 4096
    rng = np.random.default_rng(9)
    v = rng.normal(0, 1, n).astype(np.float32)
    v[-3:] = [50.0, 49.0, 48.0]  # the largest keys sit in the last rows
    cols = _raw_columns(v, np.zeros(n, np.float32))
    allow = np.array([1, 0], np.int32)
    got = _topk(cols, allow, 16, True)
    assert {n - 3, n - 2, n - 1} <= set(got.tolist())
    got = _topk(cols, allow, 16, True, key_is_ts=True)
    assert sorted(got) == list(range(n - 16, n))
    got = _select(cols, allow, 10, filters=((0, OPS[">"]),), lits=[20.0])
    assert got[0] == 3 and list(got[1:4]) == [n - 3, n - 2, n - 1]


def test_wrappers_refuse_a_device_without_a_kernel():
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.raw_select_packed((z,), (z,), (), z, z, select_slots=1, numeric_filters=())


# ---- the build -------------------------------------------------------------------


def test_build_target_follows_included_headers(tmp_path, monkeypatch):
    """A library is named by its source and every header it includes, so an
    edited header rebuilds it; a header it does not include does not."""
    from horaedb_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#define B 1\n")
    (tmp_path / "c.cuh").write_text("#define C 1\n")
    assert [p.rsplit("/", 1)[1] for p in _build._sources(str(tmp_path / "k.cu"))] == [
        "k.cu", "a.cuh", "b.cuh"]
    first = _build._target("k")[1]
    (tmp_path / "c.cuh").write_text("#define C 2\n")
    assert _build._target("k")[1] == first
    (tmp_path / "b.cuh").write_text("#define B 2\n")
    assert _build._target("k")[1] != first


def test_kernels_share_the_layout_decoders():
    from horaedb_tpu_torch.ops import _build

    for name in ("scan_agg", "scan_topk"):
        src = f"{_build.CSRC_DIR}/{name}.cu"
        assert f"{_build.CSRC_DIR}/layouts.cuh" in _build._sources(src)


# ---- the padded k at SQL level ----------------------------------------------------


def test_padded_k_decides_which_signed_zeros_are_candidates(monkeypatch):
    """k is part of the answer: with the reference's padded k (16, clamped
    to 12 rows) every zero is a candidate and the host's final sort keeps
    them in row order; an exact k = 2 would put the +0.0 row first."""
    monkeypatch.setenv("HORAEDB_ADAPTIVE_PATH", "0")
    rows = ", ".join(f"('h', {v!r}, {float(i)}, {1_700_000_000_000 + i * 1000})"
                     for i, v in enumerate(_PM0))
    sql = "SELECT v, w FROM rd ORDER BY v DESC LIMIT 2"
    answers = []
    for pkg, kw in ((horaedb_tpu, {}), (horaedb_tpu_torch, {"device": "cpu"})):
        db = pkg.connect(None, **kw)
        try:
            db.execute("CREATE TABLE rd (host string TAG, v double, w double, "
                       "ts timestamp NOT NULL, TIMESTAMP KEY(ts))")
            db.execute(f"INSERT INTO rd (host, v, w, ts) VALUES {rows}")
            for _ in range(3):
                out = db.execute(sql)
            assert out.metrics.get("path") == "raw_device"
            answers.append([(r["v"], math.copysign(1.0, r["v"]), r["w"])
                            for r in out.to_pylist()])
        finally:
            db.close()
    assert answers[0] == answers[1] == [(-0.0, -1.0, 0.0), (-0.0, -1.0, 1.0)]
