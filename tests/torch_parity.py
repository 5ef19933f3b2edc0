"""Shared tolerances and comparisons for the PyTorch port's parity tests.

The port (``horaedb_tpu_torch``) is held to the JAX package
(``horaedb_tpu``) on the same inputs, made with numpy from a seed:

- counts, mins, maxs and group keys must be BIT-equal (NaN matches NaN
  whatever its payload; -0.0 and +0.0 differ);
- a sum (or an avg) may differ only by summation order: within
  ``SUM_RTOL`` of the segment's sum of |x| computed in float64.
"""

from __future__ import annotations

import numpy as np

SUM_RTOL = 1e-5


def canonical_bits(a) -> np.ndarray:
    """float32 bits with every NaN collapsed to one pattern."""
    a = np.array(a, dtype=np.float32, copy=True)
    a[np.isnan(a)] = np.float32("nan")
    return a.view(np.int32)


def assert_bit_equal(got, want, what: str = "") -> None:
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind == "f" or want.dtype.kind == "f":
        ok = np.array_equal(canonical_bits(got), canonical_bits(want))
    else:
        ok = np.array_equal(got, want)
    if not ok:
        bad = np.argwhere(
            canonical_bits(got) != canonical_bits(want)
            if got.dtype.kind == "f"
            else got != want
        )[:5]
        raise AssertionError(f"{what}: not bit-equal at {bad.tolist()}")


def assert_sums_close(got, want, abs_sums, what: str = "") -> None:
    """|got - want| <= SUM_RTOL * sum|x| per segment (both NaN passes)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    abs_sums = np.asarray(abs_sums, dtype=np.float64)
    assert got.shape == want.shape == abs_sums.shape, (what, got.shape, want.shape)
    both_nan = np.isnan(got) & np.isnan(want)
    with np.errstate(invalid="ignore"):
        ok = both_nan | (np.abs(got - want) <= SUM_RTOL * abs_sums)
    if not ok.all():
        bad = np.argwhere(~ok)[:5]
        raise AssertionError(
            f"{what}: sums differ at {bad.tolist()}: "
            f"{got[~ok][:5]} vs {want[~ok][:5]} (scale {abs_sums[~ok][:5]})"
        )


def segment_abs_sums(seg: np.ndarray, mask: np.ndarray, vals: np.ndarray, n_seg: int) -> np.ndarray:
    """(F, n_seg) float64 sums of |x| over the rows ``mask`` keeps."""
    out = np.zeros((vals.shape[0], n_seg))
    s = seg[mask]
    for f in range(vals.shape[0]):
        np.add.at(out[f], s, np.abs(vals[f][mask].astype(np.float64)))
    return out


def assert_state_equal(got, want, abs_sums, need_minmax: bool, what: str = "") -> None:
    """(counts, sums, mins, maxs) of the port against the reference."""
    gc, gs, gmn, gmx = (np.asarray(x) for x in got)
    wc, ws, wmn, wmx = (np.asarray(x) for x in want)
    assert_bit_equal(gc, wc, f"{what} counts")
    assert_sums_close(gs, ws, np.broadcast_to(abs_sums, ws.shape), f"{what} sums")
    if need_minmax:
        assert_bit_equal(gmn, wmn, f"{what} mins")
        assert_bit_equal(gmx, wmx, f"{what} maxs")


def rows_match(ref: list[dict], got: list[dict], scale) -> None:
    """SQL result rows: exact on every non-float column and on min/max/
    count columns; float columns named in ``scale(row, column)`` (sums
    and avgs) within SUM_RTOL of the returned scale."""
    assert len(ref) == len(got), (len(ref), len(got))
    for r, g in zip(ref, got):
        assert set(r) == set(g), (r, g)
        for k, v in r.items():
            s = scale(r, k)
            if s is None:
                if isinstance(v, float):
                    assert_bit_equal(np.float32(g[k]), np.float32(v), k)
                else:
                    assert g[k] == v, (k, g[k], v)
            else:
                assert abs(g[k] - v) <= SUM_RTOL * s, (k, g[k], v, s)
