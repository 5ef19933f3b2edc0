"""Window function evaluation (host path).

The reference inherits window functions from DataFusion
(`query_engine/src/datafusion_impl/mod.rs:54` — the whole engine is a
DataFusion impl, so `OVER (PARTITION BY .. ORDER BY ..)` works there).
This is the vectorized-numpy equivalent, shaped for the TSDB access
pattern: partition by tags, order by time, shift/rank/accumulate within
each series.

Semantics match the SQL standard (and DataFusion's defaults):

- no explicit frames; with an ORDER BY, aggregate windows use the default
  running frame RANGE UNBOUNDED PRECEDING .. CURRENT ROW — peers (rows
  tied on all order keys) share the frame end; without ORDER BY the frame
  is the whole partition;
- `last_value` with an ORDER BY therefore returns the current peer
  group's last row (the standard surprise), the partition's last row
  without one;
- NULL ordering: NULLS LAST for ASC, NULLS FIRST for DESC (postgres
  defaults);
- ranking is computed over the sort the OVER clause declares, never the
  output order.

Everything is O(n log n) vectorized: one lexsort, then cumsum/bincount
arithmetic; running min/max uses a Hillis-Steele segmented scan (log n
doubling passes) instead of a per-partition Python loop.
"""

from __future__ import annotations

import numpy as np

from ..common_types.dict_column import as_values
from . import ast


class WindowError(ValueError):
    pass


def _factorize(values: np.ndarray, valid: np.ndarray) -> tuple[np.ndarray, int]:
    """Dense int64 codes in VALUE-SORTED order; NULLs share one code just
    past the valid range (callers re-map per null-placement rule)."""
    v = as_values(values)
    if valid.all():
        u, inv = np.unique(v, return_inverse=True)
        return inv.astype(np.int64), len(u)
    u, inv = np.unique(v[valid], return_inverse=True)
    codes = np.full(len(v), len(u), dtype=np.int64)
    codes[valid] = inv
    return codes, len(u)


def _segmented_scan(values: np.ndarray, offset: np.ndarray, op) -> np.ndarray:
    """Inclusive prefix-``op`` within segments (Hillis-Steele doubling).

    ``offset[i]`` is i's distance from its segment start; ``op`` must be
    an associative ufunc (np.minimum / np.maximum).
    """
    out = values.copy()
    n = len(out)
    shift = 1
    while shift < n:
        take = offset >= shift
        if not take.any():
            break
        prev = np.empty_like(out)
        prev[shift:] = out[:-shift]
        out[take] = op(out[take], prev[take])
        shift *= 2
    return out


def eval_window(
    wf: ast.WindowFunc, rows, eval_expr
) -> tuple[np.ndarray, np.ndarray]:
    """-> (values, valid mask) aligned with ``rows``.

    ``eval_expr`` is executor.eval_expr, passed in to avoid a circular
    import (window args/keys are ordinary expressions).
    """
    n = len(rows)
    if n == 0:
        return np.empty(0), np.empty(0, dtype=bool)

    # ---- partition codes -------------------------------------------------
    part = np.zeros(n, dtype=np.int64)
    for e in wf.spec.partition_by:
        v, m = eval_expr(e, rows)
        codes, k = _factorize(v, m)
        part = part * (k + 1) + codes

    # ---- order keys (factorized: NaN-safe ties, NULL placement) ---------
    sort_keys: list[np.ndarray] = []  # in lexsort order (primary LAST)
    tie_keys: list[np.ndarray] = []
    for o in wf.spec.order_by:
        v, m = eval_expr(o.expr, rows)
        codes, k = _factorize(v, m)
        if o.ascending:
            key = codes  # NULL code k -> last
        else:
            key = -codes  # NULL -> -k -> first
        sort_keys.append(key)
        tie_keys.append(codes)
    perm = np.lexsort(tuple(reversed(sort_keys)) + (part,))

    part_s = part[perm]
    new_seg = np.empty(n, dtype=bool)
    new_seg[0] = True
    new_seg[1:] = part_s[1:] != part_s[:-1]
    idx = np.arange(n, dtype=np.int64)
    start = np.maximum.accumulate(np.where(new_seg, idx, 0))
    seg_id = np.cumsum(new_seg) - 1
    seg_counts = np.bincount(seg_id)
    end = np.cumsum(seg_counts)[seg_id]  # exclusive per-row segment end

    new_peer = new_seg.copy()
    for tk in tie_keys:
        tks = tk[perm]
        new_peer[1:] |= tks[1:] != tks[:-1]
    has_order = bool(wf.spec.order_by)

    def arg_sorted(i: int):
        v, m = eval_expr(wf.args[i], rows)
        return as_values(v)[perm], m[perm]

    name = wf.name
    out_v: np.ndarray
    out_m = np.ones(n, dtype=bool)

    if name == "row_number":
        out_v = idx - start + 1
    elif name == "rank":
        peer_start = np.maximum.accumulate(np.where(new_peer, idx, 0))
        out_v = peer_start - start + 1
    elif name == "dense_rank":
        c = np.cumsum(new_peer)
        out_v = c - c[start] + 1
    elif name in ("lag", "lead"):
        v_s, m_s = arg_sorted(0)
        off = wf.args[1].value if len(wf.args) >= 2 else 1
        default = wf.args[2].value if len(wf.args) >= 3 else None
        if name == "lag":
            src = idx - off
            ok = src >= start
        else:
            src = idx + off
            ok = src < end
        src_c = np.clip(src, 0, n - 1)
        out_v = np.where(ok, v_s[src_c], v_s[0])
        out_m = np.where(ok, m_s[src_c], False)
        if default is not None:
            fill = ~ok
            out_v = _fill_default(out_v, fill, default)
            out_m = out_m | fill
    elif name == "first_value":
        v_s, m_s = arg_sorted(0)
        out_v = v_s[start]
        out_m = m_s[start]
    elif name == "last_value":
        v_s, m_s = arg_sorted(0)
        last = _peer_end(new_peer, n) - 1 if has_order else end - 1
        out_v = v_s[last]
        out_m = m_s[last]
    else:  # count / sum / avg / min / max
        if name == "count" and (
            not wf.args or isinstance(wf.args[0], ast.Star)
        ):
            v_s = np.ones(n)
            m_s = np.ones(n, dtype=bool)
        else:
            v_s, m_s = arg_sorted(0)
        if name == "count":
            # count needs only validity — never touch the values (they
            # may be strings)
            v_f = np.zeros(n)
        else:
            if np.asarray(v_s).dtype.kind not in "fiub":
                raise WindowError(
                    f"{name}() window over a non-numeric column is not "
                    "supported"
                )
            v_f = np.where(m_s, v_s.astype(np.float64, copy=False), 0.0)
        cnt_inc = m_s.astype(np.int64)
        csum = np.cumsum(v_f)
        ccnt = np.cumsum(cnt_inc)
        base_sum = csum[start] - v_f[start]
        base_cnt = ccnt[start] - cnt_inc[start]
        if has_order:
            at = _peer_end(new_peer, n) - 1
            run_sum = csum[at] - base_sum
            run_cnt = ccnt[at] - base_cnt
        else:
            at = end - 1
            run_sum = (csum[at] - base_sum)
            run_cnt = (ccnt[at] - base_cnt)
        if name == "count":
            out_v = run_cnt
        elif name == "sum":
            out_v = run_sum
            out_m = run_cnt > 0
        elif name == "avg":
            with np.errstate(divide="ignore", invalid="ignore"):
                out_v = run_sum / run_cnt
            out_m = run_cnt > 0
        else:  # min / max
            op = np.minimum if name == "min" else np.maximum
            fill = np.inf if name == "min" else -np.inf
            masked = np.where(m_s, v_s.astype(np.float64, copy=False), fill)
            scanned = _segmented_scan(masked, idx - start, op)
            at_mm = _peer_end(new_peer, n) - 1 if has_order else end - 1
            out_v = scanned[at_mm]
            out_m = run_cnt > 0
    res_v = np.empty_like(out_v)
    res_v[perm] = out_v
    res_m = np.empty(n, dtype=bool)
    res_m[perm] = out_m
    return res_v, res_m


def _peer_end(new_peer: np.ndarray, n: int) -> np.ndarray:
    """Exclusive end index of each row's peer group (sorted domain)."""
    peer_id = np.cumsum(new_peer) - 1
    counts = np.bincount(peer_id)
    return np.cumsum(counts)[peer_id]


def _fill_default(out_v: np.ndarray, fill: np.ndarray, default) -> np.ndarray:
    """Write ``default`` into ``fill`` slots, widening dtype if needed."""
    if not fill.any():
        return out_v
    try:
        out_v = out_v.copy()
        out_v[fill] = default
        return out_v
    except (ValueError, TypeError):
        widened = out_v.astype(object)
        widened[fill] = default
        return widened
