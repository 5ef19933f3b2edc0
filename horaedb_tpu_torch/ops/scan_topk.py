"""Fused filter + top-k / bounded-selection kernels for raw reads.

Non-aggregate reads, above all the dashboard staple ``SELECT ... ORDER BY
ts DESC LIMIT n``, run over the scan cache's resident columns (series
codes, relative timestamps, value columns, in any resident layout). Both
kernels evaluate the per-query predicate as a device mask (series
allow-list + time range + numeric field comparisons, the mask
``ops.scan_agg`` builds) and return only ROW INDICES; the host gathers
those rows from the entry's host copy and finishes exactly.

- **top-k** (``ORDER BY <ts|field> [DESC] LIMIT n``): the k rows with the
  largest int32 sort key, ties broken toward the smaller resident row id.
  Slot order: the rows strictly above the threshold in row order, then the
  ties in row order, then -1.
- **bounded selection**: every passing row id, in row order, into a
  buffer the executor sizes from an exact host-side candidate bound, plus
  the passing count.

Float sort keys travel through the order-preserving f32 -> int32 bit
transform, so one integer threshold serves both ``ORDER BY ts`` and
``ORDER BY field``, and the masked-row sentinel (INT32_MIN) lies outside
the real key domain (even ``-inf`` maps above it).

Both are written by hand in CUDA (``csrc/scan_topk.cu``) and visit only
the executor's row windows, the rows its mask can pass. The top-k keys
the window rows, drops the rows that cannot be among the top k, finds the
k-th key by a radix select over four 8-bit digits of the rows left, and
writes the slots by an ordered compaction; the selection compacts in one
launch. The plain PyTorch versions
below transcribe the reference's programs (its 32-step bisection and its
cumsum + searchsorted compaction): they are the spec, and they run for
CPU tensors. For a CUDA tensor the wrappers launch the kernels or raise.

Packed entry points keep the reference's serving discipline: one
content-cached session upload (the allow-list), one per-query int32 dyn
upload (filter literals bitcast + time bounds + key seeds), one int32
fetch. ``raw_topk_cohort`` serves B top-k queries of one shape (stacked
session and dyn rows, each member's row windows) in one launch sequence per
32 members, over the tiles of the union of their windows; like the
reference, no executor route calls it yet.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..utils.env import env_int
from .encoding import decode_layouts, layout_rows, next_pow2
from .scan_agg import (
    _COUNTS_LOCK,
    MAX_FIELDS,
    MAX_FILTERS,
    _Column,
    _Filters,
    _apply_filters,
    _check,
    _check_tensor,
    _count,
    _dense_layout,
    _filters,
    _int_column,
    _value_column,
)

_I32_MIN = -(2**31)

# Kernel launches, counted where each wrapper launches its kernel (a
# cohort and a top-k count one launch per launch sequence); PLAIN_CALLS
# counts the plain versions the wrappers ran for CPU tensors; TILES the
# tiles the selection's launches walked (its launch geometry); KERNELS the
# kernels a top-k's launch sequences ran. Counts move under scan_agg's
# lock (``_count``): wrappers run on several threads at once.
LAUNCHES = {"raw_topk": 0, "raw_select": 0, "raw_topk_cohort": 0}
PLAIN_CALLS = {"raw_topk": 0, "raw_select": 0, "raw_topk_cohort": 0}
TILES = {"raw_select": 0}
KERNELS = {"raw_topk": 0, "raw_topk_cohort": 0}
# what a top-k's keys kernel counts on the card as it runs, added to the
# wrapper's ``stats``: the rows it decoded and the tiles it walked
TOPK_STATS = ("rows", "tiles")


def reset_counts() -> None:
    with _COUNTS_LOCK:
        for d in (LAUNCHES, PLAIN_CALLS, TILES, KERNELS):
            for k in d:
                d[k] = 0


def raw_device_enabled() -> bool:
    """HORAEDB_RAW_DEVICE kill switch: 0/off/false pins every raw
    (non-aggregate) read to the host path. Read per query so operators
    can flip it live."""
    return os.environ.get("HORAEDB_RAW_DEVICE", "1") not in (
        "0", "off", "false",
    )


def raw_max_rows() -> int:
    """HORAEDB_RAW_MAX_ROWS: ceiling on rows a device raw read may
    select/gather (bounds both the selection buffer and top-k's
    limit+offset). Queries whose candidate bound exceeds it fall back
    to the host path. Guarded parse — a typo degrades to the default."""
    return env_int("HORAEDB_RAW_MAX_ROWS", 1 << 18)


@dataclass(frozen=True)
class RawScanSpec:
    """Static shape/op configuration of one raw-read launch.

    Exactly one of ``k`` (top-k slots) / ``select_slots`` (selection
    buffer) is nonzero.
    """

    k: int = 0
    descending: bool = True
    key_is_ts: bool = True
    key_field: int = 0  # value field of the key when key_is_ts is False
    numeric_filters: tuple[tuple[int, str], ...] = ()
    select_slots: int = 0
    # Compressed-layout descriptors (ops.encoding), as in ScanAggSpec.
    # Raw reads keep dictionary fields in the code domain, the sort key
    # too (the dictionary is sorted); the executor pre-translates filter
    # literals against the sorted dictionary.
    value_layouts: tuple = ()
    ts_layout: tuple = ("raw",)
    series_layout: tuple = ("raw",)


def padded_k(n_rows: int, limit_plus_offset: int) -> int:
    """Top-k slot count: limit + offset rounded up to a power of two (at
    least 16), clamped to the resident row count.

    The kernel needs no padding, but k is part of the answer: when zeros
    of both signs compete for the last slots, the k-th key decides which
    of them are candidates (``f32_sort_key`` ranks -0.0 below +0.0, the
    host's final sort does not), so a smaller k can change which rows a
    query returns. The reference pads k exactly so; keep it, so the port
    answers as the reference does."""
    return min(next_pow2(max(limit_plus_offset, 1), floor=16), max(n_rows, 1))


def f32_sort_key(v: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> int32: signed integer order equals float order
    (-inf < ... < -0 < +0 < ... < +inf < NaN). Real keys never reach
    INT32_MIN, so it is a safe masked-row sentinel."""
    u = v.to(torch.float32).contiguous().view(torch.int32)
    u2 = torch.where(u < 0, ~u, u | _I32_MIN)
    return u2 ^ _I32_MIN


def topk_key_bounds(
    descending: bool, key_is_ts: bool, lo_rel: int, hi_rel: int
) -> tuple[int, int]:
    """Host-side bisection seeds bracketing every real sort key: the
    query's own relative time range for ts keys (DESC: key == ts_rel in
    [lo_rel, hi_rel); ASC: key == -ts_rel). Float keys span the full
    int32 domain INCLUDING the NaN slot at INT32_MIN + 1 (_sort_key
    pins NaN samples there), so their lower seed is the sentinel
    itself — the strict/tie masks AND the row mask, so sentinel rows
    still can't be selected."""
    if not key_is_ts:
        return _I32_MIN, 2**31 - 1
    if descending:
        return lo_rel - 1, hi_rel
    return -hi_rel, -lo_rel + 1


def pack_raw_dyn(
    filter_literals: Sequence[float],
    lo_rel: int,
    hi_rel: int,
    key_lo: int = _I32_MIN,
    key_hi: int = 2**31 - 1,
) -> np.ndarray:
    """[literals (f32 bitcast) | lo, hi, key_lo, key_hi] — one int32
    upload (the selection kernel ignores the trailing key seeds)."""
    lits = np.asarray(filter_literals, dtype=np.float32).view(np.int32)
    return np.concatenate(
        [lits, np.array([lo_rel, hi_rel, key_lo, key_hi], dtype=np.int32)]
    )


# ---- plain PyTorch versions ------------------------------------------------


def _raw_mask(series_codes, ts_rel, values, allowed_series, literals, lo_rel, hi_rel,
              numeric_filters):
    """The shared predicate mask: allow-list + time range + numeric
    filters (the op codes of scan_agg)."""
    m = allowed_series[series_codes.long()]
    m = m & (ts_rel >= lo_rel) & (ts_rel < hi_rel)
    vals = {fi: values[fi].to(torch.float32) for fi, _ in numeric_filters}
    return _apply_filters(m, vals, literals, numeric_filters)


def _sort_key(ts_rel, values, m, *, descending: bool, key_is_ts: bool, key_field: int):
    """Masked int32 sort key, largest-first == result order."""
    sentinel = torch.full_like(m, _I32_MIN, dtype=torch.int32)
    if key_is_ts:
        key = ts_rel.to(torch.int32)
        if not descending:
            # real keys never equal INT32_MIN (ts_rel > INT32_MIN), so the
            # negation cannot overflow
            key = -key
        return torch.where(m, key, sentinel)
    v = values[key_field].to(torch.float32)
    key = f32_sort_key(v)
    if not descending:
        key = -key
    # NaN samples (valid, non-NULL) rank below every real value in both
    # directions, as np.lexsort places NaN last: pinned just above the
    # sentinel AFTER the direction flip
    key = torch.where(torch.isnan(v), torch.full_like(key, _I32_MIN + 1), key)
    return torch.where(m, key, sentinel)


def _kth_threshold(key, k: int, key_lo: int, key_hi: int) -> int:
    """The reference's bisection for the k-th largest key: the returned
    ``thr`` satisfies count(key > thr) < k <= count(key >= thr) whenever at
    least k real (non-sentinel) keys exist; seeds bracket the real keys
    (key_lo strictly below every one, key_hi at least the largest).
    Overflow-safe signed midpoint via (a & b) + ((a ^ b) >> 1)."""
    lo, hi = int(key_lo), int(key_hi)
    while hi > lo + 1:
        mid = (lo & hi) + ((lo ^ hi) >> 1)
        cnt = int((key > mid).sum())
        if cnt >= k:
            lo = mid
        else:
            # hi stays strictly above lo (count(> t) only shrinks as t
            # grows, so the invariant count(> hi) < k survives the clamp)
            hi = max(mid, lo + 1)
    return hi


def _compact(mask, slots: int):
    """Row indices of the first ``slots`` True entries, ascending —
    cumsum + searchsorted. Slots past the count return index n; callers
    mask them."""
    cs = torch.cumsum(mask.to(torch.int64), 0)
    j = torch.arange(slots, dtype=torch.int64, device=mask.device)
    idx = torch.searchsorted(cs, j + 1, side="left").to(torch.int32)
    return idx, int(cs[-1]) if mask.shape[0] else 0


def raw_topk_body(series_codes, ts_rel, values, allowed_series, literals, lo_rel, hi_rel,
                  key_lo, key_hi, *, k: int, descending: bool, key_is_ts: bool,
                  key_field: int, numeric_filters, with_keys: bool = False):
    """-> row idx int32[k]: the top-k rows by key, ties broken toward the
    smaller resident row id; strict rows first in row order, then ties;
    -1 in slots with no passing row. ``with_keys``: int32[2, k], the slots
    and then their keys (INT32_MIN where a slot holds no row), as the
    reference's body returns them."""
    m = _raw_mask(series_codes, ts_rel, values, allowed_series, literals, lo_rel, hi_rel,
                  numeric_filters)
    key = _sort_key(ts_rel, values, m, descending=descending, key_is_ts=key_is_ts,
                    key_field=key_field)
    thr = _kth_threshold(key, k, key_lo, key_hi)
    strict = key > thr  # sentinel rows can never exceed thr (> I32_MIN)
    tie = m & (key == thr)
    i_strict, n_strict = _compact(strict, k)
    i_tie, _ = _compact(tie, k)
    total = int(m.sum())
    j = torch.arange(k, dtype=torch.int64, device=m.device)
    # strict rows fill the first n_strict slots; lowest-row-id ties the rest
    idx = torch.where(j < n_strict, i_strict, i_tie[(j - n_strict).clamp(0, k - 1)])
    valid = j < min(k, total)
    idx = torch.where(valid, idx, torch.full_like(idx, -1))
    if not with_keys:
        return idx
    n = key.shape[0]
    held = (idx >= 0) & (idx < n)  # a slot past the tie stream holds n_rows: no key
    keys = key[idx.long().clamp(0, n - 1)] if n else torch.zeros_like(idx)
    keys = torch.where(held, keys.to(torch.int32), torch.full_like(idx, _I32_MIN))
    return torch.stack([idx, keys])


def raw_select_body(series_codes, ts_rel, values, allowed_series, literals, lo_rel, hi_rel,
                    *, select_slots: int, numeric_filters):
    """-> (row idx int32[slots] in resident order, passing count). The
    caller sizes ``select_slots`` from an exact bound, so the first
    ``count`` slots are exactly the passing rows in (series, ts) resident
    order; the rest are -1."""
    m = _raw_mask(series_codes, ts_rel, values, allowed_series, literals, lo_rel, hi_rel,
                  numeric_filters)
    idx, count = _compact(m, select_slots)
    j = torch.arange(select_slots, dtype=torch.int64, device=m.device)
    return torch.where(j < count, idx, torch.full_like(idx, -1)), count


def _unpack_dyn(dyn, numeric_filters):
    n_f = len(numeric_filters)
    literals = dyn[:n_f].contiguous().view(torch.float32)
    lo, hi, key_lo, key_hi = (int(x) for x in dyn[n_f:n_f + 4].tolist())
    return literals, lo, hi, key_lo, key_hi


def raw_topk_plain(series_parts, ts_parts, values, session, dyn, *, k: int,
                   descending: bool, key_is_ts: bool, key_field: int, numeric_filters,
                   value_layouts: tuple = (), ts_layout: tuple = ("raw",),
                   series_layout: tuple = ("raw",), with_keys: bool = False, windows=None):
    """Plain version of ``raw_topk_packed``: the same inputs, int32[k]
    (int32[2, k] ``with_keys``). It takes ``windows`` and ignores them, as
    ``raw_select_plain`` does."""
    del windows
    literals, lo, hi, key_lo, key_hi = _unpack_dyn(dyn, numeric_filters)
    sc, tr, vals = decode_layouts(series_parts, ts_parts, values, series_layout, ts_layout,
                                  value_layouts)
    return raw_topk_body(sc, tr, vals, session != 0, literals, lo, hi, key_lo, key_hi,
                         k=k, descending=descending, key_is_ts=key_is_ts,
                         key_field=key_field, numeric_filters=numeric_filters,
                         with_keys=with_keys)


def raw_select_plain(series_parts, ts_parts, values, session, dyn, *, select_slots: int,
                     numeric_filters, value_layouts: tuple = (), ts_layout: tuple = ("raw",),
                     series_layout: tuple = ("raw",), windows=None):
    """Plain version of ``raw_select_packed``: int32[1 + slots], [passing
    count | row indices]. It takes ``windows`` and ignores them: the
    reference's function over every row, so a kernel held to it is also
    held to windows that cover every passing row."""
    del windows
    literals, lo, hi, _, _ = _unpack_dyn(dyn, numeric_filters)
    sc, tr, vals = decode_layouts(series_parts, ts_parts, values, series_layout, ts_layout,
                                  value_layouts)
    out, count = raw_select_body(sc, tr, vals, session != 0, literals, lo, hi,
                                 select_slots=select_slots, numeric_filters=numeric_filters)
    head = torch.tensor([count], dtype=torch.int32, device=out.device)
    return torch.cat([head, out])


def raw_topk_cohort_plain(series_parts, ts_parts, values, sessions, dyns, windows=None, **kw):
    """Plain version of ``raw_topk_cohort``: ``raw_topk_plain`` per member
    (row b of ``sessions`` and ``dyns``); int32[B, k]. It takes ``windows``
    and ignores them, as ``raw_topk_plain`` does."""
    del windows
    rows = [raw_topk_plain(series_parts, ts_parts, values, sessions[b], dyns[b], **kw)
            for b in range(sessions.shape[0])]
    if rows:
        return torch.stack(rows)
    return torch.empty((0, kw["k"]), dtype=torch.int32, device=sessions.device)


# ---- the kernels and their wrappers -----------------------------------------


class _RawArgs(ctypes.Structure):
    """Mirror of ``RawArgs`` in ops/csrc/scan_topk.cu."""

    _fields_ = [
        ("series", _Column),
        ("ts", _Column),
        ("fields", _Column * MAX_FIELDS),
        ("session", ctypes.c_void_p),
        ("dyn", ctypes.c_void_p),
        ("keys", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("key_out", ctypes.c_void_p),
        ("tiles", ctypes.c_void_p),
        ("n_tiles", ctypes.c_longlong),
        ("n_rows", ctypes.c_longlong),
        ("k", ctypes.c_longlong),
        ("descending", ctypes.c_int),
        ("key_is_ts", ctypes.c_int),
        ("key_field", ctypes.c_int),
        ("device", ctypes.c_int),
        ("filt", _Filters),
    ]


class _CohortRawArgs(ctypes.Structure):
    """Mirror of ``CohortRawArgs`` in ops/csrc/scan_topk.cu."""

    _fields_ = [
        ("r", _RawArgs),
        ("sessions", ctypes.c_void_p),
        ("dyns", ctypes.c_void_p),
        ("n_items", ctypes.c_longlong),
        ("members", ctypes.c_int),
        ("sess_w", ctypes.c_int),
        ("dyn_w", ctypes.c_int),
        ("pad_", ctypes.c_int),
    ]


# rows per tile of the kernels' tile tables, and the members of one cohort
# launch sequence (checked at load)
TILE = 4096
MAX_COHORT = 32
# the top-k's state and histogram words, before its per-tile words (a
# cohort member's too); the keys kernel's counts (TOPK_STATS, 64-bit) at
# state word 16
_TOPK_HEAD = 32 + 4 * 256
_TOPK_STATS_AT = 16
# the words of a cohort launch's head, before its members' states
_COHORT_HEAD = 16

_lib = None


def _kernels():
    """The built kernel library (nvcc at first use), with its C signatures
    declared and its struct layout checked against the mirror."""
    global _lib
    if _lib is None:
        from ._build import load

        lib = load("scan_topk")
        lib.scan_topk_abi.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.scan_topk_abi.restype = ctypes.c_int
        lib.raw_topk_launch.argtypes = [ctypes.POINTER(_RawArgs), ctypes.c_void_p,
                                        ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
                                        ctypes.c_void_p]
        lib.raw_topk_launch.restype = ctypes.c_int
        lib.raw_select_launch.argtypes = [ctypes.POINTER(_RawArgs), ctypes.c_void_p,
                                          ctypes.c_longlong, ctypes.c_void_p]
        lib.raw_select_launch.restype = ctypes.c_int
        lib.raw_select_tiles.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                                         ctypes.c_void_p]
        lib.raw_select_tiles.restype = ctypes.c_longlong
        lib.raw_cohort_tiles.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [
                                             ctypes.POINTER(ctypes.c_longlong)]
        lib.raw_cohort_tiles.restype = ctypes.c_longlong
        lib.raw_topk_cohort_launch.argtypes = [ctypes.POINTER(_CohortRawArgs), ctypes.c_void_p,
                                               ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                               ctypes.c_void_p]
        lib.raw_topk_cohort_launch.restype = ctypes.c_int
        lib.scan_topk_error_string.argtypes = [ctypes.c_int]
        lib.scan_topk_error_string.restype = ctypes.c_char_p
        sizes = (ctypes.c_longlong * 8)()
        lib.scan_topk_abi(sizes)
        want = [ctypes.sizeof(_RawArgs), MAX_FIELDS, MAX_FILTERS, TILE, _COHORT_HEAD,
                ctypes.sizeof(_CohortRawArgs), MAX_COHORT, _TOPK_HEAD]
        if list(sizes) != want:
            raise RuntimeError(f"scan_topk ABI mismatch: kernel {list(sizes)} vs {want}")
        _lib = lib
    return _lib


def select_tiles(windows, n_rows: int) -> np.ndarray:
    """The selection kernel's tile table: int32[n_tiles, 2], the rows
    [row0, row1) of each tile, in row order, each tile at most TILE rows
    inside one window; ``sum(ceil(len / TILE))`` tiles over the windows.

    ``windows``: [start, end) row ranges, sorted, not overlapping, inside
    [0, n_rows) (empty ones add no tile); None for one window over every
    row."""
    if windows is None:
        windows = ((0, n_rows),)
    w = np.asarray(windows, dtype=np.int64).reshape(-1, 2)
    _check(bool((w[:, 0] >= 0).all() and (w[:, 1] <= n_rows).all()
                and (w[:, 1] >= w[:, 0]).all() and (w[1:, 0] >= w[:-1, 1]).all()),
           f"windows must be sorted, disjoint [start, end) ranges inside [0, {n_rows})")
    w = w[w[:, 1] > w[:, 0]]
    per = (w[:, 1] - w[:, 0] + TILE - 1) // TILE
    first = np.repeat(np.cumsum(per) - per, per)
    row0 = np.repeat(w[:, 0], per) + TILE * (np.arange(int(per.sum())) - first)
    row1 = np.minimum(row0 + TILE, np.repeat(w[:, 1], per))
    return np.stack([row0, row1], axis=1).astype(np.int32)


def _member_windows(windows, members: int, n_rows: int, check: bool) -> list:
    """Each member's windows as int64[W, 2], with ``check`` checked as
    ``select_tiles`` checks them (a launch's table builder checks them in
    C); None: one window over every row for each member."""
    if windows is None:
        return [np.array([[0, n_rows]], dtype=np.int64)] * members
    _check(len(windows) == members, f"{len(windows)} window lists for {members} members")
    if check:
        for w in windows:
            select_tiles(w, n_rows)
    return [np.asarray(w, dtype=np.int64).reshape(-1, 2) for w in windows]


def cohort_tiles(windows, n_rows: int):
    """The cohort top-k's tile table (the launcher builds it in C,
    ``raw_cohort_tiles``) for the members' windows (``_member_windows``):

    - tiles int32[n_tiles, 4]: (row0, row1, mask, item_off). The union of
      every member's windows, merged where they overlap or touch, cut into
      tiles of at most TILE rows inside one union window, in row order;
      ``mask`` has bit m where a window of member m meets the tile.
    - tile_p int32[items]: from ``item_off`` on, one per member of the
      tile's mask in bit order, its item's index.
    - member_off int32[B + 1] and member_tiles int32[items]: items are
      numbered member by member, each member's tiles in row order."""
    members = len(windows)
    _check(1 <= members <= MAX_COHORT, f"{members} members: 1 to {MAX_COHORT} a table")
    spans = np.concatenate([np.asarray(w, dtype=np.int64).reshape(-1, 2) for w in windows])
    spans = spans[spans[:, 1] > spans[:, 0]]
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    union = []
    for start, end in spans.tolist():
        if union and start <= union[-1][1]:
            union[-1][1] = max(union[-1][1], end)
        else:
            union.append([start, end])
    rows = select_tiles(np.array(union, dtype=np.int64).reshape(-1, 2), n_rows).astype(np.int64)
    nt = len(rows)
    member = np.zeros((nt, members), dtype=bool)
    for m, w in enumerate(windows):
        select_tiles(w, n_rows)  # checked as the builder checks them
        w = np.asarray(w, dtype=np.int64).reshape(-1, 2)
        w = w[w[:, 1] > w[:, 0]]
        lo = np.searchsorted(rows[:, 1], w[:, 0], side="right")
        hi = np.searchsorted(rows[:, 0], w[:, 1], side="left")
        edge = np.zeros(nt + 1, dtype=np.int64)
        np.add.at(edge, lo, 1)
        np.add.at(edge, hi, -1)
        member[:, m] = np.cumsum(edge)[:nt] > 0
    mask = (member.astype(np.int64) << np.arange(members)).sum(axis=1)
    count = member.sum(axis=1)
    tile_of, member_of = np.nonzero(member)  # tile by tile, bits in order
    order = np.lexsort((tile_of, member_of))  # member by member, in row order
    tile_p = np.empty(len(order), dtype=np.int64)
    tile_p[order] = np.arange(len(order))
    tiles = np.stack([rows[:, 0], rows[:, 1], mask, np.cumsum(count) - count], axis=1)
    member_off = np.concatenate([[0], np.cumsum(member.sum(axis=0))])
    return (tiles.astype(np.int64).astype(np.uint32).view(np.int32).reshape(nt, 4),
            tile_p.astype(np.int32), member_off.astype(np.int32),
            tile_of[order].astype(np.int32))


def cohort_scratch_words(members: int, n_tiles: int, items: int) -> tuple[int, int]:
    """(where the table starts, all words) of a cohort launch sequence's
    int32 scratch: the head and each member's state and histograms (zeroed
    by a memset), the items' offsets, counts, maxima and ballot words, then
    the table, 16-byte aligned (csrc/scan_topk.cu ``CohortScratch``)."""
    at = (_COHORT_HEAD + members * _TOPK_HEAD + (5 + TILE // 32) * items + 3) // 4 * 4
    return at, at + 4 * n_tiles + 2 * items + members + 1


def _args(series_parts, ts_parts, values, session, dyn, numeric_filters, value_layouts,
          ts_layout, series_layout, ndim: int = 1) -> tuple[_RawArgs, int]:
    """Check the inputs of a CUDA launch; returns the launch arguments
    (pointers of the columns, session and dyn) and the row count. A
    cohort's ``session`` and ``dyn`` are its stacked rows (``ndim`` 2). A
    message is formatted only for a refused input: this runs on every
    launch, and its host time is in the launch's latency."""
    dev = session.device
    if dev.type != "cuda":
        _check(False, f"unsupported device {dev}")
    _check_tensor(session, "session", torch.int32, dev, ndim)
    _check_tensor(dyn, "dyn", torch.int32, dev, ndim)
    _check(len(values) == len(value_layouts), "one layout per value field")
    _check(len(values) <= MAX_FIELDS, f"at most {MAX_FIELDS} value fields")
    _check(dyn.shape[-1] >= len(numeric_filters) + 4, "dyn holds literals and four scalars")
    n_rows = layout_rows(series_parts, series_layout)
    _check(n_rows < 2**31, "row ids must fit int32")
    a = _RawArgs()
    a.series = _int_column(series_parts, series_layout, dev, "series")
    a.ts = _int_column(ts_parts, ts_layout, dev, "ts")
    _check(ts_layout[0] != "delta" or layout_rows(ts_parts, ts_layout) == n_rows, "ts rows")
    if ts_layout[0] == "raw" and ts_parts[0].shape[0] != n_rows:
        _check(False, f"ts has {ts_parts[0].shape[0]} rows")
    for f, (parts, lay) in enumerate(zip(values, value_layouts)):
        a.fields[f] = _value_column(parts, lay, dev, f"value[{f}]")
        if lay[0] in ("raw", "bf16") and parts[0].shape[0] != n_rows:
            _check(False, f"value[{f}] has {parts[0].shape[0]} rows")
    a.session = session.data_ptr()
    a.dyn = dyn.data_ptr()
    a.n_rows = n_rows
    a.device = dev.index if dev.index is not None else torch.cuda.current_device()
    a.filt = _filters(numeric_filters, len(values))
    return a, n_rows


def _run(lib, fn: str, a: _RawArgs, dev, *extra) -> None:
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, fn)(ctypes.byref(a), *extra, stream)
    if err != 0:
        raise RuntimeError(
            f"{fn} failed: {lib.scan_topk_error_string(err).decode()} ({err})"
        )


def _windows(lib, windows, n_rows: int):
    """The windows as int64[W, 2] and their tile count, checked in C."""
    w = np.ascontiguousarray(((0, n_rows),) if windows is None else windows,
                             dtype=np.int64).reshape(-1, 2)
    n_tiles = lib.raw_select_tiles(w.ctypes.data, len(w), n_rows, None)
    _check(n_tiles >= 0, f"windows must be sorted, disjoint [start, end) ranges inside "
                         f"[0, {n_rows})")
    return w, n_tiles


def raw_topk_packed(series_parts, ts_parts, values, session, dyn, *, k: int,
                    descending: bool, key_is_ts: bool, key_field: int, numeric_filters,
                    value_layouts: tuple = (), ts_layout: tuple = ("raw",),
                    series_layout: tuple = ("raw",), with_keys: bool = False, windows=None,
                    stats=None):
    """-> int32[k] resident row indices, -1 in slots with no passing row;
    ``with_keys``: int32[2, k], the slots and then the int32 keys the
    kernel ranked them by (INT32_MIN in a slot with no row), one buffer.

    Resident series/ts/value part tuples, one session buffer (the allow
    list, int32[S + 1]), one dyn buffer [literals bitcast | lo, hi,
    key_lo, key_hi]. ``windows``: sorted, disjoint [start, end) row ranges
    that hold every row the mask can pass (the executor's), None for one
    window over every resident row; the kernel visits only their rows.
    A CUDA input launches the top-k (csrc/scan_topk.cu ``raw_topk_launch``:
    a memset, the tile table's copy, ``topk_keys``, three ``topk_refine``
    and ``topk_write``); a CPU input runs ``raw_topk_plain``, which scans
    every row and ignores the windows. ``stats`` (int64[2], CUDA): the
    launch adds to it the ``TOPK_STATS`` its keys kernel counted."""
    values = tuple(values)
    layouts = value_layouts or tuple(_dense_layout(p) for p in values)
    kw = dict(k=k, descending=descending, key_is_ts=key_is_ts, key_field=key_field,
              numeric_filters=numeric_filters, value_layouts=layouts, ts_layout=ts_layout,
              series_layout=series_layout, with_keys=with_keys)
    _check(k >= 1, f"k {k} must be at least 1")
    _check(key_is_ts or 0 <= key_field < len(values), f"key field {key_field} out of range")
    dev = session.device
    if dev.type == "cpu":
        # the windows are checked as for a launch, then ignored
        select_tiles(windows, layout_rows(series_parts, series_layout))
        _count(PLAIN_CALLS, "raw_topk")
        return raw_topk_plain(series_parts, ts_parts, values, session, dyn, **kw)
    a, n_rows = _args(series_parts, ts_parts, values, session, dyn, numeric_filters, layouts,
                      ts_layout, series_layout)
    _check(k < 2**31, "k must fit int32")
    lib = _kernels()
    w, n_tiles = _windows(lib, windows, n_rows)
    # [state and histograms | tile counts 2 x tiles | block counts 2 x tiles
    # (one block's at least) | tile maxima | table 2 x tiles]
    scratch = torch.empty(_TOPK_HEAD + 7 * n_tiles + 2, dtype=torch.int32, device=dev)
    keys = torch.empty(max(n_tiles, 1) * TILE, dtype=torch.int32, device=dev)
    out = torch.empty((2, k) if with_keys else k, dtype=torch.int32, device=dev)
    a.scratch, a.keys, a.out = scratch.data_ptr(), keys.data_ptr(), out.data_ptr()
    a.tiles, a.n_tiles = a.scratch + 4 * (_TOPK_HEAD + 5 * n_tiles), n_tiles
    if with_keys:
        a.key_out = out[1].data_ptr()
    a.k = k
    a.descending, a.key_is_ts, a.key_field = int(descending), int(key_is_ts), key_field
    if stats is not None:
        _check(stats.dtype == torch.int64 and stats.device == dev
               and tuple(stats.shape) == (len(TOPK_STATS),),
               f"stats is int64[{len(TOPK_STATS)}] on {dev}")
    kernels = ctypes.c_int(0)
    _run(lib, "raw_topk_launch", a, dev, w.ctypes.data, len(w), ctypes.byref(kernels))
    with _COUNTS_LOCK:
        LAUNCHES["raw_topk"] += 1
        KERNELS["raw_topk"] += kernels.value
    if stats is not None:
        at = _TOPK_STATS_AT
        stats += scratch[at:at + 2 * len(TOPK_STATS)].view(torch.int64)
    return out


def raw_topk_cohort(series_parts, ts_parts, values, sessions, dyns, *, k: int,
                    descending: bool, key_is_ts: bool, key_field: int, numeric_filters,
                    value_layouts: tuple = (), ts_layout: tuple = ("raw",),
                    series_layout: tuple = ("raw",), windows=None):
    """-> int32[B, k]: row b the slots ``raw_topk_packed`` gives for session
    row b (int32[B, S + 1]), dyn row b (int32[B, n_f + 4]) and window list
    b over the same resident columns; -1 in slots with no passing row.

    ``windows``: None (every resident row, for every member) or B lists of
    sorted, disjoint [start, end) row ranges, each holding every row its
    member's mask can pass (the executor's ``_raw_candidate_estimate``,
    ``exact=False``, per member); checked on every device. A CUDA input
    launches the cohort top-k (csrc/scan_topk.cu ``raw_topk_cohort_launch``)
    once per MAX_COHORT members: a memset, the tile table's copy,
    ``cohort_topk_keys``, three ``cohort_topk_refine`` (none when no member
    has k window rows) and ``cohort_topk_write``, over the tiles of the
    union of the members' windows; its scratch is sized by those tiles. A
    CPU input runs ``raw_topk_cohort_plain``, which ignores the windows."""
    values = tuple(values)
    layouts = value_layouts or tuple(_dense_layout(p) for p in values)
    kw = dict(k=k, descending=descending, key_is_ts=key_is_ts, key_field=key_field,
              numeric_filters=numeric_filters, value_layouts=layouts, ts_layout=ts_layout,
              series_layout=series_layout)
    _check(k >= 1, f"k {k} must be at least 1")
    _check(key_is_ts or 0 <= key_field < len(values), f"key field {key_field} out of range")
    B = sessions.shape[0]
    dev = sessions.device
    wins = _member_windows(windows, B, layout_rows(series_parts, series_layout),
                           check=dev.type == "cpu")
    if dev.type == "cpu":
        _count(PLAIN_CALLS, "raw_topk_cohort")
        return raw_topk_cohort_plain(series_parts, ts_parts, values, sessions, dyns, **kw)
    a, n_rows = _args(series_parts, ts_parts, values, sessions, dyns, numeric_filters, layouts,
                      ts_layout, series_layout, ndim=2)
    _check(dyns.shape[0] == B, "one dyn row per session row")
    _check(k < 2**31, "k must fit int32")
    out = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = _kernels()
    a.k = k
    a.descending, a.key_is_ts, a.key_field = int(descending), int(key_is_ts), key_field
    c = _CohortRawArgs()
    c.sess_w, c.dyn_w = sessions.shape[1], dyns.shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for b0 in range(0, B, MAX_COHORT):
        M = min(MAX_COHORT, B - b0)
        part = wins[b0:b0 + M]
        flat = np.ascontiguousarray(np.concatenate(part), dtype=np.int64)
        win_off = np.cumsum([0] + [len(w) for w in part], dtype=np.int64)
        items = ctypes.c_longlong(0)
        n_tiles = lib.raw_cohort_tiles(flat.ctypes.data, win_off.ctypes.data, M, n_rows, None,
                                       None, None, None, ctypes.byref(items))
        _check(n_tiles >= 0, "windows must be sorted, disjoint [start, end) ranges inside "
                             f"[0, {n_rows})" if n_tiles == -1 else "no host memory for the table")
        at, words = cohort_scratch_words(M, n_tiles, items.value)
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        keys = torch.empty(max(n_tiles, 1) * TILE, dtype=torch.int32, device=dev)
        a.scratch, a.keys, a.out = scratch.data_ptr(), keys.data_ptr(), out[b0].data_ptr()
        a.tiles, a.n_tiles = a.scratch + 4 * at, n_tiles
        c.r = a
        c.sessions, c.dyns = sessions[b0].data_ptr(), dyns[b0].data_ptr()
        c.n_items, c.members = items.value, M
        kernels = ctypes.c_int(0)
        err = lib.raw_topk_cohort_launch(ctypes.byref(c), flat.ctypes.data, win_off.ctypes.data,
                                         ctypes.byref(kernels), stream)
        if err != 0:
            raise RuntimeError(
                f"raw_topk_cohort_launch failed: {lib.scan_topk_error_string(err).decode()} "
                f"({err})"
            )
        with _COUNTS_LOCK:
            LAUNCHES["raw_topk_cohort"] += 1
            KERNELS["raw_topk_cohort"] += kernels.value
    return out


def raw_select_packed(series_parts, ts_parts, values, session, dyn, *, select_slots: int,
                      numeric_filters, value_layouts: tuple = (), ts_layout: tuple = ("raw",),
                      series_layout: tuple = ("raw",), windows=None):
    """-> int32[1 + slots]: [passing count | row indices in row order, -1
    past the count]; never writes past ``select_slots``.

    ``windows``: sorted, disjoint [start, end) row ranges that hold every
    row the mask can pass (the executor's allowed series inside the time
    range); the kernel visits only their rows and still applies the whole
    mask there. None: one window over every resident row. A CUDA input
    launches ``raw_select`` (csrc/scan_topk.cu) over ``select_tiles`` of
    the windows, one copy of the table to the card; an empty table still
    launches and writes count 0. A CPU input runs ``raw_select_plain``."""
    values = tuple(values)
    layouts = value_layouts or tuple(_dense_layout(p) for p in values)
    _check(select_slots >= 0, f"select_slots {select_slots} is negative")
    dev = session.device
    if dev.type == "cpu":
        # the windows are checked as for a launch, then ignored
        select_tiles(windows, layout_rows(series_parts, series_layout))
        _count(PLAIN_CALLS, "raw_select")
        return raw_select_plain(series_parts, ts_parts, values, session, dyn,
                                select_slots=select_slots, numeric_filters=numeric_filters,
                                value_layouts=layouts, ts_layout=ts_layout,
                                series_layout=series_layout, windows=windows)
    a, n_rows = _args(series_parts, ts_parts, values, session, dyn, numeric_filters, layouts,
                      ts_layout, series_layout)
    lib = _kernels()
    # the launcher builds the table (select_tiles, in C) and copies it to
    # the card; here only its size, for the one buffer the launch uses:
    # [look-back status 2 x tiles | ticket | count | slots | table 2 x tiles]
    w, n_tiles = _windows(lib, windows, n_rows)
    head = 2 * n_tiles + 1
    buf = torch.empty(head + 1 + select_slots + 2 * n_tiles, dtype=torch.int32, device=dev)
    a.scratch, a.k, a.n_tiles = buf.data_ptr(), select_slots, n_tiles
    a.out = a.scratch + 4 * head
    a.tiles = a.out + 4 * (1 + select_slots)
    _run(lib, "raw_select_launch", a, dev, w.ctypes.data, len(w))
    out = buf[head:head + 1 + select_slots]
    with _COUNTS_LOCK:
        LAUNCHES["raw_select"] += 1
        TILES["raw_select"] += n_tiles
    return out
