"""The fused scan/filter/time-bucket/group-by/aggregate kernel.

The aggregate serving path: a plan whose leaves are scans with filter +
group-by-time + aggregate on top runs as ONE kernel launch over dense
column buffers — mask computation, bucketing and the segment reduction
fused, written by hand for Hopper in ``ops/csrc/scan_agg.cu``.

Layout contract (prepared by ops.encoding on host):

- ``group_codes`` int32[N]: dense group index per row;
- ``bucket_ids``  int32[N]: time bucket per row;
- ``mask``        bool[N]:  validity & tag-filter & pad mask;
- ``values``      f32[F, N]: field columns (agg fields first, then any
                  fields referenced only by numeric filters);
- numeric filters evaluate on the device: op codes are launch arguments,
  literals a small f32 tensor.

Each kernel wrapper checks its inputs and, for a CUDA tensor, launches the
kernel; for a CPU tensor it runs the plain PyTorch version beside it in
this module (``scan_agg_body``, ``_packed_body``, ``_cohort_body``; the
``hash`` arm's is ``hash_agg.hash_segment_agg_plain``). Nothing else
chooses between them.

``mesh_combine`` (packed buffers) and ``mesh_combine_state`` (the four
arrays) combine the S partials of a sharded aggregate (parallel/dist_agg)
in one launch of the ``mesh_combine`` kernel; ``combine_planes_plain`` is
their plain version.

``cached_scan_agg_cohort`` serves a cohort of B shape-identical queries
(one session and dyn row each) in one launch that decodes each tile of
resident rows once for all members; ``selective_cached_scan_agg`` is the
unpacked form of the selective cached kernel, kept for the reference's
signature.

Aggregation state is the classic monoid (count, sum, min, max): partials
from different batches and the host-side delta fold combine associatively.
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .encoding import PaddedBatch, decode_layouts as _decode_layouts, layout_rows, next_pow2
from .hash_agg import default_hash_slots, hash_segment_agg_plain, probe_rounds

AGG_OPS = ("count", "sum", "min", "max", "avg")

# Numeric filter ops, by integer code (a launch argument of the kernel).
_FILTER_OPS = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}

# The kernel's reduction arms besides "single" (n_seg == 1):
#   shared  — block-private count/sum/min/max per segment in shared memory,
#             merged with global atomics; the arm for small segment counts
#             (the counterpart of the reference's one-hot "mxu" arm);
#   scatter — global atomics per segment; any segment count;
#   hash    — a block-private slot table in shared memory keyed by segment
#             id, merged with global atomics; rows that find no slot go
#             to global atomics (the reference's "hash" arm, B2d; for a
#             domain whose live segments are few, see ops/hash_agg.py).
SEGMENT_KERNELS = ("shared", "scatter", "hash")
ARMS = ("single",) + SEGMENT_KERNELS
_ARM_CODE = {"single": 0, "shared": 1, "scatter": 2, "hash": 3}
# The opt-in dynamic shared memory one block may use on Hopper.
SHARED_MEM_BYTES = 232_448
# threads of a kernel block (BLOCK in ops/csrc/scan_agg.cu)
BLOCK = 256
MAX_FIELDS = 32
MAX_FILTERS = 16

# Launches per entry point and arm, counted where each wrapper launches
# its kernel; PLAIN_CALLS counts the plain versions the wrappers ran for
# CPU tensors. Plain integers: a run reads them to show which path served.
# Wrappers run on several threads at once (the proxy's pool), so each
# count moves under _COUNTS_LOCK.
_FORMS = ("direct", "cached", "cached_selective", "cached_cohort")
LAUNCHES = {form: {arm: 0 for arm in ARMS} for form in _FORMS}
PLAIN_CALLS = {form: 0 for form in _FORMS}
# mesh_combine launches and plain calls by form: "packed" buffers or the
# four "state" arrays
COMBINE_LAUNCHES = {"packed": 0, "state": 0}
COMBINE_PLAIN_CALLS = {"packed": 0, "state": 0}
_COUNTS_LOCK = threading.Lock()


def _count(table: dict, key: str) -> None:
    with _COUNTS_LOCK:
        table[key] += 1


def reset_counts() -> None:
    with _COUNTS_LOCK:
        for form in LAUNCHES.values():
            for arm in form:
                form[arm] = 0
        for k in PLAIN_CALLS:
            PLAIN_CALLS[k] = 0
        for d in (COMBINE_LAUNCHES, COMBINE_PLAIN_CALLS):
            for k in d:
                d[k] = 0


def shared_fits(n_seg: int, n_agg_fields: int, need_minmax: bool = True) -> bool:
    """Do one block's partials of every segment fit shared memory?"""
    planes = 3 if need_minmax else 1
    return n_seg * (1 + planes * n_agg_fields) * 4 <= SHARED_MEM_BYTES


def block_hash_slots(hash_slots: int, n_agg_fields: int, need_minmax: bool = True) -> int:
    """The most slots the hash arm's table may have in one block:
    ``hash_slots`` where the table fits shared memory at 16 B of claim
    count, then a slot's 4 B of key, 4 B of claim list and (1 + planes * F)
    * 4 B of partials, else the largest power of two that fits."""
    planes = 3 if need_minmax else 1
    per_slot = 8 + (1 + planes * n_agg_fields) * 4
    h = int(hash_slots)
    while h > 2 and 16 + h * per_slot > SHARED_MEM_BYTES:
        h //= 2
    return h


def segmented_geometry(n_rows: int, sms: int, max_slots: int, resident) -> tuple[int, int]:
    """(rows one block takes, slots of its hash table: 0 without one) of a
    segmented launch (SELECTIVE, or the hash arm): the fewest whole 32-row
    steps a warp, one, two, four and so on (BLOCK rows a step of a
    block's 8 warps), whose ceil(n_rows / rows) blocks the card holds at
    once, ``sms`` times ``resident(slots)`` blocks. With ``max_slots``
    (``block_hash_slots``) a block's table is ``fitted_hash_slots`` of it
    at those rows; ``resident`` gives the blocks one SM holds at a table's
    shared memory (at least one is assumed)."""
    rows = BLOCK
    while True:
        slots = fitted_hash_slots(max_slots, rows) if max_slots else 0
        if -(-max(int(n_rows), 1) // rows) <= sms * max(1, resident(slots)):
            return rows, slots
        rows *= 2


def fitted_hash_slots(max_slots: int, rows: int) -> int:
    """Slots of a hash launch's table: a power of two of at least 2, twice
    the ``rows`` one block takes or more (a block touches at most that many
    segments), and at most ``max_slots`` (``block_hash_slots``)."""
    return min(int(max_slots), next_pow2(2 * int(rows), floor=2))


def pinned_segment_impl() -> str:
    """The HORAEDB_SEGMENT_IMPL pin: ONE arm for every query shape (exists
    to bisect the arms): ``shared``, ``scatter`` or ``hash``; ``mxu`` names
    the reference's small-segment arm and maps to ``shared``. Empty string
    means auto. Read per call."""
    v = os.environ.get("HORAEDB_SEGMENT_IMPL", "auto")
    if v == "mxu":
        return "shared"
    return v if v in SEGMENT_KERNELS else ""


def resolve_segment_impl(
    n_seg: int, requested: str = "auto", n_agg_fields: int = 0,
    need_minmax: bool = True,
) -> str:
    """Which arm a launch takes for ``n_seg`` — "single", "shared",
    "scatter" or "hash". A pin wins for every shape; ``hash`` is taken
    where pinned or requested (on any n_seg >= 2 unpinned); ``shared``
    only where its partials fit shared memory, else ``scatter``."""
    pinned = pinned_segment_impl()
    choice = pinned or requested
    if not pinned and n_seg == 1:
        # Global aggregate: a block reduction is the bandwidth floor.
        return "single"
    if choice == "hash":
        return "hash"
    if choice == "shared" and shared_fits(n_seg, n_agg_fields, need_minmax):
        return "shared"
    return "scatter"


@dataclass(frozen=True)
class ScanAggSpec:
    """Static shape/op configuration of one launch."""

    n_groups: int  # padded
    n_buckets: int  # padded
    n_agg_fields: int
    # ((value_row_index, op_str), ...) evaluated on device against literals
    numeric_filters: tuple[tuple[int, str], ...] = ()
    # False when no min/max aggregate is requested: the kernel skips the
    # min/max reductions entirely and returns zeros in their slots.
    need_minmax: bool = True
    # Reduction arm for this launch: "auto" or one of ARMS, as chosen by
    # the learned router.
    segment_impl: str = "auto"
    # Hash-arm slot-table size (power of 2; 0 = derive from n_seg), sized
    # by the router from its cardinality estimate.
    hash_slots: int = 0

    def padded(self) -> "ScanAggSpec":
        # Ungrouped specs (n_groups == 1) skip group padding: padding to 8
        # would multiply segment work for nothing. When additionally
        # n_buckets == 1 (global aggregate), n_seg stays 1 and the
        # single arm applies; bucketed ungrouped queries still pad
        # n_buckets below.
        return ScanAggSpec(
            n_groups=next_pow2(self.n_groups, floor=8) if self.n_groups > 1 else 1,
            n_buckets=next_pow2(self.n_buckets, floor=1),
            n_agg_fields=self.n_agg_fields,
            numeric_filters=self.numeric_filters,
            need_minmax=self.need_minmax,
            segment_impl=self.segment_impl,
            hash_slots=self.hash_slots,
        )


# ---- plain PyTorch versions ------------------------------------------------


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """int32 key whose order is the float order with -0.0 < +0.0 (an
    involution: applying it to a key gives the float bits back)."""
    bits = v.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _from_key(k: torch.Tensor) -> torch.Tensor:
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _segment_extreme(vals, seg, n_slots: int, amin: bool) -> torch.Tensor:
    """Exact per-segment min or max of f32 rows (F, N): NaN propagates and
    -0.0 orders below +0.0, as in the reference's scatter arm."""
    F = vals.shape[0]
    init = float("inf") if amin else float("-inf")
    fill = _order_key(torch.full((1,), init, device=vals.device))[0].item()
    out = torch.full((F, n_slots), fill, dtype=torch.int32, device=vals.device)
    idx = seg.expand(F, -1)
    out.scatter_reduce_(1, idx, _order_key(vals), "amin" if amin else "amax")
    res = _from_key(out)
    nans = torch.zeros((F, n_slots), dtype=torch.int32, device=vals.device)
    nans.scatter_add_(1, idx, torch.isnan(vals).to(torch.int32))
    return torch.where(nans > 0, torch.full_like(res, float("nan")), res)


def _segment_agg(seg_raw, m, agg_vals, n_seg: int, need_minmax: bool):
    """(counts, sums, mins, maxs) over flat segment ids; masked rows land in
    a dump slot. Sums accumulate in f64 and round once to f32. The plain
    version of every arm: they all compute this function."""
    seg = torch.where(m, seg_raw.to(torch.int64), torch.full_like(seg_raw, n_seg, dtype=torch.int64))
    counts = torch.zeros(n_seg + 1, dtype=torch.int32, device=m.device)
    counts.scatter_add_(0, seg, m.to(torch.int32))
    counts = counts[:n_seg]
    if agg_vals is None:
        return counts, None, None, None
    F = agg_vals.shape[0]
    zero = torch.zeros((), dtype=agg_vals.dtype, device=m.device)
    sums = torch.zeros((F, n_seg + 1), dtype=torch.float64, device=m.device)
    sums.scatter_add_(1, seg.expand(F, -1), torch.where(m, agg_vals, zero).to(torch.float64))
    sums = sums[:, :n_seg].to(torch.float32)
    if need_minmax:
        mins = _segment_extreme(agg_vals, seg[None, :], n_seg + 1, amin=True)[:, :n_seg]
        maxs = _segment_extreme(agg_vals, seg[None, :], n_seg + 1, amin=False)[:, :n_seg]
    else:
        mins = maxs = torch.zeros_like(sums)
    return counts, sums, mins, maxs


def _apply_filters(m, values, literals, numeric_filters):
    for i, (field_idx, op_code) in enumerate(numeric_filters):
        v = values[field_idx]
        lit = literals[i]
        if op_code == 0:
            m = m & (v == lit)
        elif op_code == 1:
            m = m & (v != lit)
        elif op_code == 2:
            m = m & (v < lit)
        elif op_code == 3:
            m = m & (v <= lit)
        elif op_code == 4:
            m = m & (v > lit)
        else:
            m = m & (v >= lit)
    return m


def scan_agg_body(
    group_codes,
    bucket_ids,
    mask,
    values,
    literals,
    *,
    n_groups: int,
    n_buckets: int,
    n_agg_fields: int,
    numeric_filters: tuple[tuple[int, int], ...] = (),
    need_minmax: bool = True,
    segment_impl: str = "auto",
    hash_slots: int = 0,
    overflow=None,
):
    """Plain version of ``scan_agg_direct``: filter, segment = group·B +
    bucket, per-segment count/sum/min/max. ``values`` is an (F, N) tensor
    or a list of per-field rows (an encoded-layout decode). The ``hash``
    arm runs ``hash_segment_agg_plain`` with ``hash_slots`` slots (0:
    ``default_hash_slots``), adding its unplaced rows to ``overflow``;
    every other arm computes the same function as ``_segment_agg``."""
    m = _apply_filters(mask, values, literals, numeric_filters)
    n_seg = n_groups * n_buckets
    seg_raw = group_codes.to(torch.int64) * n_buckets + bucket_ids.to(torch.int64)
    # out-of-range segment ids drop, as in a scatter
    m = m & (seg_raw >= 0) & (seg_raw < n_seg)
    if n_agg_fields:
        if isinstance(values, (list, tuple)):
            agg_vals = torch.stack(list(values[:n_agg_fields]))
        else:
            agg_vals = values[:n_agg_fields]
    else:
        agg_vals = None
    if segment_impl == "hash":
        counts, sums, mins, maxs = hash_segment_agg_plain(
            seg_raw, m, agg_vals, n_seg, need_minmax, hash_slots or default_hash_slots(n_seg),
            overflow,
        )
    else:
        counts, sums, mins, maxs = _segment_agg(seg_raw, m, agg_vals, n_seg, need_minmax)
    counts = counts.reshape(n_groups, n_buckets)
    if n_agg_fields:
        shape = (n_agg_fields, n_groups, n_buckets)
        return counts, sums.reshape(shape), mins.reshape(shape), maxs.reshape(shape)
    zero = torch.zeros((0, n_groups, n_buckets), dtype=torch.float32, device=mask.device)
    return counts, zero, zero, zero


def cached_scan_agg_body(
    series_codes,
    ts_rel,
    values,
    group_of_series,
    allowed_series,
    literals,
    lo_rel: int,
    hi_rel: int,
    t0_rel: int,
    bucket_ms: int,
    *,
    n_groups: int,
    n_buckets: int,
    n_agg_fields: int,
    numeric_filters: tuple[tuple[int, int], ...],
    need_minmax: bool = True,
    segment_impl: str = "auto",
    hash_slots: int = 0,
    overflow=None,
    value_layouts: tuple = (),
    ts_layout: tuple = ("raw",),
    series_layout: tuple = ("raw",),
    idx=None,
):
    """Plain version of ``scan_agg_cached``: decode the resident layouts
    (all rows, or the rows ``idx`` names), mask = allow[code] ∧ lo ≤ ts <
    hi ∧ filters, bucket = clip(floor((ts − t0) / w), 0, B − 1), group =
    gos[code], then the reduction."""
    sc, tr, vals = _decode_layouts(
        series_codes, ts_rel, values, series_layout, ts_layout, value_layouts, idx=idx
    )
    sc = sc.long()
    tr = tr.to(torch.int64)
    mask = allowed_series[sc] & (tr >= lo_rel) & (tr < hi_rel)
    # int32 subtraction wraps in the reference: wrap it explicitly
    d = ((tr - t0_rel + (1 << 31)) % (1 << 32)) - (1 << 31)
    bucket = torch.div(d, bucket_ms, rounding_mode="floor").clamp(0, n_buckets - 1)
    groups = group_of_series[sc]
    if not isinstance(vals, (list, tuple)):
        vals = vals.to(torch.float32)
    return scan_agg_body(
        groups, bucket, mask, vals, literals,
        n_groups=n_groups, n_buckets=n_buckets, n_agg_fields=n_agg_fields,
        numeric_filters=numeric_filters, need_minmax=need_minmax,
        segment_impl=segment_impl, hash_slots=hash_slots, overflow=overflow,
    )


def _packed_body(
    series_codes,
    ts_rel,
    values,
    session,  # int32[2*(S+1)]: [group map | allow list]
    dyn,  # int32[n_f + 4 (+ M)]: [literals(bitcast) | lo,hi,t0,width | idx]
    *,
    n_groups: int,
    n_buckets: int,
    n_agg_fields: int,
    numeric_filters: tuple[tuple[int, int], ...],
    need_minmax: bool,
    segment_impl: str = "auto",
    hash_slots: int = 0,
    overflow=None,
    selective: bool = False,
    value_layouts: tuple = (),
    ts_layout: tuple = ("raw",),
    series_layout: tuple = ("raw",),
    n_rows=None,
):
    """Plain version of the packed cached kernel: the same inputs and the
    same one-buffer output [counts bitcast | sums | mins | maxs]. It takes
    ``n_rows`` (the kernel's prefix of rows to scan) and ignores it: it
    stays the reference's function over every row, so a kernel that agrees
    with it over a prefix shows the prefix held every passing row."""
    s1 = session.shape[0] // 2
    gos = session[:s1].long()
    allow = session[s1:] != 0
    n_f = len(numeric_filters)
    literals = dyn[:n_f].contiguous().view(torch.float32)
    lo, hi, t0, width = (int(x) for x in dyn[n_f : n_f + 4].tolist())
    idx = dyn[n_f + 4 :] if selective else None
    counts, sums, mins, maxs = cached_scan_agg_body(
        series_codes, ts_rel, values, gos, allow, literals, lo, hi, t0, width,
        n_groups=n_groups, n_buckets=n_buckets, n_agg_fields=n_agg_fields,
        numeric_filters=numeric_filters, need_minmax=need_minmax,
        segment_impl=segment_impl, hash_slots=hash_slots, overflow=overflow,
        value_layouts=value_layouts,
        ts_layout=ts_layout, series_layout=series_layout, idx=idx,
    )
    parts = [counts.reshape(-1).view(torch.float32), sums.reshape(-1)]
    if need_minmax:
        parts.extend([mins.reshape(-1), maxs.reshape(-1)])
    return torch.cat(parts)


def packed_len(n_groups: int, n_buckets: int, n_agg_fields: int, need_minmax: bool) -> int:
    """f32 words of one packed output [counts | sums | mins | maxs]."""
    planes = 3 if need_minmax else 1
    return n_groups * n_buckets * (1 + planes * n_agg_fields)


def combine_planes_plain(planes) -> list:
    """Plain version of ``mesh_combine``: ``planes`` is four lists (counts,
    sums, mins, maxs), each of the S shards' tensors of that plane, or an
    empty list for an absent plane. Counts add as int32 (their bits, in
    float32 or int32 tensors), sums as f32 in shard order, mins and maxs by
    the order key of ``_order_key`` (-0.0 below +0.0) with NaN winning, as
    the kernel's ``fmin_t``/``fmax_t``. One tensor per plane (None where
    absent)."""
    out: list = []
    for p, parts in enumerate(planes):
        if not parts:
            out.append(None)
        elif p == 0:
            acc = parts[0].contiguous().view(torch.int32).clone()
            for t in parts[1:]:
                acc += t.contiguous().view(torch.int32)
            out.append(acc.view(parts[0].dtype))
        elif p == 1:
            acc = parts[0].clone()
            for t in parts[1:]:
                acc += t
            out.append(acc)
        else:
            keys = torch.stack([_order_key(t) for t in parts])
            best = keys.amin(0) if p == 2 else keys.amax(0)
            nan = torch.stack([torch.isnan(t) for t in parts]).any(0)
            res = _from_key(best)
            out.append(torch.where(nan, torch.full_like(res, float("nan")), res))
    return out


def _cohort_body(series_codes, ts_rel, values, sessions, dyns, **kw):
    """Plain version of the cohort kernel: ``_packed_body`` once per
    member (row b of ``sessions`` int32[B, 2(S+1)] and ``dyns`` int32[B,
    n_f + 4]) over the same resident columns, every row (``n_rows`` is
    ignored, as there); f32[B, packed_len]."""
    rows = [
        _packed_body(series_codes, ts_rel, values, sessions[b], dyns[b], selective=False, **kw)
        for b in range(sessions.shape[0])
    ]
    if rows:
        return torch.stack(rows)
    n = packed_len(kw["n_groups"], kw["n_buckets"], kw["n_agg_fields"], kw["need_minmax"])
    return torch.zeros((0, n), dtype=torch.float32, device=sessions.device)


# ---- the kernel and its wrappers -------------------------------------------


class _Column(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("aux", ctypes.c_void_p),
        ("kind", ctypes.c_int),
        ("width", ctypes.c_int),
    ]


class _Out(ctypes.Structure):
    _fields_ = [
        ("counts", ctypes.c_void_p),
        ("sums", ctypes.c_void_p),
        ("mins", ctypes.c_void_p),
        ("maxs", ctypes.c_void_p),
        ("n_seg", ctypes.c_int),
        ("n_agg", ctypes.c_int),
        ("minmax", ctypes.c_int),
        ("hash_slots", ctypes.c_int),  # the hash arm: slots of a block's table
        ("hash_rounds", ctypes.c_int),  # the hash arm: linear-probe rounds
        ("block_rows", ctypes.c_int),  # segmented launches: rows one block takes
        ("overflow", ctypes.c_void_p),  # int64 the hash arm adds unplaced rows to, or NULL
    ]


class _Filters(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int),
        ("field", ctypes.c_int * MAX_FILTERS),
        ("op", ctypes.c_int * MAX_FILTERS),
    ]


class _DirectArgs(ctypes.Structure):
    _fields_ = [
        ("group_codes", ctypes.c_void_p),
        ("bucket_ids", ctypes.c_void_p),
        ("mask", ctypes.c_void_p),
        ("values", ctypes.c_void_p),
        ("literals", ctypes.c_void_p),
        ("n_rows", ctypes.c_longlong),
        ("n_buckets", ctypes.c_int),
        ("device", ctypes.c_int),
        ("filt", _Filters),
        ("out", _Out),
    ]


class _CachedArgs(ctypes.Structure):
    _fields_ = [
        ("series", _Column),
        ("ts", _Column),
        ("fields", _Column * MAX_FIELDS),
        ("session", ctypes.c_void_p),
        ("dyn", ctypes.c_void_p),
        ("n_rows", ctypes.c_longlong),
        ("s1", ctypes.c_int),
        ("n_buckets", ctypes.c_int),
        ("device", ctypes.c_int),
        ("pad_", ctypes.c_int),
        ("filt", _Filters),
        ("out", _Out),
    ]


class _CohortArgs(ctypes.Structure):
    """Mirror of ``CohortArgs`` in ops/csrc/scan_agg.cu: the columns and
    statics of one cached launch, and where member b's session, dyn and
    packed output rows start; then the launch statistics' counters (or
    NULL) and whether each warp carries the members' run partials in
    shared memory."""

    _fields_ = [
        ("c", _CachedArgs),
        ("sessions", ctypes.c_void_p),
        ("dyns", ctypes.c_void_p),
        ("out_w", ctypes.c_longlong),
        ("members", ctypes.c_int),
        ("sess_w", ctypes.c_int),
        ("dyn_w", ctypes.c_int),
        ("n_fields", ctypes.c_int),
        ("tile", ctypes.c_int),
        ("pad_", ctypes.c_int),
        ("stats", ctypes.c_void_p),
        ("carry", ctypes.c_int),
        ("pad2_", ctypes.c_int),
    ]

# the cohort's launch statistics, in the order the kernel adds to them
COHORT_STATS = ("chunks", "member_chunks", "member_chunks_skipped", "commits")
# fields the reduction core holds in registers at once (FCAP in
# ops/csrc/scan_agg.cu)
FCAP = 10


def cohort_tile(n_fields: int) -> int:
    """Rows of the cohort kernel's tile: a power of two from 256 to 4096
    whose decoded rows (series code, timestamp, ``n_fields`` values) fit
    48 KB of shared memory."""
    tile = 4096
    while tile > 256 and tile * (2 + n_fields) * 4 > 48 * 1024:
        tile //= 2
    return tile


def cohort_arm(segment_impl: str, members: int, n_fields: int, n_seg: int,
               n_agg_fields: int, need_minmax: bool) -> str:
    """The arm a cohort launch takes: ``single`` and ``shared`` keep every
    member's partials in shared memory beside the tile, so they hold only
    where all of them fit there together; otherwise ``scatter``. ``hash``
    takes ``shared`` where that fits, else ``scatter``: B slot tables do
    not fit beside the tile (at B = 32, about 5.6 KB a member)."""
    _check(segment_impl in ARMS, f"segment_impl {segment_impl!r} not in {ARMS}")
    _check(segment_impl != "single" or n_seg == 1, "single arm needs n_seg == 1")
    if segment_impl == "hash":
        segment_impl = "shared" if shared_fits(n_seg, n_agg_fields, need_minmax) else "scatter"
    tile_bytes = cohort_tile(n_fields) * (2 + n_fields) * 4
    parts = members * packed_len(1, n_seg, n_agg_fields, need_minmax) * 4
    if segment_impl != "scatter" and tile_bytes + parts > SHARED_MEM_BYTES:
        return "scatter"
    return segment_impl


def cohort_record_words(n_agg_fields: int, need_minmax: bool) -> int:
    """int32 words of one member's carried run partials in a warp's
    records: a segment and a count for each pass of FCAP fields, then the
    sum (and min and max) of every field."""
    passes = -(-n_agg_fields // FCAP) if n_agg_fields > FCAP else 1
    return 2 * passes + (3 if need_minmax else 1) * n_agg_fields


def cohort_smem(arm: str, members: int, n_fields: int, n_seg: int, n_agg_fields: int,
                need_minmax: bool, carry: bool) -> int:
    """Bytes of shared memory one cohort block asks for: the tile, then
    (single / shared) every member's partials, then (``carry``) the
    records of its 8 warps."""
    smem = cohort_tile(n_fields) * (2 + n_fields) * 4
    if arm != "scatter":
        smem += members * packed_len(1, n_seg, n_agg_fields, need_minmax) * 4
    if carry:
        smem += (BLOCK // 32) * members * cohort_record_words(n_agg_fields, need_minmax) * 4
    return smem


def cohort_carry(arm: str, members: int, n_fields: int, n_seg: int, n_agg_fields: int,
                 need_minmax: bool) -> bool:
    """Whether a cohort launch carries each member's run partial from chunk
    to chunk in shared memory: where its records fit beside the tile and
    the arm's partials (``cohort_arm`` chose the arm without them);
    otherwise each member commits at each chunk's end."""
    return cohort_smem(arm, members, n_fields, n_seg, n_agg_fields, need_minmax,
                       True) <= SHARED_MEM_BYTES


def cohort_chunks(n_rows: int, n_fields: int) -> tuple[int, int]:
    """(rows of a chunk, chunks) of a cohort launch over ``n_rows`` rows:
    a warp's part of the tile, tile / 8 rows, and the chunks that cover
    the rows (each decoded once for the cohort)."""
    rows = cohort_tile(n_fields) // (BLOCK // 32)
    return rows, -(-int(n_rows) // rows)


MAX_SHARDS = 64


class _CombineArgs(ctypes.Structure):
    """Mirror of ``CombineArgs`` in ops/csrc/scan_agg.cu."""

    _fields_ = [
        ("src", (ctypes.c_void_p * MAX_SHARDS) * 4),
        ("dst", ctypes.c_void_p * 4),
        ("len", ctypes.c_longlong * 4),
        ("first_block", ctypes.c_longlong * 5),
        ("shards", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


# column layout codes of the kernel (ops/csrc/scan_agg.cu)
_LAY_RAW, _LAY_BF16, _LAY_DICT, _LAY_CODES, _LAY_DELTA, _LAY_TSDICT = range(6)

_lib = None


def _kernels():
    """The built kernel library (nvcc at first use), with its C signatures
    declared and its struct layouts checked against this module's."""
    global _lib
    if _lib is None:
        from ._build import load

        lib = load("scan_agg")
        lib.scan_agg_abi.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.scan_agg_abi.restype = ctypes.c_int
        lib.scan_agg_direct_launch.argtypes = [
            ctypes.POINTER(_DirectArgs), ctypes.c_int, ctypes.c_void_p,
        ]
        lib.scan_agg_direct_launch.restype = ctypes.c_int
        lib.scan_agg_cached_launch.argtypes = [
            ctypes.POINTER(_CachedArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.scan_agg_cached_launch.restype = ctypes.c_int
        lib.scan_agg_cohort_launch.argtypes = [
            ctypes.POINTER(_CohortArgs), ctypes.c_int, ctypes.c_void_p,
        ]
        lib.scan_agg_cohort_launch.restype = ctypes.c_int
        lib.scan_agg_blocks_per_sm.argtypes = [
            ctypes.POINTER(_Out), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.scan_agg_blocks_per_sm.restype = ctypes.c_int
        lib.scan_agg_combine_launch.argtypes = [ctypes.POINTER(_CombineArgs), ctypes.c_void_p]
        lib.scan_agg_combine_launch.restype = ctypes.c_int
        lib.scan_agg_error_string.argtypes = [ctypes.c_int]
        lib.scan_agg_error_string.restype = ctypes.c_char_p
        sizes = (ctypes.c_longlong * 10)()
        lib.scan_agg_abi(sizes)
        want = [
            ctypes.sizeof(_Column), ctypes.sizeof(_Out), ctypes.sizeof(_Filters),
            ctypes.sizeof(_DirectArgs), ctypes.sizeof(_CachedArgs),
            MAX_FIELDS, MAX_FILTERS, ctypes.sizeof(_CohortArgs),
            ctypes.sizeof(_CombineArgs), MAX_SHARDS,
        ]
        if list(sizes) != want:
            raise RuntimeError(f"scan_agg ABI mismatch: kernel {list(sizes)} vs {want}")
        _lib = lib
    return _lib


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"scan_agg kernel input: {what}")


def _check_tensor(t, name: str, dtype, device, ndim: int | None = None) -> None:
    if (isinstance(t, torch.Tensor) and t.device == device and t.dtype == dtype
            and t.is_contiguous() and (ndim is None or t.dim() == ndim)):
        return  # a wrapper's host time: no message is formatted for a good input
    _check(isinstance(t, torch.Tensor), f"{name} must be a tensor")
    _check(t.device == device, f"{name} on {t.device}, expected {device}")
    _check(t.dtype == dtype, f"{name} is {t.dtype}, expected {dtype}")
    _check(t.is_contiguous(), f"{name} must be contiguous")
    if ndim is not None:
        _check(t.dim() == ndim, f"{name} must have {ndim} dims, has {t.dim()}")


def _launch_error(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: {lib.scan_agg_error_string(err).decode()} ({err})"
        )


def _filters(numeric_filters, n_fields: int) -> _Filters:
    _check(len(numeric_filters) <= MAX_FILTERS, f"at most {MAX_FILTERS} filters")
    f = _Filters()
    f.n = len(numeric_filters)
    for k, (field_idx, op_code) in enumerate(numeric_filters):
        _check(0 <= field_idx < n_fields, f"filter field {field_idx} out of range")
        _check(0 <= op_code <= 5, f"filter op code {op_code}")
        f.field[k] = field_idx
        f.op[k] = op_code
    return f


def _arm(segment_impl: str, n_seg: int, n_agg_fields: int, need_minmax: bool) -> str:
    """The arm of a solo launch: a concrete one as given, or ``auto``
    resolved (``resolve_segment_impl``, which honours the pin)."""
    if segment_impl == "auto":
        segment_impl = resolve_segment_impl(n_seg, "auto", n_agg_fields, need_minmax)
    _check(segment_impl in ARMS, f"segment_impl {segment_impl!r} not in {ARMS}")
    _check(segment_impl != "single" or n_seg == 1, "single arm needs n_seg == 1")
    _check(
        segment_impl != "shared" or shared_fits(n_seg, n_agg_fields, need_minmax),
        "shared arm partials exceed shared memory",
    )
    return segment_impl


_SM_COUNT: dict = {}
_RESIDENT: dict = {}
# a segmented launch's entry point, as scan_agg_blocks_per_sm names it
_FORM_CODE = {"direct": 0, "cached": 1, "cached_selective": 2}


def _sm_count(dev) -> int:
    """Streaming multiprocessors of the card ``dev``."""
    index = _device_index(dev)
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _blocks_per_sm(out: _Out, arm: str, form: str, dev, lib=None) -> int:
    """Blocks of the launch's kernel one SM holds at the shared memory
    ``out`` asks for (the occupancy query of ``lib``, the built library by
    default, kept per shape)."""
    index = _device_index(dev)
    n_seg = out.n_seg if arm == "shared" else 0
    key = (index, form, arm, n_seg, out.n_agg, out.minmax, out.hash_slots, id(lib))
    if key not in _RESIDENT:
        lib = lib or _kernels()
        per_sm = ctypes.c_int(0)
        _launch_error(lib, lib.scan_agg_blocks_per_sm(ctypes.byref(out), _ARM_CODE[arm],
                                                      _FORM_CODE[form], index,
                                                      ctypes.byref(per_sm)),
                      "scan_agg occupancy query")
        _RESIDENT[key] = per_sm.value
    return _RESIDENT[key]


def _set_launch(out: _Out, arm: str, hash_slots: int, overflow, dev, n_rows: int,
                form: str, lib=None) -> None:
    """The launch fields of ``out`` besides its planes: the overflow
    counter; for a segmented launch (``form`` cached_selective, or the
    hash arm) the rows a block takes and, for the hash arm, a block's table
    (``segmented_geometry``, at most ``block_hash_slots`` of ``hash_slots``,
    0 meaning ``default_hash_slots``) and its probe rounds
    (HORAEDB_HASH_PROBE_ROUNDS). ``lib``: the library whose occupancy
    query sizes it (the built one by default)."""
    if overflow is not None:
        _check_tensor(overflow, "overflow", torch.int64, dev, 1)
        _check(overflow.shape[0] == 1, "overflow is one int64")
        out.overflow = overflow.data_ptr()
    if form != "cached_selective" and arm != "hash":
        return
    max_slots = 0
    if arm == "hash":
        slots = hash_slots or default_hash_slots(out.n_seg)
        _check(slots >= 2 and slots & (slots - 1) == 0, f"hash_slots {slots} not a power of 2")
        max_slots = block_hash_slots(slots, out.n_agg, bool(out.minmax))

    def resident(h: int) -> int:
        out.hash_slots = h
        return _blocks_per_sm(out, arm, form, dev, lib)

    out.block_rows, out.hash_slots = segmented_geometry(n_rows, _sm_count(dev), max_slots,
                                                        resident)
    if arm == "hash":
        out.hash_rounds = probe_rounds(out.hash_slots)


def fused_scan_agg(
    group_codes,
    bucket_ids,
    mask,
    values,
    literals,
    *,
    n_groups: int,
    n_buckets: int,
    n_agg_fields: int,
    numeric_filters: tuple[tuple[int, int], ...] = (),
    need_minmax: bool = True,
    segment_impl: str = "scatter",
    hash_slots: int = 0,
    overflow=None,
):
    """(counts i32[G,B], sums/mins/maxs f32[F,G,B]) over one padded batch.

    ``segment_impl`` is an arm of ARMS or ``auto`` (resolved, honouring
    HORAEDB_SEGMENT_IMPL). The ``hash`` arm takes ``hash_slots`` (0:
    ``default_hash_slots``) and HORAEDB_HASH_PROBE_ROUNDS probe rounds,
    and adds the rows that found no slot to ``overflow`` (int64[1]) when
    one is given.

    A CUDA input launches ``scan_agg_direct``; a CPU input runs
    ``scan_agg_body``."""
    dev = group_codes.device
    n_seg = n_groups * n_buckets
    arm = _arm(segment_impl, n_seg, n_agg_fields, need_minmax)
    kw = dict(
        n_groups=n_groups, n_buckets=n_buckets, n_agg_fields=n_agg_fields,
        numeric_filters=numeric_filters, need_minmax=need_minmax,
        segment_impl=arm, hash_slots=hash_slots,
    )
    if dev.type == "cpu":
        _count(PLAIN_CALLS, "direct")
        return scan_agg_body(group_codes, bucket_ids, mask, values, literals, overflow=overflow,
                             **kw)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    n = group_codes.shape[0]
    _check_tensor(group_codes, "group_codes", torch.int32, dev, 1)
    _check_tensor(bucket_ids, "bucket_ids", torch.int32, dev, 1)
    _check_tensor(mask, "mask", torch.bool, dev, 1)
    _check_tensor(values, "values", torch.float32, dev, 2)
    _check_tensor(literals, "literals", torch.float32, dev, 1)
    _check(bucket_ids.shape[0] == n and mask.shape[0] == n, "row counts differ")
    _check(values.shape[1] == n, "values must be [F, N]")
    _check(n_agg_fields <= values.shape[0], "more agg fields than value rows")
    _check(n_agg_fields <= MAX_FIELDS, f"at most {MAX_FIELDS} agg fields")
    _check(literals.shape[0] == len(numeric_filters), "one literal per filter")
    lib = _kernels()
    counts = torch.zeros(n_seg, dtype=torch.int32, device=dev)
    sums = torch.zeros((n_agg_fields, n_seg), dtype=torch.float32, device=dev)
    if need_minmax:
        mins = torch.full_like(sums, float("inf"))
        maxs = torch.full_like(sums, float("-inf"))
    else:
        mins = torch.zeros_like(sums)
        maxs = torch.zeros_like(sums)
    a = _DirectArgs()
    a.group_codes = group_codes.data_ptr()
    a.bucket_ids = bucket_ids.data_ptr()
    a.mask = mask.data_ptr()
    a.values = values.data_ptr()
    a.literals = literals.data_ptr()
    a.n_rows = n
    a.n_buckets = n_buckets
    a.device = dev.index if dev.index is not None else torch.cuda.current_device()
    a.filt = _filters(numeric_filters, values.shape[0])
    a.out = _Out(
        counts.data_ptr(), sums.data_ptr(), mins.data_ptr(), maxs.data_ptr(),
        n_seg, n_agg_fields, int(need_minmax),
    )
    _set_launch(a.out, arm, hash_slots, overflow, dev, n, "direct")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launch_error(
        lib, lib.scan_agg_direct_launch(ctypes.byref(a), _ARM_CODE[arm], stream),
        "scan_agg_direct",
    )
    _count(LAUNCHES["direct"], arm)
    shape = (n_agg_fields, n_groups, n_buckets)
    return (
        counts.view(n_groups, n_buckets), sums.view(shape),
        mins.view(shape), maxs.view(shape),
    )


def _int_column(parts, layout, dev, name: str) -> _Column:
    c = _Column()
    if layout[0] == "raw":
        _check_tensor(parts[0], name, torch.int32, dev, 1)
        c.data, c.kind = parts[0].data_ptr(), _LAY_RAW
        return c
    words, aux = parts
    _check_tensor(words, f"{name} words", torch.int32, dev, 1)
    _check_tensor(aux, f"{name} {layout[0]}", torch.int32, dev, 1)
    _check(1 <= layout[1] <= 16, f"{name} width {layout[1]}")
    c.data, c.aux, c.width = words.data_ptr(), aux.data_ptr(), layout[1]
    _check(layout[0] in ("delta", "dict"), f"{name} layout {layout}")
    c.kind = _LAY_DELTA if layout[0] == "delta" else _LAY_TSDICT
    return c


def _value_column(parts, layout, dev, name: str) -> _Column:
    c = _Column()
    if layout[0] in ("raw", "bf16"):
        dtype = torch.float32 if layout[0] == "raw" else torch.bfloat16
        _check_tensor(parts[0], name, dtype, dev, 1)
        c.data = parts[0].data_ptr()
        c.kind = _LAY_RAW if layout[0] == "raw" else _LAY_BF16
        return c
    _check(layout[0] == "dict", f"{name} layout {layout}")
    words, dictionary = parts
    _check_tensor(words, f"{name} words", torch.int32, dev, 1)
    _check_tensor(dictionary, f"{name} dictionary", torch.float32, dev, 1)
    _check(1 <= layout[1] <= 16, f"{name} width {layout[1]}")
    c.data, c.aux, c.width = words.data_ptr(), dictionary.data_ptr(), layout[1]
    c.kind = _LAY_CODES if len(layout) > 2 and not layout[2] else _LAY_DICT
    return c


def _dense_layout(parts) -> tuple:
    return ("bf16",) if parts[0].dtype == torch.bfloat16 else ("raw",)


def cached_scan_agg_packed(
    series_parts,
    ts_parts,
    values,
    session,
    dyn,
    *,
    n_groups: int,
    n_buckets: int,
    n_agg_fields: int,
    numeric_filters: tuple[tuple[int, int], ...],
    need_minmax: bool,
    segment_impl: str = "scatter",
    hash_slots: int = 0,
    overflow=None,
    selective: bool = False,
    value_layouts: tuple = (),
    ts_layout: tuple = ("raw",),
    series_layout: tuple = ("raw",),
    n_rows=None,
):
    """The packed cached serving kernel: resident series/ts/value part
    tuples, one session buffer [group map | allow list], one dyn buffer
    [literals bitcast | lo, hi, t0, width | row idx], one packed f32 out
    [counts bitcast | sums | mins | maxs] (mins/maxs only with
    ``need_minmax``). ``segment_impl``, ``hash_slots`` and ``overflow`` as
    for ``fused_scan_agg``. ``n_rows``: the rows a full scan reads, a
    prefix of the layout's rows that holds every row that can pass (the
    cache entry's real rows); the layout's rows by default. A SELECTIVE
    launch reads its index and ignores it.

    A CUDA input launches ``scan_agg_cached``; a CPU input runs
    ``_packed_body``."""
    dev = session.device
    values = tuple(values)
    layouts = value_layouts or tuple(_dense_layout(p) for p in values)
    arm = _arm(segment_impl, n_groups * n_buckets, n_agg_fields, need_minmax)
    kw = dict(
        n_groups=n_groups, n_buckets=n_buckets, n_agg_fields=n_agg_fields,
        numeric_filters=numeric_filters, need_minmax=need_minmax,
        segment_impl=arm, hash_slots=hash_slots, selective=selective, value_layouts=layouts,
        ts_layout=ts_layout, series_layout=series_layout,
    )
    form = "cached_selective" if selective else "cached"
    if dev.type == "cpu":
        if not selective:
            _prefix(n_rows, layout_rows(series_parts, series_layout))
        _count(PLAIN_CALLS, form)
        return _packed_body(series_parts, ts_parts, values, session, dyn, overflow=overflow,
                            **kw)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check_tensor(session, "session", torch.int32, dev, 1)
    _check_tensor(dyn, "dyn", torch.int32, dev, 1)
    _check(session.shape[0] % 2 == 0, "session is [group map | allow list]")
    n_f = len(numeric_filters)
    _check(dyn.shape[0] >= n_f + 4, "dyn holds literals and four scalars")
    lib = _kernels()
    a, rows = _cached_args(series_parts, ts_parts, values, layouts, ts_layout, series_layout,
                           numeric_filters, n_agg_fields, n_buckets, dev)
    a.session = session.data_ptr()
    a.dyn = dyn.data_ptr()
    a.n_rows = dyn.shape[0] - n_f - 4 if selective else _prefix(n_rows, rows)
    a.s1 = session.shape[0] // 2
    packed = _packed_out(1, n_groups * n_buckets, n_agg_fields, need_minmax, dev)[0]
    a.out = _out_of(packed.data_ptr(), n_groups * n_buckets, n_agg_fields, need_minmax)
    _set_launch(a.out, arm, hash_slots, overflow, dev, a.n_rows, form)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launch_error(
        lib,
        lib.scan_agg_cached_launch(ctypes.byref(a), _ARM_CODE[arm], int(selective), stream),
        "scan_agg_cached",
    )
    _count(LAUNCHES[form], arm)
    return packed


def _cached_args(series_parts, ts_parts, values, layouts, ts_layout, series_layout,
                 numeric_filters, n_agg_fields, n_buckets, dev) -> tuple[_CachedArgs, int]:
    """Check the resident columns of a cached launch; returns the launch
    arguments with their pointers and statics set (session, dyn, rows to
    scan and outputs are the caller's) and the resident row count."""
    _check(len(values) == len(layouts), "one layout per value field")
    _check(len(values) <= MAX_FIELDS, f"at most {MAX_FIELDS} value fields")
    _check(n_agg_fields <= len(values), "more agg fields than value fields")
    n_rows = layout_rows(series_parts, series_layout)
    a = _CachedArgs()
    a.series = _int_column(series_parts, series_layout, dev, "series")
    a.ts = _int_column(ts_parts, ts_layout, dev, "ts")
    _check(ts_layout[0] != "delta" or layout_rows(ts_parts, ts_layout) == n_rows, "ts rows")
    for f, (parts, lay) in enumerate(zip(values, layouts)):
        a.fields[f] = _value_column(parts, lay, dev, f"value[{f}]")
        if lay[0] in ("raw", "bf16"):
            _check(parts[0].shape[0] == n_rows, f"value[{f}] has {parts[0].shape[0]} rows")
    a.n_rows = n_rows
    a.n_buckets = n_buckets
    a.device = dev.index if dev.index is not None else torch.cuda.current_device()
    a.filt = _filters(numeric_filters, len(values))
    return a, n_rows


def _prefix(n_rows, rows: int) -> int:
    """The rows a full scan reads: ``n_rows`` (checked to be a prefix of
    the layout's ``rows``), or all of them."""
    if n_rows is None:
        return rows
    _check(0 <= int(n_rows) <= rows, f"n_rows {n_rows} not in [0, {rows}]")
    return int(n_rows)


def _packed_out(rows: int, n_seg: int, n_agg_fields: int, need_minmax: bool, dev):
    """``rows`` packed outputs, f32[rows, packed_len], initialised as the
    reductions start: counts (bits of int 0) and sums 0, mins +inf, maxs
    -inf."""
    fs = n_agg_fields * n_seg
    planes = 3 if need_minmax else 1
    packed = torch.empty((rows, n_seg * (1 + planes * n_agg_fields)), dtype=torch.float32,
                         device=dev)
    packed[:, : n_seg + fs].zero_()
    if need_minmax:
        packed[:, n_seg + fs : n_seg + 2 * fs].fill_(float("inf"))
        packed[:, n_seg + 2 * fs :].fill_(float("-inf"))
    return packed


def _out_of(base: int, n_seg: int, n_agg_fields: int, need_minmax: bool) -> _Out:
    fs = n_agg_fields * n_seg
    return _Out(
        base, base + 4 * n_seg, base + 4 * (n_seg + fs), base + 4 * (n_seg + 2 * fs),
        n_seg, n_agg_fields, int(need_minmax),
    )


def cached_scan_agg_cohort(
    series_parts,
    ts_parts,
    values,
    sessions,
    dyns,
    *,
    n_groups: int,
    n_buckets: int,
    n_agg_fields: int,
    numeric_filters: tuple[tuple[int, int], ...],
    need_minmax: bool,
    segment_impl: str = "scatter",
    value_layouts: tuple = (),
    ts_layout: tuple = ("raw",),
    series_layout: tuple = ("raw",),
    n_rows=None,
    stats=None,
):
    """The cohort serving kernel: B shape-identical full-scan queries over
    the same resident columns, one session row (int32[B, 2(S+1)]) and one
    dyn row (int32[B, n_f + 4]) each; f32[B, packed_len], row b the packed
    output ``cached_scan_agg_packed`` gives for member b (each row unpacks
    with ``unpack_packed_state``). Selective gathers are per-member and
    variable-length: cohort members always scan every row of the first
    ``n_rows`` (as for ``cached_scan_agg_packed``).

    A CUDA input launches ``scan_agg_cohort``, which decodes each chunk of
    rows once and runs every member over it, with the arm ``cohort_arm``
    gives and, where ``cohort_carry`` finds room, each member's run
    partial carried from chunk to chunk; a CPU input runs
    ``_cohort_body``. ``stats`` (int64[4], CUDA): the kernel adds its
    ``COHORT_STATS`` to it."""
    dev = sessions.device
    values = tuple(values)
    layouts = value_layouts or tuple(_dense_layout(p) for p in values)
    n_seg = n_groups * n_buckets
    arm = cohort_arm(segment_impl, sessions.shape[0], len(values), n_seg, n_agg_fields,
                     need_minmax)
    kw = dict(
        n_groups=n_groups, n_buckets=n_buckets, n_agg_fields=n_agg_fields,
        numeric_filters=numeric_filters, need_minmax=need_minmax,
        segment_impl=arm, value_layouts=layouts,
        ts_layout=ts_layout, series_layout=series_layout,
    )
    if dev.type == "cpu":
        _prefix(n_rows, layout_rows(series_parts, series_layout))
        _count(PLAIN_CALLS, "cached_cohort")
        return _cohort_body(series_parts, ts_parts, values, sessions, dyns, **kw)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check_tensor(sessions, "sessions", torch.int32, dev, 2)
    _check_tensor(dyns, "dyns", torch.int32, dev, 2)
    B = sessions.shape[0]
    _check(dyns.shape[0] == B, "one dyn row per session row")
    _check(sessions.shape[1] % 2 == 0, "session rows are [group map | allow list]")
    n_f = len(numeric_filters)
    _check(dyns.shape[1] >= n_f + 4, "dyn rows hold literals and four scalars")
    packed = _packed_out(B, n_seg, n_agg_fields, need_minmax, dev)
    if B == 0:
        return packed
    lib = _kernels()
    c, rows = _cached_args(series_parts, ts_parts, values, layouts, ts_layout, series_layout,
                           numeric_filters, n_agg_fields, n_buckets, dev)
    c.n_rows = _prefix(n_rows, rows)
    c.s1 = sessions.shape[1] // 2
    c.out = _out_of(packed.data_ptr(), n_seg, n_agg_fields, need_minmax)
    a = _CohortArgs()
    a.c = c
    a.sessions, a.dyns = sessions.data_ptr(), dyns.data_ptr()
    a.out_w, a.members = packed.shape[1], B
    a.sess_w, a.dyn_w = sessions.shape[1], dyns.shape[1]
    a.n_fields, a.tile = len(values), cohort_tile(len(values))
    a.carry = int(cohort_carry(arm, B, len(values), n_seg, n_agg_fields, need_minmax))
    if stats is not None:
        _check_tensor(stats, "stats", torch.int64, dev, 1)
        _check(stats.shape[0] == len(COHORT_STATS), f"stats is int64[{len(COHORT_STATS)}]")
        a.stats = stats.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launch_error(
        lib, lib.scan_agg_cohort_launch(ctypes.byref(a), _ARM_CODE[arm], stream),
        "scan_agg_cohort",
    )
    _count(LAUNCHES["cached_cohort"], arm)
    return packed


def selective_cached_scan_agg(
    row_idx,
    series_codes,
    ts_rel,
    values,
    group_of_series,
    allowed_series,
    literals,
    lo_rel,
    hi_rel,
    t0_rel,
    bucket_ms,
    *,
    n_groups: int,
    n_buckets: int,
    n_agg_fields: int,
    numeric_filters: tuple[tuple[int, int], ...],
    need_minmax: bool = True,
    segment_impl: str = "auto",
    hash_slots: int = 0,
    overflow=None,
):
    """The cached kernel over a GATHERED subset of raw resident rows
    (``row_idx`` int32[M], pad slots pointing at a masked pad row), in the
    reference's unpacked form: (counts int32[G, B], sums/mins/maxs
    f32[F, G, B]) on the inputs' device.

    It packs the session and the dyn row (with the index) and calls
    ``cached_scan_agg_packed(..., selective=True)``: the SELECTIVE
    ``scan_agg_cached`` kernel for CUDA tensors, its plain version for CPU
    ones. ``segment_impl`` resolves as every launch's does
    (``resolve_segment_impl``); ``hash_slots`` and ``overflow`` go to the
    launch, as for ``fused_scan_agg``."""
    dev = series_codes.device
    n_seg = n_groups * n_buckets
    impl = resolve_segment_impl(n_seg, segment_impl, n_agg_fields, need_minmax)
    session = torch.cat([group_of_series.to(dev, torch.int32),
                         allowed_series.to(dev, torch.int32)])
    scalars = torch.tensor([int(lo_rel), int(hi_rel), int(t0_rel), int(bucket_ms)],
                           dtype=torch.int32, device=dev)
    lits = literals.to(dev, torch.float32).contiguous().view(torch.int32)
    dyn = torch.cat([lits, scalars, row_idx.to(dev, torch.int32)])
    rows = values if isinstance(values, (list, tuple)) else list(values.unbind(0))
    packed = cached_scan_agg_packed(
        (series_codes.contiguous(),), (ts_rel.contiguous(),),
        tuple((v.contiguous(),) for v in rows), session, dyn,
        n_groups=n_groups, n_buckets=n_buckets, n_agg_fields=n_agg_fields,
        numeric_filters=numeric_filters, need_minmax=need_minmax,
        segment_impl=impl, hash_slots=hash_slots, overflow=overflow, selective=True,
    )
    fs = n_agg_fields * n_seg
    shape = (n_agg_fields, n_groups, n_buckets)
    counts = packed[:n_seg].view(torch.int32).view(n_groups, n_buckets)
    sums = packed[n_seg:n_seg + fs].view(shape)
    if need_minmax:
        return counts, sums, packed[n_seg + fs:n_seg + 2 * fs].view(shape), \
            packed[n_seg + 2 * fs:].view(shape)
    zero = torch.zeros_like(sums)
    return counts, sums, zero, zero


def _combine(planes, outs, form: str) -> None:
    """One ``mesh_combine`` launch: plane p of the result into ``outs[p]``
    from ``planes[p]`` (one tensor per shard, all on one card; an empty
    list and None for an absent plane)."""
    dev = outs[0].device
    shards = len(planes[0])
    _check(1 <= shards <= MAX_SHARDS, f"{shards} shards, at most {MAX_SHARDS}")
    a = _CombineArgs()
    for p, (parts, out) in enumerate(zip(planes, outs)):
        if not parts:
            continue
        _check(len(parts) == shards, f"plane {p} has {len(parts)} shards, not {shards}")
        n = out.numel()
        for d, t in enumerate(parts):
            _check(t.device == dev, f"shard {d} plane {p} on {t.device}, expected {dev}")
            _check(t.dtype == out.dtype and t.is_contiguous() and t.numel() == n,
                   f"shard {d} plane {p}: {t.dtype} [{t.numel()}], expected {out.dtype} [{n}]")
            a.src[p][d] = t.data_ptr()
        a.dst[p] = out.data_ptr()
        a.len[p] = n
    a.shards = shards
    a.device = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launch_error(lib, lib.scan_agg_combine_launch(ctypes.byref(a), stream), "mesh_combine")
    _count(COMBINE_LAUNCHES, form)


def _packed_planes(buf, n_seg: int, n_agg_fields: int, need_minmax: bool) -> list:
    """The four planes of one packed buffer as views (an absent plane:
    None)."""
    fs = n_agg_fields * n_seg
    planes = [buf[:n_seg], buf[n_seg:n_seg + fs]]
    if need_minmax:
        planes += [buf[n_seg + fs:n_seg + 2 * fs], buf[n_seg + 2 * fs:n_seg + 3 * fs]]
    else:
        planes += [None, None]
    return planes


def mesh_combine(parts, *, n_seg: int, n_agg_fields: int, need_minmax: bool):
    """The sharded cached path's combine: ``parts`` is f32[S, packed_len]
    or S packed buffers f32[packed_len] (``cached_scan_agg_packed``'s
    output, all on one device) -> one packed buffer of the combined state
    on that device, so the host still makes one fetch.

    A CUDA input launches ``mesh_combine``; a CPU input runs
    ``combine_planes_plain``."""
    parts = list(parts)
    _check(len(parts) >= 1, "no partials to combine")
    length = packed_len(1, n_seg, n_agg_fields, need_minmax)
    for d, t in enumerate(parts):
        _check(isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.dim() == 1
               and t.shape[0] == length, f"partial {d} is not f32[{length}]")
    dev = parts[0].device
    split = [_packed_planes(t, n_seg, n_agg_fields, need_minmax) for t in parts]
    planes = [[s[p] for s in split] if split[0][p] is not None else [] for p in range(4)]
    if dev.type == "cpu":
        _count(COMBINE_PLAIN_CALLS, "packed")
        return torch.cat([x for x in combine_planes_plain(planes) if x is not None])
    _check(dev.type == "cuda", f"unsupported device {dev}")
    out = torch.empty(length, dtype=torch.float32, device=dev)
    _combine(planes, _packed_planes(out, n_seg, n_agg_fields, need_minmax), "packed")
    return out


def mesh_combine_state(states, *, need_minmax: bool):
    """The sharded direct path's combine: ``states`` is S tuples (counts
    int32[G, B], sums/mins/maxs f32[F, G, B]), all on one device (the
    ``fused_scan_agg`` outputs) -> one such tuple on that device. Without
    ``need_minmax`` the mins and maxs are zeros, as the kernel gives them.

    A CUDA input launches ``mesh_combine``; a CPU input runs
    ``combine_planes_plain``."""
    states = [tuple(s) for s in states]
    _check(len(states) >= 1, "no partials to combine")
    c0, s0, _, _ = states[0]
    dev = c0.device
    planes = [[st[p].reshape(-1) for st in states] for p in range(4)]
    if not need_minmax or s0.numel() == 0:
        planes[2] = planes[3] = []
    if s0.numel() == 0:
        planes[1] = []
    if dev.type == "cpu":
        _count(COMBINE_PLAIN_CALLS, "state")
        res = combine_planes_plain(planes)
    else:
        _check(dev.type == "cuda", f"unsupported device {dev}")
        res = [torch.empty_like(planes[p][0]) if planes[p] else None for p in range(4)]
        _combine(planes, res, "state")
    counts = res[0].view(c0.shape)
    sums = res[1].view(s0.shape) if res[1] is not None else torch.zeros_like(s0)
    mins = res[2].view(s0.shape) if res[2] is not None else torch.zeros_like(s0)
    maxs = res[3].view(s0.shape) if res[3] is not None else torch.zeros_like(s0)
    return counts, sums, mins, maxs


# ---- host-facing helpers ---------------------------------------------------


def pack_session(group_of_series: np.ndarray, allowed_series: np.ndarray) -> np.ndarray:
    """[group map | allow list] as one int32 buffer (one upload)."""
    return np.concatenate(
        [group_of_series.astype(np.int32), allowed_series.astype(np.int32)]
    )


def pack_dyn(
    filter_literals: Sequence[float],
    lo_rel: int,
    hi_rel: int,
    t0_rel: int,
    bucket_ms: int,
    row_idx: np.ndarray | None = None,
) -> np.ndarray:
    """Per-query dynamic inputs as one int32 buffer (one upload).

    f32 literals travel bitcast (the kernel bitcasts them back); the
    selective kernel's row index rides the same buffer.
    """
    lits = np.asarray(filter_literals, dtype=np.float32).view(np.int32)
    scalars = np.array([lo_rel, hi_rel, t0_rel, bucket_ms], dtype=np.int32)
    if row_idx is None:
        return np.concatenate([lits, scalars])
    return np.concatenate([lits, scalars, row_idx.astype(np.int32, copy=False)])


def unpack_packed_state(packed, spec: "ScanAggSpec") -> "AggState":
    """ONE device fetch -> writable host AggState.

    counts travel bitcast as f32; the host views the bytes back as int32.
    Arrays are copies (``_fold_delta`` accumulates in place).
    """
    arr = packed.cpu().numpy() if isinstance(packed, torch.Tensor) else np.asarray(packed)
    G, B, F = spec.n_groups, spec.n_buckets, spec.n_agg_fields
    gb = G * B
    counts = arr[:gb].view(np.int32).reshape(G, B).copy()
    sums = arr[gb : gb + F * gb].astype(np.float64).reshape(F, G, B)
    if spec.need_minmax and F:
        mins = arr[gb + F * gb : gb + 2 * F * gb].astype(np.float64).reshape(F, G, B)
        maxs = arr[gb + 2 * F * gb :].astype(np.float64).reshape(F, G, B)
    else:
        mins = np.zeros((F, G, B))
        maxs = np.zeros((F, G, B))
    return AggState(counts=counts, sums=sums, mins=mins, maxs=maxs)


@dataclass
class AggState:
    """Combinable partial aggregates (numpy, on host after device exit)."""

    counts: np.ndarray  # (G, B) int
    sums: np.ndarray  # (F, G, B)
    mins: np.ndarray  # (F, G, B)
    maxs: np.ndarray  # (F, G, B)

    def combine(self, other: "AggState") -> "AggState":
        return AggState(
            counts=self.counts + other.counts,
            sums=self.sums + other.sums,
            mins=np.minimum(self.mins, other.mins),
            maxs=np.maximum(self.maxs, other.maxs),
        )


def scan_aggregate(
    batch: PaddedBatch,
    spec: ScanAggSpec,
    filter_literals: Sequence[float] = (),
    *,
    device: torch.device,
) -> AggState:
    """Run the fused kernel on one padded batch on ``device``; returns host
    partials.

    ``spec`` should already be ``.padded()`` — callers slice the outputs
    back down to true group/bucket counts after combining partials.
    """
    import time as _time

    from ..obs.device import timed_dispatch
    from ..utils.querystats import note_kernel_dispatch

    impl = resolve_segment_impl(
        spec.n_groups * spec.n_buckets, spec.segment_impl,
        spec.n_agg_fields, spec.need_minmax,
    )
    args = (
        torch.from_numpy(batch.group_codes).to(device),
        torch.from_numpy(batch.bucket_ids).to(device),
        torch.from_numpy(batch.mask).to(device),
        torch.from_numpy(batch.values).to(device),
        coerce_literals(filter_literals, device),
    )
    kwargs = dict(
        n_groups=spec.n_groups,
        n_buckets=spec.n_buckets,
        n_agg_fields=spec.n_agg_fields,
        numeric_filters=encode_filter_ops(spec.numeric_filters),
        need_minmax=spec.need_minmax,
        segment_impl=impl,
        hash_slots=spec.hash_slots,
    )
    t0 = _time.perf_counter()
    counts, sums, mins, maxs = timed_dispatch(
        "fused", lambda: fused_scan_agg(*args, **kwargs), device
    )
    state = state_to_host(counts, sums, mins, maxs)
    note_kernel_dispatch(
        ("fused", batch.values.shape, spec.n_groups, spec.n_buckets,
         spec.n_agg_fields, spec.numeric_filters, spec.need_minmax, impl, spec.hash_slots),
        _time.perf_counter() - t0,
        kind="fused",
    )
    return state


def encode_filter_ops(
    filters: tuple[tuple[int, str], ...]
) -> tuple[tuple[int, int], ...]:
    """Op strings -> the integer codes the kernel branches on."""
    return tuple((fi, _FILTER_OPS[op]) for fi, op in filters)


def coerce_literals(filter_literals: Sequence[float], device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(filter_literals, dtype=np.float32)).to(device)


def state_to_host(counts, sums, mins, maxs) -> AggState:
    # one copy per output; the first waits for the launch
    return AggState(
        counts=counts.cpu().numpy(),
        sums=sums.cpu().numpy().astype(np.float64),
        mins=mins.cpu().numpy().astype(np.float64),
        maxs=maxs.cpu().numpy().astype(np.float64),
    )
