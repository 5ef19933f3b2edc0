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
this module (``scan_agg_body``, ``_packed_body``). Nothing else chooses
between them.

Aggregation state is the classic monoid (count, sum, min, max): partials
from different batches and the host-side delta fold combine associatively.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .encoding import PaddedBatch, decode_layouts as _decode_layouts, layout_rows, next_pow2

AGG_OPS = ("count", "sum", "min", "max", "avg")

# Numeric filter ops, by integer code (a launch argument of the kernel).
_FILTER_OPS = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}

# The kernel's reduction arms besides "single" (n_seg == 1):
#   shared  — block-private count/sum/min/max per segment in shared memory,
#             merged with global atomics; the arm for small segment counts
#             (the counterpart of the reference's one-hot "mxu" arm);
#   scatter — global atomics per segment; any segment count.
SEGMENT_KERNELS = ("shared", "scatter")
ARMS = ("single",) + SEGMENT_KERNELS
_ARM_CODE = {"single": 0, "shared": 1, "scatter": 2}
# The opt-in dynamic shared memory one block may use on Hopper.
SHARED_MEM_BYTES = 232_448
MAX_FIELDS = 32
MAX_FILTERS = 16

# Launches per entry point and arm, counted where each wrapper launches
# its kernel; PLAIN_CALLS counts the plain versions the wrappers ran for
# CPU tensors. Plain integers: a run reads them to show which path served.
LAUNCHES = {
    form: {arm: 0 for arm in ARMS}
    for form in ("direct", "cached", "cached_selective")
}
PLAIN_CALLS = {"direct": 0, "cached": 0, "cached_selective": 0}


def reset_counts() -> None:
    for form in LAUNCHES.values():
        for arm in form:
            form[arm] = 0
    for k in PLAIN_CALLS:
        PLAIN_CALLS[k] = 0


def shared_fits(n_seg: int, n_agg_fields: int, need_minmax: bool = True) -> bool:
    """Do one block's partials of every segment fit shared memory?"""
    planes = 3 if need_minmax else 1
    return n_seg * (1 + planes * n_agg_fields) * 4 <= SHARED_MEM_BYTES


def pinned_segment_impl() -> str:
    """The HORAEDB_SEGMENT_IMPL pin: ONE arm for every query shape (exists
    to bisect the arms). ``mxu`` names the reference's small-segment arm
    and maps to ``shared``. Empty string means auto. Read per call."""
    v = os.environ.get("HORAEDB_SEGMENT_IMPL", "auto")
    if v == "mxu":
        return "shared"
    return v if v in SEGMENT_KERNELS else ""


def resolve_segment_impl(
    n_seg: int, requested: str = "auto", n_agg_fields: int = 0,
    need_minmax: bool = True,
) -> str:
    """Which arm a launch takes for ``n_seg`` — "single", "shared" or
    "scatter". ``shared`` is taken only where its partials fit shared
    memory; otherwise the launch falls back to ``scatter``."""
    pinned = pinned_segment_impl()
    choice = pinned or requested
    if not pinned and n_seg == 1:
        # Global aggregate: a block reduction is the bandwidth floor.
        return "single"
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
):
    """Plain version of ``scan_agg_direct``: filter, segment = group·B +
    bucket, per-segment count/sum/min/max. ``values`` is an (F, N) tensor
    or a list of per-field rows (an encoded-layout decode)."""
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
        segment_impl=segment_impl,
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
    selective: bool = False,
    value_layouts: tuple = (),
    ts_layout: tuple = ("raw",),
    series_layout: tuple = ("raw",),
):
    """Plain version of the packed cached kernel: the same inputs and the
    same one-buffer output [counts bitcast | sums | mins | maxs]."""
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
        segment_impl=segment_impl, value_layouts=value_layouts,
        ts_layout=ts_layout, series_layout=series_layout, idx=idx,
    )
    parts = [counts.reshape(-1).view(torch.float32), sums.reshape(-1)]
    if need_minmax:
        parts.extend([mins.reshape(-1), maxs.reshape(-1)])
    return torch.cat(parts)


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
        ("pad_", ctypes.c_int),
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
        lib.scan_agg_error_string.argtypes = [ctypes.c_int]
        lib.scan_agg_error_string.restype = ctypes.c_char_p
        sizes = (ctypes.c_longlong * 7)()
        lib.scan_agg_abi(sizes)
        want = [
            ctypes.sizeof(_Column), ctypes.sizeof(_Out), ctypes.sizeof(_Filters),
            ctypes.sizeof(_DirectArgs), ctypes.sizeof(_CachedArgs),
            MAX_FIELDS, MAX_FILTERS,
        ]
        if list(sizes) != want:
            raise RuntimeError(f"scan_agg ABI mismatch: kernel {list(sizes)} vs {want}")
        _lib = lib
    return _lib


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"scan_agg kernel input: {what}")


def _check_tensor(t, name: str, dtype, device, ndim: int | None = None) -> None:
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
    _check(segment_impl in ARMS, f"segment_impl {segment_impl!r} not in {ARMS}")
    _check(segment_impl != "single" or n_seg == 1, "single arm needs n_seg == 1")
    _check(
        segment_impl != "shared" or shared_fits(n_seg, n_agg_fields, need_minmax),
        "shared arm partials exceed shared memory",
    )
    return segment_impl


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
):
    """(counts i32[G,B], sums/mins/maxs f32[F,G,B]) over one padded batch.

    A CUDA input launches ``scan_agg_direct``; a CPU input runs
    ``scan_agg_body``."""
    dev = group_codes.device
    kw = dict(
        n_groups=n_groups, n_buckets=n_buckets, n_agg_fields=n_agg_fields,
        numeric_filters=numeric_filters, need_minmax=need_minmax,
        segment_impl=segment_impl,
    )
    if dev.type == "cpu":
        PLAIN_CALLS["direct"] += 1
        return scan_agg_body(group_codes, bucket_ids, mask, values, literals, **kw)
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
    n_seg = n_groups * n_buckets
    arm = _arm(segment_impl, n_seg, n_agg_fields, need_minmax)
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
        n_seg, n_agg_fields, int(need_minmax), 0,
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launch_error(
        lib, lib.scan_agg_direct_launch(ctypes.byref(a), _ARM_CODE[arm], stream),
        "scan_agg_direct",
    )
    LAUNCHES["direct"][arm] += 1
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
    selective: bool = False,
    value_layouts: tuple = (),
    ts_layout: tuple = ("raw",),
    series_layout: tuple = ("raw",),
):
    """The packed cached serving kernel: resident series/ts/value part
    tuples, one session buffer [group map | allow list], one dyn buffer
    [literals bitcast | lo, hi, t0, width | row idx], one packed f32 out
    [counts bitcast | sums | mins | maxs] (mins/maxs only with
    ``need_minmax``).

    A CUDA input launches ``scan_agg_cached``; a CPU input runs
    ``_packed_body``."""
    dev = session.device
    values = tuple(values)
    layouts = value_layouts or tuple(_dense_layout(p) for p in values)
    kw = dict(
        n_groups=n_groups, n_buckets=n_buckets, n_agg_fields=n_agg_fields,
        numeric_filters=numeric_filters, need_minmax=need_minmax,
        segment_impl=segment_impl, selective=selective, value_layouts=layouts,
        ts_layout=ts_layout, series_layout=series_layout,
    )
    form = "cached_selective" if selective else "cached"
    if dev.type == "cpu":
        PLAIN_CALLS[form] += 1
        return _packed_body(series_parts, ts_parts, values, session, dyn, **kw)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check_tensor(session, "session", torch.int32, dev, 1)
    _check_tensor(dyn, "dyn", torch.int32, dev, 1)
    _check(session.shape[0] % 2 == 0, "session is [group map | allow list]")
    _check(len(values) == len(layouts), "one layout per value field")
    _check(len(values) <= MAX_FIELDS, f"at most {MAX_FIELDS} value fields")
    _check(n_agg_fields <= len(values), "more agg fields than value fields")
    n_f = len(numeric_filters)
    _check(dyn.shape[0] >= n_f + 4, "dyn holds literals and four scalars")
    n_seg = n_groups * n_buckets
    arm = _arm(segment_impl, n_seg, n_agg_fields, need_minmax)
    lib = _kernels()
    n_rows = layout_rows(series_parts, series_layout)
    a = _CachedArgs()
    a.series = _int_column(series_parts, series_layout, dev, "series")
    a.ts = _int_column(ts_parts, ts_layout, dev, "ts")
    _check(ts_layout[0] != "delta" or layout_rows(ts_parts, ts_layout) == n_rows, "ts rows")
    for f, (parts, lay) in enumerate(zip(values, layouts)):
        a.fields[f] = _value_column(parts, lay, dev, f"value[{f}]")
        if lay[0] in ("raw", "bf16"):
            _check(parts[0].shape[0] == n_rows, f"value[{f}] has {parts[0].shape[0]} rows")
    a.session = session.data_ptr()
    a.dyn = dyn.data_ptr()
    a.n_rows = dyn.shape[0] - n_f - 4 if selective else n_rows
    a.s1 = session.shape[0] // 2
    a.n_buckets = n_buckets
    a.device = dev.index if dev.index is not None else torch.cuda.current_device()
    a.filt = _filters(numeric_filters, len(values))
    planes = 3 if need_minmax else 1
    packed = torch.empty(n_seg * (1 + planes * n_agg_fields), dtype=torch.float32, device=dev)
    fs = n_agg_fields * n_seg
    packed[: n_seg + fs].zero_()  # counts (bits of int 0) and sums
    if need_minmax:
        packed[n_seg + fs : n_seg + 2 * fs].fill_(float("inf"))
        packed[n_seg + 2 * fs :].fill_(float("-inf"))
    base = packed.data_ptr()
    a.out = _Out(
        base, base + 4 * n_seg, base + 4 * (n_seg + fs), base + 4 * (n_seg + 2 * fs),
        n_seg, n_agg_fields, int(need_minmax), 0,
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launch_error(
        lib,
        lib.scan_agg_cached_launch(ctypes.byref(a), _ARM_CODE[arm], int(selective), stream),
        "scan_agg_cached",
    )
    LAUNCHES[form][arm] += 1
    return packed


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
    )
    t0 = _time.perf_counter()
    counts, sums, mins, maxs = timed_dispatch(
        "fused", lambda: fused_scan_agg(*args, **kwargs), device
    )
    state = state_to_host(counts, sums, mins, maxs)
    note_kernel_dispatch(
        ("fused", batch.values.shape, spec.n_groups, spec.n_buckets,
         spec.n_agg_fields, spec.numeric_filters, spec.need_minmax, impl),
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
