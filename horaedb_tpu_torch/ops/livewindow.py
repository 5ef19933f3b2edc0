"""The live-window ring fold and gather: ingest batch -> ring partials.

The live-window state (state/livewindow.py) keeps per-(table, window,
group-set) partial aggregates in a device ring: one row per time bucket
(slot = bucket_id % depth), one column per group. Here the ring is ONE
buffer per state, ``[5, depth, cap]`` 32-bit words: plane 0 the counts
(int32), planes 1-4 the sums, mins, maxs and counter increments (f32).

Two kernels, written by hand in CUDA (``csrc/livewindow.cu``):

- ``fold``   replaces ``horaedb_tpu/ops/livewindow.py:45`` ``_fold_body``:
             reset the slots a head advance reuses (its own launch, only
             when a slot is named, so stream order puts it before the
             scatter), then scatter every row and counter pair with
             atomics, updating the ring IN PLACE (the reference returns
             new arrays);
- ``gather`` replaces ``horaedb_tpu/ops/livewindow.py:64`` ``_gather_body``:
             ring rows by slot, the first ``g`` group columns of all five
             planes into one contiguous ``[5, n, g]`` output, so a read is
             one device-to-host copy.

Both are bound by bytes and, at a commit's or a refresh's size, by launch
latency. Each wrapper runs its plain PyTorch version for a CPU ring and
launches its kernel (or raises) for a CUDA ring; nothing falls back.

Layout contract of a fold (prepared by the state layer on host):

- ``slot``  int32[N]: ring slot per row; ``depth`` for rows that must not
  fold (NULL values, below-tail late rows). As in the reference's scatter,
  an index in [-extent, -1] wraps once and any other out-of-range index
  drops the row;
- ``grp``   int32[N]: dense group index per row;
- ``val``   f32[N]: the value column;
- ``pair_slot``/``pair_grp``/``pair_delta``: the same encoding for the
  PromQL counter chain's write-time increments;
- ``reset_mask`` bool[depth]: ring slots a head advance reuses.

The reference pads the row arrays and the gather index to powers of two
for stable jit keys; nothing here is compiled per shape, so nothing is
padded.
"""

from __future__ import annotations

import ctypes
import time as _time

import numpy as np
import torch

from .scan_agg import _from_key, _order_key

PLANES = 5

# Kernel launches, counted where each wrapper launches its kernel;
# PLAIN_CALLS counts the plain versions the wrappers ran for CPU rings.
LAUNCHES = {"fold_reset": 0, "fold_scatter": 0, "gather": 0}
PLAIN_CALLS = {"fold": 0, "gather": 0}
# Folds that raised on the write path: each dropped its state
# (state/livewindow.LiveWindowStore.on_write).
FOLD_ERRORS = 0


def reset_counts() -> None:
    global FOLD_ERRORS
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0
    FOLD_ERRORS = 0


# ---- the ring buffer -------------------------------------------------------


def alloc_rings(depth: int, cap: int, device) -> torch.Tensor:
    """A fresh ring on ``device``: every cell (0, 0, +inf, -inf, 0)."""
    rings = torch.zeros((PLANES, depth, cap), dtype=torch.int32, device=device)
    f = rings.view(torch.float32)
    f[2] = float("inf")
    f[3] = float("-inf")
    return rings


def grow_rings(rings: torch.Tensor, cap: int) -> torch.Tensor:
    """A copy of ``rings`` widened to ``cap`` group columns; the new
    columns take the initial values."""
    out = alloc_rings(rings.shape[1], cap, rings.device)
    out[:, :, : rings.shape[2]] = rings
    return out


def planes(rings: torch.Tensor):
    """(counts int32, sums, mins, maxs, inc f32) views of a ring buffer or
    a gather's output."""
    f = rings.view(torch.float32)
    return rings[0], f[1], f[2], f[3], f[4]


def rings_nbytes(depth: int, cap: int) -> int:
    """Device bytes a ring occupies (4B cells, five planes)."""
    return depth * cap * 4 * PLANES


def pack_fold(reset_mask, slot, grp, val, pair_slot, pair_grp, pair_delta, out=None):
    """The fold's inputs as one int32 word array: reset slots, then slot,
    grp and val bits per row, then pair_slot, pair_grp and pair_delta bits
    per pair. Returns (words, n_reset, n_rows, n_pairs); ``out`` (a numpy
    view of a pinned buffer) receives the words when given."""
    reset = np.flatnonzero(np.asarray(reset_mask, dtype=np.bool_)).astype(np.int32)
    n, m = len(slot), len(pair_slot)
    total = len(reset) + 3 * n + 3 * m
    words = np.empty(total, dtype=np.int32) if out is None else out[:total]
    at = 0
    for part, dt in ((reset, np.int32), (slot, np.int32), (grp, np.int32), (val, np.float32),
                     (pair_slot, np.int32), (pair_grp, np.int32), (pair_delta, np.float32)):
        k = len(part)
        words[at:at + k] = np.asarray(part, dtype=dt).view(np.int32)
        at += k
    return words, len(reset), n, m


def fold_words(reset_mask, slot, grp, val, pair_slot, pair_grp, pair_delta) -> int:
    """Words ``pack_fold`` writes for these inputs."""
    return int(np.count_nonzero(reset_mask)) + 3 * len(slot) + 3 * len(pair_slot)


# ---- plain PyTorch versions ------------------------------------------------


def _scatter_cells(slot, grp, depth: int, cap: int):
    """Flat cell index of every row the reference's scatter keeps: an index
    in [-extent, -1] wraps once, anything else outside [0, extent) drops."""
    s = slot.long()
    g = grp.long()
    s = torch.where(s < 0, s + depth, s)
    g = torch.where(g < 0, g + cap, g)
    ok = (s >= 0) & (s < depth) & (g >= 0) & (g < cap)
    return (s * cap + g)[ok], ok


def _extreme_(plane: torch.Tensor, cells, vals, amin: bool) -> None:
    """plane[cell] = min (or max) of itself and the rows landing there:
    NaN propagates, -0.0 orders below +0.0."""
    flat = plane.reshape(-1)
    keys = _order_key(flat)
    keys.scatter_reduce_(0, cells, _order_key(vals), "amin" if amin else "amax")
    nan = torch.isnan(flat)
    nan[cells[torch.isnan(vals)]] = True
    res = torch.where(nan, torch.full_like(flat, float("nan")), _from_key(keys))
    flat.copy_(res)


def _add_(plane: torch.Tensor, cells, vals) -> None:
    """plane[cell] += the rows landing there, summed in float64 with the
    cell and rounded once to float32."""
    acc = plane.reshape(-1).double()
    acc.index_add_(0, cells, vals.double())
    plane.view(-1).copy_(acc)


def fold_plain(rings, words, n_reset: int, n_rows: int, n_pairs: int) -> None:
    """The fold's function in plain PyTorch, in place on ``rings``."""
    depth, cap = int(rings.shape[1]), int(rings.shape[2])
    counts, sums, mins, maxs, inc = planes(rings)
    if n_reset:
        r = words[:n_reset].long()
        r = r[(r >= 0) & (r < depth)]
        counts[r] = 0
        sums[r] = 0.0
        mins[r] = float("inf")
        maxs[r] = float("-inf")
        inc[r] = 0.0
    at = n_reset
    slot, grp = words[at:at + n_rows], words[at + n_rows:at + 2 * n_rows]
    val = words[at + 2 * n_rows:at + 3 * n_rows].view(torch.float32)
    at += 3 * n_rows
    cells, ok = _scatter_cells(slot, grp, depth, cap)
    v = val[ok]
    counts.view(-1).index_add_(0, cells, torch.ones_like(cells, dtype=torch.int32))
    _add_(sums, cells, v)
    _extreme_(mins, cells, v, amin=True)
    _extreme_(maxs, cells, v, amin=False)
    ps, pg = words[at:at + n_pairs], words[at + n_pairs:at + 2 * n_pairs]
    pd = words[at + 2 * n_pairs:at + 3 * n_pairs].view(torch.float32)
    cells, ok = _scatter_cells(ps, pg, depth, cap)
    _add_(inc, cells, pd[ok])


def gather_plain(rings, idx, g: int) -> torch.Tensor:
    """Ring rows by slot, clamped as the reference's gather clamps (below
    zero wraps once, then into [0, depth - 1]): [5, n, g]."""
    depth = int(rings.shape[1])
    i = idx.long()
    i = torch.where(i < 0, i + depth, i).clamp(0, depth - 1)
    return rings[:, i, :g].contiguous()


# ---- the CUDA kernels --------------------------------------------------------


class _FoldArgs(ctypes.Structure):
    """Mirror of ``FoldArgs`` in ops/csrc/livewindow.cu."""

    _fields_ = [
        ("rings", ctypes.c_void_p),
        ("inp", ctypes.c_void_p),
        ("n_reset", ctypes.c_longlong),
        ("n_rows", ctypes.c_longlong),
        ("n_pairs", ctypes.c_longlong),
        ("depth", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


class _GatherArgs(ctypes.Structure):
    """Mirror of ``GatherArgs`` in ops/csrc/livewindow.cu."""

    _fields_ = [
        ("rings", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
        ("depth", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("g", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


_lib = None


def _kernels():
    """The built kernel library (nvcc at first use), with its C signatures
    declared and its struct layouts checked against the mirrors."""
    global _lib
    if _lib is None:
        from ._build import load

        lib = load("livewindow")
        lib.livewindow_abi.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.livewindow_abi.restype = ctypes.c_int
        for fn, st in (("livewindow_reset_launch", _FoldArgs),
                       ("livewindow_scatter_launch", _FoldArgs),
                       ("livewindow_gather_launch", _GatherArgs)):
            getattr(lib, fn).argtypes = [ctypes.POINTER(st), ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        lib.livewindow_error_string.argtypes = [ctypes.c_int]
        lib.livewindow_error_string.restype = ctypes.c_char_p
        sizes = (ctypes.c_longlong * 3)()
        lib.livewindow_abi(sizes)
        want = [ctypes.sizeof(_FoldArgs), ctypes.sizeof(_GatherArgs), PLANES]
        if list(sizes) != want:
            raise RuntimeError(f"livewindow ABI mismatch: kernel {list(sizes)} vs {want}")
        _lib = lib
    return _lib


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"livewindow kernel input: {what}")


def _check_rings(rings) -> torch.device:
    dev = rings.device
    _check(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    _check(rings.dtype == torch.int32 and rings.dim() == 3 and rings.shape[0] == PLANES,
           f"rings must be int32 [{PLANES}, depth, cap], got {rings.dtype} {tuple(rings.shape)}")
    _check(rings.is_contiguous(), "rings must be contiguous")
    _check(rings.shape[1] > 0 and rings.shape[2] > 0, "empty ring")
    return dev


def _run(lib, fn: str, args, what: str) -> None:
    stream = torch.cuda.current_stream(args.device).cuda_stream
    err = getattr(lib, fn)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(
            f"livewindow {what} launch failed: {lib.livewindow_error_string(err).decode()} ({err})"
        )


def fold(rings: torch.Tensor, words: torch.Tensor, n_reset: int, n_rows: int,
         n_pairs: int) -> None:
    """Fold one packed batch (``pack_fold``'s layout, on the ring's device)
    into ``rings`` in place: the plain version for a CPU ring; for a CUDA
    ring the reset kernel (only when ``n_reset``) and then the scatter
    kernel, on the current stream."""
    dev = _check_rings(rings)
    _check(words.dtype == torch.int32 and words.dim() == 1 and words.is_contiguous(),
           "words must be contiguous int32 [n]")
    _check(words.device == dev, f"words on {words.device}, rings on {dev}")
    _check(min(n_reset, n_rows, n_pairs) >= 0, "negative count")
    _check(words.shape[0] >= n_reset + 3 * n_rows + 3 * n_pairs, "too few words")
    if dev.type == "cpu":
        PLAIN_CALLS["fold"] += 1
        fold_plain(rings, words, n_reset, n_rows, n_pairs)
        return
    lib = _kernels()
    a = _FoldArgs()
    a.rings, a.inp = rings.data_ptr(), words.data_ptr()
    a.n_reset, a.n_rows, a.n_pairs = n_reset, n_rows, n_pairs
    a.depth, a.cap = int(rings.shape[1]), int(rings.shape[2])
    a.device = dev.index if dev.index is not None else torch.cuda.current_device()
    if n_reset:
        _run(lib, "livewindow_reset_launch", a, "reset")
        LAUNCHES["fold_reset"] += 1
    _run(lib, "livewindow_scatter_launch", a, "scatter")
    LAUNCHES["fold_scatter"] += 1


def gather(rings: torch.Tensor, idx: torch.Tensor, g: int) -> torch.Tensor:
    """[5, n, g] int32: ring rows ``idx`` (clamped as the reference's
    gather clamps), first ``g`` group columns. The plain version for a CPU
    ring; the gather kernel for a CUDA ring, on the current stream."""
    dev = _check_rings(rings)
    _check(idx.dtype == torch.int32 and idx.dim() == 1 and idx.is_contiguous(),
           "idx must be contiguous int32 [n]")
    _check(idx.device == dev, f"idx on {idx.device}, rings on {dev}")
    _check(0 < g <= rings.shape[2], f"g {g} outside [1, {rings.shape[2]}]")
    n = idx.shape[0]
    _check(n > 0, "empty gather")
    if dev.type == "cpu":
        PLAIN_CALLS["gather"] += 1
        return gather_plain(rings, idx, g)
    lib = _kernels()
    out = torch.empty((PLANES, n, g), dtype=torch.int32, device=dev)
    a = _GatherArgs()
    a.rings, a.idx, a.out = rings.data_ptr(), idx.data_ptr(), out.data_ptr()
    a.n, a.depth, a.cap, a.g = n, int(rings.shape[1]), int(rings.shape[2]), g
    a.device = dev.index if dev.index is not None else torch.cuda.current_device()
    _run(lib, "livewindow_gather_launch", a, "gather")
    LAUNCHES["gather"] += 1
    return out


# ---- host entry points (the state layer's calls) ----------------------------


def _staged(n_words: int, device) -> torch.Tensor:
    """A host int32 buffer: pinned when it feeds a card (an asynchronous
    copy), plain for a CPU ring."""
    return torch.empty(n_words, dtype=torch.int32, pin_memory=device.type == "cuda")


def fold_batch(rings, reset_mask, slot, grp, val, pair_slot, pair_grp, pair_delta):
    """Fold one prepared ingest batch into ``rings`` (in place; returned):
    the inputs go to the ring's device in one copy, then ``fold``. Runs on
    the current stream; the write thread does not wait for the card."""
    from ..obs.device import timed_dispatch
    from ..utils.querystats import note_kernel_dispatch

    dev = rings.device
    depth, cap = int(rings.shape[1]), int(rings.shape[2])
    host = _staged(fold_words(reset_mask, slot, grp, val, pair_slot, pair_grp, pair_delta), dev)
    _, n_reset, n, m = pack_fold(reset_mask, slot, grp, val, pair_slot, pair_grp, pair_delta,
                                 out=host.numpy())
    words = host.to(dev, non_blocking=True) if dev.type == "cuda" else host
    t0 = _time.perf_counter()
    timed_dispatch("state_fold", lambda: fold(rings, words, n_reset, n, m), dev)
    note_kernel_dispatch(("state_fold", depth, cap), _time.perf_counter() - t0,
                         kind="state_fold")
    return rings


def gather_buckets(rings, slots, g: int | None = None):
    """Read ``slots`` (ring slots) out of the ring: one gather launch and
    one host fetch. Returns host numpy arrays (counts, sums, mins, maxs,
    inc), each [len(slots), g] (``g`` defaults to the ring's width)."""
    from ..obs.device import timed_dispatch

    dev = rings.device
    g = int(rings.shape[2]) if g is None else int(g)
    idx_host = _staged(len(slots), dev)
    idx_host.numpy()[:] = np.asarray(slots, dtype=np.int32)
    if dev.type == "cuda":
        idx = idx_host.to(dev, non_blocking=True)
        out = timed_dispatch("state_fold", lambda: gather(rings, idx, g), dev)
        host = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()  # the one host round trip
    else:
        host = timed_dispatch("state_fold", lambda: gather(rings, idx_host, g), dev)
    return tuple(p.numpy() for p in planes(host))
