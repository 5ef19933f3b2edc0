"""The live-window ring fold and gather: ingest batch -> ring partials.

The live-window state (state/livewindow.py) keeps per-(table, window,
group-set) partial aggregates in a device ring: one row per time bucket
(slot = bucket_id % depth), one column per group. Here the ring is ONE
buffer per state, ``[5, depth, cap]`` 32-bit words: plane 0 the counts
(int32), planes 1-4 the sums, mins, maxs and counter increments (f32).

Two kernels, written by hand in CUDA (``csrc/livewindow.cu``):

- ``fold_group`` replaces ``horaedb_tpu/ops/livewindow.py:45`` ``_fold_body``
             for every state of a table at once: ONE launch resets the
             slots a head advance reuses, waits at a grid-wide barrier,
             then scatters every state's rows and counter pairs with
             atomics, updating each ring IN PLACE (the reference returns
             new arrays and folds one state a call);
- ``gather`` replaces ``horaedb_tpu/ops/livewindow.py:64`` ``_gather_body``:
             ring rows by slot, the first ``g`` group columns of all five
             planes into one contiguous ``[5, n, g]`` output, so a read is
             one device-to-host copy. One launch of ``ring_gather_rows``
             copies the 5 * n rows, a block a chunk of a row, 16 bytes a
             thread a load where the ring's cap, ``g`` and both bases allow.

Both are bound by bytes and, at a commit's or a refresh's size, by launch
latency. Each wrapper runs its plain PyTorch version for a CPU ring and
launches its kernel (or raises) for a CUDA ring; nothing falls back.

Layout contract of a state's fold (prepared by the state layer on host,
``FoldBatch``):

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
from typing import NamedTuple

import numpy as np
import torch

from .scan_agg import _from_key, _order_key

PLANES = 5

# Kernel launches, counted where each wrapper launches its kernel;
# PLAIN_CALLS counts the plain versions the wrappers ran for CPU rings (a
# group's fold counts one, as its launch does); STATES_FOLDED the states
# those folds carried.
LAUNCHES = {"fold": 0, "gather": 0}
PLAIN_CALLS = {"fold": 0, "gather": 0}
STATES_FOLDED = 0
# States dropped on the write path because their fold raised or missed the
# batch (state/livewindow.LiveWindowStore.on_write), one each.
FOLD_ERRORS = 0
# states of one fold launch (checked against the kernel at load)
MAX_GROUP = 32


def reset_counts() -> None:
    global FOLD_ERRORS, STATES_FOLDED
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0
    FOLD_ERRORS = STATES_FOLDED = 0


class FoldBatch(NamedTuple):
    """One state's prepared ingest batch (the layout contract above)."""

    reset_mask: np.ndarray
    slot: np.ndarray
    grp: np.ndarray
    val: np.ndarray
    pair_slot: np.ndarray
    pair_grp: np.ndarray
    pair_delta: np.ndarray


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


def _barrier_words(n_states: int) -> int:
    """Words of the barriers at the head of a group's words."""
    return 2 * -(-n_states // MAX_GROUP)


def pack_group(batches, out=None):
    """A group's fold inputs as one int32 word array: two zero barrier
    words per launch (``MAX_GROUP`` states each), then each state's
    ``pack_fold`` words. Returns (words, spans): spans[i] = (offset,
    n_reset, n_rows, n_pairs) of state i; ``out`` (a numpy view of a pinned
    buffer) receives the words when given."""
    head = _barrier_words(len(batches))
    total = head + sum(fold_words(*b) for b in batches)
    words = np.empty(total, dtype=np.int32) if out is None else out[:total]
    words[:head] = 0
    spans, at = [], head
    for b in batches:
        _, r, n, m = pack_fold(*b, out=words[at:])
        spans.append((at, r, n, m))
        at += r + 3 * n + 3 * m
    return words, spans


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


class _FoldState(ctypes.Structure):
    """Mirror of ``FoldState`` in ops/csrc/livewindow.cu."""

    _fields_ = [
        ("rings", ctypes.c_void_p),
        ("inp", ctypes.c_void_p),
        ("n_reset", ctypes.c_int),
        ("n_rows", ctypes.c_int),
        ("n_pairs", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("row_warp0", ctypes.c_int),
        ("pair_warp0", ctypes.c_int),
        ("pad_", ctypes.c_int),
        ("reset0", ctypes.c_longlong),
    ]


class _FoldArgs(ctypes.Structure):
    """Mirror of ``FoldArgs`` in ops/csrc/livewindow.cu."""

    _fields_ = [
        ("s", _FoldState * MAX_GROUP),
        ("barrier", ctypes.c_void_p),
        ("n_reset_cells", ctypes.c_longlong),
        ("n_states", ctypes.c_int),
        ("row_chunk", ctypes.c_int),
        ("pair_chunk", ctypes.c_int),
        ("row_warps", ctypes.c_int),
        ("pair_warps", ctypes.c_int),
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
        ("vec", ctypes.c_int),
        ("chunks", ctypes.c_int),
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
        for fn, st in (("livewindow_fold_launch", _FoldArgs),
                       ("livewindow_gather_launch", _GatherArgs)):
            getattr(lib, fn).argtypes = [ctypes.POINTER(st), ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        lib.livewindow_error_string.argtypes = [ctypes.c_int]
        lib.livewindow_error_string.restype = ctypes.c_char_p
        sizes = (ctypes.c_longlong * 4)()
        lib.livewindow_abi(sizes)
        want = [ctypes.sizeof(_FoldArgs), ctypes.sizeof(_GatherArgs), PLANES, MAX_GROUP]
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


def fold_group(rings_list, words: torch.Tensor, spans) -> None:
    """Fold each state's packed batch (``pack_group``'s layout, on the
    rings' device; ``spans`` as it returns them) into ``rings_list[i]`` in
    place: the plain version state by state for CPU rings; for CUDA rings
    one ``ring_fold`` launch a ``MAX_GROUP`` states, on the current stream.
    Every ring lies on one device."""
    _check(len(rings_list) == len(spans) > 0, "one span per ring, at least one")
    _check(words.dtype == torch.int32 and words.dim() == 1 and words.is_contiguous(),
           "words must be contiguous int32 [n]")
    dev = words.device
    head = _barrier_words(len(spans))
    for rings, (at, r, n, m) in zip(rings_list, spans):
        _check(_check_rings(rings) == dev, f"rings on {rings.device}, words on {dev}")
        _check(min(r, n, m) >= 0 and at >= head, "negative count or offset")
        _check(words.shape[0] >= at + r + 3 * n + 3 * m, "too few words")
        _check(max(r, n, m) < 2**31, "a state's batch must fit int32 counts")
    global STATES_FOLDED
    if dev.type == "cpu":
        PLAIN_CALLS["fold"] += 1
        for rings, (at, r, n, m) in zip(rings_list, spans):
            fold_plain(rings, words[at:], r, n, m)
        STATES_FOLDED += len(spans)
        return
    lib = _kernels()
    base = words.data_ptr()
    device = dev.index if dev.index is not None else torch.cuda.current_device()
    for c in range(head // 2):
        group = range(c * MAX_GROUP, min((c + 1) * MAX_GROUP, len(spans)))
        a = _FoldArgs()
        a.barrier, a.n_states, a.device = base + 8 * c, len(group), device
        for j, i in enumerate(group):
            at, r, n, m = spans[i]
            rings = rings_list[i]
            st = a.s[j]
            st.rings, st.inp = rings.data_ptr(), base + 4 * at
            st.n_reset, st.n_rows, st.n_pairs = r, n, m
            st.depth, st.cap = int(rings.shape[1]), int(rings.shape[2])
        _run(lib, "livewindow_fold_launch", a, "fold")
        LAUNCHES["fold"] += 1
    STATES_FOLDED += len(spans)


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


def fold_batches(rings_list, batches) -> None:
    """Fold each state's prepared ``FoldBatch`` into its ring (in place),
    every ring on one device: the inputs go to the device in one staging
    buffer and one copy, then ``fold_group``. Runs on the current stream;
    the write thread does not wait for the card."""
    from ..obs.device import timed_dispatch
    from ..utils.querystats import note_kernel_dispatch

    dev = rings_list[0].device
    host = _staged(_barrier_words(len(batches)) + sum(fold_words(*b) for b in batches), dev)
    _, spans = pack_group(batches, out=host.numpy())
    words = host.to(dev, non_blocking=True) if dev.type == "cuda" else host
    t0 = _time.perf_counter()
    timed_dispatch("state_fold", lambda: fold_group(rings_list, words, spans), dev)
    note_kernel_dispatch(("state_fold", len(batches)), _time.perf_counter() - t0,
                         kind="state_fold")


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
