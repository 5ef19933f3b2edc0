"""Device k-way merge + dedup as one sort kernel
(ref: analytic_engine/src/row_iter/{merge.rs,dedup.rs} and the compaction
runner's merge loop — the BASELINE.json "k-way merge-dedup lifted onto the
device").

The reference merges k sorted runs with a BinaryHeap, comparing rows one at
a time. On the card the same job is a data-parallel sort: concatenate the
runs, sort by (primary key asc, sequence desc), and collapse duplicate keys
with a shift-compare mask. The sort is a stable LSD radix sort written by
hand for Hopper (``ops/csrc/merge_dedup.cu``) with the dedup mask as its
epilogue — no per-row control flow anywhere.

Key words are the whole game: the sort's cost scales with the number of
u32 words it carries per row. A merge's actual entropy is small —
timestamps span one segment window (~2^23 ms) and sequences span the input
files (~2^7) — so the hot path packs ``(ts - ts_min, seq_max - seq)`` into
ONE u32 word picked by measured bit widths, keeps the 64-bit tsid hash as an
(hi, lo) pair, and sorts 3 key words: tsid_hi, tsid_lo, packed rest. The
two wider fallbacks (u64 rest pair; the fully general split of every
column) engage only when the measured spans don't fit.

64-bit keys are split into order-preserving (hi, lo) uint32 pairs on host
(ops.encoding.split_*), and the sort orders the pair lexicographically.
Every word compares UNSIGNED: the plain versions widen the uint32 bits
(held in int32 tensors) to int64 before sorting.

Newest-wins ties without a tie-break word: the input is REVERSED on host,
and the sort is stable — among rows with identical (key, seq) the LAST
input row sorts first, which is what the reference's overwrite-in-order
memtable semantics require. The dispatcher stages only the real rows.
Words padded past ``n_valid`` (the sharded merge pads each shard) carry
all-ones keys (sort to the tail) and are identified exactly by their
sorted row index >= n_valid — no dedicated is_pad word, and a real row
whose key words are all ones still wins its tie against the pads because
it precedes them in input order.

Four kinds, each with a plain PyTorch version beside the kernel, behind
one wrapper, ``sort_dedup(kind, ...)``: it runs the plain version for CPU
tensors, launches the kernel for CUDA tensors, and does nothing else.

- ``rk``  (tsid-rank, ts, seq desc) packed into one u64 — 2 key words;
- ``f32`` (tsid_hi, tsid_lo, packed rest) — 3 key words, input reversed;
- ``f64`` the same with a u64 rest pair — 4 key words;
- ``gen`` (is_pad, tsid, ts, ~seq) split in 7 words plus the negated row
  index as the last key.

The reference compiles its sort in the background and reads on the host
until it lands; the kernel here builds once, at first use, and a failed
build raises — a merge never moves to the host lexsort.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np
import torch

from .encoding import split_i64_sortable, split_u64

_U32_MAX = 0xFFFFFFFF

# The kernel's constants (ops/csrc/merge_dedup.cu): key words per row, the
# digit width (four 8-bit digits a word), radix passes (one a digit), rows
# per tile, the executed passes after a word's last that stop it being
# carried (the epilogue gathers it), and a call's launches besides its
# passes (the memset, init_hist, plan_passes, the epilogue).
MAX_WORDS = 7
DIGIT_BITS = 8
RADIX = 1 << DIGIT_BITS
DIGITS_PER_WORD = 32 // DIGIT_BITS
MAX_PASSES = DIGITS_PER_WORD * MAX_WORDS
TILE = 5120
DROP_AFTER = 5
FIXED_LAUNCHES = 4

KINDS = ("rk", "f32", "f64", "gen")
# per kind: (key words, sort sequence reversed, perm = n_valid - 1 - idx,
# pads told by word 0 == 1 rather than by idx >= n_valid)
_SPEC = {
    "rk": (2, False, False, False),
    "f32": (3, False, True, False),
    "f64": (4, False, True, False),
    "gen": (7, True, False, True),
}

# Launches per kind, counted where the wrapper launches its kernel;
# PLAIN_CALLS counts the plain versions the wrappers ran for CPU tensors.
LAUNCHES = {k: 0 for k in KINDS}
PLAIN_CALLS = {k: 0 for k in KINDS}

_log = logging.getLogger(__name__)


def reset_counts() -> None:
    for k in KINDS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


# ---- plain PyTorch versions --------------------------------------------------


def _widen(w: torch.Tensor) -> torch.Tensor:
    """uint32 bits held in int32 as int64 in [0, 2**32): unsigned order."""
    return w.long() & _U32_MAX


def _i32(mask: int) -> int:
    """A uint32 mask as the int32 with the same bits."""
    mask = int(mask) & _U32_MAX
    return mask - (1 << 32) if mask >= 1 << 31 else mask


def _lsd_sort(words, idx: torch.Tensor) -> torch.Tensor:
    """Stable sort of positions ``idx`` by ``words`` (most significant
    first): one stable pass per word, least significant first."""
    for w in reversed(words):
        idx = idx[torch.sort(_widen(w)[idx], stable=True).indices]
    return idx


def _keep(sorted_words, masks, dedup: bool) -> torch.Tensor:
    """First row of each run of equal masked keys (all rows without
    ``dedup``)."""
    n = sorted_words[0].shape[0]
    dev = sorted_words[0].device
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    if not dedup or n < 2:
        return keep
    same = torch.ones(n - 1, dtype=torch.bool, device=dev)
    for s, m in zip(sorted_words, masks):
        if int(m) & _U32_MAX:
            same &= ((s[1:] ^ s[:-1]) & _i32(m)) == 0
    keep[1:] = ~same
    return keep


def ranked_sort_dedup(key_hi, key_lo, mask_hi, mask_lo, n_valid: int, dedup: bool):
    """(tsid-rank, ts, seq desc) packed into one u64 (hi, lo) pair — 2 key
    words. The reference's sort is UNSTABLE: callers guarantee composite
    uniqueness (deduped sorted runs with distinct per-file sequences), so
    every correct sort gives the same ``perm[:n_valid]``. ``mask_*`` zero
    the seq bits for the dedup compare. Pads carry all-ones keys (> any
    real composite, which fits 63 bits) and are identified by sorted
    index >= n_valid."""
    n = key_hi.shape[0]
    idx = _lsd_sort((key_hi, key_lo), torch.arange(n, device=key_hi.device))
    keep = _keep((key_hi[idx], key_lo[idx]), (mask_hi, mask_lo), dedup)
    return idx.int(), keep & (idx < n_valid)


def fused32_sort_dedup(tsid_hi, tsid_lo, rest, rest_mask, n_valid: int, dedup: bool):
    """Sort by (tsid, packed (ts, seq desc)) — 3 key words. The body the
    distributed merge reuses, so the reversal/pad/mask contract lives in
    one place.

    Input arrives REVERSED (last original row first); the stable sort
    therefore resolves exact-duplicate rows to the newest input row, and
    ``perm`` recovers original indices as ``n_valid - 1 - sorted_idx``.
    ``rest_mask`` zeroes the seq bits so the dedup compare sees (ts) only.
    """
    n = tsid_hi.shape[0]
    idx = _lsd_sort((tsid_hi, tsid_lo, rest), torch.arange(n, device=tsid_hi.device))
    keep = _keep((tsid_hi[idx], tsid_lo[idx], rest[idx]), (_U32_MAX, _U32_MAX, rest_mask),
                 dedup)
    return (n_valid - 1 - idx).int(), keep & (idx < n_valid)


def fused64_sort_dedup(tsid_hi, tsid_lo, rest_hi, rest_lo, mask_hi, mask_lo,
                       n_valid: int, dedup: bool):
    """Wide-span variant: packed (ts, seq desc) as a u64 (hi, lo) pair —
    4 key words. Same reversal/stability contract as fused32."""
    n = tsid_hi.shape[0]
    words = (tsid_hi, tsid_lo, rest_hi, rest_lo)
    idx = _lsd_sort(words, torch.arange(n, device=tsid_hi.device))
    keep = _keep(tuple(w[idx] for w in words), (_U32_MAX, _U32_MAX, mask_hi, mask_lo), dedup)
    return (n_valid - 1 - idx).int(), keep & (idx < n_valid)


def general_sort_dedup(is_pad, tsid_hi, tsid_lo, ts_hi, ts_lo, negseq_hi, negseq_lo,
                       dedup: bool):
    """Fully-general fallback (every 64-bit column split, 7 key words):
    engages only when the measured ts/seq spans exceed 64 packed bits.
    Ties on (key, seq) — duplicate keys in ONE write batch share a WAL
    sequence — resolve to the LAST input row: the NEGATED index is the
    final key, and perm is its complement. Pads carry is_pad = 1."""
    n = is_pad.shape[0]
    negidx = (n - 1) - torch.arange(n, device=is_pad.device)
    idx = torch.sort(negidx, stable=True).indices  # the last key first
    words = (is_pad, tsid_hi, tsid_lo, ts_hi, ts_lo, negseq_hi, negseq_lo)
    idx = _lsd_sort(words, idx)
    masks = (0, _U32_MAX, _U32_MAX, _U32_MAX, _U32_MAX, 0, 0)
    keep = _keep(tuple(w[idx] for w in words), masks, dedup)
    return ((n - 1) - negidx[idx]).int(), keep & (is_pad[idx] == 0)


def _plain(kind: str, words, masks, n_valid: int, dedup: bool):
    if kind == "rk":
        return ranked_sort_dedup(*words, *masks, n_valid, dedup)
    if kind == "f32":
        return fused32_sort_dedup(*words, masks[2], n_valid, dedup)
    if kind == "f64":
        return fused64_sort_dedup(*words, masks[2], masks[3], n_valid, dedup)
    return general_sort_dedup(*words, dedup)


# ---- the CUDA kernel -----------------------------------------------------------


class _SortArgs(ctypes.Structure):
    """Mirror of ``SortArgs`` in ops/csrc/merge_dedup.cu."""

    _fields_ = [
        ("inp", ctypes.c_void_p * MAX_WORDS),
        ("buf", (ctypes.c_void_p * (MAX_WORDS + 1)) * 2),
        ("ghist", ctypes.c_void_p),
        ("bases", ctypes.c_void_p),
        ("status", ctypes.c_void_p),
        ("tile_ctr", ctypes.c_void_p),
        ("ran", ctypes.c_void_p),
        ("perm", ctypes.c_void_p),
        ("keep", ctypes.c_void_p),
        ("passes", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
        ("n_sort", ctypes.c_longlong),
        ("n_valid", ctypes.c_longlong),
        ("n_tiles", ctypes.c_longlong),
        ("mask", ctypes.c_uint32 * MAX_WORDS),
        ("n_words", ctypes.c_int),
        ("reversed", ctypes.c_int),
        ("perm_mode", ctypes.c_int),
        ("pad_mode", ctypes.c_int),
        ("dedup", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


_lib = None


def _kernels():
    """The built kernel library (nvcc at first use), with its C signatures
    declared and its struct layout checked against ``_SortArgs``."""
    global _lib
    if _lib is None:
        from ._build import load

        lib = load("merge_dedup")
        lib.merge_dedup_abi.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.merge_dedup_abi.restype = ctypes.c_int
        lib.merge_dedup_launch.argtypes = [ctypes.POINTER(_SortArgs), ctypes.c_void_p]
        lib.merge_dedup_launch.restype = ctypes.c_int
        lib.merge_dedup_error_string.argtypes = [ctypes.c_int]
        lib.merge_dedup_error_string.restype = ctypes.c_char_p
        sizes = (ctypes.c_longlong * 6)()
        lib.merge_dedup_abi(sizes)
        want = [ctypes.sizeof(_SortArgs), MAX_WORDS, MAX_PASSES, TILE, DROP_AFTER,
                FIXED_LAUNCHES]
        if list(sizes) != want:
            raise RuntimeError(f"merge_dedup ABI mismatch: kernel {list(sizes)} vs {want}")
        _lib = lib
    return _lib


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"merge_dedup kernel input: {what}")


def _align(n: int) -> int:
    return -(-n // 64) * 64  # int32 elements: 256-byte sub-buffers


def sort_rows(kind: str, n: int, n_valid: int) -> int:
    """Rows the kernel sorts: the real rows (rk/f32/f64 place their pads
    after them without sorting them); gen sorts every row."""
    return n if _SPEC[kind][3] else n_valid


def scratch_layout(kind: str, n_sort: int) -> list[tuple[str, int]]:
    """The kernel's scratch as (name, int32 elements) in address order:
    the ping-pong buffers of the key words and the row index, then the
    region one memset zeroes (the digit counts of every pass, the passes'
    tile counters and the mask of the passes that run, a 64-bit look-back
    status word a tile and digit), then the digits' bases. Each part starts
    256 bytes aligned."""
    n_words = _SPEC[kind][0]
    n_tiles = -(-n_sort // TILE)
    return ([(f"buf{s}.{i}", _align(n_sort)) for s in range(2) for i in range(n_words + 1)]
            + [("ghist", _align(MAX_PASSES * RADIX)), ("tile_ctr", _align(MAX_PASSES + 1)),
               ("status", _align(2 * RADIX * n_tiles)), ("bases", _align(MAX_PASSES * RADIX))])


def _scratch(layout, dev) -> torch.Tensor:
    """Uninitialised scratch for ``layout``: the call zeroes what must
    start at zero, so a call may find any earlier call's words in it."""
    return torch.empty(sum(s for _, s in layout), dtype=torch.int32, device=dev)


def passes_of(kind: str) -> int:
    """Radix passes the kind's key words take before any is skipped."""
    return DIGITS_PER_WORD * _SPEC[kind][0]


def launches_of(kind: str) -> int:
    """Launches a call of the kind makes on the card: a sort_pass a radix
    pass (a skipped pass returns at once) and FIXED_LAUNCHES."""
    return passes_of(kind) + FIXED_LAUNCHES


def _launch(kind: str, words, masks, n_valid: int, dedup: bool) -> torch.Tensor:
    """Launch the sort of ``kind`` on the words' card (current stream).
    Returns one uint8 buffer: perm int32[n], keep bool[n], then one byte
    per radix pass (1 where the pass ran)."""
    n_words, reverse, perm_mode, pad_mode = _SPEC[kind]
    dev = words[0].device
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(len(words) == n_words and len(masks) == n_words, f"{kind} takes {n_words} words")
    n = words[0].shape[0]
    _check(0 < n < 2**31, f"{n} rows: perm is int32")
    _check(0 <= n_valid <= n, f"n_valid {n_valid} outside [0, {n}]")
    for i, w in enumerate(words):
        _check(isinstance(w, torch.Tensor) and w.device == dev, f"word {i} not on {dev}")
        _check(w.dtype == torch.int32, f"word {i} is {w.dtype}, expected int32 (uint32 bits)")
        _check(w.dim() == 1 and w.shape[0] == n and w.is_contiguous(),
               f"word {i} must be contiguous [{n}]")
    lib = _kernels()
    n_sort = sort_rows(kind, n, n_valid)
    layout = scratch_layout(kind, n_sort)
    scratch = _scratch(layout, dev)
    ptrs, at = {}, scratch.data_ptr()
    for name, s in layout:
        ptrs[name] = at
        at += 4 * s
    out = torch.empty(5 * n + MAX_PASSES, dtype=torch.uint8, device=dev)
    a = _SortArgs()
    for i, w in enumerate(words):
        a.inp[i] = w.data_ptr()
    for s in range(2):
        for i in range(n_words + 1):
            a.buf[s][i] = ptrs[f"buf{s}.{i}"]
    a.ghist, a.bases, a.status = ptrs["ghist"], ptrs["bases"], ptrs["status"]
    a.tile_ctr, a.ran = ptrs["tile_ctr"], ptrs["tile_ctr"] + 4 * MAX_PASSES
    a.perm = out.data_ptr()
    a.keep = out.data_ptr() + 4 * n
    a.passes = out.data_ptr() + 5 * n
    a.n, a.n_sort, a.n_valid, a.n_tiles = n, n_sort, n_valid, -(-n_sort // TILE)
    for i, m in enumerate(masks):
        a.mask[i] = int(m) & _U32_MAX
    a.n_words, a.reversed, a.perm_mode, a.pad_mode = n_words, reverse, perm_mode, pad_mode
    a.dedup = int(dedup)
    a.device = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.merge_dedup_launch(ctypes.byref(a), stream)
    if err != 0:
        raise RuntimeError(
            f"merge_dedup {kind} launch failed: "
            f"{lib.merge_dedup_error_string(err).decode()} ({err})"
        )
    LAUNCHES[kind] += 1
    return out


def unpack(out: torch.Tensor, n: int):
    """(perm int32[n], keep bool[n], passes uint8[MAX_PASSES]) views of a
    sort's output buffer."""
    return (out[: 4 * n].view(torch.int32), out[4 * n: 5 * n].view(torch.bool),
            out[5 * n:])


def sort_dedup(kind: str, words, masks, n_valid: int, dedup: bool) -> torch.Tensor:
    """The wrapper of every kind. Returns one uint8 buffer on the words'
    device holding perm, keep and the radix passes taken (see ``unpack``):
    CPU tensors run the plain version (no passes), CUDA tensors launch the
    kernel."""
    if words[0].device.type == "cpu":
        PLAIN_CALLS[kind] += 1
        perm, keep = _plain(kind, words, masks, n_valid, dedup)
        return torch.cat([perm.view(torch.uint8), keep.view(torch.uint8),
                          torch.zeros(MAX_PASSES, dtype=torch.uint8)])
    return _launch(kind, words, masks, n_valid, dedup)


# ---- host packing ----------------------------------------------------------------


def _pack_rest(ts64: np.ndarray, seq64: np.ndarray):
    """Measure ts/seq spans and pack both into the narrowest key that
    preserves (ts asc, seq desc) order. Returns (kind, payload):

    - ("f32", (rest_u32, mask_u32))          spans fit 32 bits together
    - ("f64", (hi, lo, mask_hi, mask_lo))    spans fit 64 bits together
    - ("gen", None)                          fall back to the general split
    """
    ts_min = np.int64(ts64.min())
    seq_max = np.uint64(seq64.max())
    # Python-int span: int64-wide ranges must not wrap (see pack_ranked_key).
    ts_bits = (int(ts64.max()) - int(ts_min)).bit_length()
    seq_bits = int(seq_max - np.uint64(seq64.min())).bit_length()
    if ts_bits + seq_bits <= 32:
        rest = (
            (ts64 - ts_min).astype(np.uint32) << np.uint32(seq_bits)
        ) | (seq_max - seq64).astype(np.uint32)
        mask = np.uint32(0xFFFFFFFF) ^ np.uint32((1 << seq_bits) - 1)
        return "f32", (rest, mask)
    if ts_bits + seq_bits <= 64:
        rest64 = (
            (ts64 - ts_min).astype(np.uint64) << np.uint64(seq_bits)
        ) | (seq_max - seq64)
        hi, lo = split_u64(rest64)
        if seq_bits >= 32:
            mask_lo = np.uint32(0)
            mask_hi = np.uint32(0xFFFFFFFF) ^ np.uint32((1 << (seq_bits - 32)) - 1)
        else:
            mask_lo = np.uint32(0xFFFFFFFF) ^ np.uint32((1 << seq_bits) - 1)
            mask_hi = np.uint32(0xFFFFFFFF)
        return "f64", (hi, lo, mask_hi, mask_lo)
    return "gen", None


def pack_ranked_key(
    tsid_rank: np.ndarray,
    ts64: np.ndarray,
    seq64: np.ndarray,
    n_ranks: int,
):
    """Pack (tsid-rank, ts, seq desc) into ONE order-preserving u64 per
    row — built ONCE for a whole merge; the chunked pipeline then ships
    8 bytes/row and sorts 2 u32 keys. None when the measured bit widths
    exceed 63 (the all-ones pad value must stay strictly greater).
    Returns (composite u64 array, dedup mask_hi, mask_lo) — the masks
    zero the seq bits so the dedup compare sees (rank, ts) only."""
    ts_min = np.int64(ts64.min())
    seq_max = np.uint64(seq64.max())
    # Python-int arithmetic: an int64 span >= 2^63 must NOT wrap (a
    # wrapped width would pick a too-narrow kernel and mis-merge).
    ts_bits = (int(ts64.max()) - int(ts_min)).bit_length()
    seq_bits = int(seq_max - np.uint64(seq64.min())).bit_length()
    rank_bits = max(1, int(n_ranks - 1).bit_length())
    if rank_bits + ts_bits + seq_bits > 63:
        return None
    comp = (
        (tsid_rank.astype(np.uint64) << np.uint64(ts_bits + seq_bits))
        | ((ts64 - ts_min).astype(np.uint64) << np.uint64(seq_bits))
        | (seq_max - seq64)
    )
    if seq_bits >= 32:
        mask_lo = np.uint32(0)
        mask_hi = np.uint32(0xFFFFFFFF) ^ np.uint32((1 << (seq_bits - 32)) - 1)
    else:
        mask_lo = np.uint32(0xFFFFFFFF) ^ np.uint32((1 << seq_bits) - 1)
        mask_hi = np.uint32(0xFFFFFFFF)
    return comp, mask_hi, mask_lo


# ---- dispatch ----------------------------------------------------------------------


class MergeHandle:
    """An in-flight merge: the sort's output buffer (see ``sort_dedup``)
    over ``n`` real rows. On the card the upload, the sort and the copy of
    its result back to pinned host memory were queued on the device's
    current stream, and an event marks their end; ``get()`` waits on the
    event. Lets a caller pipeline the host-side payload gather of chunk i
    with the device sort of chunk i+1."""

    __slots__ = ("_out", "_n", "_event", "_kind")

    def __init__(self, out: torch.Tensor, n: int, kind: str | None = None,
                 event=None) -> None:
        self._out, self._n, self._kind, self._event = out, n, kind, event

    def get(self) -> tuple[np.ndarray, np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        buf = self._out.numpy()
        n = self._n
        if self._event is not None:
            # a pass whose digit is the same in every row is skipped on the card
            _log.debug("merge_dedup %s: %d rows, %d radix passes", self._kind, n,
                       int(buf[5 * n:].sum()))
        return buf[: 4 * n].view(np.int32), buf[4 * n: 5 * n].view(np.bool_)


_NO_ROWS = torch.zeros(MAX_PASSES, dtype=torch.uint8)


def stage(cols, n: int, pinned: bool) -> torch.Tensor:
    """The key word columns of ``n`` rows in one int32 [words, n] host
    tensor (pinned for a card): the real rows only, no pads."""
    if n >= 2**31:
        raise ValueError(f"{n} rows: perm is int32")
    host = torch.empty((len(cols), n), dtype=torch.int32, pin_memory=pinned)
    view = host.numpy().view(np.uint32)
    for w, col in enumerate(cols):
        view[w] = col
    return host


def _dispatch(kind: str, cols, masks, n: int, dedup: bool, device) -> MergeHandle:
    """Stage the key words, upload them without blocking, and queue the
    sort and the copy of its result back."""
    device = torch.device(device)
    if n == 0:
        return MergeHandle(_NO_ROWS, 0)
    host = stage(cols, n, pinned=device.type == "cuda")
    if device.type == "cpu":
        return MergeHandle(sort_dedup(kind, host.unbind(0), masks, n, dedup), n, kind)
    from ..obs.device import timed_dispatch

    with torch.cuda.device(device):
        words = host.to(device, non_blocking=True).unbind(0)
        out = timed_dispatch(
            "merge_dedup", lambda: sort_dedup(kind, words, masks, n, dedup), device
        )
        back = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
        back.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return MergeHandle(back, n, kind, event)


def pack_composite(comp: np.ndarray, mask_hi, mask_lo):
    """The rk kind's inputs from a pre-packed composite (see
    pack_ranked_key): (kind, key word columns, dedup masks)."""
    hi, lo = split_u64(comp)
    return "rk", (hi, lo), (mask_hi, mask_lo)


def pack_inputs(
    tsid: np.ndarray,
    ts: np.ndarray,
    seq: np.ndarray,
    tsid_rank: np.ndarray | None = None,
    n_ranks: int = 0,
    unique: bool = False,
):
    """Host packing of a merge: the narrowest kind the measured spans
    allow, and its (kind, key word columns, dedup masks)."""
    ts64 = ts.astype(np.int64, copy=False)
    seq64 = seq.astype(np.uint64, copy=False)
    if tsid_rank is not None and unique:
        packed_key = pack_ranked_key(tsid_rank, ts64, seq64, n_ranks)
        if packed_key is not None:
            return pack_composite(*packed_key)

    kind, packed = _pack_rest(ts64, seq64)
    n = len(tsid)
    if kind == "gen":
        tsid_hi, tsid_lo = split_u64(tsid)
        ts_hi, ts_lo = split_i64_sortable(ts64)
        negseq_hi, negseq_lo = split_u64(~seq64)
        cols = (np.zeros(n, dtype=np.uint32), tsid_hi, tsid_lo, ts_hi, ts_lo, negseq_hi,
                negseq_lo)
        masks = (0, _U32_MAX, _U32_MAX, _U32_MAX, _U32_MAX, 0, 0)
        return kind, cols, masks
    # Reverse BEFORE splitting: stable sort + reversed input
    # = newest input row first among exact-duplicate (key, seq) rows.
    rev = slice(None, None, -1)
    tsid_hi, tsid_lo = split_u64(tsid[rev])
    if kind == "f32":
        rest, mask = packed
        cols, masks = (tsid_hi, tsid_lo, rest[rev]), (_U32_MAX, _U32_MAX, mask)
    else:
        hi, lo, mask_hi, mask_lo = packed
        cols = (tsid_hi, tsid_lo, hi[rev], lo[rev])
        masks = (_U32_MAX, _U32_MAX, mask_hi, mask_lo)
    return kind, cols, masks


def merge_dedup_dispatch_packed(
    comp: np.ndarray,
    mask_hi,
    mask_lo,
    dedup: bool = True,
    *,
    device,
) -> MergeHandle:
    """Dispatch the 2-key kind on a pre-packed composite (see
    pack_ranked_key). Caller guarantees composite uniqueness."""
    kind, cols, masks = pack_composite(comp, mask_hi, mask_lo)
    return _dispatch(kind, cols, masks, len(comp), dedup, device)


def merge_dedup_dispatch(
    tsid: np.ndarray,
    ts: np.ndarray,
    seq: np.ndarray,
    dedup: bool = True,
    tsid_rank: np.ndarray | None = None,
    n_ranks: int = 0,
    unique: bool = False,
    *,
    device,
) -> MergeHandle:
    """Asynchronously dispatch the merge sort on ``device``; see
    merge_dedup_permutation for semantics. The returned handle's ``get()``
    yields ``(perm, keep)``.

    ``tsid_rank``/``n_ranks``: dense ranks of each row's tsid in the
    merge's sorted tsid universe (compaction builds them for free from
    its sorted input runs). ``unique=True`` asserts no two rows share
    (tsid, ts, seq) — true for deduped runs with distinct per-file
    sequences. Together they unlock the 2-key packed kind when the
    measured bit widths fit 63 bits."""
    n = len(tsid)
    if n == 0:
        return MergeHandle(_NO_ROWS, 0)
    kind, cols, masks = pack_inputs(tsid, ts, seq, tsid_rank, n_ranks, unique)
    return _dispatch(kind, cols, masks, n, dedup, device)


def merge_dedup_permutation(
    tsid: np.ndarray,
    ts: np.ndarray,
    seq: np.ndarray,
    dedup: bool = True,
    tsid_rank: np.ndarray | None = None,
    n_ranks: int = 0,
    unique: bool = False,
    *,
    device,
) -> tuple[np.ndarray, np.ndarray]:
    """Merge-sort order + survivor mask for concatenated sorted runs.

    Returns ``(perm, keep)`` of length == len(input): ``perm`` is the row
    permutation sorting by (tsid, ts, seq desc); ``keep[i]`` says whether
    sorted position i survives dedup (first — i.e. newest-sequence — row of
    each (tsid, ts) key). Apply as ``rows.take(perm[keep])``.

    The device does all comparison work; callers gather payload columns
    host-side (string columns can't live on device anyway).
    """
    return merge_dedup_dispatch(
        tsid, ts, seq, dedup=dedup,
        tsid_rank=tsid_rank, n_ranks=n_ranks, unique=unique, device=device,
    ).get()
