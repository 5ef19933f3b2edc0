"""Distributed merge-dedup: the compaction sort kernel over a mesh
(ref: the reference's compaction runs node-local,
analytic_engine/src/compaction/runner/local_runner.rs — a mesh can instead
split one merge across devices because the key space partitions cleanly).

The rows are split by tsid value at boundaries drawn from a stride sample,
so every duplicate key lands on one shard: each device sorts and dedups
its own slice with the f32 kind of the merge-dedup kernel (B5), with no
combine, and the shards' outputs concatenate in split order. Each shard is
staged at exactly its rows, as the one-device dispatcher stages a merge; an
empty shard is not sorted. On a card every shard's upload, sort and copy
back are queued on a stream of its own before any result is waited on, so
shards on one card sort side by side and shards on several cards at once.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .mesh import Mesh


def shard_words(mesh: Mesh, tsid: np.ndarray, ts: np.ndarray, seq: np.ndarray,
                pinned: bool = False):
    """The sharded merge's inputs: (per shard the input rows it holds, in
    input order; per shard its three f32-kind key words as one int32
    [3, rows] host tensor holding exactly its rows, reversed, pinned where
    asked; the dedup masks). One stable split by shard id and one gather
    of the reversed rows. Packed (ts, seq) spans wider than 32 bits raise:
    callers pre-chunk by time."""
    from ..ops.encoding import split_u64
    from ..ops.merge_dedup import _pack_rest, stage

    n = len(tsid)
    n_dev = mesh.size
    ts64 = ts.astype(np.int64, copy=False)
    seq64 = seq.astype(np.uint64, copy=False)

    # tsid-value shard boundaries from a stride sample: duplicates of a key
    # never straddle shards
    step = max(1, n // 65536)
    sample = np.sort(tsid[::step])
    splits = sample[
        [min(len(sample) - 1, (len(sample) * (i + 1)) // n_dev) for i in range(n_dev - 1)]
    ]
    # shard ids as uint16: numpy's stable sort of 16-bit keys is a radix sort
    cid = np.searchsorted(splits, tsid, side="right").astype(np.uint16)
    order = np.argsort(cid, kind="stable")
    counts = np.bincount(cid, minlength=n_dev)
    ends = np.cumsum(counts)
    starts = ends - counts
    idxs = [order[a:b] for a, b in zip(starts, ends)]

    # the same packed rest word (and span measurement) as the single-device
    # f32 kind; global spans, so every shard shares one mask
    kind, packed = _pack_rest(ts64, seq64)
    if kind != "f32":
        raise ValueError(
            "dist merge requires packed (ts, seq) spans <= 32 bits; pre-chunk by time first"
        )
    rest_full, rest_mask = packed
    # reversed + stable sort = newest input row wins: each shard's rows
    # reversed, shard after shard, in one gather
    rev = np.concatenate([idx[::-1] for idx in idxs])
    hi, lo = split_u64(tsid[rev])
    rest = rest_full[rev]
    host = [stage((hi[a:b], lo[a:b], rest[a:b]), int(b - a), pinned)
            for a, b in zip(starts, ends)]
    return idxs, host, (0xFFFFFFFF, 0xFFFFFFFF, int(rest_mask))


# each card's shard streams, made once and kept: the caching allocator
# keeps a stream's freed blocks for that stream, so a merge reuses the last
# one's scratch instead of allocating anew on a stream it has not seen
_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def shard_stream(device, i: int):
    """The ``i``-th shard stream of a card."""
    device = torch.device(device)
    with _STREAMS_LOCK:
        streams = _STREAMS.setdefault(device, [])
        while len(streams) <= i:
            streams.append(torch.cuda.Stream(device=device))
        return streams[i]


def sort_shard(host: torch.Tensor, masks, dedup: bool, device, slot: int = 0):
    """Queue one shard's sort of its staged words (``shard_words``) on
    ``device``; returns a ``MergeHandle``. On a card the upload, the sort
    and the copy of its result back to pinned memory go on the card's
    ``slot``-th shard stream, which first waits for the card's current
    one, and an event marks their end: the sort's scratch and buffers are
    allocated on that stream, so the sort of a shard in another slot of
    the same card runs beside it."""
    from ..ops.merge_dedup import MergeHandle, sort_dedup

    n = host.shape[1]
    device = torch.device(device)
    if device.type == "cpu":
        return MergeHandle(sort_dedup("f32", host.unbind(0), masks, n, dedup), n, "f32")
    with torch.cuda.device(device):
        stream = shard_stream(device, slot)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            words = host.to(device, non_blocking=True).unbind(0)
            out = sort_dedup("f32", words, masks, n, dedup)
            back = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
            back.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
    return MergeHandle(back, n, "f32", event)


def dist_merge_dedup(
    mesh: Mesh,
    tsid: np.ndarray,
    ts: np.ndarray,
    seq: np.ndarray,
    dedup: bool = True,
) -> np.ndarray:
    """Global row selection (indices into the input, in merged key order)
    for a k-way merge-dedup sharded over ``mesh``. Semantics match
    ops.merge_dedup.merge_dedup_permutation: sort by (tsid, ts, seq desc),
    keep the newest row per (tsid, ts) key. Every non-empty shard's sort is
    queued before the first result is read. Packed (ts, seq) spans wider
    than 32 bits raise: callers pre-chunk by time."""
    if len(tsid) == 0:
        return np.empty(0, dtype=np.int64)
    pinned = any(d.type == "cuda" for d in mesh.devices)
    idxs, host, masks = shard_words(mesh, tsid, ts, seq, pinned)
    handles, slots = [], {}
    for idx, h, dev in zip(idxs, host, mesh.devices):
        if len(idx):  # the shards of one card take its streams in turn
            slots[dev] = slots.get(dev, -1) + 1
            handles.append((idx, sort_shard(h, masks, dedup, dev, slots[dev])))
    sel = []
    for idx, handle in handles:
        perm, keep = handle.get()
        sel.append(idx[perm[keep]])
    return np.concatenate(sel) if sel else np.empty(0, dtype=np.int64)
