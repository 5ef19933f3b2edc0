"""Distributed merge-dedup: the compaction sort kernel over a mesh
(ref: the reference's compaction runs node-local,
analytic_engine/src/compaction/runner/local_runner.rs — a mesh can instead
split one merge across devices because the key space partitions cleanly).

The rows are split by tsid value at boundaries drawn from a stride sample,
so every duplicate key lands on one shard: each device sorts and dedups
its own slice with the f32 kind of the merge-dedup kernel (B5, one launch
per shard), with no combine, and the shards' outputs concatenate in split
order.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, on_device


def shard_words(mesh: Mesh, tsid: np.ndarray, ts: np.ndarray, seq: np.ndarray):
    """The sharded merge's inputs: (per shard the input rows it holds, per
    shard its three f32-kind key words on its device, each padded to one
    bucket with all-ones keys, the dedup masks). Packed (ts, seq) spans
    wider than 32 bits raise: callers pre-chunk by time."""
    from ..ops.encoding import next_pow2, split_u64
    from ..ops.merge_dedup import _pack_rest

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
    cid = np.searchsorted(splits, tsid, side="right")
    idxs = [np.flatnonzero(cid == d) for d in range(n_dev)]
    bucket = next_pow2(max((len(i) for i in idxs), default=1), floor=256)

    # the same packed rest word (and span measurement) as the single-device
    # f32 kind; global spans, so every shard shares one mask
    kind, packed = _pack_rest(ts64, seq64)
    if kind != "f32":
        raise ValueError(
            "dist merge requires packed (ts, seq) spans <= 32 bits; pre-chunk by time first"
        )
    rest_full, rest_mask = packed
    words = []
    for idx, dev in zip(idxs, mesh.devices):
        k = len(idx)
        host = np.full((3, bucket), 0xFFFFFFFF, dtype=np.uint32)
        if k:
            rev = idx[::-1]  # reversed + stable sort = newest input row wins
            host[0, :k], host[1, :k] = split_u64(tsid[rev])
            host[2, :k] = rest_full[rev]
        words.append(torch.from_numpy(host.view(np.int32)).to(dev).unbind(0))
    return idxs, words, (0xFFFFFFFF, 0xFFFFFFFF, int(rest_mask))


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
    keep the newest row per (tsid, ts) key. Packed (ts, seq) spans wider
    than 32 bits raise: callers pre-chunk by time."""
    from ..ops.merge_dedup import sort_dedup, unpack

    if len(tsid) == 0:
        return np.empty(0, dtype=np.int64)
    idxs, words, masks = shard_words(mesh, tsid, ts, seq)
    outs = []
    for idx, w in zip(idxs, words):
        with on_device(w[0].device):
            outs.append(sort_dedup("f32", w, masks, len(idx), dedup))
    sel = []
    for out, idx, w in zip(outs, idxs, words):
        if len(idx):
            perm, keep = (x.cpu().numpy() for x in unpack(out, w[0].shape[0])[:2])
            sel.append(idx[perm[keep]])
    return np.concatenate(sel) if sel else np.empty(0, dtype=np.int64)
