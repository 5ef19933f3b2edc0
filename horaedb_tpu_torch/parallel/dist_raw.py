"""Sharded raw reads: fused filter + top-k / selection over a mesh.

When a table's scan-cache entry is sharded over the mesh (contiguous row
blocks, one per device, raw layouts), raw reads run the SAME kernels as
the single-device path (ops/scan_topk, B4) once per shard, on the shard's
device. The executor's row windows (global resident rows that hold every
row the mask can pass) are clipped to each shard's rows and shifted to its
local ids (``shard_windows``): a shard visits only its part of them, and a
shard whose part holds no row is not launched (it can pass no row). Every
launched shard's launch is issued before the first answer is fetched.

- **top-k**: each shard computes its local top-k (the caller clamps k to
  the shard length: a shard shorter than k contributes all its passing
  rows, still a superset of the global top-k). Local row ids become GLOBAL
  resident ids (+ shard index x shard length); each launch hands back its
  slots with the keys it ranked them by (one buffer, one fetch), and the
  host merges the lists with ``np.lexsort``
  (key descending, row id ascending) and cuts them at the count the
  caller needs, never at the shard-clamped k.
- **selection**: each shard compacts its passing rows into its own
  bounded buffer, as many slots as its part of the windows has rows; the
  shards' valid prefixes stitch in shard order, which is the global
  resident (series, ts) order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.scan_topk import RawScanSpec
from .dist_agg import _on
from .mesh import Mesh, on_device


def _per_device(mesh: Mesh, tensors) -> dict:
    """Each distinct device of the mesh -> ``tensors`` on it."""
    out: dict = {}
    for dev in mesh.devices:
        if dev not in out:
            out[dev] = tuple(_on(t, dev) for t in tensors)
    return out


def _layouts(spec: RawScanSpec, n_fields: int) -> dict:
    return dict(
        value_layouts=spec.value_layouts or tuple(("raw",) for _ in range(n_fields)),
        ts_layout=spec.ts_layout, series_layout=spec.series_layout,
    )


def merge_topk(keys: np.ndarray, ids: np.ndarray, need: int, key_lo: int) -> np.ndarray:
    """The top ``need`` candidates by key descending, row id ascending (the
    single-device tie rule), in the single-device kernel's slot order: the
    rows above the ``need``-th key in row order, then its ties in row order.
    With fewer than ``need`` candidates the threshold is ``key_lo + 1``,
    where the kernel's search for the k-th key ends when fewer rows pass."""
    order = np.lexsort((ids, -keys))
    top = order[:need]
    thr = keys[order[need - 1]] if len(order) >= need else key_lo + 1
    k, i = keys[top], ids[top]
    strict = np.sort(i[k > thr])
    ties = np.sort(i[k == thr])
    return np.concatenate([strict, ties])


def _shard_launches(mesh: Mesh, spec: RawScanSpec, series_shards, value_shards, windows):
    """(shard, device, layouts, row offset, local windows) of every shard
    to launch: each shard with ``windows`` None (every row), else only the
    shards whose clipped windows hold a row."""
    from ..ops.encoding import layout_rows

    out, offset = [], 0
    for d, dev in enumerate(mesh.devices):
        lay = _layouts(spec, len(value_shards[d]))
        rows = layout_rows(series_shards[d], lay["series_layout"])
        local = None if windows is None else shard_windows(windows, offset, rows)
        if local is None or int((local[:, 1] - local[:, 0]).sum()):
            out.append((d, dev, lay, offset, local))
        offset += rows
    return out


def dist_raw_topk(
    mesh: Mesh, spec: RawScanSpec, series_shards, ts_shards, value_shards, session, dyn,
    *, need: int, key_lo: int, windows=None,
) -> np.ndarray:
    """Run the top-k on every shard (``spec.k``, which the caller clamps to
    the shard length) and merge the candidates on the host: global resident
    row ids of the top ``need`` passing rows in the slot order the
    single-device kernel gives for k = ``need`` (``merge_topk``; ``key_lo``
    is the dyn row's lower key seed). ``need`` may exceed ``spec.k``: the
    union holds up to n_dev * k candidates and is cut at the requested
    count. ``windows``: the executor's global row windows (every passing
    row lies in one); each shard visits its clipped part, and a shard with
    none is not launched. Without them every shard takes all its rows.
    ``session`` (the allow list) and ``dyn`` [literals | lo, hi, key_lo,
    key_hi] lie on ``mesh.first``."""
    from ..ops import scan_topk
    from ..ops.scan_agg import encode_filter_ops

    nfilters = encode_filter_ops(spec.numeric_filters)
    inputs = _per_device(mesh, (session, dyn))
    outs = []
    for d, dev, lay, offset, local in _shard_launches(mesh, spec, series_shards, value_shards,
                                                      windows):
        with on_device(dev):
            outs.append((offset, scan_topk.raw_topk_packed(
                series_shards[d], ts_shards[d], value_shards[d], *inputs[dev], k=spec.k,
                descending=spec.descending, key_is_ts=spec.key_is_ts,
                key_field=spec.key_field, numeric_filters=nfilters, with_keys=True,
                windows=local, **lay,
            )))
    keys, ids = [np.empty(0, dtype=np.int64)], [np.empty(0, dtype=np.int64)]
    for off, out in outs:
        slots, key = out.cpu().numpy().astype(np.int64)
        held = slots >= 0
        keys.append(key[held])
        ids.append(slots[held] + off)
    ids = np.concatenate(ids)
    if not len(ids):
        return ids
    return merge_topk(np.concatenate(keys), ids, need, key_lo)


def shard_windows(windows: np.ndarray, offset: int, rows: int) -> np.ndarray:
    """The part of global row ``windows`` (int64[W, 2], sorted, disjoint
    [start, end)) inside the shard of ``rows`` rows from ``offset``, in the
    shard's local row ids."""
    w = np.asarray(windows, dtype=np.int64).reshape(-1, 2)
    w = w[(w[:, 1] > offset) & (w[:, 0] < offset + rows)]
    return np.clip(w, offset, offset + rows) - offset


def dist_raw_select(
    mesh: Mesh, spec: RawScanSpec, series_shards, ts_shards, value_shards, session, dyn,
    *, windows=None,
) -> tuple[np.ndarray, int]:
    """Run the selection on every shard -> (global row ids in resident
    order, total passing count). ``windows``: the executor's global row
    windows (every passing row lies in one); each shard gets its clipped
    part and a buffer of as many slots as that part has rows, and a shard
    with none is not launched. Without them every shard scans its rows
    into ``spec.select_slots`` slots. A total past ``len(ids)`` means a
    shard overflowed its buffer: the caller's bound was wrong, and the
    caller raises."""
    from ..ops import scan_topk
    from ..ops.scan_agg import encode_filter_ops

    nfilters = encode_filter_ops(spec.numeric_filters)
    inputs = _per_device(mesh, (session, dyn))
    outs = []
    for d, dev, lay, offset, local in _shard_launches(mesh, spec, series_shards, value_shards,
                                                      windows):
        slots = spec.select_slots if local is None else int((local[:, 1] - local[:, 0]).sum())
        with on_device(dev):
            outs.append((offset, scan_topk.raw_select_packed(
                series_shards[d], ts_shards[d], value_shards[d], *inputs[dev],
                select_slots=slots, numeric_filters=nfilters, windows=local, **lay,
            )))
    parts, total = [np.empty(0, dtype=np.int64)], 0
    for off, out in outs:
        got = out.cpu().numpy()
        n = int(got[0])
        total += n
        # a shard past its buffer: its count is the truth, its slots are cut
        parts.append(got[1:1 + n].astype(np.int64) + off)
    return np.concatenate(parts), total
