"""Sharded scan/aggregate: the distributed query step
(ref: df_engine_extensions/src/dist_sql_query — partial agg pushed to data
nodes, final agg at the coordinator; resolver.rs:76-120).

Rows are cut into S contiguous shards, one per device of the mesh. Each
shard runs the SAME aggregate kernel as single-device serving, one launch
on its own device and current stream (``scan_agg_direct`` or
``scan_agg_cached``, full scans), and the aggregation monoid combines the S
partials in one launch of the ``mesh_combine`` kernel on the mesh's first
device (the reference's psum/pmin/pmax collectives):

    counts -> int32 add    sums -> f32 add    mins -> fmin_t    maxs -> fmax_t

On a mesh of several cards the partials are first copied to the first
card (peer copies, no collective library); on a logical mesh (several
shards on one device) nothing is copied.

The combined state stays on the first device: the reference replicates
it on every device, but only ever reads it back to the host
(``state_to_host``), so the port does not replicate it. There is no
compiled-step cache (the reference's ``cached_step`` LRU): nothing is
compiled per shape, so the reference's ``make_dist_scan_agg`` and
``make_cached_dist_scan_agg`` factories are the plain functions
``dist_direct_step`` and ``dist_cached_step``. The kernels' own counters
(``scan_agg.LAUNCHES``, ``COMBINE_LAUNCHES``) show one launch a shard.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..ops.encoding import PaddedBatch
from ..ops.scan_agg import AggState, ScanAggSpec, coerce_literals, encode_filter_ops, state_to_host
from .mesh import Mesh, on_device, shard_rows


def _resolved(spec: ScanAggSpec) -> ScanAggSpec:
    """Resolve the segment impl ON HOST (honouring HORAEDB_SEGMENT_IMPL),
    so every shard launches the same concrete arm."""
    from ..ops.scan_agg import resolve_segment_impl

    impl = resolve_segment_impl(
        spec.n_groups * spec.n_buckets, spec.segment_impl, spec.n_agg_fields, spec.need_minmax
    )
    if impl == spec.segment_impl:
        return spec
    return dataclasses.replace(spec, segment_impl=impl)


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself when it is there already (a logical
    mesh), else a copy queued without blocking the host."""
    return t if t.device == device else t.to(device, non_blocking=True)


def _kernel_kw(spec: ScanAggSpec) -> dict:
    return dict(
        n_groups=spec.n_groups, n_buckets=spec.n_buckets, n_agg_fields=spec.n_agg_fields,
        numeric_filters=encode_filter_ops(spec.numeric_filters), need_minmax=spec.need_minmax,
        segment_impl=spec.segment_impl, hash_slots=spec.hash_slots,
    )


def dist_direct_step(mesh: Mesh, spec: ScanAggSpec, group_codes, bucket_ids, mask, values,
                     literals):
    """The sharded direct step for ``spec``: each row input is a sequence
    of S shards (shard d on ``mesh.devices[d]``; values [F, rows] per
    shard) and ``literals`` one f32 tensor. Returns the combined (counts,
    sums, mins, maxs) tensors on ``mesh.first``."""
    from ..ops import scan_agg

    spec = _resolved(spec)
    kw = _kernel_kw(spec)
    parts = []
    for d, dev in enumerate(mesh.devices):
        with on_device(dev):
            parts.append(scan_agg.fused_scan_agg(
                group_codes[d], bucket_ids[d], mask[d], values[d], _on(literals, dev), **kw
            ))
    first = mesh.first
    parts = [tuple(_on(x, first) for x in p) for p in parts]
    return scan_agg.mesh_combine_state(parts, need_minmax=spec.need_minmax)


def shard_real_rows(n_valid: int, rows: int, shard: int) -> int:
    """Real rows of shard ``shard`` of ``rows`` rows each, when the first
    ``n_valid`` rows of the table are real: its prefix that holds them."""
    return min(max(int(n_valid) - shard * int(rows), 0), int(rows))


def dist_cached_step(mesh: Mesh, spec: ScanAggSpec, series_shards, ts_shards, value_shards,
                     session, dyn, *, value_layouts=(), n_valid=None):
    """The sharded version of the resident cached kernel (full scans):
    shard d's series and ts part tuples and per-field value part tuples (a
    sharded cache entry's, raw layouts, on ``mesh.devices[d]``), the
    packed session [group map | allow list] and dyn [literals | lo, hi, t0,
    width] on ``mesh.first`` (copied to each other device). ``n_valid``:
    the entry's real rows, the first of the table; each shard then scans
    only its part of them (``shard_real_rows``), every row by default.
    Returns the combined packed buffer [counts | sums | mins | maxs] on
    ``mesh.first``: one fetch for the host, as single-device."""
    from ..ops import scan_agg
    from ..ops.encoding import layout_rows

    spec = _resolved(spec)
    kw = _kernel_kw(spec)
    inputs = {}
    parts = []
    for d, dev in enumerate(mesh.devices):
        if dev not in inputs:
            inputs[dev] = (_on(session, dev), _on(dyn, dev))
        rows = None
        if n_valid is not None:
            rows = shard_real_rows(n_valid, layout_rows(series_shards[0], ("raw",)), d)
        with on_device(dev):
            parts.append(scan_agg.cached_scan_agg_packed(
                series_shards[d], ts_shards[d], value_shards[d], *inputs[dev],
                value_layouts=value_layouts, n_rows=rows, **kw,
            ))
    parts = [_on(p, mesh.first) for p in parts]
    return scan_agg.mesh_combine(
        parts, n_seg=spec.n_groups * spec.n_buckets, n_agg_fields=spec.n_agg_fields,
        need_minmax=spec.need_minmax,
    )


def dist_scan_aggregate(
    mesh: Mesh,
    batch: PaddedBatch,
    spec: ScanAggSpec,
    filter_literals: Sequence[float] = (),
) -> AggState:
    """Pad the batch to a multiple of the mesh size (masked pad rows, so
    they never touch the aggregates), shard it, run the sharded step and
    return the host-side combined partials."""
    import time as _time

    from ..obs.device import timed_dispatch
    from ..utils.querystats import note_kernel_dispatch

    args = (
        shard_rows(torch.from_numpy(batch.group_codes), mesh),
        shard_rows(torch.from_numpy(batch.bucket_ids), mesh),
        shard_rows(torch.from_numpy(batch.mask), mesh, fill=False),
        shard_rows(torch.from_numpy(batch.values), mesh),
        coerce_literals(filter_literals, mesh.first),
    )
    t0 = _time.perf_counter()
    counts, sums, mins, maxs = timed_dispatch(
        "fused_dist", lambda: dist_direct_step(mesh, spec, *args), mesh.first
    )
    state = state_to_host(counts, sums, mins, maxs)
    note_kernel_dispatch(
        ("fused-dist", mesh.size, batch.values.shape, spec),
        _time.perf_counter() - t0,
        kind="fused_dist",
    )
    return state
