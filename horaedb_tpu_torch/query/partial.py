"""Partial aggregation push-down — the distributed query step
(ref: df_engine_extensions/src/dist_sql_query/resolver.rs:76-120 — filter,
projection, and PARTIAL aggregation pushed below the scan to the node that
owns each partition; the coordinator runs only the final combine).

The unit shipped to a partition owner is an ``AggSpecWire`` dict (what the
reference encodes as a protobuf physical subplan): predicate + exact
filters + group tags + time bucket + aggregated columns + device-numeric
filters. The owner scans ONLY its own data, runs the fused scan/agg
kernel (or a NULL-aware host fallback), and returns a tiny partial batch:

    key_0..key_k | __bucket | __count_rows | per field: __count/__sum/__min/__max

Partials from all partitions combine with the aggregation monoid — the
same (count,sum,min,max) algebra the mesh collectives use, so partition
parallelism (DCN) and mesh parallelism (ICI) are the SAME reduction at
different radii.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..common_types.dict_column import as_values, unique_inverse
from ..common_types.row_group import RowGroup
from ..common_types.time_range import MAX_TIMESTAMP, MIN_TIMESTAMP
from ..ops import ScanAggSpec, encode_group_codes, scan_aggregate
from ..ops.encoding import build_padded_batch, time_buckets
from ..table_engine.predicate import ColumnFilter, FilterOp, Predicate
from ..remote.codec import predicate_from_dict, predicate_to_dict
from .executor import ResultSet, _plan_needs_minmax
from .plan import QueryPlan

from ..table_engine.predicate import NUMPY_CMP as _CMP


def spec_from_plan(executor, plan: QueryPlan) -> Optional[dict]:
    """AggSpecWire for a pushable aggregate plan, else None.

    Pushable = the device kernel shape fits AND every residual conjunct is
    a simple ``col op literal`` (numeric ones run in the kernel, the rest
    as exact vectorized filters on the owner).
    """
    if not plan.is_aggregate:
        return None
    shape = executor._agg_device_shape(plan)
    if shape is None:
        return None
    tag_keys, bucket_key, agg_cols = shape
    from .planner import _as_simple_cmp

    device_filters, other = executor._split_residual_filters(plan)
    exact_filters: list[list] = []
    for conj in other:
        simple = _as_simple_cmp(conj)
        if simple is None or not plan.schema.has_column(simple[0]):
            return None
        exact_filters.append([simple[0], simple[1], simple[2]])
    return {
        "predicate": predicate_to_dict(plan.predicate),
        "exact_filters": exact_filters,
        "device_filters": [[c, op, float(lit)] for c, op, lit in device_filters],
        "group_tags": [k.column for k in tag_keys],
        "bucket_ms": bucket_key.time_bucket_ms if bucket_key is not None else 0,
        "agg_cols": agg_cols,
        # optional (older peers omit it -> treated as True by consumers)
        "need_minmax": _plan_needs_minmax(plan),
        "device": str(executor.device),
    }


def compute_partial(
    table, spec: dict, m: Optional[dict] = None
) -> tuple[list[str], list[np.ndarray]]:
    """Run the pushed-down partial aggregate against one table/partition.

    Runs wherever the data lives: the executor calls it for local
    partitions, the remote-engine service for shipped ones. ``m`` (when
    given) collects sub-stage spans — scan time, rows scanned, kernel vs
    host path — that ride home to the coordinator's EXPLAIN ANALYZE tree
    (ref: RemoteTaskContext.remote_metrics).
    """
    import time as _time

    pred = predicate_from_dict(spec["predicate"])
    group_tags = list(spec["group_tags"])
    agg_cols = list(spec["agg_cols"])
    bucket_ms = int(spec["bucket_ms"])
    filter_cols = [c for c, _, _ in spec["device_filters"]]
    exact_cols = [c for c, _, _ in spec["exact_filters"]]
    schema = table.schema
    projection = list(
        dict.fromkeys(
            [schema.timestamp_name]
            + ([schema.columns[schema.tsid_index].name] if schema.tsid_index is not None else [])
            + group_tags + agg_cols + filter_cols + exact_cols
        )
    )
    # Memory bound (ref: instance/read.rs:165-190 — the reference streams
    # N record-batch streams instead of one array): when the pruned file
    # metadata says the scan would materialize more than the cap, iterate
    # per-segment-window pieces and CONCATENATE their partial batches —
    # the caller's single monoid combine treats windows exactly like
    # extra partitions, and the whole table never sits in host memory.
    cap_bytes = _agg_memory_cap_bytes()
    # "bounded_hint": the LOCAL executor already walked this table's
    # metadata and decided (plain-table path only — partition scatters
    # leave it unset so each owner estimates its own data).
    if cap_bytes and (
        spec.get("bounded_hint")
        or _scan_estimate_bytes(table, pred, projection) > cap_bytes
    ):
        from ..utils.tracectx import span

        all_names: list[str] | None = None
        parts: list[list[np.ndarray]] = []
        windows = 0
        t_scan = _time.perf_counter()
        rows_seen = 0
        from ..utils.deadline import checkpoint as _deadline_checkpoint

        with span("partial_windowed", table=table.name) as sp:
            for rows in table.read_windows(pred, projection=projection):
                # per-window checkpoint: a long bounded aggregate is
                # exactly the shape a KILL / tight budget must be able
                # to stop mid-flight (the host-fallback chunk loop)
                _deadline_checkpoint("executing")
                windows += 1
                rows_seen += len(rows)
                names, arrays = _partial_on_rows(rows, spec)
                if arrays and len(arrays[0]):
                    all_names = names
                    parts.append(arrays)
            sp.set(windows=windows, rows=rows_seen)
        from ..utils.querystats import record as _qs_record

        _qs_record(scan_rows=rows_seen)
        if m is not None:
            m["scan_ms"] = round((_time.perf_counter() - t_scan) * 1000, 3)
            m["rows_scanned"] = rows_seen
            m["bounded_windows"] = windows
            m["path"] = "kernel-windowed"
        if all_names is None:
            return _partial_on_rows(
                _empty_projected(table, projection), spec
            )
        return all_names, [
            np.concatenate([p[i] for p in parts])
            for i in range(len(all_names))
        ]

    from ..utils.tracectx import span

    t_scan = _time.perf_counter()
    with span("scan", table=table.name) as sp:
        rows = table.read(pred, projection=projection)
        sp.set(rows=len(rows))
    from ..utils.querystats import record as _qs_record

    _qs_record(scan_rows=len(rows))
    if m is not None:
        m["scan_ms"] = round((_time.perf_counter() - t_scan) * 1000, 3)
        m["rows_scanned"] = len(rows)

    t_agg = _time.perf_counter()
    with span("partial") as sp:
        out = _partial_on_rows(rows, spec, m)
        if m is not None and "path" in m:
            sp.set(path=m["path"])
    if m is not None:
        m["agg_ms"] = round((_time.perf_counter() - t_agg) * 1000, 3)
    return out


def _partial_on_rows(
    rows: RowGroup, spec: dict, m: Optional[dict] = None
) -> tuple[list[str], list[np.ndarray]]:
    """The partial aggregate over an already-materialized row set — the
    shared core of the whole-table and per-window (memory-bounded)
    paths. Bucket origins are absolute-aligned (floor to bucket_ms), so
    batches from different windows combine on equal "__bucket" values."""
    agg_cols = list(spec["agg_cols"])
    bucket_ms = int(spec["bucket_ms"])
    n = len(rows)
    mask = np.ones(n, dtype=bool)
    for c, op, v in spec["exact_filters"]:
        col = rows.columns[c]
        valid = rows.valid_mask(c)
        from ..common_types.dict_column import DictColumn

        if isinstance(col, DictColumn):
            hit = col.map_values(lambda vals: _CMP[op](vals, v))
        else:
            hit = _CMP[op](col, v)
        mask &= np.asarray(hit).astype(bool) & valid

    # Exact predicate tag/key filters were already folded into
    # exact_filters by the planner's residual; predicate.filters here only
    # drove pruning. Aggregate inputs:
    all_valid = all(rows.valid_mask(c).all() for c in agg_cols)
    ts = rows.timestamps
    if bucket_ms:
        t0 = int((int(ts.min()) // bucket_ms) * bucket_ms) if n else 0
    else:
        t0 = 0
    if m is not None:
        m["path"] = "kernel" if all_valid else "host"
    if all_valid:
        return _partial_kernel(rows, mask, spec, t0, m)
    return _partial_host(rows, mask, spec, t0)


import functools


@functools.lru_cache(maxsize=None)
def _default_budget_mb(floor_mb: int = 1024) -> int:
    """Default memory budgets scale with the machine: a quarter of
    physical RAM, never below ``floor_mb`` (a 125GB box should not
    refuse a 3GB scan the way a 4GB edge node must)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return max(floor_mb, int(line.split()[1]) // 1024 // 4)
    except OSError:
        pass
    return floor_mb


def _budget_bytes(env_name: str) -> int:
    """Env-or-RAM/4 byte budget (fractional MB allowed; 0 disables) —
    the ONE parse both memory knobs share."""
    import os

    raw = os.environ.get(env_name)
    if raw is None:
        return _default_budget_mb() << 20
    return int(float(raw) * (1 << 20))


def _agg_memory_cap_bytes() -> int:
    """HORAEDB_AGG_MEMORY_MB: cap on the host working set one aggregate
    scan may materialize (0 disables bounding; fractions allowed;
    default: a quarter of physical RAM, min 1GB)."""
    return _budget_bytes("HORAEDB_AGG_MEMORY_MB")


def _scan_estimate_bytes(table, pred, projection) -> int:
    """Pre-read size estimate from pruned SST metadata + memtable bytes
    — no data touched."""
    tr = pred.time_range
    total_rows = 0
    mem_bytes = 0
    n_cols = (
        len(projection)
        if projection is not None
        else len(table.schema.columns)
    )
    for data in table.physical_datas():
        for h in data.version.levels.all_files():
            ftr = h.meta.time_range
            if ftr.inclusive_start < tr.exclusive_end and tr.inclusive_start < ftr.exclusive_end:
                total_rows += h.meta.num_rows
        for mem in [*data.version.immutables(), data.version.mutable]:
            mem_bytes += mem.approx_bytes  # property on both kinds
    return total_rows * 8 * n_cols + mem_bytes


def _empty_projected(table, projection) -> RowGroup:
    from ..common_types.schema import project_schema

    schema = project_schema(table.schema, projection)
    return RowGroup(
        schema,
        {c.name: np.empty(0, dtype=c.kind.numpy_dtype) for c in schema.columns},
    )


def _partial_kernel(
    rows, mask, spec, t0, m: Optional[dict] = None
) -> tuple[list[str], list[np.ndarray]]:
    group_tags = list(spec["group_tags"])
    agg_cols = list(spec["agg_cols"])
    bucket_ms = int(spec["bucket_ms"])
    n = len(rows)
    enc = encode_group_codes(rows, group_tags)
    if bucket_ms and n:
        bucket_ids, n_buckets = time_buckets(rows.timestamps, t0, bucket_ms)
    else:
        bucket_ids, n_buckets = np.zeros(n, dtype=np.int32), 1
    filter_cols = [c for c, _, _ in spec["device_filters"]]
    value_names = list(dict.fromkeys(agg_cols + filter_cols))
    batch = build_padded_batch(
        enc.codes, bucket_ids, mask, [rows.column(c) for c in value_names]
    )
    kspec = ScanAggSpec(
        n_groups=max(enc.num_groups, 1),
        n_buckets=n_buckets,
        n_agg_fields=len(agg_cols),
        numeric_filters=tuple(
            (value_names.index(c), op) for c, op, _ in spec["device_filters"]
        ),
        need_minmax=bool(spec.get("need_minmax", True)),
    ).padded()

    # Learned segment-impl choice (ROADMAP item-3 remainder): the
    # partial path rode the static HORAEDB_MXU_MAX_SEGMENTS heuristic
    # long after the direct/cached/dist paths got the router. Keyed by
    # the WIRE spec's shape (what the owner actually executes — the
    # coordinator's plan never reaches this side of the RPC); group
    # codes are dense here, so groups x buckets is an exact ceiling.
    from .executor import finish_segment_kernel, route_segment_kernel

    shape_key = (
        "partial",
        tuple(group_tags),
        bucket_ms,
        tuple(agg_cols),
        tuple((c, op) for c, op, _ in spec["device_filters"]),
        tuple((c, op) for c, op, _ in spec["exact_filters"]),
    )
    # the coordinator names the device its kernels run on
    device = torch.device(spec["device"])
    kspec, krec = route_segment_kernel(
        shape_key, kspec, n_rows=batch.n_valid,
        est_distinct=max(enc.num_groups, 1) * n_buckets, device=device,
    )

    import time as _time

    t_kernel = _time.perf_counter()
    state = scan_aggregate(
        batch, kspec, [lit for _, _, lit in spec["device_filters"]], device=device
    )
    finish_segment_kernel(
        krec, kspec, m if m is not None else {}, state,
        _time.perf_counter() - t_kernel, n_valid=batch.n_valid,
    )

    G, B = max(enc.num_groups, 1), n_buckets
    counts = state.counts[:G, :B]
    live_g, live_b = np.nonzero(counts > 0)
    names = [f"__k{i}" for i in range(len(group_tags))] + ["__bucket", "__count_rows"]
    arrays: list[np.ndarray] = [
        np.asarray(enc.key_values[i])[live_g] for i in range(len(group_tags))
    ]
    arrays.append(t0 + live_b.astype(np.int64) * (bucket_ms or 1))
    arrays.append(counts[live_g, live_b].astype(np.int64))
    need_minmax = bool(spec.get("need_minmax", True))
    n_live = len(live_g)
    for fi, _col in enumerate(agg_cols):
        names += [f"__count_{fi}", f"__sum_{fi}", f"__min_{fi}", f"__max_{fi}"]
        arrays += [
            counts[live_g, live_b].astype(np.int64),  # full validity ⇒ same
            state.sums[fi, :G, :B][live_g, live_b],
            # identity elements when the kernel skipped min/max: the
            # monoid fold in combine_partials leaves them inert
            state.mins[fi, :G, :B][live_g, live_b]
            if need_minmax else np.full(n_live, np.inf),
            state.maxs[fi, :G, :B][live_g, live_b]
            if need_minmax else np.full(n_live, -np.inf),
        ]
    return names, arrays


def _partial_host(rows, mask, spec, t0) -> tuple[list[str], list[np.ndarray]]:
    """NULL-aware numpy fallback with identical output shape."""
    group_tags = list(spec["group_tags"])
    agg_cols = list(spec["agg_cols"])
    bucket_ms = int(spec["bucket_ms"])
    for c, op, lit in spec["device_filters"]:
        mask &= _CMP[op](as_values(rows.column(c)), lit) & rows.valid_mask(c)
    idx = np.nonzero(mask)[0]
    rows = rows.take(idx)
    n = len(rows)
    key_arrays = [rows.column(c) for c in group_tags]
    if bucket_ms:
        bucket = ((rows.timestamps // bucket_ms) * bucket_ms).astype(np.int64)
    else:
        bucket = np.zeros(n, dtype=np.int64)
    combined = np.zeros(n, dtype=np.int64)
    uniqs = []
    for arr in [*key_arrays, bucket]:
        u, inv = unique_inverse(arr)
        uniqs.append(u)
        combined = combined * (len(u) + 1) + inv
    uc, first, codes = np.unique(combined, return_index=True, return_inverse=True)
    G = len(uc)
    names = [f"__k{i}" for i in range(len(group_tags))] + ["__bucket", "__count_rows"]
    arrays: list[np.ndarray] = [as_values(a[first]) for a in key_arrays]
    arrays.append(bucket[first])
    arrays.append(np.bincount(codes, minlength=G).astype(np.int64))
    for fi, col_name in enumerate(agg_cols):
        v = as_values(rows.column(col_name)).astype(np.float64)
        valid = rows.valid_mask(col_name)
        vv = np.where(valid, v, 0.0)
        cnt = np.bincount(codes, weights=valid.astype(np.float64), minlength=G)
        sums = np.bincount(codes, weights=vv, minlength=G)
        mins = np.full(G, np.inf)
        maxs = np.full(G, -np.inf)
        np.minimum.at(mins, codes[valid], v[valid])
        np.maximum.at(maxs, codes[valid], v[valid])
        names += [f"__count_{fi}", f"__sum_{fi}", f"__min_{fi}", f"__max_{fi}"]
        arrays += [cnt.astype(np.int64), sums, mins, maxs]
    return names, arrays


def combine_partials(
    parts: list[tuple[list[str], list[np.ndarray]]], spec: dict
) -> tuple[dict[str, np.ndarray], int]:
    """Concatenate partial batches and fold the monoid per (keys, bucket)."""
    n_keys = len(spec["group_tags"])
    n_fields = len(spec["agg_cols"])
    parts = [p for p in parts if len(p[1]) and len(p[1][0])]
    if not parts:
        return {}, 0
    by_name = {}
    for names, arrays in parts:
        for nm, arr in zip(names, arrays):
            by_name.setdefault(nm, []).append(arr)
    cat = {nm: np.concatenate(arrs) for nm, arrs in by_name.items()}

    combined = np.zeros(len(cat["__bucket"]), dtype=np.int64)
    uniq_per_key = []
    for i in range(n_keys):
        u, inv = unique_inverse(cat[f"__k{i}"])
        uniq_per_key.append(u)
        combined = combined * (len(u) + 1) + inv
    u, inv = unique_inverse(cat["__bucket"])
    combined = combined * (len(u) + 1) + inv
    uc, first, codes = np.unique(combined, return_index=True, return_inverse=True)
    G = len(uc)
    out: dict[str, np.ndarray] = {}
    for i in range(n_keys):
        out[f"__k{i}"] = as_values(cat[f"__k{i}"][first])
    out["__bucket"] = cat["__bucket"][first]
    out["__count_rows"] = np.bincount(
        codes, weights=cat["__count_rows"].astype(np.float64), minlength=G
    ).astype(np.int64)
    for fi in range(n_fields):
        out[f"__count_{fi}"] = np.bincount(
            codes, weights=cat[f"__count_{fi}"].astype(np.float64), minlength=G
        ).astype(np.int64)
        out[f"__sum_{fi}"] = np.bincount(
            codes, weights=cat[f"__sum_{fi}"], minlength=G
        )
        mins = np.full(G, np.inf)
        maxs = np.full(G, -np.inf)
        np.minimum.at(mins, codes, cat[f"__min_{fi}"])
        np.maximum.at(maxs, codes, cat[f"__max_{fi}"])
        out[f"__min_{fi}"] = mins
        out[f"__max_{fi}"] = maxs
    return out, G


def assemble_result(plan: QueryPlan, combined: dict, n_groups: int, spec: dict) -> ResultSet:
    from . import ast
    from .executor import _empty_ungrouped_agg_row, _order_and_limit

    if n_groups == 0:
        if not plan.group_keys:
            return _order_and_limit(_empty_ungrouped_agg_row(plan), plan)
        names = [item.output_name for item in plan.select.items]
        return _order_and_limit(ResultSet.empty(names), plan)
    group_tags = list(spec["group_tags"])
    agg_cols = list(spec["agg_cols"])

    def agg_column(a) -> tuple[np.ndarray, np.ndarray | None]:
        if a.column is None:  # count(*)
            return combined["__count_rows"], None
        fi = agg_cols.index(a.column)
        cnt = combined[f"__count_{fi}"]
        empty = cnt == 0
        null = empty if empty.any() else None
        if a.func == "count":
            return cnt, None
        if a.func == "sum":
            return combined[f"__sum_{fi}"], null
        if a.func == "avg":
            with np.errstate(divide="ignore", invalid="ignore"):
                return combined[f"__sum_{fi}"] / np.maximum(cnt, 1), null
        if a.func == "min":
            return combined[f"__min_{fi}"], null
        if a.func == "max":
            return combined[f"__max_{fi}"], null
        # unreachable: shape check restricts the func set
        raise ValueError(f"unsupported agg {a.func}")

    names: list[str] = []
    columns: list[np.ndarray] = []
    nulls: dict[str, np.ndarray] = {}
    agg_expr_map = dict(plan.agg_exprs)
    computed = None
    if agg_expr_map:
        from .executor import eval_agg_exprs

        base = {
            tag: (combined[f"__k{ki}"], None)
            for ki, tag in enumerate(group_tags)
        }
        for a in plan.aggs:
            base[a.output_name] = agg_column(a)
        computed = eval_agg_exprs(plan, base)
    for item in plan.select.items:
        out_name = item.output_name
        e = item.expr
        if out_name in agg_expr_map:
            v, nm = computed[out_name]
            columns.append(v)
            if nm is not None:
                nulls[out_name] = nm
        elif isinstance(e, ast.Column):
            ki = group_tags.index(e.name)
            columns.append(combined[f"__k{ki}"])
        elif isinstance(e, ast.FuncCall) and e.name in ("time_bucket", "date_trunc"):
            columns.append(combined["__bucket"])
        else:
            agg_i = [a.output_name for a in plan.aggs].index(out_name)
            col, null = agg_column(plan.aggs[agg_i])
            columns.append(col)
            if null is not None:
                nulls[out_name] = null
        names.append(out_name)
    return _order_and_limit(ResultSet(names, columns, nulls or None), plan)
