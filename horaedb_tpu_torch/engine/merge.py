"""Merge-dedup read path (ref: analytic_engine/src/row_iter/{merge.rs,dedup.rs,chain.rs}).

The reference streams rows through a BinaryHeap k-way merge with a dedup
iterator on top (merge.rs:134-181). Re-designed for the device: every
overlapping source (memtables + SSTs) is materialized as dense columns,
concatenated, and sorted ONCE by (primary key, version desc), then
duplicates collapse with a shift-compare mask. Sort+mask is exactly what
accelerators are good at, and it's the same algorithm compaction uses on
device (ops/merge_dedup).

On a CUDA table a merge of at least ``device_merge_min_rows`` rows always
launches the merge-dedup kernel. The reference also routes merges
adaptively between device and host by measured per-row rates; that router
is not ported (as the query path's device/host router is not): with the
kernel built at first use there is nothing to wait for, and a merge never
moves to the host while its table lives on a card.

Version ordering across sources (matching the reference's sequence rules):
memtable rows carry their true per-row WAL sequence; SST rows carry the
file's ``max_sequence`` (flush already collapsed intra-file duplicates, so
file-granularity versioning is exact — newer files always beat older ones
for the same key).

APPEND-mode tables skip sort+dedup entirely (ref: chain.rs no-sort
concatenation).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..common_types.dict_column import DictColumn
from ..common_types.row_group import RowGroup
from ..common_types.schema import Schema, project_schema
from ..table_engine.predicate import Predicate
from ..utils.env import env_int
from ..utils.object_store import ObjectStore
from .options import UpdateMode
from .sst.reader import SstReader
from .version import ReadView

# On a card the sort runs where the merge can use it above a batch
# threshold (the reference's accelerator default). A CPU table keeps the
# host lexsort: the reference measured its device sort on the CPU at
# 0.2-0.4x numpy's lexsort at every size, and defaults it off there.
DEFAULT_DEVICE_MERGE_MIN_ROWS = 200_000


def device_merge_min_rows(device) -> int:
    raw = env_int("HORAEDB_DEVICE_MERGE_MIN_ROWS", None)
    if raw is not None:
        # any explicit value is honored, including negatives (force the
        # device merge for every size) — only unset/malformed defaults
        return raw
    if device.type == "cpu":
        return 1 << 62  # effectively off
    return DEFAULT_DEVICE_MERGE_MIN_ROWS

def dedup_keep_mask(rows: RowGroup) -> np.ndarray:
    """Mask keeping the FIRST row of each primary-key run.

    Requires rows sorted by primary key with the winning version first
    (``RowGroup.sorted_by_key(seq=...)`` produces exactly that order).
    """
    n = len(rows)
    keep = np.ones(n, dtype=np.bool_)
    if n <= 1:
        return keep
    same = np.ones(n - 1, dtype=np.bool_)
    for i in rows.schema.primary_key_indexes:
        col = rows.columns[rows.schema.columns[i].name]
        if isinstance(col, DictColumn):
            col = col.codes  # same RowGroup => shared vocab => codes compare
        same &= col[1:] == col[:-1]
    keep[1:] = ~same
    return keep


def dedup_sorted(rows: RowGroup) -> RowGroup:
    """Collapse duplicate primary keys, keeping the FIRST row of each run."""
    keep = dedup_keep_mask(rows)
    if keep.all():
        return rows
    return rows.filter(keep)


def _sources_time_disjoint(view: ReadView, schema: Schema) -> bool:
    """True when no two sources can hold versions of one key: zero
    memtable rows (a memtable may hold in-place duplicates), the
    timestamp IS part of the primary key (an explicit PRIMARY KEY may
    exclude it, and then one key's versions can live in different time
    windows), and SST time ranges pairwise disjoint (versions of a
    ts-keyed key share its exact timestamp)."""
    if schema.timestamp_index not in schema.primary_key_indexes:
        return False
    for mem in view.memtables:
        if not mem.is_empty():
            return False
    spans = sorted(
        (h.meta.time_range.inclusive_start, h.meta.time_range.exclusive_end)
        for h in view.ssts
    )
    for (_, prev_end), (nxt_start, _) in zip(spans, spans[1:]):
        if nxt_start < prev_end:
            return False
    return True


def scan_sources(
    view: ReadView,
    schema: Schema,
    predicate: Predicate,
    store: ObjectStore,
    projection: Optional[Sequence[str]] = None,
) -> tuple[list[RowGroup], list[np.ndarray]]:
    """Materialize every source in the view as (rows, per-row version).

    Multi-SST reads from REMOTE stores fetch concurrently (the
    prefetchable-stream analog, ref: prefetchable_stream.rs +
    num_streams_to_prefetch): each SST is an independent network object,
    so overlap hides latency. Local-disk reads stay sequential — pyarrow
    already threads the decode and parallel mmap reads measured 0.95x.
    """
    parts: list[RowGroup] = []
    versions: list[np.ndarray] = []

    read_one, remote = _sst_read_fn(store, schema, predicate, projection)
    if remote and len(view.ssts) > 1:
        # Hint the store's page cache FIRST: while early SSTs decode in
        # pool slots, later ones stream into the cache in the background
        # (fetch/decode pipelining on cold scans).
        store.prefetch([h.path for h in view.ssts])
        # the IO pool, NOT scatter_pool: partition scatter tasks call into
        # this function, and nesting on one bounded pool deadlocks
        import contextvars

        from ..utils.runtime import io_pool

        # copied context per fetch: the per-request cost ledger (and any
        # active span) keeps accumulating from pool threads
        ctxs = [contextvars.copy_context() for _ in view.ssts]
        sst_rows = list(
            io_pool().map(lambda ch: ch[0].run(read_one, ch[1]), zip(ctxs, view.ssts))
        )
    else:
        sst_rows = [read_one(h) for h in view.ssts]
    for handle, rows in zip(view.ssts, sst_rows):
        if len(rows):
            parts.append(rows)
            versions.append(np.full(len(rows), handle.meta.max_sequence, dtype=np.uint64))
    proj_schema = project_schema(schema, projection)
    mem_rows = 0
    for mem in view.memtables:
        rows, seq = mem.scan(predicate)
        if len(rows):
            if projection is not None:
                rows = _project_rows(rows, proj_schema)
            parts.append(rows)
            versions.append(seq)
            mem_rows += len(rows)
    if mem_rows:
        from ..utils.querystats import record as _qs_record

        _qs_record(memtable_rows=mem_rows)
    return parts, versions


def _sst_read_fn(store, schema, predicate, projection):
    """(read_one(handle) -> RowGroup, is_remote) — the single definition
    of how a scan opens an SST and whether fetches should overlap
    (shared by the full scan and the limited scan)."""

    def read_one(handle):
        # per-SST checkpoint: the scan observes the query's budget /
        # cancel flag between (possibly remote) object-store fetches —
        # pool threads see it via the copied contexts
        from ..utils.deadline import checkpoint
        from ..utils.tracectx import span

        checkpoint("store")
        with span("sst_read") as sp:
            rows = SstReader(store, handle.path).read(
                schema, predicate, projection=projection
            )
            sp.set(rows=len(rows))
            return rows

    from ..utils.object_store import LocalDiskStore, MemoryStore

    return read_one, not isinstance(store, (LocalDiskStore, MemoryStore))


def _project_rows(rows: RowGroup, proj_schema: Schema) -> RowGroup:
    """Restrict memtable rows to the projected schema (shared by the
    full scan and the limited scan — keep the two paths identical)."""
    keep = proj_schema.names()
    return RowGroup(
        proj_schema,
        {k: rows.columns[k] for k in keep},
        {k: v for k, v in rows.validity.items() if k in keep},
    )


def _empty_rows(schema: Schema) -> RowGroup:
    return RowGroup(
        schema,
        {c.name: np.empty(0, dtype=c.kind.numpy_dtype) for c in schema.columns},
    )


def _limited_append_scan(
    view: ReadView,
    schema: Schema,
    predicate: Predicate,
    store: ObjectStore,
    projection: Optional[Sequence[str]] = None,
) -> RowGroup:
    """Early-stopping scan for APPEND tables with a pushed-down limit.

    Sources are consumed incrementally — memtables first (already in
    memory), then SSTs — and reading stops as soon as ``limit`` exact-
    time-filtered rows are collected, so a LIMIT 10 over a year of SSTs
    opens one file instead of hundreds. Remote stores fetch SSTs in
    concurrent batches (same prefetch rationale as scan_sources) so the
    early stop doesn't trade away latency hiding. May return MORE than
    limit rows (the executor slices); never fewer than available.
    """
    limit = predicate.limit or 0
    tr = predicate.time_range
    parts: list[RowGroup] = []
    total = 0

    def add(rows: RowGroup) -> bool:
        nonlocal total
        ts = rows.timestamps
        mask = (ts >= tr.inclusive_start) & (ts < tr.exclusive_end)
        if not mask.all():
            rows = rows.take(np.nonzero(mask)[0])
        if len(rows):
            parts.append(rows)
            total += len(rows)
        return total >= limit

    proj_schema = project_schema(schema, projection)
    done = False
    for mem in view.memtables:
        rows, _seq = mem.scan(predicate)
        if len(rows):
            from ..utils.querystats import record as _qs_record

            _qs_record(memtable_rows=len(rows))
        if projection is not None and len(rows):
            rows = _project_rows(rows, proj_schema)
        if add(rows):
            done = True
            break
    if not done:
        read_one, remote = _sst_read_fn(store, schema, predicate, projection)
        batch = 4 if remote else 1  # overlap network fetches per round
        ssts = list(view.ssts)
        for i in range(0, len(ssts), batch):
            chunk = ssts[i:i + batch]
            if remote:
                # Stream the NEXT batch into the page cache while this
                # one decodes; the early stop usually means batches after
                # that are never read — one batch of lookahead, not all.
                store.prefetch([h.path for h in ssts[i + batch:i + 2 * batch]])
            if remote and len(chunk) > 1:
                # io_pool, NOT scatter_pool — same nesting caveat as
                # scan_sources; contexts copied the same way too, so
                # ledger/span records from pool threads survive the hop
                # on the LIMIT fast path as well
                import contextvars

                from ..utils.runtime import io_pool

                ctxs = [contextvars.copy_context() for _ in chunk]
                results = list(
                    io_pool().map(
                        lambda cw: cw[0].run(read_one, cw[1]), zip(ctxs, chunk)
                    )
                )
            else:
                results = [read_one(h) for h in chunk]
            if any(add(r) for r in results):
                break
    if not parts:
        return _empty_rows(proj_schema)
    return RowGroup.concat(parts) if len(parts) > 1 else parts[0]


def merge_read(
    view: ReadView,
    schema: Schema,
    predicate: Predicate,
    store: ObjectStore,
    update_mode: UpdateMode,
    projection: Optional[Sequence[str]] = None,
    *,
    device,
) -> RowGroup:
    """Read a consistent, time-filtered, deduplicated row set; a large
    merge sorts on ``device`` (the table's).

    Column filters from the predicate are NOT applied — they run in the
    execution kernel AFTER dedup (an overwritten row version must not
    resurface just because the newest version fails the filter). For the
    same reason, value-filter ROW-GROUP PRUNING is disabled on dedup scans
    spanning multiple sources: pruning a group holding the newest version
    of a key would let an older version in another source survive dedup.
    Time-range pruning stays on everywhere (timestamp is a key column).

    ORDERING CONTRACT: the returned rows are NOT globally ordered, and
    callers must not assume they are. The dedup path happens to return
    rows sorted by (primary key, version) as a by-product of its sort,
    but every shortcut return skips that sort: APPEND scans and the
    single-SST fast path return source order, and the time-disjoint
    shortcut below returns a per-SST concatenation — each SST is
    key-sorted WITHIN its own time window, but windows are concatenated
    in level/file order, so rows of one series arrive as several sorted
    runs rather than one. Everything above this function (the executor's
    kernels, host aggregation, ORDER BY) re-groups or re-sorts as needed;
    a new caller that wants sorted output must sort explicitly.
    """
    if update_mode is UpdateMode.APPEND and predicate.limit is not None:
        # LIMIT pushdown: append tables never dedup, so ANY n matching
        # rows are a correct answer — stop opening SSTs once collected
        # (ref: the reference's ScanRequest carries a fetch limit).
        return _limited_append_scan(view, schema, predicate, store, projection)
    dedup_scan = update_mode is not UpdateMode.APPEND and (
        len(view.ssts) + len(view.memtables) > 1
    )
    disjoint = dedup_scan and _sources_time_disjoint(view, schema)
    if disjoint:
        # The flushed/compacted steady state: every SST is internally
        # deduped (flush and compaction both dedup), there are no
        # memtable rows, and the SSTs' time ranges are pairwise disjoint
        # — no key can have versions in two sources, so cross-source
        # dedup is impossible. That makes VALUE-filter row-group pruning
        # safe again (the newest version of a key is the only version),
        # which is exactly what a selective scan like usage_user > 90
        # needs to skip most pages (ref: row_group_pruner.rs:240-288
        # prunes with full predicates).
        dedup_scan = False
    if dedup_scan:
        # Key-column filters stay: every version of a key shares its key
        # values, so pruning by them can never separate versions. Only
        # value-column filters can hide the newest version of a key.
        key_cols = {
            schema.columns[i].name for i in schema.primary_key_indexes
        }
        scan_pred = predicate.restricted_to(key_cols)
    else:
        scan_pred = predicate
    parts, versions = scan_sources(view, schema, scan_pred, store, projection)
    out_schema = parts[0].schema if parts else project_schema(schema, projection)
    if not parts:
        return _empty_rows(out_schema)

    rows = RowGroup.concat(parts) if len(parts) > 1 else parts[0]
    version = np.concatenate(versions)

    # Exact time filter (timestamp is a key column: safe before dedup).
    tr = predicate.time_range
    ts = rows.timestamps
    mask = (ts >= tr.inclusive_start) & (ts < tr.exclusive_end)
    if not mask.all():
        idx = np.nonzero(mask)[0]
        rows, version = rows.take(idx), version[idx]

    if update_mode is UpdateMode.APPEND:
        return rows
    if len(parts) == 1 and len(view.memtables) == 0:
        # Single SST: flush/compaction already deduped it.
        return rows
    if disjoint:
        # Time-disjoint deduped SSTs (see above): nothing to merge —
        # rows are per-source concatenations (each key-sorted within its
        # window), like the APPEND chain.
        return rows
    # Device merge-dedup above a size threshold: the same sort +
    # shift-compare kernel compaction uses (ref: the read path IS the
    # merge iterator in the reference, row_iter/merge.rs:134-181 — here
    # it's one device sort instead of a BinaryHeap).
    tsid_idx = out_schema.tsid_index
    if tsid_idx is not None and len(rows) >= device_merge_min_rows(device):
        from ..ops.merge_dedup import merge_dedup_permutation

        tsid = rows.columns[out_schema.columns[tsid_idx].name]
        perm, keep = merge_dedup_permutation(
            tsid, rows.timestamps.astype(np.int64), version, dedup=True,
            device=device,
        )
        return rows.take(perm[keep])
    return dedup_sorted(rows.sorted_by_key(seq=version))
