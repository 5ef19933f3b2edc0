"""Primary-key sampling: suggest a pruning-friendly key order from the
first segment's writes
(ref: analytic_engine/src/sampler.rs:271-360 — PrimaryKeySampler counts
per-column cardinality with HLL while the sampling memtable fills, then
suggests lower-cardinality columns FIRST, tsid/timestamp appended last;
applied at first flush, table/version.rs:670-674).

TPU-first shape: the reference inserts rows into per-column HLLs one
datum at a time; here sampling is COLUMNAR — each write batch folds into
a bounded per-column distinct set via ``np.unique`` (exact up to a cap,
like the thetasketch analog in query/functions.py). Past the cap a
column is simply "high cardinality": its exact count can no longer
change the suggested ORDER, so counting stops.

Why order matters here: flush sorts rows by ``schema.primary_key_indexes``
(row_group.key_sort_permutation) and SST row-group pruning works off
min/max stats per group — leading with low-cardinality keys gives long
sorted runs per value, so predicate pruning skips whole row groups. The
dedup-sort in the merge path also gets cheaper: more presorted locality,
fewer long-range swaps.
"""

from __future__ import annotations

import threading

import numpy as np

from ..common_types.schema import Schema

# Exact-distinct cap per column: far above any cardinality that would be
# ranked first, far below memory concern (values kept as a set).
SAMPLE_DISTINCT_CAP = 8192
# Suggest at most this many leading key columns (ref:
# sampler.rs MAX_SUGGEST_PRIMARY_KEY_NUM = 2).
MAX_SUGGEST_PRIMARY_KEY_NUM = 2
# Don't suggest until at least this many rows were sampled.
MIN_SAMPLE_ROWS = 100


class PrimaryKeySampler:
    """Collects per-column cardinality over the first segment's writes.

    Candidate columns are the schema's key columns minus timestamp and
    tsid (both always sort LAST, in that relative order — they are the
    uniqueness tail, not the pruning prefix)."""

    def __init__(self, schema: Schema) -> None:
        self._lock = threading.Lock()
        ts_i = schema.timestamp_index
        tsid_i = schema.tsid_index
        self._candidates: dict[str, set] = {}
        self._saturated: set[str] = set()
        self._rows = 0
        for i in schema.primary_key_indexes:
            if i == ts_i or i == tsid_i:
                continue
            self._candidates[schema.columns[i].name] = set()

    @property
    def has_candidates(self) -> bool:
        return bool(self._candidates)

    def collect(self, rows) -> None:
        """Fold one write batch in (columnar, one np.unique per column)."""
        if not self._candidates or len(rows) == 0:
            return
        with self._lock:
            self._rows += len(rows)
            for name, seen in self._candidates.items():
                if name in self._saturated:
                    continue
                col = rows.columns.get(name)
                if col is None:
                    continue
                codes = getattr(col, "codes", None)
                if codes is not None:
                    # Dict column: map codes through THIS batch's vocab —
                    # code spaces are per-batch and not comparable across
                    # batches (two batches' code 0 may be different hosts).
                    vocab = col.values
                    for c in np.unique(np.asarray(codes)).tolist():
                        if 0 <= c < len(vocab):
                            seen.add(vocab[c])
                else:
                    seen.update(np.unique(np.asarray(col)).tolist())
                if len(seen) > SAMPLE_DISTINCT_CAP:
                    self._saturated.add(name)

    def suggest(self, schema: Schema) -> Schema | None:
        """A schema with re-ordered ``primary_key_indexes`` (low
        cardinality first, capped, tsid/ts last) — or None when too few
        samples or the order already matches."""
        with self._lock:
            if self._rows < MIN_SAMPLE_ROWS or not self._candidates:
                return None
            counts = {
                name: (float("inf") if name in self._saturated else len(seen))
                for name, seen in self._candidates.items()
            }
        # Tie-break by the USER'S declared position, not by name: equal
        # cardinalities must keep the explicit PRIMARY KEY order (a
        # reorder with zero pruning benefit would still churn the schema
        # version).
        declared = {
            schema.columns[i].name: pos
            for pos, i in enumerate(schema.primary_key_indexes)
        }
        ranked = sorted(
            counts, key=lambda n: (counts[n], declared.get(n, 1 << 30))
        )
        lead = ranked[:MAX_SUGGEST_PRIMARY_KEY_NUM]
        rest = [n for n in ranked if n not in lead]
        tail_idx = [
            i for i in schema.primary_key_indexes
            if i in (schema.tsid_index, schema.timestamp_index)
        ]
        new_order = tuple(
            [schema.index_of(n) for n in lead + rest] + tail_idx
        )
        if new_order == schema.primary_key_indexes:
            return None
        return Schema(
            schema.columns,
            schema.timestamp_index,
            new_order,
            version=schema.version + 1,
        )
