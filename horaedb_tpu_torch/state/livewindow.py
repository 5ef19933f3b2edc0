"""Live window state: device-resident incremental aggregates for the
open tail (ROADMAP item 1; ref: StreamBox-HBM's ingest-time grouping
into HBM, PAPERS.md). Each state's ring lives on its table's device; on a
card every fold, growth and gather runs on the one live-window CUDA
stream of that device, so a refresh right after an acknowledged write
sees its rows, and one launch can fold every state of a table.

Rollups (rules/rewrite.py) answer for CLOSED buckets; the open tail —
the "last 5m" edge every dashboard re-asks — still rescanned raw. This
module keeps that tail as STATE: per hot (table, window, group-set)
shape, a fixed-size device ring of (count, sum, min, max) partials per
time bucket. A committed batch folds into every state of its table in
ONE launch (ops/livewindow.py ``fold_batches``, ``csrc/livewindow.cu`` on
a card), so an open-tail refresh is a gather over O(buckets) partials
instead of a raw rescan.

Correctness contract (answers are never wrong):

- Additive partials are order-free — a late row landing in a
  still-RESIDENT bucket folds in exactly.
- A row OLDER than the ring's tail cannot fold (its slot was reused);
  its bucket is marked dirty-for-rescan. Dirty buckets sit below the
  serving floor by construction — any query touching them reads raw
  (``horaedb_livewindow_dirty_rescan_total`` counts those reads).
- ``valid_from`` guards the promotion race: the state registers (so
  concurrent commits fold) BEFORE the table's max timestamp is read;
  serving starts strictly above that bucket, so every pre-registration
  row sits below the floor.
- NULL / non-finite values in the value column cannot be represented by
  the monoid cells; a batch carrying one drops the state (the shape can
  re-promote; meanwhile every read is raw). So does a state whose
  preparation raises, and every state of a fold launch that fails (a
  kernel that fails to build or launch): the write still succeeds, each
  such state is dropped and logged, and ``ops.livewindow.FOLD_ERRORS``
  counts it. A state is dropped while its lock is held, so a reader that
  waited on the lock finds it gone.
- PromQL counter chains are order-SENSITIVE: per-bucket increments are
  folded at write time (same-bucket consecutive pairs), per-bucket
  first/last samples ride a packed host sidecar, and cross-bucket
  deltas are reconstructed at read time. An out-of-order sample marks
  the spanned buckets counter-dirty — counter reads above that span
  stay exact, reads into it fall back to raw.

Promotion is usage-driven (the PR-6 dtype auto-tuner discipline): the
executor hook counts eligible open-tail reads per shape and promotes at
``HORAEDB_LIVEWINDOW_PROMOTE`` sightings. Eviction is LRU under the
``HORAEDB_LIVEWINDOW_BUDGET`` byte budget; every byte is accounted
through ``register_occupancy_provider`` (component="state" rows in
``system.public.device``). Promote/evict choices are journaled in the
decision plane (loop="livewindow": predicted hit-count vs realized hits
before eviction). ``HORAEDB_LIVEWINDOW=0`` kills fold, serve, and
promotion; states dropped on the next write so a re-enable can never
serve a fold gap.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..common_types.dict_column import DictColumn
from ..common_types.schema import TSID_COLUMN
from ..common_types.time_range import MAX_TIMESTAMP, MIN_TIMESTAMP
from ..engine.options import UpdateMode
from ..query import ast
from ..query.plan import QueryPlan
from ..utils.env import env_int
from ..utils.metrics import REGISTRY

_log = logging.getLogger("horaedb_tpu_torch.state.livewindow")

_FOLDABLE = ("sum", "count", "min", "max", "avg")

_INT64_MAX = np.iinfo(np.int64).max
_FAR_PAST = -(2**61)

# Registry discipline (lint-enforced like DEVICE_METRIC_FAMILIES):
# declared here, registered eagerly, documented in docs/OBSERVABILITY.md,
# no stray horaedb_livewindow_* family outside this tuple.
LIVEWINDOW_METRIC_FAMILIES = (
    "horaedb_livewindow_reads_total",
    "horaedb_livewindow_folds_total",
    "horaedb_livewindow_dirty_rescan_total",
    "horaedb_livewindow_evictions_total",
    "horaedb_livewindow_resident_bytes",
)

_M_READS = REGISTRY.counter(
    "horaedb_livewindow_reads_total",
    "queries served (in part) from live window state, by read kind",
    labels={"kind": "sql"},
)
_M_READS_PROMQL = REGISTRY.counter(
    "horaedb_livewindow_reads_total",
    "queries served (in part) from live window state, by read kind",
    labels={"kind": "promql"},
)
_M_FOLDS = REGISTRY.counter(
    "horaedb_livewindow_folds_total",
    "ingest batches folded into live window rings",
)
_M_DIRTY = REGISTRY.counter(
    "horaedb_livewindow_dirty_rescan_total",
    "reads that rescanned raw because of dirty (below-tail/out-of-order) buckets",
)
_M_EVICTIONS = REGISTRY.counter(
    "horaedb_livewindow_evictions_total",
    "live window states evicted (LRU under the byte budget)",
)
_M_RESIDENT = REGISTRY.gauge(
    "horaedb_livewindow_resident_bytes",
    "device bytes held by live window ring state",
)


# ---- knobs ([state] table in docs/WORKLOAD.md) ---------------------------


def livewindow_enabled() -> bool:
    """HORAEDB_LIVEWINDOW=0 kills fold + serve + promotion (read per
    call so tests/operators can flip it live)."""
    return os.environ.get("HORAEDB_LIVEWINDOW", "1") != "0"


def budget_bytes() -> int:
    return env_int("HORAEDB_LIVEWINDOW_BUDGET", 64 << 20)


def ring_depth() -> int:
    return max(8, env_int("HORAEDB_LIVEWINDOW_DEPTH", 128))


def promote_reads() -> int:
    return max(1, env_int("HORAEDB_LIVEWINDOW_PROMOTE", 3))


def max_groups() -> int:
    return max(8, env_int("HORAEDB_LIVEWINDOW_MAX_GROUPS", 4096))


# ---- tag-filter conjuncts -------------------------------------------------
# The serve side applies tag filters to the state's group tuples on
# host, so the ONE predicate must only admit conjunct shapes the tiny
# evaluator below supports (SQL three-valued logic: NULL compares false).


def _cmp(op: str, a, b) -> bool:
    if a is None or b is None:
        return False
    try:
        if op == "=":
            return bool(a == b)
        if op in ("!=", "<>"):
            return bool(a != b)
        if op == "<":
            return bool(a < b)
        if op == "<=":
            return bool(a <= b)
        if op == ">":
            return bool(a > b)
        if op == ">=":
            return bool(a >= b)
    except TypeError:
        return False
    return False


def _conj_supported(e: ast.Expr, tags: set) -> bool:
    if isinstance(e, ast.BinaryOp):
        if e.op in ("AND", "OR"):
            return _conj_supported(e.left, tags) and _conj_supported(e.right, tags)
        if e.op in ("=", "!=", "<>", "<", "<=", ">", ">="):
            l, r = e.left, e.right
            if isinstance(l, ast.Literal) and isinstance(r, ast.Column):
                l, r = r, l
            return (
                isinstance(l, ast.Column)
                and l.name in tags
                and isinstance(r, ast.Literal)
            )
        return False
    if isinstance(e, ast.UnaryOp) and e.op == "NOT":
        return _conj_supported(e.operand, tags)
    if isinstance(e, ast.InList):
        return (
            isinstance(e.expr, ast.Column)
            and e.expr.name in tags
            and all(isinstance(i, ast.Literal) for i in e.values)
        )
    if isinstance(e, ast.Between):
        return (
            isinstance(e.expr, ast.Column)
            and e.expr.name in tags
            and isinstance(e.low, ast.Literal)
            and isinstance(e.high, ast.Literal)
        )
    return False


def _eval_conj(e: ast.Expr, vals: dict) -> bool:
    if isinstance(e, ast.BinaryOp):
        if e.op == "AND":
            return _eval_conj(e.left, vals) and _eval_conj(e.right, vals)
        if e.op == "OR":
            return _eval_conj(e.left, vals) or _eval_conj(e.right, vals)
        l, r, op = e.left, e.right, e.op
        if isinstance(l, ast.Literal) and isinstance(r, ast.Column):
            l, r = r, l
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        return _cmp(op, vals.get(l.name), r.value)
    if isinstance(e, ast.UnaryOp) and e.op == "NOT":
        return not _eval_conj(e.operand, vals)
    if isinstance(e, ast.InList):
        v = vals.get(e.expr.name)
        hit = v is not None and any(v == i.value for i in e.values)
        return (not hit) if e.negated else hit
    if isinstance(e, ast.Between):
        v = vals.get(e.expr.name)
        hit = v is not None and e.low.value <= v <= e.high.value
        return (not hit) if e.negated else hit
    return False


# ---- the per-shape state --------------------------------------------------

_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def _device_stream(device: torch.device):
    """The live-window CUDA stream of ``device`` (None off a card): every
    state there folds, grows and gathers on it, so one launch can fold
    several states and a reader orders behind the folds it must see."""
    if device.type != "cuda":
        return None
    with _STREAMS_LOCK:
        stream = _STREAMS.get(device)
        if stream is None:
            stream = _STREAMS[device] = torch.cuda.Stream(device)
        return stream


class LiveState:
    """One promoted (table, window, group-set) shape's ring state."""

    def __init__(self, key: str, table_name: str, ts_col: str,
                 value_col: str, tags: tuple, bucket_ms: int,
                 depth: int, table_data, device=None) -> None:
        from ..ops.livewindow import alloc_rings

        self.key = key
        self.table_name = table_name
        self.ts_col = ts_col
        self.value_col = value_col
        self.tags = tags  # grouping tags, plan order
        self.all_tags = False  # set by the store: group-set == full tag set
        self.bucket_ms = int(bucket_ms)
        self.depth = int(depth)
        self.cap = 64
        self.lock = threading.RLock()
        # the table's device (``device`` only for a state with no table,
        # as convert.livestate_from_reference builds); on a card, the
        # device's live-window stream, which orders every state's folds,
        # growths and gathers there
        self.device = torch.device(device if device is not None else table_data.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = _device_stream(self.device)
        with self.on_device():
            self.rings = alloc_rings(self.depth, self.cap, self.device)
        # host sidecar for the counter chain: packed (ts_rel<<32 | f32
        # bits) first/last sample per (slot, group)
        self.firsts = np.full((self.depth, self.cap), _INT64_MAX, np.int64)
        self.lasts = np.full((self.depth, self.cap), -1, np.int64)
        self.head = None  # highest folded bucket id; None = empty ring
        self.valid_from = _INT64_MAX  # first servable bucket id
        self.max_folded_ts = _FAR_PAST
        self.group_slots: dict[tuple, int] = {}
        self.group_vals: list[tuple] = []
        self.tsid_slot: dict[int, int] = {}
        self.series_last: dict[int, tuple] = {}  # tsid -> (ts, value)
        self.dirty: set[int] = set()  # below-tail late-row buckets
        self.counter_dirty: set[int] = set()  # broken counter-chain buckets
        self.reads_served = 0
        self.last_hit = time.time()
        self.created_at = time.time()
        self.anchor = (
            weakref.ref(table_data) if table_data is not None else (lambda: None)
        )

    def on_device(self):
        """The context every ring operation of this state runs in."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # -- residency --------------------------------------------------------

    def nbytes(self) -> int:
        from ..ops.livewindow import rings_nbytes

        return rings_nbytes(self.depth, self.cap)

    def tail(self) -> int:
        """Lowest resident bucket id (the ring covers [tail, head])."""
        return (self.head - self.depth + 1) if self.head is not None else _INT64_MAX

    def serve_floor(self, counter: bool = False) -> int:
        """First bucket id servable from state."""
        lo = max(self.valid_from, self.tail())
        if counter and self.counter_dirty:
            lo = max(lo, max(self.counter_dirty) + 1)
        return lo

    # -- write-time fold --------------------------------------------------

    def prepare(self, rows):
        """The host half of a fold: advance the head, map the rows to ring
        cells, run the counter chain. Returns the ``FoldBatch`` to launch,
        None when there is nothing to fold, or False when the state must
        be dropped (unrepresentable batch: NULL/non-finite values). The
        caller holds the lock until the batch is enqueued on the state's
        stream, and reads ``rings`` after this returns (it may grow)."""
        from ..ops.livewindow import FoldBatch

        w = self.bucket_ms
        ts = np.asarray(rows.timestamps, dtype=np.int64)
        n = len(ts)
        if n == 0:
            return None
        raw = rows.column(self.value_col)
        if isinstance(raw, DictColumn):
            return False
        vals = np.asarray(raw, dtype=np.float64)
        if not rows.valid_mask(self.value_col).all() or not np.isfinite(vals).all():
            return False
        bucket = ts // w

        # group mapping: tsid -> dense slot (vectorized over UNIQUE series)
        if self.tags:
            if TSID_COLUMN not in rows.columns:
                return False
            tsid = np.asarray(rows.column(TSID_COLUMN), dtype=np.int64)
            uniq, inv = np.unique(tsid, return_inverse=True)
            first_idx = np.full(len(uniq), n, dtype=np.int64)
            np.minimum.at(first_idx, inv, np.arange(n, dtype=np.int64))
            slot_of = np.empty(len(uniq), dtype=np.int32)
            for j, sid in enumerate(uniq):
                g = self.tsid_slot.get(int(sid))
                if g is None:
                    i = int(first_idx[j])
                    key = tuple(_tag_at(rows, t, i) for t in self.tags)
                    g = self.group_slots.get(key)
                    if g is None:
                        g = self._add_group(key)
                        if g is None:
                            return False  # over HORAEDB_LIVEWINDOW_MAX_GROUPS
                    self.tsid_slot[int(sid)] = g
                slot_of[j] = g
            grp = slot_of[inv]
        else:
            tsid = np.zeros(n, dtype=np.int64)
            if not self.group_vals:
                self._add_group(())
            grp = np.zeros(n, dtype=np.int32)

        # ring advance: slots for buckets (old head, new head] re-init
        # INSIDE the fold dispatch via reset_mask
        bmax = int(bucket.max())
        reset = np.zeros(self.depth, dtype=np.bool_)
        if self.head is None:
            self.head = bmax  # fresh rings are already at init state
        elif bmax > self.head:
            adv = bmax - self.head
            if adv >= self.depth:
                reset[:] = True
            else:
                ids = np.arange(self.head + 1, bmax + 1, dtype=np.int64)
                reset[ids % self.depth] = True
            self.head = bmax
            self.firsts[reset] = _INT64_MAX
            self.lasts[reset] = -1
            if self.dirty:
                horizon = self.tail() - 4 * self.depth
                self.dirty = {b for b in self.dirty if b >= horizon}
            if self.counter_dirty:
                self.counter_dirty = {
                    b for b in self.counter_dirty if b >= self.tail()
                }

        tail = self.tail()
        in_ring = bucket >= tail
        if not in_ring.all():
            # older than the ring's tail: can't fold (slot reused) —
            # dirty-for-rescan; those buckets are below the serving
            # floor so answers stay exact
            self.dirty.update(int(b) for b in np.unique(bucket[~in_ring]))
        slot = np.where(in_ring, bucket % self.depth, self.depth).astype(np.int32)

        p_slot, p_grp, p_delta = self._counter_prep(
            ts, vals, bucket, slot, grp, tsid, tail
        )
        self.max_folded_ts = max(self.max_folded_ts, int(ts.max()))
        return FoldBatch(reset, slot, grp, vals.astype(np.float32), p_slot, p_grp, p_delta)

    def _add_group(self, key: tuple) -> Optional[int]:
        from ..ops.livewindow import grow_rings

        g = len(self.group_vals)
        if g >= max_groups():
            return None
        if g >= self.cap:
            newcap = self.cap * 2
            extra = newcap - self.cap
            with self.on_device():
                self.rings = grow_rings(self.rings, newcap)
            self.firsts = np.pad(
                self.firsts, ((0, 0), (0, extra)), constant_values=_INT64_MAX
            )
            self.lasts = np.pad(
                self.lasts, ((0, 0), (0, extra)), constant_values=-1
            )
            self.cap = newcap
        self.group_slots[key] = g
        self.group_vals.append(key)
        return g

    def _counter_prep(self, ts, vals, bucket, slot, grp, tsid, tail):
        """Write-time counter chain: reset-adjusted deltas of
        consecutive SAME-SERIES SAME-BUCKET pairs (cross-bucket pairs
        are reconstructed at read time from the first/last sidecar).
        Returns the pair scatter arrays; updates sidecar + dirty sets.
        Vectorized over rows; python loops touch UNIQUE series only."""
        empty = (np.empty(0, np.int32), np.empty(0, np.int32),
                 np.empty(0, np.float32))
        if not self.all_tags:
            return empty
        w = self.bucket_ms
        order = np.lexsort((ts, tsid))
        sts, sv = ts[order], vals[order]
        sbucket, sslot = bucket[order], slot[order]
        sgrp, stsid = grp[order], tsid[order]
        n = len(sts)

        new_series = np.empty(n, dtype=np.bool_)
        new_series[0] = True
        new_series[1:] = stsid[1:] != stsid[:-1]
        starts = np.flatnonzero(new_series)
        ends = np.append(starts[1:], n) - 1

        # splice the carried per-series last sample in front of each run
        prev_ts = np.empty(n, dtype=np.int64)
        prev_v = np.empty(n, dtype=np.float64)
        prev_ok = np.empty(n, dtype=np.bool_)
        prev_ts[1:], prev_v[1:] = sts[:-1], sv[:-1]
        prev_ok[1:] = ~new_series[1:]
        prev_ok[0] = False
        for i in starts:
            carried = self.series_last.get(int(stsid[i]))
            if carried is not None:
                prev_ts[i], prev_v[i] = carried
                prev_ok[i] = True
        # update carried lasts to each run's final sample
        for i, j in zip(starts, ends):
            self.series_last[int(stsid[i])] = (int(sts[j]), float(sv[j]))

        # out-of-order / duplicate timestamps break the chain for the
        # spanned buckets: additive partials stay exact, counter reads
        # into the span fall back to raw
        ooo = prev_ok & (prev_ts >= sts)
        for i in np.flatnonzero(ooo):
            lo_b, hi_b = int(sts[i] // w), int(prev_ts[i] // w)
            self.counter_dirty.update(range(lo_b, hi_b + 1))
            if len(self.counter_dirty) > 8192:
                self.counter_dirty = {max(self.counter_dirty)}
        good = prev_ok & ~ooo

        # packed first/last sidecar per (slot, group) — in-ring rows only
        ring_rows = sslot < self.depth
        ts_rel = sts - sbucket * w
        packed = (ts_rel.astype(np.int64) << 32) | (
            sv.astype(np.float32).view(np.uint32).astype(np.int64)
        )
        ri = np.flatnonzero(ring_rows)
        if len(ri):
            np.minimum.at(self.firsts, (sslot[ri], sgrp[ri]), packed[ri])
            np.maximum.at(self.lasts, (sslot[ri], sgrp[ri]), packed[ri])

        # same-bucket consecutive pairs -> write-time increments
        pair = good & (prev_ts // w == sbucket) & ring_rows
        pi = np.flatnonzero(pair)
        if not len(pi):
            return empty
        delta = sv[pi] - prev_v[pi]
        delta = np.where(delta < 0, sv[pi], delta)  # counter reset
        return (
            sslot[pi].astype(np.int32),
            sgrp[pi].astype(np.int32),
            delta.astype(np.float32),
        )

    # -- read-time gather -------------------------------------------------

    def read_buckets(self, b_lo: int, b_hi: int):
        """Host partials for bucket ids [b_lo, b_hi] (must be resident):
        (bucket_ids, counts, sums, mins, maxs, inc, firsts, lasts) with
        arrays shaped [n_buckets, n_groups]."""
        from ..ops.livewindow import gather_buckets

        hi = min(b_hi, self.head if self.head is not None else b_lo - 1)
        if hi < b_lo:
            z = np.zeros((0, len(self.group_vals)))
            return ([], z.astype(np.int64), z, z, z, z,
                    z.astype(np.int64), z.astype(np.int64))
        ids = list(range(b_lo, hi + 1))
        slots = [b % self.depth for b in ids]
        g = len(self.group_vals)
        with self.on_device():
            # only the g used group columns leave the card
            counts, sums, mins, maxs, inc = gather_buckets(self.rings, slots, g)
        return (
            ids, counts[:, :g], sums[:, :g], mins[:, :g], maxs[:, :g],
            inc[:, :g], self.firsts[slots, :g], self.lasts[slots, :g],
        )


def _unpack_v(packed: np.ndarray) -> np.ndarray:
    """Low 32 bits of a packed sidecar cell -> the f32 sample value."""
    return (
        (packed & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
        .astype(np.float64)
    )


def try_livewindow_counter(table_name: str, table, value_col: str,
                           start_ms: int, end_ms: int, step_ms: int,
                           push_matchers: list):
    """Serve the PromQL counter chain's resident COMPLETE buckets from
    the write-time folded increments (proxy/promql._counter_series):
    same-bucket consecutive-pair deltas were folded at ingest into the
    ``inc`` ring; cross-bucket deltas are reconstructed here from the
    packed first/last sidecar. Returns None (raw fold) or::

        {"serve_lo": ms, "tail_lo": ms, "n_buckets": int,
         "series": {canonical_key: {"buckets": {prom_bucket_ms: inc},
                                    "first": (ts, v), "last": (ts, v)}}}

    The caller bounds its raw scan to ``ts < serve_lo OR ts >= tail_lo``
    and stitches the chain at both boundaries; a head boundary delta
    counts only when the raw side has samples for the series (prom's
    in-range consecutive-pair rule). Only all-tag states qualify (the
    prom series key IS the full tag set) and the state window must
    divide the step so every ring bucket lands in exactly one step.
    """
    if not livewindow_enabled():
        return None
    cand = None
    for s in STORE.states_for_table(table_name):
        if (
            s.all_tags
            and s.value_col == value_col
            and step_ms % s.bucket_ms == 0
            and s.anchor() is getattr(table, "data", None)
        ):
            cand = s
            break
    if cand is None:
        return None
    w = cand.bucket_ms
    with cand.lock:
        if cand.head is None or STORE.get(cand.key) is not cand:
            return None
        b_lo = max(cand.serve_floor(counter=True), -(-start_ms // w))
        b_hi = min(cand.head, (end_ms + 1) // w - 1)
        # a counter-dirty span that actually cut servable buckets in
        # this range is a forced rescan
        plain_lo = max(cand.serve_floor(), -(-start_ms // w))
        if plain_lo < b_lo and plain_lo <= b_hi:
            _M_DIRTY.inc()
        if b_hi < b_lo:
            return None
        ids, counts, _s, _mn, _mx, inc, firsts, lasts = cand.read_buckets(
            b_lo, b_hi
        )
        groups = list(cand.group_vals)
        tags = cand.tags
        cand.reads_served += 1
        cand.last_hit = time.time()

    ids_arr = np.asarray(ids, dtype=np.int64)
    has = firsts != _INT64_MAX
    out_series: dict = {}
    for g, gv in enumerate(groups):
        # the pushed =/!= matchers the raw scan applies in SQL, with
        # SQL's three-valued semantics: a NULL tag fails both
        keep = True
        for label, op, val in push_matchers:
            try:
                tv = gv[tags.index(label)]
            except ValueError:
                keep = False
                break
            if tv is None or (str(tv) == str(val)) != (op == "="):
                keep = False
                break
        if not keep:
            continue
        ks = np.flatnonzero(has[:, g])
        if not len(ks):
            continue
        f_rel = (firsts[ks, g] >> 32).astype(np.int64)
        l_rel = (lasts[ks, g] >> 32).astype(np.int64)
        f_v = _unpack_v(firsts[ks, g])
        l_v = _unpack_v(lasts[ks, g])
        b_ms = ids_arr[ks] * w
        pb = (b_ms // step_ms) * step_ms  # W | step: one step per bucket
        buckets: dict = {}
        inc_g = np.asarray(inc)[ks, g]
        cnt_g = np.asarray(counts)[ks, g]
        for k in range(len(ks)):
            d = float(inc_g[k])
            pairs = int(cnt_g[k]) - 1  # intra-bucket consecutive pairs
            if k:
                cd = float(f_v[k] - l_v[k - 1])
                if cd < 0:
                    cd = float(f_v[k])  # counter reset across buckets
                d += cd
                pairs += 1
            # parity with the raw fold: a pair's delta lands in the
            # bucket even at 0.0; a single-sample bucket emits no point
            if pairs > 0:
                b = int(pb[k])
                buckets[b] = buckets.get(b, 0.0) + d
        key = tuple(sorted(zip(tags, gv)))
        out_series[key] = {
            "buckets": buckets,
            "first": (int(b_ms[0] + f_rel[0]), float(f_v[0])),
            "last": (int(b_ms[-1] + l_rel[-1]), float(l_v[-1])),
        }
    if not out_series:
        return None  # nothing resident matched: one raw scan is simpler
    _M_READS_PROMQL.inc()
    return {
        "serve_lo": b_lo * w,
        "tail_lo": (b_hi + 1) * w,
        "n_buckets": int(b_hi - b_lo + 1),
        "series": out_series,
    }


def _tag_at(rows, name: str, i: int):
    if not rows.valid_mask(name)[i]:
        return None
    col = rows.column(name)
    if isinstance(col, DictColumn):
        v = col.values[int(col.codes[i])]
    else:
        v = col[i]
    return v.item() if isinstance(v, np.generic) else v


# ---- the store ------------------------------------------------------------


class LiveWindowStore:
    """Process-global registry of promoted shapes: usage-driven
    promotion, LRU eviction under the byte budget, the occupancy
    provider, and the write-path fold entry point."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._states: dict[str, LiveState] = {}
        self._by_table: dict[str, list[str]] = {}
        self._usage: dict[str, int] = {}
        self._evictions: dict[str, int] = {}
        self._registered = False

    # -- lookup -----------------------------------------------------------

    def get(self, key: str) -> Optional[LiveState]:
        with self._lock:
            return self._states.get(key)

    def states_for_table(self, table_name: str) -> list[LiveState]:
        with self._lock:
            keys = self._by_table.get(table_name, [])
            return [self._states[k] for k in keys if k in self._states]

    def total_bytes(self) -> int:
        with self._lock:
            return sum(s.nbytes() for s in self._states.values())

    # -- occupancy provider (obs/device) ----------------------------------

    def snapshot_device(self) -> list[dict]:
        now = time.time()
        with self._lock:
            states = list(self._states.values())
            evictions = dict(self._evictions)
        rows = []
        for s in states:
            rows.append({
                "table_name": s.table_name,
                "column_name": s.value_col,
                "component": "state",
                "dtype": "f32",
                "bytes": int(s.nbytes()),
                "rows": int(s.depth * s.cap),
                "last_hit_age_ms": int((now - s.last_hit) * 1000),
                "evictions": int(evictions.get(s.table_name, 0)),
            })
        return rows

    def _refresh_gauge(self) -> None:
        _M_RESIDENT.set(float(self.total_bytes()))

    # -- write path (engine/instance ingest hook) -------------------------

    def on_write(self, table_data, rows) -> None:
        """Called after each committed write group, before its writers
        are acknowledged. Cheap when the table has no state. Never raises
        into the write path: whatever fails, every state of the table that
        may have missed the batch is dropped (reads go raw and stay
        exact), logged and counted in ``ops.livewindow.FOLD_ERRORS``."""
        try:
            self._fold_committed(table_data, rows)
        except Exception:
            _log.exception("live-window write hook failed for %s: its states dropped",
                           table_data.name)
            self.drop_table(table_data.name, outcome="fold_error")

    def _fold_committed(self, table_data, rows) -> None:
        from ..ops import livewindow as lw_ops

        states = self.states_for_table(table_data.name)
        if not states:
            return
        if not livewindow_enabled():
            # a fold gap would poison a later re-enable: drop now
            for s in states:
                self.drop(s.key, outcome="disabled")
            return
        # another incarnation of the name owns its own writes; the locks go
        # in key order, so two writers of one table cannot deadlock
        mine = sorted((s for s in states if s.anchor() is table_data), key=lambda s: s.key)
        with contextlib.ExitStack() as held:
            groups: dict = {}
            for s in mine:
                held.enter_context(s.lock)
                try:
                    batch = s.prepare(rows)
                except Exception:
                    # the write has succeeded; a state that missed this
                    # batch must not serve, so it goes, and the miss is
                    # counted
                    lw_ops.FOLD_ERRORS += 1
                    _log.exception("live-window fold failed for %s: state dropped", s.key)
                    self.drop(s.key, outcome="fold_error")
                    continue
                if batch is False:
                    self.drop(s.key, outcome="unfoldable")
                elif batch is not None:
                    groups.setdefault(s.device, []).append((s, batch))
            # one launch a device for every state that prepared, enqueued
            # before any lock goes; the rings are read after every prep
            for group in groups.values():
                try:
                    with group[0][0].on_device():
                        lw_ops.fold_batches([s.rings for s, _ in group], [b for _, b in group])
                except Exception:
                    _log.exception("live-window fold launch failed for %s: its %d states "
                                   "dropped", table_data.name, len(group))
                    for s, _ in group:
                        lw_ops.FOLD_ERRORS += 1
                        self.drop(s.key, outcome="fold_error")
                    continue
                for _ in group:
                    _M_FOLDS.inc()

    # -- promotion / eviction ---------------------------------------------

    def note_usage(self, shape_key: str, catalog, table, shape) -> None:
        """One eligible open-tail read that could NOT be state-served;
        at the promote threshold the shape becomes live state."""
        if not livewindow_enabled():
            return
        with self._lock:
            n = self._usage.get(shape_key, 0) + 1
            self._usage[shape_key] = n
        if n < promote_reads():
            return
        self.promote(shape_key, table, shape, observed_reads=n)

    def promote(self, shape_key: str, table, shape,
                observed_reads: int = 0) -> Optional[LiveState]:
        from ..obs.decisions import record_decision
        from ..obs.device import refresh_occupancy, register_occupancy_provider

        table_data = getattr(table, "data", None)
        if table_data is None:
            return None  # no engine write path -> the hook never fires
        if table.options.update_mode is not UpdateMode.APPEND:
            return None  # overwrite dedup would double-fold re-writes
        table_name, ts_col, value_col, tags, step_ms = shape
        with self._lock:
            if shape_key in self._states:
                return self._states[shape_key]
            state = LiveState(
                shape_key, table_name, ts_col, value_col, tags, step_ms,
                ring_depth(), table_data,
            )
            schema = table.schema
            all_tags = tuple(
                schema.columns[i].name for i in schema.tag_indexes
            )
            state.all_tags = set(tags) == set(all_tags)
            # register FIRST: concurrent commits fold from here on, so
            # the max-ts read below can only OVER-estimate valid_from
            self._states[shape_key] = state
            self._by_table.setdefault(table_name, []).append(shape_key)
            self._usage.pop(shape_key, None)
            if not self._registered:
                register_occupancy_provider(self)
                self._registered = True
        try:
            rg = table.read(projection=[ts_col])
            max_ts = int(rg.timestamps.max()) if len(rg) else None
        except Exception:
            self.drop(shape_key, journal=False)
            return None
        with state.lock:
            state.valid_from = (
                (max_ts // step_ms) + 1 if max_ts is not None
                else _FAR_PAST // step_ms
            )
        record_decision(
            "livewindow", key=shape_key, choice="promote",
            features={
                "reads_before": int(observed_reads),
                "depth": state.depth,
                "window_ms": step_ms,
                "bytes": state.nbytes(),
            },
            # grade: at least as many state-served reads before eviction
            # as eligible reads observed before promotion
            predicted=float(max(observed_reads, promote_reads())),
        )
        self._evict_over_budget()
        self._refresh_gauge()
        refresh_occupancy(force=True)
        return state

    def drop(self, key: str, outcome: str = "dropped",
             journal: bool = True) -> None:
        from ..obs.decisions import DECISION_JOURNAL
        from ..obs.device import refresh_occupancy

        with self._lock:
            state = self._states.pop(key, None)
            if state is None:
                return
            keys = self._by_table.get(state.table_name)
            if keys and key in keys:
                keys.remove(key)
                if not keys:
                    self._by_table.pop(state.table_name, None)
            if outcome == "evict":
                self._evictions[state.table_name] = (
                    self._evictions.get(state.table_name, 0) + 1
                )
        if journal:
            DECISION_JOURNAL.resolve_matching(
                "livewindow", key,
                actual=float(state.reads_served), outcome=outcome,
            )
        if outcome == "evict":
            _M_EVICTIONS.inc()
        self._refresh_gauge()
        refresh_occupancy(force=True)

    def drop_table(self, table_name: str, outcome: str) -> None:
        """Drop every state of ``table_name`` after a failed write hook;
        each one counts in ``ops.livewindow.FOLD_ERRORS``."""
        from ..ops import livewindow as lw_ops

        with self._lock:
            keys = list(self._by_table.get(table_name, []))
        for key in keys:
            lw_ops.FOLD_ERRORS += 1
            try:
                self.drop(key, outcome=outcome)
            except Exception:
                # drop() unregisters the state before its bookkeeping
                _log.exception("live-window drop of %s failed after unregistering", key)

    def _evict_over_budget(self) -> None:
        budget = budget_bytes()
        while True:
            with self._lock:
                total = sum(s.nbytes() for s in self._states.values())
                if total <= budget or not self._states:
                    return
                victim = min(
                    self._states.values(), key=lambda s: s.last_hit
                )
            self.drop(victim.key, outcome="evict")

    def clear(self) -> None:
        for key in list(self._states):
            self.drop(key, journal=False)
        with self._lock:
            self._usage.clear()

    def stats(self) -> dict:
        with self._lock:
            states = list(self._states.values())
            usage = dict(self._usage)
        return {
            "enabled": livewindow_enabled(),
            "budget_bytes": budget_bytes(),
            "resident_bytes": sum(s.nbytes() for s in states),
            "states": [
                {
                    "key": s.key,
                    "table": s.table_name,
                    "window_ms": s.bucket_ms,
                    "tags": list(s.tags),
                    "depth": s.depth,
                    "groups": len(s.group_vals),
                    "bytes": s.nbytes(),
                    "head_bucket": s.head,
                    "valid_from": s.valid_from,
                    "dirty_buckets": len(s.dirty),
                    "counter_dirty": len(s.counter_dirty),
                    "reads_served": s.reads_served,
                }
                for s in states
            ],
            "pending": usage,
        }


STORE = LiveWindowStore()


def on_write(table_data, rows) -> None:
    """The engine write-path hook (engine/instance._commit_write_group)."""
    STORE.on_write(table_data, rows)


# ---- the ONE eligibility predicate (executor + EXPLAIN) -------------------


@dataclass(frozen=True)
class LiveWindowDecision:
    state_key: str
    table: str
    step_ms: int
    # the state serves COMPLETE buckets [s_lo, s_hi); raw computes the
    # partial head [start, s_lo) and (for a bounded end at/below the
    # folded watermark) the partial tail [s_hi, end)
    s_lo: int
    s_hi: int
    start: int
    end: int
    n_buckets: int


def _plan_shape(catalog, plan):
    """Structural eligibility (state existence NOT required): the same
    dashboard shape family as rules/rewrite.rollup_decision_for.
    -> (table, ts_col, value_col, tags, step_ms) or None."""
    if not isinstance(plan, QueryPlan) or not plan.is_aggregate:
        return None
    if plan.agg_exprs:
        return None
    sel = plan.select
    if (
        sel.join is not None
        or sel.joins
        or sel.distinct
        or sel.having is not None
    ):
        return None
    schema = plan.schema
    ts_col = schema.timestamp_name
    bucket_keys = [k for k in plan.group_keys if k.time_bucket_ms]
    if len(bucket_keys) != 1:
        return None
    step_ms = int(bucket_keys[0].time_bucket_ms)
    if step_ms <= 0 or step_ms >= (1 << 31):
        return None
    all_tags = {schema.columns[i].name for i in schema.tag_indexes}
    group_tags = []
    for k in plan.group_keys:
        if k.time_bucket_ms:
            continue
        if k.column is None or k.column not in all_tags:
            return None
        group_tags.append(k.column)
    if not plan.aggs:
        return None
    value_col = plan.aggs[0].column
    if value_col is None:
        return None  # count(*): NULL semantics differ from count(value)
    for a in plan.aggs:
        if (
            a.func not in _FOLDABLE
            or a.distinct
            or a.filter_where is not None
            or a.column2 is not None
            or a.params
            or a.column != value_col
        ):
            return None
    col = schema.column(value_col)
    if col.name in all_tags or value_col == ts_col:
        return None
    out_names = []
    for item in sel.items:
        e = item.expr
        if _is_bucket_expr(e, ts_col):
            pass
        elif isinstance(e, ast.Column) and e.name in all_tags:
            if e.name not in group_tags:
                return None
        elif isinstance(e, ast.FuncCall) and e.name in _FOLDABLE:
            pass
        else:
            return None
        out_names.append(item.output_name)
    for o in sel.order_by:
        name = o.expr.name if isinstance(o.expr, ast.Column) else str(o.expr)
        if name not in out_names:
            return None
    tag_conjuncts, ok = _split_where(plan, all_tags, ts_col)
    if not ok:
        return None
    for c in tag_conjuncts:
        if not _conj_supported(c, all_tags):
            return None
        # a filter over a tag OUTSIDE the group-set partitions rows the
        # state folded together: refuse (the grouped state can't apply it)
        from ..query.executor import _columns_of

        if {cc.name for cc in _columns_of(c)} - set(group_tags):
            return None
    return (plan.table, ts_col, value_col, tuple(group_tags), step_ms)


def _is_bucket_expr(e: ast.Expr, ts_col: str) -> bool:
    return (
        isinstance(e, ast.FuncCall)
        and e.name in ("time_bucket", "date_trunc")
        and e.args
        and isinstance(e.args[0], ast.Column)
        and e.args[0].name == ts_col
    )


def _split_where(plan, tags, ts_col):
    from ..rules.rewrite import _split_where as _impl

    return _impl(plan, tags, ts_col)


def _shape_key(shape) -> str:
    table, _ts, value_col, tags, step_ms = shape
    return f"{table}|{value_col}|{','.join(tags)}|{step_ms}"


def _open_tail(end: int, step_ms: int) -> bool:
    """Is this the live edge a dashboard re-asks? Unbounded, or an upper
    bound within two buckets of now."""
    if end == MAX_TIMESTAMP:
        return True
    return end >= int(time.time() * 1000) - 2 * step_ms


def livewindow_decision_for(catalog, plan) -> Optional[LiveWindowDecision]:
    """THE shared serve-from-state predicate (executor hook + EXPLAIN).
    Pure: no usage counting, no promotion."""
    if not livewindow_enabled():
        return None
    shape = _plan_shape(catalog, plan)
    if shape is None:
        return None
    key = _shape_key(shape)
    state = STORE.get(key)
    if state is None:
        return None
    table = catalog.open(plan.table)
    if table is None or getattr(table, "data", None) is not state.anchor():
        return None
    w = state.bucket_ms
    tr = plan.predicate.time_range
    start, end = tr.inclusive_start, tr.exclusive_end
    with state.lock:
        floor_b = state.serve_floor()
        head = state.head
        max_ts = state.max_folded_ts
    if head is None:
        return None
    s_lo_b = floor_b
    if start != MIN_TIMESTAMP:
        s_lo_b = max(s_lo_b, -(-start // w))  # first COMPLETE bucket
    s_lo = s_lo_b * w
    if end == MAX_TIMESTAMP or end > max_ts:
        s_hi = end  # open tail: buckets past the head hold no rows
        hi_b = head
    else:
        s_hi = (end // w) * w  # partial end bucket stays raw
        hi_b = min(head, s_hi // w - 1)
    if s_lo >= s_hi or hi_b < s_lo_b:
        return None
    return LiveWindowDecision(
        state_key=key,
        table=plan.table,
        step_ms=w,
        s_lo=s_lo,
        s_hi=s_hi,
        start=start,
        end=end,
        n_buckets=hi_b - s_lo_b + 1,
    )


# ---- the serve ------------------------------------------------------------


def try_livewindow_serve(factory, plan):
    """Serve an eligible open-tail aggregate head-from-rollup/raw +
    tail-from-state; None when the predicate refuses (caller runs the
    normal path, including the rollup rewrite). ``factory`` is the
    InterpreterFactory (catalog + executor)."""
    if not livewindow_enabled() or not isinstance(plan, QueryPlan):
        return None
    shape = _plan_shape(factory.catalog, plan)
    if shape is None:
        return None
    decision = livewindow_decision_for(factory.catalog, plan)
    if decision is None:
        # an eligible open-tail read the state could not serve: usage
        # feeds the promotion loop (the dtype auto-tuner discipline)
        tr = plan.predicate.time_range
        if _open_tail(tr.exclusive_end, shape[4]):
            table = factory.catalog.open(plan.table)
            if table is not None:
                STORE.note_usage(_shape_key(shape), factory.catalog, table, shape)
        return None
    state = STORE.get(decision.state_key)
    if state is None:
        return None  # evicted between decision and serve: run raw

    from ..query.interpreters import _concat_results, _order_limit_result
    from ..utils import querystats
    from ..utils.tracectx import span as _span

    sel = plan.select
    table_name, ts_col, value_col, tags, step_ms = shape
    schema = plan.schema
    all_tags = {schema.columns[i].name for i in schema.tag_indexes}
    tag_conjuncts, _ = _split_where(plan, all_tags, ts_col)

    with _span("livewindow_gather", table=table_name):
        part = _state_result(state, decision, sel, shape, tag_conjuncts)
    if part is None:
        return None  # state mutated underneath (evicted/reset): run raw
    results = [part]

    # raw/rollup halves: the partial HEAD [start, s_lo) and — for a
    # bounded end below the folded watermark — the partial TAIL [s_hi, end)
    raw_metrics = None
    raw_ranges = []
    if decision.start < decision.s_lo:
        raw_ranges.append((decision.start, decision.s_lo))
    if decision.s_hi < decision.end:
        raw_ranges.append((decision.s_hi, decision.end))
    if raw_ranges and any(
        (lo // step_ms) in state.dirty or (hi - 1) // step_ms in state.dirty
        for lo, hi in raw_ranges
    ):
        _M_DIRTY.inc()
    if raw_ranges:
        import dataclasses

        from ..query.planner import Planner
        from ..rules.rewrite import _and, try_rollup_serve

        planner = Planner(factory.catalog.schema_of)
        ts = ast.Column(ts_col)
        for r_start, r_end in raw_ranges:
            raw_where = list(tag_conjuncts)
            if r_start > MIN_TIMESTAMP:
                raw_where.append(ast.BinaryOp(">=", ts, ast.Literal(r_start)))
            if r_end < MAX_TIMESTAMP:
                raw_where.append(ast.BinaryOp("<", ts, ast.Literal(r_end)))
            raw_select = dataclasses.replace(
                sel,
                items=tuple(
                    ast.SelectItem(i.expr, alias=i.output_name)
                    for i in sel.items
                ),
                where=_and(raw_where),
                order_by=(),
                limit=None,
                offset=0,
            )
            raw_plan = planner.plan(raw_select)
            src_table = factory.catalog.open(plan.table)
            with _span("livewindow_raw_part", table=plan.table):
                # the closed head may itself serve from the rollup ladder
                served = try_rollup_serve(factory, raw_plan)
                if served is None:
                    served = factory.executor.execute(raw_plan, src_table)
                results.append(served)
            m_part = factory.executor.last_metrics or {}
            raw_metrics = (
                m_part if raw_metrics is None else {
                    "rows_scanned": raw_metrics.get("rows_scanned", 0)
                    + m_part.get("rows_scanned", 0)
                }
            )

    combined = results[0] if len(results) == 1 else _concat_results(results)
    combined = _order_limit_result(
        combined, sel.order_by, sel.limit, sel.offset
    )
    with state.lock:
        state.reads_served += 1
        state.last_hit = time.time()
    m = {
        "table": plan.table,
        "path": "livewindow",
        "window_ms": decision.step_ms,
        "state_buckets": decision.n_buckets,
        "serve_lo": decision.s_lo,
        "serve_hi": decision.s_hi,
        "raw_head_rows": (
            raw_metrics.get("rows_scanned", 0) if raw_metrics else 0
        ),
        "result_rows": combined.num_rows,
    }
    combined.metrics = m
    factory.executor.last_path = "livewindow"
    factory.executor.last_metrics = m
    # first-class route in the ledger/query_stats (set AFTER the halves
    # so their sub-executions' routes don't win)
    querystats.set_route("livewindow")
    querystats.record(state_buckets=decision.n_buckets)
    _M_READS.inc()
    return combined


def _state_result(state, decision, sel, shape, tag_conjuncts):
    """Materialize the state-served buckets [s_lo, s_hi) as a ResultSet
    aligned to the original select items; None if the state can no
    longer cover the range (evicted/reset mid-query)."""
    from ..query.executor import ResultSet

    table_name, ts_col, value_col, tags, w = shape
    b_lo = decision.s_lo // w
    b_hi_req = decision.s_hi // w - (0 if decision.s_hi % w else 1)
    with state.lock:
        if STORE.get(decision.state_key) is not state:
            return None
        if state.head is None or state.serve_floor() > b_lo:
            return None
        (ids, counts, sums, mins, maxs, _inc, _f, _l) = state.read_buckets(
            b_lo, b_hi_req
        )
        groups = list(state.group_vals)

    # tag filters evaluate against the group tuples on host
    if tag_conjuncts and groups:
        keep = []
        for gi, gv in enumerate(groups):
            vals = dict(zip(tags, gv))
            if all(_eval_conj(c, vals) for c in tag_conjuncts):
                keep.append(gi)
        gsel = np.asarray(keep, dtype=np.int64)
    else:
        gsel = np.arange(len(groups), dtype=np.int64)

    nb = len(ids)
    if nb and len(gsel):
        counts = counts[:, gsel]
        cells = counts > 0  # a (bucket, group) cell with no rows emits none
        bi, gj = np.nonzero(cells)
    else:
        bi = gj = np.empty(0, dtype=np.int64)
        counts = np.zeros((nb, len(gsel)), dtype=np.int64)
    bucket_vals = (np.asarray(ids, dtype=np.int64)[bi] * w) if len(bi) else \
        np.empty(0, dtype=np.int64)
    cnt = counts[bi, gj].astype(np.int64) if len(bi) else \
        np.empty(0, dtype=np.int64)

    def cells_of(arr):
        if not len(bi):
            return np.empty(0, dtype=np.float64)
        return arr[:, gsel][bi, gj].astype(np.float64)

    names, cols, nulls = [], [], {}
    for item in sel.items:
        e = item.expr
        name = item.output_name
        names.append(name)
        if _is_bucket_expr(e, ts_col):
            cols.append(bucket_vals)
        elif isinstance(e, ast.Column):
            gvals = [groups[int(gsel[j])][tags.index(e.name)] for j in gj]
            arr = np.array(gvals, dtype=object)
            mask = np.array([v is None for v in gvals], dtype=bool)
            cols.append(arr)
            if mask.any():
                nulls[name] = mask
        else:  # a foldable aggregate (the predicate admitted nothing else)
            f = e.name
            if f == "count":
                cols.append(cnt)
            elif f == "sum":
                cols.append(cells_of(sums))
            elif f == "min":
                cols.append(cells_of(mins))
            elif f == "max":
                cols.append(cells_of(maxs))
            else:  # avg
                with np.errstate(invalid="ignore"):
                    cols.append(
                        cells_of(sums) / np.maximum(cnt, 1).astype(np.float64)
                    )
    return ResultSet(names, cols, nulls or None)
