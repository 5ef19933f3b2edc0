"""Query-shape keys and the learned segment-kernel router.

The reference also routes whole aggregate queries between the device and
a host (numpy) path by measured latency. The port does not: every
aggregate shape the kernels can serve runs on the connection's device,
so no query's work moves to the CPU while its table sits on the card.
What remains is the choice among the kernel's on-device reduction arms.
"""

from __future__ import annotations

import dataclasses
import os
import threading

PROBE_EVERY = 16  # serve the winner; re-probe the losers every Nth call
MAX_KEYS = 512  # LRU bound on tracked query shapes


MEMO_PLANS = 1024  # plans whose shape keys memo_by_plan keeps


def memo_by_plan(memo: dict, plan, key_of):
    """``key_of(plan)``, computed once per plan object. Plans are frozen
    and the plan cache hands the same object to every repeat of a SQL
    text, so a dashboard's repeats pay for the key once. ``memo`` maps
    id(plan) -> (plan, key); holding the plan keeps its id from being
    reused while the entry lives. Cleared whole at MEMO_PLANS entries."""
    hit = memo.get(id(plan))
    if hit is not None and hit[0] is plan:
        return hit[1]
    key = key_of(plan)
    if len(memo) >= MEMO_PLANS:
        memo.clear()
    memo[id(plan)] = (plan, key)
    return key


_PLAN_SHAPES: dict = {}


def plan_shape_key(plan) -> tuple:
    """(table, normalized-select) with literal VALUES masked out.

    Rolling-window dashboards re-issue the same query with fresh time/
    filter literals every refresh; masking literals makes those one shape,
    so the router's samples accumulate instead of restarting (and the
    stats table stays bounded)."""
    return memo_by_plan(_PLAN_SHAPES, plan, lambda p: (p.table, _shape(p.select)))


_FIELD_NAMES: dict = {}  # dataclass type -> its field names


def _shape(node):
    cls = type(node)
    names = _FIELD_NAMES.get(cls)
    if names is None and dataclasses.is_dataclass(cls):
        names = _FIELD_NAMES[cls] = tuple(f.name for f in dataclasses.fields(cls))
    if names is not None:
        if cls.__name__ == "Literal":
            return ("?",)  # value masked; shape only
        return (cls.__name__, *((n, _shape(getattr(node, n))) for n in names))
    if isinstance(node, (tuple, list)):
        return tuple(_shape(x) for x in node)
    return node


# ---- learned segment-kernel routing ---------------------------------------
#
# The device group-by has three multi-segment reduction arms
# (ops/scan_agg.py: "shared" — block-private partials in shared memory,
# the counterpart of the reference's "mxu" —, "scatter" — global atomics —
# and "hash" — a block-private slot table keyed by segment id) and the
# winner flips with segment count, live cardinality and skew. An EWMA
# with periodic re-probes, keyed by (plan shape, segment-count bucket),
# chooses the ARM the kernel launches; a never-measured shape starts from
# its estimated cardinality, as in the reference.


def kernel_routing_enabled() -> bool:
    """Learned arm choice (default on). HORAEDB_SEGMENT_IMPL pinning
    bypasses the router entirely regardless of this switch."""
    return os.environ.get("HORAEDB_KERNEL_ROUTER", "1") not in (
        "0", "off", "false",
    )


def candidate_kernels(n_seg: int, n_rows: int, est_distinct, n_agg_fields: int,
                      need_minmax: bool) -> tuple:
    """Arms worth PROBING for this shape: ``scatter`` always, ``shared``
    where one block's partials of every segment fit shared memory, and
    ``hash`` where the reference proposes it: a domain of more than 64
    segments whose estimated live cardinality (if known) fills at most a
    quarter of it (a near-full table only routes rows to the overflow)."""
    from ..ops.scan_agg import shared_fits

    cands = ["scatter"]
    if shared_fits(n_seg, n_agg_fields, need_minmax):
        cands.append("shared")
    if n_seg > 64 and (est_distinct is None or est_distinct * 4 <= n_seg):
        cands.append("hash")
    return tuple(cands)


def seed_kernel(n_seg: int, est_distinct, device) -> str:
    """Starting arm for a never-measured shape: ``hash`` for a sparse
    domain (more than 512 segments, at most an eighth of them estimated
    live), else ``scatter`` (the reference's seed off the TPU); the
    router's probes find where another arm wins."""
    if est_distinct is not None and n_seg > 512 and est_distinct * 8 <= n_seg:
        return "hash"
    return "scatter"


class KernelRouter:
    """Per-(plan-shape, segment-bucket) EWMA over the segment impls.

    Warms each candidate (dropping its compile-tainted first sample),
    serves the measured winner, and re-probes the losers round-robin
    every PROBE_EVERY-th call so the choice adapts when conditions
    change. Also remembers the observed live
    segment count per key."""

    def __init__(self) -> None:
        self._stats: dict = {}
        self._lock = threading.Lock()

    def _touch(self, key) -> dict:
        st = self._stats.pop(key, None)
        if st is None:
            st = {"calls": 0, "n": {}, "t": {}}
            if len(self._stats) >= MAX_KEYS:
                self._stats.pop(next(iter(self._stats)))
        self._stats[key] = st
        return st

    def choose(self, key, seed: str, candidates: tuple) -> str:
        """The impl to dispatch this call with."""
        with self._lock:
            st = self._touch(key)
            st["calls"] += 1
            samples, times = st["n"], st["t"]
            order = [seed] + [k for k in candidates if k != seed]
            for k in order:
                # two samples each: the first pays one-time costs (the
                # kernel build) and is dropped by record()
                if k in candidates and samples.get(k, 0) < 2:
                    return k
            measured = {k: times[k] for k in candidates if k in times}
            if not measured:
                return seed if seed in candidates else candidates[0]
            winner = min(measured, key=measured.get)
            if st["calls"] % PROBE_EVERY == 0:
                losers = [k for k in candidates if k != winner]
                if losers:
                    return losers[(st["calls"] // PROBE_EVERY) % len(losers)]
            return winner

    def record(self, key, kernel: str, seconds: float) -> None:
        """Fold a dispatch latency in: adapt DOWN instantly, creep UP by
        10% per sample; the first sample of each impl (compile-tainted)
        only counts, never judges."""
        with self._lock:
            st = self._touch(key)
            n = st["n"][kernel] = st["n"].get(kernel, 0) + 1
            if n == 1:
                return  # compile-tainted
            prev = st["t"].get(kernel)
            st["t"][kernel] = (
                seconds if prev is None else min(seconds, prev * 1.1)
            )

    def note_segments(self, key, live: int) -> None:
        """Observed live (group x bucket) cells, EWMA'd."""
        with self._lock:
            st = self._touch(key)
            prev = st.get("segments")
            st["segments"] = (
                int(live) if prev is None else int(0.7 * prev + 0.3 * live)
            )

    def observed_segments(self, key):
        with self._lock:
            st = self._stats.get(key)
            return None if st is None else st.get("segments")

    def stats(self, key) -> dict:
        with self._lock:
            st = self._stats.get(key, {})
            return {
                k: (dict(v) if isinstance(v, dict) else v)
                for k, v in st.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


# One process-wide router: kernel latency is a property of the hardware
# and the shape, not of any particular executor instance — every
# consumer (direct device path, cached path, dist-agg step) folds into
# and serves from the same history.
KERNEL_ROUTER = KernelRouter()


def bootstrap_observed_segments(sql: str):
    """Seed a never-seen router key from query_stats history: the most
    recent finalized ledger of the same normalized SQL shape carries the
    live segment count its aggregation produced (``agg_segments``)."""
    if not sql:
        return None
    from ..utils.querystats import STATS_STORE
    from ..wlm.admission import normalize_shape

    shape = normalize_shape(sql)
    for row in reversed(STATS_STORE.list()):
        segs = row.get("agg_segments")
        if segs and normalize_shape(str(row.get("sql", ""))) == shape:
            return int(segs)
    return None
