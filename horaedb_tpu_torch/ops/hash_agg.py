"""Hash-based segment aggregation: the kernel's ``hash`` arm (B2d).

The fused scan-aggregate reduces rows into a dense segment domain
``n_seg = n_groups * n_buckets``. When the rows present touch only a few
of those segments (a dashboard panel over a few hosts of a table whose
GROUP BY spans every host), the other arms still pay for the whole
domain; the hash arm aggregates through a small slot table first:

1. a Fibonacci multiply-shift hash of the segment id into ``H = 2^b``
   slots (H from the router's cardinality estimate, ``hash_slots_for``);
2. ``HORAEDB_HASH_PROBE_ROUNDS`` (default 2) linear-probe rounds, each
   claiming only EMPTY slots, so a claimed slot never changes owner;
3. a per-slot aggregate, then an H-row scatter into the n_seg output;
4. rows that found no slot within the budget go through the exact
   scatter aggregate, so every input gets the exact answer.

``hash_segment_agg_plain`` is the plain PyTorch version, step by step as
the JAX package's ``hash_segment_agg`` (``horaedb_tpu/ops/hash_agg.py``)
computes it, except that the per-slot aggregate follows the scatter
arm's special-float rule (NaN only from a kept row; -0.0 < +0.0) as
every port arm does. The kernel is ``ARM_HASH`` in ``csrc/scan_agg.cu``:
each block keeps its own slot table in shared memory, fitted to the rows
it takes (``scan_agg.fitted_hash_slots`` of ``scan_agg.block_hash_slots``),
so which rows overflow differs from this version; the outputs do not.

Not ported: ``host_segment_agg`` and ``host_scan_aggregate`` and the
tiny-input host route that calls them (``HORAEDB_HASH_HOST_MAX_ROWS``).
That route moves a query's work from the device to the host, and the
port has no device/host router: every aggregate the kernels can serve
runs on the connection's device.
"""

from __future__ import annotations

import torch

from ..utils.env import env_int
from .encoding import next_pow2

# 2^32 / golden ratio (Knuth multiplicative / Fibonacci hashing): odd,
# spreads consecutive dense segment ids across the high bits.
_MULT = 2654435769

# Slot-table bounds: the floor keeps the multiply-shift well-defined
# (shift < 32); the cap bounds the table's cost: past it, hash stops
# beating scatter anyway.
_MIN_SLOTS = 16
_DEFAULT_MAX_SLOTS = 4096

# a slot no segment owns (valid segment ids are < n_seg < 2^31 - 1)
EMPTY = 2**31 - 1


def default_hash_slots(n_seg: int) -> int:
    """Deterministic slot count when the caller has no cardinality
    estimate: the full domain up to the cap."""
    return next_pow2(min(n_seg, _DEFAULT_MAX_SLOTS), floor=_MIN_SLOTS)


def hash_slots_for(n_seg: int, est_distinct: int | None) -> int:
    """Slot count from a cardinality estimate: 4x headroom (load factor
    <= 0.25 in the expected case) so nearly every segment places within
    the small probe budget. NOT clamped to n_seg: when the estimate
    approaches the domain a same-size table would run at load 1.0 and
    push everything through the fallback."""
    cap = max(_MIN_SLOTS, env_int("HORAEDB_HASH_MAX_SLOTS", _DEFAULT_MAX_SLOTS))
    if est_distinct is None or est_distinct <= 0:
        return default_hash_slots(n_seg)
    return next_pow2(min(4 * est_distinct, cap), floor=_MIN_SLOTS)


def probe_rounds(n_slots: int) -> int:
    """Linear-probe rounds for a table of ``n_slots``:
    ``HORAEDB_HASH_PROBE_ROUNDS`` (default 2), at least 1 and at most the
    table size. Read per call."""
    r = env_int("HORAEDB_HASH_PROBE_ROUNDS", 2)
    return min(int(n_slots), max(1, r))


def hash_of(seg: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Fibonacci multiply-shift of segment ids (>= 0) into [0, n_slots):
    ``(uint32(seg) * _MULT mod 2^32) >> (32 - log2 n_slots)``, in int64
    (every product of a non-negative int32 and _MULT fits)."""
    shift = 32 - (int(n_slots).bit_length() - 1)
    return ((seg.to(torch.int64) * _MULT) & 0xFFFFFFFF) >> shift


def hash_segment_agg_plain(seg_raw, m, agg_vals, n_seg: int, need_minmax: bool,
                           n_slots: int, overflow=None):
    """(counts, sums, mins, maxs) over flat segment ids through an
    ``n_slots`` hash table, the contract of ``scan_agg._segment_agg``.
    ``overflow``, an int64[1] tensor, gets the count of rows that found
    no slot added to it."""
    from .scan_agg import _segment_agg

    H = int(n_slots)
    if H < 2 or H & (H - 1):
        raise ValueError(f"n_slots must be a power of 2, got {H}")
    dev = m.device
    valid = m & (seg_raw >= 0)
    seg = torch.where(valid, seg_raw.to(torch.int64), torch.full_like(seg_raw, -1,
                                                                    dtype=torch.int64))
    h0 = hash_of(torch.where(valid, seg, 0), H)

    # Probe/insert, one claim pass a round: a row tries the next slot of
    # its sequence; only EMPTY slots can be claimed (slot H drops the
    # rows that do not claim), and the smallest segment id wins a slot
    # several segments reach in one round.
    slots = torch.full((H + 1,), EMPTY, dtype=torch.int64, device=dev)
    slot_of = torch.zeros_like(seg)
    placed = ~valid
    for r in range(probe_rounds(H)):
        cand = (h0 + r) & (H - 1)
        cur = slots[cand]
        mine = cur == seg  # slot already owned by my segment
        try_claim = (~placed) & (cur == EMPTY)
        tgt = torch.where(try_claim, cand, H)
        slots.scatter_reduce_(0, tgt, torch.where(try_claim, seg, EMPTY), "amin")
        won = try_claim & (slots[cand] == seg)
        newly = (~placed) & (mine | won)
        slot_of = torch.where(newly, cand, slot_of)
        placed = placed | newly
    slots = slots[:H]

    # per-slot aggregate, then the H-row scatter: a segment owns at most
    # one slot, so each occupied slot's partials are placed as they are
    counts_h, sums_h, mins_h, maxs_h = _segment_agg(slot_of, placed & valid, agg_vals, H,
                                                    need_minmax)
    owned = torch.nonzero(slots != EMPTY).squeeze(1)
    seg_of = slots[owned]
    counts = torch.zeros(n_seg, dtype=torch.int32, device=dev)
    counts[seg_of] = counts_h[owned]
    if agg_vals is not None:
        F = agg_vals.shape[0]
        sums = torch.zeros((F, n_seg), dtype=torch.float32, device=dev)
        sums[:, seg_of] = sums_h[:, owned]
        if need_minmax:
            mins = torch.full((F, n_seg), float("inf"), device=dev)
            maxs = torch.full((F, n_seg), float("-inf"), device=dev)
            mins[:, seg_of] = mins_h[:, owned]
            maxs[:, seg_of] = maxs_h[:, owned]
        else:
            mins = maxs = torch.zeros_like(sums)
    else:
        sums = mins = maxs = None

    # Overflow: rows of a segment place together or not at all (they
    # share one probe sequence), so the exact scatter of the unplaced
    # rows and the placed slots never meet in one segment.
    left = valid & ~placed
    if overflow is not None:
        overflow += left.sum()
    if bool(left.any()):
        oc, osums, omins, omaxs = _segment_agg(seg_raw, left, agg_vals, n_seg, need_minmax)
        counts = counts + oc
        if agg_vals is not None:
            sums = sums + osums
            if need_minmax:
                mins = torch.minimum(mins, omins)
                maxs = torch.maximum(maxs, omaxs)
    return counts, sums, mins, maxs
