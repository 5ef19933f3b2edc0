"""Per-row-group membership filters for tag point lookups
(ref: analytic_engine/src/sst/parquet/writer.rs builds xor filters per
row group; row_group_pruner.rs:283-288 consults them — min/max stats
can't prune a high-cardinality tag whose values span each group).

A classic Bloom filter (k=4, ~10 bits/key ⇒ ~1-2% FP) instead of the
reference's xor filter: identical pruning power for this use (false
positives only cost a read), and buildable in a few vectorized lines.
Filters ride the SST footer JSON base64-encoded; absent filters mean
"may match" — pruning is only ever an optimization.
"""

from __future__ import annotations

import base64
from typing import Iterable, Optional

import numpy as np
import xxhash

_K = 4
_BITS_PER_KEY = 10


def _hashes(value: str) -> tuple[int, int]:
    data = value.encode("utf-8", "replace")
    return (
        xxhash.xxh64_intdigest(data, seed=0x9E3779B9),
        xxhash.xxh64_intdigest(data, seed=0x85EBCA6B) | 1,  # odd: full cycle
    )


def build_filter(values: Iterable[str]) -> bytes:
    vals = list(dict.fromkeys(values))
    if not vals:
        return b""
    n_bits = max(64, len(vals) * _BITS_PER_KEY)
    n_bits = (n_bits + 7) & ~7
    bits = np.zeros(n_bits, dtype=bool)
    for v in vals:
        h1, h2 = _hashes(str(v))
        for i in range(_K):
            bits[(h1 + i * h2) % n_bits] = True
    return np.packbits(bits).tobytes()


def might_contain(filt: bytes, value: str) -> bool:
    if not filt:
        return True  # empty/absent: never prune
    n_bits = len(filt) * 8
    h1, h2 = _hashes(str(value))
    for i in range(_K):
        idx = (h1 + i * h2) % n_bits
        # direct byte/bit probe — no full-filter unpack per lookup
        # (packbits fills each byte MSB-first)
        if not (filt[idx >> 3] >> (7 - (idx & 7))) & 1:
            return False
    return True


def encode_filters(per_group: list[dict]) -> list[dict]:
    """[{col: filter_bytes}] -> JSON-safe [{col: base64}]."""
    return [
        {col: base64.b64encode(f).decode() for col, f in group.items()}
        for group in per_group
    ]


def decode_filters(raw: Optional[list]) -> list[dict]:
    if not raw:
        return []
    return [
        {col: base64.b64decode(b64) for col, b64 in group.items()}
        for group in raw
    ]
