"""Dictionary-encoded columns: codes + vocabulary, no per-row objects.

The TPU-first answer to string tags (SURVEY §7 hard parts: "TPU kernels
need integer codes -> dictionary-encode tags and group by code"): a tag
column read from an SST stays as ``int32 codes + small value vocabulary``
all the way through scan -> filter -> group-by. Per-row Python strings
exist only at the API edges (INSERT literals, result row dicts).

Any comparison against a literal evaluates on the VOCABULARY (tiny) and
broadcasts through the codes — one vectorized small-op + one index gather
instead of a million string compares.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


class DictColumn:
    __slots__ = ("codes", "values")

    def __init__(self, codes: np.ndarray, values: np.ndarray) -> None:
        self.codes = codes  # int32 per row, indexes into values
        self.values = values  # object array, the vocabulary

    # ---- container protocol (what RowGroup needs) -----------------------
    def __len__(self) -> int:
        return len(self.codes)

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self.values[self.codes[idx]]
        return DictColumn(self.codes[idx], self.values)

    @property
    def dtype(self):
        return np.dtype(object)

    @property
    def nbytes(self) -> int:
        return self.codes.nbytes + sum(len(str(v)) for v in self.values)

    # ---- conversions ----------------------------------------------------
    def decode(self) -> np.ndarray:
        """Materialize per-row values (the slow path — avoid in hot code)."""
        return self.values[self.codes]

    @staticmethod
    def encode(arr: np.ndarray) -> "DictColumn":
        values, codes = np.unique(arr, return_inverse=True)
        return DictColumn(codes.astype(np.int32), values)

    # ---- vectorized ops on the vocabulary -------------------------------
    def map_values(self, fn: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        """Apply a vectorized fn to the vocabulary, gather through codes.

        ``fn(values) -> per-value result``; output is per-row. This is how
        every comparison/predicate over a dict column runs: O(|vocab|)
        compute + O(n) gather.
        """
        per_value = fn(self.values)
        return np.asarray(per_value)[self.codes]

    def sort_ranks(self) -> np.ndarray:
        """Per-row ranks that sort like the decoded values (for ORDER BY)."""
        order = np.argsort(self.values, kind="stable")
        ranks = np.empty(len(self.values), dtype=np.int64)
        ranks[order] = np.arange(len(self.values))
        return ranks[self.codes]

    def min_max(self, mask: np.ndarray | None = None):
        codes = self.codes if mask is None else self.codes[mask]
        if len(codes) == 0:
            return None, None
        used = np.unique(codes)
        vals = self.values[used]
        return min(vals), max(vals)


ColumnData = "np.ndarray | DictColumn"


def as_values(col) -> np.ndarray:
    """Object-array view of any column (decodes DictColumn)."""
    return col.decode() if isinstance(col, DictColumn) else col


def column_take(col, idx):
    return col[idx]


def unique_inverse(col) -> tuple[np.ndarray, np.ndarray]:
    """(unique values, per-row inverse codes) — int-speed for DictColumn."""
    if isinstance(col, DictColumn):
        used, inv = np.unique(col.codes, return_inverse=True)
        return col.values[used], inv
    return np.unique(col, return_inverse=True)


def concat_columns(parts: Sequence) -> "np.ndarray | DictColumn":
    """Concatenate plain and/or dictionary columns.

    If any part is dictionary-encoded the result is dictionary-encoded
    with a UNION vocabulary; code spaces are remapped vectorized.
    """
    if len(parts) == 1:
        return parts[0]
    if not any(isinstance(p, DictColumn) for p in parts):
        return np.concatenate(parts)
    vocabs = []
    for p in parts:
        if isinstance(p, DictColumn):
            vocabs.append(p.values)
        else:
            vocabs.append(np.unique(p))
    # Union vocabulary MUST be sorted: remapping uses searchsorted.
    union = np.unique(np.concatenate(vocabs))
    out_codes = []
    for p in parts:
        if isinstance(p, DictColumn):
            remap = np.searchsorted(union, p.values).astype(np.int32)
            out_codes.append(remap[p.codes])
        else:
            out_codes.append(np.searchsorted(union, p).astype(np.int32))
    return DictColumn(np.concatenate(out_codes), union)
