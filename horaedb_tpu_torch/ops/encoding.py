"""Host-side encoding that makes columns device-friendly, and the plain
PyTorch decode of the compressed resident layouts.

The kernels want padded shapes and integer keys; time-series data arrives with
ragged row counts, 64-bit epoch timestamps, and string tags. This module is
the boundary where that impedance is resolved, all in vectorized numpy:

- ``shape_bucket``/``pad_to_bucket`` — round row counts up to a small set of
  shape buckets so the kernels see a handful of shapes, not one per scan;
- ``encode_group_codes`` — dense int32 group codes from tsid + tag columns
  (per-scan ``np.unique`` at series granularity; strings are only touched
  once per unique series, never per row);
- ``time_buckets`` — int32 bucket ids from int64 epoch-ms timestamps
  (computed host-side so the device never needs 64-bit integers).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..common_types.dict_column import as_values, unique_inverse
from ..common_types.row_group import RowGroup

# Shape buckets: powers of two from 4k up. Anything smaller pads to 4096;
# each bucket above that is exactly 2x the previous.
_MIN_BUCKET = 4096


def next_pow2(n: int, floor: int = 1) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def shape_bucket(n: int) -> int:
    return next_pow2(n, _MIN_BUCKET)


def pad_to_bucket(arr: np.ndarray, n_rows: int, fill=0) -> np.ndarray:
    """Pad axis 0 up to ``shape_bucket(n_rows)`` with ``fill``."""
    target = shape_bucket(n_rows)
    if len(arr) == target:
        return arr
    pad_n = target - len(arr)
    pad_block = np.full((pad_n, *arr.shape[1:]), fill, dtype=arr.dtype)
    return np.concatenate([arr, pad_block])


@dataclass(frozen=True)
class GroupEncoding:
    """Per-row dense group codes + the decoded key values per group."""

    codes: np.ndarray  # int32 per row, in [0, num_groups)
    num_groups: int
    # For each output group, the group-by key values (one array per key
    # column, each of length num_groups) — used to label result rows.
    key_values: tuple[np.ndarray, ...]


def encode_group_codes(
    rows: RowGroup,
    group_columns: Sequence[str],
) -> GroupEncoding:
    """Dense int32 group codes for arbitrary group-by key columns.

    Strategy (all C-speed numpy, no Python per-row loops):

    1. `np.unique(tsid, return_inverse)` -> dense series index per row.
       Series count is tiny next to row count in time-series workloads.
    2. The group key of a series is constant unless the key includes
       non-tag columns; when keys are all tags (the common case), compute
       group codes at series granularity and broadcast through the inverse.
    3. Otherwise fall back to row-level np.unique over the key columns.
    """
    schema = rows.schema
    tag_names = set(schema.tag_names)
    n = len(rows)
    if not group_columns:
        return GroupEncoding(np.zeros(n, dtype=np.int32), 1, ())

    all_tags = all(c in tag_names for c in group_columns)
    tsid_idx = schema.tsid_index
    if all_tags and tsid_idx is not None and n > 0:
        tsid = rows.columns[schema.columns[tsid_idx].name]
        uniq_tsid, first_idx, inverse = np.unique(
            tsid, return_index=True, return_inverse=True
        )
        # Key values per unique series (small arrays).
        series_keys = [as_values(rows.columns[c][first_idx]) for c in group_columns]
        series_group, key_values = _codes_from_columns(series_keys)
        codes = series_group[inverse].astype(np.int32)
        return GroupEncoding(codes, len(key_values[0]) if key_values else 1, key_values)

    row_keys = [rows.columns[c] for c in group_columns]
    codes64, key_values = _codes_from_columns(row_keys)
    return GroupEncoding(codes64.astype(np.int32), len(key_values[0]) if key_values else 1, key_values)


def _codes_from_columns(cols: list) -> tuple[np.ndarray, tuple[np.ndarray, ...]]:
    """(codes, unique key values per column) for composite keys."""
    if len(cols) == 1:
        uniq, codes = unique_inverse(cols[0])
        return codes, (uniq,)
    # Composite: successive refinement — code each column, then combine.
    combined = np.zeros(len(cols[0]), dtype=np.int64)
    for c in cols:
        u, inv = unique_inverse(c)
        combined = combined * (len(u) + 1) + inv
    uniq_comb, first_idx, codes = np.unique(
        combined, return_index=True, return_inverse=True
    )
    key_values = tuple(as_values(c[first_idx]) for c in cols)
    return codes, key_values


def time_buckets(
    ts: np.ndarray, t0: int, bucket_ms: int
) -> tuple[np.ndarray, int]:
    """(int32 bucket ids relative to t0, bucket count). Host-side int64
    floor-div so the device kernel never sees 64-bit timestamps.

    Rows before ``t0`` are rejected loudly: negative segment ids would be
    SILENTLY DROPPED by a scatter, corrupting aggregates. Callers must
    time-filter first (merge_read already does) and pass t0 <= min(ts).
    """
    if bucket_ms <= 0:
        raise ValueError(f"bucket_ms must be positive, got {bucket_ms}")
    b = (ts - t0) // bucket_ms
    n = int(b.max()) + 1 if len(b) else 1
    if len(b) and int(b.min()) < 0:
        raise ValueError(
            f"timestamps before bucket origin t0={t0} (min bucket {int(b.min())}); "
            "clip the batch to the query time range first"
        )
    if n > 2**31 - 1:
        raise ValueError(f"bucket count {n} overflows int32; widen bucket_ms")
    return b.astype(np.int32), max(n, 1)


def split_u64(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 -> (hi uint32, lo uint32) for device sorts without x64."""
    x = x.astype(np.uint64, copy=False)
    return (x >> np.uint64(32)).astype(np.uint32), (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split_i64_sortable(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64 -> order-preserving (hi uint32, lo uint32) pair.

    Flipping the sign bit maps int64 order onto uint64 order, so sorting by
    (hi, lo) lexicographically equals sorting by the original int64.
    """
    u = x.astype(np.int64, copy=False).view(np.uint64) ^ np.uint64(1 << 63)
    return split_u64(u)


@dataclass(frozen=True)
class PaddedBatch:
    """A scan batch padded to a shape bucket, ready for the device."""

    n_valid: int
    group_codes: np.ndarray  # int32 (padded)
    bucket_ids: np.ndarray  # int32 (padded)
    mask: np.ndarray  # bool (padded; False in the pad tail)
    values: np.ndarray  # float32, shape (n_fields, padded)

    @property
    def padded_len(self) -> int:
        return len(self.mask)


def build_padded_batch(
    group_codes: np.ndarray,
    bucket_ids: np.ndarray,
    mask: np.ndarray,
    value_cols: Sequence[np.ndarray],
) -> PaddedBatch:
    n = len(group_codes)
    target = shape_bucket(n)
    if value_cols:
        values = np.stack([v.astype(np.float32, copy=False) for v in value_cols])
        values = np.pad(values, ((0, 0), (0, target - n)))
    else:
        values = np.zeros((0, target), dtype=np.float32)
    return PaddedBatch(
        n_valid=n,
        group_codes=pad_to_bucket(group_codes, n),
        bucket_ids=pad_to_bucket(bucket_ids, n),
        mask=pad_to_bucket(mask.astype(np.bool_), n, fill=False),
        values=values,
    )


# ---------------------------------------------------------------------------
# Compressed device layouts
#
# The scan cache stores columns in HBM; capacity, not kernel speed, bounds
# how much of the working set gets device-path serving. These codecs trade
# a few register-level ops per row for 4-8x fewer HBM bytes:
#
# - ``pack_bits``/``unpack_bits`` — a uint32 word stream holding fixed-width
#   codes (1..16 bits). The device unpack is random-access (any gather index
#   works), so the same stream serves full scans AND decode-on-gather.
# - ``dict_encode`` — sorted-dictionary encoding for low-cardinality
#   columns: bit-packed codes + a small pow2-padded dictionary. Sorted
#   dictionaries let the executor pre-translate comparison literals into
#   the code domain host-side (filters never decode).
# - ``delta_for_encode`` — block frame-of-reference for sorted-ish int32
#   streams (series codes, per-series relative timestamps): one int32 base
#   per 128-row block + bit-packed offsets.
#
# All codecs are LOSSLESS and verified by bit-exact host roundtrip at
# encode time; callers fall back to the raw layout on any mismatch (the
# -0.0/0.0 collapse under np.unique is caught exactly this way).
#
# Layout descriptors are small hashable tuples; the kernel wrapper turns
# them into its launch arguments:
#
#   value field:  ("raw",) | ("bf16",) | ("dict", width, full_decode)
#   timestamps:   ("raw",) | ("dict", width) | ("delta", width)
#   series codes: ("raw",) | ("delta", width)
# ---------------------------------------------------------------------------

RAW_LAYOUT = ("raw",)
BF16_LAYOUT = ("bf16",)

# Frame-of-reference block size. 128 divides every shape bucket (pow2 >=
# 4096), and series codes — consecutive np.unique inverses, non-decreasing
# — span at most 128 distinct values per block, so offsets always fit 8 bits.
FOR_BLOCK = 128
_FOR_SHIFT = 7

_MAX_CODE_WIDTH = 16


def _bit_width(max_value: int) -> int:
    """Bits needed to store values in [0, max_value] (min 1)."""
    return max(1, int(max_value).bit_length())


def pack_bits(values: np.ndarray, width: int) -> np.ndarray:
    """Pack unsigned ints (< 2**width) into a dense uint32 word stream.

    One trailing safety word is appended so the device unpack may always
    read ``words[wi + 1]`` without bounds checks.
    """
    if not 1 <= width <= _MAX_CODE_WIDTH:
        raise ValueError(f"width must be in [1, {_MAX_CODE_WIDTH}], got {width}")
    v = values.astype(np.uint64, copy=False)
    n = len(v)
    n_words = (n * width + 31) // 32 + 1
    pos = np.arange(n, dtype=np.uint64) * np.uint64(width)
    wi = (pos >> np.uint64(5)).astype(np.int64)
    sh = pos & np.uint64(31)
    shifted = v << sh  # width<=16, sh<=31 -> fits u64
    words = np.zeros(n_words, dtype=np.uint64)
    np.bitwise_or.at(words, wi, shifted & np.uint64(0xFFFFFFFF))
    np.bitwise_or.at(words, wi + 1, shifted >> np.uint64(32))
    return (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def unpack_bits_host(words: np.ndarray, width: int, n: int) -> np.ndarray:
    """Host-side mirror of the device unpack (roundtrip verification)."""
    w64 = words.astype(np.uint64)
    pos = np.arange(n, dtype=np.uint64) * np.uint64(width)
    wi = (pos >> np.uint64(5)).astype(np.int64)
    sh = pos & np.uint64(31)
    lo = w64[wi] >> sh
    # shift-by-32 is undefined on fixed-width ints: guard the aligned case
    hi = np.where(sh == np.uint64(0), np.uint64(0), w64[wi + 1] << (np.uint64(32) - sh))
    return ((lo | hi) & np.uint64((1 << width) - 1)).astype(np.uint32)


def unpack_bits(words, width: int, idx):
    """Random-access unpack on tensors: codes at row positions ``idx``.

    ``words`` is the packed stream as int32 (the uint32 bits, unchanged);
    ``idx`` any integer index tensor. Runs in int64 so no shift or cast
    wraps. Plain version of the kernel prologue's unpack
    (ops/csrc/scan_agg.cu ``unpack``).
    """
    p = idx.to(torch.int64) * width
    wi = p >> 5
    sh = p & 31
    lo = (words[wi].to(torch.int64) & 0xFFFFFFFF) >> sh
    nxt = words[wi + 1].to(torch.int64) & 0xFFFFFFFF
    # the sh == 0 lane must not take bits from the next word
    hi = torch.where(sh == 0, torch.zeros_like(nxt), nxt << ((32 - sh) & 31))
    return (lo | hi) & ((1 << width) - 1)


@dataclass(frozen=True)
class DictEncoded:
    """Sorted-dictionary encoding of one padded column."""

    words: np.ndarray  # uint32 packed codes (+ safety word)
    dictionary: np.ndarray  # sorted values, pow2-padded with the max value
    dict_host: np.ndarray  # unpadded sorted dictionary (literal translation)
    width: int  # bits per code
    encoding: str  # "dict8" | "dict16"

    @property
    def nbytes(self) -> int:
        return int(self.words.nbytes + self.dictionary.nbytes)


def dict_encode(padded: np.ndarray, max_cardinality: int) -> Optional[DictEncoded]:
    """Dictionary-encode a padded f32/int32 column, or None if ineligible.

    Eligible when the column is NaN-free and its cardinality fits both the
    cap and a 16-bit code. The dictionary is sorted (np.unique), so code
    order == value order and comparison literals translate host-side via
    searchsorted. A bit-exact roundtrip is verified before accepting.
    """
    if padded.dtype.kind == "f" and np.isnan(padded).any():
        return None
    uniq = np.unique(padded)
    if len(uniq) > max_cardinality or len(uniq) > (1 << _MAX_CODE_WIDTH):
        return None
    width = _bit_width(len(uniq) - 1) if len(uniq) > 1 else 1
    codes = np.searchsorted(uniq, padded).astype(np.uint32)
    words = pack_bits(codes, width)
    decoded = uniq[unpack_bits_host(words, width, len(padded))]
    # bitwise comparison: catches -0.0/0.0 collapse and any packing bug
    if decoded.view(np.int32).tobytes() != padded.view(np.int32).tobytes():
        return None
    n_dict = next_pow2(len(uniq), floor=8)
    dictionary = np.pad(uniq, (0, n_dict - len(uniq)), mode="edge")
    return DictEncoded(
        words=words,
        dictionary=dictionary,
        dict_host=uniq,
        width=width,
        encoding="dict8" if width <= 8 else "dict16",
    )


@dataclass(frozen=True)
class DeltaEncoded:
    """Block frame-of-reference encoding of one padded int32 column."""

    words: np.ndarray  # uint32 packed offsets (+ safety word)
    base: np.ndarray  # int32 per-block minima, len == n/FOR_BLOCK
    width: int  # bits per offset
    encoding: str = "delta"

    @property
    def nbytes(self) -> int:
        return int(self.words.nbytes + self.base.nbytes)


def delta_for_encode(arr: np.ndarray, max_bits: int) -> Optional[DeltaEncoded]:
    """Delta/FOR-encode a padded int32 column, or None if offsets overflow.

    ``len(arr)`` must be a multiple of FOR_BLOCK (every shape bucket is).
    The global offset width is the max block range — one scattered block
    (e.g. a pad boundary) can reject the whole column, which is fine: the
    tuner falls back to dict or raw.
    """
    if len(arr) % FOR_BLOCK:
        return None
    blocks = arr.astype(np.int64, copy=False).reshape(-1, FOR_BLOCK)
    base = blocks.min(axis=1)
    offsets = blocks - base[:, None]
    width = _bit_width(int(offsets.max()) if len(arr) else 0)
    if width > min(max_bits, _MAX_CODE_WIDTH):
        return None
    words = pack_bits(offsets.ravel().astype(np.uint32), width)
    base32 = base.astype(np.int32)
    decoded = base32[np.arange(len(arr)) >> _FOR_SHIFT] + unpack_bits_host(
        words, width, len(arr)
    ).astype(np.int32)
    if not np.array_equal(decoded, arr):
        return None
    return DeltaEncoded(words=words, base=base32, width=width)


# ---- plain PyTorch layout decode (the kernel prologue's plain version) ----


def _iota(n_rows: int, device):
    return torch.arange(n_rows, dtype=torch.int64, device=device)


def decode_series(parts, layout, n_rows: int, idx=None):
    """int32 series codes under ``layout`` — all rows (idx=None) or a gather.

    ``parts`` is the resident part tuple: ("raw",) -> (codes,);
    ("delta", w) -> (words, base).
    """
    if layout[0] == "raw":
        return parts[0] if idx is None else parts[0][idx.long()]
    words, base = parts
    ix = _iota(n_rows, words.device) if idx is None else idx.long()
    return base[ix >> _FOR_SHIFT] + unpack_bits(words, layout[1], ix).to(torch.int32)


def decode_ts(parts, layout, n_rows: int, idx=None):
    """int32 relative timestamps under ``layout``."""
    if layout[0] == "raw":
        return parts[0] if idx is None else parts[0][idx.long()]
    ix = _iota(n_rows, parts[0].device) if idx is None else idx.long()
    if layout[0] == "dict":
        words, dictionary = parts
        return dictionary[unpack_bits(words, layout[1], ix)]
    words, base = parts
    return base[ix >> _FOR_SHIFT] + unpack_bits(words, layout[1], ix).to(torch.int32)


def decode_value(parts, layout, n_rows: int, idx=None):
    """f32 values under a value-field layout.

    ``("dict", w, False)`` (filter-only fields) returns the CODES as f32 —
    the executor pre-translated the comparison literal into the code
    domain, so the predicate never touches the dictionary.
    """
    if layout[0] in ("raw", "bf16"):
        arr = parts[0] if idx is None else parts[0][idx.long()]
        return arr.to(torch.float32)
    words, dictionary = parts
    ix = _iota(n_rows, words.device) if idx is None else idx.long()
    codes = unpack_bits(words, layout[1], ix)
    if len(layout) > 2 and not layout[2]:
        return codes.to(torch.float32)
    return dictionary[codes]


def layout_rows(parts, layout) -> int:
    """Static logical row count of one encoded/raw part tuple."""
    if layout[0] == "delta":
        return parts[1].shape[0] * FOR_BLOCK
    return parts[0].shape[0]


def _as_parts(x):
    return x if isinstance(x, tuple) else (x,)


def decode_layouts(
    series_codes, ts_rel, values, series_layout, ts_layout, value_layouts, idx=None
):
    """Reconstruct kernel inputs from their resident layouts.

    With ``idx`` given, only those row positions decode (decode-on-gather:
    the selective path ships an M-row index and reads M encoded rows, not
    N). Raw inputs pass through untouched. Encoded values come back as a
    LIST of per-field rows; the reduction stacks only what it aggregates.
    """
    if (
        series_layout[0] == "raw"
        and ts_layout[0] == "raw"
        and not any(l[0] not in ("raw", "bf16") for l in value_layouts)
        and not isinstance(values, tuple)
    ):
        if idx is None:
            return _as_parts(series_codes)[0], _as_parts(ts_rel)[0], values
        ix = idx.long()
        return (
            _as_parts(series_codes)[0][ix],
            _as_parts(ts_rel)[0][ix],
            values[:, ix],
        )
    sc_parts = _as_parts(series_codes)
    ts_parts = _as_parts(ts_rel)
    n_rows = layout_rows(sc_parts, series_layout)
    sc = decode_series(sc_parts, series_layout, n_rows, idx)
    tr = decode_ts(ts_parts, ts_layout, n_rows, idx)
    layouts = value_layouts or tuple(("raw",) for _ in values)
    vals = [
        decode_value(_as_parts(p), l, n_rows, idx) for p, l in zip(values, layouts)
    ]
    return sc, tr, vals
