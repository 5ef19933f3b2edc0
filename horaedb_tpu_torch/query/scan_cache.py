"""Device-resident scan cache — the HBM-fed serving path.

The reference keeps hot SST pages in a memory cache (mem_cache.rs) so
repeated scans skip object storage. This cache goes further: after the
first scan of a table state, the dense scan inputs live in device memory,
as tensors on the connection's device —

    per-row series codes (int32), relative timestamps (int32),
    value columns (f32)

— and every subsequent aggregate query ships only O(series)+O(1) data:
a series->group map, a series allow-list (tag filters evaluated per
series on host), time-range scalars, and filter literals. The fused
kernel (ops.scan_agg.cached_scan_agg_packed) does the rest on device.

Invalidation: entries key on the table's BASE fingerprint — schema
version, flushed sequence, SST file set. Plain ingest (memtable appends)
does NOT invalidate: the cache serves base state from HBM and the
executor folds the small unflushed DELTA (memtable rows with sequence
above the entry's build point) into the aggregate on the side, so the
steady state of a TSDB — continuous writes — stays on the device path.
Flush/compaction/ALTER change the base fingerprint and rebuild.

Eligibility: aggregate plans whose residual filters decompose into tag
EQ/IN (series-level) + numeric field comparisons (device literals), and
whose data span fits int32 relative milliseconds (~24 days).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..common_types.dict_column import as_values
from ..common_types.row_group import RowGroup
from ..ops.encoding import pad_to_bucket, shape_bucket
from ..table_engine.predicate import Predicate

_I32_MAX = 2**31 - 1


def _cache_dtype_mode() -> str:
    """HORAEDB_CACHE_DTYPE: f32 (default, exact), bf16 (every value
    column halved), or auto — the learned per-column mode: a column is
    stored bf16 only while every query shape that touched it needs just
    count/min/max of it (sums accumulate rounding; filters compare
    against the resident values), and promotes back to f32 the moment a
    sum/avg/filter usage appears (ScanCache.note_usage)."""
    import os

    v = os.environ.get("HORAEDB_CACHE_DTYPE", "f32")
    return v if v in ("f32", "bf16", "auto") else "f32"


def _cache_layout_mode() -> str:
    """HORAEDB_CACHE_LAYOUT: auto (default — per-column compressed
    layouts chosen from observed cardinality + the usage map) or raw
    (every column dense, the uncompressed behavior; also the bench A/B
    control). Read per call so operators can flip it live; entries built
    under the old mode keep their layout until rebuilt/invalidated."""
    import os

    v = os.environ.get("HORAEDB_CACHE_LAYOUT", "auto")
    return v if v in ("auto", "raw") else "auto"


def _dict_max_cardinality() -> int:
    """HORAEDB_CACHE_DICT_MAX: cardinality cap for dictionary-encoding a
    value/timestamp column (codes stay <= 16 bits regardless)."""
    from ..utils.env import env_int

    return env_int("HORAEDB_CACHE_DICT_MAX", 4096)


def _delta_max_bits() -> int:
    """HORAEDB_CACHE_DELTA_MAX_BITS: widest per-block offset the
    delta/FOR timestamp codec accepts before falling back to dict/raw."""
    from ..utils.env import env_int

    return env_int("HORAEDB_CACHE_DELTA_MAX_BITS", 16)


@dataclass
class EncodedColumn:
    """A dictionary-encoded device value column.

    Duck-types the accounting surface of a plain device array — ``nbytes``
    is the ENCODED footprint (what the byte budget and LRU price),
    ``dtype`` the LOGICAL dtype the column decodes to — while carrying
    the device parts the encoded-domain kernels consume and the sorted
    host dictionary the executor translates filter literals against."""

    words: object  # device packed codes as int32 bits (+ safety word)
    dictionary: object  # device f32/int32 dictionary, pow2-padded
    dict_host: np.ndarray  # unpadded sorted dictionary (host)
    width: int  # bits per code
    encoding: str  # "dict8" | "dict16"

    @property
    def nbytes(self) -> int:
        return int(self.words.nbytes + self.dictionary.nbytes)

    @property
    def dtype(self):
        return np.dtype(np.float32)

    @property
    def parts(self) -> tuple:
        return (self.words, self.dictionary)

    def layout(self, full_decode: bool = True) -> tuple:
        return ("dict", self.width, full_decode)


@dataclass
class ShardedColumn:
    """A value column of a sharded entry: one raw (f32 or bf16) tensor per
    shard, shard d on the mesh's device d. Duck-types the accounting
    surface of a plain tensor (``nbytes`` over every shard, ``dtype``)."""

    shards: tuple

    @property
    def nbytes(self) -> int:
        return int(sum(t.nbytes for t in self.shards))

    @property
    def dtype(self):
        return self.shards[0].dtype


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Upload one host column; uint32 word streams travel as int32 bits."""
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _dtype_name(dev) -> str:
    return str(dev.dtype).replace("torch.", "")


def _parts_nbytes(parts) -> int:
    return int(sum(p.nbytes for p in parts)) if parts else 0


def _layout_encoding(layout: tuple) -> str:
    """Inventory label of a series/ts layout descriptor."""
    if layout[0] == "dict":
        return "dict8" if layout[1] <= 8 else "dict16"
    return layout[0]  # "raw" | "delta"


def _segment_search(values: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                    x: np.ndarray) -> np.ndarray:
    """For each j, the first index i in [starts[j], ends[j]) with
    values[i] >= x[j] (ends[j] when there is none): ``np.searchsorted``
    (side "left") over each sorted segment, all segments bisected at once."""
    lo, hi = starts.copy(), ends.copy()
    while True:
        live = lo < hi
        if not live.any():
            return lo
        mid = (lo + hi) >> 1
        go = live & (values[np.where(live, mid, 0)] < x)
        lo = np.where(go, mid + 1, lo)
        hi = np.where(live & ~go, mid, hi)


class SeriesTimeIndex:
    """Each series' first row at ``n_steps + 1`` evenly spaced relative
    timestamps: ``first[j, s]`` is the first row of series ``s`` with
    ``ts_rel >= j * width`` (the series' end where there is none), about
    ``ROWS_PER_STEP`` rows of a series apart. The row bounds of a time
    range for every series then cost one row of the table and, to be
    exact, a look at the few rows of one step of each series, with no
    search per series. Built from the entry's int32 relative timestamps
    (non-negative, sorted within each series range) and series offsets."""

    ROWS_PER_STEP = 8
    # rows a step of one series may hold before the exact bound bisects
    # the step instead of reading all of its rows
    _GATHER_MAX = 64
    # rows counted a pass while building
    _CHUNK = 1 << 22

    def __init__(self, ts_rel: np.ndarray, offsets: np.ndarray):
        self.ts_rel = ts_rel
        self.offsets = np.asarray(offsets, dtype=np.int64)
        n, S = len(ts_rel), len(self.offsets) - 1
        self.n_steps = max(1, n // (self.ROWS_PER_STEP * max(S, 1)))
        span = int(ts_rel.max()) + 1 if n else 1
        self.width = -(-span // self.n_steps)  # n_steps * width >= span
        first = np.empty((self.n_steps + 1, S), dtype=np.int32 if n < 2**31 else np.int64)
        first[0] = self.offsets[:-1]
        s0 = 0
        while s0 < S:
            # a run of series of about _CHUNK rows (one series at least):
            # the rows of each series in each step, counted, then summed
            s1 = int(np.searchsorted(self.offsets, self.offsets[s0] + self._CHUNK, "right")) - 1
            s1 = min(max(s1, s0 + 1), S)
            r0, r1 = self.offsets[s0], self.offsets[s1]
            step = ts_rel[r0:r1].astype(np.int64) // self.width
            step += np.repeat(np.arange(s1 - s0, dtype=np.int64) * self.n_steps,
                              np.diff(self.offsets[s0:s1 + 1]))
            per = np.bincount(step, minlength=(s1 - s0) * self.n_steps)
            ends = np.cumsum(per.reshape(s1 - s0, self.n_steps), axis=1)
            first[1:, s0:s1] = (ends + self.offsets[s0:s1, None]).T
            s0 = s1
        self.first = first

    @property
    def nbytes(self) -> int:
        return self.first.nbytes

    def row_bounds(self, series: np.ndarray, lo: int, hi: int,
                   exact: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """int64 (starts, ends): the rows of each of ``series`` with
        ``lo <= ts_rel < hi`` lie in [starts, ends) — exactly those rows,
        or with ``exact=False`` up to one step of rows more at each end
        (no timestamp read)."""
        return self._first(series, lo, exact, 0), self._first(series, hi, exact, 1)

    def _first(self, series, x: int, exact: bool, up: int) -> np.ndarray:
        """The first row of each series with ``ts_rel >= x``; not exact:
        the step's first row below it (``up`` 0) or above it (1)."""
        if x <= 0:
            return self.offsets[series]
        if x >= self.n_steps * self.width:
            return self.offsets[series + 1]
        j, r = divmod(x, self.width)
        if r == 0 or not exact:
            return self.first[j + (up if r else 0), series].astype(np.int64)
        a = self.first[j, series].astype(np.int64)
        b = self.first[j + 1, series].astype(np.int64)
        w = int((b - a).max()) if len(a) else 0
        if w > self._GATHER_MAX:
            return _segment_search(self.ts_rel, a, b, np.full(len(a), x, dtype=np.int64))
        # the step's rows of each series, the last one repeated past its
        # end: the rows below x are a prefix of them
        rows = np.minimum(a[:, None] + np.arange(w), np.maximum(b - 1, 0)[:, None])
        below = (self.ts_rel[rows] < x).sum(axis=1)
        return a + np.minimum(below, b - a)


@dataclass
class CachedTableScan:
    """Device-resident state for one table fingerprint."""

    fingerprint: tuple
    # merged host rows. None once dropped under the host-bytes budget —
    # everything the serving path needs lives in the small derived fields
    # below (series_rows, ts_rel_host, all_valid); only extending the
    # entry with a NEW value column needs a re-read (ScanCache._extend).
    rows: Optional[RowGroup]
    n_valid: int
    min_ts: int
    max_ts: int
    # per-series (small, host): unique tsids + first-row index
    series_first_idx: np.ndarray
    n_series: int
    # device value columns by name, shape (padded,): plain f32/bf16
    # tensors or EncodedColumn wrappers (dictionary layouts); on a sharded
    # entry ShardedColumn wrappers
    value_cols_dev: dict
    # the mesh the row arrays are sharded over (None = single device):
    # ``series_parts``/``ts_parts`` then hold one raw tensor per shard, in
    # shard order, and queries on the entry MUST use the sharded kernels
    # (parallel/dist_agg, parallel/dist_raw)
    mesh: object = None
    # owning table name — keys the cache's per-column usage map (dtype
    # auto-tuning) from extend paths that only hold the entry.
    table_name: str = ""
    # sorted unique tsid values — maps delta rows onto series codes
    series_tsids: np.ndarray = None
    # per physical table id: last sequence INCLUDED in this entry; newer
    # memtable rows are the query-time delta
    built_seqs: dict = None
    # rows are SORTED by (series, ts): series i occupies
    # [series_offsets[i], series_offsets[i+1]) — selective queries gather
    # just those ranges instead of scanning the whole table
    series_offsets: np.ndarray = None
    # compressed layouts: the device part tuples the kernels
    # consume (raw -> the dense array itself) + their static descriptors;
    # padded_rows is the logical padded length
    # (len() of the dense arrays, which may not exist when encoded)
    series_parts: tuple = None
    ts_parts: tuple = None
    series_layout: tuple = ("raw",)
    ts_layout: tuple = ("raw",)
    padded_rows: int = 0
    # value columns dropped for f32/dict promotion whose re-upload hasn't
    # happened yet — an LRU eviction of this entry must resolve their
    # journaled layout_tuner decisions as outcome="evicted" (no
    # pending-until-expiry leak)
    pending_promotions: set = None

    # per-(group map, allow list) content -> device-resident upload; a
    # dashboard re-issuing the same query shape skips the upload entirely
    # (see ops.scan_agg packed serving path)
    _sessions: dict = None
    # raw (non-aggregate) reads ship only the allow-list — their own
    # content-keyed session cache (ops.scan_topk packed serving path)
    _raw_sessions: dict = None
    # GROUP BY tag columns -> (series group code, key values): group_codes
    _group_codes: dict = None
    # the connection's device: every tensor of the entry lives there
    device: torch.device = None
    # Derived host state that SURVIVES dropping ``rows`` (ref analog: the
    # reference's MemCacheStore keeps bounded bytes, mem_cache.rs:64-158):
    # one row per series (tags for group maps/filters), the int32
    # relative timestamps (selective range gathers), per-column
    # no-NULLs flags, and a 0-row schema carrier for empty deltas.
    series_rows: Optional[RowGroup] = None
    ts_rel_host: Optional[np.ndarray] = None
    # each series' first rows at evenly spaced relative timestamps: the
    # raw reads' row windows without a search per series
    time_index: Optional[SeriesTimeIndex] = None
    all_valid: dict = None
    empty_rows: Optional[RowGroup] = None
    # per-series (min, max) of each resident value column — the cached
    # path's analog of parquet row-group statistics: a numeric filter no
    # row of a series can pass excludes the series BEFORE the kernel
    # (ref: row_group_pruner.rs:240-288 value-stat pruning)
    series_value_stats: dict = None
    # resident-size accounting for the cache's byte budget
    device_bytes: int = 0
    host_bytes: int = 0
    # last serve time (hit or build) — the device telemetry plane's
    # "last-hit age" column; the usage recency the future livewindow
    # eviction policy (ROADMAP item 2) reads
    last_hit_at: float = 0.0
    # Serializes _extend against itself for THIS entry only: two hit-path
    # queries needing a missing value column must not both upload it and
    # double-count device_bytes. Per-entry, so unrelated tables' extends
    # never contend (the cache's stated no-cross-table-serialization
    # design constraint).
    ext_lock: threading.Lock = field(default_factory=threading.Lock)

    def total_bytes(self) -> int:
        return self.device_bytes + self.host_bytes

    def value_layout(self, name: str, full_decode: bool = True) -> tuple:
        """Static layout descriptor of one resident value column."""
        dev = self.value_cols_dev[name]
        if isinstance(dev, EncodedColumn):
            return dev.layout(full_decode)
        return ("bf16",) if dev.dtype == torch.bfloat16 else ("raw",)

    def shard_parts(self) -> tuple:
        """A sharded entry's (series part tuples, ts part tuples), one
        raw part tuple per shard."""
        return (
            tuple((t,) for t in self.series_parts),
            tuple((t,) for t in self.ts_parts),
        )

    def values_for(self, names: list[str]) -> tuple:
        """Per-field device part tuples, in ``names`` order: the kernel
        reads each column where it lives, so nothing is stacked. On a
        sharded entry: one such tuple per shard."""
        if self.mesh is not None:
            cols = [self.value_cols_dev[n] for n in names]
            return tuple(
                tuple((c.shards[d],) for c in cols) for d in range(self.mesh.size)
            )
        return tuple(
            dev.parts if isinstance(dev, EncodedColumn) else (dev,)
            for dev in (self.value_cols_dev[n] for n in names)
        )

    def _session_lru(self, attr: str, key: bytes, build):
        """Content-keyed bounded-LRU get-or-build shared by both session
        caches; benign races just upload twice."""
        cache = getattr(self, attr)
        if cache is None:
            cache = {}
            setattr(self, attr, cache)
        dev = cache.pop(key, None)
        if dev is None:
            if len(cache) >= 32:
                try:  # racing evictors may target the same oldest key
                    cache.pop(next(iter(cache)), None)
                except (StopIteration, RuntimeError):
                    pass
            dev = build()
        cache[key] = dev
        return dev

    def group_codes(self, columns: tuple) -> tuple:
        """(series group code, key values per column) of the GROUP BY tag
        ``columns`` over this entry's series rows, computed once per
        column tuple: the series rows never change once built, and every
        query of a shape that groups by the same tags reuses the codes."""
        from ..ops.encoding import _codes_from_columns

        if self._group_codes is None:
            self._group_codes = {}
        hit = self._group_codes.get(columns)
        if hit is None:
            codes, key_values = _codes_from_columns(
                [self.series_rows.columns[c] for c in columns]
            )
            for a in (codes, *key_values):
                if isinstance(a, np.ndarray):
                    a.setflags(write=False)  # shared by every later query
            hit = self._group_codes[columns] = (codes, key_values)
        return hit

    def session_for(self, gos: np.ndarray, allow: np.ndarray):
        """Device handle for the packed [group map | allow list] upload,
        keyed by CONTENT — repeats of a query shape (the dashboard steady
        state) reuse the resident buffer and ship zero series-level bytes."""
        from ..ops.scan_agg import pack_session

        return self._session_lru(
            "_sessions",
            gos.tobytes() + allow.tobytes(),
            lambda: _to_device(pack_session(gos, allow), self.device),
        )

    def raw_session_for(self, allow: np.ndarray):
        """Device handle for a raw read's allow-list upload (raw reads
        ship no group map), content-keyed like the aggregate sessions."""
        return self._session_lru(
            "_raw_sessions",
            allow.tobytes(),
            lambda: _to_device(allow.astype(np.int32), self.device),
        )


def _rowgroup_bytes(rows: RowGroup) -> int:
    """Approximate resident bytes of a RowGroup's host columns."""
    from ..common_types.dict_column import DictColumn

    total = 0
    for arr in rows.columns.values():
        if isinstance(arr, DictColumn):
            total += arr.codes.nbytes
            total += sum(len(str(v)) + 49 for v in arr.values)  # str overhead
        elif isinstance(arr, np.ndarray) and arr.dtype == object:
            total += arr.nbytes + 56 * len(arr)  # pointer + str objects
        else:
            total += arr.nbytes
    for mask in rows.validity.values():
        total += mask.nbytes
    return total


class ScanCache:
    """Bounded by BYTES, not entry count (ref: mem_cache.rs:64-158 — the
    reference budgets its partitioned LRU by capacity): entries are
    evicted least-recently-used until resident device+host bytes fit
    ``max_bytes`` (HORAEDB_SCAN_CACHE_MB, default RAM/4). A single table
    whose resident state alone exceeds the budget is never built — the
    host path serves it instead of failing a giant device_put. Entries
    whose HOST rows exceed HORAEDB_CACHE_HOST_ROWS_MB (default 256) drop
    the host copy after deriving the small serving-side state; a later
    query needing a NEW value column re-reads from the SSTs."""

    def __init__(
        self,
        device: torch.device,
        max_entries: int = 4,
        max_bytes: Optional[int] = None,
        max_host_rows_bytes: Optional[int] = None,
    ) -> None:
        self.device = device
        self._entries: dict[str, CachedTableScan] = {}
        # fingerprint last seen per table: a cache build is only worth the
        # full-table read once the data has been STABLE across two
        # consecutive eligible queries (a write-heavy table would otherwise
        # rebuild — full read + upload — on every single query).
        self._candidate: dict[str, tuple] = {}
        # per table -> per value column: how query shapes have USED it
        # ({"sum": bool, "filter": bool}) — drives the auto dtype choice.
        # Sticky by design: one sum/filter usage pins the column f32 for
        # the cache's lifetime (a later min/max-only query must not
        # demote a column some dashboard still sums).
        self._usage: dict[str, dict[str, dict]] = {}
        self._lock = threading.Lock()
        self.max_entries = max_entries
        if max_bytes is not None:
            self.max_bytes = max_bytes
        else:
            from .partial import _budget_bytes

            self.max_bytes = _budget_bytes("HORAEDB_SCAN_CACHE_MB")
        from ..utils.env import env_int

        self.max_host_rows_bytes = (
            max_host_rows_bytes
            if max_host_rows_bytes is not None
            else env_int("HORAEDB_CACHE_HOST_ROWS_MB", 256) << 20
        )
        self.hits = 0
        self.misses = 0
        # per-table budget-eviction counts (survive the entry — the
        # device telemetry plane reports them; bounded LRU-style)
        self._evictions: dict[str, int] = {}
        # the cache IS the HBM residency source: the device telemetry
        # plane walks registered caches for system.public.device
        from ..obs.device import register_occupancy_provider

        register_occupancy_provider(self)

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.total_bytes() for e in self._entries.values())

    def occupancy_bytes(self) -> dict:
        """Cheap component byte sums (no row materialization) — the
        hot-path gauge refresh (obs/device.refresh_occupancy) reads this
        instead of snapshot_device()."""
        with self._lock:
            entries = list(self._entries.values())
        col = sess = 0
        for e in entries:
            try:
                col += e.device_bytes
                for attr in ("_sessions", "_raw_sessions"):
                    c = getattr(e, attr)
                    if c:
                        sess += sum(v.nbytes for v in list(c.values()))
            except Exception:
                continue  # a racing extend/evict: best-effort sums
        return {"column": col, "session": sess}

    def snapshot_device(self) -> list[dict]:
        """Per-(table, column, dtype) HBM residency rows for the device
        telemetry plane (obs/device.device_inventory). ``component=
        "column"`` rows sum EXACTLY to the entries' ``device_bytes``
        accounting (the acceptance invariant); sessions — the
        content-keyed query-shape uploads — are
        reported beside them; evicted tables keep a zero-byte row
        carrying their eviction count."""
        with self._lock:
            entries = list(self._entries.items())
            evictions = dict(self._evictions)
        now = time.time()
        rows: list[dict] = []

        def row(table: str, column: str, component: str, dtype: str,
                nbytes: int, nrows: int, age_ms: int,
                encoding: str = "", logical_rows: int = 0) -> dict:
            return {
                "table_name": table,
                "column_name": column,
                "component": component,
                "dtype": dtype,
                "bytes": int(nbytes),
                "rows": int(nrows),
                "last_hit_age_ms": age_ms,
                "evictions": int(evictions.get(table, 0)),
                # compressed-layout inventory: what form the
                # bytes are in, and how many LOGICAL rows they serve —
                # rows-per-HBM-byte is logical_rows / bytes
                "encoding": encoding,
                "logical_rows": int(logical_rows),
            }

        for name, e in entries:
            try:
                age = (
                    int((now - e.last_hit_at) * 1000)
                    if e.last_hit_at else -1
                )
                sc_bytes = _parts_nbytes(e.series_parts)
                ts_bytes = _parts_nbytes(e.ts_parts)
                rows.append(row(name, "__series_codes__", "column", "int32",
                                sc_bytes, e.n_valid, age,
                                encoding=_layout_encoding(e.series_layout),
                                logical_rows=e.n_valid))
                rows.append(row(name, "__ts_rel__", "column", "int32",
                                ts_bytes, e.n_valid, age,
                                encoding=_layout_encoding(e.ts_layout),
                                logical_rows=e.n_valid))
                for col, dev in list(e.value_cols_dev.items()):
                    if isinstance(dev, EncodedColumn):
                        enc = dev.encoding
                    elif dev.dtype == torch.bfloat16:
                        enc = "bf16"
                    else:
                        enc = "raw"
                    rows.append(row(name, col, "column", _dtype_name(dev),
                                    dev.nbytes, e.n_valid, age,
                                    encoding=enc, logical_rows=e.n_valid))
                for attr, label in (("_sessions", "__sessions__"),
                                    ("_raw_sessions", "__raw_sessions__")):
                    cache = getattr(e, attr)
                    if cache:
                        vals = list(cache.values())
                        rows.append(row(
                            name, label, "session", "int32",
                            sum(v.nbytes for v in vals), len(vals), age,
                        ))
            except Exception:
                continue  # a racing extend/evict: skip this entry's rows
        resident = {name for name, _ in entries}
        for table, n in evictions.items():
            if table not in resident and n:
                rows.append(row(table, "", "evicted", "", 0, 0, -1))
        return rows

    # ---- learned per-column dtype ---------------------------------------
    def note_usage(
        self,
        table_name: str,
        value_columns: list[str],
        sum_cols=(),
        filter_cols=(),
    ) -> None:
        """Record how this query shape touches each value column — the
        feedback the HORAEDB_CACHE_DTYPE=auto mode tunes dtypes from
        ("fine-tune the data structure to the workload", arXiv
        2112.13099). Called by the executor BEFORE the cache lookup, so
        the very first build of an entry already stores min/max-only
        columns as bf16. A column already resident as bf16 whose usage
        GROWS a sum/filter is promoted: its device copy is dropped here
        and the ordinary extend path re-uploads it f32."""
        promote: list[str] = []
        with self._lock:
            usage = self._usage.get(table_name)
            if usage is None:
                # bound tracked tables LRU-style (dict order = recency)
                if len(self._usage) >= 512:
                    self._usage.pop(next(iter(self._usage)))
                usage = self._usage[table_name] = {}
            else:
                self._usage[table_name] = self._usage.pop(table_name)
            for c in value_columns:
                u = usage.setdefault(c, {"sum": False, "filter": False})
                was_exact = u["sum"] or u["filter"]
                u["sum"] |= c in sum_cols
                u["filter"] |= c in filter_cols
                if (u["sum"] or u["filter"]) and not was_exact:
                    promote.append(c)
            entry = self._entries.get(table_name)
        if promote and entry is not None and _cache_dtype_mode() == "auto":
            self._drop_bf16_columns(entry, promote)
            from ..obs.device import refresh_occupancy

            refresh_occupancy(force=True)  # bf16 drop freed device bytes

    def _column_dtype(self, table_name: str, column: str):
        """Resident dtype for one value column under the current mode."""
        mode = _cache_dtype_mode()
        if mode == "bf16":
            return torch.bfloat16
        if mode == "auto":
            with self._lock:
                u = self._usage.get(table_name, {}).get(column)
            # unknown usage -> exact: auto must never guess lossy
            if u is not None and not (u["sum"] or u["filter"]):
                return torch.bfloat16
        return torch.float32

    @staticmethod
    def _drop_bf16_columns(entry: CachedTableScan, columns) -> None:
        """Evict now-stale bf16 device copies so the extend path
        re-uploads them at f32 (may force an SST re-read if the host
        rows were dropped — correctness over residency)."""
        from ..obs.decisions import record_decision

        with entry.ext_lock:
            for c in columns:
                dev = entry.value_cols_dev.get(c)
                if dev is None or dev.dtype != torch.bfloat16:
                    continue
                entry.value_cols_dev.pop(c)
                entry.device_bytes -= dev.nbytes
                if entry.series_value_stats is not None:
                    entry.series_value_stats.pop(c, None)
                # Decision plane: the tuner chose to spend HBM for
                # exactness. Predicted: the f32 re-upload doubles the
                # dropped bf16 bytes; the extend path resolves with the
                # bytes ACTUALLY uploaded (a grown pad bucket, a raced
                # rebuild, or a dictionary re-encode beating f32 shows
                # up as calibration error).
                record_decision(
                    "layout_tuner",
                    key=f"{entry.table_name}:{c}",
                    choice="promote_f32",
                    features={"bf16_bytes": int(dev.nbytes)},
                    predicted=float(dev.nbytes) * 2.0,
                )
                # An LRU eviction of the whole entry before the re-upload
                # must resolve this decision (outcome=evicted), not leak
                # it to TTL expiry.
                if entry.pending_promotions is None:
                    entry.pending_promotions = set()
                entry.pending_promotions.add(c)

    @staticmethod
    def _resolve_pending_evicted(entry: CachedTableScan) -> None:
        """Resolve still-pending promotion decisions of a dying entry as
        ``outcome=evicted`` — the re-upload they predicted will never
        happen, so without this they sit pending until TTL expiry and
        the tenantsim accounting shows them as leaks. No calibration:
        there is no realized-bytes ground truth for an upload that never
        ran."""
        pending = entry.pending_promotions
        if not pending:
            return
        from ..obs.decisions import DECISION_JOURNAL

        for c in list(pending):
            DECISION_JOURNAL.resolve_matching(
                "layout_tuner",
                f"{entry.table_name}:{c}",
                actual=0.0,
                outcome="evicted",
                calibrate=False,
            )
        pending.clear()

    def _evict_over_budget_locked(self, keep: str) -> int:
        """Evict least-recently-used entries (never ``keep``) until both
        the entry-count and byte budgets hold — the ONE eviction policy;
        the insert path and the hit path (whose _extend uploads grow
        entries) both call it. Returns how many entries were evicted so
        callers can force the occupancy-gauge refresh on mutation."""
        evicted = 0
        while len(self._entries) > 1 and (
            len(self._entries) > self.max_entries
            or sum(e.total_bytes() for e in self._entries.values())
            > self.max_bytes
        ):
            victim = next(
                (k for k in self._entries if k != keep), None
            )
            if victim is None:
                return evicted
            self._resolve_pending_evicted(self._entries.pop(victim))
            evicted += 1
            # accounted eviction: the device plane reports per-table
            # counts (the usage-map signal the layout tuner reads)
            if len(self._evictions) >= 512 and victim not in self._evictions:
                self._evictions.pop(next(iter(self._evictions)))
            self._evictions[victim] = self._evictions.get(victim, 0) + 1
            from ..obs.device import note_eviction

            note_eviction()
        return evicted

    def get(
        self,
        table,
        value_columns: list[str],
        read_rows,
    ) -> tuple[Optional[CachedTableScan], bool, Optional["RowGroup"]]:
        """(cached scan state, was_built_this_call, delta_rows).

        ``read_rows()`` materializes the full-table merged rows on miss.
        ``delta_rows`` (possibly empty) are memtable rows written AFTER the
        entry was built — the executor folds them into the aggregate so
        ingest doesn't evict the HBM state. Entry is None when the table's
        shape doesn't fit the cached-kernel contract (span overflow, empty
        table), or when the base state hasn't been stable long enough.
        """
        base_fp = _base_fingerprint(table)
        from ..parallel.mesh import serving_mesh

        mesh_now = serving_mesh(device=self.device)
        with self._lock:
            entry = self._entries.get(table.name)
            if entry is not None and entry.mesh is not None and entry.mesh is not mesh_now:
                # The mesh changed: the entry's shards are placed on the old
                # one — rebuild from scratch.
                self._resolve_pending_evicted(self._entries.pop(table.name))
                entry = None
            hit = entry is not None and entry.fingerprint == base_fp
            if not hit and self._candidate.get(table.name) != base_fp:
                # first sighting of this base state: don't build yet
                self._candidate[table.name] = base_fp
                self.misses += 1
                return None, False, None
        if hit:
            # Delta materialization and column upload run OUTSIDE the
            # cache lock — they do O(memtable) / O(rows) work and must not
            # serialize unrelated tables' queries. Entry mutation during
            # _extend is per-entry idempotent; the fingerprint re-check
            # catches a racing flush.
            if not all(c in entry.value_cols_dev for c in value_columns):
                if not self._extend(
                    entry, value_columns, read_rows=read_rows, table=table
                ):
                    # host rows were dropped and the re-read raced a
                    # write: serve this query from the host path
                    self.misses += 1
                    return None, False, None
            delta = _read_delta(table, entry)
            with self._lock:
                if delta is not None and _base_fingerprint(table) == base_fp:
                    self.hits += 1
                    entry.last_hit_at = time.time()
                    # LRU touch: reinsert at the tail
                    e = self._entries.pop(table.name, None)
                    if e is not None:
                        self._entries[table.name] = e
                    # _extend above may have grown this entry's device
                    # bytes — the budget holds on the hit path too.
                    evicted = self._evict_over_budget_locked(keep=table.name)
                else:
                    # A flush raced the delta read (or the delta predates
                    # the entry inconsistently): serve nothing from cache.
                    self.misses += 1
                    entry = None
                    evicted = 0
            # gauge refresh OUTSIDE the cache lock (snapshot_device
            # re-takes it); _extend above may have changed residency.
            # An eviction forces through the throttle — it may be the
            # last touch for a while and must not park the gauge.
            from ..obs.device import refresh_occupancy

            refresh_occupancy(force=bool(evicted))
            if entry is None:
                return None, False, None
            return entry, False, delta
        seq_before = {d.table_id: d.last_sequence for d in table.physical_datas()}
        rows = read_rows()
        seq_after = {d.table_id: d.last_sequence for d in table.physical_datas()}
        if seq_before != seq_after or _base_fingerprint(table) != base_fp:
            # Writes or a flush raced the build read: the entry's exact
            # row set would be ambiguous (delta double/under-count) —
            # skip building this time.
            return None, False, None
        n = len(rows)
        if n == 0:
            return None, False, None
        ts = rows.timestamps
        min_ts, max_ts = int(ts.min()), int(ts.max())
        if max_ts - min_ts >= _I32_MAX:
            return None, False, None
        # A table whose resident state ALONE busts the byte budget never
        # builds — the host path serves it instead of a failing (or
        # budget-starving) giant device_put. Under the layout tuner the
        # raw estimate may overstate the encoded footprint by the codec
        # ratio, so auto mode admits down to a best-case 8x and the
        # post-build check below enforces the REAL bytes.
        est = shape_bucket(n + 1) * 4 * (2 + len(value_columns))
        if _cache_layout_mode() == "auto":
            est //= 8
        host_est = min(_rowgroup_bytes(rows), self.max_host_rows_bytes)
        if est + host_est > self.max_bytes:
            return None, False, None
        entry = self._build(
            base_fp, rows, min_ts, max_ts, value_columns, table.name
        )
        if entry.total_bytes() > self.max_bytes:
            # the codecs didn't deliver the admitted ratio: the realized
            # entry alone busts the budget — never insert it
            self._resolve_pending_evicted(entry)
            return None, False, None
        entry.built_seqs = seq_after
        entry.last_hit_at = time.time()
        with self._lock:
            self.misses += 1
            self._entries.pop(table.name, None)
            self._entries[table.name] = entry
            self._evict_over_budget_locked(keep=table.name)
        from ..obs.device import refresh_occupancy

        refresh_occupancy(force=True)  # a build is a residency mutation
        empty = entry.empty_rows
        return entry, True, empty

    @staticmethod
    def _resident_layout(rows: RowGroup):
        """THE resident layout: rows sorted by (series, ts). One
        definition — _build derives it and _extend's re-read (after a
        host-rows drop) must reproduce it bit-for-bit.

        Selective queries (a handful of series out of thousands — the
        TSBS single-groupby shape) become contiguous-range gathers
        instead of full scans because of this sort."""
        schema = rows.schema
        tsid = rows.columns[schema.columns[schema.tsid_index].name]
        uniq, _, inverse = np.unique(tsid, return_index=True, return_inverse=True)
        order = np.lexsort((rows.timestamps, inverse))
        return rows.take(order), uniq, inverse[order]

    def _build(
        self,
        fp,
        rows: RowGroup,
        min_ts: int,
        max_ts: int,
        value_columns: list[str],
        table_name: str = "",
    ) -> CachedTableScan:
        n = len(rows)
        schema = rows.schema
        rows, uniq, inverse = self._resident_layout(rows)
        n_series = len(uniq)
        counts = np.bincount(inverse, minlength=n_series)
        offsets = np.zeros(n_series + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        first_idx = offsets[:-1].copy()
        # One explicit pad row at index n (series code n_series, allow
        # masked): selective gathers point their padding here even when n
        # itself is a power of two.
        codes = pad_to_bucket(
            np.append(inverse.astype(np.int32), np.int32(n_series)), n + 1,
            fill=n_series,
        )
        ts_rel = pad_to_bucket(
            np.append((rows.timestamps - min_ts).astype(np.int32), np.int32(-1)),
            n + 1,
            fill=np.int32(-1),
        )
        # Multi-device: the row arrays live SHARDED across the mesh, so
        # steady-state serving is itself distributed (each device holds
        # and scans one contiguous block of rows; the combine is one
        # kernel). Small tables stay single-device — the same threshold as
        # the uncached path. Sharded entries keep raw series and ts
        # layouts: the delta and dict encodings are single-device only.
        from ..parallel.mesh import dist_min_rows, serving_mesh

        mesh = serving_mesh(device=self.device) if n >= dist_min_rows() else None
        series_layout = ts_layout = ("raw",)
        series_parts = ts_parts = None
        padded_rows = len(codes)
        if mesh is not None:
            from ..parallel.mesh import shard_rows

            padded_rows += -padded_rows % mesh.size
            series_parts = tuple(shard_rows(torch.from_numpy(codes), mesh, fill=n_series))
            ts_parts = tuple(shard_rows(torch.from_numpy(ts_rel), mesh, fill=-1))
        # Compressed layouts. Both codecs are lossless and
        # roundtrip-verified; any rejection falls back to the dense
        # array, bit-identical to the raw layout.
        elif _cache_layout_mode() == "auto":
            from ..obs.decisions import DECISION_JOURNAL, record_decision
            from ..ops.encoding import delta_for_encode, dict_encode

            def _journal(col, choice, predicted, actual, **features):
                record_decision(
                    "layout_tuner",
                    key=f"{table_name}:{col}",
                    choice=choice,
                    features=features,
                    predicted=predicted,
                )
                DECISION_JOURNAL.resolve_matching(
                    "layout_tuner",
                    f"{table_name}:{col}",
                    actual=actual,
                    outcome="encoded",
                )

            # Series codes are sorted consecutive np.unique inverses:
            # any 128-row block spans <= 128 distinct codes, so
            # delta/FOR at width <= 8 succeeds whenever the padded
            # bucket is block-aligned (tiny tables stay raw).
            d = delta_for_encode(codes, 8)
            if d is not None:
                series_layout = ("delta", d.width)
                series_parts = (
                    _to_device(d.words, self.device),
                    _to_device(d.base, self.device),
                )
                _journal(
                    "__series_codes__", "delta",
                    predicted=len(codes) * d.width / 8.0 + d.base.nbytes,
                    actual=float(_parts_nbytes(series_parts)),
                    width=d.width,
                )
            # The -1 pad fill would blow the FOR width at the tail;
            # pad rows are series-masked in every kernel (the allow
            # list's last entry is always False), so the encoded
            # stream may carry any value there — reuse the last real
            # timestamp. ts_rel_host keeps the true values.
            ts_src = ts_rel.copy()
            ts_src[n:] = ts_src[n - 1] if n else 0
            dt = delta_for_encode(ts_src, _delta_max_bits())
            if dt is not None:
                ts_layout = ("delta", dt.width)
                ts_parts = (
                    _to_device(dt.words, self.device),
                    _to_device(dt.base, self.device),
                )
                _journal(
                    "__ts_rel__", "delta",
                    predicted=len(ts_src) * dt.width / 8.0 + dt.base.nbytes,
                    actual=float(_parts_nbytes(ts_parts)),
                    width=dt.width,
                )
            else:
                # aligned multi-series timestamps: few distinct
                # relative values — a dictionary beats raw even when
                # per-block ranges are wide
                de = dict_encode(ts_src, _dict_max_cardinality())
                if de is not None:
                    ts_layout = ("dict", de.width)
                    ts_parts = (
                        _to_device(de.words, self.device),
                        _to_device(de.dictionary, self.device),
                    )
                    _journal(
                        "__ts_rel__", de.encoding,
                        predicted=len(ts_src) * de.width / 8.0
                        + de.dict_host.nbytes,
                        actual=float(_parts_nbytes(ts_parts)),
                        width=de.width,
                        cardinality=len(de.dict_host),
                    )
        if series_parts is None:
            series_parts = (_to_device(codes, self.device),)
        if ts_parts is None:
            ts_parts = (_to_device(ts_rel, self.device),)
        entry = CachedTableScan(
            fingerprint=fp,
            rows=rows,
            n_valid=n,
            min_ts=min_ts,
            max_ts=max_ts,
            series_first_idx=first_idx,
            n_series=n_series,
            value_cols_dev={},
            table_name=table_name,
            series_tsids=uniq,
            series_offsets=offsets,
            series_parts=series_parts,
            ts_parts=ts_parts,
            series_layout=series_layout,
            ts_layout=ts_layout,
            padded_rows=padded_rows,
            device=mesh.first if mesh is not None else self.device,
            mesh=mesh,
        )
        # Serving-side state that outlives the host rows: per-series tag
        # rows, int32 relative timestamps, no-NULL flags, schema carrier.
        entry.series_rows = RowGroup(
            schema,
            {c.name: rows.columns[c.name][first_idx] for c in schema.columns},
            {name: mask[first_idx] for name, mask in rows.validity.items()},
        )
        entry.ts_rel_host = (rows.timestamps - min_ts).astype(np.int32)
        entry.time_index = SeriesTimeIndex(entry.ts_rel_host, offsets)
        entry.all_valid = {
            c.name: bool(rows.valid_mask(c.name).all()) for c in schema.columns
        }
        entry.empty_rows = rows.slice(0, 0)
        entry.device_bytes = _parts_nbytes(series_parts) + _parts_nbytes(ts_parts)
        entry.host_bytes = (
            _rowgroup_bytes(rows)
            + entry.ts_rel_host.nbytes
            + entry.time_index.nbytes
            + _rowgroup_bytes(entry.series_rows)
        )
        # _extend uploads the value columns and then applies the host
        # budget: an oversized full host copy is dropped (the derived
        # state above keeps the device path serving; _extend re-reads
        # from the SSTs should a new value column ever be requested).
        self._extend(entry, value_columns)
        return entry

    def _extend(
        self,
        entry: CachedTableScan,
        value_columns: list[str],
        read_rows=None,
        table=None,
    ) -> bool:
        """Upload any missing value columns; False when the entry's host
        rows were dropped and the re-read couldn't reproduce the build
        state (caller serves from the host path).

        Runs OUTSIDE the cache-wide lock (O(rows) work must not serialize
        unrelated tables) but UNDER the entry's own lock: concurrent
        hit-path extends re-check ``value_cols_dev`` after acquiring it,
        so a column uploads once and ``device_bytes`` counts once."""
        with entry.ext_lock:
            return self._extend_locked(entry, value_columns, read_rows, table)

    def _extend_locked(
        self,
        entry: CachedTableScan,
        value_columns: list[str],
        read_rows=None,
        table=None,
    ) -> bool:
        missing = [c for c in value_columns if c not in entry.value_cols_dev]
        if missing and entry.rows is None:
            if read_rows is None or table is None:
                return False
            # The re-read must reproduce EXACTLY the build-time row set.
            # Any write since the build — including an OVERWRITE of an
            # existing (tsid, ts) key, which changes neither the row
            # count nor the timestamps — would leak into the uploaded
            # column AND be re-counted by the delta fold. Same guard the
            # build path uses: sequences must still equal the build point.
            def _seqs():
                return {
                    d.table_id: d.last_sequence for d in table.physical_datas()
                }

            if entry.built_seqs is None or _seqs() != entry.built_seqs:
                return False
            # Re-derive the EXACT resident layout (the ONE definition in
            # _resident_layout) — deterministic for an unchanged base.
            rows = read_rows()
            if _seqs() != entry.built_seqs:
                return False  # a write raced the re-read
            if len(rows) != entry.n_valid:
                return False
            rows, _, _ = self._resident_layout(rows)
            if not np.array_equal(
                (rows.timestamps - entry.min_ts).astype(np.int32),
                entry.ts_rel_host,
            ):
                return False
            entry.rows = rows  # keep until the next budget sweep

        target = entry.padded_rows
        # HORAEDB_CACHE_DTYPE: bf16 halves resident HBM for value columns
        # (the kernel upcasts to f32 in registers for accumulation; the win
        # is bandwidth/capacity). Costs
        # ~3 significant digits on stored samples, INCLUDING values that
        # numeric filters compare against — rows within bf16 rounding of
        # a filter threshold may classify differently than the host path.
        # Default stays f32; "bf16" opts every column in; "auto" tunes
        # per column from observed usage (_column_dtype: min/max-only
        # columns shrink, summed/filtered columns stay exact).
        for c in value_columns:
            if c not in entry.value_cols_dev:
                dtype = self._column_dtype(entry.table_name, c)
                # entry.rows is already in the sorted resident layout;
                # the bf16 rounding happens on the host, so the per-series
                # stats below see exactly the values the kernel reads
                arr = as_values(entry.rows.column(c)).astype(np.float32, copy=False)
                padded = np.pad(arr, (0, target - len(arr)))
                host_col = torch.from_numpy(padded)
                if dtype == torch.bfloat16:
                    host_col = host_col.to(torch.bfloat16)
                # Layout tuner: a low-cardinality exact column
                # stores as bit-packed dictionary codes + a small sorted
                # f32 dictionary — lossless (bit-verified in dict_encode)
                # and 4-8x smaller. bf16 columns keep the lossy half-size
                # layout the dtype mode chose; sharded entries stay raw.
                enc = None
                if (
                    entry.mesh is None
                    and _cache_layout_mode() == "auto"
                    and dtype == torch.float32
                ):
                    from ..ops.encoding import dict_encode

                    enc = dict_encode(padded, _dict_max_cardinality())
                if enc is not None:
                    from ..obs.decisions import record_decision

                    record_decision(
                        "layout_tuner",
                        key=f"{entry.table_name}:{c}",
                        choice=enc.encoding,
                        features={
                            "cardinality": len(enc.dict_host),
                            "width": enc.width,
                            "raw_bytes": int(padded.nbytes),
                        },
                        predicted=target * enc.width / 8.0
                        + enc.dict_host.nbytes,
                    )
                    dev = EncodedColumn(
                        words=_to_device(enc.words, self.device),
                        dictionary=_to_device(enc.dictionary, self.device),
                        dict_host=enc.dict_host,
                        width=enc.width,
                        encoding=enc.encoding,
                    )
                    # memtable ride-along: remember this column arrives
                    # low-cardinality so freezes dictionary-code it early
                    from ..common_types.layout_hints import note_low_cardinality

                    note_low_cardinality(
                        entry.table_name, c, len(enc.dict_host)
                    )
                elif entry.mesh is not None:
                    # one raw (f32 or bf16) block of rows per shard, each on
                    # its device
                    from ..parallel.mesh import shard_rows

                    dev = ShardedColumn(tuple(shard_rows(host_col, entry.mesh)))
                else:
                    dev = host_col.to(self.device)
                entry.value_cols_dev[c] = dev
                entry.device_bytes += dev.nbytes
                if dtype != torch.bfloat16:
                    # an exact upload closes any pending promote_f32
                    # decision for this column — and, one call, the
                    # just-recorded encode decision (no match -> no-op:
                    # a plain first raw upload decided nothing)
                    from ..obs.decisions import DECISION_JOURNAL

                    outcome = (
                        "promoted"
                        if entry.pending_promotions
                        and c in entry.pending_promotions
                        else "encoded"
                    )
                    DECISION_JOURNAL.resolve_matching(
                        "layout_tuner",
                        f"{entry.table_name}:{c}",
                        actual=float(dev.nbytes),
                        outcome=outcome,
                    )
                    if entry.pending_promotions:
                        entry.pending_promotions.discard(c)
                # Per-series min/max over the SAME values the kernel sees
                # — the dtype-CAST values (bf16-resident columns compare
                # rounded), with fills included and NaN samples ignored
                # (np.fmin/fmax: a NaN passes no numeric filter, so it
                # must not poison a series' stats; an all-NaN series
                # yields NaN stats and correctly prunes). Every series is
                # non-empty by construction (offsets from bincount of
                # present rows), so reduceat is well-defined.
                if entry.series_value_stats is None:
                    entry.series_value_stats = {}
                seg = entry.series_offsets[:-1]
                stat_src = host_col[: len(arr)].to(torch.float64).numpy()
                entry.series_value_stats[c] = (
                    np.fmin.reduceat(stat_src, seg),
                    np.fmax.reduceat(stat_src, seg),
                )
        self._apply_host_budget(entry)
        return True

    def _apply_host_budget(self, entry: CachedTableScan) -> None:
        """Drop the full host rows copy when it exceeds the per-entry
        budget; the derived serving state stays."""
        if (
            entry.rows is not None
            and _rowgroup_bytes(entry.rows) > self.max_host_rows_bytes
        ):
            entry.rows = None
            entry.host_bytes = (
                entry.ts_rel_host.nbytes
                + entry.time_index.nbytes
                + _rowgroup_bytes(entry.series_rows)
            )

    def invalidate(self, table_name: str) -> None:
        with self._lock:
            entry = self._entries.pop(table_name, None)
            if entry is not None:
                self._resolve_pending_evicted(entry)
        from ..obs.device import refresh_occupancy

        # forced: an invalidation (DROP/ALTER) may be the last cache
        # touch for a long time — a throttled skip would leave the
        # resident-bytes gauges reporting the freed bytes until the
        # next query, and the recorder would persist the stale value
        refresh_occupancy(force=True)


def _base_fingerprint(table) -> tuple:
    """The FLUSHED state only: schema + flushed sequence + SST file set.

    Plain memtable appends deliberately do NOT change it — they are
    served as a delta on top of the cached base."""
    parts = []
    for data in table.physical_datas():
        files = tuple(
            (h.level, h.file_id) for h in data.version.levels.all_files()
        )
        parts.append(
            (
                data.table_id,
                data.schema.version,  # ALTER invalidates even with no writes
                data.version.flushed_sequence,
                files,
            )
        )
    return tuple(parts)


def _append_newer(parts: list, rows, seqs, built: int) -> None:
    """Append the sub-slice of rows written after the build point."""
    if len(rows) == 0:
        return
    keep = seqs > built
    if keep.any():
        parts.append(rows if keep.all() else rows.filter(keep))


def _read_delta(table, entry: CachedTableScan):
    """Memtable rows with sequence above the entry's build point, or None
    when the delta cannot be trusted (entry predates unknown state)."""
    if entry.built_seqs is None:
        return None
    parts = []
    for data in table.physical_datas():
        built = entry.built_seqs.get(data.table_id)
        if built is None:
            return None  # physical set changed (e.g. partition added)
        version = data.version
        for mem in [*version.immutables(), version.mutable]:
            # snapshot() is uniform across memtable kinds: frozen segments
            # (layered only) + the mutable head. Whole segments at or
            # below the build point are skipped on their scalar max_seq —
            # the delta never touches rows older than the cache entry.
            segments, head_rows, head_seqs = mem.snapshot()
            for seg in segments:
                if seg.max_seq <= built:
                    continue
                _append_newer(parts, seg.rows, seg.seqs, built)
            _append_newer(parts, head_rows, head_seqs, built)
    if not parts:
        # verified clean: an empty RowGroup with the table schema
        return entry.empty_rows
    from ..common_types.row_group import RowGroup

    return RowGroup.concat(parts) if len(parts) > 1 else parts[0]
