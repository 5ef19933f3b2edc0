"""Write-ahead log (ref: src/wal — WalManager trait, manager.rs:325-360).

The reference ships RocksDB / table-KV / Kafka WAL backends behind one
trait. Here the trait is ``WalManager`` and the first backend is a
local-disk log: one append-only file per table (the reference's
``TableBased`` layout), each record framed as

    [u32 len][u32 crc32][payload]
    payload = msgpack { seq, ipc: arrow-IPC-serialized row batch }

Arrow IPC is the value codec (self-describing, zero-copy-friendly — the
reference uses arrow IPC for its remote-engine streams, components/
arrow_ext). Replay decodes with the table's CURRENT schema, so rows logged
before an ALTER read back with NULL-filled new columns.

Truncation (``mark_flushed``): the flushed sequence is recorded in a side
file; replay skips records <= flushed. When everything in the log is
flushed the log file is deleted outright (the common case after a clean
flush), so the log never grows unboundedly across flush cycles.
"""

from __future__ import annotations

import io
import os
import struct
import threading
import zlib
from abc import ABC, abstractmethod
from typing import Iterator, Optional

import msgpack
import pyarrow as pa

from ..common_types.row_group import RowGroup
from ..common_types.schema import Schema

_FRAME = struct.Struct("<II")  # len, crc32


class WalCorruption(RuntimeError):
    pass


class WalManager(ABC):
    @abstractmethod
    def append(self, table_id: int, seq: int, rows: RowGroup) -> None: ...

    @abstractmethod
    def read_from(
        self, table_id: int, from_seq: int
    ) -> Iterator[tuple[int, "pa.RecordBatch"]]: ...

    @abstractmethod
    def mark_flushed(self, table_id: int, seq: int) -> None: ...

    @abstractmethod
    def delete_table(self, table_id: int) -> None: ...

    def close(self) -> None:
        pass

    def stats(self) -> dict:
        """Introspection for /debug/wal_stats (ref: http.rs:587-613)."""
        return {"backend": type(self).__name__}


def _encode_record(seq: int, rows: RowGroup, table_id: Optional[int] = None) -> bytes:
    batch = rows.to_arrow()
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    rec = {"seq": seq, "ipc": sink.getvalue()}
    if table_id is not None:
        rec["tid"] = table_id  # region logs multiplex tables
    payload = msgpack.packb(rec, use_bin_type=True)
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def _iter_frame_meta(raw: bytes, path: str) -> Iterator[tuple[dict, int]]:
    """THE frame walk — one copy of the framing invariants. Yields each
    record's msgpack dict (Arrow payload NOT decoded) and its end offset;
    stops cleanly at a torn tail (a partial final write is a crash
    artifact, not corruption), raises on mid-log CRC damage."""
    off = 0
    n = len(raw)
    while off < n:
        if off + _FRAME.size > n:
            return  # torn tail
        length, crc = _FRAME.unpack_from(raw, off)
        start = off + _FRAME.size
        end = start + length
        if end > n:
            return  # torn tail
        payload = raw[start:end]
        if zlib.crc32(payload) != crc:
            raise WalCorruption(f"{path}: CRC mismatch at offset {off}")
        yield msgpack.unpackb(payload, raw=False), end
        off = end


def _iter_frames(raw: bytes, path: str) -> Iterator[tuple[dict, pa.RecordBatch]]:
    for rec, _ in _iter_frame_meta(raw, path):
        with pa.ipc.open_stream(pa.BufferReader(rec["ipc"])) as r:
            yield rec, r.read_all().combine_chunks()


def _decode_records(raw: bytes, path: str) -> Iterator[tuple[int, pa.RecordBatch]]:
    for rec, batch in _iter_frames(raw, path):
        yield rec["seq"], batch


class LocalDiskWal(WalManager):
    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._locks: dict[int, threading.Lock] = {}
        self._guard = threading.Lock()
        self._files: dict[int, "io.BufferedWriter"] = {}

    def _lock(self, table_id: int) -> threading.Lock:
        with self._guard:
            return self._locks.setdefault(table_id, threading.Lock())

    def _log_path(self, table_id: int) -> str:
        return os.path.join(self.root, f"{table_id}.wal")

    def _flushed_path(self, table_id: int) -> str:
        return os.path.join(self.root, f"{table_id}.flushed")

    # ---- WalManager ------------------------------------------------------
    def append(self, table_id: int, seq: int, rows: RowGroup) -> None:
        record = _encode_record(seq, rows)
        with self._lock(table_id):
            f = self._files.get(table_id)
            if f is None:
                f = open(self._log_path(table_id), "ab")
                self._files[table_id] = f
            f.write(record)
            f.flush()
            os.fsync(f.fileno())

    def read_from(
        self, table_id: int, from_seq: int
    ) -> Iterator[tuple[int, pa.RecordBatch]]:
        path = self._log_path(table_id)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return
        flushed = self._read_flushed(table_id)
        for seq, batch in _decode_records(raw, path):
            if seq >= from_seq and seq > flushed:
                yield seq, batch

    def mark_flushed(self, table_id: int, seq: int) -> None:
        with self._lock(table_id):
            last = self._last_seq_locked(table_id)
            if last is not None and seq >= last:
                # Everything durable is flushed: drop the log entirely.
                f = self._files.pop(table_id, None)
                if f is not None:
                    f.close()
                try:
                    os.remove(self._log_path(table_id))
                except FileNotFoundError:
                    pass
                try:
                    os.remove(self._flushed_path(table_id))
                except FileNotFoundError:
                    pass
                return
            tmp = self._flushed_path(table_id) + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(seq))
            os.replace(tmp, self._flushed_path(table_id))

    def _read_flushed(self, table_id: int) -> int:
        try:
            with open(self._flushed_path(table_id)) as f:
                return int(f.read().strip() or 0)
        except FileNotFoundError:
            return 0

    def _last_seq_locked(self, table_id: int) -> Optional[int]:
        path = self._log_path(table_id)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        last = None
        try:
            for seq, _ in _decode_records(raw, path):
                last = seq
        except WalCorruption:
            pass
        return last

    def delete_table(self, table_id: int) -> None:
        with self._lock(table_id):
            f = self._files.pop(table_id, None)
            if f is not None:
                f.close()
            for p in (self._log_path(table_id), self._flushed_path(table_id)):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass

    def stats(self) -> dict:
        tables = {}
        for name in sorted(os.listdir(self.root)):
            if name.endswith(".wal"):
                tid = name[:-4]
                try:  # a concurrent flush/drop may remove the log mid-walk
                    size = os.path.getsize(os.path.join(self.root, name))
                except FileNotFoundError:
                    continue
                tables[tid] = {
                    "log_bytes": size,
                    "flushed_seq": self._read_flushed(int(tid)),
                }
        return {"backend": "LocalDiskWal", "root": self.root, "tables": tables}

    def close(self) -> None:
        with self._guard:
            for f in self._files.values():
                f.close()
            self._files.clear()


class ObjectStoreWal(WalManager):
    """WAL over the object-store interface — the second real backend
    proving the trait boundary (ref: the table-KV WAL keeps its log in a
    remote KV service, wal/src/table_kv_impl/namespace.rs; the TPU-build
    analog is a paged log in the same object store that holds the SSTs,
    so a diskless node recovers from shared storage alone).

    Layout: one immutable PAGE object per append group,

        wal/{table_id}/{first_seq:020d}-{last_seq:020d}.page

    using the same framed record encoding as the disk backend. Pages are
    never rewritten; truncation deletes whole pages whose last sequence is
    flushed, and a marker object records the flushed watermark.
    """

    def __init__(self, store, prefix: str = "wal") -> None:
        self.store = store
        self.prefix = prefix
        self._locks: dict[int, threading.Lock] = {}
        self._guard = threading.Lock()

    def _lock(self, table_id: int) -> threading.Lock:
        with self._guard:
            return self._locks.setdefault(table_id, threading.Lock())

    def _dir(self, table_id: int) -> str:
        return f"{self.prefix}/{table_id}/"

    def _flushed_path(self, table_id: int) -> str:
        return f"{self.prefix}/{table_id}/flushed"

    def _pages(self, table_id: int) -> list[tuple[int, int, str]]:
        """Sorted (first_seq, last_seq, path) for every page object."""
        out = []
        for path in self.store.list(self._dir(table_id)):
            name = path.rsplit("/", 1)[-1]
            if not name.endswith(".page"):
                continue
            first, _, last = name[: -len(".page")].partition("-")
            try:
                out.append((int(first), int(last), path))
            except ValueError:
                continue
        out.sort()
        return out

    # ---- WalManager ------------------------------------------------------
    def append(self, table_id: int, seq: int, rows: RowGroup) -> None:
        record = _encode_record(seq, rows)
        path = f"{self.prefix}/{table_id}/{seq:020d}-{seq:020d}.page"
        with self._lock(table_id):
            self.store.put(path, record)

    def read_from(
        self, table_id: int, from_seq: int
    ) -> Iterator[tuple[int, pa.RecordBatch]]:
        flushed = self._read_flushed(table_id)
        for first, last, path in self._pages(table_id):
            if last < from_seq or last <= flushed:
                continue
            raw = self.store.get(path)
            for seq, batch in _decode_records(raw, path):
                if seq >= from_seq and seq > flushed:
                    yield seq, batch

    def mark_flushed(self, table_id: int, seq: int) -> None:
        with self._lock(table_id):
            pages = self._pages(table_id)
            for first, last, path in pages:
                if last <= seq:
                    self.store.delete(path)
            if pages and all(last <= seq for _, last, _ in pages):
                # fully truncated: the marker may go too
                try:
                    self.store.delete(self._flushed_path(table_id))
                except FileNotFoundError:
                    pass
                return
            self.store.put(self._flushed_path(table_id), str(seq).encode())

    def _read_flushed(self, table_id: int) -> int:
        try:
            return int(self.store.get(self._flushed_path(table_id)).decode() or 0)
        except FileNotFoundError:
            return 0

    def delete_table(self, table_id: int) -> None:
        with self._lock(table_id):
            for path in list(self.store.list(self._dir(table_id))):
                try:
                    self.store.delete(path)
                except FileNotFoundError:
                    pass

    def stats(self) -> dict:
        tables: dict = {}
        plen = len(self.prefix) + 1  # table id is the segment AFTER prefix
        for path in self.store.list(self.prefix + "/"):
            if not path.endswith(".page"):
                continue
            rel = path[plen:]
            tid = rel.split("/", 1)[0]
            entry = tables.setdefault(tid, {"pages": 0})
            entry["pages"] += 1
        return {"backend": "ObjectStoreWal", "prefix": self.prefix, "tables": tables}


class SharedLogWal(WalManager):
    """Region-based shared log — ONE segmented log per region multiplexes
    every table of that region (shard), the reference's message-queue WAL
    layout with RegionBased replay (ref: wal/src/message_queue_impl/
    region.rs — one Kafka topic partition per region; wal_replayer.rs:156
    — RegionBased mode scans a shard's log once and dispatches records to
    tables, instead of one scan per table).

    Layout under ``root``::

        region_{rid}/{first_record_index:020d}.seg   append-only segments
        region_{rid}/meta                            msgpack {flushed: {tid: seq},
                                                     deleted: [tid]}

    Frames reuse the disk codec but the payload carries ``table_id``.
    Segments rotate at ``segment_bytes``; a segment is deleted once EVERY
    record in it is flushed (per-table watermarks) or its table dropped.

    ``region_of`` maps table_id -> region id (the shard mapping in
    cluster mode; a single shared region by default — standalone's
    "whole node is one shard").

    Recovery: ``read_from`` serves per-table replay from a one-scan
    region cache, so opening all tables of a shard decodes the log ONCE
    (the RegionBased win) while keeping the per-table WalManager API.
    """

    def __init__(self, root: str, region_of=None, segment_bytes: int = 8 << 20) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.region_of = region_of or (lambda table_id: 0)
        self.segment_bytes = segment_bytes
        self._guard = threading.Lock()
        self._regions: dict[int, _SharedRegion] = {}

    def _region(self, rid: int) -> "_SharedRegion":
        with self._guard:
            reg = self._regions.get(rid)
            if reg is None:
                reg = _SharedRegion(
                    os.path.join(self.root, f"region_{rid}"), self.segment_bytes
                )
                self._regions[rid] = reg
            return reg

    # ---- WalManager ------------------------------------------------------
    def append(self, table_id: int, seq: int, rows: RowGroup) -> None:
        self._region(self.region_of(table_id)).append(table_id, seq, rows)

    def read_from(
        self, table_id: int, from_seq: int
    ) -> Iterator[tuple[int, pa.RecordBatch]]:
        yield from self._region(self.region_of(table_id)).read_from(table_id, from_seq)

    def replay_region(
        self, rid: int
    ) -> Iterator[tuple[int, int, pa.RecordBatch]]:
        """(table_id, seq, batch) for every unflushed record of a region,
        in append order — the bulk shard-open path."""
        yield from self._region(rid).scan()

    def mark_flushed(self, table_id: int, seq: int) -> None:
        self._region(self.region_of(table_id)).mark_flushed(table_id, seq)

    def delete_table(self, table_id: int) -> None:
        self._region(self.region_of(table_id)).delete_table(table_id)

    def stats(self) -> dict:
        regions = {}
        for name in sorted(os.listdir(self.root)):
            if not name.startswith("region_"):
                continue
            seg_dir = os.path.join(self.root, name)
            segs = [f for f in os.listdir(seg_dir) if f.endswith(".seg")]
            total = 0
            alive = 0
            for f in segs:
                try:  # a concurrent truncation may remove segments mid-walk
                    total += os.path.getsize(os.path.join(seg_dir, f))
                    alive += 1
                except FileNotFoundError:
                    continue
            regions[name[len("region_"):]] = {
                "segments": alive,
                "log_bytes": total,
            }
        return {"backend": "SharedLogWal", "root": self.root, "regions": regions}

    def close(self) -> None:
        with self._guard:
            for reg in self._regions.values():
                reg.close()
            self._regions.clear()


def _encode_region_record(table_id: int, seq: int, rows: RowGroup) -> bytes:
    return _encode_record(seq, rows, table_id=table_id)


def _decode_region_records(
    raw: bytes, path: str
) -> Iterator[tuple[int, int, pa.RecordBatch]]:
    for rec, batch in _iter_frames(raw, path):
        yield rec["tid"], rec["seq"], batch


def _valid_prefix_len(raw: bytes, path: str) -> int:
    """Byte length of the valid frame prefix (where a torn tail starts)."""
    end = 0
    for _, end in _iter_frame_meta(raw, path):
        pass
    return end


class _SharedRegion:
    """One region's segmented log + per-table flushed watermarks."""

    def __init__(self, path: str, segment_bytes: int) -> None:
        self.path = path
        self.segment_bytes = segment_bytes
        os.makedirs(self.path, exist_ok=True)
        self._lock = threading.Lock()
        self._active: Optional["io.BufferedWriter"] = None
        self._active_path: Optional[str] = None
        self._meta = self._load_meta()
        # segment path -> {table_id: max_seq} (for truncation checks)
        self._seg_index: dict[str, dict[int, int]] = {}
        # one-scan replay cache: (version, {table_id: [(seq, batch)]})
        self._replay_cache: Optional[tuple[int, dict]] = None
        self._version = 0
        # Rotation always opens a FRESH name strictly above every existing
        # segment — appending into a crash-torn segment would bury the torn
        # frame mid-file and poison every later replay.
        segs = self._segments()
        self._next_seg_idx = (
            max(int(name[: -len(".seg")]) for name in segs) + 1 if segs else 0
        )
        if segs:
            # A torn tail in the LAST segment is a crash artifact: cut it
            # off now so the valid prefix stays replayable forever.
            last = os.path.join(self.path, segs[-1])
            with open(last, "rb") as f:
                raw = f.read()
            valid = _valid_prefix_len(raw, last)
            if valid < len(raw):
                with open(last, "ab") as f:
                    f.truncate(valid)

    # ---- meta (flushed watermarks + deleted tables) ---------------------
    def _meta_path(self) -> str:
        return os.path.join(self.path, "meta")

    def _load_meta(self) -> dict:
        try:
            with open(self._meta_path(), "rb") as f:
                m = msgpack.unpackb(f.read(), raw=False, strict_map_key=False)
                return {
                    "flushed": {int(k): int(v) for k, v in m.get("flushed", {}).items()},
                    "deleted": set(m.get("deleted", [])),
                }
        except FileNotFoundError:
            return {"flushed": {}, "deleted": set()}

    def _store_meta_locked(self) -> None:
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "wb") as f:
            f.write(
                msgpack.packb(
                    {
                        "flushed": self._meta["flushed"],
                        "deleted": sorted(self._meta["deleted"]),
                    },
                    use_bin_type=True,
                )
            )
        os.replace(tmp, self._meta_path())

    def _segments(self) -> list[str]:
        return sorted(f for f in os.listdir(self.path) if f.endswith(".seg"))

    # ---- log ------------------------------------------------------------
    def append(self, table_id: int, seq: int, rows: RowGroup) -> None:
        record = _encode_region_record(table_id, seq, rows)
        with self._lock:
            if table_id in self._meta["deleted"]:
                # Catalog table ids are monotonic and never reused; an
                # append after delete_table is a caller bug, and silently
                # accepting it would resurrect the dead incarnation's
                # records on replay.
                raise ValueError(f"table {table_id} was deleted from this WAL region")
            f = self._active
            if f is None or f.tell() + len(record) > self.segment_bytes:
                self._rotate_locked()
                f = self._active
            f.write(record)
            f.flush()
            os.fsync(f.fileno())
            self._seg_index.setdefault(self._active_path, {})[table_id] = seq
            self._version += 1
            self._replay_cache = None

    def _rotate_locked(self) -> None:
        if self._active is not None:
            self._active.close()
        name = f"{self._next_seg_idx:020d}.seg"
        self._next_seg_idx += 1
        self._active_path = os.path.join(self.path, name)
        self._active = open(self._active_path, "ab")

    def _seg_table_seqs(self, seg_path: str) -> dict[int, int]:
        """{table_id: max_seq} for a segment (cached; scans once)."""
        idx = self._seg_index.get(seg_path)
        if idx is None:
            idx = {}
            try:
                with open(seg_path, "rb") as f:
                    raw = f.read()
                # meta-only walk: {tid: max_seq} without Arrow-decoding
                # every batch (a reopen's first truncation check would
                # otherwise re-decode the whole region log)
                for rec, _ in _iter_frame_meta(raw, seg_path):
                    tid = rec["tid"]
                    idx[tid] = max(idx.get(tid, -1), rec["seq"])
            except FileNotFoundError:
                pass
            self._seg_index[seg_path] = idx
        return idx

    def scan(self) -> Iterator[tuple[int, int, pa.RecordBatch]]:
        """All unflushed records, append order, across segments."""
        with self._lock:
            segs = self._segments()
            flushed = dict(self._meta["flushed"])
            deleted = set(self._meta["deleted"])
        for name in segs:
            seg_path = os.path.join(self.path, name)
            try:
                with open(seg_path, "rb") as f:
                    raw = f.read()
            except FileNotFoundError:
                continue  # truncated concurrently
            for tid, seq, batch in _decode_region_records(raw, seg_path):
                if tid in deleted or seq <= flushed.get(tid, 0):
                    continue
                yield tid, seq, batch

    def read_from(
        self, table_id: int, from_seq: int
    ) -> Iterator[tuple[int, pa.RecordBatch]]:
        # Serve from the one-scan replay cache: opening every table of a
        # shard after a crash decodes the region log once, not T times.
        with self._lock:
            cache = self._replay_cache
            version = self._version
        if cache is None or cache[0] != version:
            by_table: dict[int, list] = {}
            for tid, seq, batch in self.scan():
                by_table.setdefault(tid, []).append((seq, batch))
            cache = (version, by_table)
            with self._lock:
                if self._version == version:
                    self._replay_cache = cache
        for seq, batch in cache[1].get(table_id, []):
            if seq >= from_seq:
                yield seq, batch

    def mark_flushed(self, table_id: int, seq: int) -> None:
        with self._lock:
            if seq <= self._meta["flushed"].get(table_id, 0):
                return
            self._meta["flushed"][table_id] = seq
            self._store_meta_locked()
            self._truncate_locked()
            self._version += 1
            self._replay_cache = None

    def delete_table(self, table_id: int) -> None:
        with self._lock:
            self._meta["deleted"].add(table_id)
            self._meta["flushed"].pop(table_id, None)
            self._store_meta_locked()
            self._truncate_locked()
            self._version += 1
            self._replay_cache = None

    def _truncate_locked(self) -> None:
        """Drop segments where every record is flushed or its table dropped."""
        flushed = self._meta["flushed"]
        deleted = self._meta["deleted"]
        for name in self._segments():
            seg_path = os.path.join(self.path, name)
            idx = self._seg_table_seqs(seg_path)
            done = all(
                tid in deleted or max_seq <= flushed.get(tid, 0)
                for tid, max_seq in idx.items()
            )
            if not done:
                continue
            if seg_path == self._active_path:
                self._active.close()
                self._active = None
                self._active_path = None
            os.remove(seg_path)
            self._seg_index.pop(seg_path, None)

    def close(self) -> None:
        with self._lock:
            if self._active is not None:
                self._active.close()
                self._active = None


class NoopWal(WalManager):
    """``DoNothing`` analog (ref: wal/src/dummy.rs) — explicit no-durability."""

    def append(self, table_id: int, seq: int, rows: RowGroup) -> None:
        pass

    def read_from(self, table_id: int, from_seq: int):
        return iter(())

    def mark_flushed(self, table_id: int, seq: int) -> None:
        pass

    def delete_table(self, table_id: int) -> None:
        pass
