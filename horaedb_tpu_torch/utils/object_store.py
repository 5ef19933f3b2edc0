"""Object store abstraction (ref: src/components/object_store).

The reference re-exports the Rust ``object_store`` crate and layers caches on
top (mem_cache.rs, disk_cache.rs). Here the trait is a small ABC with the
operations the engine actually needs — whole/range reads, atomic-ish puts,
listing, delete — with three impls:

- ``MemoryStore``      — tests / ephemeral
- ``LocalDiskStore``   — standalone deployments (write-to-temp + rename)
- ``MemCacheStore``    — sharded-LRU read-through page cache wrapper
                         (ref: mem_cache.rs partitioned LRU)

S3/OSS-style remote backends slot in behind the same ABC in a later round
(zero-egress image: nothing to talk to here).
"""

from __future__ import annotations

import os
import threading
from abc import ABC, abstractmethod
from collections import OrderedDict
from typing import Iterator, Optional, Sequence


class ObjectStore(ABC):
    @abstractmethod
    def put(self, path: str, data: bytes) -> None: ...

    @abstractmethod
    def get(self, path: str) -> bytes: ...

    @abstractmethod
    def get_range(self, path: str, start: int, end: int) -> bytes:
        """Bytes in [start, end) — the SST reader's footer/page reads."""

    @abstractmethod
    def head(self, path: str) -> int:
        """Size in bytes; raises FileNotFoundError if absent."""

    @abstractmethod
    def delete(self, path: str) -> None: ...

    @abstractmethod
    def list(self, prefix: str = "") -> Iterator[str]: ...

    def prefetch(self, paths: Sequence[str]) -> None:
        """Hint: these objects will be read soon — start pulling them into
        whatever cache this store has, in the background, without blocking
        the caller. Default: no cache, nothing to do (the prefetchable-
        stream analog, ref: analytic_engine/src/prefetchable_stream.rs +
        num_streams_to_prefetch, lib.rs:109)."""

    def exists(self, path: str) -> bool:
        try:
            self.head(path)
            return True
        except FileNotFoundError:
            return False


class MemoryStore(ObjectStore):
    def __init__(self) -> None:
        self._objects: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, path: str, data: bytes) -> None:
        with self._lock:
            self._objects[path] = bytes(data)

    def get(self, path: str) -> bytes:
        try:
            return self._objects[path]
        except KeyError:
            raise FileNotFoundError(path) from None

    def get_range(self, path: str, start: int, end: int) -> bytes:
        return self.get(path)[start:end]

    def head(self, path: str) -> int:
        return len(self.get(path))

    def delete(self, path: str) -> None:
        with self._lock:
            self._objects.pop(path, None)

    def list(self, prefix: str = "") -> Iterator[str]:
        with self._lock:
            keys = sorted(self._objects)
        return iter([k for k in keys if k.startswith(prefix)])


class LocalDiskStore(ObjectStore):
    """Filesystem-backed store; puts are atomic via temp-file + rename."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _abs(self, path: str) -> str:
        p = os.path.normpath(os.path.join(self.root, path))
        if not p.startswith(self.root):
            raise ValueError(f"path escapes store root: {path!r}")
        return p

    def put(self, path: str, data: bytes) -> None:
        dst = self._abs(path)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = dst + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dst)

    def get(self, path: str) -> bytes:
        with open(self._abs(path), "rb") as f:
            return f.read()

    def get_range(self, path: str, start: int, end: int) -> bytes:
        with open(self._abs(path), "rb") as f:
            f.seek(start)
            return f.read(end - start)

    def head(self, path: str) -> int:
        return os.path.getsize(self._abs(path))

    def delete(self, path: str) -> None:
        try:
            os.remove(self._abs(path))
        except FileNotFoundError:
            pass

    def list(self, prefix: str = "") -> Iterator[str]:
        # Start the walk at the deepest directory the prefix pins down —
        # a per-table prefix must not traverse the whole store.
        base_rel = prefix if prefix.endswith("/") else os.path.dirname(prefix)
        start = os.path.join(self.root, base_rel.rstrip("/")) if base_rel else self.root
        if not os.path.isdir(start):
            return iter([])
        out = []
        for dirpath, _dirs, files in os.walk(start):
            for name in files:
                if name.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return iter(sorted(out))

    def local_path(self, path: str) -> str:
        """Direct filesystem path — lets pyarrow mmap SSTs instead of
        round-tripping bytes through Python."""
        return self._abs(path)


class DiskCacheStore(ObjectStore):
    """Paged on-disk read cache over a (remote) store
    (ref: components/object_store/src/disk_cache.rs — page-granular
    caching with CRC integrity, LRU eviction, and request dedup so a cold
    page is fetched once even under concurrent readers).

    ``get_range`` reads fetch whole aligned PAGES from the inner store and
    serve slices from disk afterwards; ``get`` caches the whole object as
    its pages. Each cache file is ``[u32 crc][payload]`` — a torn or
    corrupted page re-fetches instead of serving garbage.
    """

    def __init__(
        self,
        inner: ObjectStore,
        cache_dir: str,
        capacity_bytes: int = 1 << 30,
        page_size: int = 1 << 20,
    ) -> None:
        import zlib

        self._zlib = zlib
        self.inner = inner
        self.cache_dir = os.path.abspath(cache_dir)
        os.makedirs(self.cache_dir, exist_ok=True)
        self.page_size = page_size
        self.capacity_bytes = capacity_bytes
        self._lock = threading.Lock()
        self._lru: "OrderedDict[str, int]" = OrderedDict()  # cache file -> bytes
        self._bytes = 0
        self._inflight: dict[str, threading.Event] = {}
        # object sizes cached too: a warm read must not pay a remote HEAD
        self._sizes: dict[str, int] = {}
        # lazy pools: most stores never see a cold multi-page read
        self._pool = None
        self._bg_pool = None
        self.hits = 0
        self.misses = 0
        # /metrics visibility: prefetch effectiveness is invisible from
        # timings alone (a useless prefetch just wastes inner-store IO).
        from .metrics import REGISTRY

        self._m_hits = REGISTRY.counter(
            "horaedb_object_store_page_cache_hits_total",
            "disk page cache hits (all DiskCacheStore instances)",
        )
        self._m_misses = REGISTRY.counter(
            "horaedb_object_store_page_cache_misses_total",
            "disk page cache misses (cold fetches from the inner store)",
        )
        self._m_prefetch = REGISTRY.counter(
            "horaedb_object_store_prefetch_objects_total",
            "objects queued for background prefetch",
        )
        self._load_index()

    # ---- index -----------------------------------------------------------
    def _load_index(self) -> None:
        for name in sorted(os.listdir(self.cache_dir)):
            p = os.path.join(self.cache_dir, name)
            if name.endswith(".tmp"):
                # torn write from a crash mid-_write_cached: reclaim now
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
                continue
            if os.path.isfile(p):
                size = os.path.getsize(p)
                self._lru[name] = size
                self._bytes += size

    def _cache_name(self, path: str, page: int) -> str:
        import hashlib

        digest = hashlib.sha256(path.encode()).hexdigest()[:24]
        return f"{digest}.{page:06d}"

    # ---- page IO ---------------------------------------------------------
    def _read_cached(self, name: str) -> Optional[bytes]:
        p = os.path.join(self.cache_dir, name)
        try:
            with open(p, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        if len(raw) < 4:
            return None
        crc = int.from_bytes(raw[:4], "little")
        payload = raw[4:]
        if self._zlib.crc32(payload) & 0xFFFFFFFF != crc:
            # torn/corrupt page: drop it, caller re-fetches
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
            with self._lock:
                size = self._lru.pop(name, 0)
                self._bytes -= size
            return None
        with self._lock:
            if name in self._lru:
                self._lru.move_to_end(name)
        return payload

    def _write_cached(self, name: str, payload: bytes) -> None:
        p = os.path.join(self.cache_dir, name)
        tmp = p + ".tmp"
        crc = (self._zlib.crc32(payload) & 0xFFFFFFFF).to_bytes(4, "little")
        with open(tmp, "wb") as f:
            f.write(crc + payload)
        os.replace(tmp, p)
        size = len(payload) + 4
        evict = []
        with self._lock:
            self._lru[name] = size
            self._lru.move_to_end(name)
            self._bytes += size
            while self._bytes > self.capacity_bytes and len(self._lru) > 1:
                evicted, esize = self._lru.popitem(last=False)
                self._bytes -= esize
                evict.append(evicted)
        for name_ in evict:
            try:
                os.remove(os.path.join(self.cache_dir, name_))
            except FileNotFoundError:
                pass

    def _fetch_page(self, path: str, page: int, obj_size: int) -> bytes:
        """One page, cached; concurrent requests for a cold page dedup.

        Followers wait on the current leader's event and retry the cache;
        a follower whose leader failed loops back and may become the NEXT
        leader — it never touches an event it didn't register."""
        name = self._cache_name(path, page)
        while True:
            cached = self._read_cached(name)
            if cached is not None:
                self.hits += 1
                self._m_hits.inc()
                return cached
            with self._lock:
                ev = self._inflight.get(name)
                if ev is None:
                    my_event = threading.Event()
                    self._inflight[name] = my_event
                    break  # we are the leader
            # follower wait caps at min(op_cap, remaining budget): a
            # query out of time observes it at the next checkpoint
            # instead of riding a slow leader fetch to the 60s bound
            from .deadline import cap_timeout, checkpoint

            ev.wait(timeout=cap_timeout(60))
            checkpoint("store")
        try:
            # Double-check as leader: our first cache miss may predate a
            # previous leader's write (we raced past its event) — a
            # redundant remote fetch is wasted inner-store traffic.
            cached = self._read_cached(name)
            if cached is not None:
                self.hits += 1
                self._m_hits.inc()
                return cached
            self.misses += 1
            self._m_misses.inc()
            start = page * self.page_size
            end = min(start + self.page_size, obj_size)
            payload = self.inner.get_range(path, start, end)
            self._write_cached(name, payload)
            return payload
        finally:
            with self._lock:
                if self._inflight.get(name) is my_event:
                    del self._inflight[name]
            my_event.set()

    # ---- ObjectStore -----------------------------------------------------
    def _fetch_pool(self, background: bool = False):
        """Store-OWNED pools for cold-page fan-out. Deliberately not the
        shared io_pool: get_range is often called FROM io_pool tasks
        (scan_sources overlaps SST reads there), and a bounded pool whose
        tasks submit to itself and wait deadlocks. Nothing running on
        these pools ever re-enters them — page fetches call
        ``inner.get_range`` directly.

        TWO pools, not one: prefetch() queues whole-object pulls on the
        BACKGROUND pool only, so a foreground read's cold pages never
        wait behind the hint backlog (the priority inversion a shared
        FIFO queue would reintroduce). The inflight leader/follower
        protocol dedups fetches across both pools."""
        with self._lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                from .env import env_int

                n = env_int("HORAEDB_CACHE_FETCH_THREADS", 8)
                self._pool = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix="diskcache-fetch",
                )
                self._bg_pool = ThreadPoolExecutor(
                    max_workers=max(1, n // 2),
                    thread_name_prefix="diskcache-prefetch",
                )
            return self._bg_pool if background else self._pool

    def get_range(self, path: str, start: int, end: int) -> bytes:
        size = self.head(path)
        end = min(end, size)
        if start >= end:
            return b""
        first, last = start // self.page_size, (end - 1) // self.page_size
        pages = range(first, last + 1)
        # Warm pages are served INLINE from disk — never through the
        # fetch pool, whose FIFO queue may hold a backlog of whole-object
        # prefetch pulls that a foreground read must not wait behind.
        byp: dict[int, bytes] = {}
        cold: list[int] = []
        for pg in pages:
            cached = self._read_cached(self._cache_name(path, pg))
            if cached is not None:
                self.hits += 1
                self._m_hits.inc()
                byp[pg] = cached
            else:
                cold.append(pg)
        if len(cold) > 1:
            # Cold pages fan out: a 64MB object at 1MB pages would
            # otherwise serialize 64 round trips to the inner store
            # (first-read prefetch pipeline); the inflight leader/follower
            # protocol dedups against concurrent readers and prefetchers.
            for pg, payload in zip(
                cold,
                self._fetch_pool().map(
                    lambda p: self._fetch_page(path, p, size), cold
                ),
            ):
                byp[pg] = payload
        else:
            for pg in cold:
                byp[pg] = self._fetch_page(path, pg, size)
        blob = b"".join(byp[pg] for pg in pages)
        base = first * self.page_size
        return blob[start - base : end - base]

    def get(self, path: str) -> bytes:
        return self.get_range(path, 0, self.head(path))

    def prefetch(self, paths: Sequence[str]) -> None:
        """Queue background whole-object pulls into the page cache; the
        decode loop that follows finds pages warm instead of paying one
        round trip per page. Bounded by the fetch pool's worker count and
        the cache's LRU capacity; failures are swallowed (a prefetch is a
        hint, the read path re-fetches on miss)."""

        def pull(path: str) -> None:
            try:
                size = self.head(path)
                for page in range((size + self.page_size - 1) // self.page_size):
                    self._fetch_page(path, page, size)
            except Exception:
                pass

        self._m_prefetch.inc(len(paths))
        for p in paths:
            self._fetch_pool(background=True).submit(pull, p)

    def head(self, path: str) -> int:
        with self._lock:
            size = self._sizes.get(path)
        if size is not None:
            return size
        size = self.inner.head(path)
        with self._lock:
            self._sizes[path] = size
        return size

    def put(self, path: str, data: bytes) -> None:
        self.inner.put(path, data)
        self._invalidate(path)

    def delete(self, path: str) -> None:
        self.inner.delete(path)
        self._invalidate(path)

    def _invalidate(self, path: str) -> None:
        import hashlib

        digest = hashlib.sha256(path.encode()).hexdigest()[:24]
        with self._lock:
            self._sizes.pop(path, None)
            stale = [n for n in self._lru if n.startswith(digest + ".")]
            for n in stale:
                self._bytes -= self._lru.pop(n)
        for n in stale:
            try:
                os.remove(os.path.join(self.cache_dir, n))
            except FileNotFoundError:
                pass

    def list(self, prefix: str = "") -> Iterator[str]:
        return self.inner.list(prefix)


class InjectedFaultError(OSError):
    """A fault the FaultInjectingStore raised on purpose — typed so test
    assertions can tell injected chaos from real store failures."""


class FaultInjectingStore(ObjectStore):
    """Deterministic fault-injection wrapper over any store — the shared
    chaos layer for bench (ingest A/B), chipbench, and the tenant-scale
    production simulator (tools/tenantsim), promoted from bench.py's
    ad-hoc latency-injected SST store.

    Injection points:

    - ``put_latency_s``   — synthetic upload delay per matching put (the
      remote-store shape the pipelined flush exists for)
    - ``get_latency_s``   — synthetic fetch delay per matching get/range
    - ``error_rate``      — probability in [0, 1] that a matching op
      raises ``InjectedFaultError`` (an OSError: the engine's retry/
      backoff paths see exactly what a flaky store would produce)
    - ``suffix``          — only paths ending with it are injected
      (default ``".sst"``: manifest/WAL appends stay fast — the point is
      the data-object cost); ``""`` injects everything

    All knobs are plain attributes, adjustable mid-run under ``_lock``
    (the simulator's fault schedule flips them live). The RNG is seeded
    (``seed``) so a failing schedule replays identically. ``head``/
    ``list``/``delete`` are never injected: they back bookkeeping the
    engine must not lose, and the interesting failure shapes are data
    reads/writes. ``local_path`` (mmap fast path) intentionally does NOT
    pass through: a wrapped store must not let readers bypass injection.
    """

    def __init__(
        self,
        inner: ObjectStore,
        put_latency_s: float = 0.0,
        get_latency_s: float = 0.0,
        error_rate: float = 0.0,
        seed: int = 0,
        suffix: str = ".sst",
    ) -> None:
        import random

        self.inner = inner
        self.put_latency_s = float(put_latency_s)
        self.get_latency_s = float(get_latency_s)
        self.error_rate = float(error_rate)
        self.suffix = suffix
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected_errors = 0
        self.delayed_ops = 0
        # /metrics visibility: the simulator's SLO objectives and alert
        # rules observe the chaos through the DATABASE's own telemetry
        # (rate over the samples history), not harness-side bookkeeping
        from .metrics import REGISTRY

        self._m_errors = REGISTRY.counter(
            "horaedb_object_store_injected_faults_total",
            "operations failed on purpose by FaultInjectingStore",
        )
        self._m_delays = REGISTRY.counter(
            "horaedb_object_store_injected_delays_total",
            "operations delayed on purpose by FaultInjectingStore",
        )

    def _maybe_inject(self, path: str, latency_s: float, op: str) -> None:
        if self.suffix and not path.endswith(self.suffix):
            return
        with self._lock:
            rate = self.error_rate
            fail = rate > 0 and self._rng.random() < rate
            if fail:
                self.injected_errors += 1
                self._m_errors.inc()
            elif latency_s > 0:
                self.delayed_ops += 1
                self._m_delays.inc()
        if fail:
            raise InjectedFaultError(f"injected {op} fault: {path}")
        if latency_s > 0:
            import time

            time.sleep(latency_s)

    def put(self, path: str, data: bytes) -> None:
        self._maybe_inject(path, self.put_latency_s, "put")
        self.inner.put(path, data)

    def get(self, path: str) -> bytes:
        self._maybe_inject(path, self.get_latency_s, "get")
        return self.inner.get(path)

    def get_range(self, path: str, start: int, end: int) -> bytes:
        self._maybe_inject(path, self.get_latency_s, "get_range")
        return self.inner.get_range(path, start, end)

    def head(self, path: str) -> int:
        return self.inner.head(path)

    def delete(self, path: str) -> None:
        self.inner.delete(path)

    def list(self, prefix: str = "") -> Iterator[str]:
        return self.inner.list(prefix)

    def prefetch(self, paths: Sequence[str]) -> None:
        self.inner.prefetch(paths)

    def __getattr__(self, name: str):
        # Forward everything else to the inner store (``root`` places the
        # state files — rules_state.json / wlm_state.json — so hiding it
        # would silently disable persistence on wrapped nodes). EXCEPT
        # ``local_path``: the mmap fast path would let readers bypass
        # injection entirely.
        if name == "local_path":
            raise AttributeError(
                "FaultInjectingStore hides local_path (mmap would bypass "
                "fault injection)"
            )
        inner = self.__dict__.get("inner")
        if inner is None:  # mid-__init__ lookup: nothing to forward yet
            raise AttributeError(name)
        return getattr(inner, name)


class MemCacheStore(ObjectStore):
    """Read-through whole-object LRU cache over another store.

    Sharded like the reference's partitioned LRU (mem_cache.rs:64-158) to
    keep lock contention off the scan path.
    """

    SHARDS = 16

    def __init__(self, inner: ObjectStore, capacity_bytes: int) -> None:
        self.inner = inner
        self._shard_cap = max(1, capacity_bytes // self.SHARDS)
        self._shards = [OrderedDict() for _ in range(self.SHARDS)]
        self._sizes = [0] * self.SHARDS
        self._locks = [threading.Lock() for _ in range(self.SHARDS)]
        self.hits = 0
        self.misses = 0

    def _shard(self, path: str) -> int:
        return hash(path) % self.SHARDS

    def get(self, path: str) -> bytes:
        i = self._shard(path)
        with self._locks[i]:
            cached = self._shards[i].get(path)
            if cached is not None:
                self._shards[i].move_to_end(path)
                self.hits += 1
                return cached
        self.misses += 1
        data = self.inner.get(path)
        with self._locks[i]:
            if path not in self._shards[i]:
                self._shards[i][path] = data
                self._sizes[i] += len(data)
                while self._sizes[i] > self._shard_cap and len(self._shards[i]) > 1:
                    _, evicted = self._shards[i].popitem(last=False)
                    self._sizes[i] -= len(evicted)
        return data

    def get_range(self, path: str, start: int, end: int) -> bytes:
        return self.get(path)[start:end]

    def put(self, path: str, data: bytes) -> None:
        self.inner.put(path, data)
        self._invalidate(path)

    def delete(self, path: str) -> None:
        self.inner.delete(path)
        self._invalidate(path)

    def _invalidate(self, path: str) -> None:
        i = self._shard(path)
        with self._locks[i]:
            old = self._shards[i].pop(path, None)
            if old is not None:
                self._sizes[i] -= len(old)

    def head(self, path: str) -> int:
        return self.inner.head(path)

    def prefetch(self, paths: Sequence[str]) -> None:
        # Forward to the inner (disk) cache: pulling whole objects into
        # THIS cache on a hint could evict the working set from RAM; the
        # page cache below is disk-backed and LRU-bounded.
        self.inner.prefetch(paths)

    def list(self, prefix: str = "") -> Iterator[str]:
        return self.inner.list(prefix)
