"""SST level management (ref: analytic_engine/src/sst/manager.rs, file.rs).

Exactly two levels, like the reference (file.rs:66-69):

- L0: freshly flushed, time-bucketed but *overlapping* sorted runs;
- L1: compacted, non-overlapping within a time window.

``LevelsController`` owns file handles per level, answers time-range picks
for reads, collects TTL-expired files, and queues removed files for purge.

Purge safety (ref: the reference's ref-counted FileHandles + FilePurger,
sst/file.rs:64-113): a removed file may still be held by an in-flight read
whose ReadView predates the removal. Removals are stamped with an epoch;
reads pin the epoch they started at; ``drain_purge_queue`` only releases
files removed strictly before every active read began.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

from ...common_types.time_range import TimeRange
from .meta import SstMeta

MAX_LEVEL = 1  # levels are 0 and 1


@dataclass(frozen=True)
class FileHandle:
    meta: SstMeta
    path: str
    level: int

    @property
    def file_id(self) -> int:
        return self.meta.file_id

    @property
    def time_range(self) -> TimeRange:
        return self.meta.time_range


class LevelsController:
    def __init__(self) -> None:
        self._levels: list[dict[int, FileHandle]] = [{} for _ in range(MAX_LEVEL + 1)]
        self._purge_queue: list[tuple[int, FileHandle]] = []  # (removal epoch, handle)
        self._epoch = 0
        self._active_reads: dict[int, int] = {}  # start epoch -> count
        self._lock = threading.RLock()

    # ---- read pinning --------------------------------------------------
    @contextlib.contextmanager
    def read_pin(self):
        """Pin the current epoch for the duration of a read.

        Files removed at or after the pinned epoch stay on disk until the
        pin is released (a ReadView picked before a concurrent compaction's
        version swap must still find its SSTs)."""
        with self._lock:
            epoch = self._epoch
            self._active_reads[epoch] = self._active_reads.get(epoch, 0) + 1
        try:
            yield
        finally:
            with self._lock:
                n = self._active_reads[epoch] - 1
                if n:
                    self._active_reads[epoch] = n
                else:
                    del self._active_reads[epoch]

    # ---- mutation ------------------------------------------------------
    def add_file(self, level: int, handle: FileHandle) -> None:
        if not (0 <= level <= MAX_LEVEL):
            raise ValueError(f"invalid level {level}")
        with self._lock:
            self._levels[level][handle.file_id] = handle

    def swap_files(
        self,
        adds: list[tuple[int, FileHandle]],
        removes: list[tuple[int, int]],
    ) -> None:
        """Install compaction outputs and retire inputs in ONE lock
        acquisition: a concurrent read-view pick sees either the
        pre-compaction or the post-compaction file set, never both.
        APPEND-mode reads skip dedup, so a torn view (output installed,
        inputs not yet removed) would double every merged row."""
        with self._lock:
            for level, handle in adds:
                self.add_file(level, handle)
            by_level: dict[int, list[int]] = {}
            for level, fid in removes:
                by_level.setdefault(level, []).append(fid)
            for level, fids in by_level.items():
                self.remove_files(level, fids)

    def remove_files(self, level: int, file_ids: list[int]) -> None:
        with self._lock:
            stamped = False
            for fid in file_ids:
                h = self._levels[level].pop(fid, None)
                if h is not None:
                    self._purge_queue.append((self._epoch, h))
                    stamped = True
            if stamped:
                # Reads starting after the removal can't see these files,
                # so a later epoch means "safe once current pins drain".
                self._epoch += 1

    def pending_purge_paths(self) -> set[str]:
        """Paths queued for purge but not yet released — still REFERENCED
        (a pinned read may hold them); the orphan sweep must not treat
        them as untracked garbage."""
        with self._lock:
            return {h.path for _, h in self._purge_queue}

    def drain_purge_queue(self) -> list[FileHandle]:
        """Handles that are provably unreachable by any in-flight read."""
        with self._lock:
            # Stamps are always < the post-removal epoch, so with no pins
            # everything drains; with pins, only pre-pin removals do.
            min_active = min(self._active_reads, default=self._epoch)
            out = [h for e, h in self._purge_queue if e < min_active]
            self._purge_queue = [(e, h) for e, h in self._purge_queue if e >= min_active]
            return out

    # ---- queries -------------------------------------------------------
    def files_at(self, level: int) -> list[FileHandle]:
        with self._lock:
            return sorted(
                self._levels[level].values(),
                key=lambda h: (h.time_range.inclusive_start, h.file_id),
            )

    def all_files(self) -> list[FileHandle]:
        # One lock acquisition for the WHOLE walk — per-level locking
        # would let a concurrent swap_files land between levels and show
        # a read view containing both a merge's inputs and its output.
        with self._lock:
            return [h for lvl in range(MAX_LEVEL + 1) for h in self.files_at(lvl)]

    def pick_overlapping(self, time_range: TimeRange) -> list[FileHandle]:
        """Read view: every SST whose range overlaps, L0 first (newer data).

        L0 runs may overlap each other; L1 runs don't. The merge path uses
        `meta.max_sequence` for conflict resolution, so order here is only
        a grouping convenience.
        """
        return [h for h in self.all_files() if h.time_range.overlaps(time_range)]

    def expired_files(self, now_ms: int, ttl_ms: int) -> list[FileHandle]:
        """Files entirely older than the TTL horizon (ref: TTL purge,
        sst/manager.rs:100-118)."""
        horizon = now_ms - ttl_ms
        return [h for h in self.all_files() if h.time_range.exclusive_end <= horizon]

    def total_size_bytes(self) -> int:
        return sum(h.meta.size_bytes for h in self.all_files())

    def max_sequence(self) -> int:
        files = self.all_files()
        return max((h.meta.max_sequence for h in files), default=0)
