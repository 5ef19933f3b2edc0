"""Table manifest: metadata edit log + snapshots
(ref: analytic_engine/src/manifest/{details.rs,meta_edit.rs,meta_snapshot.rs}).

Every metadata mutation (flush adds an SST, compaction swaps SSTs, ALTER
changes the schema, flush advances the flushed sequence) is a ``MetaEdit``
appended durably BEFORE the in-memory state changes. Recovery = load last
snapshot + replay newer edit logs (details.rs:246-346). Periodic snapshots
bound replay time (details.rs:605-643).

Storage layout under the object store:

    manifest/{space}/{table}/log.{seq:020d}   — msgpack list of edits
    manifest/{space}/{table}/snapshot          — msgpack snapshot + watermark

The reference appends edits to a dedicated WAL region; here each append is
one immutable object (atomic on LocalDiskStore via rename), which keeps the
manifest independent of the data WAL backend.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import msgpack

from ..common_types.schema import Schema
from ..common_types.time_range import TimeRange
from ..utils.object_store import ObjectStore
from .sst.manager import FileHandle, LevelsController
from .sst.meta import SstMeta


# ---- edits ------------------------------------------------------------


@dataclass(frozen=True)
class AddFile:
    level: int
    meta: SstMeta
    path: str
    kind: str = "add_file"


@dataclass(frozen=True)
class RemoveFile:
    level: int
    file_id: int
    kind: str = "remove_file"


@dataclass(frozen=True)
class AlterSchema:
    schema: Schema
    kind: str = "alter_schema"


@dataclass(frozen=True)
class AlterOptions:
    options: dict
    kind: str = "alter_options"


@dataclass(frozen=True)
class Flushed:
    sequence: int
    kind: str = "flushed"


MetaEdit = AddFile | RemoveFile | AlterSchema | AlterOptions | Flushed


def _edit_to_dict(e: MetaEdit) -> dict:
    if isinstance(e, AddFile):
        return {"kind": e.kind, "level": e.level, "meta": e.meta.to_dict(), "path": e.path}
    if isinstance(e, RemoveFile):
        return {"kind": e.kind, "level": e.level, "file_id": e.file_id}
    if isinstance(e, AlterSchema):
        return {"kind": e.kind, "schema": e.schema.to_dict()}
    if isinstance(e, AlterOptions):
        return {"kind": e.kind, "options": e.options}
    if isinstance(e, Flushed):
        return {"kind": e.kind, "sequence": e.sequence}
    raise TypeError(f"unknown edit {e!r}")


def _edit_from_dict(d: dict) -> MetaEdit:
    k = d["kind"]
    if k == "add_file":
        return AddFile(d["level"], SstMeta.from_dict(d["meta"]), d["path"])
    if k == "remove_file":
        return RemoveFile(d["level"], d["file_id"])
    if k == "alter_schema":
        return AlterSchema(Schema.from_dict(d["schema"]))
    if k == "alter_options":
        return AlterOptions(d["options"])
    if k == "flushed":
        return Flushed(d["sequence"])
    raise ValueError(f"unknown edit kind {k!r}")


# ---- state ------------------------------------------------------------


@dataclass
class TableManifestState:
    """Materialized view of a table's manifest."""

    schema: Optional[Schema] = None
    options: dict = field(default_factory=dict)
    levels: LevelsController = field(default_factory=LevelsController)
    flushed_sequence: int = 0
    next_file_id: int = 1

    def apply(self, edit: MetaEdit) -> None:
        if isinstance(edit, AddFile):
            self.levels.add_file(edit.level, FileHandle(edit.meta, edit.path, edit.level))
            self.next_file_id = max(self.next_file_id, edit.meta.file_id + 1)
        elif isinstance(edit, RemoveFile):
            self.levels.remove_files(edit.level, [edit.file_id])
        elif isinstance(edit, AlterSchema):
            self.schema = edit.schema
        elif isinstance(edit, AlterOptions):
            self.options.update(edit.options)
        elif isinstance(edit, Flushed):
            self.flushed_sequence = max(self.flushed_sequence, edit.sequence)
        else:
            raise TypeError(f"unknown edit {edit!r}")

    def to_dict(self) -> dict:
        return {
            "schema": self.schema.to_dict() if self.schema else None,
            "options": self.options,
            "files": [
                {"level": h.level, "meta": h.meta.to_dict(), "path": h.path}
                for h in self.levels.all_files()
            ],
            "flushed_sequence": self.flushed_sequence,
            "next_file_id": self.next_file_id,
        }

    @staticmethod
    def from_dict(d: dict) -> "TableManifestState":
        st = TableManifestState()
        if d.get("schema"):
            st.schema = Schema.from_dict(d["schema"])
        st.options = dict(d.get("options", {}))
        for f in d.get("files", []):
            meta = SstMeta.from_dict(f["meta"])
            st.levels.add_file(f["level"], FileHandle(meta, f["path"], f["level"]))
        st.flushed_sequence = d.get("flushed_sequence", 0)
        st.next_file_id = d.get("next_file_id", 1)
        return st


# ---- manifest ---------------------------------------------------------


class Manifest:
    SNAPSHOT_EVERY_N_LOGS = 16

    def __init__(self, store: ObjectStore, space_id: int, table_id: int) -> None:
        self.store = store
        self.prefix = f"manifest/{space_id}/{table_id}/"
        self._lock = threading.Lock()
        self._next_log_seq = 0
        self._append_probed = False

    # ---- paths ---------------------------------------------------------
    def _log_path(self, seq: int) -> str:
        return f"{self.prefix}log.{seq:020d}"

    @property
    def _snapshot_path(self) -> str:
        return f"{self.prefix}snapshot"

    def _log_seqs(self) -> list[int]:
        logs = []
        for p in self.store.list(self.prefix):
            name = p[len(self.prefix):]
            if name.startswith("log."):
                logs.append(int(name[4:]))
        return sorted(logs)

    # ---- writes --------------------------------------------------------
    def append_edits(self, edits: list[MetaEdit]) -> None:
        if not edits:
            return
        with self._lock:
            seq = self._next_log_seq
            # Defense in depth for cluster mode: another NODE may have
            # appended while this handle was idle (shard moved away and
            # back). Probe for an existing log object once per handle —
            # after our own first append, WE own the head (single-writer
            # fencing) — and skip to the first free sequence rather than
            # overwrite (which would silently lose the other writer's
            # edits). Exists-then-put is not atomic; the fencing layer is
            # the real guarantee, this narrows the window.
            if not self._append_probed:
                # The snapshot watermark counts as much as existing log
                # files: after truncation removed every log, a fresh
                # handle that appends BEFORE ever loading would otherwise
                # start at seq 0 and write edits every load skips as
                # `<= last_log_seq` (the same silent-loss class the
                # load-path fix covers; caught by the round-trip test).
                seq = max(seq, self._snapshot_watermark() + 1)
                while self.store.exists(self._log_path(seq)):
                    seq += 1
                self._append_probed = True
            self._next_log_seq = seq + 1
            payload = msgpack.packb([_edit_to_dict(e) for e in edits], use_bin_type=True)
            self.store.put(self._log_path(seq), payload)
            if (seq + 1) % self.SNAPSHOT_EVERY_N_LOGS == 0:
                self._do_snapshot_locked()

    def snapshot(self) -> None:
        with self._lock:
            self._do_snapshot_locked()

    def _snapshot_watermark(self) -> int:
        """last_log_seq covered by the persisted snapshot, -1 if none."""
        try:
            snap = msgpack.unpackb(self.store.get(self._snapshot_path), raw=False)
            return int(snap.get("last_log_seq", -1))
        except FileNotFoundError:
            return -1

    def _do_snapshot_locked(self) -> None:
        state, last_applied = self._load_locked()
        body = msgpack.packb(
            {"state": state.to_dict(), "last_log_seq": last_applied},
            use_bin_type=True,
        )
        self.store.put(self._snapshot_path, body)
        # Logs covered by the snapshot are garbage; drop them.
        for seq in self._log_seqs():
            if seq <= last_applied:
                self.store.delete(self._log_path(seq))

    # ---- recovery ------------------------------------------------------
    def load(self) -> TableManifestState:
        with self._lock:
            state, _ = self._load_locked()
            return state

    def _load_locked(self) -> tuple[TableManifestState, int]:
        state = TableManifestState()
        last_applied = -1
        try:
            snap = msgpack.unpackb(self.store.get(self._snapshot_path), raw=False)
            state = TableManifestState.from_dict(snap["state"])
            last_applied = snap["last_log_seq"]
        except FileNotFoundError:
            pass
        seqs = self._log_seqs()
        for seq in seqs:
            if seq <= last_applied:
                continue
            for d in msgpack.unpackb(self.store.get(self._log_path(seq)), raw=False):
                state.apply(_edit_from_dict(d))
            last_applied = seq
        # next_log_seq must clear BOTH the surviving log files AND the
        # snapshot watermark. After a snapshot truncated every log, a
        # fresh handle that considered only files would restart at seq 0;
        # its appends would then be `<= last_applied` and silently
        # SKIPPED by every future load — recovery reverts to the
        # snapshot, and the orphan sweep deletes the SSTs those invisible
        # edits referenced (found by the fuzz harness, seed 2).
        self._next_log_seq = max(
            self._next_log_seq,
            (seqs[-1] + 1) if seqs else 0,
            last_applied + 1,
        )
        return state, last_applied

    def exists(self) -> bool:
        if self.store.exists(self._snapshot_path):
            return True
        return bool(self._log_seqs())

    def destroy(self) -> None:
        """DROP TABLE: remove every manifest object."""
        with self._lock:
            for p in list(self.store.list(self.prefix)):
                self.store.delete(p)
