"""Catalog: name -> table resolution, persisted in object storage
(ref: src/catalog + src/catalog_impls TableBasedManager for standalone
mode — the reference persists catalog entries through a system-table WAL,
catalog_impls/src/table_based.rs, or through meta consensus in cluster
mode, horaemeta cluster_metadata.go).

Persistence is an EDIT LOG over the object store, not a single
last-writer-wins blob: every create/drop writes one uniquely-named edit
object ``catalog/edits/<seq>.<node>`` — two nodes mutating a SHARED
store concurrently can never clobber each other's entries, because they
never write the same object. Readers fold the newest snapshot plus every
edit above its high-water mark, ordered by (seq, node) — deterministic
on every node. Compaction folds edits into ``catalog/snap.<seq>`` and
deletes only edits STRICTLY below that seq (same-seq edits from a racing
node survive and re-apply idempotently).

Known limitation (documented, matches the standalone contract): table
IDS still allocate from a sequential counter, so two nodes creating
tables at the same instant can collide on the id (storage paths) even
though neither catalog ENTRY is lost. Cluster mode routes creates
through the meta service, which serializes allocation.

Single default catalog/schema namespace ("horaedb"."public") for the
standalone build; the cluster build adds shard-backed volatile catalogs
(ref: catalog_impls/volatile.rs) in a later round.
"""

from __future__ import annotations

import logging
import threading
import uuid as _uuid
from dataclasses import dataclass
from typing import Optional

import msgpack

from ..common_types.schema import Schema
from ..engine.instance import Instance
from ..engine.options import TableOptions
from ..engine.table_data import TableData
from ..table_engine.partition import PartitionedTable, make_rule, sub_table_name
from ..table_engine.table import AnalyticTable, Table
from ..utils.object_store import ObjectStore

logger = logging.getLogger("horaedb_tpu_torch.catalog")

DEFAULT_CATALOG = "horaedb"
DEFAULT_SCHEMA = "public"

_REGISTRY_PATH = "catalog/registry"  # legacy single-blob registry (read-only)
_SNAP_PREFIX = "catalog/snap."
_EDIT_PREFIX = "catalog/edits/"
_COMPACT_EDITS = 64  # fold into a snapshot past this many live edits


@dataclass
class TableEntry:
    name: str
    table_id: int
    space_id: int
    partition_info: Optional[dict] = None
    sub_table_ids: Optional[list[int]] = None


class Catalog:
    """Table registry + lifecycle orchestration over the engine."""

    def __init__(self, store: ObjectStore, instance: Instance) -> None:
        self.store = store
        self.instance = instance
        self._lock = threading.RLock()
        self._entries: dict[str, TableEntry] = {}
        # Bumped on catalog-shape mutations (create/drop/reload/forget) —
        # connections key their plan caches on it. ALTER does NOT bump it
        # (it mutates the table, not the catalog); plan-cache hits
        # additionally verify the planned schema VERSION, which ALTER
        # does bump.
        self.ddl_generation = 0
        self._next_table_id = 1
        self._open_tables: dict[str, Table] = {}
        # Cluster hook: (logical_name, index, sub_name, sub_id)
        # -> Table | None. Returns a RemoteSubTable for partitions owned
        # by another node; None = open locally (ref: the reference builds
        # remote handles in PartitionTableImpl via remote_engine_client).
        self.sub_table_resolver = None
        self._load()

    # ---- persistence -----------------------------------------------------
    def _load(self) -> None:
        try:
            raw = msgpack.unpackb(self.store.get(_REGISTRY_PATH), raw=False)
        except FileNotFoundError:
            return
        self._next_table_id = raw["next_table_id"]
        for t in raw["tables"]:
            self._entries[t["name"]] = TableEntry(
                t["name"],
                t["table_id"],
                t["space_id"],
                t.get("partition_info"),
                t.get("sub_table_ids"),
            )

    def _persist_locked(self) -> None:
        body = msgpack.packb(
            {
                "next_table_id": self._next_table_id,
                "tables": [
                    {
                        "name": e.name,
                        "table_id": e.table_id,
                        "space_id": e.space_id,
                        "partition_info": e.partition_info,
                        "sub_table_ids": e.sub_table_ids,
                    }
                    for e in self._entries.values()
                ],
            },
            use_bin_type=True,
        )
        self.store.put(_REGISTRY_PATH, body)

    def reload(self) -> None:
        """Re-read the persisted registry (cluster mode: another node may
        have created tables in the SHARED object store since we loaded).
        Keeps open handles; only the name->entry map refreshes."""
        with self._lock:
            self.ddl_generation += 1
            self._entries.clear()
            self._load()

    def forget(self, name: str) -> None:
        """Drop the open handle + entry WITHOUT touching storage (shard
        moved away: the table lives on, owned by another node)."""
        with self._lock:
            self.ddl_generation += 1
            self._open_tables.pop(name, None)
            self._entries.pop(name, None)

    def entry(self, name: str) -> Optional[TableEntry]:
        with self._lock:
            return self._entries.get(name)

    # ---- lookup ------------------------------------------------------------
    def table_names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def schema_of(self, name: str) -> Optional[Schema]:
        t = self.open(name)
        return t.schema if t is not None else None

    def open(self, name: str) -> Optional[Table]:
        """Open a table behind the Table interface (the query layer's view)."""
        if "." in name:
            # Virtual system-catalog tables (system.public.tables) resolve
            # here so the whole query layer works on them unchanged
            # (ref: system_catalog/src/tables.rs). Non-system dotted names
            # FALL THROUGH: quoted identifiers may contain dots, and
            # schema-qualified references (public.demo) resolve to their
            # bare name.
            from ..table_engine.system import open_system_table

            st = open_system_table(self, name)
            if st is not None:
                return st
            if not self.exists(name):
                # Only names that are NOT themselves registered get the
                # qualified-name rewrite — a table literally named
                # `public.x` must never be shadowed by a sibling `x`.
                low = name.lower()
                for prefix in ("horaedb.public.", "public."):
                    if low.startswith(prefix) and self.exists(name[len(prefix):]):
                        return self.open(name[len(prefix):])
        with self._lock:
            cached = self._open_tables.get(name)
            if cached is not None:
                return cached
            e = self._entries.get(name)
            if e is None:
                return None
            if e.partition_info is not None:
                rule = make_rule(
                    e.partition_info["method"],
                    e.partition_info["columns"],
                    e.partition_info["num_partitions"],
                )
                subs: list[Table] = []
                for i, sub_id in enumerate(e.sub_table_ids or []):
                    sub_name = sub_table_name(name, i)
                    if self.sub_table_resolver is not None:
                        remote = self.sub_table_resolver(
                            name, i, sub_name, sub_id,
                            local_open=lambda sid=sub_id, sn=sub_name, sp=e.space_id:
                                self.instance.open_table(sp, sid, sn),
                        )
                        if remote is not None:
                            subs.append(remote)
                            continue
                    data = self.instance.open_table(e.space_id, sub_id, sub_name)
                    if data is None:
                        raise RuntimeError(
                            f"partition {i} of {name!r} missing from storage"
                        )
                    subs.append(AnalyticTable(self.instance, data))
                table: Table = PartitionedTable(name, rule, subs)
            else:
                data = self.instance.open_table(e.space_id, e.table_id, name)
                if data is None:
                    raise RuntimeError(
                        f"catalog entry for {name!r} exists but table storage is missing"
                    )
                table = AnalyticTable(self.instance, data)
            self._open_tables[name] = table
            return table

    def open_follower(self, name: str) -> Optional[Table]:
        """Open a PLAIN table as a read-only follower replica: manifest
        state from the shared object store, no WAL replay, no orphan
        sweep, every mutation fenced (engine/instance.open_table_follower).
        The handle is cached like a normal open, so the whole query layer
        serves from it transparently. Partitioned tables are not
        replicated (their sub-tables route per-shard); returns None for
        them and for names not in the registry."""
        with self._lock:
            cached = self._open_tables.get(name)
            if cached is not None:
                datas = cached.physical_datas()
                # a cached LEADER handle is a role conflict, not a
                # follower handle — the caller resolves (release/reopen)
                if datas and not datas[0].read_only:
                    return None
                return cached
            e = self._entries.get(name)
            if e is None or e.partition_info is not None:
                return None
            data = self.instance.open_table_follower(
                e.space_id, e.table_id, name
            )
            if data is None:
                return None
            table = AnalyticTable(self.instance, data)
            self._open_tables[name] = table
            return table

    def open_handle(self, name: str) -> Optional[Table]:
        """The ALREADY-OPEN handle for a name, or None — never opens
        (cluster code peeks at follower handles without triggering a
        manifest load)."""
        with self._lock:
            return self._open_tables.get(name)

    def release(self, name: str) -> None:
        """Drop the OPEN HANDLE for a table without touching its registry
        entry or storage (follower handle teardown; promotion to leader
        re-opens through the normal path with WAL replay)."""
        with self._lock:
            self.ddl_generation += 1  # cached plans bound the old handle
            t = self._open_tables.pop(name, None)
        if t is not None:
            for data in t.physical_datas():
                try:
                    self.instance.close_table(data, flush=False)
                except Exception:
                    logger.exception("releasing handle for %s", name)

    def open_sub_table(self, sub_name: str) -> Optional[Table]:
        """Open ONE partition of a partitioned table by its storage name
        (``__<table>_<index>``) as a local AnalyticTable.

        The remote-engine service resolves shipped sub-table requests here
        (the reference's remote engine works on sub tables by name,
        partition.rs sub table naming)."""
        if not sub_name.startswith("__") or "_" not in sub_name[2:]:
            return None
        logical, _, idx_str = sub_name[2:].rpartition("_")
        if not idx_str.isdigit():
            return None
        idx = int(idx_str)
        with self._lock:
            cached = self._open_tables.get(sub_name)
            if cached is not None:
                return cached
            e = self._entries.get(logical)
            if e is None or e.partition_info is None or e.sub_table_ids is None:
                return None
            if not (0 <= idx < len(e.sub_table_ids)):
                return None
            data = self.instance.open_table(e.space_id, e.sub_table_ids[idx], sub_name)
            if data is None:
                return None
            table = AnalyticTable(self.instance, data)
            self._open_tables[sub_name] = table
            return table

    # ---- DDL -----------------------------------------------------------------
    def create_table(
        self,
        name: str,
        schema: Schema,
        options: TableOptions,
        if_not_exists: bool = False,
        partition_info: Optional[dict] = None,
    ) -> Optional[Table]:
        with self._lock:
            if name in self._entries:
                if if_not_exists:
                    return self.open(name)
                raise ValueError(f"table already exists: {name}")
            if partition_info is not None:
                n = partition_info["num_partitions"]
                rule = make_rule(
                    partition_info["method"], partition_info["columns"], n
                )
                sub_ids = []
                subs: list[Table] = []
                for i in range(n):
                    sub_id = self._next_table_id
                    self._next_table_id += 1
                    sub_name = sub_table_name(name, i)
                    # Storage for every partition is created here (shared
                    # object store), but the SERVING handle respects
                    # ownership: partitions routed to another node close
                    # locally and resolve to remote handles.
                    data = self.instance.create_table(0, sub_id, sub_name, schema, options)
                    sub_ids.append(sub_id)
                    if self.sub_table_resolver is not None:
                        remote = self.sub_table_resolver(
                            name, i, sub_name, sub_id,
                            local_open=lambda sid=sub_id, sn=sub_name:
                                self.instance.open_table(0, sid, sn),
                        )
                        if remote is not None:
                            self.instance.close_table(data, flush=False)
                            subs.append(remote)
                            continue
                    subs.append(AnalyticTable(self.instance, data))
                logical_id = self._next_table_id
                self._next_table_id += 1
                self._entries[name] = TableEntry(
                    name, logical_id, 0, partition_info, sub_ids
                )
                table: Table = PartitionedTable(name, rule, subs)
            else:
                table_id = self._next_table_id
                self._next_table_id += 1
                data = self.instance.create_table(0, table_id, name, schema, options)
                self._entries[name] = TableEntry(name, table_id, 0)
                table = AnalyticTable(self.instance, data)
            self.ddl_generation += 1
            self._persist_locked()
            self._open_tables[name] = table
        from ..utils.events import record_event

        record_event(
            "ddl_create_table", table=name,
            partitions=(partition_info or {}).get("num_partitions", 0),
        )
        return table

    def drop_table(self, name: str, if_exists: bool = False) -> bool:
        # Unregister under the lock, drop storage AFTER releasing it:
        # routed partition handles consult the router (which takes the
        # cluster lock) while the heartbeat thread takes the cluster lock
        # and then calls back into this catalog — holding self._lock
        # across the drops would invert that order and deadlock.
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                if if_exists:
                    return False
                raise ValueError(f"table not found: {name}")
            table = self.open(name)
            self._entries.pop(name, None)
            self._open_tables.pop(name, None)
            self.ddl_generation += 1
            self._persist_locked()
        if table is not None:
            subs = getattr(table, "sub_tables", None)
            if subs is None:
                for data in table.physical_datas():
                    self.instance.drop_table(data)
            else:
                for sub in subs:
                    drop_storage = getattr(sub, "drop_storage", None)
                    if drop_storage is not None:
                        # Routed handle: drops wherever the partition
                        # lives — locally (even if never opened here)
                        # or on its owning node.
                        drop_storage()
                        continue
                    for data in sub.physical_datas():
                        self.instance.drop_table(data)
                    # Remote-owned partitions drop on their owning
                    # node, or their storage would orphan in the
                    # shared store.
                    drop_remote = getattr(sub, "drop_remote", None)
                    if drop_remote is not None:
                        drop_remote()
        from ..utils.events import record_event

        record_event("ddl_drop_table", table=name)
        return True

    def close(self) -> None:
        with self._lock:
            for t in list(self._open_tables.values()):
                for data in t.physical_datas():
                    self.instance.close_table(data)
            self._open_tables.clear()
