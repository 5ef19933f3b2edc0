"""Embedded database facade — the minimum end-to-end surface.

    import horaedb_tpu_torch
    db = horaedb_tpu_torch.connect("/path/to/data")   # or None for in-memory
    # device="cuda" (the default) runs the CUDA kernels; device="cpu"
    # runs their plain PyTorch versions
    db.execute("CREATE TABLE demo (name string TAG, value double, "
               "t timestamp NOT NULL, TIMESTAMP KEY(t)) ENGINE=Analytic")
    db.execute("INSERT INTO demo (name, value, t) VALUES ('h1', 0.5, 1000)")
    rows = db.execute("SELECT avg(value) FROM demo GROUP BY name").to_pylist()

The server layer (HTTP /sql etc.) drives exactly this object; in the
reference the equivalent stack is proxy -> Frontend -> interpreters
(SURVEY §3.2).
"""

from __future__ import annotations

from typing import Optional, Union

from .catalog import Catalog
from .device import resolve_device
from .engine.instance import EngineConfig, Instance
from .engine.wal import LocalDiskWal
from .query.frontend import Frontend
from .query.interpreters import AffectedRows, InterpreterFactory, Output
from .query.executor import ResultSet
from .utils.object_store import LocalDiskStore, MemoryStore, ObjectStore
from .utils.tracectx import annotate


class Connection:
    def __init__(
        self,
        store: ObjectStore,
        wal=None,
        config: EngineConfig | None = None,
        device="cuda",
    ) -> None:
        # resolved before anything is opened: no usable card, no connection
        self.device = resolve_device(device)
        self.store = store
        self.instance = Instance(store, config=config, wal=wal)
        self.catalog = Catalog(store, self.instance)
        self.frontend = Frontend(self.catalog.schema_of)
        self.interpreters = InterpreterFactory(self.catalog, self.device)
        # Remote partial-agg span ring (ref: RemoteTaskContext.remote_metrics)
        # — the gRPC service appends, /debug/remote_spans reads; spans carry
        # the ORIGIN coordinator's request id for cross-node correlation.
        import threading
        from collections import deque

        self.remote_spans: deque = deque(maxlen=128)
        # gRPC workers append while the HTTP debug endpoint snapshots;
        # deque iteration during a concurrent append raises — lock both.
        self.remote_spans_lock = threading.Lock()
        # Plan cache: dashboards re-issue IDENTICAL query text at high
        # rate, and at serving latencies (~1ms on the packed cached path)
        # parse+plan is most of the request. SELECT-family plans are
        # immutable frozen dataclasses — reusable verbatim. Invalidation:
        # the catalog DDL generation (create/drop/alter bump it) plus the
        # planned table's schema version (covers cluster-reload alters).
        self._plan_cache: dict = {}
        self._plan_cache_lock = threading.Lock()

    _PLAN_CACHE_MAX = 256

    def _cached_plan(self, sql: str):
        from .query import plan as plan_mod

        def fresh(p) -> bool:
            # ALTERs bump schema versions without a catalog persist; a
            # cached plan binds the schema it was planned against.
            if isinstance(p, plan_mod.QueryPlan):
                s = self.catalog.schema_of(p.table)
                return s is not None and s.version == p.schema.version
            if isinstance(p, plan_mod.UnionPlan):
                return all(fresh(b) for b in p.branches)
            return True  # CTEPlan: inner ASTs re-plan at execute time

        gen = self.catalog.ddl_generation
        with self._plan_cache_lock:
            hit = self._plan_cache.get(sql)
        if hit is not None:
            plan, cached_gen = hit
            if cached_gen == gen and fresh(plan):
                annotate(plan_cache="hit")
                return plan
        annotate(plan_cache="miss")
        plan = self.frontend.sql_to_plan(sql)
        if isinstance(
            plan, (plan_mod.QueryPlan, plan_mod.UnionPlan, plan_mod.CTEPlan)
        ):
            with self._plan_cache_lock:
                if len(self._plan_cache) >= self._PLAN_CACHE_MAX:
                    self._plan_cache.pop(next(iter(self._plan_cache)))
                self._plan_cache[sql] = (plan, gen)
        return plan

    def execute(self, sql: str) -> Output:
        return self.interpreters.execute(self._cached_plan(sql))

    def execute_many(self, sql: str) -> list[Output]:
        return [
            self.interpreters.execute(self.frontend.statement_to_plan(s))
            for s in self.frontend.parse_sql_many(sql)
        ]

    def flush_all(self) -> None:
        for t in self.instance.open_tables():
            self.instance.flush_table(t)

    def close(self) -> None:
        # A closed database's scan cache must stop contributing to the
        # process-wide device-residency inventory NOW, not whenever GC
        # collects it (system.public.device merges live sources only).
        try:
            from .obs.device import unregister_occupancy_provider

            unregister_occupancy_provider(
                self.interpreters.executor.scan_cache
            )
        except Exception:
            pass
        # Catalog close flushes every table, and those flushes may
        # REQUEST compactions — so the scheduler drain must come after,
        # or a close-time flush would resurrect a scheduler whose merge
        # then races the next Connection over the same manifest (two
        # independent log-sequence counters; the loser's edits are
        # skipped as stale on load while its input purges survive —
        # found by the fuzz harness, seed 2).
        try:
            self.catalog.close()
        finally:
            self.instance.close(wait=True)


def connect(
    path: Optional[str] = None,
    device="cuda",
    wal: bool = True,
    engine_config: EngineConfig | None = None,
    wal_backend: str = "disk",
) -> Connection:
    """Open (or create) a database. ``path=None`` -> in-memory, no WAL.

    ``device``: where every tensor of the connection lives and every
    kernel runs — ``"cuda"`` (the default; raises when no card is usable)
    or ``"cpu"`` (the kernels' plain PyTorch versions).

    ``wal_backend``: "disk" (framed local log per table), "object_store"
    (paged log in the same store as the SSTs — a diskless node recovers
    from shared storage alone), or "shared_log" (region-based shared log:
    one segmented log multiplexes every table of a region/shard and shard
    recovery scans it once — the reference's message-queue WAL layout
    with RegionBased replay)."""
    if path is None:
        return Connection(MemoryStore(), config=engine_config, device=device)
    resolve_device(device)  # fail before touching the data directory
    store = LocalDiskStore(path)
    if not wal:
        wal_mgr = None
    elif wal_backend == "object_store":
        from .engine.wal import ObjectStoreWal

        wal_mgr = ObjectStoreWal(store)
    elif wal_backend == "shared_log":
        from .engine.wal import SharedLogWal

        wal_mgr = SharedLogWal(f"{path}/wal")
    elif wal_backend == "disk":
        wal_mgr = LocalDiskWal(f"{path}/wal")
    else:
        raise ValueError(
            f"unknown wal_backend {wal_backend!r} "
            "(use 'disk', 'object_store' or 'shared_log')"
        )
    return Connection(store, wal=wal_mgr, config=engine_config, device=device)
