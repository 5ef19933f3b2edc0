"""Remote engine client + the remote sub-table
(ref: src/remote_engine_client/src/client.rs:65-484 — typed RPCs over a
channel pool; cached_router.rs route caching lives in cluster/router).

``RemoteSubTable`` is a full ``Table`` implementation whose owner is
another node: writes/reads/partial-aggregates cross the wire; everything
behind the interface (partitioned scatter/gather, the executor's
push-down) works unchanged — the partition layer cannot tell a local
AnalyticTable from a remote one, which is exactly the reference's
PartitionTableImpl + remote_engine_client split.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import grpc

from ..common_types.row_group import RowGroup
from ..common_types.schema import Schema
from ..engine.options import TableOptions
from ..table_engine.predicate import Predicate
from ..table_engine.table import Table
from ..utils.tracectx import graft, wire_context
from .codec import (
    columns_from_ipc,
    pack,
    predicate_to_dict,
    rows_from_ipc,
    rows_to_ipc,
    unpack,
)

GRPC_PORT_OFFSET = 1000

# Per-hop RPC ceiling, settable from [limits] forward_timeout at server
# startup (run_server) — the effective per-call timeout is
# min(this, remaining query budget) instead of a fixed constant.
DEFAULT_TIMEOUT_S = 30.0


def set_default_timeout(seconds: float) -> None:
    global DEFAULT_TIMEOUT_S
    if seconds and seconds > 0:
        DEFAULT_TIMEOUT_S = float(seconds)


def grpc_endpoint_for(http_endpoint: str, offset: int = GRPC_PORT_OFFSET) -> str:
    """Convention: a node's gRPC port = its HTTP port + offset.

    Routing state (meta, static rules) speaks HTTP endpoints; the remote
    engine derives the data-plane address from it (the reference instead
    carries both ports in topology — a future meta field can override)."""
    host, port = http_endpoint.rsplit(":", 1)
    return f"{host}:{int(port) + offset}"


class _ChannelPool:
    """One shared channel per endpoint (ref: channel.rs pool)."""

    _channels: dict[str, grpc.Channel] = {}
    _lock = threading.Lock()

    @classmethod
    def get(cls, endpoint: str) -> grpc.Channel:
        with cls._lock:
            ch = cls._channels.get(endpoint)
            if ch is None:
                ch = grpc.insecure_channel(endpoint)
                cls._channels[endpoint] = ch
            return ch


class RemoteEngineClient:
    def __init__(self, endpoint: str, timeout_s: Optional[float] = None) -> None:
        self.endpoint = endpoint
        self.timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
        self._channel = _ChannelPool.get(endpoint)

    def _call(self, method: str, payload: dict) -> dict:
        fn = self._channel.unary_unary(
            f"/horaedb.remote_engine/{method}",
            request_serializer=None,
            response_deserializer=None,
        )
        from ..utils.deadline import (
            DEADLINE_MARKER,
            DeadlineExceeded,
            current_deadline,
        )
        from ..utils.querystats import merge_remote, record
        from ..wlm.admission import current_admission

        adm = current_admission()
        if adm is not None and "admission" not in payload:
            # the coordinator's admission class rides every envelope
            # beside the trace/ledger context: the partition owner runs
            # the work on the matching PriorityRuntime lane and applies
            # its own gate (wlm/admission)
            payload["admission"] = adm
        # Deadline propagation: the envelope ships the REMAINING budget
        # (the owner refuses already-expired work and runs its own
        # checkpoints under it) and the per-call timeout is
        # min(per-hop cap, remaining) — a 25s-stale query can no longer
        # burn a fresh 30s on every hop.
        timeout_s = self.timeout_s
        budget = current_deadline()
        budget_bound = False
        if budget is not None:
            budget.check("remote")
            rem = budget.remaining_s()
            if rem is not None:
                payload.setdefault("deadline_ms", max(1, int(rem * 1000)))
                if rem < timeout_s:
                    timeout_s = max(0.05, rem)
                    budget_bound = True
        req = pack(payload)
        try:
            raw = fn(req, timeout=timeout_s)
        except grpc.RpcError as e:
            from ..wlm.admission import SHED_MARKER

            if e.code() == grpc.StatusCode.DEADLINE_EXCEEDED and budget_bound:
                # OUR budget set this call's timeout: surface the typed
                # 504, not an opaque transport error
                raise DeadlineExceeded(
                    f"remote call to {self.endpoint} outlived the "
                    "query's remaining budget",
                    stage="remote",
                    budget_ms=budget.budget_ms,
                ) from e
            if e.code() == grpc.StatusCode.DEADLINE_EXCEEDED and \
                    DEADLINE_MARKER in (e.details() or ""):
                # the owner refused/stopped the work against the SHIPPED
                # budget — same typed error, one wire mapping
                raise DeadlineExceeded(
                    f"partition owner {self.endpoint} refused expired "
                    f"work: {e.details()}",
                    stage="remote",
                ) from e

            if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED and \
                    SHED_MARKER in (e.details() or ""):
                # the owner's admission gate shed this sub-query (marker
                # distinguishes it from grpc's own RESOURCE_EXHAUSTED,
                # e.g. message-size overflow): surface it as the SAME
                # retryable overload the local gate raises, so the front
                # ends answer 503/1040/53300 + Retry-After instead of a
                # generic internal error
                from ..wlm.admission import OverloadedError

                raise OverloadedError(
                    f"partition owner {self.endpoint} overloaded: "
                    f"{e.details()}",
                    reason="remote_shed",
                    retry_after_s=1.0,
                ) from e
            raise
        record(remote_rpcs=1, remote_bytes=len(req) + len(raw))
        out = unpack(raw)
        if isinstance(out, dict):
            # the owner's cost ledger rides the response (the accounting
            # analog of the span subtree) and folds into the
            # coordinator's — query_stats shows the CLUSTER-wide cost
            merge_remote(out.get("ledger"))
        return out

    def get_table_info(self, table: str) -> dict:
        return self._call("GetTableInfo", {"table": table})

    def write(self, table: str, rows: RowGroup) -> int:
        out = self._call("Write", {"table": table, "ipc": rows_to_ipc(rows)})
        return int(out["affected"])

    def read(
        self,
        table: str,
        schema: Schema,
        predicate: Optional[Predicate],
        projection: Optional[Sequence[str]] = None,
    ) -> RowGroup:
        from ..common_types.schema import project_schema

        out = self._call(
            "Read",
            {
                "table": table,
                "predicate": predicate_to_dict(predicate or Predicate.all_time()),
                "projection": list(projection) if projection is not None else None,
                "trace": wire_context(),
            },
        )
        graft(out.get("span"), endpoint=self.endpoint)
        return rows_from_ipc(project_schema(schema, projection), out["ipc"])

    def partial_agg(self, table: str, spec: dict):
        out = self._call("PartialAgg", {"table": table, "spec": spec})
        # the owner's span subtree comes home in the response and grafts
        # under the coordinator's current span (ref: RemoteTaskContext)
        graft(out.get("span"), endpoint=self.endpoint)
        names, arrays = columns_from_ipc(out["ipc"])
        return names, arrays, out.get("metrics") or {}

    def read_page(
        self,
        table: str,
        schema: Schema,
        predicate: Optional[Predicate],
        projection: Optional[Sequence[str]] = None,
        after=None,
    ):
        """One page of the windowed stream -> (rows | None, next_token)."""
        from ..common_types.schema import project_schema

        out = self._call(
            "ReadPage",
            {
                "table": table,
                "predicate": predicate_to_dict(predicate or Predicate.all_time()),
                "projection": list(projection) if projection is not None else None,
                "after": after,
                "trace": wire_context(),
            },
        )
        # every page's remote span grafts under the ONE coordinator trace
        graft(out.get("span"), endpoint=self.endpoint)
        rows = None
        if out.get("ipc") is not None:
            rows = rows_from_ipc(project_schema(schema, projection), out["ipc"])
        return rows, out.get("next")

    def read_pages(
        self,
        table: str,
        schema: Schema,
        predicate: Optional[Predicate],
        projection: Optional[Sequence[str]] = None,
    ):
        """Stream the read one segment window per RPC (ref: the
        reference's record-batch streams over the remote engine,
        remote_engine_service/mod.rs:928-1011) — a table bigger than RAM
        never materializes in one envelope on either side."""
        after = None
        while True:
            rows, after = self.read_page(
                table, schema, predicate, projection, after
            )
            if rows is not None and len(rows):
                yield rows
            if after is None:
                return

    def execute_plan(self, table: str, req: dict):
        """Execute a shipped plan subtree on the owner (ref:
        client.rs:484 execute_physical_plan). -> (names, columns, nulls,
        metrics)."""
        from .codec import result_from_ipc

        out = self._call("ExecutePlan", {"table": table, **req})
        graft(out.get("span"), endpoint=self.endpoint)
        names, columns, nulls = result_from_ipc(out["ipc"])
        return names, columns, nulls, out.get("metrics") or {}

    def drop_sub(self, table: str) -> bool:
        return bool(self._call("DropSub", {"table": table}).get("dropped"))


class RoutedSubTable(Table):
    """A partition handle that RE-RESOLVES its owner through the router on
    every operation (ref: remote_engine_client/src/cached_router.rs —
    route caching with eviction on failure).

    A partition's shard can move at any time (rebalance, failover); a
    handle pinned to the endpoint observed at parent-open time would hit
    the old owner forever — it rejects with FAILED_PRECONDITION and the
    scatter write wedges. Instead every call asks the router (TTL-cached,
    so steady-state cost is a dict lookup), and on a stale-route error
    (remote FAILED_PRECONDITION/NOT_FOUND/UNAVAILABLE, or the local lease
    fence) the cached route is invalidated and the call retried once
    against the fresh owner. Local writes go through the SAME lease fence
    as remote ones (``cluster.ensure_table_writable``) — without it a
    node that lost the partition would keep applying scatter writes to
    shared storage alongside the new owner."""

    # Route sources that authoritatively establish locality: this node's
    # shard set, static rule config, or a fresh coordinator answer. A
    # "fallback" (coordinator unreachable) or "meta-unknown" local route
    # must NEVER open partition storage here — a non-owner would serve a
    # stale shared-store snapshot alongside the real owner.
    _AUTHORITATIVE_LOCAL = ("owned", "static", "meta")

    def __init__(
        self,
        name: str,
        schema: Schema,
        options: TableOptions,
        router,
        cluster=None,
        instance=None,
        local_open=None,  # () -> engine TableData | None (shared store)
    ) -> None:
        self._name = name
        self._schema = schema
        self._options = options
        self.router = router
        self.cluster = cluster
        self.instance = instance
        self.local_open = local_open
        self._local: Optional[Table] = None
        self._remote: Optional[RemoteSubTable] = None
        self._remote_ep: Optional[str] = None
        self._lock = threading.Lock()
        self._local_inflight = 0  # ops running against self._local
        self._close_pending = False

    @property
    def name(self) -> str:
        return self._name

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def options(self) -> TableOptions:
        return self._options

    # ---- resolution (all under self._lock) -------------------------------
    def _close_local_locked(self) -> None:
        """Close the local handle — deferred while operations are running
        against it (closing a TableData under a concurrent write would
        drop its rows into a just-closed memtable)."""
        if self._local is None:
            return
        if self._local_inflight > 0:
            self._close_pending = True
            return
        if self.instance is not None:
            for data in self._local.physical_datas():
                try:
                    # Mirrors ClusterImpl._release_table: with a WAL the
                    # unflushed rows are durable and replayed by the new
                    # owner; flushing here would race its manifest.
                    self.instance.close_table(
                        data, flush=self.instance.wal is None
                    )
                except Exception:
                    pass
        self._local = None
        self._close_pending = False

    def _resolve_locked(self, route) -> Table:
        if route.is_local:
            if route.source not in self._AUTHORITATIVE_LOCAL:
                raise RuntimeError(
                    f"cannot resolve partition {self._name!r}: route is "
                    f"non-authoritative ({route.source}); refusing to open "
                    "shared storage on a possible non-owner"
                )
            if self._local is None:
                if self.local_open is None:
                    raise RuntimeError(
                        f"partition {self._name!r} routed local but no "
                        "local opener configured"
                    )
                data = self.local_open()
                if data is None:
                    raise RuntimeError(
                        f"partition {self._name!r} missing from storage"
                    )
                from ..table_engine.table import AnalyticTable

                self._local = AnalyticTable(self.instance, data)
            return self._local
        self._close_local_locked()
        ep = grpc_endpoint_for(route.endpoint)
        if self._remote is None or self._remote_ep != ep:
            self._remote = RemoteSubTable(
                self._name, ep, self._schema, self._options
            )
            self._remote_ep = ep
        return self._remote

    @staticmethod
    def _is_stale_route_error(e: Exception, for_write: bool = False) -> bool:
        if isinstance(e, grpc.RpcError):
            codes = [
                grpc.StatusCode.FAILED_PRECONDITION,  # fenced: not applied
                grpc.StatusCode.NOT_FOUND,            # no table: not applied
            ]
            if not for_write:
                # UNAVAILABLE is ambiguous for writes (the rows may have
                # been applied before the connection died — retrying
                # could double-write); reads/aggs are idempotent.
                codes.append(grpc.StatusCode.UNAVAILABLE)
            return e.code() in codes
        from ..cluster.shard import ShardError

        return isinstance(e, ShardError)

    def _call(self, op, fenced: bool = False):
        """Run ``op(target)`` with one stale-route retry."""
        for attempt in (0, 1):
            # route() consults the cluster shard set (cluster._lock) —
            # resolve BEFORE taking self._lock; holding both would invert
            # against the heartbeat thread's cluster._lock ->
            # physical_datas() -> self._lock order.
            route = self.router.route(self._name)
            with self._lock:
                t = self._resolve_locked(route)
                local = t is self._local
                if local:
                    self._local_inflight += 1
            try:
                if local and fenced and self.cluster is not None:
                    self.cluster.ensure_table_writable(self._name)
                return op(t)
            except Exception as e:
                if attempt == 0 and self._is_stale_route_error(
                    e, for_write=fenced
                ):
                    from ..utils.querystats import record

                    record(retries=1)
                    self.router.invalidate(self._name)
                    continue
                raise
            finally:
                if local:
                    with self._lock:
                        self._local_inflight -= 1
                        if self._close_pending and self._local_inflight == 0:
                            self._close_local_locked()

    # ---- Table interface -------------------------------------------------
    def write(self, rows: RowGroup) -> int:
        return self._call(lambda t: t.write(rows), fenced=True)

    def read(self, predicate=None, projection=None) -> RowGroup:
        return self._call(lambda t: t.read(predicate, projection))

    def partial_agg(self, spec: dict):
        return self._call(lambda t: t.partial_agg(spec))

    def read_windows(self, predicate=None, projection=None):
        """Streamed read, ONE page per _call: the stale-route retry and
        the close-deferral inflight guard both hold for every page (a
        shard move between pages re-resolves the owner; the stateless
        window token makes the resume exact)."""
        from ..table_engine.table import read_one_page

        after = None
        while True:
            def one_page(t, after=after):
                if isinstance(t, RemoteSubTable):
                    return t.client.read_page(
                        t.name, t.schema, predicate, projection, after
                    )
                return read_one_page(t, predicate, projection, after)

            rows, after = self._call(one_page)
            if rows is not None and len(rows):
                yield rows
            if after is None:
                return

    def execute_plan(self, req: dict):
        """Ship the plan when the owner is remote; None when the route is
        local — the coordinator's executor runs it against this handle
        directly (the local resolution already IS where the data lives)."""
        return self._call(
            lambda t: t.execute_plan(req) if isinstance(t, RemoteSubTable) else None
        )

    def drop_storage(self) -> None:
        """Called by the logical DROP TABLE: drop this partition's storage
        wherever it lives — on the owning node when remote, or locally
        (opening it first if this handle never touched it). One
        stale-route retry: a drop sent to a node the partition just left
        answers dropped=false (or errors), and giving up there would
        orphan the partition's SSTs in the shared store forever."""
        for attempt in (0, 1):
            route = self.router.route(self._name)
            if route.is_local:
                if route.source not in self._AUTHORITATIVE_LOCAL:
                    raise RuntimeError(
                        f"cannot drop partition {self._name!r}: route is "
                        f"non-authoritative ({route.source})"
                    )
                with self._lock:
                    t = self._local
                    if t is None and self.local_open is not None:
                        data = self.local_open()
                        if data is None:
                            return  # storage already gone
                        from ..table_engine.table import AnalyticTable

                        t = AnalyticTable(self.instance, data)
                    if t is None:
                        return
                    for data in t.physical_datas():
                        self.instance.drop_table(data)
                    self._local = None
                return
            try:
                client = RemoteEngineClient(grpc_endpoint_for(route.endpoint))
                if client.drop_sub(self._name):
                    return
                # The target no longer holds the partition — route moved.
                if attempt == 0:
                    self.router.invalidate(self._name)
                    continue
                raise RuntimeError(
                    f"drop of partition {self._name!r} refused by "
                    f"{route.endpoint} and the refreshed route"
                )
            except grpc.RpcError as e:
                if attempt == 0 and self._is_stale_route_error(e):
                    self.router.invalidate(self._name)
                    continue
                raise

    def flush(self) -> None:
        with self._lock:
            if self._local is not None:
                self._local.flush()

    def compact(self) -> None:
        with self._lock:
            if self._local is not None:
                self._local.compact()

    def alter_schema(self, schema: Schema) -> None:
        route = self.router.route(self._name)  # outside self._lock, see _call
        with self._lock:
            t = self._resolve_locked(route)
            if t is not self._local:
                raise NotImplementedError("ALTER runs on the owning node")
            t.alter_schema(schema)
            self._schema = schema

    def alter_options(self, options: TableOptions) -> None:
        route = self.router.route(self._name)  # outside self._lock, see _call
        with self._lock:
            t = self._resolve_locked(route)
            if t is not self._local:
                raise NotImplementedError("ALTER runs on the owning node")
            t.alter_options(options)
            self._options = options

    def physical_datas(self) -> list:
        # What THIS node holds open locally (close/drop paths walk this);
        # remote-owned partitions contribute nothing here.
        with self._lock:
            return [] if self._local is None else self._local.physical_datas()

    def metrics(self) -> dict:
        with self._lock:
            if self._local is not None:
                return self._local.metrics()
        return {"table": self._name, "remote": self._remote_ep}


class RemoteSubTable(Table):
    """A partition owned by another node, behind the Table interface."""

    def __init__(self, name: str, endpoint: str, schema: Schema, options: TableOptions) -> None:
        self._name = name
        self._schema = schema
        self._options = options
        self.client = RemoteEngineClient(endpoint)

    @property
    def name(self) -> str:
        return self._name

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def options(self) -> TableOptions:
        return self._options

    def write(self, rows: RowGroup) -> int:
        return self.client.write(self._name, rows)

    def read(self, predicate=None, projection=None) -> RowGroup:
        return self.client.read(self._name, self._schema, predicate, projection)

    def read_windows(self, predicate=None, projection=None):
        """Streamed: one segment window per RPC — the memory-bounded
        aggregate path over a REMOTE partition never holds the whole
        partition on either side."""
        yield from self.client.read_pages(
            self._name, self._schema, predicate, projection
        )

    def partial_agg(self, spec: dict):
        names, arrays, metrics = self.client.partial_agg(self._name, spec)
        return names, arrays, [{
            "partition": self._name,
            "remote": self.client.endpoint,
            **metrics,
        }]

    def execute_plan(self, req: dict):
        names, columns, nulls, metrics = self.client.execute_plan(
            self._name, req
        )
        return names, columns, nulls, {
            "partition": self._name,
            "remote": self.client.endpoint,
            **metrics,
        }

    def drop_remote(self) -> None:
        """Delete this partition's storage on its owning node (the
        logical DROP TABLE calls this for every remote partition)."""
        self.client.drop_sub(self._name)

    # Maintenance is owner-local; remote handles are read/write views.
    def flush(self) -> None:
        pass

    def compact(self) -> None:
        pass

    def alter_schema(self, schema: Schema) -> None:
        raise NotImplementedError("ALTER runs on the owning node")

    def alter_options(self, options: TableOptions) -> None:
        raise NotImplementedError("ALTER runs on the owning node")

    def physical_datas(self) -> list:
        return []

    def metrics(self) -> dict:
        return {"table": self._name, "remote": self.client.endpoint}
