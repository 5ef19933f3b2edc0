"""Data-node gRPC server: RemoteEngineService + StorageService
(ref: src/server/src/grpc/mod.rs:162-198 — one tonic server bundling the
services on one port; remote_engine_service/mod.rs:695-1011;
storage_service/mod.rs:55-145. Default port 8831, config.rs:176-179).

Implemented with grpc generic handlers (bytes in/out): each method takes a
msgpack envelope; row data rides inside as arrow IPC. No protoc codegen —
the envelope schema IS the contract, documented per method below.

    /horaedb.remote_engine/GetTableInfo  {table} -> {schema, options}
    /horaedb.remote_engine/Write         {table, ipc} -> {affected}
    /horaedb.remote_engine/Read          {table, predicate, projection}
                                         -> {ipc}
    /horaedb.remote_engine/PartialAgg    {table, spec} -> {ipc}  (partial
                                         aggregate batch, query/partial)
    /horaedb.storage/SqlQuery            {query} -> {rows}|{affected}
    /horaedb.storage/Write               {table, ipc} -> {affected}
"""

from __future__ import annotations

import logging
from concurrent import futures
from typing import Optional

import grpc

from ..common_types.row_group import RowGroup
from ..utils.querystats import serving_ledger
from ..utils.runtime import PriorityRuntime
from ..utils.tracectx import root_dict, serving_trace, span
from ..wlm.admission import (
    SHED_MARKER,
    AdmissionController,
    OverloadedError,
    lane_for,
)
from .codec import (
    columns_to_ipc,
    pack,
    predicate_from_dict,
    rows_from_ipc,
    rows_to_ipc,
    unpack,
)

logger = logging.getLogger("horaedb_tpu_torch.remote")

DEFAULT_GRPC_PORT = 8831  # ref: config.rs:176-179


class _RpcError(Exception):
    def __init__(self, code: grpc.StatusCode, msg: str) -> None:
        super().__init__(msg)
        self.code = code


class GrpcServer:
    """Bundles both services on one port over a Connection.

    ``cluster`` (optional ClusterImpl) adds the same lease-fencing write
    barrier the HTTP path has — a remote-engine write is still a write.
    """

    def __init__(
        self,
        conn,
        host: str = "127.0.0.1",
        port: int = DEFAULT_GRPC_PORT,
        cluster=None,
        max_workers: int = 8,
    ) -> None:
        self.conn = conn
        self.cluster = cluster
        self.host = host
        self.port = port
        # Serving-side workload management: the coordinator's admission
        # class rides the envelope; heavy ops (PartialAgg/ExecutePlan)
        # run on the matching priority lane behind this node's OWN gate —
        # a fan-out storm from many coordinators can't starve the owner.
        self.admission = AdmissionController(total_units=max_workers)
        self.runtime = PriorityRuntime(high_workers=max(2, max_workers // 2),
                                       low_workers=2)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="grpc")
        )
        self._server.add_generic_rpc_handlers(
            (
                grpc.method_handlers_generic_handler(
                    "horaedb.remote_engine",
                    {
                        "GetTableInfo": _unary(self._get_table_info),
                        "Write": _unary(self._write),
                        "Read": _unary(self._read),
                        "ReadPage": _unary(self._read_page),
                        "PartialAgg": _unary(self._partial_agg),
                        "ExecutePlan": _unary(self._execute_plan),
                        "DropSub": _unary(self._drop_sub),
                    },
                ),
                grpc.method_handlers_generic_handler(
                    "horaedb.storage",
                    {
                        "SqlQuery": _unary(self._sql_query),
                        "Write": _unary(self._write),
                    },
                ),
            )
        )
        self.bound_port = self._server.add_insecure_port(f"{host}:{port}")
        if self.bound_port == 0:
            # grpc reports bind failure as port 0 — surface it at startup,
            # not as opaque per-query RPC errors against a dead endpoint.
            raise OSError(f"could not bind gRPC services to {host}:{port}")

    def start(self) -> None:
        self._server.start()
        logger.info("grpc services on %s:%d", self.host, self.bound_port)

    def stop(self, grace: float = 2.0) -> None:
        self._server.stop(grace)
        self.runtime.shutdown()

    def _gated(self, admission_class, fn):
        """Run ``fn`` on the lane matching the shipped admission class,
        behind this node's own admission gate. The serving ledger/trace
        follow by context copy; a shed answers RESOURCE_EXHAUSTED (the
        coordinator surfaces it as a retryable overload)."""
        import contextvars

        cls = admission_class if admission_class in ("cheap", "normal", "expensive") \
            else "normal"
        try:
            with self.admission.admit(cls):
                # copy AFTER admit so the admitted class (and the serving
                # ledger/trace) ride to the pool thread and any nested RPC
                cctx = contextvars.copy_context()
                return self.runtime.run(lane_for(cls), lambda: cctx.run(fn))
        except OverloadedError as e:
            # SHED_MARKER distinguishes a deliberate shed from grpc's own
            # RESOURCE_EXHAUSTED uses (e.g. message-size overflow): only
            # marked errors are retryable overloads on the coordinator
            raise _RpcError(
                grpc.StatusCode.RESOURCE_EXHAUSTED, f"{SHED_MARKER}: {e}"
            )

    # ---- table resolution ----------------------------------------------
    def _open(self, name: str):
        catalog = self.conn.catalog
        t = catalog.open(name) or catalog.open_sub_table(name)
        if t is None:
            # Cluster mode: the table may have been created by another
            # node since our registry snapshot.
            reload_fn = getattr(catalog, "reload", None)
            if reload_fn is not None:
                reload_fn()
                t = catalog.open(name) or catalog.open_sub_table(name)
        if t is None:
            raise _RpcError(grpc.StatusCode.NOT_FOUND, f"table not found: {name}")
        return t

    # ---- remote engine ---------------------------------------------------
    def _get_table_info(self, req: dict) -> dict:
        t = self._open(req["table"])
        return {"schema": t.schema.to_dict(), "options": t.options.to_dict()}

    def _write(self, req: dict) -> dict:
        name = req["table"]
        if self.cluster is not None:
            from ..cluster import ShardError

            try:
                self.cluster.ensure_table_writable(name)
            except ShardError as e:
                raise _RpcError(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        t = self._open(name)
        rows = rows_from_ipc(t.schema, req["ipc"])
        t.write(rows)
        return {"affected": len(rows)}

    def _read(self, req: dict) -> dict:
        # This node's share of the query's cost accounts in a detached
        # ledger and ships home in the response (the accounting analog of
        # the span subtree) — the COORDINATOR's merged row is the one
        # per-query truth, so nothing lands in this node's stats ring.
        sl = serving_ledger((req.get("trace") or {}).get("request_id"))
        with sl, serving_trace(
            req.get("trace"), "remote_read", table=req["table"]
        ) as trace:
            t = self._open(req["table"])
            pred = predicate_from_dict(req["predicate"]) if req.get("predicate") else None
            projection = req.get("projection")
            with span("scan", table=req["table"]) as sp:
                rows = t.read(pred, projection=projection)
                sp.set(rows=len(rows))
            # NO scan_rows here: raw rows cross the wire and the
            # coordinator's gather counts them exactly once — recording
            # them in the shipped ledger too would double-count. The
            # engine-level costs (sst_read, store bytes, memtable rows)
            # accrued above DO ship home; only this node sees them.
        return {"ipc": rows_to_ipc(rows), "span": root_dict(trace), "ledger": sl.wire}

    def _read_page(self, req: dict) -> dict:
        """Streaming read, one segment window per RPC (ref: the reference
        streams arrow IPC batches over the remote engine,
        server/src/grpc/remote_engine_service/mod.rs:928-1011; grpc
        generic bytes-in/bytes-out has no server streaming, so the stream
        is stateless pagination by WINDOW START — same correctness basis
        as the bounded scan: a key's versions never straddle windows).

        req: {table, predicate?, projection?, after?, trace?} — ``after``
        is the previous page's ``next`` token (an exclusive window-start
        lower bound). -> {ipc, next, span} where next=None terminates the
        stream; ``span`` is this page's span subtree when the caller sent
        trace context (each page grafts under the ONE coordinator trace)."""
        from ..table_engine.table import read_one_page

        sl = serving_ledger((req.get("trace") or {}).get("request_id"))
        with sl, serving_trace(
            req.get("trace"), "remote_read_page", table=req["table"]
        ) as trace:
            t = self._open(req["table"])
            pred = predicate_from_dict(req["predicate"]) if req.get("predicate") else None
            with span("scan_window", after=req.get("after")) as sp:
                rows, nxt = read_one_page(
                    t, pred, req.get("projection"), req.get("after")
                )
                sp.set(rows=0 if rows is None else len(rows))
            # scan_rows deliberately NOT recorded (see _read): the
            # coordinator counts the streamed pages once on arrival.
        return {
            "ipc": rows_to_ipc(rows) if rows is not None else None,
            "next": nxt,
            "span": root_dict(trace),
            "ledger": sl.wire,
        }

    def _partial_agg(self, req: dict) -> dict:
        import time

        from ..query.partial import compute_partial

        t0 = time.perf_counter()
        trace_ctx = (req["spec"] or {}).get("trace")
        sl = serving_ledger((trace_ctx or {}).get("request_id"))
        with sl, serving_trace(
            trace_ctx, "remote_partial_agg", table=req["table"]
        ) as trace:
            t = self._open(req["table"])
            sub: dict = {}
            names, arrays = self._gated(
                req.get("admission") or (req["spec"] or {}).get("admission"),
                lambda: compute_partial(t, req["spec"], sub),
            )
        metrics = {
            **sub,
            "elapsed_ms": round((time.perf_counter() - t0) * 1000, 3),
            "groups": int(len(arrays[0])) if arrays else 0,
        }
        # Span ring keyed by the COORDINATOR'S request id (shipped in the
        # spec's trace): /debug/remote_spans on this node correlates with
        # the origin's slow-log/EXPLAIN ANALYZE by that id.
        with self.conn.remote_spans_lock:
            self.conn.remote_spans.append(
                {
                    "request_id": (trace_ctx or {}).get("request_id"),
                    "table": req["table"],
                    "at": time.time(),
                    **metrics,
                }
            )
        return {
            "ipc": columns_to_ipc(names, arrays),
            # stage metrics ride home for EXPLAIN ANALYZE (ref: the
            # reference's RemoteTaskContext.remote_metrics), and the span
            # subtree + cost ledger graft into the coordinator's
            "metrics": metrics,
            "span": root_dict(trace),
            "ledger": sl.wire,
        }

    def _execute_plan(self, req: dict) -> dict:
        """Execute a shipped plan subtree against a local table (ref:
        remote_engine_service handling of execute_physical_plan,
        server/src/grpc/remote_engine_service/mod.rs:928-1011). The wire
        carries the planned SELECT tree; this node re-binds it to its
        local table state and runs the full local execution path (device
        kernels included) — the coordinator receives finished output
        rows, not raw partition rows."""
        import time

        from ..query.planner import Planner
        from ..remote.plan_codec import select_from_wire
        from .codec import result_to_ipc

        t0 = time.perf_counter()
        name = req["table"]
        sl = serving_ledger((req.get("trace") or {}).get("request_id"))
        with sl, serving_trace(
            req.get("trace"), "remote_execute_plan", table=name
        ) as trace:
            t = self._open(name)
            select = select_from_wire(req["plan"])
            planner = Planner(
                lambda n: t.schema if n == name else self.conn.catalog.schema_of(n)
            )
            plan = planner.plan(select)
            executor = self.conn.interpreters.executor
            rs = self._gated(
                req.get("admission"), lambda: executor.execute(plan, t)
            )
        m = rs.metrics or {}
        metrics = {
            "elapsed_ms": round((time.perf_counter() - t0) * 1000, 3),
            "rows": rs.num_rows,
            **{k: m[k] for k in ("path", "scan_ms", "rows_scanned") if k in m},
        }
        with self.conn.remote_spans_lock:
            self.conn.remote_spans.append(
                {
                    "request_id": (req.get("trace") or {}).get("request_id"),
                    "table": name,
                    "op": "execute_plan",
                    "at": time.time(),
                    **metrics,
                }
            )
        return {
            "ipc": result_to_ipc(rs.names, rs.columns, rs.nulls),
            "metrics": metrics,
            "span": root_dict(trace),
            "ledger": sl.wire,
        }

    def _drop_sub(self, req: dict) -> dict:
        """Drop ONE partition's storage on its owning node — the logical
        DROP TABLE dispatches this for remote-owned partitions so nothing
        orphans in the shared store."""
        name = req["table"]
        if self.cluster is not None:
            self.cluster.forget_table(name)  # close the write fence NOW
        t = self.conn.catalog.open_sub_table(name)
        if t is None:
            return {"dropped": False}  # already gone: idempotent
        for data in t.physical_datas():
            self.conn.instance.drop_table(data)
        self.conn.catalog.forget(name)
        return {"dropped": True}

    # ---- storage (client-facing) ----------------------------------------
    def _sql_query(self, req: dict) -> dict:
        from ..query.interpreters import AffectedRows

        out = self.conn.execute(req["query"])
        if isinstance(out, AffectedRows):
            return {"affected": out.count}
        return {"rows": out.to_pylist()}


def _unary(fn):
    def handler(raw: bytes, context: grpc.ServicerContext) -> bytes:
        from ..utils.deadline import (
            DEADLINE_MARKER,
            DeadlineExceeded,
            QueryCancelled,
            serving_deadline,
        )

        try:
            req = unpack(raw)
            # Deadline propagation: the envelope carries the origin's
            # REMAINING budget. Already-expired work is refused before
            # doing any of it, and the handler's scan/kernel
            # checkpoints observe the budget while serving.
            with serving_deadline(
                req.get("deadline_ms") if isinstance(req, dict) else None
            ):
                return pack(fn(req))
        except _RpcError as e:
            context.abort(e.code, str(e))
        except (DeadlineExceeded, QueryCancelled) as e:
            # marked so the coordinator maps it back to ITS typed 504
            # (grpc also mints DEADLINE_EXCEEDED for client-side
            # timeouts; the marker distinguishes a deliberate refusal)
            context.abort(
                grpc.StatusCode.DEADLINE_EXCEEDED, f"{DEADLINE_MARKER}: {e}"
            )
        except KeyError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"missing field {e}")
        except Exception as e:
            logger.exception("rpc failed")
            context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")

    return grpc.unary_unary_rpc_method_handler(
        handler,
        request_deserializer=None,
        response_serializer=None,
    )
