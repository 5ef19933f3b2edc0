"""Hierarchical request tracing — a span tree follows the query across
threads and nodes (ref: trace_metric's MetricsCollector span trees +
RemoteTaskContext.remote_metrics carrying EXPLAIN ANALYZE data home;
RequestId in common_types).

A ContextVar pair holds the current ``Trace`` and ``Span``; the proxy
starts one trace per SQL statement and runs the executor inside a copied
context so priority-pool threads observe it. ``span("name", **attrs)``
opens a child of the current span (a cheap no-op when no trace is
active — the hot path pays O(spans) only while a sink is attached).

Cross-node: ``wire_context()`` serializes ``(trace_id, parent_span_id)``
into the RPC envelope; the owning node serves the call under
``serving_trace(...)`` and ships its finished subtree back in the
response, where ``graft(...)`` attaches it to the coordinator's tree —
one request id correlates the coordinator's slow-log/EXPLAIN ANALYZE
tree with every remote span it fanned out.

Finished traces land in the bounded in-process ``TRACE_STORE`` (ring of
recent + ring of slow), surfaced at /debug/trace and
/debug/trace/{request_id}.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator, Optional

# ---- flat request id (set by start_trace; wire_context falls back to it
# when no span tree is active) ---------------------------------------------

_request_id: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "horaedb_request_id", default=None
)


def get_request_id() -> Optional[int]:
    return _request_id.get()


# ---- span tree -----------------------------------------------------------

# Bounds: a runaway loop opening spans (or a hostile remote payload) must
# not grow a request tree without limit — extra children are counted, not
# stored, and remote grafts are depth/width-clipped on arrival.
MAX_CHILDREN = 128
MAX_GRAFT_DEPTH = 8


class Span:
    __slots__ = (
        "span_id", "parent_id", "name", "start_at", "_t0",
        "duration_ms", "attrs", "children", "dropped_children",
    )

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 attrs: Optional[dict] = None) -> None:
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_at = time.time()
        self._t0 = time.perf_counter()
        self.duration_ms: Optional[float] = None  # None = still open
        self.attrs: dict = attrs or {}
        self.children: list[Span] = []
        self.dropped_children = 0

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes (stage metrics, row counts, paths)."""
        self.attrs.update(attrs)
        return self

    def finish(self) -> None:
        if self.duration_ms is None:
            self.duration_ms = round((time.perf_counter() - self._t0) * 1000, 3)

    def to_dict(self) -> dict:
        d: dict = {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_at": round(self.start_at, 6),
            "duration_ms": self.duration_ms,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        if self.dropped_children:
            d["dropped_children"] = self.dropped_children
        return d


class _NullSpan:
    """What ``span()`` yields when no trace is active: absorbs .set()."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def finish(self) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Trace:
    """One request's span tree. Child creation/grafting is locked — the
    scatter pool and gRPC callbacks append from several threads."""

    def __init__(self, trace_id, name: str = "request",
                 attrs: Optional[dict] = None) -> None:
        self.trace_id = trace_id
        self._lock = threading.Lock()
        self._ids = itertools.count(2)
        self.root = Span(1, None, name, attrs)
        # profile-plane tags (obs/profile key dimensions): the serving
        # plane (query/ingest/ddl/flush/compaction/rules) and the
        # normalized plan-key class. Set via tag_trace once known.
        self.route = ""
        self.shape = ""

    def new_span(self, parent: Span, name: str,
                 attrs: Optional[dict] = None) -> Optional[Span]:
        with self._lock:
            if len(parent.children) >= MAX_CHILDREN:
                parent.dropped_children += 1
                return None
            s = Span(next(self._ids), parent.span_id, name, attrs)
            parent.children.append(s)
            return s

    def graft(self, parent: Span, remote: dict,
              attrs: Optional[dict] = None) -> None:
        """Attach a remote node's serialized subtree under ``parent``,
        re-numbering span ids into this trace (depth/width bounded)."""
        if not isinstance(remote, dict):
            return
        with self._lock:
            self._graft_locked(parent, remote, attrs, depth=0)

    def _graft_locked(self, parent: Span, node: dict,
                      extra: Optional[dict], depth: int) -> None:
        if depth >= MAX_GRAFT_DEPTH or len(parent.children) >= MAX_CHILDREN:
            parent.dropped_children += 1
            return
        s = Span(next(self._ids), parent.span_id, str(node.get("name", "remote")))
        a = node.get("attrs")
        if isinstance(a, dict):
            s.attrs.update(a)
        s.attrs.setdefault("origin", "remote")
        if extra:
            s.attrs.update(extra)
        start = node.get("start_at")
        if isinstance(start, (int, float)):
            s.start_at = float(start)
        dur = node.get("duration_ms")
        s.duration_ms = float(dur) if isinstance(dur, (int, float)) else 0.0
        parent.children.append(s)
        kids = node.get("children")
        if isinstance(kids, list):
            for k in kids[:MAX_CHILDREN]:
                if isinstance(k, dict):
                    self._graft_locked(s, k, None, depth + 1)
            if len(kids) > MAX_CHILDREN:
                s.dropped_children += len(kids) - MAX_CHILDREN
        drop = node.get("dropped_children")
        if isinstance(drop, int):
            s.dropped_children += drop

    def num_spans(self) -> int:
        def count(s: Span) -> int:
            return 1 + sum(count(c) for c in s.children)

        with self._lock:
            return count(self.root)

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "trace_id": self.trace_id,
                "root": self.root.to_dict(),
            }


_current_trace: contextvars.ContextVar[Optional[Trace]] = contextvars.ContextVar(
    "horaedb_trace", default=None
)
_current_span: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "horaedb_span", default=None
)


def current_trace() -> Optional[Trace]:
    return _current_trace.get()


def current_span() -> Optional[Span]:
    trace = _current_trace.get()
    if trace is None:
        return None
    return _current_span.get() or trace.root


def start_trace(trace_id, name: str = "request", **attrs: Any):
    """Begin a trace in the current context. Returns ``(trace, handle)``;
    pass the handle to ``finish_trace``."""
    trace = Trace(trace_id, name, attrs or None)
    tokens = (
        _current_trace.set(trace),
        _current_span.set(trace.root),
        _request_id.set(trace_id),
    )
    return trace, tokens


def tag_trace(route: Optional[str] = None, shape: Optional[str] = None) -> None:
    """Stamp the current trace's profile-plane dimensions (no-op outside
    a trace). The proxy tags by plan kind after parse; background planes
    tag at round start."""
    trace = _current_trace.get()
    if trace is None:
        return
    if route is not None:
        trace.route = route
    if shape is not None:
        trace.shape = shape


def finish_trace(handle, record: bool = True, slow: bool = False) -> None:
    """End the trace started with ``start_trace`` and (by default) record
    its snapshot in the global TRACE_STORE and fold it into the profile
    aggregator (obs/profile). ``record=False`` (serving_trace) skips
    BOTH: the subtree ships home and folds once, at the coordinator —
    never double-counted fleetwide."""
    t_tok, s_tok, r_tok = handle
    trace = _current_trace.get()
    _current_trace.reset(t_tok)
    _current_span.reset(s_tok)
    _request_id.reset(r_tok)
    if trace is None:
        return
    trace.root.finish()
    if record:
        root = trace.to_dict()["root"]  # ONE locked walk per request
        TRACE_STORE.record_snapshot(trace.trace_id, root, slow=slow)
        try:
            from ..obs.profile import fold_trace

            fold_trace(trace.trace_id, root,
                       route=trace.route, shape=trace.shape)
        except Exception:
            pass  # profiling must never fail the request


@contextmanager
def span(name: str, **attrs: Any):
    """Open a child span of the current one. Usable from sync and async
    code (ContextVars follow the task/thread context). No active trace →
    yields a shared no-op span and touches nothing."""
    trace = _current_trace.get()
    if trace is None:
        yield _NULL_SPAN
        return
    parent = _current_span.get() or trace.root
    s = trace.new_span(parent, name, attrs or None)
    if s is None:  # parent full: drop quietly, bound enforced
        yield _NULL_SPAN
        return
    token = _current_span.set(s)
    try:
        yield s
    finally:
        s.finish()
        _current_span.reset(token)


_bg_trace_ids = itertools.count(1)


@contextmanager
def owned_trace(name: str, route: str = "", shape: str = "", **attrs: Any):
    """A background plane's own trace round (flush, compaction, rules):
    starts a trace so the plane's spans fold into the profile aggregator
    through the SAME machinery as queries. If a trace is already active
    (a foreground-requested flush inside a request), opens a child span
    instead — never shadows the request's tree. Yields the root/child
    span (supports ``.set``)."""
    if _current_trace.get() is not None:
        with span(name, **attrs) as s:
            yield s
        return
    tid = f"{name}-{next(_bg_trace_ids)}"
    trace, handle = start_trace(tid, name, **attrs)
    trace.route = route or name
    trace.shape = shape
    try:
        yield trace.root
    finally:
        finish_trace(handle)


def annotate(**attrs: Any) -> None:
    """Attach attributes to the current span (no-op outside a trace)."""
    s = current_span()
    if s is not None:
        s.set(**attrs)


def wire_context() -> Optional[dict]:
    """The trace context an RPC envelope ships to a partition owner:
    ``{request_id, trace_id, parent_span_id}``. Outside a trace, falls
    back to the flat request id (older envelope shape); None when neither
    is set."""
    trace = _current_trace.get()
    if trace is None:
        rid = _request_id.get()
        return {"request_id": rid} if rid is not None else None
    parent = _current_span.get() or trace.root
    return {
        "request_id": trace.trace_id,
        "trace_id": trace.trace_id,
        "parent_span_id": parent.span_id,
    }


def graft(remote_span: Optional[dict], **attrs: Any) -> None:
    """Attach a remote node's serialized span tree (an RPC response's
    ``span`` field) under the current span. No-op outside a trace."""
    if remote_span is None:
        return
    trace = _current_trace.get()
    if trace is None:
        return
    parent = _current_span.get() or trace.root
    trace.graft(parent, remote_span, attrs or None)


@contextmanager
def serving_trace(trace_ctx: Optional[dict], name: str, **attrs: Any) -> Iterator[Optional[Trace]]:
    """Serve an RPC under a detached trace carrying the ORIGIN's trace id
    (ref: RemoteTaskContext). The handler runs with span() active; the
    finished root ships back in the response via ``root_dict(trace)``.
    ``trace_ctx`` None (old peer, no trace at origin) → no tracing."""
    if not isinstance(trace_ctx, dict) or (
        trace_ctx.get("trace_id") is None and trace_ctx.get("request_id") is None
    ):
        yield None
        return
    tid = trace_ctx.get("trace_id", trace_ctx.get("request_id"))
    trace, handle = start_trace(tid, name, **attrs)
    try:
        yield trace
    finally:
        # Remote subtrees ship home in the RPC response; recording them
        # locally too would double-count them in this node's store.
        finish_trace(handle, record=False)


def root_dict(trace: Optional[Trace]) -> Optional[dict]:
    """Serialize a serving_trace's tree for the RPC response."""
    if trace is None:
        return None
    trace.root.finish()
    return trace.to_dict()["root"]


# ---- trace store ---------------------------------------------------------


class TraceStore:
    """Bounded in-process sink: a ring of recent traces plus a (larger)
    ring of slow ones — sustained load can never grow it without bound.
    Stores SNAPSHOTS (dicts), so later mutation of a live trace (or ring
    eviction) never races a /debug/trace reader."""

    def __init__(self, recent: int = 64, slow: int = 256) -> None:
        from collections import deque

        self._recent: "deque[dict]" = deque(maxlen=recent)
        self._slow: "deque[dict]" = deque(maxlen=slow)
        self._lock = threading.Lock()

    def record(self, trace: Trace, slow: bool = False) -> None:
        trace.root.finish()
        self.record_snapshot(trace.trace_id, trace.to_dict()["root"],
                             slow=slow)

    def record_snapshot(self, trace_id, root: dict, slow: bool = False) -> None:
        """Record an already-serialized root (finish_trace snapshots once
        and shares the walk with the profile fold)."""

        def count(node: dict) -> int:
            return 1 + sum(count(c) for c in node.get("children", ()))

        entry = {
            "trace_id": trace_id,
            "name": root["name"],
            "at": root["start_at"],
            "duration_ms": root["duration_ms"],
            "spans": count(root),
            "slow": bool(slow),
            "root": root,
        }
        with self._lock:
            self._recent.append(entry)
            if slow:
                self._slow.append(entry)

    def get(self, trace_id) -> Optional[dict]:
        with self._lock:
            # newest wins on id reuse (per-proxy counters restart at 1)
            for ring in (self._recent, self._slow):
                for entry in reversed(ring):
                    if entry["trace_id"] == trace_id:
                        return entry
        return None

    def list(self) -> list[dict]:
        with self._lock:
            seen: set[int] = set()
            out: list[dict] = []
            for entry in (*reversed(self._recent), *reversed(self._slow)):
                if id(entry) in seen:
                    continue
                seen.add(id(entry))
                out.append({k: entry[k] for k in
                            ("trace_id", "name", "at", "duration_ms", "spans", "slow")})
            return out

    def resize(self, recent: Optional[int] = None,
               slow: Optional[int] = None) -> None:
        """Apply the [observability] trace_ring / trace_slow_ring knobs;
        shrinking drops oldest entries (deque maxlen semantics)."""
        from collections import deque

        with self._lock:
            if recent is not None and recent != self._recent.maxlen:
                self._recent = deque(self._recent, maxlen=max(1, int(recent)))
            if slow is not None and slow != self._slow.maxlen:
                self._slow = deque(self._slow, maxlen=max(1, int(slow)))

    def sizes(self) -> tuple[int, int]:
        return self._recent.maxlen or 0, self._slow.maxlen or 0

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._slow.clear()


TRACE_STORE = TraceStore()


def render_tree(node: dict, indent: int = 0) -> list[str]:
    """Render a serialized span tree as indented text lines — what
    EXPLAIN ANALYZE prints under its plan (ref: trace_metric's formatted
    collector output)."""
    dur = node.get("duration_ms")
    dur_s = f"{dur:.3f}ms" if isinstance(dur, (int, float)) else "…"
    attrs = node.get("attrs") or {}
    label = str(node.get("name", "?"))
    if attrs.get("origin") == "remote":
        ep = attrs.get("endpoint")
        label = f"[remote{' ' + str(ep) if ep else ''}] {label}"
    detail = " ".join(
        f"{k}={v}" for k, v in attrs.items()
        if k not in ("origin", "endpoint") and not isinstance(v, (dict, list))
    )
    line = "  " * indent + f"{label} {dur_s}" + (f" {detail}" if detail else "")
    out = [line]
    for child in node.get("children", ()):  # already bounded at insert
        out.extend(render_tree(child, indent + 1))
    dropped = node.get("dropped_children")
    if dropped:
        out.append("  " * (indent + 1) + f"(+{dropped} spans dropped)")
    return out
