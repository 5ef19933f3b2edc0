"""Plan-subtree wire codec — ship query plans, not raw rows
(ref: df_engine_extensions/src/dist_sql_query/codec.rs — the reference
serializes DataFusion physical plan subtrees as protobuf;
remote_engine_client/src/client.rs:484 ``execute_physical_plan``).

Here the shipped unit is the planned SELECT tree (``ast.Select`` —
expressions, window specs, order keys, limits) encoded as tagged msgpack
maps. Our physical execution derives deterministically from this tree
plus the owning table's local state, so shipping the logical tree gives
the receiving node everything the reference's physical subtree carries —
without pinning the wire format to executor internals (the receiver is
free to pick its own device path, exactly like a fresh local query).

Every AST node encodes as ``{"_": ClassName, field: value, ...}``;
tuples ride as msgpack lists and decode back to tuples (all AST
sequence fields are tuples). Nodes that embed local runtime state
(materialized subquery lookups) or other tables (joins, CTEs) refuse to
encode with ``PlanNotShippable`` — the distributed planner falls back to
row shipping for those shapes.
"""

from __future__ import annotations

from dataclasses import fields, is_dataclass

from ..query import ast


class PlanNotShippable(Exception):
    """This plan shape cannot cross the wire (embedded runtime state or
    multi-table references) — callers fall back to raw-row pulls."""


# The shippable node set. Anything outside it (Subquery, InSubquery,
# CorrelatedLookup — pre-materialization or holding host lookup state)
# refuses loudly rather than shipping something the peer can't rebuild.
_NODES = {
    cls.__name__: cls
    for cls in (
        ast.Column,
        ast.Literal,
        ast.BinaryOp,
        ast.UnaryOp,
        ast.Case,
        ast.Cast,
        ast.Like,
        ast.FuncCall,
        ast.Star,
        ast.InList,
        ast.WindowSpec,
        ast.WindowFunc,
        ast.Between,
        ast.IsNull,
        ast.SelectItem,
        ast.OrderItem,
        ast.Select,
    )
}

_PLAIN = (str, int, float, bool, type(None))


def select_to_wire(node) -> dict:
    """Encode a Select tree (raises PlanNotShippable on non-wire nodes)."""
    return _encode(node)


def select_from_wire(obj: dict) -> "ast.Select":
    sel = _decode(obj)
    if not isinstance(sel, ast.Select):
        raise ValueError(f"wire plan is not a Select: {type(sel).__name__}")
    return sel


def _encode(v):
    if isinstance(v, _PLAIN):
        return v
    if isinstance(v, (tuple, list)):
        return [_encode(x) for x in v]
    if is_dataclass(v):
        name = type(v).__name__
        cls = _NODES.get(name)
        if cls is None or type(v) is not cls:
            raise PlanNotShippable(f"non-shippable plan node: {name}")
        out = {"_": name}
        for f in fields(v):
            out[f.name] = _encode(getattr(v, f.name))
        return out
    raise PlanNotShippable(f"non-shippable plan value: {type(v).__name__}")


def _decode(v):
    if isinstance(v, _PLAIN):
        return v
    if isinstance(v, list):
        return tuple(_decode(x) for x in v)
    if isinstance(v, dict):
        name = v.get("_")
        cls = _NODES.get(name)
        if cls is None:
            raise ValueError(f"unknown plan node on wire: {name!r}")
        kwargs = {k: _decode(x) for k, x in v.items() if k != "_"}
        return cls(**kwargs)
    raise ValueError(f"undecodable wire value: {type(v).__name__}")
