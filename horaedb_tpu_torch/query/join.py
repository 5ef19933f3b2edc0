"""Equi-key joins on the host path
(ref: the reference gets JOIN from DataFusion, query_engine/src/
datafusion_impl/mod.rs:54 — this is the host-path subset: one or more
equi-keys ANDed; INNER / LEFT / RIGHT / FULL OUTER; arbitrary-length
chains folded left-to-right).

Vectorized hash-join shape: factorize each key-column pair into one code
space, fold multiple keys into a composite code (re-compacted per key so
the product never overflows), sort the right side by code, then expand
match pairs with repeat/cumsum arithmetic — no per-row Python. NULL keys
match nothing (SQL equality), including other NULLs. Outer variants are
the same match mirrored: unmatched-left rows ride with NULL right
columns, unmatched-right with NULL left columns, FULL with both; merged
key columns COALESCE(left, right) so an unmatched-right row still shows
its key. Joined rows feed the existing projection/WHERE/ORDER BY/LIMIT
machinery over a synthesized combined schema.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..common_types.dict_column import as_values, unique_inverse
from ..common_types.row_group import RowGroup
from ..common_types.schema import ColumnSchema, Schema
from . import ast
from .executor import ResultSet


class JoinError(ValueError):
    pass


def execute_join(catalog, executor, stmt: ast.Select) -> ResultSet:
    joins = [stmt.join, *stmt.joins]
    left_t = catalog.open(stmt.table)
    if left_t is None:
        raise JoinError(f"table not found: {stmt.table}")

    # Push the WHERE's time range + simple filters into the BASE scan
    # (the output timestamp IS the left one, so its conjuncts are left's;
    # exact WHERE still evaluates post-join). Sound only when no step is
    # RIGHT/FULL: dropping a base row early would turn its matches into
    # unmatched-right rows, changing which NULL-padded rows exist before
    # the exact WHERE runs.
    from .planner import extract_predicate

    push = all(j.kind in ("inner", "left") for j in joins)
    pred = extract_predicate(stmt.where, left_t.schema) if push else None
    rows = left_t.read(pred)

    for join in joins:
        right_t = catalog.open(join.table)
        if right_t is None:
            raise JoinError(f"table not found: {join.table}")
        rows = _join_step(rows, join, right_t.read(None), right_t.schema)

    # Reuse the projection pipeline: WHERE/ORDER/LIMIT over joined rows.
    from ..table_engine.predicate import Predicate
    from .plan import QueryPlan

    plan = QueryPlan(
        table="⋈".join([stmt.table, *(j.table for j in joins)]),
        schema=rows.schema,
        select=stmt,
        predicate=Predicate.all_time(),
        aggs=(),
        group_keys=(),
        is_aggregate=False,
    )
    # WHERE evaluates here exactly (the storage predicate never saw the
    # join): hand the projection a where-less statement so the residual
    # logic can't drop time conjuncts it assumes storage applied.
    if stmt.where is not None and len(rows):
        from .executor import eval_expr

        v, m = eval_expr(stmt.where, rows)
        rows = rows.filter(np.asarray(as_values(v)).astype(bool) & m)
    import dataclasses

    plan = dataclasses.replace(plan, select=dataclasses.replace(stmt, where=None))
    return executor._execute_projection(plan, rows)


def _visible(s: Schema) -> list[ColumnSchema]:
    tsid = s.columns[s.tsid_index].name if s.tsid_index is not None else None
    return [c for c in s.columns if c.name != tsid]


def _join_step(
    left: RowGroup, join: ast.Join, right: RowGroup, rs: Schema
) -> RowGroup:
    """One fold step: the combined rows so far ⋈ the next table."""
    ls = left.schema
    for col in join.left_cols:
        if not ls.has_column(col):
            raise JoinError(f"join key {col!r} not found on the left side")
    for col in join.right_cols:
        if not rs.has_column(col):
            raise JoinError(f"join key {col!r} not in {join.table}")

    lk, rk = _composite_codes(
        [as_values(left.column(c)) for c in join.left_cols],
        [as_values(right.column(c)) for c in join.right_cols],
    )
    # SQL equality: a NULL key matches NOTHING (not even another NULL) —
    # give each NULL-keyed row a unique code outside the shared space.
    l_valid = np.ones(len(lk), dtype=bool)
    for c in join.left_cols:
        l_valid &= left.valid_mask(c)
    r_valid = np.ones(len(rk), dtype=bool)
    for c in join.right_cols:
        r_valid &= right.valid_mask(c)
    if not l_valid.all() or not r_valid.all():
        base = int(max(lk.max(initial=0), rk.max(initial=0))) + 1
        lk = lk.copy()
        rk = rk.copy()
        l_bad = np.nonzero(~l_valid)[0]
        r_bad = np.nonzero(~r_valid)[0]
        lk[l_bad] = base + np.arange(len(l_bad))
        rk[r_bad] = base + len(l_bad) + np.arange(len(r_bad))

    li_idx, ri_idx = _inner_match(lk, rk)
    if join.kind in ("left", "full"):
        matched = np.zeros(len(lk), dtype=bool)
        matched[li_idx] = True
        unmatched = np.nonzero(~matched)[0]
        li_idx = np.concatenate([li_idx, unmatched])
        ri_idx = np.concatenate(
            [ri_idx, np.full(len(unmatched), -1, dtype=np.int64)]
        )
    if join.kind in ("right", "full"):
        # the mirrored mask: right rows no left row matched
        matched_r = np.zeros(len(rk), dtype=bool)
        matched_r[ri_idx[ri_idx >= 0]] = True
        unmatched_r = np.nonzero(~matched_r)[0]
        li_idx = np.concatenate(
            [li_idx, np.full(len(unmatched_r), -1, dtype=np.int64)]
        )
        ri_idx = np.concatenate([ri_idx, unmatched_r])

    # Combined schema: left columns + right non-key columns; internal tsid
    # columns stay out; name clashes (other than the key) are an error the
    # user resolves by renaming — qualified output names are not modeled.
    cols: list[ColumnSchema] = list(_visible(ls))
    names = {c.name for c in cols}
    for c in _visible(rs):
        if c.name in join.right_cols:
            continue  # merged into the left key columns (COALESCE)
        if c.name == rs.timestamp_name:
            # Every table carries a timestamp; the joined row keeps the
            # LEFT one (dimension-table joins don't want the right's).
            continue
        if c.name in names:
            raise JoinError(
                f"ambiguous column {c.name!r} on both sides of the join"
            )
        cols.append(c)

    combined_schema = Schema.build(
        [ColumnSchema(c.name, c.kind, is_tag=c.is_tag) for c in cols],
        timestamp_column=ls.timestamp_name,
        primary_key=[*join.left_cols, ls.timestamp_name],
    )
    n_out = len(li_idx)
    null_left = li_idx < 0  # RIGHT/FULL: rows with no left-side match
    null_right = ri_idx < 0  # LEFT/FULL: rows with no right-side match
    li_safe = np.where(null_left, 0, li_idx)
    ri_safe = np.where(null_right, 0, ri_idx)
    key_merge = dict(zip(join.left_cols, join.right_cols))

    data = {}
    validity = {}
    for c in _visible(ls):
        fill = np.full(n_out, c.kind.default_value(), dtype=c.kind.numpy_dtype)
        lvals = as_values(left.column(c.name))
        taken = fill if len(lvals) == 0 else np.where(
            null_left, fill, lvals[li_safe]
        )
        lm = (
            np.zeros(n_out, dtype=bool)
            if len(lvals) == 0
            else left.valid_mask(c.name)[li_safe] & ~null_left
        )
        if c.name in key_merge:
            # merged key column: COALESCE(left, right) — an unmatched
            # right row still shows the key it joined on.
            rvals = as_values(right.column(key_merge[c.name]))
            if len(rvals):
                rtaken = rvals[ri_safe]
                rm = right.valid_mask(key_merge[c.name])[ri_safe] & ~null_right
                taken = np.where(null_left, rtaken, taken)
                lm = np.where(null_left, rm, lm)
        data[c.name] = taken
        if not lm.all():
            validity[c.name] = lm
    for c in _visible(rs):
        if c.name in join.right_cols or c.name == rs.timestamp_name:
            continue
        vals = as_values(right.column(c.name))
        # NULL slots carry the column kind's default fill (the engine-wide
        # convention — see RowGroup) so downstream comparisons/sorts see a
        # well-typed value, never an arbitrary row-0 leak.
        fill = np.full(n_out, c.kind.default_value(), dtype=c.kind.numpy_dtype)
        if len(vals) == 0:
            data[c.name] = fill
            validity[c.name] = np.zeros(n_out, dtype=bool)
            continue
        data[c.name] = np.where(null_right, fill, vals[ri_safe])
        m = right.valid_mask(c.name)[ri_safe] & ~null_right
        if not m.all():
            validity[c.name] = m
    # Schema.build may prepend a tsid column; fill it (unused downstream).
    if combined_schema.tsid_index is not None:
        tsid_name = combined_schema.columns[combined_schema.tsid_index].name
        if tsid_name not in data:
            data[tsid_name] = np.zeros(n_out, dtype=np.uint64)
    return RowGroup(combined_schema, data, validity)


def _composite_codes(
    l_cols: list[np.ndarray], r_cols: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """Fold N key-column pairs into one integer code per row such that
    composite codes are equal iff every key column is equal.

    Per key: factorize left+right jointly, then composite = prior * card
    + code. The composite is RE-COMPACTED after each key (unique over at
    most n_l + n_r values), so the running product stays bounded by
    (n_l + n_r) * card and cannot overflow int64 for any realistic input.
    """
    n_l = len(l_cols[0])
    comp: Optional[np.ndarray] = None
    for lk, rk in zip(l_cols, r_cols):
        _, codes = unique_inverse(np.concatenate([lk, rk]))
        codes = codes.astype(np.int64)
        if comp is None:
            comp = codes
            continue
        card = int(codes.max()) + 1 if len(codes) else 1
        comp = comp * card + codes
        _, comp = np.unique(comp, return_inverse=True)
    assert comp is not None
    return comp[:n_l], comp[n_l:]


def _inner_match(lk: np.ndarray, rk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Index pairs (li, ri) of every equal-code combination; ``lk``/``rk``
    are already in one shared code space (see _composite_codes)."""
    n_l = len(lk)
    lc, rc = lk, rk
    order_r = np.argsort(rc, kind="stable")
    rc_sorted = rc[order_r]
    # for each left row: the contiguous run of matching right rows
    starts = np.searchsorted(rc_sorted, lc, side="left")
    ends = np.searchsorted(rc_sorted, lc, side="right")
    counts = ends - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    li = np.repeat(np.arange(n_l, dtype=np.int64), counts)
    # within-run offsets: global arange minus each row's run start
    run_starts = np.repeat(np.cumsum(counts) - counts, counts)
    offsets = np.arange(total, dtype=np.int64) - run_starts
    ri = order_r[np.repeat(starts, counts) + offsets]
    return li, ri
