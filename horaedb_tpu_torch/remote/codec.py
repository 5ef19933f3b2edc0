"""Wire codec: msgpack envelopes + arrow IPC payloads
(ref: components/arrow_ext ipc helpers used by the remote engine RPCs).

Everything row-shaped crosses the wire as ONE arrow IPC stream; small
control structures (predicates, agg specs, schemas) ride msgpack. Partial
aggregates are themselves a record batch — group key values + bucket
starts + the (count, sum, min, max) monoid per aggregated column — so the
final combine is a tiny group-by at the coordinator (the reference ships
DataFusion partial-agg batches the same way, resolver.rs:76-104).
"""

from __future__ import annotations

import io
from typing import Optional, Sequence

import msgpack
import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc

from ..common_types.row_group import RowGroup
from ..common_types.schema import Schema
from ..common_types.time_range import TimeRange
from ..table_engine.predicate import ColumnFilter, FilterOp, Predicate


def pack(obj: dict) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def unpack(raw: bytes) -> dict:
    return msgpack.unpackb(raw, raw=False, strict_map_key=False)


# ---- RowGroup <-> arrow IPC ---------------------------------------------


def rows_to_ipc(rows: RowGroup) -> bytes:
    batch = rows.to_arrow()
    sink = io.BytesIO()
    with ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    return sink.getvalue()


def rows_from_ipc(schema: Schema, raw: bytes) -> RowGroup:
    with ipc.open_stream(io.BytesIO(raw)) as r:
        table = r.read_all()
    return RowGroup.from_arrow(schema, table)


# ---- arbitrary column dict <-> arrow IPC (partial aggregates) ------------


def columns_to_ipc(names: Sequence[str], arrays: Sequence[np.ndarray]) -> bytes:
    cols = [pa.array(a) for a in arrays]
    batch = pa.record_batch(cols, names=list(names))
    sink = io.BytesIO()
    with ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    return sink.getvalue()


def columns_from_ipc(raw: bytes) -> tuple[list[str], list[np.ndarray]]:
    with ipc.open_stream(io.BytesIO(raw)) as r:
        table = r.read_all()
    names = list(table.schema.names)
    arrays = []
    for i in range(table.num_columns):
        col = table.column(i)
        if pa.types.is_string(col.type) or pa.types.is_large_string(col.type):
            arrays.append(np.asarray(col.to_pylist(), dtype=object))
        else:
            arrays.append(col.to_numpy(zero_copy_only=False))
    return names, arrays


# ---- result set (named columns + NULL masks) <-> arrow IPC ----------------


def result_to_ipc(
    names: Sequence[str],
    columns: Sequence[np.ndarray],
    nulls: Optional[dict] = None,
) -> bytes:
    """Arbitrary query output with per-column NULL masks — arrow carries
    validity natively, so the masks ride in-band (used by ExecutePlan)."""
    cols = []
    for name, a in zip(names, columns):
        mask = (nulls or {}).get(name)
        if mask is not None:
            cols.append(pa.array(a, mask=np.asarray(mask, dtype=bool)))
        else:
            cols.append(pa.array(a))
    batch = pa.record_batch(cols, names=list(names))
    sink = io.BytesIO()
    with ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
    return sink.getvalue()


def result_from_ipc(raw: bytes) -> tuple[list[str], list[np.ndarray], dict]:
    """-> (names, columns, nulls). NULL slots are filled with the column
    kind's neutral value and reported through the mask (the ResultSet
    convention)."""
    import pyarrow.compute as pc

    with ipc.open_stream(io.BytesIO(raw)) as r:
        table = r.read_all()
    names = list(table.schema.names)
    columns: list[np.ndarray] = []
    nulls: dict[str, np.ndarray] = {}
    for i, name in enumerate(names):
        col = table.column(i).combine_chunks()
        if col.null_count:
            nulls[name] = np.asarray(col.is_null())
        t = col.type
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            filled = pc.fill_null(col, "") if col.null_count else col
            columns.append(np.asarray(filled.to_pylist(), dtype=object))
        elif pa.types.is_null(t):
            nulls[name] = np.ones(len(col), dtype=bool)
            columns.append(np.zeros(len(col), dtype=object))
        else:
            fill = False if pa.types.is_boolean(t) else 0
            filled = pc.fill_null(col, fill) if col.null_count else col
            columns.append(filled.to_numpy(zero_copy_only=False))
    return names, columns, nulls


# ---- predicate ------------------------------------------------------------


def predicate_to_dict(p: Predicate) -> dict:
    return {
        "time_range": [int(p.time_range.inclusive_start), int(p.time_range.exclusive_end)],
        "filters": [[f.column, f.op.value, _plain(f.value)] for f in p.filters],
        "limit": p.limit,
    }


def predicate_from_dict(d: dict) -> Predicate:
    lo, hi = d["time_range"]
    filters = tuple(
        ColumnFilter(c, FilterOp(op), tuple(v) if isinstance(v, list) else v)
        for c, op, v in d.get("filters", ())
    )
    return Predicate(TimeRange(lo, hi), filters, d.get("limit"))


def _plain(v):
    if isinstance(v, (np.generic,)):
        return v.item()
    if isinstance(v, tuple):
        return [_plain(x) for x in v]
    return v
