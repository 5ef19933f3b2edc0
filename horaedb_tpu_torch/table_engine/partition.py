"""Partition rules + the partitioned virtual table
(ref: src/table_engine/src/partition/{mod.rs:90-136,rule/}, and
src/partition_table_engine/src/{partition.rs,scan_builder.rs}).

A partitioned table is a logical table over N physical sub-tables:

- writes split by the rule — ONE vectorized pass computes every row's
  partition (ref fans out row-by-row; here the rule maps dense columns);
- reads scatter to the sub-tables and either concatenate rows or (for
  aggregates) combine per-partition partial AggStates — the same monoid
  the mesh collectives use, so a partition maps 1:1 onto a future shard.

Rules (mirroring the reference's three):
- ``KeyRule``    — hash of key tag columns mod N (default for PARTITION BY KEY)
- ``HashRule``   — hash of an integer column mod N
- ``RandomRule`` — round-robin-ish scatter for append-only workloads
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Sequence

import numpy as np

from ..common_types.row_group import RowGroup
from ..common_types.schema import Schema, compute_tsid
from ..engine.options import TableOptions, UpdateMode
from .predicate import ColumnFilter, FilterOp, Predicate
from .table import Table


class PartitionRule(ABC):
    def __init__(self, columns: tuple[str, ...], num_partitions: int) -> None:
        if num_partitions <= 0:
            raise ValueError("num_partitions must be positive")
        self.columns = columns
        self.num_partitions = num_partitions

    @abstractmethod
    def partition_of_rows(self, rows: RowGroup) -> np.ndarray:
        """int partition id per row (vectorized)."""

    def prune(self, predicate: Predicate) -> Optional[list[int]]:
        """Partitions that may match, or None = all.

        Only exact-equality (EQ on every rule column, or IN) can prune —
        same as the reference's rule-based locate-for-read.
        """
        return None

    def to_dict(self) -> dict:
        return {
            "method": self.method,
            "columns": list(self.columns),
            "num_partitions": self.num_partitions,
        }


class KeyRule(PartitionRule):
    """Hash of the named key/tag column values (ref: rule/key.rs)."""

    method = "key"

    def partition_of_rows(self, rows: RowGroup) -> np.ndarray:
        cols = [rows.column(c) for c in self.columns]
        h = compute_tsid(cols, num_rows=len(rows))
        return (h % np.uint64(self.num_partitions)).astype(np.int64)

    def partition_of_values(self, values: Sequence) -> int:
        arrays = [np.array([v], dtype=object) for v in values]
        h = compute_tsid(arrays, num_rows=1)
        return int(h[0] % np.uint64(self.num_partitions))

    def prune(self, predicate: Predicate) -> Optional[list[int]]:
        # Need an EQ (or IN) constraint on EVERY rule column.
        per_col: list[list] = []
        for c in self.columns:
            eqs = [f for f in predicate.filters_on(c) if f.op is FilterOp.EQ]
            ins = [f for f in predicate.filters_on(c) if f.op is FilterOp.IN]
            if eqs:
                per_col.append([eqs[0].value])
            elif ins:
                per_col.append(list(ins[0].value))
            else:
                return None
        import itertools

        parts = {
            self.partition_of_values(combo)
            for combo in itertools.product(*per_col)
        }
        return sorted(parts)


class HashRule(PartitionRule):
    """Modulo hash of one integer column (ref: rule/hash.rs linear hash)."""

    method = "hash"

    def __init__(self, columns: tuple[str, ...], num_partitions: int) -> None:
        if len(columns) != 1:
            raise ValueError("HashRule takes exactly one column")
        super().__init__(columns, num_partitions)

    def partition_of_rows(self, rows: RowGroup) -> np.ndarray:
        col = rows.column(self.columns[0])
        return (col.astype(np.int64) % self.num_partitions + self.num_partitions) % self.num_partitions

    def prune(self, predicate: Predicate) -> Optional[list[int]]:
        eqs = [f for f in predicate.filters_on(self.columns[0]) if f.op is FilterOp.EQ]
        if not eqs:
            return None
        v = int(eqs[0].value)
        return [(v % self.num_partitions + self.num_partitions) % self.num_partitions]


class RandomRule(PartitionRule):
    """Scatter without locate support — append-only tables only."""

    method = "random"

    def partition_of_rows(self, rows: RowGroup) -> np.ndarray:
        return np.random.default_rng().integers(0, self.num_partitions, len(rows))


def make_rule(method: str, columns: Sequence[str], num_partitions: int) -> PartitionRule:
    m = method.lower()
    if m == "key":
        return KeyRule(tuple(columns), num_partitions)
    if m == "hash":
        return HashRule(tuple(columns), num_partitions)
    if m == "random":
        return RandomRule(tuple(columns), num_partitions)
    raise ValueError(f"unknown partition method {method!r}")


def sub_table_name(table: str, partition: int) -> str:
    """Reference naming: __<table>_<partition> (partition.rs sub tables)."""
    return f"__{table}_{partition}"


class PartitionedTable(Table):
    def __init__(
        self,
        name: str,
        rule: PartitionRule,
        sub_tables: list[Table],
    ) -> None:
        if len(sub_tables) != rule.num_partitions:
            raise ValueError("sub table count != num_partitions")
        self._name = name
        self.rule = rule
        self.sub_tables = sub_tables

    @property
    def name(self) -> str:
        return self._name

    @property
    def schema(self) -> Schema:
        return self.sub_tables[0].schema

    @property
    def options(self) -> TableOptions:
        return self.sub_tables[0].options

    # ---- scatter write --------------------------------------------------
    def write(self, rows: RowGroup) -> int:
        parts = self.rule.partition_of_rows(rows)
        for p in np.unique(parts):
            idx = np.nonzero(parts == p)[0]
            self.sub_tables[int(p)].write(rows.take(idx))
        return len(rows)

    # ---- scatter/gather read --------------------------------------------
    def read(self, predicate=None, projection=None) -> RowGroup:
        predicate = predicate or Predicate.all_time()
        keep = self.rule.prune(predicate)
        targets = (
            self.sub_tables
            if keep is None
            else [self.sub_tables[i] for i in keep]
        )
        from ..utils.querystats import record as _qs_record

        _qs_record(fanout=len(targets))
        parts = [t.read(predicate, projection) for t in targets]
        non_empty = [p for p in parts if len(p)]
        if not non_empty:
            return parts[0]  # empty, right schema — already fetched
        return RowGroup.concat(non_empty)

    def partial_agg(self, spec: dict):
        """Scatter the pushed-down aggregate to every (unpruned) partition
        — each runs against its OWN data, remote ones across the wire —
        and concatenate the partial batches (combining stays associative,
        so the caller's single final combine still works)."""
        from ..remote.codec import predicate_from_dict
        from ..utils.runtime import scatter_pool

        keep = self.rule.prune(predicate_from_dict(spec["predicate"]))
        targets = (
            self.sub_tables if keep is None else [self.sub_tables[i] for i in keep]
        )
        from ..utils.querystats import record as _qs_record

        _qs_record(fanout=len(targets))
        if len(targets) == 1:
            return targets[0].partial_agg(spec)
        import contextvars

        from ..utils.tracectx import span

        def one(t):
            # copied context per task: partition spans (and remote span
            # grafts from the wire) attach under the coordinator's tree
            with span("partition", partition=t.name):
                return t.partial_agg(spec)

        ctxs = [contextvars.copy_context() for _ in targets]
        parts = list(
            scatter_pool().map(
                lambda ct: ct[0].run(one, ct[1]), zip(ctxs, targets)
            )
        )
        names = None
        merged: dict[str, list] = {}
        stage_metrics: list = []
        for p_names, p_arrays, p_metrics in parts:
            stage_metrics.extend(p_metrics)
            if not len(p_arrays) or not len(p_arrays[0]):
                continue
            names = p_names
            for nm, arr in zip(p_names, p_arrays):
                merged.setdefault(nm, []).append(arr)
        if names is None:
            return parts[0][0], parts[0][1], stage_metrics
        return names, [np.concatenate(merged[nm]) for nm in names], stage_metrics

    def flush(self) -> None:
        for t in self.sub_tables:
            t.flush()

    def compact(self) -> None:
        for t in self.sub_tables:
            t.compact()

    def alter_schema(self, schema: Schema) -> None:
        for t in self.sub_tables:
            t.alter_schema(schema)

    def alter_options(self, options: TableOptions) -> None:
        for t in self.sub_tables:
            t.alter_options(options)

    def physical_datas(self) -> list:
        return [d for t in self.sub_tables for d in t.physical_datas()]

    def metrics(self) -> dict:
        subs = [t.metrics() for t in self.sub_tables]
        return {
            "table": self._name,
            "partitions": len(subs),
            "memtable_bytes": sum(m.get("memtable_bytes", 0) for m in subs),
            "num_ssts": sum(m.get("num_ssts", 0) for m in subs),
            "sst_bytes": sum(m.get("sst_bytes", 0) for m in subs),
        }
