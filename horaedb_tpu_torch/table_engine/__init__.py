"""Table abstraction layer (ref: src/table_engine).

``Table``/``TableEngine`` interfaces, read/write request types, predicates
with time-range extraction, partition rules, and the in-memory test engine.
"""

from .predicate import ColumnFilter, FilterOp, Predicate

__all__ = ["ColumnFilter", "FilterOp", "Predicate"]
