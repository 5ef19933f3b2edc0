"""Cross-layer column-layout hints.

The scan cache's layout tuner learns, per (table, column), that a value
column is low-cardinality enough to dictionary-encode. That knowledge is
useful BELOW the cache too: if the memtable freezes such a column as a
DictColumn, every downstream consumer — freeze concat, SST write, the
cache build's host read — moves codes instead of repeated values, and
the column arrives at the cache already in the layout the tuner would
pick.

This module is the (deliberately tiny) channel: a bounded process-global
map written by the cache at encode time and read by the memtable at
freeze time. Hints are advisory — a column that stopped being
low-cardinality simply fails the next dictionary attempt and freezes
dense; nothing downstream may *require* a hint to hold.

Lives in common_types because both engine.memtable and query.scan_cache
import it (either direction between those two would cycle).
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
# (table, column) -> last observed dictionary cardinality; dict order is
# recency (LRU-style bound like ScanCache._usage)
_hints: dict[tuple[str, str], int] = {}
_MAX_HINTS = 4096


def note_low_cardinality(table: str, column: str, cardinality: int) -> None:
    """Record that ``table.column`` dictionary-encoded at ``cardinality``
    distinct values (called by the cache's layout tuner on encode)."""
    key = (table, column)
    with _lock:
        _hints.pop(key, None)
        if len(_hints) >= _MAX_HINTS:
            _hints.pop(next(iter(_hints)))
        _hints[key] = int(cardinality)


def low_cardinality_hint(table: str, column: str) -> int:
    """Last observed dictionary cardinality for ``table.column``, or 0
    when the tuner has never dictionary-encoded it."""
    with _lock:
        return _hints.get((table, column), 0)


def clear_hints() -> None:
    """Test isolation helper."""
    with _lock:
        _hints.clear()
