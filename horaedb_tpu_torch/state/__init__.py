"""Streaming state: device-resident incremental aggregates.

``livewindow`` keeps hot (table, window, group-set) partial aggregates
in device ring buffers, folded at write time, so an open-tail dashboard
refresh is a gather over O(buckets) partials instead of a raw rescan.
"""

from .livewindow import (  # noqa: F401
    LIVEWINDOW_METRIC_FAMILIES,
    LiveWindowDecision,
    STORE,
    livewindow_decision_for,
    livewindow_enabled,
    try_livewindow_counter,
    try_livewindow_serve,
)
