"""Configuration sections the port reads (a copy of the reference's
``utils/config.py``, cut to what the port imports).

Here: ``[rules]`` (``rules.RuleEngine`` defaults to it), ``[limits]`` and
``[wlm.batch]`` (the ``proxy.Proxy`` gateway and its cohort batcher), with
the ``[wlm.batch]`` validation the loader applies (``_apply_batch``). The
TOML loader and the server, engine, cluster, object-store and elastic
sections come with the slice that ports the server (ROADMAP A10).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..engine.options import parse_duration_ms


class ConfigError(ValueError):
    pass


@dataclass
class RulesSection:
    """Continuous queries (rules/): PromQL recording rules and alert
    rules in the compact ``NAME := EXPR [for 30s]`` line form, plus the
    tiered rollup ladder (raw -> 1m -> 1h with TTL laddering) for the
    listed source tables. All evaluated on one periodic loop; runtime
    additions via /admin/rules persist beside wlm_state.json."""

    enabled: bool = True
    eval_interval_s: float = 15.0
    grace_s: float = 5.0
    recording: list[str] = field(default_factory=list)
    alerts: list[str] = field(default_factory=list)
    rollup_tables: list[str] = field(default_factory=list)
    rollup_raw_ttl_s: float = 24 * 3600.0
    rollup_1m_ttl_s: float = 30 * 24 * 3600.0
    rollup_1h_ttl_s: float = 0.0
    recording_ttl_s: float = 30 * 24 * 3600.0


@dataclass
class LimitsConfig:
    slow_threshold_s: float = 1.0
    # workload manager (wlm/): weighted admission slots, bounded wait
    # queues with a deadline, a memory budget, and read dedup
    admission_slots: int = 8
    admission_queue_depth: int = 32
    admission_deadline_s: float = 5.0
    admission_memory_budget: int = 1 << 30
    dedup: bool = True
    # deadline propagation (utils/deadline): the default per-query time
    # budget when the client sent no X-HoraeDB-Timeout-Ms / session
    # knob (0 = unbounded); every layer charges it and forwarding hops
    # ship the REMAINING budget
    query_timeout_s: float = 60.0
    # per-hop ceiling for forwarded HTTP calls and remote RPCs — the
    # effective per-call timeout is min(forward_timeout, remaining
    # budget) instead of the old fixed 30s constants
    forward_timeout_s: float = 30.0


@dataclass
class BatchSection:
    """Cohort batching ([wlm.batch] — wlm/batch.CohortBatcher): in-flight
    SELECTs sharing one normalized plan shape but differing literals
    gather for a micro-batching window, then the whole cohort is served
    by ONE fused device dispatch (the cohort scan-agg kernel, members on
    its grid). Disabled by default: with ``enabled = false`` the proxy
    read path is bit-for-bit the pre-batching single-flight path."""

    enabled: bool = False
    window_s: float = 0.002  # gather window before the fused dispatch
    max_cohort: int = 32  # cohort width ceiling
    # substrings matched against the normalized (literal-stripped) SQL
    # shape; non-empty restricts batching to the listed shapes
    shapes: list[str] = field(default_factory=list)


@dataclass
class WlmSection:
    """Workload-manager extensions beyond [limits] (which predates this
    section and keeps the admission/dedup knobs for compatibility)."""

    batch: BatchSection = field(default_factory=BatchSection)


_BATCH_KEYS = {"enabled", "window", "max_cohort", "shapes"}


def _apply_batch(bs: BatchSection, raw: Any) -> None:
    """[wlm.batch] — validated at load like every other section."""
    if not isinstance(raw, dict):
        raise ConfigError("wlm.batch must be a table")
    unknown = set(raw) - _BATCH_KEYS
    if unknown:
        raise ConfigError(f"unknown key(s) in [wlm.batch]: {sorted(unknown)}")
    if "enabled" in raw:
        if not isinstance(raw["enabled"], bool):
            raise ConfigError("wlm.batch.enabled must be a boolean")
        bs.enabled = raw["enabled"]
    if "window" in raw:
        bs.window_s = parse_duration_ms(raw["window"]) / 1000.0
        if bs.window_s <= 0:
            raise ConfigError("wlm.batch.window must be positive")
    if "max_cohort" in raw:
        bs.max_cohort = int(raw["max_cohort"])
        if bs.max_cohort < 2:
            # a 1-wide "cohort" is just the solo path plus a window wait
            raise ConfigError("wlm.batch.max_cohort must be >= 2")
    if "shapes" in raw:
        v = raw["shapes"]
        if not isinstance(v, list) or not all(isinstance(x, str) for x in v):
            raise ConfigError("wlm.batch.shapes must be a list of strings")
        bs.shapes = list(v)
