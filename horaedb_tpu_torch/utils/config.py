"""Configuration sections the port reads (a copy of the reference's
``utils/config.py``, cut to what the port imports).

Only ``[rules]`` is here: ``rules.RuleEngine`` defaults to it. The TOML
loader and the server, engine, limits, WLM, cluster, object-store and
elastic sections come with the slice that ports the server (ROADMAP A10).
"""

from __future__ import annotations

from dataclasses import dataclass, field


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
