"""Continuous queries: PromQL recording rules, tiered rollups, and an
alerting evaluator — see rules/engine.py for the subsystem overview."""

from .engine import (
    RULES_METRIC_FAMILIES,
    RuleEngine,
    recording_schema,
    registered_engines,
)
from .model import Rule, RuleError, parse_rule_line, rule_from_dict
from .rewrite import rollup_decision_for, try_rollup_serve
from .rollup import (
    ROLLUPS,
    RollupMaintainer,
    RollupSpec,
    TIERS,
    rollup_table_name,
)

__all__ = [
    "ROLLUPS",
    "RULES_METRIC_FAMILIES",
    "Rule",
    "RuleEngine",
    "RuleError",
    "RollupMaintainer",
    "RollupSpec",
    "TIERS",
    "parse_rule_line",
    "recording_schema",
    "registered_engines",
    "rollup_decision_for",
    "rollup_table_name",
    "rule_from_dict",
    "try_rollup_serve",
]
