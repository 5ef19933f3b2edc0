"""Rule definitions: PromQL recording rules and alert rules
(ref: prometheus's rule groups — recording rules materialize an
expression as a new series under a stable name; alert rules evaluate an
expression and manage a pending->firing->resolved lifecycle per result
series. StreamBox-HBM's stance, PAPERS.md: continuous queries over the
hybrid-memory stream ARE the serving workload, not an external scraper's
job).

One ``Rule`` dataclass carries both kinds; config lines use the compact
``NAME := EXPR [for DURATION]`` form (TOML-subset-friendly inline string
arrays), the runtime ``/admin/rules`` endpoint takes the same fields as
JSON. Rule names double as output table names (recording) and alertname
labels (alerts), so they are restricted to SQL-safe identifiers — the
PromQL selector for a recording rule's output is then just its name.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..engine.options import parse_duration_ms
from ..proxy.promql import PromQLError, parse_promql

# SQL-safe so the output table needs no quoting on any wire (and so a
# remote CREATE TABLE IF NOT EXISTS forward round-trips the parser).
_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")

_FOR_TAIL = re.compile(r"\s+for\s+(\d+(?:ms|s|m|h|d))\s*$")
_EVERY_TAIL = re.compile(r"\s+every\s+(\d+(?:ms|s|m|h|d))\s*$")


class RuleError(ValueError):
    pass


@dataclass
class Rule:
    """One recording or alert rule.

    ``for_s`` (alerts only): how long the expression must keep returning
    a series before that series transitions pending -> firing.
    ``every_s``: per-rule evaluation cadence — 0 means "every engine
    round" ([rules] eval_interval); a larger value makes the engine skip
    rounds until the interval elapses (an expensive daily recording rule
    must not re-run every 15s). Effective cadence is therefore
    max(eval_interval, every).
    ``source``: "config" rules reload from the config file each start and
    cannot be removed at runtime; "runtime" rules persist in the rules
    state file beside ``wlm_state.json``.
    """

    name: str
    expr: str
    kind: str = "recording"  # "recording" | "alert"
    for_s: float = 0.0
    every_s: float = 0.0
    labels: dict[str, str] = field(default_factory=dict)
    source: str = "config"  # "config" | "runtime"

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "expr": self.expr,
            "kind": self.kind,
            "for_s": self.for_s,
            "every_s": self.every_s,
            "labels": dict(self.labels),
            "source": self.source,
        }


def validate_rule(rule: Rule) -> Rule:
    """Fail loudly at load/add time, not at the first evaluation."""
    if rule.kind not in ("recording", "alert"):
        raise RuleError(f"rule {rule.name!r}: kind must be recording|alert")
    if not _NAME_RE.match(rule.name or ""):
        raise RuleError(
            f"rule name {rule.name!r} must match [A-Za-z_][A-Za-z0-9_]* "
            "(it names the output table / alertname)"
        )
    if rule.for_s < 0:
        raise RuleError(f"rule {rule.name!r}: negative for duration")
    if rule.every_s < 0:
        raise RuleError(f"rule {rule.name!r}: negative every interval")
    if rule.kind == "recording" and rule.for_s:
        raise RuleError(f"recording rule {rule.name!r} takes no for duration")
    try:
        parse_promql(rule.expr)
    except PromQLError as e:
        raise RuleError(f"rule {rule.name!r}: bad expr: {e}") from None
    if not isinstance(rule.labels, dict) or not all(
        isinstance(k, str) and isinstance(v, str)
        for k, v in rule.labels.items()
    ):
        raise RuleError(f"rule {rule.name!r}: labels must be str -> str")
    return rule


def parse_rule_line(line: str, kind: str, source: str = "config") -> Rule:
    """``NAME := EXPR [for 30s] [every 15s]`` — the ``[rules]`` config
    line form (``for`` is alert-only; ``every`` sets the per-rule
    evaluation cadence for either kind, trailing the ``for`` tail)."""
    name, sep, expr = line.partition(":=")
    if not sep:
        raise RuleError(
            f"bad rule line {line!r}: expected 'NAME := EXPR'"
        )
    name, expr = name.strip(), expr.strip()
    every_s = 0.0
    m = _EVERY_TAIL.search(expr)
    if m is not None:
        every_s = parse_duration_ms(m.group(1)) / 1000.0
        expr = expr[: m.start()].rstrip()
    for_s = 0.0
    if kind == "alert":
        m = _FOR_TAIL.search(expr)
        if m is not None:
            for_s = parse_duration_ms(m.group(1)) / 1000.0
            expr = expr[: m.start()].rstrip()
    return validate_rule(
        Rule(name, expr, kind=kind, for_s=for_s, every_s=every_s,
             source=source)
    )


def rule_from_dict(d: dict, source: str = "runtime") -> Rule:
    """The /admin/rules POST body (and the persisted state-file form)."""
    if not isinstance(d, dict):
        raise RuleError("rule must be an object")
    def _dur(key: str, alt: str) -> float:
        raw = d.get(key, d.get(alt, 0))
        if isinstance(raw, str):
            return parse_duration_ms(raw) / 1000.0
        return float(raw or 0)

    return validate_rule(
        Rule(
            name=str(d.get("name", "")),
            expr=str(d.get("expr", "")),
            kind=str(d.get("kind", "recording")),
            for_s=_dur("for", "for_s"),
            every_s=_dur("every", "every_s"),
            labels=dict(d.get("labels") or {}),
            source=source,
        )
    )
