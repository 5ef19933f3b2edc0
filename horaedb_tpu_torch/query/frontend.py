"""Frontend: SQL text -> Plan (ref: query_frontend/src/frontend.rs:110-214).

``parse_sql`` and ``statement_to_plan`` mirror the reference's two-step
surface; PromQL/InfluxQL/OpenTSDB translators land beside this in later
rounds (same Plan target, different grammars).
"""

from __future__ import annotations

from typing import Callable, Optional

from ..common_types.schema import Schema
from . import ast
from .parser import parse_many, parse_sql
from .plan import Plan
from .planner import Planner


class Frontend:
    def __init__(self, schema_of: Callable[[str], Optional[Schema]]) -> None:
        self.planner = Planner(schema_of)

    def parse_sql(self, sql: str) -> ast.Statement:
        return parse_sql(sql)

    def parse_sql_many(self, sql: str) -> list[ast.Statement]:
        return parse_many(sql)

    def statement_to_plan(self, stmt: ast.Statement) -> Plan:
        return self.planner.plan(stmt)

    def sql_to_plan(self, sql: str) -> Plan:
        return self.statement_to_plan(self.parse_sql(sql))
