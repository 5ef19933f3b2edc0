"""SQL tokenizer + recursive-descent parser.

Covers the reference's extended SQL dialect (ref: query_frontend/src/
parser.rs:140-363 — standard SQL plus ``TAG`` column modifiers,
``TIMESTAMP KEY``, ``ENGINE = Analytic``, ``WITH (k='v')`` table options,
``PARTITION BY KEY(...) PARTITIONS n``). Hand-rolled because the image has
no SQL parsing library — and the dialect is small enough that a tight
tokenizer + precedence-climbing expression parser is clearer than bending
a general parser around the extensions.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

from . import ast


class ParseError(ValueError):
    def __init__(self, msg: str, pos: int = -1, sql: str = "") -> None:
        ctx = ""
        if sql and pos >= 0:
            ctx = f" near: {sql[max(0, pos - 10):pos + 20]!r}"
        super().__init__(f"{msg}{ctx}")


# ---- tokenizer ---------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<number>\d+(\.\d+)?([eE][+-]?\d+)?)
  | (?P<qident>"[^"]*"|`[^`]*`)
  | (?P<string>'(?:[^']|'')*')
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|!=|<>|==|[-+*/%(),.=<>;])
    """,
    re.VERBOSE,
)


class Token:
    __slots__ = ("kind", "text", "pos")

    def __init__(self, kind: str, text: str, pos: int) -> None:
        self.kind = kind  # number|string|name|op|qident
        self.text = text
        self.pos = pos

    def __repr__(self) -> str:
        return f"Token({self.kind}, {self.text!r})"


def tokenize(sql: str) -> list[Token]:
    out: list[Token] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise ParseError(f"unexpected character {sql[i]!r}", i, sql)
        kind = m.lastgroup
        if kind not in ("ws", "comment"):
            out.append(Token(kind, m.group(), i))
        i = m.end()
    return out


_PRECEDENCE = {
    "OR": 1,
    "AND": 2,
    "=": 4, "!=": 4, "<>": 4, "<": 4, "<=": 4, ">": 4, ">=": 4,
    "+": 5, "-": 5,
    "*": 6, "/": 6, "%": 6,
}


class Parser:
    """One statement per parse() call; parse_many() splits on ';'."""

    def __init__(self, sql: str) -> None:
        self.sql = sql
        self.tokens = tokenize(sql)
        self.i = 0

    # ---- cursor helpers -------------------------------------------------
    def _peek(self) -> Optional[Token]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def _next(self) -> Token:
        t = self._peek()
        if t is None:
            raise ParseError("unexpected end of input", len(self.sql), self.sql)
        self.i += 1
        return t

    def _peek_ahead_is(self, kw: str) -> bool:
        nxt = self.i + 1
        return nxt < len(self.tokens) and self.tokens[nxt].text.upper() == kw

    def _at_kw(self, *kws: str) -> bool:
        t = self._peek()
        return t is not None and t.kind == "name" and t.text.upper() in kws

    def _eat_kw(self, *kws: str) -> bool:
        if self._at_kw(*kws):
            self.i += 1
            return True
        return False

    def _expect_kw(self, kw: str) -> None:
        if not self._eat_kw(kw):
            t = self._peek()
            raise ParseError(
                f"expected {kw}, found {t.text if t else 'end of input'}",
                t.pos if t else len(self.sql),
                self.sql,
            )

    def _at_op(self, op: str) -> bool:
        t = self._peek()
        return t is not None and t.kind == "op" and t.text == op

    def _eat_op(self, op: str) -> bool:
        if self._at_op(op):
            self.i += 1
            return True
        return False

    def _expect_op(self, op: str) -> None:
        if not self._eat_op(op):
            t = self._peek()
            raise ParseError(
                f"expected {op!r}, found {t.text if t else 'end of input'}",
                t.pos if t else len(self.sql),
                self.sql,
            )

    def _ident(self) -> str:
        t = self._next()
        if t.kind == "name":
            return t.text
        if t.kind == "qident":
            return t.text[1:-1]
        raise ParseError(f"expected identifier, found {t.text!r}", t.pos, self.sql)

    # ---- entry points ---------------------------------------------------
    def parse(self) -> ast.Statement:
        stmt = self._statement()
        self._eat_op(";")
        t = self._peek()
        if t is not None:
            raise ParseError(f"unexpected trailing input {t.text!r}", t.pos, self.sql)
        return stmt

    def parse_many(self) -> list[ast.Statement]:
        out = []
        while self._peek() is not None:
            out.append(self._statement())
            if not self._eat_op(";"):
                break
        t = self._peek()
        if t is not None:
            raise ParseError(f"unexpected trailing input {t.text!r}", t.pos, self.sql)
        return out

    # ---- statements ------------------------------------------------------
    def _statement(self) -> ast.Statement:
        if self._peek() is None:
            raise ParseError("empty statement", 0, self.sql)
        if self._at_kw("EXPLAIN"):
            self.i += 1
            analyze = self._eat_kw("ANALYZE")
            if self._at_kw("WITH"):
                t = self._peek()
                raise ParseError(
                    "EXPLAIN over WITH is not supported; EXPLAIN the "
                    "outer statement against materialized tables instead",
                    t.pos, self.sql,
                )
            inner = self._select_or_union()
            if analyze and isinstance(inner, ast.UnionSelect):
                t = self._peek()
                raise ParseError(
                    "EXPLAIN ANALYZE over UNION is not supported",
                    t.pos if t else -1, self.sql,
                )
            return ast.Explain(inner, analyze=analyze)
        if self._at_kw("WITH"):
            return self._with_statement()
        if self._at_kw("SELECT"):
            return self._select_or_union()
        if self._at_kw("CREATE"):
            return self._create_table()
        if self._at_kw("INSERT"):
            return self._insert()
        if self._at_kw("DROP"):
            return self._drop()
        if self._at_kw("DESCRIBE", "DESC"):
            self.i += 1
            self._eat_kw("TABLE")
            return ast.Describe(self._ident())
        if self._at_kw("SHOW"):
            return self._show()
        if self._at_kw("EXISTS"):
            self.i += 1
            self._eat_kw("TABLE")
            return ast.ExistsTable(self._ident())
        if self._at_kw("ALTER"):
            return self._alter()
        if self._at_kw("KILL"):
            # KILL [QUERY] <id> — cooperative cancellation; the id comes
            # from system.public.queries (utils/deadline registry)
            self.i += 1
            self._eat_kw("QUERY")
            t = self._next()
            if t.kind != "number" or "." in t.text:
                raise ParseError(
                    "KILL QUERY expects an integer query id", t.pos, self.sql
                )
            return ast.KillQuery(int(t.text))
        t = self._peek()
        raise ParseError(f"unsupported statement start {t.text!r}", t.pos, self.sql)

    def _with_statement(self) -> ast.Statement:
        """WITH a AS (select), b AS (select) <select-or-union> — each cte
        body may itself be a union; later ctes may reference earlier ones
        (resolved by the interpreter's overlay)."""
        self._expect_kw("WITH")
        ctes: list[tuple[str, ast.Select | ast.UnionSelect]] = []
        while True:
            name = self._ident()
            self._expect_kw("AS")
            self._expect_op("(")
            body = self._select_or_union()
            self._expect_op(")")
            ctes.append((name, body))
            if not self._eat_op(","):
                break
        outer = self._select_or_union()
        return dataclasses.replace(outer, ctes=tuple(ctes))

    def _select_or_union(self) -> ast.Select | ast.UnionSelect:
        """SELECT ... [UNION [ALL] SELECT ...]*; a trailing ORDER BY/LIMIT
        (which ``_select`` greedily attaches to the last branch — the only
        place SQL allows them un-parenthesized) lifts to the union."""
        first = self._select()
        if not self._at_kw("UNION"):
            return first
        selects = [first]
        all_flags: list[bool] = []
        while self._eat_kw("UNION"):
            branch_all = bool(self._eat_kw("ALL"))
            self._eat_kw("DISTINCT")
            all_flags.append(branch_all)
            selects.append(self._select())
        last = selects[-1]
        order_by, limit, offset = last.order_by, last.limit, last.offset
        if order_by or limit is not None or offset:
            selects[-1] = dataclasses.replace(
                last, order_by=(), limit=None, offset=0
            )
        n_cols = {len(s.items) for s in selects}
        if len(n_cols) > 1 and not any(
            isinstance(i.expr, ast.Star) for s in selects for i in s.items
        ):
            raise ParseError("UNION branches have different column counts", -1, self.sql)
        return ast.UnionSelect(
            selects=tuple(selects),
            all_flags=tuple(all_flags),
            order_by=order_by,
            limit=limit,
            offset=offset,
        )

    def _select(self) -> ast.Select:
        self._expect_kw("SELECT")
        distinct = bool(self._eat_kw("DISTINCT"))
        items = [self._select_item()]
        while self._eat_op(","):
            items.append(self._select_item())
        table = None
        joins: list[ast.Join] = []
        if self._eat_kw("FROM"):
            table = self._table_name()
            prev_tables = [table]
            while True:
                if self._eat_kw("INNER"):
                    self._expect_kw("JOIN")
                    kind = "inner"
                elif self._eat_kw("LEFT"):
                    self._eat_kw("OUTER")
                    self._expect_kw("JOIN")
                    kind = "left"
                elif self._eat_kw("RIGHT"):
                    self._eat_kw("OUTER")
                    self._expect_kw("JOIN")
                    kind = "right"
                elif self._eat_kw("FULL"):
                    self._eat_kw("OUTER")
                    self._expect_kw("JOIN")
                    kind = "full"
                elif self._eat_kw("JOIN"):
                    kind = "inner"
                else:
                    break
                j = self._join_clause(prev_tables, kind=kind)
                joins.append(j)
                prev_tables.append(j.table)
        where = None
        if self._eat_kw("WHERE"):
            where = self._expr()
        group_by: tuple = ()
        having = None
        if self._eat_kw("GROUP"):
            self._expect_kw("BY")
            gb = [self._expr()]
            while self._eat_op(","):
                gb.append(self._expr())
            group_by = tuple(gb)
        if self._eat_kw("HAVING"):
            having = self._expr()
        order_by: list[ast.OrderItem] = []
        if self._eat_kw("ORDER"):
            self._expect_kw("BY")
            while True:
                e = self._expr()
                asc = True
                if self._eat_kw("DESC"):
                    asc = False
                elif self._eat_kw("ASC"):
                    pass
                nulls_last = None
                if self._eat_kw("NULLS"):
                    if self._eat_kw("LAST"):
                        nulls_last = True
                    elif self._eat_kw("FIRST"):
                        nulls_last = False
                    else:
                        t = self._peek()
                        raise ParseError(
                            "expected FIRST or LAST after NULLS",
                            t.pos if t else -1, self.sql,
                        )
                order_by.append(ast.OrderItem(e, asc, nulls_last))
                if not self._eat_op(","):
                    break
        limit = None
        if self._eat_kw("LIMIT"):
            t = self._next()
            if t.kind != "number":
                raise ParseError("LIMIT expects a number", t.pos, self.sql)
            limit = int(t.text)
        offset = 0
        if self._eat_kw("OFFSET"):
            t = self._next()
            if t.kind != "number":
                raise ParseError("OFFSET expects a number", t.pos, self.sql)
            offset = int(t.text)
        return ast.Select(
            items=tuple(items),
            table=table,
            where=where,
            group_by=group_by,
            order_by=tuple(order_by),
            limit=limit,
            offset=offset,
            having=having,
            distinct=distinct,
            join=joins[0] if joins else None,
            joins=tuple(joins[1:]),
        )

    def _join_clause(self, prev_tables: list[str], kind: str = "inner") -> ast.Join:
        """JOIN t2 ON a.k1 = b.k1 [AND a.k2 = b.k2 ...] — equi-key join
        (the reference gets richer joins from DataFusion; this is the
        host-path equi-join subset). In a chain the left side of each
        equality may reference ANY earlier table."""
        right = self._table_name()
        self._expect_kw("ON")
        left_cols: list[str] = []
        right_cols: list[str] = []

        def names_table(tab: Optional[str], full: str) -> bool:
            """ON qualifiers may use the full dotted name or its last
            component (JOIN public.t2 ... ON t1.k = t2.k)."""
            return tab is None or tab == full or tab == full.rsplit(".", 1)[-1]

        def names_any_prev(tab: Optional[str]) -> bool:
            return any(names_table(tab, p) for p in prev_tables)

        while True:
            l_tab, l_col = self._qualified()
            self._expect_op("=")
            r_tab, r_col = self._qualified()
            # normalize sides: an earlier table's column first
            if (l_tab is not None and names_table(l_tab, right)
                    and r_tab is not None and names_any_prev(r_tab)):
                l_col, r_col = r_col, l_col
            elif not (names_any_prev(l_tab) and names_table(r_tab, right)):
                raise ParseError(
                    f"JOIN ON must reference an earlier table "
                    f"({', '.join(prev_tables)}) and {right}", -1, self.sql
                )
            left_cols.append(l_col)
            right_cols.append(r_col)
            if not self._eat_kw("AND"):
                break
        return ast.Join(right, tuple(left_cols), tuple(right_cols), kind=kind)

    def _table_name(self) -> str:
        """A possibly-qualified table reference. Qualified names
        (system.public.tables — the system catalog's virtual tables,
        ref: system_catalog/src/tables.rs; or public.demo) join into one
        dotted identifier; regular tables stay single-part. Shared by
        FROM and JOIN targets."""
        name = self._ident()
        while self._eat_op("."):
            name = f"{name}.{self._ident()}"
        return name

    def _qualified(self) -> tuple[Optional[str], str]:
        name = self._ident()
        if self._eat_op("."):
            return name, self._ident()
        return None, name

    def _select_item(self) -> ast.SelectItem:
        if self._at_op("*"):
            self.i += 1
            return ast.SelectItem(ast.Star())
        e = self._expr()
        alias = None
        if self._eat_kw("AS"):
            alias = self._ident()
        elif (t := self._peek()) is not None and t.kind in ("name", "qident") and t.text.upper() not in (
            "FROM", "WHERE", "GROUP", "ORDER", "LIMIT", "AS",
            "HAVING", "JOIN", "INNER", "ON", "LEFT", "OUTER",
            "RIGHT", "FULL", "UNION", "OVER",
        ):
            alias = self._ident()
        return ast.SelectItem(e, alias)

    def _create_table(self) -> ast.CreateTable:
        self._expect_kw("CREATE")
        self._expect_kw("TABLE")
        if_not_exists = False
        if self._eat_kw("IF"):
            self._expect_kw("NOT")
            self._expect_kw("EXISTS")
            if_not_exists = True
        name = self._ident()
        self._expect_op("(")
        columns: list[ast.ColumnDef] = []
        timestamp_key: Optional[str] = None
        primary_key: Optional[tuple[str, ...]] = None
        while True:
            if self._at_kw("TIMESTAMP") and self._peek_ahead_is("KEY"):
                self.i += 2
                self._expect_op("(")
                timestamp_key = self._ident()
                self._expect_op(")")
            elif self._at_kw("PRIMARY"):
                self.i += 1
                self._expect_kw("KEY")
                self._expect_op("(")
                pk = [self._ident()]
                while self._eat_op(","):
                    pk.append(self._ident())
                self._expect_op(")")
                primary_key = tuple(pk)
            else:
                columns.append(self._column_def())
                if columns[-1].is_timestamp_key:
                    timestamp_key = columns[-1].name
            if not self._eat_op(","):
                break
        self._expect_op(")")
        engine = "Analytic"
        partition_by = None
        options: dict[str, str] = {}
        while True:
            if self._eat_kw("ENGINE"):
                self._expect_op("=")
                engine = self._ident()
            elif self._at_kw("PARTITION"):
                partition_by = self._partition_by()
            elif self._eat_kw("WITH"):
                self._expect_op("(")
                while True:
                    k = self._ident()
                    self._expect_op("=")
                    v = self._next()
                    options[k] = v.text[1:-1].replace("''", "'") if v.kind == "string" else v.text
                    if not self._eat_op(","):
                        break
                self._expect_op(")")
            else:
                break
        return ast.CreateTable(
            table=name,
            columns=tuple(columns),
            timestamp_key=timestamp_key,
            primary_key=primary_key,
            engine=engine,
            options=options,
            if_not_exists=if_not_exists,
            partition_by=partition_by,
        )

    def _partition_by(self) -> ast.PartitionBy:
        self._expect_kw("PARTITION")
        self._expect_kw("BY")
        method = self._ident().lower()
        if method not in ("key", "hash"):
            raise ParseError(f"unsupported partition method {method!r}")
        self._expect_op("(")
        cols = [self._ident()]
        while self._eat_op(","):
            cols.append(self._ident())
        self._expect_op(")")
        self._expect_kw("PARTITIONS")
        t = self._next()
        if t.kind != "number":
            raise ParseError("PARTITIONS expects a number", t.pos, self.sql)
        return ast.PartitionBy(method, tuple(cols), int(t.text))

    def _column_def(self) -> ast.ColumnDef:
        name = self._ident()
        type_name = self._ident()
        is_tag = False
        is_ts_key = False
        not_null = False
        comment = ""
        while True:
            if self._eat_kw("TAG"):
                is_tag = True
            elif self._eat_kw("KEY"):
                is_ts_key = True
            elif self._at_kw("TIMESTAMP") and self._peek_ahead_is("KEY"):
                self.i += 2
                is_ts_key = True
            elif self._eat_kw("NOT"):
                self._expect_kw("NULL")
                not_null = True
            elif self._eat_kw("NULL"):
                pass
            elif self._eat_kw("COMMENT"):
                t = self._next()
                if t.kind != "string":
                    raise ParseError("COMMENT expects a string", t.pos, self.sql)
                comment = t.text[1:-1].replace("''", "'")
            else:
                break
        return ast.ColumnDef(name, type_name, is_tag, is_ts_key, not_null, comment)

    def _insert(self) -> ast.Insert:
        self._expect_kw("INSERT")
        self._expect_kw("INTO")
        table = self._ident()
        columns: tuple[str, ...] = ()
        if self._eat_op("("):
            cols = [self._ident()]
            while self._eat_op(","):
                cols.append(self._ident())
            self._expect_op(")")
            columns = tuple(cols)
        self._expect_kw("VALUES")
        rows = []
        while True:
            self._expect_op("(")
            vals = [self._literal_value()]
            while self._eat_op(","):
                vals.append(self._literal_value())
            self._expect_op(")")
            rows.append(tuple(vals))
            if not self._eat_op(","):
                break
        return ast.Insert(table, columns, tuple(rows))

    def _literal_value(self) -> Any:
        e = self._expr()
        return _fold_literal(e, self.sql)

    def _drop(self) -> ast.DropTable:
        self._expect_kw("DROP")
        self._expect_kw("TABLE")
        if_exists = False
        if self._eat_kw("IF"):
            self._expect_kw("EXISTS")
            if_exists = True
        return ast.DropTable(self._ident(), if_exists)

    def _show(self) -> ast.Statement:
        self._expect_kw("SHOW")
        if self._eat_kw("TABLES"):
            return ast.ShowTables()
        if self._eat_kw("CREATE"):
            self._expect_kw("TABLE")
            return ast.ShowCreateTable(self._ident())
        t = self._peek()
        raise ParseError(
            f"unsupported SHOW {t.text if t else ''}", t.pos if t else -1, self.sql
        )

    def _alter(self) -> ast.Statement:
        self._expect_kw("ALTER")
        self._expect_kw("TABLE")
        table = self._ident()
        if self._eat_kw("ADD"):
            self._eat_kw("COLUMN")
            cols = [self._column_def()]
            while self._eat_op(","):
                self._eat_kw("COLUMN")
                cols.append(self._column_def())
            return ast.AlterTableAddColumn(table, tuple(cols))
        if self._eat_kw("MODIFY"):
            self._expect_kw("SETTING")
            opts: dict[str, str] = {}
            while True:
                k = self._ident()
                self._expect_op("=")
                v = self._next()
                opts[k] = v.text[1:-1].replace("''", "'") if v.kind == "string" else v.text
                if not self._eat_op(","):
                    break
            return ast.AlterTableSetOptions(table, opts)
        t = self._peek()
        raise ParseError(
            f"unsupported ALTER action {t.text if t else ''}", t.pos if t else -1, self.sql
        )

    # ---- expressions ------------------------------------------------------
    def _expr(self, min_prec: int = 0) -> ast.Expr:
        left = self._unary()
        while True:
            t = self._peek()
            if t is None:
                return left
            op = t.text.upper() if t.kind == "name" else t.text
            # NOT IN / NOT BETWEEN / IS [NOT] NULL / IN / BETWEEN / [NOT] [I]LIKE
            if t.kind == "name" and op in ("IN", "BETWEEN", "IS", "NOT", "LIKE", "ILIKE"):
                left = self._postfix_predicate(left)
                continue
            prec = _PRECEDENCE.get(op)
            if prec is None or prec < min_prec:
                return left
            self.i += 1
            if op == "<>":
                op = "!="
            right = self._expr(prec + 1)
            left = ast.BinaryOp(op, left, right)

    def _postfix_predicate(self, left: ast.Expr) -> ast.Expr:
        negated = self._eat_kw("NOT")
        if self._eat_kw("IN"):
            self._expect_op("(")
            if self._at_kw("SELECT"):
                inner = self._select()
                self._expect_op(")")
                return ast.InSubquery(left, inner, negated)
            vals = [self._expr()]
            while self._eat_op(","):
                vals.append(self._expr())
            self._expect_op(")")
            return ast.InList(left, tuple(vals), negated)
        if self._eat_kw("BETWEEN"):
            low = self._expr(_PRECEDENCE["AND"] + 1)
            self._expect_kw("AND")
            high = self._expr(_PRECEDENCE["AND"] + 1)
            return ast.Between(left, low, high, negated)
        for kw, ci in (("LIKE", False), ("ILIKE", True)):
            if self._eat_kw(kw):
                t = self._next()
                if t.kind != "string":
                    raise ParseError(
                        f"{kw} expects a string pattern", t.pos, self.sql
                    )
                pattern = t.text[1:-1].replace("''", "'")
                return ast.Like(left, pattern, negated, case_insensitive=ci)
        if not negated and self._eat_kw("IS"):
            neg = self._eat_kw("NOT")
            self._expect_kw("NULL")
            return ast.IsNull(left, neg)
        t = self._peek()
        raise ParseError(
            f"unexpected token {t.text if t else ''}", t.pos if t else -1, self.sql
        )

    def _unary(self) -> ast.Expr:
        if self._eat_kw("NOT"):
            return ast.UnaryOp("NOT", self._unary())
        if self._eat_op("-"):
            inner = self._unary()
            # Fold negative number literals so every downstream consumer
            # (predicate extraction, residual filters) sees plain Literals.
            if isinstance(inner, ast.Literal) and isinstance(inner.value, (int, float)):
                return ast.Literal(-inner.value)
            return ast.UnaryOp("-", inner)
        if self._eat_op("+"):
            return self._unary()
        return self._primary()

    def _primary(self) -> ast.Expr:
        t = self._next()
        if t.kind == "number":
            text = t.text
            if "." in text or "e" in text or "E" in text:
                return ast.Literal(float(text))
            return ast.Literal(int(text))
        if t.kind == "string":
            return ast.Literal(t.text[1:-1].replace("''", "'"))
        if t.kind == "op" and t.text == "(":
            if self._at_kw("SELECT"):
                # scalar subquery: (SELECT max(v) FROM t) — must be
                # uncorrelated; the interpreter evaluates it first
                inner = self._select()
                self._expect_op(")")
                return ast.Subquery(inner)
            e = self._expr()
            self._expect_op(")")
            return e
        if t.kind == "op" and t.text == "*":
            return ast.Star()
        if t.kind in ("name", "qident"):
            upper = t.text.upper()
            if upper == "TRUE":
                return ast.Literal(True)
            if upper == "FALSE":
                return ast.Literal(False)
            if upper == "NULL":
                return ast.Literal(None)
            if upper == "EXISTS" and self._at_op("("):
                # EXISTS (SELECT ...): semi-join probe; NOT EXISTS arrives
                # via _unary's NOT wrapping.
                self._expect_op("(")
                inner = self._select()
                self._expect_op(")")
                return ast.Exists(inner)
            if upper == "CASE":
                return self._case()
            if upper == "CAST" and self._at_op("("):
                self.i += 1
                inner = self._expr()
                self._expect_kw("AS")
                ty = self._next()
                if ty.kind != "name":
                    raise ParseError("CAST expects a type name", ty.pos, self.sql)
                self._expect_op(")")
                return ast.Cast(inner, ty.text.lower())
            name = t.text if t.kind == "name" else t.text[1:-1]
            if self._at_op("("):
                self.i += 1
                distinct = self._eat_kw("DISTINCT")
                args: list[ast.Expr] = []
                if not self._at_op(")"):
                    args.append(self._expr())
                    while self._eat_op(","):
                        args.append(self._expr())
                self._expect_op(")")
                call = ast.FuncCall(name.lower(), tuple(args), distinct)
                if self._eat_kw("FILTER"):
                    # standard SQL: agg(col) FILTER (WHERE cond)
                    self._expect_op("(")
                    self._expect_kw("WHERE")
                    cond = self._expr()
                    self._expect_op(")")
                    call = ast.FuncCall(
                        call.name, call.args, call.distinct, filter_where=cond
                    )
                if self._eat_kw("OVER"):
                    return self._window(call)
                return call
            if self._at_op("."):
                # qualified column (t.col) — resolution is by column name;
                # the planner validates the qualifier
                self.i += 1
                return ast.Column(self._ident(), qualifier=name)
            return ast.Column(name)
        raise ParseError(f"unexpected token {t.text!r}", t.pos, self.sql)

    def _case(self) -> ast.Case:
        """CASE [operand] WHEN w THEN t ... [ELSE e] END; the simple form
        (with operand) normalizes to searched conditions (operand = w)."""
        operand = None
        if not self._at_kw("WHEN"):
            operand = self._expr()
        whens: list[tuple[ast.Expr, ast.Expr]] = []
        while self._eat_kw("WHEN"):
            w = self._expr()
            self._expect_kw("THEN")
            t = self._expr()
            if operand is not None:
                w = ast.BinaryOp("=", operand, w)
            whens.append((w, t))
        if not whens:
            tk = self._peek()
            raise ParseError("CASE requires at least one WHEN", tk.pos if tk else -1, self.sql)
        else_ = None
        if self._eat_kw("ELSE"):
            else_ = self._expr()
        self._expect_kw("END")
        return ast.Case(tuple(whens), else_)

    def _window(self, call: ast.FuncCall) -> ast.WindowFunc:
        """fn(...) OVER ( [PARTITION BY e, ...] [ORDER BY e [ASC|DESC], ...] )"""
        if call.distinct:
            raise ParseError("DISTINCT is not allowed in window functions", -1, self.sql)
        if call.filter_where is not None:
            raise ParseError(
                "FILTER is not supported with window functions", -1, self.sql
            )
        self._expect_op("(")
        partition_by: list[ast.Expr] = []
        order_by: list[ast.OrderItem] = []
        if self._eat_kw("PARTITION"):
            self._expect_kw("BY")
            partition_by.append(self._expr())
            while self._eat_op(","):
                partition_by.append(self._expr())
        if self._eat_kw("ORDER"):
            self._expect_kw("BY")
            while True:
                e = self._expr()
                asc = True
                if self._eat_kw("DESC"):
                    asc = False
                elif self._eat_kw("ASC"):
                    pass
                order_by.append(ast.OrderItem(e, asc))
                if not self._eat_op(","):
                    break
        self._expect_op(")")
        return ast.WindowFunc(
            call.name, call.args,
            ast.WindowSpec(tuple(partition_by), tuple(order_by)),
        )


def _fold_literal(e: ast.Expr, sql: str) -> Any:
    """INSERT values must be constants; folds unary minus."""
    if isinstance(e, ast.Literal):
        return e.value
    if isinstance(e, ast.UnaryOp) and e.op == "-":
        v = _fold_literal(e.operand, sql)
        return -v
    raise ParseError(f"expected literal in VALUES, found {e}", -1, sql)


def parse_sql(sql: str) -> ast.Statement:
    return Parser(sql).parse()


def parse_many(sql: str) -> list[ast.Statement]:
    return Parser(sql).parse_many()
