"""SQL text frontend (copy of duckdb_vss_tpu/sql/parser.py, bound to the
port's expression layer; error messages are the JAX package's, word for
word, because sqllogic files compare error text).

The reference's entire user surface is SQL executed by the DuckDB host
(SURVEY.md §1 L5): CREATE INDEX ... USING HNSW, ORDER BY
array_distance(...) LIMIT k, min_by top-k, lateral k-NN joins, the
vss_join/vss_match macros, PRAGMA hnsw_compact_index /
pragma_hnsw_index_info(), SET hnsw_ef_search, CHECKPOINT. This module
gives the engine the same textual surface: a hand-written tokenizer +
recursive-descent parser that lowers statements onto the
Database / QueryBuilder / knn_join layer (sql/engine.py), where the
optimizer rewrites (E8/E9/E10) and the device executors live.

Coverage is the surface exercised by the reference's sqllogictests
(its test/sql/hnsw/*.test): DDL (CREATE/DROP TABLE/INDEX),
DML (INSERT VALUES, INSERT ... SELECT ... FROM range(...) cross
products, DELETE, UPDATE), SELECT with WHERE/ORDER BY/LIMIT, distance
operators <-> <=> <#>, ::FLOAT[N] casts, ARRAY[...] literals,
array_value(), min_by() aggregates, lateral (SELECT ... ORDER BY
dist(a.x, b.y) LIMIT k) joins, table functions (vss_join, vss_match,
pragma_hnsw_index_info, range), PRAGMA / SET / CHECKPOINT / EXPLAIN.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np

from duckdb_vss_tpu_torch.sql import expr as E
from duckdb_vss_tpu_torch.utils.config import BinderError

# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>"(?:[^"]|"")*")
  | (?P<op><->|<=>|<\#>|::|<=|>=|!=|<>|[(),;.*\[\]=<>+\-/%])
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)


@dataclasses.dataclass
class Token:
    kind: str  # 'num' | 'str' | 'id' | 'op' | 'end'
    value: str
    upper: str = ""


def tokenize(sql: str) -> list[Token]:
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            raise BinderError(f"cannot tokenize SQL at: {sql[pos:pos+30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "str":
            out.append(Token("str", text[1:-1].replace("''", "'")))
        elif kind == "qid":
            out.append(Token("id", text[1:-1].replace('""', '"')))
        elif kind == "id":
            out.append(Token("id", text, text.upper()))
        else:
            out.append(Token(kind, text, text.upper()))
    out.append(Token("end", ""))
    return out


# ---------------------------------------------------------------------------
# statement ASTs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TableRef:
    name: str
    alias: str | None = None


@dataclasses.dataclass
class RangeFunc:
    args: list
    alias: str | None = None
    colname: str = "range"


@dataclasses.dataclass
class TableFunc:
    name: str
    args: list
    alias: str | None = None


@dataclasses.dataclass
class Lateral:
    sub: "SelectStmt"


@dataclasses.dataclass
class Star:
    table: str | None = None  # for a.* forms


@dataclasses.dataclass
class SelectStmt:
    projections: list  # E.Expr | Star
    from_items: list
    where: E.Expr | None = None
    order: E.Expr | None = None
    order_desc: bool = False
    limit: int | None = None
    group_by: list | None = None


@dataclasses.dataclass
class CreateTable:
    name: str
    columns: dict


@dataclasses.dataclass
class CreateTableAs:
    name: str
    select: "SelectStmt"


@dataclasses.dataclass
class CreateIndex:
    name: str
    table: str
    column: str
    options: dict


@dataclasses.dataclass
class DropStmt:
    kind: str  # 'table' | 'index'
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class InsertStmt:
    table: str
    columns: list | None
    rows: list | None  # list of list-of-expr (VALUES)
    select: SelectStmt | None = None


@dataclasses.dataclass
class DeleteStmt:
    table: str
    where: E.Expr | None


@dataclasses.dataclass
class UpdateStmt:
    table: str
    assigns: list  # (col, expr)
    where: E.Expr | None


@dataclasses.dataclass
class SetStmt:
    key: str
    value: Any


@dataclasses.dataclass
class PragmaStmt:
    name: str
    args: list


@dataclasses.dataclass
class CheckpointStmt:
    pass


@dataclasses.dataclass
class ExplainStmt:
    select: SelectStmt


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


class Parser:
    def __init__(self, tokens: list[Token]):
        self.toks = tokens
        self.i = 0

    # -- token helpers ---------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "end":
            self.i += 1
        return t

    def accept(self, *uppers: str) -> Token | None:
        t = self.peek()
        if t.kind in ("id", "op") and t.upper in uppers:
            return self.next()
        return None

    def expect(self, upper: str) -> Token:
        t = self.next()
        if t.upper != upper:
            raise BinderError(f"expected {upper!r}, got {t.value!r}")
        return t

    def expect_ident(self) -> str:
        t = self.next()
        if t.kind != "id":
            raise BinderError(f"expected identifier, got {t.value!r}")
        return t.value

    # -- statements ------------------------------------------------------
    def parse_statement(self):
        t = self.peek()
        u = t.upper
        if u == "CREATE":
            return self._create()
        if u == "DROP":
            return self._drop()
        if u == "INSERT":
            return self._insert()
        if u == "DELETE":
            return self._delete()
        if u == "UPDATE":
            return self._update()
        if u == "SELECT":
            return self._select()
        if u == "SET":
            return self._set()
        if u == "PRAGMA":
            return self._pragma()
        if u == "CHECKPOINT":
            self.next()
            return CheckpointStmt()
        if u == "EXPLAIN":
            self.next()
            return ExplainStmt(self._select())
        raise BinderError(f"unsupported statement start: {t.value!r}")

    def _create(self):
        self.expect("CREATE")
        kind = self.next().upper
        if kind == "TABLE":
            name = self.expect_ident()
            if self.accept("AS"):
                return CreateTableAs(name, self._select())
            self.expect("(")
            cols: dict = {}
            while True:
                cname = self.expect_ident()
                cols[cname] = self._column_type()
                if not self.accept(","):
                    break
            self.expect(")")
            return CreateTable(name, cols)
        if kind == "INDEX":
            name = self.expect_ident()
            self.expect("ON")
            table = self.expect_ident()
            self.expect("USING")
            using = self.expect_ident()
            if using.upper() != "HNSW":
                raise BinderError(f"unknown index type {using!r}")
            self.expect("(")
            column = self.expect_ident()
            self.expect(")")
            options: dict = {}
            if self.accept("WITH"):
                self.expect("(")
                while True:
                    key = self.expect_ident()
                    self.expect("=")
                    options[key.lower()] = self._option_value()
                    if not self.accept(","):
                        break
                self.expect(")")
            return CreateIndex(name, table, column, options)
        raise BinderError(f"unsupported CREATE {kind}")

    def _column_type(self):
        base = self.expect_ident().upper()
        if self.accept("["):
            n = int(self.next().value)
            self.expect("]")
            if base not in ("FLOAT", "REAL"):
                raise BinderError(
                    f"only FLOAT[N] array columns are supported, got {base}[]")
            return ("FLOAT", n)
        return {"INT": "INTEGER", "TEXT": "VARCHAR", "REAL": "FLOAT",
                "DOUBLE": "FLOAT"}.get(base, base)

    def _option_value(self):
        t = self.next()
        if t.kind == "num":
            return float(t.value) if "." in t.value else int(t.value)
        if t.kind == "str":
            return t.value
        if t.kind == "id":
            if t.upper == "TRUE":
                return True
            if t.upper == "FALSE":
                return False
            return t.value
        raise BinderError(f"bad option value {t.value!r}")

    def _drop(self):
        self.expect("DROP")
        kind = self.next().upper
        if kind not in ("TABLE", "INDEX"):
            raise BinderError(f"unsupported DROP {kind}")
        if_exists = False
        if self.accept("IF"):
            self.expect("EXISTS")
            if_exists = True
        return DropStmt(kind.lower(), self.expect_ident(), if_exists)

    def _insert(self):
        self.expect("INSERT")
        self.expect("INTO")
        table = self.expect_ident()
        columns = None
        if self.peek().value == "(" and self.peek(1).kind == "id" \
                and self.peek(1).upper != "SELECT":
            # optional explicit column list
            save = self.i
            self.next()
            cols = [self.expect_ident()]
            while self.accept(","):
                cols.append(self.expect_ident())
            if self.peek().value == ")" and \
                    self.peek(1).upper in ("VALUES", "SELECT"):
                self.next()
                columns = cols
            else:
                self.i = save
        if self.accept("VALUES"):
            rows = []
            while True:
                self.expect("(")
                row = [self.parse_expr()]
                while self.accept(","):
                    row.append(self.parse_expr())
                self.expect(")")
                rows.append(row)
                if not self.accept(","):
                    break
            return InsertStmt(table, columns, rows)
        if self.peek().upper == "SELECT" or self.peek().value == "(":
            if self.accept("("):
                sel = self._select()
                self.expect(")")
            else:
                sel = self._select()
            return InsertStmt(table, columns, None, sel)
        raise BinderError("INSERT expects VALUES or SELECT")

    def _delete(self):
        self.expect("DELETE")
        self.expect("FROM")
        table = self.expect_ident()
        where = self.parse_expr() if self.accept("WHERE") else None
        return DeleteStmt(table, where)

    def _update(self):
        self.expect("UPDATE")
        table = self.expect_ident()
        self.expect("SET")
        assigns = []
        while True:
            col = self.expect_ident()
            self.expect("=")
            assigns.append((col, self.parse_expr()))
            if not self.accept(","):
                break
        where = self.parse_expr() if self.accept("WHERE") else None
        return UpdateStmt(table, assigns, where)

    def _set(self):
        self.expect("SET")
        key = self.expect_ident()
        self.expect("=")
        return SetStmt(key, self._option_value())

    def _pragma(self):
        self.expect("PRAGMA")
        name = self.expect_ident()
        args: list = []
        if self.accept("("):
            if self.peek().value != ")":
                args.append(self._option_value())
                while self.accept(","):
                    args.append(self._option_value())
            self.expect(")")
        elif self.accept("="):
            args.append(self._option_value())
        return PragmaStmt(name.lower(), args)

    # -- SELECT ----------------------------------------------------------
    def _select(self) -> SelectStmt:
        self.expect("SELECT")
        projections = [self._projection()]
        while self.accept(","):
            projections.append(self._projection())
        from_items: list = []
        if self.accept("FROM"):
            from_items.append(self._from_item())
            while self.accept(","):
                from_items.append(self._from_item())
        where = self.parse_expr() if self.accept("WHERE") else None
        group_by = None
        if self.accept("GROUP"):
            self.expect("BY")
            group_by = [self.parse_expr()]
            while self.accept(","):
                group_by.append(self.parse_expr())
        order = None
        desc = False
        if self.accept("ORDER"):
            self.expect("BY")
            order = self.parse_expr()
            if self.accept("DESC"):
                desc = True
            else:
                self.accept("ASC")
        limit = None
        if self.accept("LIMIT"):
            limit = int(self.next().value)
        return SelectStmt(projections, from_items, where, order, desc,
                          limit, group_by)

    def _projection(self):
        if self.peek().value == "*":
            self.next()
            return Star()
        # a.* form
        if (self.peek().kind == "id" and self.peek(1).value == "."
                and self.peek(2).value == "*"):
            tbl = self.next().value
            self.next()
            self.next()
            return Star(tbl)
        e = self.parse_expr()
        if self.accept("AS"):
            return E.Aliased(e, self.expect_ident())
        # implicit alias: `expr ident`
        if self.peek().kind == "id" and self.peek().upper not in (
                "FROM", "WHERE", "ORDER", "GROUP", "LIMIT", "ASC", "DESC"):
            return E.Aliased(e, self.expect_ident())
        return e

    def _from_item(self):
        if self.accept("LATERAL"):
            self.expect("(")
            sub = self._select()
            self.expect(")")
            # optional alias
            if self.accept("AS"):
                self.expect_ident()
            elif self.peek().kind == "id" and self.peek().upper not in (
                    "WHERE", "ORDER", "GROUP", "LIMIT"):
                self.next()
            return Lateral(sub)
        if self.peek().value == "(":
            self.next()
            sub = self._select()
            self.expect(")")
            alias = None
            if self.accept("AS"):
                alias = self.expect_ident()
            elif self.peek().kind == "id" and self.peek().upper not in (
                    "WHERE", "ORDER", "GROUP", "LIMIT"):
                alias = self.next().value
            return Lateral(sub)  # subquery in FROM == lateral without refs
        name = self.expect_ident()
        if self.peek().value == "(":
            # table function
            self.next()
            args = []
            if self.peek().value != ")":
                args.append(self.parse_expr())
                while self.accept(","):
                    args.append(self.parse_expr())
            self.expect(")")
            item: Any
            if name.lower() == "range":
                item = RangeFunc([_const_value(a) for a in args])
            else:
                item = TableFunc(name.lower(), args)
            # alias with optional column rename: `range(1,10) ra(a)`
            if self.accept("AS"):
                item.alias = self.expect_ident()
            elif self.peek().kind == "id" and self.peek().upper not in (
                    "WHERE", "ORDER", "GROUP", "LIMIT", "LATERAL"):
                item.alias = self.next().value
            if item.alias is not None and self.peek().value == "(":
                self.next()
                cols = [self.expect_ident()]
                while self.accept(","):
                    cols.append(self.expect_ident())
                self.expect(")")
                if isinstance(item, RangeFunc):
                    item.colname = cols[0]
            return item
        alias = None
        if self.accept("AS"):
            alias = self.expect_ident()
        elif self.peek().kind == "id" and self.peek().upper not in (
                "WHERE", "ORDER", "GROUP", "LIMIT", "LATERAL", "USING",
                "SET"):
            alias = self.next().value
        return TableRef(name, alias)

    # -- expressions -----------------------------------------------------
    def parse_expr(self) -> E.Expr:
        return self._or()

    def _or(self):
        e = self._and()
        while self.accept("OR"):
            e = E.BinaryOp("or", e, self._and())
        return e

    def _and(self):
        e = self._not()
        while self.accept("AND"):
            e = E.BinaryOp("and", e, self._not())
        return e

    def _not(self):
        if self.accept("NOT"):
            return E.UnaryOp("not", self._not())
        return self._comparison()

    def _comparison(self):
        e = self._additive()
        while True:
            t = self.peek()
            if t.upper == "IS":
                self.next()
                neg = bool(self.accept("NOT"))
                self.expect("NULL")
                if neg:
                    e = E.IsNotNull(e)
                else:
                    e = E.UnaryOp("not", E.IsNotNull(e))
                continue
            if t.upper == "BETWEEN":
                self.next()
                lo = self._additive()
                self.expect("AND")
                hi = self._additive()
                e = E.BinaryOp("and", E.BinaryOp("<=", lo, e),
                               E.BinaryOp("<=", e, hi))
                continue
            if t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
                self.next()
                op = "!=" if t.value == "<>" else t.value
                e = E.BinaryOp(op, e, self._additive())
                continue
            return e

    def _additive(self):
        e = self._mult()
        while True:
            t = self.peek()
            if t.value in ("+", "-"):
                self.next()
                e = E.BinaryOp(t.value, e, self._mult())
            elif t.value in ("<->", "<=>", "<#>"):
                self.next()
                e = E.FunctionCall(t.value, [e, self._mult()])
            else:
                return e

    def _mult(self):
        e = self._unary()
        while self.peek().value in ("*", "/", "%"):
            op = self.next().value
            e = E.BinaryOp(op, e, self._unary())
        return e

    def _unary(self):
        if self.peek().value == "-":
            self.next()
            inner = self._unary()
            if isinstance(inner, E.Constant) and np.isscalar(inner.value):
                return E.Constant(-inner.value)
            return E.UnaryOp("-", inner)
        return self._postfix()

    def _postfix(self):
        e = self._primary()
        while True:
            if self.peek().value == "::":
                self.next()
                e = self._apply_cast(e, self._cast_type())
            elif self.peek().value == "[" and not isinstance(e, E.Constant):
                # list/array subscript — evaluate on constants only
                self.next()
                idx = self.parse_expr()
                self.expect("]")
                e = E.FunctionCall("list_extract", [e, idx])
            else:
                return e

    def _cast_type(self):
        base = self.expect_ident().upper()
        if self.accept("["):
            n = int(self.next().value)
            self.expect("]")
            return ("FLOAT", n)
        return base

    @staticmethod
    def _apply_cast(e: E.Expr, ty):
        if isinstance(ty, tuple):  # FLOAT[N]
            if isinstance(e, E.Constant):
                vec = np.asarray(e.value, np.float32)
                if vec.shape != (ty[1],):
                    raise BinderError(
                        f"cannot cast value of shape {vec.shape} to "
                        f"FLOAT[{ty[1]}]")
                return E.Constant(vec)
            return e  # columns are already typed
        if isinstance(e, E.Constant):
            v = e.value
            if ty in ("INT", "INTEGER", "BIGINT"):
                return E.Constant(int(v))
            if ty in ("FLOAT", "REAL", "DOUBLE"):
                return E.Constant(float(v))
            if ty in ("VARCHAR", "TEXT"):
                return E.Constant(str(v))
        return e

    def _primary(self):
        t = self.peek()
        if t.kind == "num":
            self.next()
            txt = t.value
            return E.Constant(float(txt) if ("." in txt or "e" in txt
                                             or "E" in txt) else int(txt))
        if t.kind == "str":
            self.next()
            return E.Constant(t.value)
        if t.value == "(":
            self.next()
            e = self.parse_expr()
            self.expect(")")
            return e
        if t.value == "[":
            return self._array_literal()
        if t.kind == "id":
            if t.upper == "NULL":
                self.next()
                return E.Constant(None)
            if t.upper == "TRUE":
                self.next()
                return E.Constant(True)
            if t.upper == "FALSE":
                self.next()
                return E.Constant(False)
            if t.upper == "ARRAY" and self.peek(1).value == "[":
                self.next()
                return self._array_literal()
            name = self.next().value
            if self.peek().value == "(":
                self.next()
                args = []
                order_by = None
                if self.peek().value == "*":
                    self.next()
                    args.append(Star())
                elif self.peek().value != ")":
                    args.append(self.parse_expr())
                    while self.accept(","):
                        args.append(self.parse_expr())
                # ordered aggregate: list(x ORDER BY k1, k2)
                if self.accept("ORDER"):
                    self.expect("BY")
                    order_by = [self.parse_expr()]
                    while self.accept(","):
                        order_by.append(self.parse_expr())
                    self.accept("ASC")
                self.expect(")")
                # window form: fn() OVER () — only the trivial frame the
                # reference tests use (row_number() over ())
                if self.accept("OVER"):
                    self.expect("(")
                    self.expect(")")
                    return E.FunctionCall("__window_" + name.lower(), args)
                fc = E.FunctionCall(name, args)
                fc.order_by = order_by
                return fc
            if self.peek().value == "." and self.peek(1).kind == "id":
                self.next()
                col = self.expect_ident()
                return E.ColumnRef(col, table=name)
            return E.ColumnRef(name)
        raise BinderError(f"unexpected token {t.value!r} in expression")

    def _array_literal(self):
        self.expect("[")
        elems = []
        if self.peek().value != "]":
            elems.append(self.parse_expr())
            while self.accept(","):
                elems.append(self.parse_expr())
        self.expect("]")
        if all(isinstance(x, E.Constant) and np.isscalar(x.value)
               for x in elems):
            return E.Constant(np.asarray([x.value for x in elems],
                                         np.float32))
        return E.FunctionCall("array_value", elems)


def _const_value(e: E.Expr):
    if isinstance(e, E.Constant):
        return e.value
    if isinstance(e, E.UnaryOp) and e.op == "-":
        return -_const_value(e.arg)
    if isinstance(e, E.FunctionCall) and e.name == "array_value":
        return np.asarray([_const_value(a) for a in e.args], np.float32)
    raise BinderError(f"expected a constant, got {e!r}")


def parse(sql: str) -> list:
    """Parse a script into a list of statement ASTs."""
    p = Parser(tokenize(sql))
    stmts = []
    while p.peek().kind != "end":
        stmts.append(p.parse_statement())
        while p.accept(";"):
            pass
    return stmts
