"""Expression layer: column refs, constants, distance function calls,
and the canonicalization rewrite (port of duckdb_vss_tpu/sql/expr.py).

Mirrors the reference's expression handling:
- distance function names + operator aliases (<->, <=>, <#>) matched by
  the index's function matcher (the reference's src/hnsw/
  hnsw_index.cpp:632-662);
- the `1.0 - array_cosine_similarity(a, b) -> array_cosine_distance(a, b)`
  rewrite rule (hnsw_optimize_expr.cpp:18-75).

``evaluate`` takes the device explicitly: the SQL scalar functions
(ops/distance.SCALAR_FUNCTIONS) run there, on tensors the call moves
there, and their results come back as float32 numpy arrays. Everything
else (column refs, arithmetic, comparisons) is numpy on the host, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from duckdb_vss_tpu_torch.ops.distance import SCALAR_FUNCTIONS
from duckdb_vss_tpu_torch.utils.config import FUNCTION_TO_METRIC

OPERATOR_ALIASES = {"<->": "array_distance",
                    "<=>": "array_cosine_distance",
                    "<#>": "array_negative_inner_product"}


class Expr:
    def __sub__(self, other):
        return BinaryOp("-", self, _wrap(other))

    def __rsub__(self, other):
        return BinaryOp("-", _wrap(other), self)

    def __eq__(self, other):  # noqa: D105
        return BinaryOp("=", self, _wrap(other))

    def __lt__(self, other):
        return BinaryOp("<", self, _wrap(other))

    def __le__(self, other):
        return BinaryOp("<=", self, _wrap(other))

    def __gt__(self, other):
        return BinaryOp(">", self, _wrap(other))

    def __ge__(self, other):
        return BinaryOp(">=", self, _wrap(other))

    def __ne__(self, other):
        return BinaryOp("!=", self, _wrap(other))

    def __hash__(self):
        return id(self)

    def alias(self, name: str) -> "Aliased":
        return Aliased(self, name)


def _wrap(v) -> "Expr":
    return v if isinstance(v, Expr) else Constant(v)


@dataclasses.dataclass(eq=False, repr=False)
class ColumnRef(Expr):
    name: str
    table: str | None = None

    def __repr__(self):
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclasses.dataclass(eq=False, repr=False)
class Constant(Expr):
    value: Any

    def __repr__(self):
        v = self.value
        if isinstance(v, (list, tuple, np.ndarray)) and len(np.shape(v)) == 1:
            return f"const_vec[{len(v)}]"
        return repr(v)


@dataclasses.dataclass(eq=False, repr=False)
class FunctionCall(Expr):
    name: str
    args: list
    # ordered-aggregate keys: list(x ORDER BY k1, k2)
    order_by: list | None = None

    def __post_init__(self):
        self.name = OPERATOR_ALIASES.get(self.name, self.name).lower()

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(eq=False, repr=False)
class BinaryOp(Expr):
    op: str
    left: Expr
    right: Expr

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclasses.dataclass(eq=False, repr=False)
class UnaryOp(Expr):
    op: str
    arg: Expr

    def __repr__(self):
        return f"({self.op} {self.arg!r})"


@dataclasses.dataclass(eq=False, repr=False)
class IsNotNull(Expr):
    arg: Expr

    def __repr__(self):
        return f"({self.arg!r} IS NOT NULL)"


@dataclasses.dataclass(eq=False, repr=False)
class Aliased(Expr):
    expr: Expr
    name: str

    def __repr__(self):
        return f"{self.expr!r} AS {self.name}"


# -- public constructors ----------------------------------------------------


def col(name: str, table: str | None = None) -> ColumnRef:
    return ColumnRef(name, table)


def const(value) -> Constant:
    return Constant(value)


def fn(name: str, *args) -> FunctionCall:
    return FunctionCall(name, [_wrap(a) for a in args])


# -- analysis helpers -------------------------------------------------------


def canonicalize(e: Expr) -> Expr:
    """Apply the reference's expression rewrite rules bottom-up.

    Currently one rule (hnsw_optimize_expr.cpp:18-75):
      1.0 - array_cosine_similarity(a, b)  ->  array_cosine_distance(a, b)
    """
    if isinstance(e, BinaryOp):
        left = canonicalize(e.left)
        right = canonicalize(e.right)
        if (
            e.op == "-"
            and isinstance(left, Constant)
            and isinstance(left.value, (int, float))
            and float(left.value) == 1.0
            and isinstance(right, FunctionCall)
            and right.name == "array_cosine_similarity"
        ):
            return FunctionCall("array_cosine_distance", right.args)
        return BinaryOp(e.op, left, right)
    if isinstance(e, FunctionCall):
        return FunctionCall(e.name, [canonicalize(a) for a in e.args])
    if isinstance(e, Aliased):
        return Aliased(canonicalize(e.expr), e.name)
    if isinstance(e, IsNotNull):
        return IsNotNull(canonicalize(e.arg))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, canonicalize(e.arg))
    return e


def match_distance_call(e: Expr):
    """If ``e`` is a known distance function call over (column, constant
    vector) in either argument order, return
    (function_name, metric, column_ref, query_vector) else None.
    Mirrors TryMatchDistanceFunction + constant-vector extraction
    (hnsw_optimize_scan.cpp:103-141)."""
    if isinstance(e, Aliased):
        e = e.expr
    if not isinstance(e, FunctionCall) or e.name not in FUNCTION_TO_METRIC:
        return None
    if len(e.args) != 2:
        return None
    a, b = e.args
    for colx, constx in ((a, b), (b, a)):
        if isinstance(colx, ColumnRef) and isinstance(constx, Constant):
            vec = np.asarray(constx.value, dtype=np.float32)
            if vec.ndim != 1:
                continue
            return e.name, FUNCTION_TO_METRIC[e.name], colx, vec
    return None


def expr_columns(e: Expr) -> set[str]:
    """All column names referenced by ``e``."""
    if isinstance(e, ColumnRef):
        return {e.name}
    if isinstance(e, FunctionCall):
        return set().union(*[expr_columns(a) for a in e.args]) if e.args else set()
    if isinstance(e, BinaryOp):
        return expr_columns(e.left) | expr_columns(e.right)
    if isinstance(e, Aliased):
        return expr_columns(e.expr)
    if isinstance(e, IsNotNull):
        return expr_columns(e.arg)
    if isinstance(e, UnaryOp):
        return expr_columns(e.arg)
    return set()


# session RNG backing SQL setseed()/random() (DuckDB's generator stream
# differs; tests depending on literal random() draws compare labeled
# result sets instead — see sql/sqllogic.py)
_SQL_RNG = np.random.default_rng(0)


def _batch_rows(batch) -> int:
    for v in batch.values():
        return len(v)
    return 1


def _fn_setseed(args, n):
    global _SQL_RNG
    seed = float(args[0]) if args else 0.0
    _SQL_RNG = np.random.default_rng(abs(int(seed * 2**31)))
    return None if n == 1 else np.full(n, None, object)


_ROW_CONTEXT_FUNCTIONS = {
    "random": lambda args, n: _SQL_RNG.random(n),
    "setseed": _fn_setseed,
    "__window_row_number": lambda args, n: np.arange(1, n + 1,
                                                     dtype=np.int64),
}


def call_function(name: str, args: list, device: torch.device) -> np.ndarray:
    """A SQL scalar function (SCALAR_FUNCTIONS[name]) over evaluated
    arguments, on ``device``: every argument is copied there as float32
    (a constant 1-D query vector is broadcast against a column of
    vectors there), the function runs there, and the float32 result
    comes back to the host."""
    impl = SCALAR_FUNCTIONS.get(name)
    if impl is None:
        raise KeyError(f"unknown function {name}")
    ts = [torch.from_numpy(np.require(a, np.float32, ["C", "W"])).to(device)
          for a in args]
    if max(t.ndim for t in ts) == 2:
        n = next(t.shape[0] for t in ts if t.ndim == 2)
        ts = [t.expand(n, t.shape[0]) if t.ndim == 1 else t for t in ts]
    return impl(*ts).cpu().numpy()


def evaluate(e: Expr, batch: dict[str, np.ndarray],
             device: torch.device) -> np.ndarray:
    """Evaluate an expression over a column batch: host numpy, but for
    the SQL scalar functions, which run on ``device`` (call_function)."""
    if isinstance(e, Aliased):
        return evaluate(e.expr, batch, device)
    if isinstance(e, ColumnRef):
        if e.table is not None and f"{e.table}.{e.name}" in batch:
            return batch[f"{e.table}.{e.name}"]
        return batch[e.name]
    if isinstance(e, Constant):
        return e.value
    if isinstance(e, FunctionCall):
        if e.name in _ROW_CONTEXT_FUNCTIONS:
            return _ROW_CONTEXT_FUNCTIONS[e.name](
                [evaluate(a, batch, device) for a in e.args],
                _batch_rows(batch))
        if e.name == "len":
            v = evaluate(e.args[0], batch, device)
            if isinstance(v, np.ndarray) and v.dtype == object:
                return np.asarray([len(x) for x in v])
            return len(v)
        return call_function(e.name, [evaluate(a, batch, device)
                                      for a in e.args], device)
    if isinstance(e, BinaryOp):
        left = evaluate(e.left, batch, device)
        right = evaluate(e.right, batch, device)
        ops = {
            "+": lambda a, b: a + b,
            "-": lambda a, b: a - b,
            "*": lambda a, b: a * b,
            "/": lambda a, b: a / b,
            "%": lambda a, b: a % b,
            "=": lambda a, b: a == b,
            "!=": lambda a, b: a != b,
            "<": lambda a, b: a < b,
            "<=": lambda a, b: a <= b,
            ">": lambda a, b: a > b,
            ">=": lambda a, b: a >= b,
            "and": lambda a, b: np.asarray(a, bool) & np.asarray(b, bool),
            "or": lambda a, b: np.asarray(a, bool) | np.asarray(b, bool),
        }
        res = ops[e.op](left, right)
        # ARRAY comparison (vec = ARRAY[...]): reduce the elementwise
        # result over the vector axis to one boolean per row
        if e.op in ("=", "!=") and np.ndim(res) == 2:
            res = np.asarray(res)
            res = res.any(axis=1) if e.op == "!=" else res.all(axis=1)
        return res
    if isinstance(e, UnaryOp):
        v = evaluate(e.arg, batch, device)
        if e.op == "-":
            return -v
        if e.op == "not":
            return ~np.asarray(v, bool)
        raise TypeError(f"unknown unary op {e.op}")
    if isinstance(e, IsNotNull):
        v = evaluate(e.arg, batch, device)
        if v.dtype == object:
            return np.array([x is not None for x in v])
        if np.issubdtype(v.dtype, np.floating) and v.ndim == 2:
            return ~np.isnan(v).any(axis=1)
        return ~np.isnan(v) if np.issubdtype(v.dtype, np.floating) else np.ones(
            len(v), bool)
    raise TypeError(f"cannot evaluate {e!r}")
