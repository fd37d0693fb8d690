"""sqllogictest runner (DuckDB dialect subset; port of
duckdb_vss_tpu/sql/sqllogic.py: the same format and directives, on a
database of the port on ``device``).

The reference ships its entire test suite as DuckDB sqllogictest files
(its test/sql/hnsw/*.test; SURVEY.md §4). This runner executes those
files — read in place, never vendored — against this engine's SQL
frontend, giving direct, mechanical parity evidence.

Supported directives (the subset the vss suite uses):
  require <feature>            vss / noforcestorage / vector_size N ok
  load <path>                  open a disk-backed database (__TEST_DIR__
                               substituted); creates it if absent
  restart                      reopen the current disk database
                               (checkpoint + WAL replay path)
  statement ok | error         execute; error may carry an expected
                               message after ---- (substring match)
  query <types> [sort] [label] execute, compare rows after ----;
                               `rowsort` sorts rows as strings;
                               a label stores the result and re-compares
                               every later query with the same label;
                               cells may be <REGEX>:pattern

Numeric cells compare with small tolerance (the reference's own tests
use approximate assertions for ANN results, hnsw_basic.test:26-31).

``skip_literal_blocks`` skips literal expected values (label
comparisons still enforced) for files whose literals encode DuckDB's
exact random() stream, which no reimplementation can reproduce
(hnsw_lateral_join_group.test pins ids drawn from setseed(0.1337)).
"""

from __future__ import annotations

import dataclasses
import math
import os
import re

import numpy as np
import torch

from duckdb_vss_tpu_torch.sql.engine import (
    Database,
    open_database,
)
from duckdb_vss_tpu_torch.utils.config import BinderError


class SkipFile(Exception):
    """Raised when a `require` is not satisfied."""


class SqlLogicFailure(AssertionError):
    pass


_KNOWN_REQUIRES = {"vss", "noforcestorage", "vector_size"}
_SORT_MODES = {"rowsort", "nosort", "valuesort"}


@dataclasses.dataclass
class _Record:
    kind: str  # 'statement' | 'query' | 'require' | 'load' | 'restart'
    arg: str = ""
    sql: str = ""
    expected: list[str] | None = None  # lines after ----
    sort: str = "nosort"
    label: str | None = None
    line: int = 0


def _expand_loops(lines: list[str]) -> list[str]:
    """Expand `loop var start end` ... `endloop` (end-exclusive, DuckDB
    sqllogictest semantics) with ${var} substitution."""
    out: list[str] = []
    i = 0
    while i < len(lines):
        head = lines[i].strip().split()
        if head and head[0] == "loop":
            var, start, end = head[1], int(head[2]), int(head[3])
            depth, j = 1, i + 1
            body: list[str] = []
            while j < len(lines):
                w = lines[j].strip().split()
                if w and w[0] == "loop":
                    depth += 1
                if w and w[0] == "endloop":
                    depth -= 1
                    if depth == 0:
                        break
                body.append(lines[j])
                j += 1
            if depth != 0:
                raise SqlLogicFailure("loop without endloop")
            inner = _expand_loops(body)
            for it in range(start, end):
                out.extend(ln.replace("${" + var + "}", str(it))
                           for ln in inner)
            i = j + 1
        else:
            out.append(lines[i])
            i += 1
    return out


def parse_file(path: str,
               substitutions: dict[str, str] | None = None) -> list[_Record]:
    with open(path) as f:
        lines = f.read().splitlines()
    if substitutions:
        for old, new in substitutions.items():
            lines = [ln.replace(old, new) for ln in lines]
    lines = _expand_loops(lines)
    recs: list[_Record] = []
    i, n = 0, len(lines)
    while i < n:
        line = lines[i].strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        lineno = i + 1
        head = line.split()
        kw = head[0]
        if kw == "require":
            recs.append(_Record("require", " ".join(head[1:]), line=lineno))
            i += 1
            continue
        if kw == "load":
            recs.append(_Record("load", head[1], line=lineno))
            i += 1
            continue
        if kw == "restart":
            recs.append(_Record("restart", line=lineno))
            i += 1
            continue
        if kw in ("statement", "query"):
            rec = _Record(kw, line=lineno)
            if kw == "statement":
                rec.arg = head[1]  # ok | error
            else:
                rec.arg = head[1] if len(head) > 1 else ""
                rest = head[2:]
                if rest and rest[0] in _SORT_MODES:
                    rec.sort = rest[0]
                    rest = rest[1:]
                if rest:
                    rec.label = rest[0]
            i += 1
            sql_lines = []
            while i < n and lines[i].strip() and lines[i].strip() != "----":
                sql_lines.append(lines[i])
                i += 1
            rec.sql = "\n".join(sql_lines)
            if i < n and lines[i].strip() == "----":
                i += 1
                exp = []
                while i < n and lines[i].strip():
                    exp.append(lines[i].rstrip("\n"))
                    i += 1
                rec.expected = exp
            recs.append(rec)
            continue
        if kw in ("mode", "set"):  # harness modes we don't need
            i += 1
            continue
        raise SqlLogicFailure(f"{path}:{lineno}: unknown directive {kw!r}")
    return recs


# -- value formatting (DuckDB result style) ----------------------------------


def format_value(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        f = float(v)
        if math.isnan(f):
            return "NULL"
        if f == int(f) and abs(f) < 1e15:
            return f"{f:.1f}"
        return f"{f:.6g}"
    if isinstance(v, (list, tuple, np.ndarray)):
        arr = list(v)
        if arr and all(isinstance(x, (float, np.floating)) for x in arr) \
                and all(math.isnan(float(x)) for x in arr):
            return "NULL"  # a NULL vector round-trips as a NaN row
        return "[" + ", ".join(format_value(x) for x in arr) + "]"
    return str(v)


def _cell_matches(expected: str, actual: str) -> bool:
    expected = expected.strip()
    if expected.startswith("<REGEX>:"):
        return re.search(expected[len("<REGEX>:"):], actual,
                         re.DOTALL) is not None
    if expected == actual:
        return True
    # booleans under an integer column type render 1/0 in DuckDB
    if actual in ("true", "false"):
        if expected == ("1" if actual == "true" else "0"):
            return True
    # numeric tolerance (ANN distances; f32 rounding)
    try:
        e, a = float(expected), float(actual)
        return math.isclose(e, a, rel_tol=1e-4, abs_tol=1e-4)
    except ValueError:
        pass
    # element-wise list compare
    if expected.startswith("[") and actual.startswith("["):
        es = [s for s in expected[1:-1].split(",")]
        as_ = [s for s in actual[1:-1].split(",")]
        return len(es) == len(as_) and all(
            _cell_matches(e.strip(), a.strip()) for e, a in zip(es, as_))
    return False


def _rows_from_result(result) -> list[list[str]]:
    if result is None:
        return []
    if isinstance(result, str):  # EXPLAIN output
        return [["physical_plan", result]]
    if isinstance(result, dict):
        cols = list(result.values())
        if not cols:
            return []
        n = len(cols[0])
        return [[format_value(_cell(c, i)) for c in cols] for i in range(n)]
    if isinstance(result, (int, np.integer)):
        return [[format_value(result)]]
    raise SqlLogicFailure(f"cannot interpret result {type(result)}")


def _cell(col, i):
    v = col[i]
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return v.item()
    return v


class SqlLogicRunner:
    def __init__(self, test_dir: str, skip_literal_blocks: bool = False,
                 substitutions: dict[str, str] | None = None,
                 device: str | torch.device = "cuda"):
        self.test_dir = test_dir
        self.device = device
        self.skip_literal_blocks = skip_literal_blocks
        # documented scale knob: textual substitutions applied before
        # parsing (the 1M-row slow tests assert scale-invariant relative
        # properties; CI runs them scaled down, full scale on the card)
        self.substitutions = substitutions
        self.db = Database(device=device)
        self.db_path: str | None = None
        self.labels: dict[str, list[str]] = {}

    # -- directive execution --------------------------------------------
    def run_file(self, path: str) -> int:
        """Run every record; returns the number of queries checked.
        Raises SkipFile / SqlLogicFailure."""
        checked = 0
        for rec in parse_file(path, substitutions=self.substitutions):
            self._run_record(path, rec)
            if rec.kind == "query":
                checked += 1
        return checked

    def _fail(self, path, rec, msg):
        raise SqlLogicFailure(f"{path}:{rec.line}: {msg}\nSQL: {rec.sql}")

    def _run_record(self, path: str, rec: _Record) -> None:
        if rec.kind == "require":
            feature = rec.arg.split()[0] if rec.arg else ""
            if feature not in _KNOWN_REQUIRES:
                raise SkipFile(rec.arg)
            return
        if rec.kind == "load":
            p = rec.arg.replace("__TEST_DIR__", self.test_dir)
            self.db_path = p
            self.db = (open_database(p, device=self.device)
                       if os.path.exists(p)
                       else Database(p, device=self.device))
            return
        if rec.kind == "restart":
            if self.db_path is None:
                raise SqlLogicFailure(f"{path}:{rec.line}: restart "
                                      "without load")
            self.db = open_database(self.db_path, device=self.device)
            return
        if rec.kind == "statement":
            try:
                self.db.execute(rec.sql)
            except Exception as err:  # noqa: BLE001
                if rec.arg == "error":
                    if rec.expected:
                        exp = "\n".join(rec.expected).strip()
                        actual = _error_text(err)
                        if exp not in actual:
                            self._fail(path, rec,
                                       f"error message mismatch:\n"
                                       f"  expected: {exp}\n"
                                       f"  actual:   {actual}")
                    return
                self._fail(path, rec, f"unexpected error: {err!r}")
            if rec.arg == "error":
                self._fail(path, rec, "expected an error, statement passed")
            return
        if rec.kind == "query":
            try:
                result = self.db.execute(rec.sql)
            except Exception as err:  # noqa: BLE001
                self._fail(path, rec, f"query failed: {err!r}")
            rows = _rows_from_result(result)
            if rec.sort == "rowsort":
                rows = sorted(rows)
            elif rec.sort == "valuesort":
                rows = sorted([[c] for r in rows for c in r])
            flat = ["\t".join(r) for r in rows]
            if rec.expected and not self.skip_literal_blocks:
                exp_rows = [e.split("\t") for e in rec.expected]
                if rec.sort == "rowsort":
                    exp_rows = sorted(exp_rows)
                elif rec.sort == "valuesort":
                    exp_rows = sorted(exp_rows)
                if len(exp_rows) != len(rows):
                    self._fail(path, rec,
                               f"row count mismatch: expected "
                               f"{len(exp_rows)}, got {len(rows)}:\n"
                               + "\n".join(flat))
                for er, ar in zip(exp_rows, rows):
                    if len(er) != len(ar) or not all(
                            _cell_matches(e, a) for e, a in zip(er, ar)):
                        self._fail(path, rec,
                                   f"row mismatch:\n  expected: {er}\n"
                                   f"  actual:   {ar}")
            if rec.label is not None:
                if rec.label in self.labels:
                    if self.labels[rec.label] != flat:
                        self._fail(
                            path, rec,
                            f"labeled result '{rec.label}' differs:\n"
                            f"  first: {self.labels[rec.label]}\n"
                            f"  now:   {flat}")
                else:
                    self.labels[rec.label] = flat
            return
        raise SqlLogicFailure(f"unhandled record kind {rec.kind}")


def _error_text(err: Exception) -> str:
    if isinstance(err, BinderError):
        return f"Binder Error: {err}"
    return f"{type(err).__name__}: {err}"


def run_sqllogic_file(path: str, test_dir: str,
                      skip_literal_blocks: bool = False,
                      substitutions: dict[str, str] | None = None,
                      device: str | torch.device = "cuda") -> int:
    """Convenience wrapper: run one .test file, return #queries checked."""
    return SqlLogicRunner(
        test_dir, skip_literal_blocks=skip_literal_blocks,
        substitutions=substitutions, device=device).run_file(path)
