"""Database / Table / query layer (port of duckdb_vss_tpu/sql/engine.py):
the host-engine surface the reference gets from DuckDB, re-built thin
around the device executors.

A Database lives on one device (``device=``, CUDA unless the caller asks
for the CPU): every HNSW index and flat column block it makes is on that
device, and so are the SQL scalar functions its expressions evaluate.
Table storage stays on the host, as in the JAX package: per-row lists
and a live list, rowid == position.

Covers the reference capability checklist (SURVEY §7.1):
- CREATE INDEX ... USING HNSW with option validation
  (hnsw_index_plan.cpp:21-99) and persistence gating;
- ORDER BY distance LIMIT k -> HNSW_INDEX_SCAN rewrite with constant
  query-vector matching, metric/function matching, runtime ef_search
  override, and table-filter pull-up (hnsw_optimize_scan.cpp);
- min_by top-k rewrite (hnsw_optimize_topk.cpp);
- lateral k-NN join -> batched index multi-scan
  (hnsw_optimize_join.cpp) — here naturally batch-parallel;
- vss_join / vss_match brute-force macros (hnsw_index_macros.cpp);
- insert/delete/update index maintenance (§3.4) incl. NULL skipping;
- PRAGMA hnsw_compact_index / hnsw_index_info (hnsw_index_pragmas.cpp);
- settings hnsw_ef_search, hnsw_enable_experimental_persistence
  (hnsw_index.cpp:667-691).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

import torch

from duckdb_vss_tpu_torch.models.flat import FlatIndex
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.sql import expr as E
from duckdb_vss_tpu_torch.sql import plan as P
from duckdb_vss_tpu_torch.utils.config import (
    BinderError,
    HNSWConfig,
    MetricKind,
)
from duckdb_vss_tpu_torch.utils.device import resolve_device
from duckdb_vss_tpu_torch.utils.tracing import annotate, span


class VectorType:
    """ARRAY(FLOAT, N) — the only indexable type, like the reference
    (hnsw_index_plan.cpp:83-99 / SCALAR_KIND_MAP f32-only)."""

    def __init__(self, dims: int):
        self.dims = int(dims)

    def __repr__(self):
        return f"FLOAT[{self.dims}]"


@dataclasses.dataclass
class IndexEntry:
    name: str
    table: "Table"
    column: str
    index: HNSWIndex

    @property
    def metric(self) -> MetricKind:
        return self.index.metric


class Table:
    """Append-only row storage with delete bitmap; rowid == position.

    The vector column also keeps a lazily-refreshed device-resident block
    (FlatIndex, on the database's device) used by brute-force scans — the
    analog of DuckDB's buffer-managed column segments, in device memory.
    """

    def __init__(self, db: "Database", name: str, columns: dict):
        self.db = db
        self.name = name
        self.columns: dict[str, Any] = {}
        for cname, ctype in columns.items():
            if isinstance(ctype, tuple) and str(ctype[0]).upper() == "FLOAT":
                self.columns[cname] = VectorType(ctype[1])
            else:
                self.columns[cname] = str(ctype).upper()
        self._data: dict[str, list] = {c: [] for c in self.columns}
        self._live: list[bool] = []
        self._flat_cache: dict[str, FlatIndex] = {}
        self._flat_dirty: set[str] = set(self.vector_columns())
        # changed since the last checkpoint (block-image dirty flag)
        self._ckpt_dirty = True

    # -- schema helpers ------------------------------------------------
    def vector_columns(self) -> list[str]:
        return [c for c, t in self.columns.items()
                if isinstance(t, VectorType)]

    def vector_dims(self, column: str) -> int:
        t = self.columns[column]
        if not isinstance(t, VectorType):
            raise BinderError(f"column '{column}' is not a FLOAT[N] array")
        return t.dims

    @property
    def row_count(self) -> int:
        return sum(self._live)

    # -- DML -----------------------------------------------------------
    def insert(self, rows) -> np.ndarray:
        """Insert rows (list of dicts or dict of columns). Returns rowids.
        Propagates to indexes, skipping NULL vectors
        (hnsw_index.cpp:436-440)."""
        if isinstance(rows, dict):
            n = len(next(iter(rows.values())))
            rows = [
                {c: (rows[c][i] if c in rows else None)
                 for c in self.columns} for i in range(n)
            ]
        start = len(self._live)
        for r in rows:
            for c, t in self.columns.items():
                v = r.get(c)
                if v is not None and isinstance(t, VectorType):
                    v = np.asarray(v, np.float32)
                    if v.shape != (t.dims,):
                        raise BinderError(
                            f"vector for '{c}' must have {t.dims} elements")
                self._data[c].append(v)
            self._live.append(True)
        rowids = np.arange(start, len(self._live), dtype=np.int64)
        self._flat_dirty |= set(self.vector_columns())
        self._ckpt_dirty = True
        for entry in self.db.indexes_on(self.name):
            vecs, ids = self._gather_index_rows(entry.column, rowids)
            if len(ids):
                entry.index.add(vecs, ids)
        if self.name in self.db.tables:  # macro temp tables are not logged
            self.db._log({"op": "insert", "table": self.name, "rows": rows})
        return rowids

    def delete(self, predicate: E.Expr | None = None,
               rowids: np.ndarray | None = None) -> int:
        if rowids is None:
            batch, ids = self.scan()
            mask = (np.asarray(E.evaluate(predicate, batch, self.db.device),
                               bool)
                    if predicate is not None else np.ones(len(ids), bool))
            rowids = ids[mask]
        n = 0
        for rid in np.asarray(rowids, np.int64).reshape(-1):
            if 0 <= rid < len(self._live) and self._live[rid]:
                self._live[rid] = False
                n += 1
        if n:
            self._flat_dirty |= set(self.vector_columns())
            self._ckpt_dirty = True
            for entry in self.db.indexes_on(self.name):
                entry.index.remove(
                    [r for r in np.asarray(rowids).tolist()
                     if entry.index.store._key_to_slot.get(int(r)) is not None])
            if self.name in self.db.tables:
                self.db._log({"op": "delete", "table": self.name,
                              "rowids": np.asarray(rowids, np.int64)})
        return n

    def update(self, rowids, rows) -> np.ndarray:
        """UPDATE = DELETE + INSERT (DuckDB semantics, SURVEY §3.4)."""
        self.delete(rowids=np.asarray(rowids))
        return self.insert(rows)

    # -- scan / fetch ----------------------------------------------------
    def scan(self) -> tuple[dict[str, np.ndarray], np.ndarray]:
        ids = np.nonzero(self._live)[0].astype(np.int64)
        return self.fetch(ids), ids

    def fetch(self, rowids: np.ndarray) -> dict[str, np.ndarray]:
        """Random-access row fetch (DataTable::Fetch analog)."""
        rowids = np.asarray(rowids, np.int64)
        out = {}
        for c, t in self.columns.items():
            colvals = self._data[c]
            if isinstance(t, VectorType):
                arr = np.full((len(rowids), t.dims), np.nan, np.float32)
                for i, rid in enumerate(rowids):
                    v = colvals[rid]
                    if v is not None:
                        arr[i] = v
                out[c] = arr
            elif t in ("BIGINT", "INTEGER", "INT"):
                out[c] = np.array(
                    [colvals[rid] for rid in rowids], dtype=np.int64)
            elif t in ("DOUBLE", "FLOAT"):
                out[c] = np.array(
                    [colvals[rid] for rid in rowids], dtype=np.float64)
            else:
                out[c] = np.array([colvals[rid] for rid in rowids],
                                  dtype=object)
        out["rowid"] = rowids
        return out

    def _gather_index_rows(self, column, rowids):
        """Non-NULL (vector, rowid) pairs for index maintenance."""
        dims = self.vector_dims(column)
        vecs, ids = [], []
        for rid in np.asarray(rowids, np.int64).reshape(-1):
            v = self._data[column][rid]
            if v is not None:
                vecs.append(np.asarray(v, np.float32))
                ids.append(rid)
        if not ids:
            return np.zeros((0, dims), np.float32), np.zeros(0, np.int64)
        return np.stack(vecs), np.asarray(ids, np.int64)

    def flat_column(self, column: str) -> FlatIndex:
        """Device-resident brute-force block for a vector column."""
        if column in self._flat_dirty or column not in self._flat_cache:
            dims = self.vector_dims(column)
            fi = FlatIndex(dims, MetricKind.L2SQ,
                           capacity=max(len(self._live), 1),
                           device=self.db.device)
            ids = np.nonzero(self._live)[0].astype(np.int64)
            vecs, ids = self._gather_index_rows(column, ids)
            if len(ids):
                fi.add(vecs, ids)
            self._flat_cache[column] = fi
            self._flat_dirty.discard(column)
        return self._flat_cache[column]

    # -- query entry -----------------------------------------------------
    def select(self, *exprs) -> "QueryBuilder":
        return QueryBuilder(self).select(*exprs)

    def order_by(self, e) -> "QueryBuilder":
        return QueryBuilder(self).order_by(e)

    def where(self, e) -> "QueryBuilder":
        return QueryBuilder(self).where(e)


class Database:
    """Tables, HNSW indexes and settings on one device.

    path: a directory for the WAL, the block file and the catalog (None:
    in memory, nothing logged). device: where indexes, flat blocks and
    scalar functions run; "cuda" raises without a card. wal_fsync: fsync
    every WAL append (the JAX package's DVT_WAL_FSYNC, on by default: a
    WAL that can vanish in the page cache protects nothing)."""

    def __init__(self, path: str | None = None,
                 device: str | torch.device = "cuda",
                 wal_fsync: bool = True):
        self.path = path
        self.device = resolve_device(device)
        self.tables: dict[str, Table] = {}
        self.indexes: dict[str, IndexEntry] = {}
        self.settings = {
            "hnsw_ef_search": 0,  # 0 = use index default
            "hnsw_enable_experimental_persistence": False,
            # PRAGMA disable_optimizer/enable_optimizer: gates the E8/E9/
            # E10/E11 rewrites so plans fall back to brute-force scans
            # (the reference tests toggle this for differential checks)
            "optimizer_enabled": True,
        }
        # WAL (GetStorageInfo(to_wal) analog, hnsw_index.cpp:534-554):
        # disk-backed databases log DML/DDL; checkpoint truncates;
        # open_database replays records newer than the checkpoint.
        self.wal = None
        self._wal_replaying = False
        self._block_mgr = None
        if path is not None:
            import os as _os

            from duckdb_vss_tpu_torch.utils.wal import WriteAheadLog

            _os.makedirs(path, exist_ok=True)
            self.wal = WriteAheadLog(_os.path.join(path, "vss.wal"),
                                     fsync=bool(wal_fsync))

    def _log(self, record: dict) -> None:
        if self.wal is not None and not self._wal_replaying:
            self.wal.append(record)

    # -- block-managed storage --------------------------------------------
    def block_manager(self, directory: str | None = None):
        """The database's block allocator (data.vssblk) — the reference's
        FixedSizeAllocator analog. Lazy; shared across checkpoints so the
        free list persists within a session (it is also saved in the
        catalog for reopen)."""
        import os as _os

        from duckdb_vss_tpu_torch.utils.blockstore import BlockManager

        directory = directory or self.path
        if directory is None:
            raise BinderError("in-memory database has no block storage")
        path = _os.path.join(directory, "data.vssblk")
        if self._block_mgr is None or self._block_mgr.path != path:
            free: list[int] = []
            catalog_path = _os.path.join(directory, "catalog.json")
            if _os.path.exists(catalog_path):
                import json

                with open(catalog_path) as f:
                    cat = json.load(f)
                free = list(cat.get("free_blocks", []))
            self._block_mgr = BlockManager(path, free_blocks=free)
        return self._block_mgr

    def pragma_database_size(self) -> dict:
        """pragma_database_size() row (DuckDB schema subset): block
        accounting over the database's block file. In-memory databases
        report zero blocks, like DuckDB's in-memory path."""
        if self.path is None:
            return {"database_size": 0, "block_size": 0, "total_blocks": 0,
                    "used_blocks": 0, "free_blocks": 0, "wal_size": 0}
        import os as _os

        mgr = self.block_manager()
        total = mgr.total_blocks()
        free = len(mgr.free_blocks)
        wal_path = _os.path.join(self.path, "vss.wal")
        wal_size = (_os.path.getsize(wal_path)
                    if _os.path.exists(wal_path) else 0)
        return {
            "database_size": total * mgr.block_size,
            "block_size": mgr.block_size,
            "total_blocks": total,
            "used_blocks": total - free,
            "free_blocks": free,
            "wal_size": wal_size,
        }

    # -- SQL text surface ------------------------------------------------
    @span("sql.execute")
    def execute(self, sql: str):
        """Execute a SQL script (the reference's L5 surface). Query
        statements return a column batch dict; EXPLAIN returns the
        physical plan string; DDL returns None."""
        from duckdb_vss_tpu_torch.sql.frontend import execute_sql
        return execute_sql(self, sql)

    sql = execute

    # -- catalog ---------------------------------------------------------
    def create_table(self, name: str, columns: dict) -> Table:
        if name in self.tables:
            raise BinderError(f"table '{name}' already exists")
        t = Table(self, name, columns)
        self.tables[name] = t
        self._log({"op": "create_table", "name": name,
                   "columns": {c: (["FLOAT", ty.dims]
                                   if isinstance(ty, VectorType) else ty)
                               for c, ty in t.columns.items()}})
        return t

    def table(self, name: str) -> Table:
        return self.tables[name]

    def drop_table(self, name: str) -> None:
        for iname in [i for i, e in self.indexes.items()
                      if e.table.name == name]:
            del self.indexes[iname]
        del self.tables[name]
        self._log({"op": "drop_table", "name": name})

    def set(self, key: str, value) -> None:
        if key not in self.settings:
            raise BinderError(f"unknown setting '{key}'")
        self.settings[key] = value
        self._log({"op": "set", "key": key, "value": value})

    def indexes_on(self, table_name: str) -> list[IndexEntry]:
        return [e for e in self.indexes.values()
                if e.table.name == table_name]

    # -- CREATE INDEX ----------------------------------------------------
    def create_hnsw_index(self, name: str, table_name: str, column: str,
                          on_progress=None, **options) -> IndexEntry:
        """CREATE INDEX name ON table USING HNSW (column) WITH (options).

        on_progress(phase, fraction) mirrors the reference's two-phase
        sink progress — phase 'load' (buffering rows) then 'build'
        (graph construction), each reported in [0, 1]
        (hnsw_index_physical_create.cpp:308-323)."""
        if name in self.indexes:
            raise BinderError(f"index '{name}' already exists")
        if self.path is not None and not self.settings[
                "hnsw_enable_experimental_persistence"]:
            # hnsw_index_plan.cpp:21-30
            raise BinderError(
                "HNSW indexes can only be created in in-memory databases, or "
                "when the configuration option "
                "'hnsw_enable_experimental_persistence' is set to true.")
        table = self.tables[table_name]
        dims = table.vector_dims(column)  # validates FLOAT[N] key column
        config = HNSWConfig.from_options(options)
        index = HNSWIndex(dims, config,
                          capacity=max(table.row_count, 1024),
                          device=self.device)
        # bulk build: scan -> project (vec, rowid) -> IS NOT NULL filter ->
        # construct (hnsw_index_plan.cpp:101-141)
        if on_progress is not None:
            on_progress("load", 0.0)
        ids = np.nonzero(table._live)[0].astype(np.int64)
        vecs, ids = table._gather_index_rows(column, ids)
        if on_progress is not None:
            on_progress("load", 1.0)
        if len(ids):
            index.add(vecs, ids,
                      on_progress=None if on_progress is None else
                      (lambda f: on_progress("build", f)))
        entry = IndexEntry(name, table, column, index)
        self.indexes[name] = entry
        self._log({"op": "create_index", "name": name, "table": table_name,
                   "column": column, "options": options})
        return entry

    def drop_index(self, name: str) -> None:
        del self.indexes[name]
        self._log({"op": "drop_index", "name": name})

    # -- pragmas ---------------------------------------------------------
    def pragma_hnsw_compact_index(self, name: str) -> None:
        if name not in self.indexes:
            raise BinderError(
                f"index '{name}' does not exist")
        self.indexes[name].index.compact()
        self._log({"op": "compact_index", "name": name})

    def pragma_hnsw_index_info(self) -> list[dict]:
        out = []
        for e in self.indexes.values():
            s = e.index.stats()
            s.update({"index_name": e.name, "table_name": e.table.name,
                      "column_name": e.column})
            out.append(s)
        return out

    # -- table macros (E13) ---------------------------------------------
    def vss_join(self, left: Table, right: Table, left_col: str,
                 right_col: str, k: int, metric: str = "l2sq"):
        """Brute-force k-NN join macro (hnsw_index_macros.cpp:10-46)."""
        return knn_join(self, left, right, left_col, right_col, k,
                        metric=metric, use_index=False)

    def vss_match(self, right: Table, left_vector: np.ndarray,
                  right_col: str, k: int, metric: str = "l2sq"):
        """Single-probe brute-force match macro
        (hnsw_index_macros.cpp:48-75)."""
        lt = Table(self, "__probe__", {"q": ("FLOAT",
                                             len(np.asarray(left_vector)))})
        lt.insert([{"q": np.asarray(left_vector, np.float32)}])
        return knn_join(self, lt, right, "q", right_col, k, metric=metric,
                        use_index=False)


# ---------------------------------------------------------------------------
# query builder + optimizer + executor
# ---------------------------------------------------------------------------


class QueryBuilder:
    def __init__(self, table: Table):
        self.tbl = table
        self._select: list[E.Expr] = []
        self._where: E.Expr | None = None
        self._order: E.Expr | None = None
        self._order_desc = False
        self._limit: int | None = None
        self._no_index = False  # force the generic path (E9 huge-k bail)

    def select(self, *exprs) -> "QueryBuilder":
        for e in exprs:
            self._select.append(E.col(e) if isinstance(e, str) else e)
        return self

    def where(self, e: E.Expr) -> "QueryBuilder":
        self._where = e if self._where is None else _and(self._where, e)
        return self

    def order_by(self, e: E.Expr, desc: bool = False) -> "QueryBuilder":
        self._order = e
        self._order_desc = desc
        return self

    def limit(self, n: int) -> "QueryBuilder":
        self._limit = int(n)
        return self

    # -- planning -------------------------------------------------------
    def plan(self) -> P.PlanNode:
        """Build + optimize the physical plan (HNSWIndexScanOptimizer
        analog, hnsw_optimize_scan.cpp:29-98)."""
        select = self._select or [E.col(c) for c in self.tbl.columns]
        optimize = self.tbl.db.settings.get("optimizer_enabled", True)
        if optimize:
            # E11 applies to every expression, not just ORDER BY — the
            # reference EXPLAIN shows array_cosine_distance in plain
            # projections too (hnsw_rewrite.test)
            select = [E.canonicalize(s) for s in select]
        order = self._order
        if order is not None and optimize:
            order = E.canonicalize(order)

        index_plan = None
        if optimize and order is not None and self._limit is not None \
                and not self._order_desc:
            m = E.match_distance_call(order)
            if m is not None:
                fname, metric, colref, qvec = m
                entry = (None if self._no_index
                         else _find_index(self.tbl, colref.name, metric))
                if entry is not None:
                    scan = P.PhysicalHNSWIndexScan(
                        table=self.tbl, index=entry, limit=self._limit)
                    scan.query_vector = qvec
                    node = scan
                    if self._where is not None:
                        # filter pull-up (hnsw_optimize_scan.cpp:161-187)
                        node = P.PhysicalFilter(
                            children=[node], predicate=self._where)
                    index_plan = P.PhysicalProjection(
                        children=[node], exprs=select)
                elif colref.name in self.tbl.vector_columns() \
                        and self._where is None:
                    # no index: brute-force device scan (still far better than
                    # a host TopN; the reference falls back to DuckDB TopN)
                    scan = P.PhysicalFlatTopN(
                        table=self.tbl, column=colref.name, metric=metric,
                        limit=self._limit)
                    scan.query_vector = qvec
                    index_plan = P.PhysicalProjection(
                        children=[scan], exprs=select)
        if index_plan is not None:
            return index_plan

        # unoptimized shape: seq scan -> filter -> topn/limit -> projection
        node: P.PlanNode = P.PhysicalSeqScan(table=self.tbl)
        if self._where is not None:
            node = P.PhysicalFilter(children=[node], predicate=self._where)
        if order is not None and self._limit is not None:
            node = P.PhysicalTopN(children=[node], order=order,
                                  limit=self._limit)
            node.desc = self._order_desc
        return P.PhysicalProjection(children=[node], exprs=select)

    def explain(self) -> str:
        return self.plan().explain()

    # -- execution ------------------------------------------------------
    def execute(self, plan: P.PlanNode | None = None
                ) -> dict[str, np.ndarray]:
        """Run ``plan`` (default: the query's plan, made here)."""
        if plan is None:
            with annotate("sql.plan"):
                plan = self.plan()
        batch = _execute_node(plan, self.tbl.db)
        with annotate("sql.result"):
            if self._limit is not None:
                batch = {c: v[: self._limit] for c, v in batch.items()}
        return batch

    def min_by(self, value: E.Expr | str, dist: E.Expr, k: int):
        """SELECT min_by(value, dist, k) — the E9 rewrite: with a matching
        index becomes list(value ORDER BY dist) over an index scan
        (hnsw_optimize_topk.cpp:51-56). For k >= 2048 the reference skips
        the rewrite but still answers via the generic plan (:162-164) —
        here that is the exact brute-force/TopN path, never the index."""
        value = E.col(value) if isinstance(value, str) else value
        qb = (QueryBuilder(self.tbl)
              .select(value.alias("__v__") if not isinstance(value, E.Aliased)
                      else value)
              .order_by(dist)
              .limit(k))
        qb._no_index = k >= 2048
        res = qb.execute()
        key = next(iter(res.keys()))
        return list(res[key])


def _and(a, b):
    out = E.BinaryOp("and", a, b)
    return out


def _find_index(table: Table, column: str,
                metric: MetricKind) -> IndexEntry | None:
    """Index lookup requiring metric/function match
    (hnsw_metrics.test semantics)."""
    for e in table.db.indexes_on(table.name):
        if e.column == column and e.metric == metric:
            return e
    return None


def _eval_predicate(pred, batch, device):
    if pred is not None and isinstance(pred, E.BinaryOp) and pred.op == "and":
        return (np.asarray(_eval_predicate(pred.left, batch, device), bool)
                & np.asarray(_eval_predicate(pred.right, batch, device),
                             bool))
    return np.asarray(E.evaluate(pred, batch, device), bool)


# each operator's span; a child's span nests in its parent's
_OPERATOR_SPANS = {
    P.PhysicalSeqScan: "sql.scan",
    P.PhysicalHNSWIndexScan: "sql.scan",
    P.PhysicalFlatTopN: "sql.scan",
    P.PhysicalFilter: "sql.filter",
    P.PhysicalTopN: "sql.topn",
    P.PhysicalProjection: "sql.project",
}


def _execute_node(node: P.PlanNode, db: Database) -> dict[str, np.ndarray]:
    if type(node) not in _OPERATOR_SPANS:
        raise TypeError(f"cannot execute {node!r}")
    with annotate(_OPERATOR_SPANS[type(node)]):
        return _run_operator(node, db)


def _run_operator(node: P.PlanNode, db: Database) -> dict[str, np.ndarray]:
    """One operator of _OPERATOR_SPANS over its child's batch."""
    if isinstance(node, P.PhysicalSeqScan):
        batch, _ = node.table.scan()
        return batch

    if isinstance(node, P.PhysicalHNSWIndexScan):
        entry = node.index
        ef = db.settings["hnsw_ef_search"] or None
        _, keys = entry.index.search(
            node.query_vector[None, :], node.limit, ef=ef)
        rowids = keys[0]
        rowids = rowids[rowids >= 0]
        return node.table.fetch(rowids)

    if isinstance(node, P.PhysicalFlatTopN):
        fi = node.table.flat_column(node.column)
        fi.metric = node.metric
        _, keys = fi.search(node.query_vector[None, :], node.limit)
        rowids = keys[0]
        rowids = rowids[rowids >= 0]
        return node.table.fetch(rowids)

    if isinstance(node, P.PhysicalFilter):
        batch = _execute_node(node.children[0], db)
        mask = _eval_predicate(node.predicate, batch, db.device)
        return {c: v[mask] for c, v in batch.items()}

    if isinstance(node, P.PhysicalTopN):
        batch = _execute_node(node.children[0], db)
        key = np.asarray(E.evaluate(node.order, batch, db.device),
                         np.float64)
        order = np.argsort(-key if getattr(node, "desc", False) else key,
                           kind="stable")[: node.limit]
        return {c: v[order] for c, v in batch.items()}

    if isinstance(node, P.PhysicalProjection):
        batch = _execute_node(node.children[0], db)
        out = {}
        for i, e in enumerate(node.exprs):
            name = (e.name if isinstance(e, E.Aliased)
                    else (e.name if isinstance(e, E.ColumnRef)
                          else f"expr_{i}"))
            out[name] = np.asarray(E.evaluate(e, batch, db.device)) \
                if not isinstance(e, E.ColumnRef) else batch[e.name]
        return out


# ---------------------------------------------------------------------------
# k-NN lateral join (E10 / E13)
# ---------------------------------------------------------------------------


def knn_join(db: Database, left: Table, right: Table, left_col: str,
             right_col: str, k: int, metric: str | MetricKind = "l2sq",
             use_index: bool | None = None) -> dict[str, np.ndarray]:
    """FROM left, LATERAL (SELECT ... FROM right ORDER BY
    dist(left.l, right.r) LIMIT k) — executed as ONE batched device
    search over all outer rows (vs the reference's sequential per-row
    multi-scan, hnsw_optimize_join.cpp:113-170).

    Output columns: left columns prefixed `left_`, right columns
    prefixed `right_`, plus `score` and 1-based `row_num`. k must be
    < 2048 (reference guard, hnsw_optimize_join.cpp:459-463).
    """
    if not (0 < k < 2048):
        raise BinderError("k must be in [1, 2048) for knn join")
    metric = MetricKind(metric) if not isinstance(metric, MetricKind) else metric
    lbatch, lids = left.scan()
    lvecs = lbatch[left_col]
    # NULL outer rows still probe and emit k matches: the reference's
    # join operator reads the raw (zeroed) array storage without a
    # validity check (hnsw_optimize_join.cpp:126-145), so a NULL outer
    # vector searches as the zero vector
    lvalid = np.ones(len(lvecs), bool)
    lvecs = np.nan_to_num(lvecs, nan=0.0)

    entry = _find_index(right, right_col, metric) if use_index in (None, True) \
        else None
    if use_index is True and entry is None:
        raise BinderError("no matching index for knn join")

    nq = int(lvalid.sum())
    qs = lvecs[lvalid]
    if nq == 0:
        scores = np.zeros((0, k), np.float32)
        rkeys = np.zeros((0, k), np.int64)
    elif entry is not None:
        ef = db.settings["hnsw_ef_search"] or None
        scores, rkeys = entry.index.search(qs, k, ef=ef)
    else:
        fi = right.flat_column(right_col)
        fi.metric = metric
        scores, rkeys = fi.search(qs, k)

    # assemble: one combined fetch for all matches (join.cpp:156),
    # vectorized — row_num is the 1-based rank of valid matches per probe
    qpos = np.nonzero(lvalid)[0]
    match = rkeys >= 0  # [nq, k]
    rownum = np.cumsum(match, axis=1)
    sel_q, sel_j = np.nonzero(match)
    out_lidx = lids[qpos[sel_q]]
    out_ridx = rkeys[sel_q, sel_j]
    out_score = scores[sel_q, sel_j]
    out_rownum = rownum[sel_q, sel_j]
    lfetch = left.fetch(np.asarray(out_lidx, np.int64))
    rfetch = right.fetch(np.asarray(out_ridx, np.int64))
    out = {f"left_{c}": v for c, v in lfetch.items()}
    out.update({f"right_{c}": v for c, v in rfetch.items()})
    out["score"] = np.asarray(out_score, np.float32)
    out["row_num"] = np.asarray(out_rownum, np.int64)
    return out


def explain_knn_join(db: Database, left: Table, right: Table, left_col: str,
                     right_col: str, k: int,
                     metric: str | MetricKind = "l2sq",
                     use_index: bool | None = None) -> str:
    metric = MetricKind(metric) if not isinstance(metric, MetricKind) else metric
    entry = _find_index(right, right_col, metric) if use_index in (None, True) \
        else None
    scan: P.PlanNode
    if entry is not None:
        scan = P.PhysicalHNSWIndexJoin(table=right, index=entry, limit=k)
    else:
        scan = P.PhysicalFlatKNNJoin(table=right, column=right_col,
                                     metric=metric, limit=k)
    outer = P.PhysicalSeqScan(table=left)
    scan.children = [outer]
    return P.PhysicalProjection(children=[scan], exprs=[]).explain()


# ---------------------------------------------------------------------------
# database checkpoint / restart (§3.5 analog at engine level)
# ---------------------------------------------------------------------------


def table_arrays(t: Table) -> tuple[dict, dict[str, np.ndarray]]:
    """(column declarations, arrays) of one table: a vector column as
    [rows, dims] float32 with NaN rows for NULL, any other column as one
    numpy array (object for VARCHAR, and where NULLs leave numpy no other
    dtype), and the live flags as "__live__". What a checkpoint writes
    and utils/convert.py carries between the packages."""
    cols = {}
    arrays = {}
    for c, ty in t.columns.items():
        if isinstance(ty, VectorType):
            cols[c] = ["FLOAT", ty.dims]
            mat = np.full((len(t._live), ty.dims), np.nan, np.float32)
            for i, v in enumerate(t._data[c]):
                if v is not None:
                    mat[i] = v
            arrays[c] = mat
        else:
            cols[c] = ty
            arrays[c] = np.asarray(t._data[c],
                                   dtype=object if ty == "VARCHAR"
                                   else None)
    arrays["__live__"] = np.asarray(t._live, bool)
    return cols, arrays


def restore_table(t: Table, columns, live) -> None:
    """Fill table ``t`` (just created, empty) from its columns as
    table_arrays gives them (vector columns as [rows, dims], an all-NaN
    row a NULL; others as arrays or lists) and its live flags."""
    for c, ty in t.columns.items():
        col = columns[c]
        if isinstance(ty, VectorType):
            t._data[c] = [None if np.isnan(row).all() else row.copy()
                          for row in col]
        else:
            t._data[c] = list(col) if isinstance(col, list) else col.tolist()
    t._live = np.asarray(live, bool).tolist()
    t._flat_dirty = set(t.vector_columns())
    t._ckpt_dirty = False


def _serialize_table(t: Table) -> tuple[dict, dict, bytes]:
    """(column decl, object columns, npz blob bytes) for one table."""
    import io

    cols, arrays = table_arrays(t)
    buf = io.BytesIO()
    np.savez(buf, **{k: v for k, v in arrays.items() if v.dtype != object})
    obj_cols = {k: v.tolist() for k, v in arrays.items()
                if v.dtype == object}
    return cols, obj_cols, buf.getvalue()


def checkpoint_database(db: Database, directory: str | None = None) -> str:
    """CHECKPOINT: persist tables (npz blobs) + indexes (native container
    blobs) into the database's block file with block REUSE — the
    FixedSizeAllocator reclaim semantics the reference's
    hnsw_reclaim_storage.test_slow pins (dropped objects' blocks return
    to the free list; the file does not grow across drop/recreate
    cycles). Old blobs are freed only after the new image is written, so
    a crash mid-checkpoint leaves the previous catalog intact."""
    import json
    import os as _os

    from duckdb_vss_tpu_torch.utils import persist as _persist

    directory = directory or db.path
    if directory is None:
        raise BinderError("in-memory database: pass a directory to checkpoint")
    if not db.settings["hnsw_enable_experimental_persistence"] and db.indexes:
        raise BinderError(
            "set 'hnsw_enable_experimental_persistence' to checkpoint HNSW "
            "indexes")
    _os.makedirs(directory, exist_ok=True)
    mgr = db.block_manager(directory)
    catalog_path = _os.path.join(directory, "catalog.json")
    old = {"tables": {}, "indexes": {}}
    if _os.path.exists(catalog_path):
        with open(catalog_path) as f:
            loaded = json.load(f)
        if loaded.get("format") == 2:
            old = loaded

    # DuckDB-style incremental image: objects unchanged since the last
    # checkpoint keep their existing blocks; only dirty/new objects are
    # rewritten (into free blocks first). Old blocks of rewritten or
    # dropped objects are freed after the new image is complete.
    freed: list[int] = []
    catalog = {"format": 2, "tables": {}, "indexes": {}}
    for tname, t in db.tables.items():
        prev = old["tables"].get(tname)
        if prev is not None and not t._ckpt_dirty:
            catalog["tables"][tname] = prev
            continue
        cols, obj_cols, blob = _serialize_table(t)
        blocks = mgr.write_blob(blob)
        catalog["tables"][tname] = {"columns": cols, "objects": obj_cols,
                                    "blocks": blocks, "nbytes": len(blob)}
        if prev is not None:
            freed.extend(prev.get("blocks", []))
        t._ckpt_dirty = False
    tmp = _os.path.join(directory, ".blob.tmp")
    for iname, e in db.indexes.items():
        prev = old["indexes"].get(iname)
        if prev is not None and not e.index.is_dirty:
            catalog["indexes"][iname] = prev
            continue
        _persist.save_index(e.index, tmp)
        with open(tmp, "rb") as f:
            blob = f.read()
        _os.unlink(tmp)
        blocks = mgr.write_blob(blob)
        catalog["indexes"][iname] = {
            "table": e.table.name, "column": e.column,
            "blocks": blocks, "nbytes": len(blob)}
        if prev is not None:
            freed.extend(prev.get("blocks", []))
    # dropped objects' blocks return to the pool
    for tname, meta in old["tables"].items():
        if tname not in catalog["tables"]:
            freed.extend(meta.get("blocks", []))
    for iname, meta in old["indexes"].items():
        if iname not in catalog["indexes"]:
            freed.extend(meta.get("blocks", []))
    mgr.free_blob(freed)
    catalog["free_blocks"] = sorted(mgr.free_blocks)
    with open(catalog_path + ".tmp", "w") as f:
        json.dump(catalog, f)
    _os.replace(catalog_path + ".tmp", catalog_path)
    # everything the WAL held is now in the checkpoint image
    if db.wal is not None and directory == db.path:
        db.wal.truncate()
    return directory


def _apply_wal_record(db: Database, rec: dict) -> None:
    op = rec["op"]
    if op == "create_table":
        db.create_table(rec["name"],
                        {c: (tuple(ty) if isinstance(ty, list) else ty)
                         for c, ty in rec["columns"].items()})
    elif op == "drop_table":
        db.drop_table(rec["name"])
    elif op == "insert":
        db.tables[rec["table"]].insert(rec["rows"])
    elif op == "delete":
        db.tables[rec["table"]].delete(rowids=rec["rowids"])
    elif op == "create_index":
        db.create_hnsw_index(rec["name"], rec["table"], rec["column"],
                             **rec["options"])
    elif op == "drop_index":
        db.drop_index(rec["name"])
    elif op == "compact_index":
        db.pragma_hnsw_compact_index(rec["name"])
    elif op == "set":
        db.set(rec["key"], rec["value"])
    else:  # forward compatibility: unknown records are skipped
        pass


def open_database(directory: str,
                  device: str | torch.device = "cuda") -> Database:
    """Restart on ``device``: rebuild the catalog from the last checkpoint
    (if any); index blobs load from the native container (deferred: the
    first search reads them from the block file onto the device); then
    replay WAL records appended since that checkpoint
    (hnsw_insert_wal.test semantics — a database that was never
    checkpointed restores entirely from the WAL)."""
    import json
    import os as _os

    from duckdb_vss_tpu_torch.utils import persist as _persist

    catalog_path = _os.path.join(directory, "catalog.json")
    db = Database(path=directory, device=device)
    db.settings["hnsw_enable_experimental_persistence"] = True
    if not _os.path.exists(catalog_path):
        db._wal_replaying = True
        try:
            for rec in db.wal.replay():
                _apply_wal_record(db, rec)
        finally:
            db._wal_replaying = False
        return db
    with open(catalog_path) as f:
        catalog = json.load(f)
    # catalog restoration must not re-log into the (post-checkpoint) WAL
    db._wal_replaying = True
    fmt2 = catalog.get("format") == 2
    mgr = db.block_manager(directory) if fmt2 else None
    for tname, meta in catalog["tables"].items():
        cols = {
            c: (tuple(ty) if isinstance(ty, list) else ty)
            for c, ty in meta["columns"].items()}
        t = db.create_table(tname, cols)
        if fmt2:
            import io

            z = np.load(io.BytesIO(mgr.read_blob(meta["blocks"])),
                        allow_pickle=False)
        else:
            z = np.load(_os.path.join(directory, f"table_{tname}.npz"),
                        allow_pickle=False)
        restore_table(t, {c: meta["objects"][c] if c in meta["objects"]
                          else z[c] for c in t.columns}, z["__live__"])
    for iname, meta in catalog["indexes"].items():
        if fmt2:
            # reader over the blob image directly — no temp-file round
            # trip; the factory re-reads block storage at (deferred)
            # materialize time so the image is never pinned in RAM
            blocks = meta["blocks"]
            idx = _persist.load_index_from_buffer(
                lambda blocks=blocks: mgr.read_blob(blocks),
                device=db.device)
        else:
            idx = _persist.load_index(
                _os.path.join(directory, f"index_{iname}.vss"),
                device=db.device)
        entry = IndexEntry(iname, db.tables[meta["table"]], meta["column"],
                           idx)
        db.indexes[iname] = entry
    # operations newer than the checkpoint live in the WAL
    try:
        for rec in db.wal.replay():
            _apply_wal_record(db, rec)
    finally:
        db._wal_replaying = False
    return db
