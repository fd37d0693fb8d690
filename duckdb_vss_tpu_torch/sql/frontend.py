"""SQL statement execution: lowers parser ASTs onto the engine layer
(port of duckdb_vss_tpu/sql/frontend.py; every expression and aggregate
evaluates with the database's device, where the SQL scalar functions
run).

`execute_sql(db, "...")` is the analog of DuckDB's
connection.execute() for the surface the vss extension touches. Query
statements return a dict[str, np.ndarray] column batch (the same shape
QueryBuilder.execute returns); EXPLAIN returns the physical plan string
(the reference's plan-shape tests regex over it,
hnsw_basic.test:19-23); DDL/DML return None or a rowcount.

Single-table SELECTs lower onto QueryBuilder so the reference's
optimizer rewrites fire (E8 TopN->index scan, E9 min_by); the
`FROM a, LATERAL (... ORDER BY dist(a.x, b.y) LIMIT k)` shape lowers
onto the batched knn_join operator (E10, hnsw_optimize_join.cpp:351-474
pattern match done here on the AST instead of on a delim-join plan).
"""

from __future__ import annotations

import numpy as np

from duckdb_vss_tpu_torch.ops.distance import SCALAR_FUNCTIONS
from duckdb_vss_tpu_torch.sql import expr as E
from duckdb_vss_tpu_torch.sql import parser as P
from duckdb_vss_tpu_torch.sql.engine import (
    Database,
    QueryBuilder,
    Table,
    VectorType,
    checkpoint_database,
    explain_knn_join,
    knn_join,
)
from duckdb_vss_tpu_torch.utils.config import FUNCTION_TO_METRIC, BinderError
from duckdb_vss_tpu_torch.utils.tracing import annotate

AGGREGATES = {"min_by", "max_by", "list", "count", "sum", "avg", "min",
              "max", "bool_and", "bool_or", "first", "any_value"}

# list/host scalar helpers usable above aggregates (hnsw_topk.test uses
# list_sum(flatten(min_by(...))))
_HOST_FUNCS = {
    "flatten": lambda xs: [v for x in xs for v in np.asarray(x).ravel()],
    "list_sum": lambda xs: float(np.sum(np.asarray(xs, np.float64))),
    "len": lambda xs: len(xs),
    "abs": abs,
}


def execute_sql(db: Database, sql: str):
    """Execute a SQL script; returns the result of the LAST statement."""
    result = None
    with annotate("sql.parse"):
        stmts = P.parse(sql)
    for stmt in stmts:
        result = _execute_stmt(db, stmt)
    return result


def _execute_stmt(db: Database, stmt):
    if isinstance(stmt, P.CreateTable):
        db.create_table(stmt.name, stmt.columns)
        return None
    if isinstance(stmt, P.CreateTableAs):
        return _execute_ctas(db, stmt)
    if isinstance(stmt, P.CreateIndex):
        db.create_hnsw_index(stmt.name, stmt.table, stmt.column,
                             **stmt.options)
        return None
    if isinstance(stmt, P.DropStmt):
        exists = (stmt.name in db.tables if stmt.kind == "table"
                  else stmt.name in db.indexes)
        if not exists:
            if stmt.if_exists:
                return None
            raise BinderError(f"{stmt.kind} '{stmt.name}' does not exist")
        (db.drop_table if stmt.kind == "table" else db.drop_index)(stmt.name)
        return None
    if isinstance(stmt, P.InsertStmt):
        return _execute_insert(db, stmt)
    if isinstance(stmt, P.DeleteStmt):
        return db.table(stmt.table).delete(predicate=stmt.where)
    if isinstance(stmt, P.UpdateStmt):
        return _execute_update(db, stmt)
    if isinstance(stmt, P.SetStmt):
        db.set(stmt.key, stmt.value)
        return None
    if isinstance(stmt, P.PragmaStmt):
        return _execute_pragma(db, stmt)
    if isinstance(stmt, P.CheckpointStmt):
        if db.path is not None:
            checkpoint_database(db)
        return None
    if isinstance(stmt, P.ExplainStmt):
        return _explain(db, stmt.select)
    if isinstance(stmt, P.SelectStmt):
        return execute_select(db, stmt)
    raise BinderError(f"cannot execute {type(stmt).__name__}")


# ---------------------------------------------------------------------------
# DML
# ---------------------------------------------------------------------------


def _infer_column_type(col: np.ndarray):
    """CTAS column-type inference from a result batch column."""
    arr = np.asarray(col)
    if arr.ndim == 2 and arr.dtype.kind == "f":
        return ("FLOAT", arr.shape[1])
    if arr.dtype == object and len(arr) and isinstance(
            arr[0], (np.ndarray, list)):
        return ("FLOAT", len(arr[0]))
    if arr.dtype.kind in "iu":
        return "BIGINT"
    if arr.dtype.kind == "b":
        return "BOOLEAN"
    if arr.dtype.kind == "f":
        return "DOUBLE"
    return "VARCHAR"


def _execute_ctas(db: Database, stmt: P.CreateTableAs):
    """CREATE TABLE name AS SELECT ... (the reference's slow suite builds
    its 1M-row fixture this way, hnsw_reclaim_storage.test_slow:8)."""
    batch = execute_select(db, stmt.select)
    cols = {c: _infer_column_type(v) for c, v in batch.items()}
    table = db.create_table(stmt.name, cols)
    n = len(next(iter(batch.values()), []))
    if n:
        table.insert({c: list(np.asarray(v)) if np.asarray(v).ndim == 2
                      else np.asarray(v) for c, v in batch.items()})
    return n


def _execute_insert(db: Database, stmt: P.InsertStmt):
    table = db.table(stmt.table)
    colnames = stmt.columns or list(table.columns)
    if stmt.rows is not None:
        rows = []
        for row in stmt.rows:
            if len(row) != len(colnames):
                raise BinderError(
                    f"INSERT has {len(row)} values for {len(colnames)} "
                    "columns")
            rows.append({c: P._const_value(e)
                         for c, e in zip(colnames, row)})
        rowids = table.insert(rows)
        return len(rowids)
    batch = execute_select(db, stmt.select)
    src_cols = list(batch.keys())
    if len(src_cols) != len(colnames):
        raise BinderError(
            f"INSERT SELECT produces {len(src_cols)} columns for "
            f"{len(colnames)} target columns")
    n = len(batch[src_cols[0]]) if src_cols else 0
    rows = []
    for i in range(n):
        r = {}
        for c, s in zip(colnames, src_cols):
            v = batch[s][i]
            if isinstance(v, np.ndarray) and v.ndim == 1 \
                    and np.isnan(v).all():
                v = None
            r[c] = v
        rows.append(r)
    rowids = table.insert(rows)
    return len(rowids)


def _execute_update(db: Database, stmt: P.UpdateStmt):
    table = db.table(stmt.table)
    batch, ids = table.scan()
    mask = (np.asarray(E.evaluate(stmt.where, batch, db.device), bool)
            if stmt.where is not None else np.ones(len(ids), bool))
    sel = np.nonzero(mask)[0]
    if not len(sel):
        return 0
    sub = {c: v[mask] for c, v in batch.items()}
    rows = []
    for i in range(len(sel)):
        r = {}
        for c in table.columns:
            r[c] = sub[c][i]
            if isinstance(r[c], np.ndarray) and r[c].ndim == 1 \
                    and np.isnan(r[c]).all():
                r[c] = None
        rows.append(r)
    for col, e in stmt.assigns:
        vals = E.evaluate(e, sub, db.device)
        is_vec = isinstance(table.columns.get(col), VectorType)
        # a [D] result against a vector column is one constant vector for
        # every row; a [n] result against a scalar column is per-row
        per_row = np.ndim(vals) == (2 if is_vec else 1)
        for i, r in enumerate(rows):
            r[col] = vals[i] if per_row else vals
    table.update(ids[mask], rows)
    return len(rows)


def _execute_pragma(db: Database, stmt: P.PragmaStmt):
    if stmt.name == "hnsw_compact_index":
        if len(stmt.args) != 1:
            raise BinderError("hnsw_compact_index('index_name')")
        db.pragma_hnsw_compact_index(str(stmt.args[0]))
        return None
    if stmt.name == "hnsw_index_info":
        return _info_batch(db)
    # DuckDB-host pragmas the reference tests toggle for differential
    # checks (indexed vs brute-force plans on identical data)
    if stmt.name == "disable_optimizer":
        db.settings["optimizer_enabled"] = False
        return None
    if stmt.name == "enable_optimizer":
        db.settings["optimizer_enabled"] = True
        return None
    raise BinderError(f"unknown pragma '{stmt.name}'")


def _info_batch(db: Database):
    rows = db.pragma_hnsw_index_info()
    if not rows:
        return {}
    keys = list(rows[0].keys())
    return {k: np.asarray([r[k] for r in rows], dtype=object)
            for k in keys}


# ---------------------------------------------------------------------------
# SELECT
# ---------------------------------------------------------------------------


def execute_select(db: Database, sel: P.SelectStmt):
    items = sel.from_items
    if not items:
        # FROM-less SELECT: each projection is one value of a single row —
        # a 1-D result (array_value/list literal) is one vector cell, not
        # a batch of scalars (hnsw_projection.test INSERT .. SELECT shape)
        out = {}
        for i, p in enumerate(sel.projections):
            name, e = _proj_name(p, i)
            v = np.asarray(E.evaluate(e, {}, db.device))
            out[name] = v[None, ...]
        return out
    if len(items) == 1 and isinstance(items[0], P.TableRef):
        return _select_table(db, sel, items[0])
    if len(items) == 1 and isinstance(items[0], P.TableFunc):
        batch = _table_func(db, items[0])
        return _host_pipeline(db, sel, batch)
    if all(isinstance(it, P.RangeFunc) for it in items):
        batch = _range_cross(items)
        return _host_pipeline(db, sel, batch)
    if len(items) == 2 and isinstance(items[0], P.TableRef) \
            and isinstance(items[1], P.Lateral):
        return _select_lateral(db, sel, items[0], items[1].sub)
    if len(items) == 2 and isinstance(items[0], P.TableRef) \
            and isinstance(items[1], P.TableFunc) \
            and items[1].name == "vss_match":
        batch = _vss_match_lateral(db, items[0], items[1])
        return _host_pipeline(db, sel, batch)
    if len(items) == 1 and isinstance(items[0], P.Lateral):
        # subquery in FROM: SELECT ... FROM ( SELECT ... )
        batch = execute_select(db, items[0].sub)
        return _host_pipeline(db, sel, batch)
    if len(items) >= 2 and all(
            isinstance(it, (P.TableRef, P.TableFunc)) for it in items):
        # generic cross product (hnsw_reclaim_storage.test_slow compares
        # pragma_database_size() snapshots across saved tables)
        return _host_pipeline(db, sel, _cross_batch(db, items))
    raise BinderError("unsupported FROM clause shape")


def _cross_batch(db: Database, items: list) -> dict:
    """Cross product of TableRef/TableFunc FROM items. Columns appear
    under their qualified name (alias.col) always, and under the bare
    name when it is unique across the items."""
    parts = []
    for it in items:
        if isinstance(it, P.TableRef):
            batch, _ = db.table(it.name).scan()
            alias = it.alias or it.name
        else:
            batch = _table_func(db, it)
            alias = it.alias or it.name
        parts.append((alias, batch))

    sizes = [len(next(iter(b.values()), [])) if b else 0 for _, b in parts]

    def _prod(xs):
        n = 1
        for x in xs:
            n *= x
        return n

    bare_counts: dict[str, int] = {}
    for _, b in parts:
        for c in b:
            bare_counts[c] = bare_counts.get(c, 0) + 1
    out: dict[str, np.ndarray] = {}
    for i, (alias, b) in enumerate(parts):
        tile = _prod(sizes[:i])
        rep = _prod(sizes[i + 1:])
        for c, v in b.items():
            arr = np.asarray(v)
            col = np.repeat(arr, rep, axis=0)
            if tile > 1:
                col = np.concatenate([col] * tile, axis=0)
            out[f"{alias}.{c}"] = col
            if bare_counts[c] == 1:
                out[c] = col
    return out


def _proj_name(p, i):
    if isinstance(p, E.Aliased):
        return p.name, p.expr
    if isinstance(p, E.ColumnRef):
        return p.name, p
    return f"expr_{i}", p


def _expand_projections(projections, columns):
    """Expand Star() against a column list; return list of (name, expr)."""
    out = []
    for i, p in enumerate(projections):
        if isinstance(p, P.Star):
            out.extend((c, E.col(c)) for c in columns)
        else:
            out.append(_proj_name(p, i))
    return out


def _has_aggregate(e) -> bool:
    if isinstance(e, P.Star):
        return False
    if isinstance(e, E.FunctionCall):
        if e.name in AGGREGATES:
            return True
        return any(_has_aggregate(a) for a in e.args)
    if isinstance(e, E.BinaryOp):
        return _has_aggregate(e.left) or _has_aggregate(e.right)
    if isinstance(e, (E.Aliased,)):
        return _has_aggregate(e.expr)
    if isinstance(e, (E.UnaryOp, E.IsNotNull)):
        return _has_aggregate(e.arg)
    return False


def _select_table(db: Database, sel: P.SelectStmt, ref: P.TableRef):
    table = db.table(ref.name)
    projs = sel.projections
    if any(_has_aggregate(p) for p in projs) and sel.group_by is None:
        batch, _ = table.scan()
        if sel.where is not None:
            mask = np.asarray(E.evaluate(sel.where, batch, db.device), bool)
            batch = {c: v[mask] for c, v in batch.items()}
        out = {}
        for i, p in enumerate(projs):
            name, e = _proj_name(p, i)
            out[name] = np.asarray([_eval_aggregate(db, table, e, batch)],
                                   dtype=object)
        return out
    with annotate("sql.plan"):
        qb = QueryBuilder(table)
        named = _expand_projections(projs, list(table.columns))
        alias_map = {n: e for n, e in named
                     if not isinstance(e, E.ColumnRef)}
        for n, e in named:
            qb.select(e if isinstance(e, E.ColumnRef) and e.name == n
                      else E.Aliased(e, n) if not isinstance(e, E.Aliased)
                      else e)
        if sel.where is not None:
            qb.where(_strip_qualifiers(sel.where, ref))
        if sel.order is not None:
            order = sel.order
            if isinstance(order, E.ColumnRef) and order.name in alias_map \
                    and order.name not in table.columns:
                order = alias_map[order.name]
            qb.order_by(_strip_qualifiers(order, ref), desc=sel.order_desc)
        if sel.limit is not None:
            qb.limit(sel.limit)
        plan = qb.plan()
    out = qb.execute(plan)
    if sel.group_by is not None:
        raise BinderError("GROUP BY over a plain table scan with "
                          "aggregates only")
    return out


def _strip_qualifiers(e, ref: P.TableRef):
    """Drop table qualifiers that refer to the single FROM table."""
    names = {ref.name, ref.alias} - {None}
    if isinstance(e, E.ColumnRef) and e.table in names:
        return E.ColumnRef(e.name)
    if isinstance(e, E.FunctionCall):
        return E.FunctionCall(e.name,
                              [_strip_qualifiers(a, ref) for a in e.args])
    if isinstance(e, E.BinaryOp):
        return E.BinaryOp(e.op, _strip_qualifiers(e.left, ref),
                          _strip_qualifiers(e.right, ref))
    if isinstance(e, E.Aliased):
        return E.Aliased(_strip_qualifiers(e.expr, ref), e.name)
    if isinstance(e, E.UnaryOp):
        return E.UnaryOp(e.op, _strip_qualifiers(e.arg, ref))
    if isinstance(e, E.IsNotNull):
        return E.IsNotNull(_strip_qualifiers(e.arg, ref))
    return e


def _list_agg(e: E.FunctionCall, batch, device):
    """list(x [ORDER BY k1, k2, ...]) over a column batch."""
    vals = E.evaluate(e.args[0], batch, device)
    vals = list(vals)
    if getattr(e, "order_by", None):
        keys = [np.asarray(E.evaluate(k, batch, device)) for k in e.order_by]
        order = np.lexsort(tuple(reversed(keys)))
        vals = [vals[i] for i in order]
    return vals


def _eval_aggregate(db: Database, table: Table, e, batch):
    """Evaluate an expression that may contain aggregate calls, over a
    full-table batch. Returns a host scalar / list."""
    if isinstance(e, E.Constant):
        return e.value
    if isinstance(e, E.FunctionCall):
        if e.name in ("min_by", "max_by"):
            if len(e.args) != 3:
                raise BinderError(f"{e.name}(value, key, k)")
            val_e, key_e, k_e = e.args
            k = int(P._const_value(k_e))
            # k >= 2048: QueryBuilder.min_by answers via the generic
            # (non-index) path, matching hnsw_optimize_topk.cpp:162-164
            # which skips the rewrite but still executes the aggregate
            qb = QueryBuilder(table)
            return qb.min_by(val_e, key_e if e.name == "min_by"
                             else E.UnaryOp("-", key_e), k)
        if e.name == "count":
            if e.args and isinstance(e.args[0], P.Star):
                return int(len(next(iter(batch.values()), [])))
            v = E.evaluate(e.args[0], batch, db.device)
            return int(np.count_nonzero(~_null_mask(v)))
        if e.name == "list":
            return _list_agg(e, batch, db.device)
        if e.name in ("sum", "avg", "min", "max"):
            v = np.asarray(E.evaluate(e.args[0], batch, db.device),
                           np.float64)
            return {"sum": np.sum, "avg": np.mean, "min": np.min,
                    "max": np.max}[e.name](v) if v.size else None
        if e.name in ("bool_and", "bool_or"):
            v = np.asarray(E.evaluate(e.args[0], batch, db.device), bool)
            return bool(v.all() if e.name == "bool_and" else v.any())
        if e.name in ("first", "any_value"):
            v = E.evaluate(e.args[0], batch, db.device)
            return v[0] if len(v) else None
        if e.name in _HOST_FUNCS:
            args = [_eval_aggregate(db, table, a, batch) for a in e.args]
            return _HOST_FUNCS[e.name](*args)
        args = [_eval_aggregate(db, table, a, batch) for a in e.args]
        if e.name in SCALAR_FUNCTIONS:
            return E.call_function(e.name, args, db.device)
        raise BinderError(f"unknown function '{e.name}'")
    if isinstance(e, E.BinaryOp):
        left = _eval_aggregate(db, table, e.left, batch)
        right = _eval_aggregate(db, table, e.right, batch)
        return E.evaluate(E.BinaryOp(e.op, E.Constant(left),
                                     E.Constant(right)), {}, db.device)
    if isinstance(e, E.UnaryOp):
        v = _eval_aggregate(db, table, e.arg, batch)
        return (not v) if e.op == "not" else -v
    if isinstance(e, E.Aliased):
        return _eval_aggregate(db, table, e.expr, batch)
    raise BinderError(f"cannot aggregate-evaluate {e!r}")


def _null_mask(v):
    v = np.asarray(v)
    if v.dtype == object:
        return np.asarray([x is None for x in v])
    if np.issubdtype(v.dtype, np.floating):
        return np.isnan(v) if v.ndim == 1 else np.isnan(v).any(axis=1)
    return np.zeros(len(v), bool)


# ---------------------------------------------------------------------------
# host-side pipeline (table functions, range cross products)
# ---------------------------------------------------------------------------


def _table_func(db: Database, tf: P.TableFunc):
    def _name(a):
        if isinstance(a, E.ColumnRef):
            return a.name
        return str(P._const_value(a))

    if tf.name == "vss_join":
        lt, rt = db.table(_name(tf.args[0])), db.table(_name(tf.args[1]))
        lcol, rcol = _name(tf.args[2]), _name(tf.args[3])
        k = int(P._const_value(tf.args[4]))
        metric = "l2sq"
        if len(tf.args) > 5:
            metric = str(P._const_value(tf.args[5]))
        return db.vss_join(lt, rt, lcol, rcol, k, metric=metric)
    if tf.name == "vss_match":
        rt = db.table(_name(tf.args[0]))
        vec = P._const_value(tf.args[1])
        rcol = _name(tf.args[2])
        k = int(P._const_value(tf.args[3]))
        metric = "l2sq"
        if len(tf.args) > 4:
            metric = str(P._const_value(tf.args[4]))
        return db.vss_match(rt, vec, rcol, k, metric=metric)
    if tf.name == "pragma_hnsw_index_info":
        return _info_batch(db)
    if tf.name == "pragma_database_size":
        row = db.pragma_database_size()
        return {k: np.asarray([v]) for k, v in row.items()}
    raise BinderError(f"unknown table function '{tf.name}'")


def _vss_match_lateral(db: Database, ref: P.TableRef, tf: P.TableFunc):
    """FROM left, vss_match(right, left_col, right_col, k[, metric]) —
    one `matches` list of {'score', 'row'} structs per outer row
    (VSS_MATCH_MACRO, hnsw_index_macros.cpp:48-75)."""
    def _name(a):
        return a.name if isinstance(a, E.ColumnRef) else str(P._const_value(a))

    lt = db.table(ref.name)
    rt = db.table(_name(tf.args[0]))
    lcol, rcol = _name(tf.args[1]), _name(tf.args[2])
    k = int(P._const_value(tf.args[3]))
    metric = str(P._const_value(tf.args[4])) if len(tf.args) > 4 else "l2sq"

    flat = knn_join(db, lt, rt, lcol, rcol, k, metric=metric,
                    use_index=False)
    lbatch, _ = lt.scan()
    n = len(next(iter(lbatch.values()), []))
    # regroup the flattened join output into per-outer-row match lists
    rcols = [c for c in flat if c.startswith("right_")]
    matches: list = [[] for _ in range(n)]
    probe = 0
    for i in range(len(flat["score"])):
        if flat["row_num"][i] == 1 and i > 0:
            probe += 1
        row = {c[len("right_"):]: flat[c][i] for c in rcols}
        matches[probe].append({"score": flat["score"][i], "row": row})
    out = {c: v for c, v in lbatch.items()}
    out["matches"] = np.asarray([m for m in matches], dtype=object)
    return out


def _range_cross(items: list) -> dict:
    axes = []
    names = []
    for it in items:
        args = [int(a) for a in it.args]
        if len(args) == 1:
            lo, hi, step = 0, args[0], 1
        elif len(args) == 2:
            lo, hi, step = args[0], args[1], 1
        else:
            lo, hi, step = args
        axes.append(np.arange(lo, hi, step, dtype=np.int64))
        names.append(it.colname)
    grids = np.meshgrid(*axes, indexing="ij")
    return {n: g.ravel() for n, g in zip(names, grids)}


def _host_pipeline(db: Database, sel: P.SelectStmt, batch: dict):
    """WHERE -> GROUP BY/aggregate -> ORDER BY -> LIMIT -> projection over
    an in-memory column batch."""
    if sel.where is not None:
        mask = np.asarray(E.evaluate(sel.where, batch, db.device), bool)
        batch = {c: v[mask] for c, v in batch.items()}
    if sel.group_by is not None or any(_has_aggregate(p)
                                       for p in sel.projections):
        return _host_group(db, sel, batch)
    named = _expand_projections(sel.projections, list(batch.keys()))
    if sel.order is not None:
        alias_map = {n: e for n, e in named}
        order = sel.order
        if isinstance(order, E.ColumnRef) and order.name not in batch \
                and order.name in alias_map:
            order = alias_map[order.name]
        key = np.asarray(E.evaluate(order, batch, db.device), np.float64)
        idx = np.argsort(-key if sel.order_desc else key, kind="stable")
        batch = {c: v[idx] for c, v in batch.items()}
    if sel.limit is not None:
        batch = {c: v[: sel.limit] for c, v in batch.items()}
    out = {}
    for name, e in named:
        out[name] = (batch[e.name] if isinstance(e, E.ColumnRef)
                     and e.name in batch
                     else np.asarray(E.evaluate(e, batch, db.device)))
    return out


def _host_group(db: Database, sel: P.SelectStmt, batch: dict):
    keys = sel.group_by or []
    key_vals = [np.asarray(E.evaluate(k, batch, db.device)) for k in keys]
    if key_vals:
        tags = [tuple(kv[i].tolist() if isinstance(kv[i], np.ndarray)
                      else kv[i] for kv in key_vals)
                for i in range(len(key_vals[0]))]
        uniq = list(dict.fromkeys(tags))
        groups = [(u, np.asarray([t == u for t in tags], bool))
                  for u in uniq]
    else:
        n = len(next(iter(batch.values()), []))
        groups = [((), np.ones(n, bool))]
    out_rows = []
    for tag, mask in groups:
        gb = {c: v[mask] for c, v in batch.items()}
        row = {}
        for i, p in enumerate(sel.projections):
            name, e = _proj_name(p, i)
            if _has_aggregate(e):
                row[name] = _eval_batch_aggregate(e, gb, db.device)
            else:
                v = E.evaluate(e, gb, db.device)
                row[name] = v[0] if np.ndim(v) else v
        out_rows.append(row)
    if not out_rows:
        return {}
    cols = list(out_rows[0].keys())
    return {c: np.asarray([r[c] for r in out_rows], dtype=object)
            for c in cols}


def _eval_batch_aggregate(e, batch, device):
    """Aggregate evaluation over an already-materialized batch (used by
    GROUP BY over lateral joins / table functions)."""
    if isinstance(e, E.FunctionCall) and e.name in AGGREGATES:
        if e.name == "count":
            if e.args and isinstance(e.args[0], P.Star):
                return int(len(next(iter(batch.values()), [])))
            v = E.evaluate(e.args[0], batch, device)
            return int(np.count_nonzero(~_null_mask(v)))
        if e.name == "list":
            return _list_agg(e, batch, device)
        if e.name in ("sum", "avg", "min", "max"):
            v = np.asarray(E.evaluate(e.args[0], batch, device), np.float64)
            return {"sum": np.sum, "avg": np.mean, "min": np.min,
                    "max": np.max}[e.name](v) if v.size else None
        if e.name in ("bool_and", "bool_or"):
            v = np.asarray(E.evaluate(e.args[0], batch, device), bool)
            return bool(v.all() if e.name == "bool_and" else v.any())
        if e.name in ("first", "any_value"):
            v = E.evaluate(e.args[0], batch, device)
            return v[0] if len(v) else None
        raise BinderError(f"unsupported aggregate '{e.name}' here")
    if isinstance(e, E.FunctionCall) and e.name in _HOST_FUNCS:
        return _HOST_FUNCS[e.name](*[_eval_batch_aggregate(a, batch, device)
                                     for a in e.args])
    if isinstance(e, E.BinaryOp):
        l = _eval_batch_aggregate(e.left, batch, device)
        r = _eval_batch_aggregate(e.right, batch, device)
        return E.evaluate(E.BinaryOp(e.op, E.Constant(l), E.Constant(r)),
                          {}, device)
    if isinstance(e, E.Aliased):
        return _eval_batch_aggregate(e.expr, batch, device)
    if isinstance(e, E.Constant):
        return e.value
    v = E.evaluate(e, batch, device)
    return v[0] if np.ndim(v) else v


# ---------------------------------------------------------------------------
# lateral k-NN join (E10)
# ---------------------------------------------------------------------------


def _select_lateral(db: Database, sel: P.SelectStmt, outer: P.TableRef,
                    sub: P.SelectStmt):
    if len(sub.from_items) != 1 or not isinstance(sub.from_items[0],
                                                  P.TableRef):
        raise BinderError("lateral subquery must select FROM one table")
    inner = sub.from_items[0]
    if sub.order is None or sub.limit is None:
        raise BinderError("lateral subquery needs ORDER BY ... LIMIT k")
    k = sub.limit
    lt, rt = db.table(outer.name), db.table(inner.name)

    # resolve the order expression (possibly an alias of a projection)
    order = sub.order
    sub_named = []
    for i, p in enumerate(sub.projections):
        if isinstance(p, P.Star):
            sub_named.append((None, p))
        else:
            sub_named.append(_proj_name(p, i))
    alias_map = {n: e for n, e in sub_named if n is not None}
    if isinstance(order, E.ColumnRef) and order.table is None \
            and order.name in alias_map:
        order = alias_map[order.name]
    order = E.canonicalize(order)

    m = _match_lateral_distance(order, outer, inner, lt, rt)
    if m is None:
        raise BinderError(
            "lateral ORDER BY must be dist(outer.col, inner.col)")
    fname, metric, lcol, rcol = m

    joined = knn_join(db, lt, rt, lcol, rcol, k, metric=metric)

    # assemble output: outer columns first, then subquery projections
    out = {}
    for c in lt.columns:
        out[c] = joined[f"left_{c}"]
    for i, (name, p) in enumerate(sub_named):
        if isinstance(p, P.Star):
            for c in rt.columns:
                out[c] = joined[f"right_{c}"]
            continue
        e = _rewrite_lateral(p, outer, inner, lt, rt)
        out[name] = (joined[e.name] if isinstance(e, E.ColumnRef)
                     else np.asarray(E.evaluate(e, joined, db.device)))
    out["__row_num__"] = joined["row_num"]

    # outer-level pipeline
    if sel.where is not None:
        w = _rewrite_lateral(sel.where, outer, inner, lt, rt)
        mask = np.asarray(E.evaluate(w, {**joined, **out}, db.device), bool)
        out = {c: v[mask] for c, v in out.items()}
    proj_cols = [c for c in out if c != "__row_num__"]
    if sel.group_by is not None or any(_has_aggregate(p)
                                       for p in sel.projections):
        sel2 = P.SelectStmt(sel.projections, [], None, sel.order,
                            sel.order_desc, sel.limit, sel.group_by)
        return _host_group(db, sel2, {c: out[c] for c in proj_cols})
    named = _expand_projections(sel.projections, proj_cols)
    final = {}
    for name, e in named:
        final[name] = (out[e.name] if isinstance(e, E.ColumnRef)
                       and e.name in out
                       else np.asarray(E.evaluate(e, out, db.device)))
    if sel.order is not None:
        key = np.asarray(E.evaluate(sel.order, out, db.device), np.float64)
        idx = np.argsort(-key if sel.order_desc else key, kind="stable")
        final = {c: v[idx] for c, v in final.items()}
    if sel.limit is not None:
        final = {c: v[: sel.limit] for c, v in final.items()}
    return final


def _owner(cref: E.ColumnRef, outer: P.TableRef, inner: P.TableRef,
           lt: Table, rt: Table) -> str | None:
    """'outer' | 'inner' | None for a column reference."""
    if cref.table is not None:
        if cref.table in (outer.alias, outer.name):
            return "outer"
        if cref.table in (inner.alias, inner.name):
            return "inner"
        return None
    # unqualified: inner shadows outer (lateral scoping)
    if cref.name in rt.columns:
        return "inner"
    if cref.name in lt.columns:
        return "outer"
    return None


def _match_lateral_distance(order, outer, inner, lt: Table, rt: Table):
    if not isinstance(order, E.FunctionCall) \
            or order.name not in FUNCTION_TO_METRIC or len(order.args) != 2:
        return None
    a, b = order.args
    if not (isinstance(a, E.ColumnRef) and isinstance(b, E.ColumnRef)):
        return None
    oa = _owner(a, outer, inner, lt, rt)
    ob = _owner(b, outer, inner, lt, rt)
    if {oa, ob} != {"outer", "inner"}:
        return None
    lref, rref = (a, b) if oa == "outer" else (b, a)
    return (order.name, FUNCTION_TO_METRIC[order.name], lref.name,
            rref.name)


def _rewrite_lateral(e, outer, inner, lt, rt):
    """Rewrite column refs to the knn_join output namespace
    (left_*/right_*)."""
    if isinstance(e, E.ColumnRef):
        side = _owner(e, outer, inner, lt, rt)
        if side == "outer":
            return E.ColumnRef(f"left_{e.name}")
        if side == "inner":
            return E.ColumnRef(f"right_{e.name}")
        return e
    if isinstance(e, E.FunctionCall):
        return E.FunctionCall(e.name, [_rewrite_lateral(a, outer, inner,
                                                        lt, rt)
                                       for a in e.args])
    if isinstance(e, E.BinaryOp):
        return E.BinaryOp(e.op, _rewrite_lateral(e.left, outer, inner, lt, rt),
                          _rewrite_lateral(e.right, outer, inner, lt, rt))
    if isinstance(e, E.Aliased):
        return E.Aliased(_rewrite_lateral(e.expr, outer, inner, lt, rt),
                         e.name)
    if isinstance(e, E.UnaryOp):
        return E.UnaryOp(e.op, _rewrite_lateral(e.arg, outer, inner, lt, rt))
    if isinstance(e, E.IsNotNull):
        return E.IsNotNull(_rewrite_lateral(e.arg, outer, inner, lt, rt))
    return e


# ---------------------------------------------------------------------------
# EXPLAIN
# ---------------------------------------------------------------------------


def _explain(db: Database, sel: P.SelectStmt) -> str:
    items = sel.from_items
    if len(items) == 1 and isinstance(items[0], P.TableRef):
        table = db.table(items[0].name)
        if any(_has_aggregate(p) for p in sel.projections):
            # min_by rewrite visibility (hnsw_topk.test EXPLAIN pattern)
            agg = _find_min_by(sel.projections)
            if agg is not None:
                val_e, key_e, k_e = agg.args
                qb = QueryBuilder(table).select(val_e).order_by(
                    E.canonicalize(key_e)).limit(
                        int(P._const_value(k_e)))
                return qb.explain()
        qb = QueryBuilder(table)
        named = _expand_projections(sel.projections, list(table.columns))
        alias_map = {n: e for n, e in named
                     if not isinstance(e, E.ColumnRef)}
        for n, e in named:
            qb.select(e if isinstance(e, E.ColumnRef)
                      else E.Aliased(e, n) if not isinstance(e, E.Aliased)
                      else e)
        if sel.where is not None:
            qb.where(_strip_qualifiers(sel.where, items[0]))
        if sel.order is not None:
            order = sel.order
            # ORDER BY <select alias> participates in the index-scan
            # rewrite (hnsw_result.test EXPLAIN asserts this)
            if isinstance(order, E.ColumnRef) and order.name in alias_map \
                    and order.name not in table.columns:
                order = alias_map[order.name]
            qb.order_by(_strip_qualifiers(order, items[0]),
                        desc=sel.order_desc)
        if sel.limit is not None:
            qb.limit(sel.limit)
        return qb.explain()
    if len(items) == 2 and isinstance(items[0], P.TableRef) \
            and isinstance(items[1], P.Lateral):
        outer, sub = items[0], items[1].sub
        inner = sub.from_items[0]
        lt, rt = db.table(outer.name), db.table(inner.name)
        order = E.canonicalize(sub.order)
        m = _match_lateral_distance(order, outer, inner, lt, rt)
        if m is None:
            raise BinderError("cannot explain this lateral join")
        fname, metric, lcol, rcol = m
        return explain_knn_join(db, lt, rt, lcol, rcol, sub.limit,
                                metric=metric)
    raise BinderError("EXPLAIN supports single-table and lateral selects")


def _find_min_by(projections):
    def walk(e):
        if isinstance(e, E.FunctionCall):
            if e.name == "min_by" and len(e.args) == 3:
                return e
            for a in e.args:
                r = walk(a)
                if r is not None:
                    return r
        if isinstance(e, E.BinaryOp):
            return walk(e.left) or walk(e.right)
        if isinstance(e, (E.Aliased,)):
            return walk(e.expr)
        if isinstance(e, (E.UnaryOp, E.IsNotNull)):
            return walk(e.arg)
        return None

    for p in projections:
        if not isinstance(p, P.Star):
            r = walk(p)
            if r is not None:
                return r
    return None
