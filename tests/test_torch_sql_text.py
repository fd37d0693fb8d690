"""Port parity: the SQL text surface (sql/parser.py, sql/frontend.py)
against the JAX package's, on the statements of tests/test_sql_text.py:
the same script through the JAX ``Database().execute`` and the port's
``Database(device="cpu").execute`` must give the same results, the same
EXPLAIN text and the same error messages.

Where a script creates an index, both engines build it, and then the
port's is replaced by a copy of the JAX one (utils/convert.
index_from_arrays, searching with layout="flat" as the JAX package does
on the CPU), so both search one graph; later DML goes through each
engine's own maintenance.

Tolerances: the data are small integers, so most values are exact in
f32 and compared exactly; float columns are held within 2 d 2^-24
(relative, d <= 8) of the JAX values. Where a top-k cuts through a
group of equal distances the two engines may keep different members of
it: those results are compared as distance profiles, and ids within
ties (``assert_same_ids_within_ties``).
"""

import numpy as np
import pytest
import torch

from duckdb_vss_tpu.sql import engine as jengine
from duckdb_vss_tpu.utils.config import BinderError as JBinderError
from duckdb_vss_tpu_torch.sql import engine as tengine
from duckdb_vss_tpu_torch.utils.config import BinderError, HNSWConfig
from duckdb_vss_tpu_torch.utils.convert import index_from_arrays
from test_torch_hnsw_api import jax_arrays
from test_torch_topk import assert_same_ids_within_ties

torch.set_num_threads(2)

REL = 2 * 8 * 2.0 ** -24
GRID = ("CREATE TABLE t1 (vec FLOAT[3]);"
        "INSERT INTO t1 SELECT array_value(a,b,c) FROM "
        "range(1,10) ra(a), range(1,10) rb(b), range(1,10) rc(c);")


class Pair:
    """One script, two engines."""

    def __init__(self, path=None):
        self.j = jengine.Database(path=None if path is None
                                  else str(path / "jax"))
        self.t = tengine.Database(path=None if path is None
                                  else str(path / "port"), device="cpu")

    def run(self, sql):
        """(port result, JAX result); after a CREATE INDEX the port's
        index becomes a copy of the JAX one."""
        want = self.j.execute(sql)
        got = self.t.execute(sql)
        if "CREATE INDEX" in sql.upper():
            for name, e in self.j.indexes.items():
                cfg = e.index.config
                self.t.indexes[name].index = index_from_arrays(
                    jax_arrays(e.index), HNSWConfig.from_options(
                        metric=cfg.metric.value, m=cfg.m, m0=cfg.m0,
                        ef_construction=cfg.ef_construction,
                        ef_search=cfg.ef_search),
                    device="cpu", layout="flat")
        return got, want

    def same(self, sql):
        got, want = self.run(sql)
        assert_same(got, want)
        return got

    def errors(self, sql):
        """Both raise a BinderError with the same text."""
        msgs = []
        for db, err in ((self.j, JBinderError), (self.t, BinderError)):
            with pytest.raises(err) as info:
                db.execute(sql)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1], msgs
        return msgs[0]


def assert_same(got, want):
    """Equal results: strings (EXPLAIN), counts and None exactly; column
    batches column by column, floats within REL."""
    if not isinstance(want, dict):
        assert got == want
        return
    assert list(got) == list(want)
    for c in want:
        assert_close(got[c], want[c], c)


def assert_close(g, w, where):
    if isinstance(w, dict):
        assert isinstance(g, dict) and list(g) == list(w), where
        for k in w:
            assert_close(g[k], w[k], f"{where}.{k}")
        return
    if isinstance(w, (list, tuple)) or (isinstance(w, np.ndarray)
                                        and w.dtype == object):
        assert len(g) == len(w), where
        for i, (a, b) in enumerate(zip(g, w)):
            assert_close(a, b, f"{where}[{i}]")
        return
    g, w = np.asarray(g), np.asarray(w)
    assert g.shape == w.shape, where
    if w.dtype.kind == "f":
        assert np.allclose(g, w, rtol=REL, atol=1e-6, equal_nan=True), (
            where, g, w)
    else:
        assert np.array_equal(g, w), (where, g, w)


def assert_same_topk_vectors(got, want, q):
    """A top-k over vectors that may cut a group of equal distances."""
    d = {k: np.sqrt(((np.asarray(v["vec"], np.float64) - q) ** 2).sum(1))
         for k, v in (("got", got), ("want", want))}
    np.testing.assert_allclose(d["got"], d["want"], rtol=REL)
    ids = {k: np.asarray([hash(tuple(r)) for r in np.asarray(v["vec"])])
           for k, v in (("got", got), ("want", want))}
    assert_same_ids_within_ties(ids["got"][None], ids["want"][None],
                                d["want"][None], np.full(1, 1e-6), "sql")


@pytest.fixture()
def grid():
    p = Pair()
    got, want = p.run(GRID)
    assert got == want == 729
    return p


@pytest.fixture(scope="module")
def indexed():
    """The grid with an l2sq index, shared by the read-only cases."""
    p = Pair()
    p.run(GRID)
    p.same("CREATE INDEX my_idx ON t1 USING HNSW (vec);")
    return p


def test_create_insert_rowcount(grid):
    assert grid.t.table("t1").row_count == grid.j.table("t1").row_count
    grid.same("SELECT count(*) AS n FROM t1;")


def test_index_scan_plan_and_results(indexed):
    plan = indexed.same("EXPLAIN SELECT * FROM t1 ORDER BY "
                     "array_distance(vec, [1,2,3]::FLOAT[3]) LIMIT 3;")
    assert "HNSW_INDEX_SCAN" in plan
    res = indexed.same("SELECT array_distance([1,2,3]::FLOAT[3], vec) < 1.5 "
                    "FROM t1 ORDER BY array_distance(vec, [1,2,3]::FLOAT[3]) "
                    "LIMIT 3;")
    assert list(res["expr_0"]) == [True, True, True]


@pytest.mark.parametrize("stmt,needle", [
    ("EXPLAIN SELECT * FROM t1 ORDER BY vec <-> [1,2,3]::FLOAT[3] LIMIT 3;",
     "HNSW_INDEX_SCAN"),
    ("EXPLAIN SELECT * FROM t1 ORDER BY array_cosine_distance(vec, "
     "[1,2,3]::FLOAT[3]) LIMIT 3;", "FLAT_TOPN_SCAN"),
    ("EXPLAIN SELECT min_by(vec, array_distance(vec, [1,2,3]::FLOAT[3]), 3)"
     " as x FROM t1;", "HNSW_INDEX_SCAN"),
    ("EXPLAIN SELECT array_distance(vec, [1,2,3]::FLOAT[3]) as x FROM t1 "
     "ORDER BY x LIMIT 3;", "HNSW_INDEX_SCAN"),
    ("EXPLAIN SELECT * FROM t1 WHERE vec[1] > 2 ORDER BY "
     "array_distance(vec, [1,2,3]::FLOAT[3]) LIMIT 3;", "FILTER"),
])
def test_explain_text_equal(indexed, stmt, needle):
    assert needle in indexed.same(stmt)


def test_cosine_canonicalization(grid):
    grid.same("CREATE INDEX cos_idx ON t1 USING HNSW (vec) "
              "WITH (metric='cosine');")
    plan = grid.same("EXPLAIN SELECT * FROM t1 ORDER BY 1.0 - "
                     "array_cosine_similarity(vec, [1,2,3]::FLOAT[3]) LIMIT 3;")
    assert "HNSW_INDEX_SCAN" in plan


def test_operator_alias_results(indexed):
    res = indexed.same("SELECT vec FROM t1 ORDER BY vec <-> [2,2,2]::FLOAT[3] "
                    "LIMIT 1;")
    np.testing.assert_array_equal(res["vec"][0], [2, 2, 2])


def test_min_by(indexed):
    res = indexed.same("SELECT list_sum(flatten(min_by(vec, array_distance(vec, "
                    "[5,5,5]::FLOAT[3]), 3))) BETWEEN 43 AND 50 FROM t1;")
    assert res["expr_0"][0]
    # k >= 2048: the exact generic path, every row in stable order
    res = indexed.same("SELECT min_by(vec, array_distance(vec, "
                       "[1,2,3]::FLOAT[3]), 3000) as x FROM t1;")
    assert len(res["x"][0]) == 729


@pytest.mark.parametrize("stmt", [
    "CREATE INDEX i ON t USING HNSW (vec) WITH (metric='nonexist');",
    "CREATE INDEX i ON t USING HNSW (vec) WITH (m=1);",
    "CREATE INDEX i ON t USING HNSW (vec) WITH (ef_construction=0);",
    "CREATE INDEX i ON t USING IVF (vec);",
    "SET nonsense = 1;",
    "PRAGMA nonsense;",
    "DROP TABLE nope;",
    "SELEC 1;",
    "SELECT * FROM t ORDER BY x @ 1;",
    "INSERT INTO t VALUES (1, 2);",
    "CREATE TABLE t2 (v INT[3]);",
    "SELECT * FROM t, LATERAL (SELECT * FROM t LIMIT 1);",
])
def test_error_messages_equal(stmt):
    p = Pair()
    p.run("CREATE TABLE t (vec FLOAT[4]); INSERT INTO t VALUES ([1,2,3,4]);")
    p.errors(stmt)


def test_crud_and_compact():
    p = Pair()
    p.run("CREATE TABLE t (id BIGINT, vec FLOAT[3]);")
    assert p.run("INSERT INTO t SELECT a, array_value(a, a, a) "
                 "FROM range(100) r(a);") == (100, 100)
    p.same("CREATE INDEX idx ON t USING HNSW (vec);")
    assert p.run("DELETE FROM t WHERE id < 10;") == (10, 10)
    p.same("PRAGMA hnsw_compact_index('idx');")
    res = p.same("SELECT id FROM t ORDER BY array_distance(vec, "
                 "[5,5,5]::FLOAT[3]) LIMIT 1;")
    assert res["id"][0] == 10
    info = p.run("SELECT * FROM pragma_hnsw_index_info();")
    for r in info:
        r.pop("build_distance_count"), r.pop("search_distance_count")
    assert_same(*info)


def test_update_ctas_and_insert_select():
    p = Pair()
    p.run("CREATE TABLE t (id BIGINT, vec FLOAT[2]);")
    p.run("INSERT INTO t VALUES (1, [1,1]), (2, [2,2]), (3, NULL);")
    assert p.run("UPDATE t SET vec = [9,9]::FLOAT[2] WHERE id = 2;") == (1, 1)
    assert p.run("UPDATE t SET vec = array_value(id, id * 2) "
                 "WHERE id = 1;") == (1, 1)
    p.same("SELECT id, vec FROM t ORDER BY array_distance(vec, "
           "[9,9]::FLOAT[2]) LIMIT 3;")
    assert p.run("CREATE TABLE c AS SELECT id, vec FROM t;") == (3, 3)
    assert p.run("INSERT INTO c SELECT id + 10, vec FROM t;") == (3, 3)
    p.same("SELECT * FROM c;")
    p.same("SELECT id, array_distance(vec, [0,0]::FLOAT[2]) AS d, "
           "vec IS NULL AS n FROM c WHERE id > 2;")


def test_lateral_join_sql():
    p = Pair()
    p.run("CREATE TABLE a (a_vec FLOAT[3], a_id INT);"
          "CREATE TABLE b (b_vec FLOAT[3], b_str VARCHAR);"
          "INSERT INTO a VALUES (ARRAY[1.0, 2.0, 3.0], 1), "
          "(ARRAY[4.0, 5.0, 6.0], 2);"
          "INSERT INTO b VALUES (ARRAY[4.0, 5.0, 6.0], 'b'), "
          "(ARRAY[1.0, 2.0, 3.0], 'a');")
    p.same("CREATE INDEX my_idx ON b USING HNSW (b_vec);")
    plan = p.same("EXPLAIN select * from a, lateral (select * from b order "
                  "by array_distance(a.a_vec, b.b_vec) limit 1);")
    assert "HNSW_INDEX_JOIN" in plan
    res = p.same("select * from a, lateral (select *, a_id as id_dup from b "
                 "order by array_distance(a.a_vec, b.b_vec) limit 1);")
    assert sorted(zip(res["a_id"], res["b_str"])) == [(1, "a"), (2, "b")]
    p.same("select * from a, lateral (select array_distance(a.a_vec, "
           "b.b_vec) as dist, * from b order by dist limit 1);")
    p.run("INSERT INTO a VALUES (NULL, 3);")
    res = p.same("select a_id from a, lateral (select * from b "
                 "order by array_distance(a.a_vec, b.b_vec) limit 2);")
    assert list(res["a_id"]).count(3) == 2


def test_lateral_join_group_by_and_flat():
    p = Pair()
    p.run("CREATE TABLE a (v FLOAT[2], aid INT);"
          "CREATE TABLE b (v FLOAT[2], bid INT);"
          "INSERT INTO a VALUES ([0,0], 1), ([10,10], 2);"
          "INSERT INTO b SELECT array_value(x, x), x FROM range(5) r(x);")
    q = ("select aid, count(*) as n, list(bid) as ids from a, lateral "
         "(select bid from b order by array_distance(a.v, b.v) limit 2) "
         "group by aid;")
    assert "FLAT_KNN_JOIN" in p.same(
        "EXPLAIN select aid from a, lateral (select bid from b order by "
        "array_distance(a.v, b.v) limit 2);")
    flat = p.same(q)
    p.same("CREATE INDEX bidx ON b USING HNSW (v);")
    indexed = p.same(q)
    assert_same(indexed, flat)


def test_macros_and_from_less_selects():
    p = Pair()
    p.run("CREATE TABLE l (v FLOAT[2], tag VARCHAR);"
          "CREATE TABLE r (v FLOAT[2], tag VARCHAR);"
          "INSERT INTO l VALUES ([1,1], 'l1'), ([5,5], 'l2');"
          "INSERT INTO r VALUES ([1,1.1], 'r1'), ([5,5.1], 'r2');")
    res = p.same("SELECT * FROM vss_join(l, r, v, v, 1);")
    assert sorted(res["right_tag"]) == ["r1", "r2"]
    res = p.same("SELECT * FROM vss_match(r, [5,5]::FLOAT[2], v, 1);")
    assert list(res["right_tag"]) == ["r2"]
    p.same("SELECT * FROM l, vss_match(r, v, v, 2);")
    assert p.same("SELECT 1 + 2 AS x;")["x"][0] == 3
    p.same("SELECT array_value(1, 2, 3) AS v, array_distance([1,2]::FLOAT[2],"
           " [4,6]::FLOAT[2]) AS d, array_cosine_similarity([1,0]::FLOAT[2], "
           "[1,1]::FLOAT[2]) AS c;")
    p.same("SELECT a, b FROM range(3) x(a), range(2) y(b) WHERE a + b > 1 "
           "ORDER BY a - b DESC LIMIT 3;")


def test_pragma_info_set_and_drop():
    p = Pair()
    p.run("CREATE TABLE t (vec FLOAT[4]);"
          "INSERT INTO t SELECT array_value(a, a, a, a) FROM range(50) r(a);")
    p.same("CREATE INDEX idx ON t USING HNSW (vec);")
    p.same("SET hnsw_ef_search = 99;")
    assert p.t.settings == p.j.settings
    p.errors("SET nonsense = 1;")
    p.same("DROP INDEX idx;")
    p.same("DROP INDEX IF EXISTS idx;")
    assert p.same("SELECT * FROM pragma_hnsw_index_info();") == {}
    p.same("DROP TABLE t;")
    p.errors("DROP TABLE t;")
    assert not p.t.tables and not p.t.indexes


def test_disable_optimizer_and_ties(indexed):
    """Ties at the cut: the indexed top-3 is held as a distance profile
    and ids within ties; the brute-force one (stable host sort) exactly."""
    q = ("SELECT vec FROM t1 ORDER BY "
         "array_distance(vec, [1,2,3]::FLOAT[3]) LIMIT 3;")
    indexed.same("PRAGMA disable_optimizer;")
    try:
        assert "HNSW_INDEX_SCAN" not in indexed.same("EXPLAIN " + q)
        indexed.same(q)
    finally:
        indexed.same("PRAGMA enable_optimizer;")
    got, want = indexed.run(q)
    assert_same_topk_vectors(got, want, np.array([1, 2, 3], np.float64))
    got, want = indexed.run("SELECT array_distance(vec, [1,2,3]::FLOAT[3]) "
                            "as x FROM t1 ORDER BY x LIMIT 3;")
    assert got["x"].tolist() == want["x"].tolist() == [0.0, 1.0, 1.0]


def test_projection_shapes():
    p = Pair()
    p.run("CREATE TABLE embeddings (id INT, vec FLOAT[3]);"
          "INSERT INTO embeddings SELECT 1, array_value(1,2,3);"
          "INSERT INTO embeddings SELECT 2, array_value(4,5,6);")
    p.same("CREATE INDEX idx ON embeddings USING HNSW (vec);")
    base = ("FROM embeddings ORDER BY "
            "array_distance(vec, [1.0,2.0,3.0]::FLOAT[3]) LIMIT 1;")
    for proj in ["*", "vec, id", "id", "id, vec",
                 "id, vec, array_distance(vec, [1.0,2.0,3.0]::FLOAT[3]) "
                 "as dist"]:
        p.same(f"SELECT {proj} " + base)


def test_checkpoint_restart_sql(tmp_path):
    p = Pair(tmp_path)
    p.run("SET hnsw_enable_experimental_persistence = true;"
          "CREATE TABLE t (vec FLOAT[3]);"
          "INSERT INTO t SELECT array_value(a,b,c) FROM "
          "range(1,6) x(a), range(1,6) y(b), range(1,6) z(c);")
    p.same("CREATE INDEX idx ON t USING HNSW (vec);")
    p.same("CHECKPOINT;")
    p.run("INSERT INTO t VALUES ([9,9,9]);")
    for db in (p.j, p.t):
        db.wal.close()
    p.j = jengine.open_database(str(tmp_path / "jax"))
    p.t = tengine.open_database(str(tmp_path / "port"), device="cpu")
    p.t.indexes["idx"].index.layout = "flat"
    assert "HNSW_INDEX_SCAN" in p.same(
        "EXPLAIN SELECT * FROM t ORDER BY array_distance(vec, "
        "[1,2,3]::FLOAT[3]) LIMIT 3;")
    res = p.same("SELECT array_distance([9,9,9]::FLOAT[3], vec) AS d FROM t "
                 "ORDER BY array_distance(vec, [9,9,9]::FLOAT[3]) LIMIT 2;")
    assert res["d"][0] == 0.0
    got, want = p.run("SELECT * FROM pragma_database_size();")
    assert_same(got, want)
