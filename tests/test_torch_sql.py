"""Port parity: the SQL engine (duckdb_vss_tpu_torch.sql.engine) against
the JAX package's, case for case as tests/test_sql.py runs the JAX one:
plans and EXPLAIN text, option errors, metric matching, top-k scans,
min_by, filters, DML and compaction, pragma_hnsw_index_info, joins and
the vss_match macro.

Both engines get the same seeded inputs. Where an index is involved
they search one graph: the JAX engine builds it, and
utils/convert.database_from_arrays carries the JAX database (tables,
live flags, indexes) into the port, whose indexes then search with
layout="flat", the step-by-step bf16 beam that the JAX package runs on
the CPU. DML after the carry-over goes through each engine's own insert
path, whose graphs may differ in near-ties (tests/test_torch_insert.py).

Tolerances: a distance column is an f32 sum of d squares (then a root)
in two libraries, held within 2 d 2^-24 of the JAX value (relative);
ids must be equal wherever the JAX result's gap to the next distance
exceeds twice that (``assert_same_ids_within_ties``), and form the same
set within closer groups. EXPLAIN text, error messages and row counts
must be equal exactly.
"""

import io
import re

import numpy as np
import pytest
import torch

from duckdb_vss_tpu.sql import engine as jengine
from duckdb_vss_tpu.sql import expr as jE
from duckdb_vss_tpu.utils.config import BinderError as JBinderError
from duckdb_vss_tpu_torch.sql import engine as tengine
from duckdb_vss_tpu_torch.sql import expr as tE
from duckdb_vss_tpu_torch.utils.config import BinderError
from duckdb_vss_tpu_torch.utils.convert import (database_from_arrays,
                                                database_to_arrays)
from test_torch_hnsw_api import jax_arrays
from test_torch_topk import assert_same_ids_within_ties

torch.set_num_threads(2)

D = 16
REL = 2 * D * 2.0 ** -24


def jax_database_arrays(jdb):
    """A JAX Database as database_from_arrays takes it."""
    tables = {}
    for name, t in jdb.tables.items():
        # the JAX checkpoint's own serializer: npz columns + object lists
        cols, objects, blob = jengine._serialize_table(t)
        arrays = dict(np.load(io.BytesIO(blob), allow_pickle=False))
        arrays.update({c: np.asarray(v, dtype=object)
                       for c, v in objects.items()})
        tables[name] = {"columns": cols, "arrays": arrays}
    indexes = {}
    for name, e in jdb.indexes.items():
        cfg = e.index.config
        indexes[name] = {
            "table": e.table.name, "column": e.column,
            "config": {"metric": cfg.metric.value, "m": cfg.m, "m0": cfg.m0,
                       "ef_construction": cfg.ef_construction,
                       "ef_search": cfg.ef_search},
            "arrays": jax_arrays(e.index)}
    return {"settings": dict(jdb.settings), "tables": tables,
            "indexes": indexes}


def carry(jdb):
    """The port's copy of a JAX database, searching as the JAX one does
    on the CPU."""
    tdb = database_from_arrays(jax_database_arrays(jdb), device="cpu")
    for e in tdb.indexes.values():
        e.index.layout = "flat"
    return tdb


def make_pair(n=500, seed=0, with_index=True, metric="l2sq"):
    """test_sql.make_db in the JAX engine, and its port copy."""
    rng = np.random.default_rng(seed)
    jdb = jengine.Database()
    t = jdb.create_table("items", {"id": "BIGINT", "vec": ("FLOAT", D)})
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    t.insert({"id": np.arange(n), "vec": list(vecs)})
    if with_index:
        jdb.create_hnsw_index("idx", "items", "vec", metric=metric)
    return jdb, carry(jdb), vecs, rng


def dist(E, q, fn="array_distance"):
    return E.fn(fn, E.col("vec"), E.const(q))


def assert_same_topk(got, want, dcol="d", idcol="id"):
    """Same columns; distances within the f32 bound; ids within ties."""
    assert list(got) == list(want)
    assert len(got[idcol]) == len(want[idcol])
    g, w = np.asarray(got[dcol], np.float64), np.asarray(want[dcol],
                                                         np.float64)
    bound = REL * np.abs(w) + 1e-7
    assert np.all(np.abs(g - w) <= bound), (g, w)
    tol = np.full(1, 2 * bound.max())
    assert_same_ids_within_ties(np.asarray(got[idcol])[None],
                                np.asarray(want[idcol])[None], w[None], tol,
                                "sql")


# -- plans: EXPLAIN text equal, and the expected operator --------------------

PLAN_CASES = {
    # name: (index metric or None, query builder, must, must not)
    "index_scan": ("l2sq", lambda E, t, v: t.select("id").order_by(
        dist(E, v[0])).limit(5), "HNSW_INDEX_SCAN", None),
    "no_index_flat": (None, lambda E, t, v: t.select("id").order_by(
        dist(E, v[0])).limit(5), "FLAT_TOPN_SCAN", "HNSW_INDEX_SCAN"),
    "metric_mismatch": ("l2sq", lambda E, t, v: t.select("id").order_by(
        dist(E, v[0], "array_cosine_distance")).limit(5), None,
        "HNSW_INDEX_SCAN"),
    "cosine_canonical": ("cosine", lambda E, t, v: t.select("id").order_by(
        1.0 - dist(E, v[0], "array_cosine_similarity")).limit(5),
        "HNSW_INDEX_SCAN", None),
    "filter_pull_up": ("l2sq", lambda E, t, v: t.select("id").where(
        E.col("id") < 100).order_by(dist(E, v[0])).limit(5),
        r"FILTER.*\n.*HNSW_INDEX_SCAN", None),
    "desc_not_rewritten": ("l2sq", lambda E, t, v: t.select("id").order_by(
        dist(E, v[0]), desc=True).limit(5), "TOP_N", "HNSW_INDEX_SCAN"),
    "alias_l2": ("l2sq", lambda E, t, v: t.select("id").order_by(
        E.fn("<->", E.col("vec"), E.const(v[0]))).limit(3),
        "HNSW_INDEX_SCAN", None),
    "alias_ip": ("ip", lambda E, t, v: t.select("id").order_by(
        E.fn("<#>", E.col("vec"), E.const(v[5]))).limit(3),
        "HNSW_INDEX_SCAN", None),
    "const_first": ("l2sq", lambda E, t, v: t.select("id").order_by(
        E.fn("array_distance", E.const(v[3]), E.col("vec"))).limit(3),
        "HNSW_INDEX_SCAN", None),
}


@pytest.fixture(scope="module")
def plan_pairs():
    """One pair per index metric (None: no index), made at first use and
    shared by the plan cases, which only read."""
    pairs = {}

    def get(metric):
        if metric not in pairs:
            pairs[metric] = make_pair(n=200, with_index=metric is not None,
                                      metric=metric or "l2sq")
        return pairs[metric]

    return get


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_explain_text_equal(case, plan_pairs):
    metric, build, must, must_not = PLAN_CASES[case]
    jdb, tdb, vecs, _ = plan_pairs(metric)
    want = build(jE, jdb.table("items"), vecs).explain()
    got = build(tE, tdb.table("items"), vecs).explain()
    assert got == want
    if must:
        assert re.search(must, got), got
    if must_not:
        assert must_not not in got


# -- results -----------------------------------------------------------------


@pytest.mark.parametrize("with_index", [True, False])
def test_topk_results(with_index):
    """The index scan (and, without an index, the exact flat scan) gives
    the JAX engine's rows; the exact scan equals the brute force."""
    jdb, tdb, vecs, rng = make_pair(n=400, with_index=with_index)
    for q in rng.normal(size=(4, D)).astype(np.float32):
        res = {}
        for name, E, db in (("jax", jE, jdb), ("port", tE, tdb)):
            t = db.table("items")
            res[name] = (t.select("id", dist(E, q).alias("d"))
                         .order_by(dist(E, q)).limit(10).execute())
        assert_same_topk(res["port"], res["jax"])
        if not with_index:
            d = np.sqrt(((vecs - q) ** 2).sum(1))
            assert set(res["port"]["id"]) == set(np.argsort(d)[:10])


def test_filter_and_ef_search():
    jdb, tdb, vecs, rng = make_pair(n=400)
    for db, E in ((jdb, jE), (tdb, tE)):
        db.set("hnsw_ef_search", 200)
    q = rng.normal(size=D).astype(np.float32)
    res = {}
    for name, E, db in (("jax", jE, jdb), ("port", tE, tdb)):
        t = db.table("items")
        res[name] = (t.select("id", dist(E, q).alias("d"))
                     .where(E.col("id") >= 100).order_by(dist(E, q))
                     .limit(50).execute())
    assert (res["port"]["id"] >= 100).all()
    assert_same_topk(res["port"], res["jax"])
    with pytest.raises(BinderError, match="unknown setting"):
        tdb.set("unknown_setting", 1)


@pytest.mark.parametrize("k", [5, 2048])
def test_min_by(k):
    """The index rewrite (k < 2048) and the generic exact path."""
    jdb, tdb, vecs, rng = make_pair(n=400)
    q = rng.normal(size=D).astype(np.float32)
    want = jdb.table("items").select().min_by("id", dist(jE, q), k)
    got = tdb.table("items").select().min_by("id", dist(tE, q), k)
    d = np.sqrt(((vecs.astype(np.float64) - q) ** 2).sum(1))
    assert_same_topk({"id": np.asarray(got), "d": d[got]},
                     {"id": np.asarray(want), "d": d[want]})
    assert len(got) == min(k, 400)


# -- DML ---------------------------------------------------------------------


def _both(jdb, tdb, fn):
    """fn(db, E, t) on both engines; returns (port, JAX) results."""
    return (fn(tdb, tE, tdb.table("items")),
            fn(jdb, jE, jdb.table("items")))


def test_insert_null_delete_update_compact():
    jdb, tdb, vecs, rng = make_pair(n=300)
    nv = rng.normal(size=D).astype(np.float32)

    def top(db, E, t, q, k=5):
        return (t.select("id", "rowid", dist(E, q).alias("d"))
                .order_by(dist(E, q)).limit(k).execute())

    got, want = _both(jdb, tdb, lambda db, E, t: t.insert(
        [{"id": 999, "vec": nv}, {"id": 1000, "vec": None}]))
    np.testing.assert_array_equal(got, want)
    assert len(tdb.indexes["idx"].index) == len(jdb.indexes["idx"].index) \
        == 301  # the NULL vector is not indexed
    got, want = _both(jdb, tdb, lambda db, E, t: top(db, E, t, nv))
    assert got["id"][0] == want["id"][0] == 999
    got, want = _both(jdb, tdb, lambda db, E, t: t.delete(rowids=[5]))
    assert got == want == 1
    got, want = _both(jdb, tdb, lambda db, E, t: t.delete(
        predicate=E.col("id") > 290))
    assert got == want == 11  # ids 291-299, 999 and 1000
    got, want = _both(jdb, tdb, lambda db, E, t: top(db, E, t, vecs[5]))
    assert 5 not in got["rowid"].tolist()
    assert_same_topk(got, want)
    for db in (jdb, tdb):
        db.pragma_hnsw_compact_index("idx")
    got, want = _both(jdb, tdb, lambda db, E, t: top(db, E, t, vecs[5]))
    assert_same_topk(got, want)
    far = (vecs[0] + 100.0).astype(np.float32)
    got, want = _both(jdb, tdb, lambda db, E, t: t.update(
        [0], [{"id": 0, "vec": far}]))
    np.testing.assert_array_equal(got, want)
    got, want = _both(jdb, tdb, lambda db, E, t: top(db, E, t, far, 1))
    assert got["id"][0] == want["id"][0] == 0
    assert tdb.table("items").row_count == jdb.table("items").row_count


def test_pragma_hnsw_index_info():
    """On one graph every statistic is equal but the distance counters
    (the carried index has counted no build)."""
    jdb, tdb, _, _ = make_pair(n=150)
    (got,), (want,) = tdb.pragma_hnsw_index_info(), \
        jdb.pragma_hnsw_index_info()
    for key in ("build_distance_count", "search_distance_count"):
        got.pop(key), want.pop(key)
    assert got == want and got["count"] == 150 and got["index_name"] == "idx"


def test_own_index_recall():
    """The port's own CREATE INDEX (not carried) reaches the JAX
    engine's recall@10 against the brute force, less 0.02."""
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(600, D)).astype(np.float32)
    qs = rng.normal(size=(30, D)).astype(np.float32)
    truth = np.argsort(((vecs[None] - qs[:, None]) ** 2).sum(-1), 1)[:, :10]
    recall = {}
    for name, mod, E, kw in (("jax", jengine, jE, {}),
                             ("port", tengine, tE, {"device": "cpu"})):
        db = mod.Database(**kw)
        t = db.create_table("items", {"id": "BIGINT", "vec": ("FLOAT", D)})
        t.insert({"id": np.arange(600), "vec": list(vecs)})
        db.create_hnsw_index("idx", "items", "vec")
        got = [t.select("id").order_by(dist(E, q)).limit(10).execute()["id"]
               for q in qs]
        recall[name] = np.mean([len(set(g) & set(w)) / 10
                                for g, w in zip(got, truth)])
    assert recall["port"] >= recall["jax"] - 0.02, recall


def test_create_index_progress_two_phase():
    rng = np.random.default_rng(3)
    rows = [{"vec": v} for v in rng.normal(size=(300, 8)).astype(np.float32)]
    events = {}
    for name, mod, kw in (("jax", jengine, {}),
                          ("port", tengine, {"device": "cpu"})):
        db = mod.Database(**kw)
        db.create_table("t", {"vec": ("FLOAT", 8)}).insert(rows)
        ev = []
        db.create_hnsw_index("idx_p", "t", "vec",
                             on_progress=lambda ph, f, ev=ev: ev.append(
                                 (ph, f)))
        events[name] = ev
    assert events["port"] == events["jax"]
    assert events["port"][0] == ("load", 0.0)
    assert events["port"][-1] == ("build", 1.0)


# -- options: the same BinderError, word for word ------------------------------

OPTION_CASES = {
    "metric": ("vec", {"metric": "manhattan"}),
    "m": ("vec", {"m": 1}),
    "m0": ("vec", {"m0": 0}),
    "ef_construction": ("vec", {"ef_construction": 0}),
    "ef_search": ("vec", {"ef_search": -1}),
    "unknown": ("vec", {"bogus": 3}),
    "non_vector": ("id", {}),
    "duplicate": ("vec", {}),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_option_errors_equal(case):
    column, opts = OPTION_CASES[case]
    jdb, tdb, _, _ = make_pair(n=50, with_index=case == "duplicate")
    msgs = []
    for db, err in ((jdb, JBinderError), (tdb, BinderError)):
        name = "idx" if case == "duplicate" else "i2"
        with pytest.raises(err) as info:
            db.create_hnsw_index(name, "items", column, **opts)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_persistence_gate(tmp_path):
    msgs = []
    for mod, kw, err in ((jengine, {}, JBinderError),
                         (tengine, {"device": "cpu"}, BinderError)):
        db = mod.Database(path=str(tmp_path / mod.__name__), **kw)
        db.create_table("x", {"vec": ("FLOAT", 8)})
        with pytest.raises(err) as info:
            db.create_hnsw_index("i", "x", "vec")
        msgs.append(str(info.value))
        db.set("hnsw_enable_experimental_persistence", True)
        db.create_hnsw_index("i", "x", "vec")
        db.wal.close()
    assert msgs[0] == msgs[1] and "experimental_persistence" in msgs[0]


# -- joins and macros ----------------------------------------------------------


def _join_pair(seed=4, na=20, nb=200, d=8, null_outer=False):
    rng = np.random.default_rng(seed)
    av = rng.normal(size=(na, d)).astype(np.float32)
    bv = rng.normal(size=(nb, d)).astype(np.float32)
    jdb = jengine.Database()
    a = jdb.create_table("a", {"aid": "BIGINT", "v": ("FLOAT", d)})
    b = jdb.create_table("b", {"bid": "BIGINT", "v": ("FLOAT", d)})
    a.insert({"aid": np.arange(na), "v": list(av)})
    if null_outer:
        a.insert([{"aid": na, "v": None}])
    b.insert({"bid": np.arange(nb), "v": list(bv)})
    return jdb


def _assert_same_join(got, want, k):
    assert list(got) == list(want)
    np.testing.assert_array_equal(got["left_aid"], want["left_aid"])
    np.testing.assert_array_equal(got["row_num"], want["row_num"])
    nq = len(want["score"]) // k
    w = np.asarray(want["score"], np.float64).reshape(nq, k)
    g = np.asarray(got["score"], np.float64).reshape(nq, k)
    bound = REL * (np.abs(w).max(1) + 1.0)
    assert np.all(np.abs(g - w) <= bound[:, None])
    assert_same_ids_within_ties(got["right_bid"].reshape(nq, k),
                                want["right_bid"].reshape(nq, k), w,
                                2 * bound, "knn_join")


@pytest.mark.parametrize("use_index", [False, True])
def test_knn_join(use_index):
    jdb = _join_pair(null_outer=True)
    if use_index:
        jdb.create_hnsw_index("bidx", "b", "v")
    tdb = carry(jdb)
    outs = []
    for mod, db in ((tengine, tdb), (jengine, jdb)):
        a, b = db.table("a"), db.table("b")
        outs.append((mod.knn_join(db, a, b, "v", "v", 3,
                                  use_index=use_index or None),
                     mod.explain_knn_join(db, a, b, "v", "v", 3)))
    (got, gplan), (want, wplan) = outs
    assert gplan == wplan
    assert ("HNSW_INDEX_JOIN" if use_index else "FLAT_KNN_JOIN") in gplan
    _assert_same_join(got, want, 3)
    # the NULL outer row probes as the zero vector
    assert (got["left_aid"] == 20).sum() == 3


def test_knn_join_k_guard_and_no_index():
    tdb = carry(_join_pair())
    a, b = tdb.table("a"), tdb.table("b")
    with pytest.raises(BinderError, match="k must be"):
        tengine.knn_join(tdb, a, b, "v", "v", 5000, use_index=False)
    with pytest.raises(BinderError, match="no matching index"):
        tengine.knn_join(tdb, a, b, "v", "v", 3, use_index=True)


def test_vss_match_and_join_macros():
    jdb = _join_pair(seed=6, na=5, nb=50)
    tdb = carry(jdb)
    bv = tdb.table("b").scan()[0]["v"]
    got = tdb.vss_match(tdb.table("b"), bv[7], "v", 1)
    want = jdb.vss_match(jdb.table("b"), bv[7], "v", 1)
    assert got["right_bid"][0] == want["right_bid"][0] == 7
    got = tdb.vss_join(tdb.table("a"), tdb.table("b"), "v", "v", 2)
    want = jdb.vss_join(jdb.table("a"), jdb.table("b"), "v", "v", 2)
    _assert_same_join(got, want, 2)


def test_scalar_functions_run_on_the_database_device(monkeypatch):
    """Projections evaluate the SQL scalar functions on tensors on
    db.device (never on host arrays), and return float32 numpy."""
    from duckdb_vss_tpu_torch.ops import distance

    _, tdb, vecs, _ = make_pair(n=100, with_index=False)
    seen = []
    impl = distance.SCALAR_FUNCTIONS["array_distance"]

    def spy(*args):
        seen.append([(type(a), a.device) for a in args])
        return impl(*args)

    monkeypatch.setitem(distance.SCALAR_FUNCTIONS, "array_distance", spy)
    t = tdb.table("items")
    res = t.select("id", dist(tE, vecs[3]).alias("d")).execute()
    assert res["d"].dtype == np.float32 and res["d"].shape == (100,)
    assert seen and all(tp is torch.Tensor and dev == tdb.device
                        for call in seen for tp, dev in call)
    want = np.sqrt(((vecs.astype(np.float64) - vecs[3]) ** 2).sum(1))
    np.testing.assert_allclose(res["d"], want, rtol=REL, atol=1e-6)


def test_database_arrays_round_trip():
    """database_to_arrays is database_from_arrays' inverse: a port
    database carried out and back holds the same tables, live flags and
    index state, and answers alike."""
    jdb, tdb, vecs, _ = make_pair(n=200)
    tdb.table("items").delete(rowids=[3, 4])
    tdb.table("items").insert([{"id": 7000, "vec": None}])
    arrays = database_to_arrays(tdb)
    back = database_from_arrays(arrays, device="cpu")
    again = database_to_arrays(back)
    assert again["settings"] == arrays["settings"]
    for name, tab in arrays["tables"].items():
        assert again["tables"][name]["columns"] == tab["columns"]
        for c, a in tab["arrays"].items():
            np.testing.assert_array_equal(again["tables"][name]["arrays"][c],
                                          a)
    for f, a in arrays["indexes"]["idx"]["arrays"].items():
        np.testing.assert_array_equal(again["indexes"]["idx"]["arrays"][f],
                                      a, err_msg=f)
    back.indexes["idx"].index.layout = "flat"
    q = vecs[10]
    got = back.table("items").select("id", dist(tE, q).alias("d")).order_by(
        dist(tE, q)).limit(10).execute()
    want = tdb.table("items").select("id", dist(tE, q).alias("d")).order_by(
        dist(tE, q)).limit(10).execute()
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])
