"""The port's spans and counters (duckdb_vss_tpu_torch.utils.tracing):
under torch.profiler a search, a point SQL statement, a 256-row insert
and a sharded search on a one-process CPU mesh each hold the spans
that the module's docstring names, nested as it says; outside the
profiler a span enters no record_function and a count keeps nothing;
the counters equal what the search returns."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from duckdb_vss_tpu_torch.models import hnsw as hnsw_mod
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.parallel import sharded as tsh
from duckdb_vss_tpu_torch.sql.engine import Database
from duckdb_vss_tpu_torch.utils import tracing
from duckdb_vss_tpu_torch.utils.config import HNSWConfig

torch.set_num_threads(2)

D = 16
N = 4096  # the bulk build's threshold: one bulk build, no insert steps
EPS = 0.01  # us: the trace file's rounding


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


@pytest.fixture(scope="module")
def index():
    idx = HNSWIndex(D, HNSWConfig(), capacity=8192, device="cpu")
    idx.add(_rows(N), np.arange(N))
    assert idx.tables.use_layout(idx.layout, idx.nbr_budget_bytes)  # K1's
    return idx


@pytest.fixture(scope="module")
def db():
    d = Database(device="cpu")
    d.execute(f"CREATE TABLE items (id BIGINT, vec FLOAT[{D}])")
    d.table("items").insert({"id": np.arange(N, dtype=np.int64),
                             "vec": _rows(N)})
    d.execute("CREATE INDEX items_idx ON items USING HNSW (vec)")
    return d


@pytest.fixture(scope="module")
def sharded():
    sh = tsh.ShardedHNSWIndex(D, HNSWConfig(), tsh.make_mesh(2, device="cpu"),
                              capacity_per_shard=1024)
    sh.add(_rows(1024, 1), np.arange(1024))
    return sh


def _statement(q):
    lit = "[" + ", ".join(repr(float(x)) for x in q) + f"]::FLOAT[{D}]"
    return (f"SELECT id, array_distance(vec, {lit}) AS d FROM items "
            f"ORDER BY array_distance(vec, {lit}) LIMIT 10")


def _traced(tmp_path, fn):
    """fn() under utils.tracing.trace: (its result, the spans [(name,
    start, end, tid)] and the aten operators, in start order)."""
    log = str(tmp_path / "tb")
    with tracing.trace(log):
        out = fn()
    [path] = glob.glob(os.path.join(log, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, ops = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        rec = (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               e.get("tid"))
        if e.get("cat") == "user_annotation":
            spans.append(rec)
        elif e.get("cat") == "cpu_op" and e["name"].startswith("aten::"):
            ops.append(rec)
    return out, sorted(spans, key=lambda s: s[1]), sorted(
        ops, key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parent):
    return (child[3] == parent[3] and child[1] >= parent[1] - EPS
            and child[2] <= parent[2] + EPS)


def _one(spans, name):
    [s] = _named(spans, name)
    return s


def _each_inside(spans, names, parent):
    """Every span called one of ``names`` lies inside ``parent``; each
    name occurs at least once."""
    for name in names:
        got = _named(spans, name)
        assert got, name
        assert all(_inside(s, parent) for s in got), name


def test_search_spans_nest_and_cover_search_graph(index, tmp_path,
                                                  monkeypatch):
    """index.search holds a chunk's upload, search_graph's four stages
    and the download; every aten operator search_graph runs lies inside
    one of its stages, on the same thread and clock."""
    search_graph = hnsw_mod.search_graph

    def marked(*args, **kwargs):
        with torch.profiler.record_function("test.search_graph"):
            return search_graph(*args, **kwargs)

    monkeypatch.setattr(hnsw_mod, "search_graph", marked)
    (_, keys), spans, ops = _traced(
        tmp_path, lambda: index.search(_rows(8, 2), 5, chunk=4))
    assert keys.shape == (8, 5)
    top = _one(spans, "index.search")
    stages = ("search.descent", "search.seed", "search.beam",
              "search.finish")
    _each_inside(spans, ("index.upload", "index.download") + stages, top)
    assert len(_named(spans, "index.upload")) == 2  # one a chunk
    calls = _named(spans, "test.search_graph")
    assert len(calls) == 2
    for call in calls:
        mine = [s for s in spans if s[0] in stages and _inside(s, call)]
        assert [s[0] for s in mine] == list(stages)  # in this order
        inner = [o for o in ops if _inside(o, call)]
        assert inner
        loose = [o[0] for o in inner
                 if not any(_inside(o, s) for s in mine)]
        assert not loose, loose
    assert _one(spans, "index.download")[1] > calls[-1][2] - EPS


def test_sql_statement_spans(db, tmp_path):
    """sql.execute holds the parse, then the statement's plan, its
    operators (the index search inside the scan, the scan inside the
    projection) and the column batch."""
    q = _rows(1, 3)[0]
    res, spans, _ = _traced(tmp_path, lambda: db.execute(_statement(q)))
    assert len(res["id"]) == 10
    top = _one(spans, "sql.execute")
    _each_inside(spans, ("sql.parse", "sql.plan", "sql.project", "sql.scan",
                         "index.search", "sql.result"), top)
    parse, plan, project, scan, search, result = (
        _one(spans, n) for n in ("sql.parse", "sql.plan", "sql.project",
                                 "sql.scan", "index.search", "sql.result"))
    assert parse[2] <= plan[1] + EPS and plan[2] <= project[1] + EPS
    assert _inside(scan, project) and _inside(search, scan)
    assert project[2] <= result[1] + EPS


def test_insert_spans_and_rows_counter(tmp_path):
    """A 256-row insert is one insert step inside index.add, split into
    its upper levels, base layer and back-links (every aten operator of
    the step in one of them), then the int8 rows refreshed; the
    insert.rows counter counts the rows."""
    idx = HNSWIndex(D, HNSWConfig(), capacity=8192, device="cpu")
    idx.add(_rows(N), np.arange(N))
    tracing.reset_counters()
    _, spans, ops = _traced(tmp_path, lambda: idx.add(
        _rows(256, 4), np.arange(N, N + 256)))
    top = _one(spans, "index.add")
    step = _one(spans, "insert.step")
    assert _inside(step, top)
    phases = [_one(spans, n) for n in ("insert.upper", "insert.base",
                                       "insert.backlinks")]
    assert all(_inside(p, step) for p in phases)
    assert phases[0][2] <= phases[1][1] + EPS
    assert phases[1][2] <= phases[2][1] + EPS
    rows = _one(spans, "insert.rows")
    assert _inside(rows, top) and rows[1] >= step[2] - EPS
    loose = [o[0] for o in ops if _inside(o, step)
             and not any(_inside(o, p) for p in phases)]
    assert not loose, loose
    assert tracing.counters()["insert.rows"] == 256
    tracing.reset_counters()


def test_sharded_search_spans(sharded, tmp_path):
    """sharded.search holds the upload, the issue (every shard's
    search_graph and its stages inside it), the gather, the merge and
    the download, in that order."""
    (_, keys), spans, _ = _traced(tmp_path,
                                  lambda: sharded.search(_rows(8, 5), 5))
    assert keys.shape == (8, 5) and (keys >= 0).all()
    top = _one(spans, "sharded.search")
    names = ("sharded.upload", "sharded.issue", "sharded.gather",
             "sharded.merge", "sharded.download")
    _each_inside(spans, names, top)
    firsts = [_named(spans, n)[0] for n in names]
    assert all(a[2] <= b[1] + EPS for a, b in zip(firsts, firsts[1:]))
    issue = _one(spans, "sharded.issue")
    for stage in ("search.descent", "search.beam", "search.finish"):
        got = _named(spans, stage)
        assert len(got) == 2 and all(_inside(s, issue) for s in got)


def test_spans_off_enter_no_record_function(index, db, sharded,
                                            monkeypatch):
    """Outside the profiler no span enters record_function or opens an
    NVTX range, and no count is kept; under it the same calls do enter
    it (the patch is the one the spans use)."""
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    nvtx = []
    monkeypatch.setattr(tracing, "record_function", Counting)
    for fn in ("range_push", "range_pop", "range", "mark"):
        monkeypatch.setattr(torch.cuda.nvtx, fn,
                            lambda *a, _fn=fn, **k: nvtx.append(_fn))
    tracing.reset_counters()
    q = _rows(4, 6)

    def calls():
        index.search(q, 5)
        db.execute(_statement(q[0]))
        sharded.search(q, 5)

    calls()
    assert entered == [] and nvtx == []
    assert tracing.counters() == {}
    assert tracing.annotate("x") is tracing.annotate("y")  # one no-op
    with torch.profiler.profile():
        calls()
    assert {"index.search", "sql.execute", "sharded.search",
            "search.beam"} <= set(entered)
    assert nvtx == []
    tracing.reset_counters()


def test_counters_equal_what_the_search_returns(index):
    """search.distances is the n_dist search_graph returns, search.queries
    the rows searched, K1's counts part of it; search_distance_count is
    an int that grows by the same n_dist, read back only when read."""
    q = index.store.prepare_queries(_rows(8, 7))
    tracing.reset_counters()
    with torch.profiler.profile():
        _, _, n_dist = index.search_device(q, 5)
    c = tracing.counters()
    assert c["search.distances"] == int(n_dist) > 0
    assert c["search.queries"] == 8
    assert 0 < c["k1.distances"] < c["search.distances"]
    assert c["k1.expansions"] > 0
    tracing.reset_counters()
    before = index.search_distance_count
    index.search(_rows(8, 7), 5)
    assert index._search_nd_dev is not None  # not read back yet
    after = index.search_distance_count
    assert isinstance(after, int) and after - before == int(n_dist)
    assert index._search_nd_dev is None
    index.search_distance_count = 5
    assert index.search_distance_count == 5
    assert index.stats()["search_distance_count"] == 5


def test_span_decorator_keeps_the_function():
    @tracing.span("test.f")
    def f(x, y=1):
        """doc"""
        return x + y

    assert f.__name__ == "f" and f.__doc__ == "doc" and f(1, y=2) == 3
    tracing.count("test.count", 3)  # profiler off: not kept
    assert "test.count" not in tracing.counters()
