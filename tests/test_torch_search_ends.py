"""The two ends of the search around kernel K1: kernel K4, the seed beam,
and kernel K5, the finish (ops/search_ends.py, csrc/search_ends.cu),
held to their plain versions, models/graph.seed_beam and
models/graph._finish_search.

On the CPU search_graph runs the plain versions (spied here) and the
kernels' counters read nothing; the plain versions keep their contract:
a repeated seed keeps its id with INF_SCORE, a seed < 0 is (INF_SCORE,
-1), equal seed scores go by position; the finish drops dead slots and
INF beam entries, and equal exact scores go to the higher slot. With
hop_rerank > 0 search_graph returns what the finish and its one-hop
expansion as one function return (the reference _finish_with_hop).

The tests marked ``gpu`` hold the kernels to the plain versions on the
card, at the batch cell's chunks (8,192 and 1,808 queries) and at one
query, ef 32, 64 and 128, k 10, 4 and 8 seeds, every metric, an f32
and a bf16 store, with dead slots, seeds of -1 and repeated seeds, a
beam row of INF_SCORE only and planted equal scores. On random rows the
sums run in another order than cuBLAS's, so scores agree within the
f32 bound of tests/test_torch_topk.py and ids within its rounding ties;
on small integer rows every sum is exact and both agree bit for bit.
One traced search counts what the seed and the finish launch. This file
imports no JAX, so on a card machine without it they run with
``python -m pytest -o addopts="" -m gpu --noconftest
tests/test_torch_search_ends.py``.
"""

import numpy as np
import pytest
import torch

from duckdb_vss_tpu_torch import HNSWConfig
from duckdb_vss_tpu_torch.models import graph as tgraph
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.ops import search_ends as se
from duckdb_vss_tpu_torch.utils import tracing
from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.padding import INF_SCORE
from torch_tolerances import assert_same_ids_within_ties, score_bound

torch.set_num_threads(2)

METRICS = [MetricKind.L2SQ, MetricKind.IP, MetricKind.COSINE]
CAP, D, K = 65_536, 128, 10
CARD_SHAPES = [(b, ef, p) for b in (8192, 1808, 1) for ef in (32, 64, 128)
               for p in (4, 8)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -o "
                    "addopts='' -m gpu --noconftest "
                    "tests/test_torch_search_ends.py` on the GPU machine")
    return torch.device("cuda")


def _store(dev, dtype, integer, seed=0, cap=CAP, d=D):
    """(vectors, vec_sq, valid): SIFT-like magnitudes, or small integers
    (every product and sum exact in f32); a zero row (cosine's zero-norm
    rule), rows 11 and 12 equal to row 10 (equal scores for every
    query), a twentieth of the slots dead, slot 20 among them."""
    rng = np.random.default_rng(seed)
    v = (rng.integers(-3, 4, (cap, d)) if integer
         else 30.0 * rng.random((cap, d))).astype(np.float32)
    v[7] = 0.0
    v[11] = v[12] = v[10]
    vt = torch.from_numpy(v).to(dtype)
    stored = vt.float().numpy()
    valid = rng.random(cap) >= 0.05
    valid[[7, 10, 11, 12]] = True
    valid[20] = False
    return (vt.to(dev), torch.from_numpy((stored * stored).sum(1)).to(dev),
            torch.from_numpy(valid).to(dev))


def _queries(dev, b, integer, seed=1, d=D):
    rng = np.random.default_rng(seed)
    q = (rng.integers(-3, 4, (b, d)) if integer
         else 30.0 * rng.random((b, d))).astype(np.float32)
    q[b // 2] = 0.0  # a zero query
    qt = torch.from_numpy(q).to(dev)
    return qt, (qt * qt).sum(-1)


def _seeds(dev, b, p, seed=2, cap=CAP):
    """[B, P] slots with a tenth of -1 and a tenth repeating the seed
    before them; query 0 holds the planted equal rows, query 1 only
    -1."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, cap, (b, p)).astype(np.int32)
    s[rng.random((b, p)) < 0.1] = -1
    rep = rng.random((b, p)) < 0.1
    rep[:, 0] = False
    s[rep] = np.roll(s, 1, axis=1)[rep]
    s[0, :3] = [11, 10, 12]
    if b > 1:
        s[1] = -1
    return torch.from_numpy(s).to(dev)


def _beam(dev, b, ef, seed=3, cap=CAP):
    """A beam as K1 leaves it: distinct slots past 20 with ascending
    scores, then INF_SCORE with id -1 in a random tail; query 0 holds
    the planted equal rows, the zero row and the dead slot 20, query 1
    is INF_SCORE only."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, cap, (b, 1))
    ids = (21 + (start + 499 * np.arange(ef)) % (cap - 21)).astype(np.int32)
    s = np.sort(rng.random((b, ef)).astype(np.float32), 1)
    n_live = rng.integers(ef // 2, ef + 1, b)
    tail = np.arange(ef)[None, :] >= n_live[:, None]
    s[tail], ids[tail] = INF_SCORE, -1
    ids[0, :5] = [12, 10, 11, 7, 20]
    s[0, :5] = s[0, 0]
    if b > 1:
        s[1], ids[1] = INF_SCORE, -1
    return torch.from_numpy(s).to(dev), torch.from_numpy(ids).to(dev)


def _np(*ts):
    return [t.cpu().numpy() for t in ts]


def _check_close(got_s, got_i, want_s, want_i, q, vectors, metric, what):
    """Scores within the f32 bound, ids equal within rounding ties; the
    INF_SCORE places exactly alike."""
    got_s, got_i, want_s, want_i = _np(got_s, got_i, want_s, want_i)
    inf = want_s >= INF_SCORE
    np.testing.assert_array_equal(got_s >= INF_SCORE, inf, err_msg=what)
    np.testing.assert_array_equal(got_i[inf], want_i[inf], err_msg=what)
    # the INF places (-1s, repeated seeds) are alike: give them distinct
    # ids, so the ties' comparison reads the scored places alone
    mark = -10 - np.broadcast_to(np.arange(inf.shape[1]), inf.shape)
    got_i, want_i = np.where(inf, mark, got_i), np.where(inf, mark, want_i)
    bound = score_bound(q.cpu().numpy(), vectors.float().cpu().numpy(),
                        metric.value)
    diff = np.abs(got_s.astype(np.float64) - want_s)
    assert (np.where(inf, 0.0, diff) <= bound[:, None]).all(), (
        f"{what}: a score differs by {float(np.max(np.where(inf, 0, diff)))}")
    assert_same_ids_within_ties(got_i, want_i, want_s, 2.0 * bound,
                                f"{what} {metric.value}")


# ---------------------------------------------------------------------------
# the CPU: the plain versions, their contract and the choice of path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_index():
    rng = np.random.default_rng(4)
    idx = HNSWIndex(32, HNSWConfig(), capacity=3000, device="cpu")
    idx.add(rng.normal(size=(3000, 32)).astype(np.float32), np.arange(3000))
    return idx, rng.normal(size=(40, 32)).astype(np.float32)


def test_cpu_search_runs_the_plain_versions(cpu_index, monkeypatch):
    """On the CPU search_graph calls seed_beam and _finish_search (K1's
    path: the layout is on), launches neither kernel and counts nothing
    under their counters while the profiler records."""
    idx, q = cpu_index
    calls = {"seed": 0, "finish": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tgraph, "seed_beam", spy("seed", tgraph.seed_beam))
    monkeypatch.setattr(tgraph, "_finish_search",
                        spy("finish", tgraph._finish_search))
    launches = se.seed_kernel.launches, se.finish_kernel.launches
    tracing.reset_counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        idx.search(q, K, chunk=16)
        got = tracing.counters()
    tracing.reset_counters()
    assert calls == {"seed": 3, "finish": 3}  # one a chunk of 40 rows
    assert (se.seed_kernel.launches, se.finish_kernel.launches) == launches
    assert got["search.queries"] == 40
    assert "seed.kernel_queries" not in got
    assert "finish.kernel_queries" not in got


def test_kernels_refuse_cpu_tensors():
    vectors, vec_sq, valid = _store("cpu", torch.float32, True, cap=64)
    q, q_sq = _queries("cpu", 2, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        se.seed_kernel(vectors, vec_sq, _seeds("cpu", 2, 4, cap=64), q, q_sq,
                       MetricKind.L2SQ, 16, torch.zeros((), dtype=torch.int64))
    s, i = _beam("cpu", 2, 16, cap=64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        se.finish_kernel(vectors, vec_sq, valid, q, q_sq, MetricKind.L2SQ,
                         K, s, i)


def test_finish_spills_past_shared_memory():
    """K5 ranks its beam in shared memory up to ef 29,056 (8 bytes an
    entry), past that in a buffer on the card."""
    assert not se.finish_spills(64) and not se.finish_spills(29_056)
    assert se.finish_spills(29_057) and se.finish_spills(40_000)


@pytest.mark.parametrize("ef", [3, 4, 8])
def test_seed_beam_contract(ef):
    """seed_beam on exact scores: a repeat keeps its id with INF_SCORE,
    -1 is (INF_SCORE, -1), equal scores in seed order, INF places in
    seed order, then padding; with ef below P the first ef."""
    vectors = torch.zeros((6, 8))
    vectors[:, 0] = torch.tensor([4.0, 1.0, 3.0, 1.0, 2.0, 0.0])
    vec_sq = (vectors * vectors).sum(1)
    seeds = torch.tensor([[2, 1, -1, 3, 1, 4]], dtype=torch.int32)
    q = torch.zeros((1, 8))
    s, i = tgraph.seed_beam(vectors, vec_sq, seeds, q, (q * q).sum(1),
                            MetricKind.L2SQ, ef)
    want_s = [1.0, 1.0, 4.0, 9.0, INF_SCORE, INF_SCORE, INF_SCORE, INF_SCORE]
    want_i = [1, 3, 4, 2, -1, 1, -1, -1]
    assert s[0].tolist() == want_s[:ef] and i[0].tolist() == want_i[:ef]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finish_ties_go_to_the_higher_slot(metric, dtype):
    """_finish_search on exact scores (4-way equal rows): the order of
    (score ascending, slot descending), the dead slot 8 and INF beam
    entries dropped, (INF_SCORE, -1) past the live entries: the contract
    K5 keeps. The same as an exact oracle."""
    vectors = torch.zeros((40, 128), dtype=dtype)
    vectors[:, 0] = torch.arange(40, dtype=torch.float32) % 4 + 1
    vec_sq = (vectors.float() ** 2).sum(1)
    valid = torch.ones(40, dtype=torch.bool)
    valid[[8, 9]] = False
    ids = (torch.arange(16, dtype=torch.int32) * 2).repeat(2, 1)
    scores = torch.zeros((2, 16))
    scores[1, 4:] = float(INF_SCORE)
    q = torch.zeros((2, 128))
    q[:, 0] = 1.0
    k = 12
    s, i = tgraph._finish_search(vectors, vec_sq, valid, q, (q * q).sum(1),
                                 metric, k, scores, ids)
    v = vectors[:, 0].double().numpy()
    exact = {MetricKind.L2SQ: (1.0 - v) ** 2, MetricKind.IP: 1.0 - v,
             MetricKind.COSINE: 0.0 * v}[metric]
    for row in range(2):
        live = [int(x) for x, sc in zip(ids[row], scores[row])
                if valid[int(x)] and sc < INF_SCORE]
        want = sorted(live, key=lambda x: (exact[x], -x))[:k]
        pad = k - len(want)
        assert i[row].tolist() == want + [-1] * pad
        assert s[row].tolist() == [exact[x] for x in want] + [
            float(INF_SCORE)] * pad


def _finish_with_hop(vectors, vec_sq, valid_mask, queries, q_sq, metric, k,
                     scores, ids, n_dist, hop, neighbors0, tiles):
    """The finish as one function, the exact top k and its one-hop
    expansion together, as search_graph ran it before the expansion
    became graph._one_hop: the reference the split is held to."""
    live = valid_mask[ids.clamp_min(0).long()] & (ids >= 0)
    exact = tgraph.gather_scores(vectors, vec_sq, ids, queries, q_sq, metric)
    exact = torch.where(live & (scores < INF_SCORE), exact, INF_SCORE)
    out_s, out_i = tgraph._sort_score_then_high_id(exact, ids, k)
    b = queries.shape[0]
    h = min(int(hop), k)
    src = out_i[:, :h]
    safe_src = src.clamp_min(0).long()
    nbrs = torch.where((src >= 0)[:, :, None], neighbors0[safe_src], -1)
    cand = nbrs.reshape(b, -1)
    if tiles is not None:
        q_i8, q_scale = tgraph.quantize_queries_i8(queries)
        s_c = tgraph._int8_tile_scores(*tiles, safe_src, q_i8, q_scale, q_sq,
                                       metric)
    else:
        s_c = tgraph.gather_scores(vectors, vec_sq, cand, queries, q_sq,
                                   metric)
    in_out = (cand[:, :, None] == out_i[:, None, :]).any(dim=2)
    sorted_c, order_c = torch.sort(cand, dim=1, stable=True)
    dup_sorted = torch.cat(
        [torch.zeros((b, 1), dtype=torch.bool, device=cand.device),
         sorted_c[:, 1:] == sorted_c[:, :-1]], 1)
    dup = torch.zeros_like(dup_sorted).scatter_(1, order_c, dup_sorted)
    live_c = valid_mask[cand.clamp_min(0).long()]
    keep = (cand >= 0) & live_c & ~in_out & ~dup
    s_c = torch.where(keep, s_c, INF_SCORE)
    n_dist = n_dist + (cand >= 0).sum()
    top_s, pos = tgraph.smallest_k(s_c, min(16, cand.shape[1]))
    cand_r = torch.gather(cand, 1, pos)
    ok_r = (top_s < INF_SCORE) & (cand_r >= 0)
    exact_r = tgraph.gather_scores(vectors, vec_sq, cand_r, queries, q_sq,
                                   metric)
    m_s = torch.cat([out_s, torch.where(ok_r, exact_r, INF_SCORE)], 1)
    m_i = torch.cat([out_i, torch.where(ok_r, cand_r, -1)], 1)
    out_s, out_i = tgraph._sort_score_then_high_id(m_s, m_i, k)
    return out_s, out_i, n_dist


@pytest.mark.parametrize("hop", [1, 3, 10])
def test_one_hop_reads_the_finish_top_k(cpu_index, monkeypatch, hop):
    """hop_rerank > 0: search_graph's scores, ids and count equal those
    of the finish and its one-hop expansion as one function
    (_finish_with_hop) on the beam search_graph finished, bit for bit;
    the expansion's candidates are counted."""
    idx, q = cpu_index
    seen = {}
    finish, one_hop = tgraph._finish_search, tgraph._one_hop

    def keep_finish(*a):
        seen["beam"] = a
        return finish(*a)

    def keep_hop(*a):
        seen["hop"] = a
        return one_hop(*a)

    monkeypatch.setattr(tgraph, "_finish_search", keep_finish)
    monkeypatch.setattr(tgraph, "_one_hop", keep_hop)
    got = idx.search_device(idx.store.prepare_queries(q), K, hop_rerank=hop)
    n_before, h, neighbors0, tiles = seen["hop"][9:]
    assert h == hop
    want = _finish_with_hop(*seen["beam"], n_before, hop, neighbors0, tiles)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert int(got[2]) > int(n_before)


# ---------------------------------------------------------------------------
# the card: the kernels against the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seed_kernel_on_card(metric, dtype):
    """K4 against seed_beam at every shape: scores within the bound, ids
    within ties, the INF places alike, n_dist equal; on integer rows
    bit for bit."""
    dev = _card()
    for integer in (False, True):
        vectors, vec_sq, _ = _store(dev, dtype, integer)
        for b, ef, p in CARD_SHAPES:
            q, q_sq = _queries(dev, b, integer)
            seeds = _seeds(dev, b, p)
            what = f"B={b} ef={ef} P={p} {dtype} integer={integer}"
            n = torch.tensor(5, dtype=torch.int64, device=dev)
            got_s, got_i = se.seed_kernel(vectors, vec_sq, seeds, q, q_sq,
                                          metric, ef, n)
            want_s, want_i = tgraph.seed_beam(vectors, vec_sq, seeds, q, q_sq,
                                              metric, ef)
            torch.cuda.synchronize()
            assert int(n) == 5 + int((seeds >= 0).sum()), what
            if integer:
                for g, w in zip((got_s, got_i), (want_s, want_i)):
                    np.testing.assert_array_equal(*_np(g, w), err_msg=what)
            else:
                _check_close(got_s, got_i, want_s, want_i, q, vectors, metric,
                             what)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finish_kernel_on_card(metric, dtype):
    """K5 against _finish_search at every shape: scores within the
    bound, ids within ties, the INF places alike; on integer rows (the
    planted equal rows among them) bit for bit."""
    dev = _card()
    for integer in (False, True):
        vectors, vec_sq, valid = _store(dev, dtype, integer)
        for b, ef, _p in CARD_SHAPES[::2]:
            q, q_sq = _queries(dev, b, integer)
            s, i = _beam(dev, b, ef)
            what = f"B={b} ef={ef} {dtype} integer={integer}"
            got_s, got_i = se.finish_kernel(vectors, vec_sq, valid, q, q_sq,
                                            metric, K, s, i)
            want_s, want_i = tgraph._finish_search(
                vectors, vec_sq, valid, q, q_sq, metric, K, s, i)
            torch.cuda.synchronize()
            if integer:
                for g, w in zip((got_s, got_i), (want_s, want_i)):
                    np.testing.assert_array_equal(*_np(g, w), err_msg=what)
            else:
                _check_close(got_s, got_i, want_s, want_i, q, vectors, metric,
                             what)
            assert b == 1 or (got_i[1] == -1).all(), what


@pytest.mark.gpu
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finish_kernel_spills_on_card(metric, dtype):
    """K5 on beams too wide for shared memory (ef 29,057 and 40,000,
    ranked in its buffer on the card) against _finish_search: scores
    within the bound, ids within ties; on integer rows bit for bit."""
    dev = _card()
    for integer in (False, True):
        vectors, vec_sq, valid = _store(dev, dtype, integer)
        for ef in (29_057, 40_000):
            q, q_sq = _queries(dev, 3, integer)
            s, i = _beam(dev, 3, ef)
            what = f"ef={ef} {dtype} integer={integer}"
            assert se.finish_spills(ef)
            got_s, got_i = se.finish_kernel(vectors, vec_sq, valid, q, q_sq,
                                            metric, K, s, i)
            want_s, want_i = tgraph._finish_search(
                vectors, vec_sq, valid, q, q_sq, metric, K, s, i)
            torch.cuda.synchronize()
            if integer:
                for g, w in zip((got_s, got_i), (want_s, want_i)):
                    np.testing.assert_array_equal(*_np(g, w), err_msg=what)
            else:
                _check_close(got_s, got_i, want_s, want_i, q, vectors, metric,
                             what)


@pytest.mark.gpu
def test_one_hop_after_the_finish_kernel_on_card():
    """The one-hop expansion of K5's top k equals that of
    _finish_search's on the same beam (integer rows: bit for bit)."""
    dev = _card()
    vectors, vec_sq, valid = _store(dev, torch.float32, True)
    rng = np.random.default_rng(9)
    nbrs = torch.from_numpy(rng.integers(-1, CAP, (CAP, 32)).astype(
        np.int32)).to(dev)
    q, q_sq = _queries(dev, 1808, True)
    s, i = _beam(dev, 1808, 64)
    args = (vectors, vec_sq, valid, q, q_sq, MetricKind.L2SQ, K)
    n0 = torch.tensor(0, device=dev)
    got = tgraph._one_hop(*args, *se.finish_kernel(*args, s, i), n0, 3,
                          nbrs, None)
    want = tgraph._one_hop(*args, *tgraph._finish_search(*args, s, i), n0,
                           3, nbrs, None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(*_np(g, w))


@pytest.mark.gpu
def test_search_on_card_launches_four_kernels_at_most():
    """One traced HNSWIndex.search of the batch cell's 10,000 queries
    (two chunks) on the card: the seed and the finish launch at most 4
    kernels a chunk between them, K4 and K5 take every query, and their
    plain versions never run."""
    from portbench.trace import Profile

    dev = _card()
    rng = np.random.default_rng(6)
    idx = HNSWIndex(D, HNSWConfig(), capacity=20_000, device=dev)
    idx.add(rng.random((20_000, D)).astype(np.float32), np.arange(20_000))
    q = rng.random((10_000, D)).astype(np.float32)
    idx.search(q, K)  # builds the layout; warms every shape
    calls = {"seed": 0, "finish": 0}

    def spy(name):
        def fail(*a, **kw):
            calls[name] += 1
        return fail

    seed_beam, finish = tgraph.seed_beam, tgraph._finish_search
    tgraph.seed_beam, tgraph._finish_search = spy("seed"), spy("finish")
    tracing.reset_counters()
    try:
        with Profile() as prof:
            idx.search(q, K)
            got = tracing.counters()
    finally:
        tgraph.seed_beam, tgraph._finish_search = seed_beam, finish
        tracing.reset_counters()
    chunks = prof.count("search.seed")
    assert chunks == prof.count("search.finish") == 2
    launched = (len(prof.launched_in("search.seed"))
                + len(prof.launched_in("search.finish")))
    assert launched <= 4 * chunks, launched
    assert calls == {"seed": 0, "finish": 0}
    assert got["seed.kernel_queries"] == got["finish.kernel_queries"] == \
        got["search.queries"] == 10_000
