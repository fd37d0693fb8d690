"""Port parity: blockwise top-k and FlatIndex against the JAX package.

Exact paths: scores within 1e-5 and the same ids. Tie order (lowest
index first among equal scores) is held on data whose scores are exact
in f32 (small integers), where both libraries must agree bit for bit.
On float data, planted duplicate rows score within a few ulps of each
other and their order rests on two GEMM libraries rounding every copy
alike wherever it sits in their blocking, which no contract promises;
there the ids are compared as sets within each group of reference
scores closer than the tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from duckdb_vss_tpu.models.flat import FlatIndex as JFlat
from duckdb_vss_tpu.ops import topk as jt
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch.models.flat import FlatIndex
from duckdb_vss_tpu_torch.ops import topk as tt
from duckdb_vss_tpu_torch.utils.config import MetricKind

torch.set_num_threads(2)


def test_smallest_k_lowest_index_ties():
    """torch.topk does not keep the lowest index among ties; smallest_k
    must (lax.top_k's order)."""
    s = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0]])
    sc, pos = tt.smallest_k(s, 3)
    assert pos.tolist() == [[1, 2, 4]]
    assert sc.tolist() == [[1.0, 1.0, 1.0]]
    sc, pos = tt.smallest_k(s, 2)
    assert pos.tolist() == [[1, 2]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_smallest_k_matches_lax_top_k_with_ties(seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 6, size=(16, 200)).astype(np.float32)  # many ties
    neg, want_pos = lax.top_k(-jnp.asarray(s), 9)
    sc, pos = tt.smallest_k(torch.from_numpy(s), 9)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(sc.numpy(), -np.asarray(neg))


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 20, (8, 10)).astype(np.float32), 1)
    b = np.sort(rng.integers(0, 20, (8, 6)).astype(np.float32), 1)
    ia = rng.integers(0, 1000, (8, 10)).astype(np.int32)
    ib = rng.integers(0, 1000, (8, 6)).astype(np.int32)
    ws, wi = jt.merge_topk(jnp.asarray(a), jnp.asarray(ia), jnp.asarray(b),
                           jnp.asarray(ib), 7)
    gs, gi = tt.merge_topk(*(torch.from_numpy(x) for x in (a, ia, b, ib)), 7)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def _data(seed, n, d, b, ties):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    if ties:
        # exact duplicates: equal scores that only the tie order separates
        v[100:140] = v[7]
        v[500:520] = v[9]
        q[:4] = v[7] + 0.01
        q[4:8] = v[9]
    return q, v


TIE_TOL = 1e-5  # reference scores closer than this form one tie group


def assert_same_ids_within_ties(got_i, want_i, want_s, tol=TIE_TOL):
    """Row by row: split the reference's ascending scores into groups of
    neighbours closer than ``tol``. A group that ends before the k-th
    place must hold the same ids in both results, in any order. The
    last group may be cut by k, and two libraries may keep different
    members of it: there the ids must be distinct and new."""
    k = want_s.shape[1]
    for r, (g, w, s) in enumerate(zip(got_i.tolist(), want_i.tolist(),
                                      want_s.tolist())):
        start = 0
        while start < k:
            end = start + 1
            while end < k and abs(s[end] - s[end - 1]) <= tol:
                end += 1
            if end < k:
                assert set(g[start:end]) == set(w[start:end]), (r, start, end)
            else:
                tail = g[start:]
                assert len(set(tail)) == len(tail), (r, tail)
                assert not set(tail) & set(g[:start]), (r, tail)
            start = end


def _flat_topk_both(q, v, metric, block_n):
    n = v.shape[0]
    valid = np.ones(n, bool)
    valid[::13] = False
    ws, wi = jt.flat_topk(jnp.asarray(q), jnp.asarray(v), 10, JMetric(metric),
                          valid=jnp.asarray(valid), block_n=block_n)
    gs, gi = tt.flat_topk(torch.from_numpy(q), torch.from_numpy(v), 10,
                          MetricKind(metric), valid=torch.from_numpy(valid),
                          block_n=block_n)
    return gs.numpy(), gi.numpy(), np.asarray(ws), np.asarray(wi)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
@pytest.mark.parametrize("n,block_n", [(1024, 16384), (4096, 1024)])
def test_flat_topk_matches_jax(metric, n, block_n):
    q, v = _data(4, n, 32, 24, ties=True)
    gs, gi, ws, wi = _flat_topk_both(q, v, metric, block_n)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)
    assert_same_ids_within_ties(gi, wi, ws)
    # rows without a planted duplicate have no ties: identical ids
    np.testing.assert_array_equal(gi[8:], wi[8:])


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
@pytest.mark.parametrize("n,block_n", [(1024, 16384), (4096, 1024)])
def test_flat_topk_tie_order_on_exact_scores(metric, n, block_n):
    """Small-integer vectors: every product, norm and sum is exact in
    f32, so equal rows score bit-equal within each library in any
    blocking and the ids must be identical, ties to the lowest index,
    across block boundaries too. The scores agree exactly for l2sq and
    ip; cosine's division may round one ulp apart between the
    libraries (atol 2e-7), alike for every copy of a row."""
    rng = np.random.default_rng(8)
    v = rng.integers(-2, 3, size=(n, 32)).astype(np.float32)
    q = rng.integers(-2, 3, size=(24, 32)).astype(np.float32)
    v[100:140] = v[7]
    v[n - 30:n - 10] = v[9]  # copies in the last block as well
    q[:4] = v[7]
    q[4:8] = v[9]
    gs, gi, ws, wi = _flat_topk_both(q, v, metric, block_n)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=0,
                               atol=2e-7 if metric == "cosine" else 0)
    assert (np.diff(ws, axis=1) == 0).sum() > 24  # the data does tie


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_flat_index_search_matches_jax(metric):
    q, v = _data(5, 3000, 40, 33, ties=True)
    keys = np.arange(3000, dtype=np.int64) * 3 + 11
    jf = JFlat(40, JMetric(metric), capacity=3000)
    tf = FlatIndex(40, MetricKind(metric), capacity=3000, device="cpu")
    for f in (jf, tf):
        f.add(v, keys)
        assert f.remove(keys[::7]) == len(keys[::7])
    ws, wk = jf.search(q, 12)
    gs, gk = tf.search(q, 12)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)
    # tombstoned slots are reused LIFO, in the same order in both stores
    extra = np.random.default_rng(6).normal(size=(20, 40)).astype(np.float32)
    js = jf.add(extra, np.arange(20) + 10**6)
    ts = tf.add(extra, np.arange(20) + 10**6)
    np.testing.assert_array_equal(ts, js)
    ws, wk = jf.search(q, 12)
    gs, gk = tf.search(q, 12)
    np.testing.assert_array_equal(gk, wk)


def test_flat_index_k_beyond_size_and_errors():
    f = FlatIndex(8, MetricKind.L2SQ, device="cpu")
    v = np.random.default_rng(7).normal(size=(5, 8)).astype(np.float32)
    f.add(v, np.arange(5))
    s, k = f.search(v[:2], 8)
    assert (k[:, 5:] == -1).all() and (k[:, :5] >= 0).all()
    assert set(k[0, :5].tolist()) == set(range(5))
    assert k[0, 0] == 0 and k[1, 0] == 1
    with pytest.raises(ValueError, match="duplicate key 3"):
        f.add(v[:1], [3])
    assert len(f) == 5
    assert f.capacity == 1024
    f.reserve(5000)
    assert f.capacity == 8192 and f._vectors.shape == (8192, 128)
