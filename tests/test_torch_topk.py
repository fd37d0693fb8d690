"""Port parity: blockwise top-k and FlatIndex against the JAX package.

Exact paths compute the same f32 values in another order of additions:
the two libraries (and one library on hosts whose BLAS takes another
code path) may differ by their rounding errors, and no further. So the
tolerances here are derived from the computation instead of chosen:

- a d-term f32 inner product is off from the exact value by at most
  d u |a||b| (u = 2^-24, the unit roundoff; Higham's gamma_d bound), a
  squared norm by d u |a|^2;
- l2sq = |q|^2 + |v|^2 - 2 q.v is then off by at most (2d + 3) u
  (|q|^2 + |v|^2); cosine = 1 - q.v / sqrt(|q|^2 |v|^2) by at most
  (2d + 4) u; ip = 1 - q.v by at most (d + 1) u (|q||v| + 1);
- two results, each within that of the exact value, differ by at most
  twice it, which BOUND_C d u (...) covers for d >= 8 (BOUND_C = 5).

Scores must agree within that bound. Ids must be equal wherever the
reference's gap between neighbouring scores exceeds twice the bound
(then no rounding can swap them); within closer groups they are
compared as sets (``assert_same_ids_within_ties``). Tie order (lowest
index first among equal scores) is held on data whose scores are exact
in f32 (small integers), where both libraries must agree bit for bit.
"""

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

U = 2.0 ** -24  # f32 unit roundoff
BOUND_C = 5


def score_bound(q, v, metric):
    """Per query row, the largest difference two correct f32
    computations of its scores against any row of ``v`` may show (see
    the module docstring). [B] float64."""
    q = q.astype(np.float64)
    v = v.astype(np.float64)
    d = q.shape[1]
    q_sq = (q * q).sum(1)
    v_sq_max = (v * v).sum(1).max()
    if metric == "l2sq":
        scale = q_sq + v_sq_max
    elif metric == "cosine":
        scale = np.ones_like(q_sq)
    else:
        scale = np.sqrt(q_sq * v_sq_max) + 1.0
    return BOUND_C * d * U * scale


def assert_scores_within(got, want, bound, metric):
    """Every score within its row's bound; the message names the first
    row that misses it, the metric and both values."""
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bad = diff > bound[:, None]
    if bad.any():
        r, c = map(int, np.argwhere(bad)[0])
        raise AssertionError(
            f"{metric}: row {r}, place {c}: port {got[r, c]!r} vs JAX "
            f"{want[r, c]!r}, difference {diff[r, c]:.3e} > bound "
            f"{bound[r]:.3e} ({int(bad.sum())} places miss it)")


def assert_same_ids_within_ties(got_i, want_i, want_s, tol, metric):
    """Row by row: split the reference's ascending scores into groups of
    neighbours closer than ``tol[row]`` (twice the score bound: a larger
    gap cannot be crossed by rounding). A group that ends before the
    k-th place must hold the same ids in both results, in any order; a
    group of one is an exact id. The last group may be cut by k, and two
    libraries may keep different members of it: there the ids must be
    distinct and new."""
    k = want_s.shape[1]
    for r, (g, w, s) in enumerate(zip(got_i.tolist(), want_i.tolist(),
                                      want_s.tolist())):
        start = 0
        while start < k:
            end = start + 1
            while end < k and abs(s[end] - s[end - 1]) <= tol[r]:
                end += 1
            if end < k:
                assert set(g[start:end]) == set(w[start:end]), (
                    f"{metric}: row {r}, places {start}-{end - 1}: port ids "
                    f"{g[start:end]} vs JAX {w[start:end]} (JAX scores "
                    f"{s[start:end]}, tie tolerance {tol[r]:.3e})")
            else:
                tail = g[start:]
                assert len(set(tail)) == len(tail), (
                    f"{metric}: row {r}: repeated ids in the last group "
                    f"{tail} (JAX {w[start:]})")
                assert not set(tail) & set(g[:start]), (
                    f"{metric}: row {r}: the last group {tail} repeats an "
                    f"earlier id of {g[:start]} (JAX {w})")
            start = end


def test_smallest_k_lowest_index_ties():
    """torch.topk does not keep the lowest index among ties; smallest_k
    must (lax.top_k's order)."""
    s = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0]])
    sc, pos = tt.smallest_k(s, 3)
    assert pos.tolist() == [[1, 2, 4]], pos.tolist()
    assert sc.tolist() == [[1.0, 1.0, 1.0]], sc.tolist()
    sc, pos = tt.smallest_k(s, 2)
    assert pos.tolist() == [[1, 2]], pos.tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_smallest_k_matches_lax_top_k_with_ties(seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 6, size=(16, 200)).astype(np.float32)  # many ties
    neg, want_pos = lax.top_k(-jnp.asarray(s), 9)
    sc, pos = tt.smallest_k(torch.from_numpy(s), 9)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos),
                                  err_msg=f"positions, seed {seed}")
    np.testing.assert_array_equal(sc.numpy(), -np.asarray(neg),
                                  err_msg=f"scores, seed {seed}")


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 20, (8, 10)).astype(np.float32), 1)
    b = np.sort(rng.integers(0, 20, (8, 6)).astype(np.float32), 1)
    ia = rng.integers(0, 1000, (8, 10)).astype(np.int32)
    ib = rng.integers(0, 1000, (8, 6)).astype(np.int32)
    ws, wi = jt.merge_topk(jnp.asarray(a), jnp.asarray(ia), jnp.asarray(b),
                           jnp.asarray(ib), 7)
    gs, gi = tt.merge_topk(*(torch.from_numpy(x) for x in (a, ia, b, ib)), 7)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi), err_msg="ids")
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws),
                                  err_msg="scores")


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
    """Float data with planted duplicate rows: scores within the derived
    bound, ids equal except inside groups the bound cannot separate."""
    q, v = _data(4, n, 32, 24, ties=True)
    gs, gi, ws, wi = _flat_topk_both(q, v, metric, block_n)
    bound = score_bound(q, v, metric)
    assert_scores_within(gs, ws, bound, metric)
    assert_same_ids_within_ties(gi, wi, ws, 2 * bound, metric)


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
    np.testing.assert_array_equal(gi, wi, err_msg=f"{metric}: ids")
    np.testing.assert_allclose(gs, ws, rtol=0,
                               atol=2e-7 if metric == "cosine" else 0,
                               err_msg=f"{metric}: scores")
    assert (np.diff(ws, axis=1) == 0).sum() > 24, "the data does not tie"


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_flat_index_search_matches_jax(metric):
    q, v = _data(5, 3000, 40, 33, ties=True)
    keys = np.arange(3000, dtype=np.int64) * 3 + 11
    jf = JFlat(40, JMetric(metric), capacity=3000)
    tf = FlatIndex(40, MetricKind(metric), capacity=3000, device="cpu")
    for f in (jf, tf):
        f.add(v, keys)
        assert f.remove(keys[::7]) == len(keys[::7])
    bound = score_bound(q, v, metric)
    ws, wk = jf.search(q, 12)
    gs, gk = tf.search(q, 12)
    assert_scores_within(gs, ws, bound, metric)
    assert_same_ids_within_ties(gk, wk, ws, 2 * bound, metric)
    # tombstoned slots are reused LIFO, in the same order in both stores
    extra = np.random.default_rng(6).normal(size=(20, 40)).astype(np.float32)
    js = jf.add(extra, np.arange(20) + 10**6)
    ts = tf.add(extra, np.arange(20) + 10**6)
    np.testing.assert_array_equal(ts, js, err_msg=f"{metric}: reused slots")
    bound = score_bound(q, np.concatenate([v, extra]), metric)
    ws, wk = jf.search(q, 12)
    gs, gk = tf.search(q, 12)
    assert_scores_within(gs, ws, bound, metric)
    assert_same_ids_within_ties(gk, wk, ws, 2 * bound, metric)


def test_flat_index_k_beyond_size_and_errors():
    f = FlatIndex(8, MetricKind.L2SQ, device="cpu")
    v = np.random.default_rng(7).normal(size=(5, 8)).astype(np.float32)
    f.add(v, np.arange(5))
    s, k = f.search(v[:2], 8)
    assert (k[:, 5:] == -1).all() and (k[:, :5] >= 0).all(), k
    assert set(k[0, :5].tolist()) == set(range(5)), k
    assert k[0, 0] == 0 and k[1, 0] == 1, k
    with pytest.raises(ValueError, match="duplicate key 3"):
        f.add(v[:1], [3])
    assert len(f) == 5
    assert f.capacity == 1024
    f.reserve(5000)
    assert f.capacity == 8192 and f._vectors.shape == (8192, 128), (
        f.capacity, tuple(f._vectors.shape))
