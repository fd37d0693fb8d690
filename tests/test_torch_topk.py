"""Port parity: blockwise top-k and FlatIndex against the JAX package.

Exact paths: ids must be identical, including the tie order (lowest
index first among equal scores), and scores within 1e-5."""

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


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
@pytest.mark.parametrize("n,block_n", [(1024, 16384), (4096, 1024)])
def test_flat_topk_matches_jax(metric, n, block_n):
    q, v = _data(4, n, 32, 24, ties=True)
    valid = np.ones(n, bool)
    valid[::13] = False
    ws, wi = jt.flat_topk(jnp.asarray(q), jnp.asarray(v), 10, JMetric(metric),
                          valid=jnp.asarray(valid), block_n=block_n)
    gs, gi = tt.flat_topk(torch.from_numpy(q), torch.from_numpy(v), 10,
                          MetricKind(metric), valid=torch.from_numpy(valid),
                          block_n=block_n)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)


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
