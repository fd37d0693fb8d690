"""Port parity: the rest of FlatIndex (the bf16 store, compact,
prepare_queries' transfer dtypes, get_vector, deferred allocation) and
the stashed flat scan, against the JAX package on the same seeded
inputs.

Tolerances: the bf16 store, its norms, the query transfers and the
compacted arrays are compared bit for bit (the same roundings on the
same values: round to nearest even, numpy's row sums on the host, the
JAX package's int8 arithmetic). The stashed scan returns the per-block
scan's results exactly (the same score values are read again), so it
is held to ``flat_topk`` bit for bit. Searches are held to the JAX
package's with the score bound derived in tests/test_torch_topk.py
(f32 products summed in another order): scores within it, ids equal
wherever the reference's gaps exceed twice it.
"""

import jax.numpy as jnp
import ml_dtypes
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
from duckdb_vss_tpu_torch.utils.convert import host_array
from test_torch_topk import (assert_same_ids_within_ties,
                             assert_scores_within, score_bound)

torch.set_num_threads(2)


def _rows(seed, n, d):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, d)).astype(np.float32) * 3.0
    v[3] = 0.0
    return v


def _bits(arr):
    """A JAX or port store as uint16 (bf16) or uint32 (f32) bits."""
    a = host_array(arr) if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _store_pair(scalar_kind, metric="l2sq", n=600, d=40, cap=1024):
    jf = JFlat(d, JMetric(metric), capacity=cap, scalar_kind=scalar_kind)
    tf = FlatIndex(d, MetricKind(metric), capacity=cap, device="cpu",
                   scalar_kind=scalar_kind)
    return jf, tf


def assert_same_store(jf, tf):
    np.testing.assert_array_equal(_bits(tf._vectors), _bits(jf._vectors),
                                  err_msg="vectors")
    np.testing.assert_array_equal(_bits(tf._vec_sq), _bits(jf._vec_sq),
                                  err_msg="squared norms")
    np.testing.assert_array_equal(tf._valid.numpy(), np.asarray(jf._valid),
                                  err_msg="valid")
    np.testing.assert_array_equal(tf._keys, jf._keys, err_msg="keys")
    assert tf._key_to_slot == jf._key_to_slot
    assert tf._free_slots == jf._free_slots
    assert (tf._next_slot, tf.size, tf.capacity) == (
        jf._next_slot, jf.size, jf.capacity)


def assert_same_search(jf, tf, q, v, metric, k=5):
    """The two stores' searches: scores within the derived bound, ids
    equal where the bound separates them."""
    js, jk = jf.search(q, k)
    ts, tk = tf.search(q, k)
    bound = score_bound(q, v, metric)
    assert_scores_within(ts, js, bound, metric)
    assert_same_ids_within_ties(tk, jk, js, 2 * bound, metric)


def test_bf16_store_bytes_equal_ml_dtypes():
    """The bulk load rounds to nearest even as ml_dtypes does, with norms
    from the rounded rows: the JAX package's store, bit for bit."""
    jf, tf = _store_pair("bf16")
    v = _rows(0, 600, 40)
    v[5, :4] = [1.00390625, 1.01171875, -2.00781250, 3.0e18]  # halfway cases
    for f in (jf, tf):
        f.add(v, np.arange(600) * 2)
    assert tf._vectors.dtype == torch.bfloat16
    want = np.zeros((600, 128), ml_dtypes.bfloat16)
    want[:, :40] = v.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(_bits(tf._vectors)[:600],
                                  want.view(np.uint16))
    assert_same_store(jf, tf)


def test_bf16_scatter_add_and_reserve_keep_dtype():
    """Adds after removals (slot reuse) and past the capacity (reserve):
    the rows equal the JAX package's bf16 rows bit for bit; the norms
    equal the f32 sums of the rounded rows within 1e-6 relative (the
    JAX package sums them on the device, in another order)."""
    jf, tf = _store_pair("bf16")
    v = _rows(1, 1200, 40)
    for f in (jf, tf):
        f.add(v[:500], np.arange(500))
        f.remove(np.arange(0, 500, 7))
        f.add(v[500:600], np.arange(500, 600))  # reuses the freed slots
        f.add(v[600:], np.arange(600, 1200))  # grows to 2048
    assert tf.capacity == jf.capacity == 2048
    assert tf._vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tf._vectors), _bits(jf._vectors))
    np.testing.assert_allclose(tf._vec_sq.numpy(), np.asarray(jf._vec_sq),
                               rtol=1e-6)
    np.testing.assert_array_equal(tf._keys, jf._keys)
    np.testing.assert_array_equal(tf.get_vector(650), jf.get_vector(650))
    assert_same_search(jf, tf, v[[10, 650]], v, "l2sq")


@pytest.mark.parametrize("scalar_kind", ["f32", "bf16"])
def test_compact_matches_jax(scalar_kind):
    """FlatIndex.compact packs the live slots in slot order and shrinks
    the capacity: the same arrays as the JAX package's, bit for bit."""
    jf, tf = _store_pair(scalar_kind, n=3000, cap=3000)
    v = _rows(2, 3000, 40)
    for f in (jf, tf):
        f.add(v, np.arange(3000) + 7)
        f.remove(np.arange(7, 3007, 3))
        f.remove(np.arange(1500, 3007))
        f.compact()
    assert tf.capacity == 1024
    assert_same_store(jf, tf)
    assert_same_search(jf, tf, v[:20], v, "l2sq")


@pytest.mark.parametrize("transfer", ["f32", "bf16", "int8"])
def test_prepare_queries_transfer_dtypes_bitwise(transfer):
    """The three transfer dtypes give the JAX package's device queries bit
    for bit (its batch is padded to a power of two; the rows compare)."""
    q = _rows(3, 13, 40)
    q[4] *= 1e-3
    jf = JFlat(40, JMetric.L2SQ)
    tf = FlatIndex(40, MetricKind.L2SQ, device="cpu")
    want = np.asarray(jf.prepare_queries(q, transfer_dtype=transfer))[:13]
    got = tf.prepare_queries(q, transfer_dtype=transfer)
    assert got.dtype == torch.float32 and tuple(got.shape) == (13, 128)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if transfer != "f32":
        assert not np.array_equal(got.numpy()[:, :40], q)  # it did round
    with pytest.raises(ValueError, match="transfer_dtype"):
        tf.prepare_queries(q, transfer_dtype="f16")


def test_get_vector_and_deferred_allocation():
    f = FlatIndex(12, MetricKind.IP, device="cpu", defer_alloc=True)
    assert f._vectors is None and f._vec_sq is None and f._valid is None
    v = _rows(4, 5, 12)
    g = FlatIndex(12, MetricKind.IP, device="cpu")
    g.add(v, [10, 11, 12, 13, 14])
    np.testing.assert_array_equal(g.get_vector(12), v[2])
    with pytest.raises(KeyError):
        g.get_vector(99)
    with pytest.raises(ValueError, match="scalar_kind"):
        FlatIndex(12, device="cpu", scalar_kind="f16")


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_flat_topk_stashed_matches_jax(metric):
    """flat_topk_stashed against the JAX function on the same inputs
    (scores within the derived bound, ids equal where it separates
    them), and bit for bit against the port's per-block scan, which
    flat_topk routes to it within stash_bytes."""
    rng = np.random.default_rng(5)
    n, d, b, blk = 4096, 32, 24, 1024
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    v[2000:2010] = v[17]  # ties across bins and blocks
    q[0] = v[17]
    valid = np.ones(n, bool)
    valid[::11] = False
    sq = (v * v).sum(1)
    ws, wi = jt.flat_topk_stashed(
        jnp.asarray(q), jnp.asarray(v), 10, JMetric(metric),
        jnp.asarray(sq), jnp.asarray(valid), blk, lax.Precision.HIGHEST)
    args = (torch.from_numpy(q), torch.from_numpy(v), 10, MetricKind(metric))
    t_sq, t_valid = torch.from_numpy(sq), torch.from_numpy(valid)
    gs, gi = tt.flat_topk_stashed(*args, t_sq, t_valid, blk)
    bound = score_bound(q, v, metric)
    assert_scores_within(gs.numpy(), np.asarray(ws), bound, metric)
    assert_same_ids_within_ties(gi.numpy(), np.asarray(wi), np.asarray(ws),
                                2 * bound, metric)
    ps, pi = tt.flat_topk(*args, vec_sq=t_sq, valid=t_valid, block_n=blk)
    np.testing.assert_array_equal(gi.numpy(), pi.numpy())
    np.testing.assert_array_equal(gs.numpy(), ps.numpy())
    # within the budget flat_topk takes the stashed path, with one budget
    # byte too few the per-block one
    calls = []
    real = tt.flat_topk_stashed

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    tt.flat_topk_stashed = spy
    try:
        rs, ri = tt.flat_topk(*args, vec_sq=t_sq, valid=t_valid, block_n=blk,
                              stash_bytes=b * n * 4)
        tt.flat_topk(*args, vec_sq=t_sq, valid=t_valid, block_n=blk,
                     stash_bytes=b * n * 4 - 1)
    finally:
        tt.flat_topk_stashed = real
    assert len(calls) == 1
    np.testing.assert_array_equal(ri.numpy(), pi.numpy())


def test_smallest_k_matches_exact_topk_small():
    """smallest_k stands in for the JAX package's exact_topk_small:
    tests/test_distance.py's adversarial rows (duplicates in one bin,
    constants, the best all in one bin, one best per bin) give the same
    scores, and positions that point at them, distinct per row."""
    from duckdb_vss_tpu.ops.topk import exact_topk_small

    rng = np.random.default_rng(42)
    for b, n, k in ((64, 1024, 10), (16, 128, 5), (8, 2048, 32)):
        s = rng.normal(size=(b, n)).astype(np.float32)
        s[0] = 1.0
        s[1, :] = np.arange(n)[::-1]
        s[2, 5:15] = -100.0
        if b > 3:
            s[3, ::128] = -50.0
        want_s, want_i = exact_topk_small(jnp.asarray(s), k)
        got_s, got_i = tt.smallest_k(torch.from_numpy(s), k)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        picked = np.take_along_axis(s, got_i.numpy(), axis=1)
        np.testing.assert_array_equal(picked, got_s.numpy())
        assert all(len(set(r)) == k for r in got_i.tolist())
