"""Port parity: the augmented traversal table (graph.aug_width,
make_aug_table, make_aug_queries, the aug branch of beam_search and
search_graph, HNSWIndex(use_aug=True)) against the JAX package.

Tolerances:
- tables and query rows bit for bit. One exception, stated: cosine
  scales each row by rsqrt(|v|^2), and XLA's CPU rsqrt is an
  approximation that differs from torch's in the last f32 bit for about
  a third of inputs (and from a correctly rounded 1/sqrt as often). A
  one-bit difference before the bf16 rounding changes that rounding
  only for values within a bit of a halfway point: there the tables
  may differ by one bf16 ulp, in at most 1e-3 of the elements; the
  cosine query rows (f32) within 2 ulps (rtol 2.4e-7);
- the beam over one carried-across graph and the same tables: identical
  ids and distance counts, scores within 1e-5 (bf16 products summed in
  f32 in another order), as tests/test_torch_beam.py holds the other
  branches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_vss_tpu.models import graph as jgraph
from duckdb_vss_tpu.models.hnsw import HNSWIndex as JHNSW
from duckdb_vss_tpu.utils.config import HNSWConfig as JConfig
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch.models import graph as tgraph
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.convert import host_array, index_from_arrays
from test_torch_beam import _clustered, _seeds, jax_index_arrays

torch.set_num_threads(2)

N, D, NQ = 4000, 32, 40
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
METRICS = ["l2sq", "ip", "cosine"]


@pytest.fixture(scope="module")
def pair():
    """One JAX bulk-built l2sq index and the port's copy, flat layout,
    with the augmented table on both sides, and padded queries."""
    v, q = _clustered(41, N, NQ)
    jidx = JHNSW(D, JConfig(), capacity=N)
    jidx.layout, jidx.use_aug = "flat", True
    jidx.add(v, np.arange(N, dtype=np.int64))
    tidx = index_from_arrays(jax_index_arrays(jidx), HNSWConfig(),
                             device="cpu", layout="flat", use_aug=True)
    qp = tidx.store.prepare_queries(q)
    return jidx, tidx, v, q, qp, jnp.asarray(qp.numpy())


def _table_inputs(seed, n=700, d=24):
    rng = np.random.default_rng(seed)
    v = np.zeros((n, 128), np.float32)
    v[:, :d] = rng.normal(size=(n, d)) * 2.0
    v[[4, 9]] = 0.0  # zero rows: cosine's zero-norm case
    q = np.zeros((33, 128), np.float32)
    q[:, :d] = rng.normal(size=(33, d))
    q[2] = 0.0
    return v, (v * v).sum(1), q, (q * q).sum(1)


@pytest.mark.parametrize("metric", METRICS)
def test_aug_table_and_queries_bitwise(metric):
    v, sq, q, q_sq = _table_inputs(1)
    jm, tm = JMetric(metric), MetricKind(metric)
    want = np.asarray(jgraph.make_aug_table(jnp.asarray(v), jnp.asarray(sq),
                                            jm)).view(np.uint16)
    got = host_array(tgraph.make_aug_table(torch.from_numpy(v),
                                           torch.from_numpy(sq), tm))
    assert got.shape == want.shape == (700, tgraph.aug_width(128, tm))
    assert tgraph.aug_width(128, tm) == jgraph.aug_width(128, jm)
    if metric == "cosine":
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (
            f"cosine table: {(diff > 0).sum()} elements differ, by up to "
            f"{diff.max()} bf16 ulps")
    else:
        np.testing.assert_array_equal(got, want, err_msg=metric)
    d_aug = got.shape[1]
    wq, wb = jgraph.make_aug_queries(jnp.asarray(q), jnp.asarray(q_sq), jm,
                                     d_aug)
    tq, tb = tgraph.make_aug_queries(torch.from_numpy(q),
                                     torch.from_numpy(q_sq), tm, d_aug)
    assert tuple(tq.shape) == np.asarray(wq).shape
    np.testing.assert_array_equal(tb.numpy(), np.asarray(wb), err_msg=metric)
    if metric == "cosine":
        np.testing.assert_allclose(tq.numpy(), np.asarray(wq), rtol=2.4e-7,
                                   atol=0)
    else:
        np.testing.assert_array_equal(tq.numpy(), np.asarray(wq),
                                      err_msg=metric)


def test_bf16_store_aug_table_bitwise():
    """From a bf16 store (the JAX package's -2.0 * v stays bf16: exact)."""
    v, sq, _, _ = _table_inputs(2)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    sq_b = (vb.float() ** 2).sum(1)
    want = np.asarray(jgraph.make_aug_table(
        jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(sq_b.numpy()),
        JMetric.L2SQ)).view(np.uint16)
    got = host_array(tgraph.make_aug_table(vb, sq_b, MetricKind.L2SQ))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("expand", [1, 4])
def test_aug_beam_matches_jax(pair, expand):
    """beam_search over the augmented table (no K2, as in the JAX
    package): the JAX package's ids and distance count on its own graph
    and table."""
    jidx, tidx, _v, _q, qp, qj = pair
    jtab = jidx._aug_table()
    ttab = tidx.tables.aug()
    np.testing.assert_array_equal(host_array(ttab),
                                  np.asarray(jtab).view(np.uint16))
    seeds = _seeds(np.random.default_rng(43), NQ, 5, N)
    ef = 32
    jq, jb = jgraph.make_aug_queries(qj, jnp.sum(qj * qj, -1), JMetric.L2SQ,
                                     jtab.shape[1])
    js, ji, jn = jgraph.beam_search(
        jidx.graph, jtab, jidx.store._vec_sq, jq, jb, jnp.asarray(seeds), ef,
        JMetric.L2SQ, level=0, expand=expand, aug=True)
    st = tidx.store
    tq, tb = tgraph.make_aug_queries(qp, (qp * qp).sum(-1), MetricKind.L2SQ,
                                     ttab.shape[1])
    ts, ti, tn = tgraph.beam_search(
        tidx.graph, ttab, st._vec_sq, tq, tb, torch.from_numpy(seeds), ef,
        MetricKind.L2SQ, level=0, expand=expand, aug=True, use_pallas=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tn) == int(jn)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCORE_TOL)


def test_search_with_aug_table_matches_jax(pair):
    """HNSWIndex.search with use_aug and the flat layout, both sides: the
    JAX package's ids, exact distances within 1e-5; without use_aug the
    index builds no table."""
    jidx, tidx, v, q, _qp, _qj = pair
    js, jk = jidx.search(q, 10, ef=48)
    ts, tk = tidx.search(q, 10, ef=48)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(ts, js, **SCORE_TOL)
    d2 = (v * v).sum(1)[None, :] - 2.0 * (q @ v.T)
    want = np.argsort(d2, 1, kind="stable")[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(tk.tolist(), want.tolist())])
    assert recall >= 0.9, recall
    tidx.use_aug = False
    tidx.tables.drop("aug")
    try:
        tidx.search(q[:4], 10)
        assert "aug" not in tidx.tables.built
    finally:
        tidx.use_aug = True
