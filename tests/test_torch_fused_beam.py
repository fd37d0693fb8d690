"""Port parity: the neighborhood layout and the fused beam search.

- make_neighborhood_tables + pack_meta equal the JAX package's bit for
  bit on the same store and graph;
- the plain PyTorch version of kernel K1 (what the wrapper runs on CPU
  tensors) tracks the Pallas kernel in interpret mode on the same
  tables, at the shapes of tests/test_pallas_beam.py. The tolerances
  are that test's (id-set overlap >= 0.95, scores within 3e-3 where the
  ids agree), for the same reason: the bf16 rounding of the products
  may be kept or dropped by XLA's fusion on the JAX side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_vss_tpu.models.graph import (
    make_neighborhood_tables as j_tables,
    quantize_queries_i8 as j_quant,
)
from duckdb_vss_tpu.ops.pallas_beam import (TB, beam_search_pallas,
                                            pack_meta as j_pack)
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch.models.graph import (make_neighborhood_tables,
                                               quantize_queries_i8)
from duckdb_vss_tpu_torch.ops import fused_beam as fb
from duckdb_vss_tpu_torch.utils.config import MetricKind

torch.set_num_threads(2)


def _graph(seed, n=2048, d=128, m0=32):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs[11] = 0.0  # an all-zero row: scale 1, all-zero int8 tile row
    vec_sq = (vecs * vecs).sum(1).astype(np.float32)
    nbr = rng.integers(0, n, (n, m0)).astype(np.int32)
    nbr[rng.random((n, m0)) < 0.1] = -1
    nbr[:4, 3] = 11
    return rng, vecs, vec_sq, nbr


def test_neighborhood_tables_and_meta_bitwise():
    _, vecs, vec_sq, nbr = _graph(0)
    jv, js, jq = j_tables(jnp.asarray(vecs), jnp.asarray(vec_sq),
                          jnp.asarray(nbr), chunk=512)
    jm = j_pack(jnp.asarray(nbr), js, jq)
    tv, ts, tq = make_neighborhood_tables(
        torch.from_numpy(vecs), torch.from_numpy(vec_sq),
        torch.from_numpy(nbr), chunk=300)
    tm = fb.pack_meta(torch.from_numpy(nbr), ts, tq)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.shape == (2048, 128) and (tm[:, 96:] == -1).all()


def test_quantize_queries_bitwise():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(20, 128)).astype(np.float32)
    q[2] = 0.0
    # under jit, as the JAX package always runs it (inside its search and
    # insert programs): XLA then computes absmax / 127 as absmax *
    # f32(1/127), one ulp off the eager division for some rows
    j8, js = jax.jit(j_quant)(jnp.asarray(q))
    t8, ts = quantize_queries_i8(torch.from_numpy(q))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("metric,ef", [("l2sq", 16), ("ip", 16),
                                       ("l2sq", 64)])
def test_plain_beam_matches_pallas_interpret(metric, ef):
    rng, vecs, vec_sq, nbr = _graph(3)
    n, d = vecs.shape
    m0, expand, steps, b = nbr.shape[1], 4, 6, TB
    tv, ts, tq = make_neighborhood_tables(
        torch.from_numpy(vecs), torch.from_numpy(vec_sq),
        torch.from_numpy(nbr))
    meta = fb.pack_meta(torch.from_numpy(nbr), ts, tq)
    q = rng.normal(size=(b, d)).astype(np.float32)
    q_sq = (q * q).sum(1).astype(np.float32)
    seeds = rng.integers(0, n, (b, ef)).astype(np.int32)
    seed_s = np.sort(np.abs(rng.normal(size=(b, ef))).astype(np.float32), 1)

    want_s, want_i, want_nd = beam_search_pallas(
        jnp.asarray(q), jnp.asarray(q_sq), jnp.asarray(seed_s),
        jnp.asarray(seeds), jnp.asarray(meta.numpy()),
        jnp.asarray(tv.numpy()), ef=ef, expand=expand, m0=m0, d=d,
        max_steps=steps, metric=JMetric(metric), interpret=True)
    calls = fb.beam_search_plain.calls
    launches = fb.fused_beam_search.launches
    got_s, got_i, got_nd, got_exp = fb.fused_beam_search(
        torch.from_numpy(q), torch.from_numpy(q_sq),
        torch.from_numpy(seed_s), torch.from_numpy(seeds), meta, tv,
        ef=ef, expand=expand, m0=m0, d=d, max_steps=steps,
        metric=MetricKind(metric))
    # CPU tensors take the plain version; no kernel launch is counted
    assert fb.beam_search_plain.calls == calls + 1
    assert fb.fused_beam_search.launches == launches

    got_i, want_i = got_i.numpy(), np.asarray(want_i)
    got_s, want_s = got_s.numpy(), np.asarray(want_s)
    overlap = np.mean([len(set(got_i[i]) & set(want_i[i])) / ef
                       for i in range(b)])
    assert overlap >= 0.95, overlap
    same = got_i == want_i
    np.testing.assert_allclose(got_s[same], want_s[same], rtol=3e-3,
                               atol=3e-3)
    assert int(got_nd) > 0 and abs(int(got_nd) - int(want_nd)) <= 0.05 * int(
        want_nd)
    # every step expands E live entries while the beam has unexpanded ones
    assert 0 < int(got_exp) <= b * steps * expand


def test_plain_beam_cosine_zero_norms_and_dead_beams():
    """Cosine epilogue with zero-norm queries and rows, and queries whose
    seed beam is empty (no live selection: nothing is read or kept)."""
    rng, vecs, vec_sq, nbr = _graph(5, n=512)
    tv, ts, tq = make_neighborhood_tables(
        torch.from_numpy(vecs), torch.from_numpy(vec_sq),
        torch.from_numpy(nbr))
    meta = fb.pack_meta(torch.from_numpy(nbr), ts, tq)
    b, ef = 8, 16
    q = rng.normal(size=(b, 128)).astype(np.float32)
    q[1] = 0.0
    q_sq = (q * q).sum(1).astype(np.float32)
    seeds = rng.integers(0, 512, (b, ef)).astype(np.int32)
    seed_s = np.sort(np.abs(rng.normal(size=(b, ef))).astype(np.float32), 1)
    seeds[7] = -1
    seed_s[7] = fb.INF_SCORE
    s, i, nd, n_exp = fb.beam_search_plain(
        torch.from_numpy(q), torch.from_numpy(q_sq), torch.from_numpy(seed_s),
        torch.from_numpy(seeds), meta, tv, ef=ef, expand=4, m0=32, d=128,
        max_steps=5, metric=MetricKind.COSINE)
    s, i = s.numpy(), i.numpy()
    assert (i[7] == -1).all() and (s[7] >= fb.INF_SCORE).all()
    # a zero query scores exactly 1 against every nonzero row
    assert np.all(s[1][i[1] >= 0] <= 1.0)
    assert np.all(np.diff(s, axis=1) >= 0)  # beams stay ascending
    for row in i:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)  # no repeats
    assert int(nd) > 0 and int(n_exp) <= 7 * 5 * 4


def test_kernel_shape_checks():
    """The wrapper raises, never clamps, for shapes the kernel cannot
    take: shared memory over a Hopper block's 227 KB, or D not a
    multiple of 16."""
    fb.check_kernel_shapes(64, 4, 32, 128)  # the defaults fit
    fb.check_kernel_shapes(128, 8, 32, 128)
    assert fb.smem_bytes(64, 4, 32, 128) < 48 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        fb.check_kernel_shapes(128, 8, 32, 1024)
    with pytest.raises(ValueError, match="multiple of 16"):
        fb.check_kernel_shapes(64, 4, 32, 120)
    with pytest.raises(ValueError):
        fb.check_kernel_shapes(4, 8, 32, 128)
