"""Port parity: the step-by-step beam search and what rides on it
(models/graph.py) against the JAX package, on one graph that the JAX
package built and utils/convert.py carried across.

- beam_search at the base layer and an upper level, expand 1 and 4,
  with inactive rows and repeated seeds, f32 tables: identical ids and
  distance counts, scores within 1e-5 (f32 sums in another order);
- the int8-tile branch with the JAX package's own tables: the same;
- reading ``done`` every step, every 4 steps or never gives one beam;
- HNSWIndex.search through the step-by-step beam (ef 160, hop rerank,
  beam descent, flat layout) returns the JAX package's ids;
- update_neighborhood_rows equals the JAX function bit for bit.

The JAX functions run under jit where the JAX package runs them so
(XLA computes the int8 scales' ``absmax / 127`` as a product there).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_vss_tpu.models import graph as jgraph
from duckdb_vss_tpu.models.hnsw import HNSWIndex as JHNSW
from duckdb_vss_tpu.ops.pallas_beam import pack_meta as j_pack_meta
from duckdb_vss_tpu.utils.config import HNSWConfig as JConfig
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch.models import graph as tgraph
from duckdb_vss_tpu_torch.ops import fused_gather as fg
from duckdb_vss_tpu_torch.ops.fused_beam import pack_meta
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.convert import GRAPH_FIELDS, index_from_arrays

torch.set_num_threads(2)

N, D, NQ = 5000, 32, 48
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def _clustered(seed, n, nq, d=D, n_centers=64):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    v = (centers[rng.integers(0, n_centers, n)]
         + 0.25 * rng.normal(size=(n, d))).astype(np.float32)
    q = (centers[rng.integers(0, n_centers, nq)]
         + 0.25 * rng.normal(size=(nq, d))).astype(np.float32)
    return v, q


def jax_index_arrays(jidx):
    arrays = {f: np.asarray(getattr(jidx.store, f))
              for f in ("_vectors", "_vec_sq", "_valid", "_keys")}
    arrays.update({f: np.asarray(getattr(jidx.graph, f))
                   for f in GRAPH_FIELDS})
    arrays["dims"] = jidx.dims
    return arrays


@pytest.fixture(scope="module")
def pair():
    """One JAX bulk-built index and the port's copy of it, flat layout,
    f32 traversal, plus padded queries in both frameworks."""
    v, q = _clustered(21, N, NQ)
    jidx = JHNSW(D, JConfig(), capacity=N, traversal_dtype="f32")
    jidx.layout = "flat"
    jidx.add(v, np.arange(N, dtype=np.int64))
    tidx = index_from_arrays(jax_index_arrays(jidx), HNSWConfig(),
                             device="cpu", layout="flat",
                             traversal_dtype="f32")
    qp = tidx.store.prepare_queries(q)
    return jidx, tidx, q, qp, jnp.asarray(qp.numpy())


def _seeds(rng, b, p, n):
    seeds = rng.integers(0, n, size=(b, p)).astype(np.int32)
    seeds[:, 1] = seeds[:, 0]  # a repeated seed
    seeds[3, 2:] = -1
    return seeds


@pytest.mark.parametrize("level,expand", [(0, 1), (0, 4), (1, 1), (1, 4)])
def test_beam_search_matches_jax(pair, level, expand):
    jidx, tidx, _q, qp, qj = pair
    rng = np.random.default_rng(30 + level)
    if level == 0:
        seeds = _seeds(rng, NQ, 5, N)
    else:  # seeds among the nodes that exist at the level
        upper = np.nonzero(np.asarray(jidx.graph.levels) >= level)[0]
        assert len(upper) > 50
        seeds = upper[_seeds(rng, NQ, 5, len(upper))].astype(np.int32)
        seeds[3, 2:] = -1
    active = np.ones(NQ, bool)
    active[[5, 17]] = False
    ef = 32
    js, ji, jn = jgraph.beam_search(
        jidx.graph, jidx.store._vectors, jidx.store._vec_sq, qj,
        jnp.sum(qj * qj, -1), jnp.asarray(seeds), ef, JMetric.L2SQ,
        level=level, expand=expand, active=jnp.asarray(active))
    st = tidx.store
    ts, ti, tn = tgraph.beam_search(
        tidx.graph, st._vectors, st._vec_sq, qp, (qp * qp).sum(-1),
        torch.from_numpy(seeds), ef, MetricKind.L2SQ, level=level,
        expand=expand, active=torch.from_numpy(active))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tn) == int(jn)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCORE_TOL)
    assert (ti.numpy()[[5, 17]] == -1).all()  # inactive rows stay empty


def test_beam_search_int8_tiles_match_jax(pair):
    """The neighborhood-tile branch, both sides on the JAX tables."""
    jidx, tidx, _q, qp, qj = pair
    jv, jsc, jsq = jgraph.make_neighborhood_tables(
        jidx.store._vectors, jidx.store._vec_sq, jidx.graph.neighbors0)
    seeds = _seeds(np.random.default_rng(33), NQ, 6, N)
    ef, expand = 48, 4
    jbeam = jax.jit(functools.partial(
        jgraph.beam_search, ef=ef, metric=JMetric.L2SQ, level=0,
        expand=expand))
    js, ji, jn = jbeam(jidx.graph, jidx.store._vectors, jidx.store._vec_sq,
                       qj, jnp.sum(qj * qj, -1), jnp.asarray(seeds),
                       nbr_vecs=jv, nbr_scale=jsc, nbr_sq=jsq)
    st = tidx.store
    tabs = [torch.from_numpy(np.asarray(a).copy()) for a in (jv, jsc, jsq)]
    ts, ti, tn = tgraph.beam_search(
        tidx.graph, st._vectors, st._vec_sq, qp, (qp * qp).sum(-1),
        torch.from_numpy(seeds), ef, MetricKind.L2SQ, level=0, expand=expand,
        nbr_vecs=tabs[0], nbr_scale=tabs[1], nbr_sq=tabs[2])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tn) == int(jn)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCORE_TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fixed_trip_count_equals_early_exit(pair, use_pallas):
    """A step after ``done`` changes nothing: the exit is read every
    step, every 4 steps, or never, and the beam and the distance count
    are the same. With use_pallas the scoring goes through kernel K2's
    wrapper, once per step taken."""
    _jidx, tidx, _q, qp, _qj = pair
    st = tidx.store
    seeds = torch.from_numpy(_seeds(np.random.default_rng(34), NQ, 4, N))
    outs, steps = [], []
    for sync_every in (1, 4, 0):
        tgraph.beam_search.steps = 0
        calls = fg.gather_scores_plain.calls
        outs.append(tgraph.beam_search(
            tidx.graph, st._vectors, st._vec_sq, qp, (qp * qp).sum(-1), seeds,
            32, MetricKind.L2SQ, expand=4, use_pallas=use_pallas,
            sync_every=sync_every))
        steps.append(tgraph.beam_search.steps)
        if use_pallas:  # CPU tensors: the wrapper ran the plain version
            assert fg.gather_scores_plain.calls - calls == steps[-1]
    assert steps[0] <= steps[1] <= steps[0] + 3 and steps[1] % 4 == 0
    assert steps[2] == 3 * 32 // 4 + 8 > steps[0]  # the max_steps default
    for s, i, n in outs[1:]:
        np.testing.assert_array_equal(i.numpy(), outs[0][1].numpy())
        np.testing.assert_array_equal(s.numpy(), outs[0][0].numpy())
        assert int(n) == int(outs[0][2])


def test_use_pallas_needs_an_f32_table(pair):
    _jidx, tidx, _q, qp, _qj = pair
    st = tidx.store
    with pytest.raises(ValueError, match="traversal_dtype='f32'"):
        tgraph.beam_search(
            tidx.graph, st._vectors.to(torch.bfloat16), st._vec_sq, qp,
            (qp * qp).sum(-1), torch.zeros((NQ, 1), dtype=torch.int32), 16,
            MetricKind.L2SQ, use_pallas=True)


@pytest.mark.parametrize("case", ["ef160", "hop4", "beam-descent",
                                  "hop4-tiles", "pallas"])
def test_search_step_beam_matches_jax(pair, case):
    """HNSWIndex.search off the fused kernel's path: same ids as the JAX
    package, scores within 1e-5."""
    jidx, tidx, q, _qp, _qj = pair
    kw = dict(ef=160) if case == "ef160" else dict(ef=64)
    if case.startswith("hop4"):
        kw["hop_rerank"] = 4
    jidx.descent = tidx.descent = "beam" if case == "beam-descent" else "mxu"
    layout = "neighborhood" if case == "hop4-tiles" else "flat"
    jidx.layout = tidx.layout = layout
    # the JAX package cannot reach its gather kernel on the CPU (no
    # interpret flag on that call), so its side scores by plain gathers
    tidx.use_pallas = case == "pallas"
    # off the fused kernel on both sides: this test is the step beam's
    jidx.use_pallas_beam = tidx.use_pallas_beam = False
    calls = fg.gather_scores_plain.calls
    try:
        js, jk = jidx.search(q, 10, **kw)
        ts, tk = tidx.search(q, 10, **kw)
    finally:
        jidx.descent = tidx.descent = "mxu"
        jidx.layout = tidx.layout = "flat"
        tidx.use_pallas = False
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(ts, js, **SCORE_TOL)
    assert (fg.gather_scores_plain.calls > calls) == (case == "pallas")


def test_update_neighborhood_rows_bitwise(pair):
    jidx, tidx, _q, _qp, _qj = pair
    rng = np.random.default_rng(35)
    nb0 = np.asarray(jidx.graph.neighbors0).copy()
    jv, jsc, jsq = jgraph.make_neighborhood_tables(
        jidx.store._vectors, jidx.store._vec_sq, jnp.asarray(nb0))
    jm = jax.jit(j_pack_meta)(jnp.asarray(nb0), jsc, jsq)
    tabs = [torch.from_numpy(np.asarray(a).copy()) for a in (jv, jsc, jsq, jm)]
    # an insert batch's footprint: new rows and their forward targets change
    new_slots = rng.choice(N, size=24, replace=False).astype(np.int32)
    for s in new_slots:
        nb0[s] = rng.integers(0, N, nb0.shape[1])
        nb0[s, -3:] = -1
        for t in nb0[s, :4]:
            nb0[t, rng.integers(0, nb0.shape[1])] = s
    new_slots[[2, 9]] = -1  # inactive pad rows (their edits stay unseen)
    new_slots[5] = new_slots[6]  # a duplicate
    jout = jgraph.update_neighborhood_rows(
        jv, jsc, jsq, jm, jidx.store._vectors, jidx.store._vec_sq,
        jnp.asarray(nb0), jnp.asarray(new_slots))
    st = tidx.store
    tout = tgraph.update_neighborhood_rows(
        *tabs, st._vectors, st._vec_sq, torch.from_numpy(nb0),
        torch.from_numpy(new_slots))
    for got, want in zip(tout, jout):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tout[0] is tabs[0]  # updated in place
    # and the refreshed rows' meta is pack_meta of the refreshed tables
    live = new_slots[new_slots >= 0]
    rows = np.unique(np.concatenate([live, nb0[live].ravel()]))
    rows = rows[rows >= 0]
    np.testing.assert_array_equal(
        tout[3].numpy()[rows],
        pack_meta(torch.from_numpy(nb0), tout[1], tout[2]).numpy()[rows])
