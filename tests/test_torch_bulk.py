"""Port parity: bulk_build and its pieces against the JAX package.

The same store, slots and sampled levels go through both packages'
bulk_build, with phase 1 forced exact or IVF (the JAX package through
DVT_BUILD_KNN, the port through ``knn=``). The hierarchy is host-derived
from the levels, so it must be identical; the base-layer lists come
from float scores summed in different orders, so they are compared as
sets (mean per-row Jaccard >= 0.9)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_vss_tpu.models import build as jbuild
from duckdb_vss_tpu.models import bulk as jbulk
from duckdb_vss_tpu.utils.config import HNSWConfig as JConfig
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch.models import build as tbuild
from duckdb_vss_tpu_torch.models import bulk as tbulk
from duckdb_vss_tpu_torch.models.graph import sample_levels
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.padding import (pad_2d_np, pad_dim,
                                                 round_up_capacity)

torch.set_num_threads(2)


def _store(seed, n, d, n_centers=64):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    v = (centers[rng.integers(0, n_centers, n)]
         + 0.25 * rng.normal(size=(n, d))).astype(np.float32)
    cap = round_up_capacity(n)
    store = pad_2d_np(v, cap, pad_dim(d))
    # the sampler both HNSWIndex classes use, on one generator
    levels = sample_levels(HNSWIndex(d, device="cpu")._level_rng, n,
                           HNSWConfig().m)
    return v, store, (store * store).sum(1).astype(np.float32), levels


def _jaccard(a, b):
    out = []
    for ra, rb in zip(a.tolist(), b.tolist()):
        sa, sb = {x for x in ra if x >= 0}, {x for x in rb if x >= 0}
        out.append(len(sa & sb) / max(1, len(sa | sb)))
    return float(np.mean(out))


@pytest.mark.parametrize("knn,n,metric", [("exact", 8192, "l2sq"),
                                          ("ivf", 12000, "l2sq"),
                                          ("ivf", 8192, "cosine")])
def test_bulk_build_matches_jax(monkeypatch, knn, n, metric):
    d = 32
    v, store, sq, levels = _store(11, n, d)
    slots = np.arange(n, dtype=np.int32)
    monkeypatch.setenv("DVT_BUILD_KNN", knn)
    jstats, tstats = {}, {}
    jg = jbulk.bulk_build(jnp.asarray(store), jnp.asarray(sq), slots, levels,
                          JConfig(metric=JMetric(metric)), JMetric(metric),
                          host_vectors=v, stats_out=jstats)
    tg = tbulk.bulk_build(torch.from_numpy(store), torch.from_numpy(sq),
                          slots, levels, HNSWConfig(metric=MetricKind(metric)),
                          MetricKind(metric), host_vectors=v,
                          stats_out=tstats, knn=knn)
    for f in ("levels", "upper_slot", "upper_node", "entry_node",
              "max_level", "upper_count"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    assert tstats["n_distances"] == jstats["n_distances"]
    jn0, tn0 = np.asarray(jg.neighbors0)[:n], tg.neighbors0.numpy()[:n]
    assert _jaccard(tn0, jn0) >= 0.9, _jaccard(tn0, jn0)
    # every live node keeps edges, none to itself or out of range
    assert ((tn0 >= 0).sum(1) > 0).all()
    assert not (tn0 == np.arange(n)[:, None]).any() and tn0.max() < n
    # level-1 lists of the upper table agree as sets too
    m = 16
    ju, tu = np.asarray(jg.upper_neighbors), tg.upper_neighbors.numpy()
    n_up = int(tg.upper_count)
    assert _jaccard(tu[:n_up, :m], ju[:n_up, :m]) >= 0.9
    assert set(tstats["phase_s"]) >= {"phase0_upper_levels",
                                      "phase1_knn_sweep", "phase2_prune",
                                      "phase2.5_repair"}


def test_upper_level_ivf_path_matches_jax(monkeypatch):
    """Level 1 routed through the IVF sweep (_upper_level_from_knn), as it
    is at 1M rows, forced here by lowering the level threshold."""
    d, n = 32, 8192
    v, store, sq, levels = _store(5, n, d)
    slots = np.arange(n, dtype=np.int32)
    monkeypatch.setattr(jbulk, "IVF_LEVEL_MIN_N", 128)
    monkeypatch.setattr(tbulk, "IVF_LEVEL_MIN_N", 128)
    monkeypatch.setenv("DVT_BUILD_KNN", "exact")
    jg = jbulk.bulk_build(jnp.asarray(store), jnp.asarray(sq), slots, levels,
                          JConfig(), JMetric.L2SQ, host_vectors=v)
    tg = tbulk.bulk_build(torch.from_numpy(store), torch.from_numpy(sq),
                          slots, levels, HNSWConfig(), MetricKind.L2SQ,
                          host_vectors=v, knn="exact")
    n_up = int(tg.upper_count)
    assert n_up >= 128
    ju, tu = np.asarray(jg.upper_neighbors), tg.upper_neighbors.numpy()
    assert _jaccard(tu[:n_up, :16], ju[:n_up, :16]) >= 0.9


def test_group_ranks_and_reverse_candidates_match_jax():
    rng = np.random.default_rng(2)
    n, k, rev_r = 3000, 8, 4
    ids = rng.integers(-1, n, (n, k)).astype(np.int32)
    sc = rng.integers(0, 50, (n, k)).astype(np.float32)  # many ties
    tgt, dist = ids.reshape(-1), sc.reshape(-1)
    np.testing.assert_array_equal(
        tbuild._group_ranks(torch.from_numpy(tgt), torch.from_numpy(dist)
                            ).numpy(),
        np.asarray(jbuild._group_ranks(jnp.asarray(tgt), jnp.asarray(dist))))
    np.testing.assert_array_equal(
        tbulk._reverse_candidates(torch.from_numpy(ids), torch.from_numpy(sc),
                                  rev_r).numpy(),
        np.asarray(jbulk._reverse_candidates(jnp.asarray(ids),
                                             jnp.asarray(sc), rev_r)))


@pytest.mark.parametrize("n_cols", [8, 3])
def test_reverse_chunked_matches_single(monkeypatch, n_cols):
    rng = np.random.default_rng(42)
    cap, n_live, k, rev_r = 32768, 20000, 8, 4
    ids = np.full((cap, k), -1, np.int32)
    ids[:n_live] = rng.integers(-1, cap, (n_live, k))
    # distinct distances keep the chunked merge order equal to the sort
    sc = np.full((cap, k), np.float32(3.0e38), np.float32)
    sc[:n_live] = np.sort(rng.permutation(n_live * k).reshape(n_live, k)
                          .astype(np.float32) * 1e-3 + 0.5, 1)
    ref = tbulk._reverse_candidates(torch.from_numpy(ids[:, :n_cols]),
                                    torch.from_numpy(sc[:, :n_cols]), rev_r)
    monkeypatch.setattr(tbulk, "REV_EDGE_CHUNK", 1024)
    got = tbulk._reverse_candidates_chunked(torch.from_numpy(ids),
                                            torch.from_numpy(sc), rev_r,
                                            n_cols)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_select_diverse_matches_jax(metric):
    rng = np.random.default_rng(8)
    n, d, b, c = 500, 16, 64, 40
    v = rng.normal(size=(n, d)).astype(np.float32)
    vsq = (v * v).sum(1).astype(np.float32)
    ids = np.stack([rng.permutation(n)[:c] for _ in range(b)]).astype(np.int32)
    ids[:, -5:] = -1
    q = rng.normal(size=(b, d)).astype(np.float32)
    from duckdb_vss_tpu.ops.distance import score_matrix
    s_all = np.asarray(score_matrix(jnp.asarray(q), jnp.asarray(v),
                                    JMetric(metric)))
    sc = np.take_along_axis(s_all, np.maximum(ids, 0), 1)
    sc[ids < 0] = np.float32(3.0e38)
    order = np.argsort(sc, 1, kind="stable")
    ids, sc = (np.take_along_axis(ids, order, 1),
               np.take_along_axis(sc, order, 1))
    for backfill in (False, True):
        want = np.asarray(jbuild.select_diverse(
            jnp.asarray(v), jnp.asarray(vsq), jnp.asarray(ids),
            jnp.asarray(sc), 12, JMetric(metric), backfill=backfill))
        got = tbuild.select_diverse(
            torch.from_numpy(v), torch.from_numpy(vsq), torch.from_numpy(ids),
            torch.from_numpy(sc), 12, MetricKind(metric),
            backfill=backfill).numpy()
        np.testing.assert_array_equal(got, want)


def test_component_repair_connects_islands():
    """Two far-apart clusters with no edges between them: the repair adds
    a bridge so every live node is reachable from the entry point."""
    n, m0 = 400, 8
    rng = np.random.default_rng(4)
    v = np.concatenate([rng.normal(size=(200, 8)),
                        100 + rng.normal(size=(200, 8))]).astype(np.float32)
    nb = np.full((n, m0), -1, np.int32)
    for i in range(n):
        base = 0 if i < 200 else 200
        nb[i, :4] = base + (i - base + 1 + np.arange(4)) % 200
    nb_t = torch.from_numpy(nb.copy())
    valid = torch.ones(n, dtype=torch.bool)
    labels = tbulk._component_labels(nb_t, valid).numpy()
    assert set(labels.tolist()) == {0, 200}
    assert tbulk._bridge_components(nb_t, labels, v,
                                    np.arange(n, dtype=np.int32)) == 1
    labels = tbulk._component_labels(nb_t, valid).numpy()
    assert set(labels.tolist()) == {0}
