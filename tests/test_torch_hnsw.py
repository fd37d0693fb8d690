"""The port's HNSWIndex as a whole: bulk build, fused-beam search, and
the calls that leave the fused path.

(a) a JAX-built index (fused layout) carried across with
    index_from_arrays: the port reaches the JAX package's recall on the
    same graph and queries, with the same exact distances;
(b) a port-built index end to end reaches the JAX package's recall bar;
(c) tombstoned keys are never returned;
(d) the entry points default to CUDA and raise without a card;
(e) incremental add, ef > 128, expand > 8, hop_rerank and a layout over
    the memory budget work and agree with the JAX package; bad settings
    raise ValueError;
(f) (gpu) the kernel check of chip_smoke.py on the card.
"""

import jax
import numpy as np
import pytest
import torch

from duckdb_vss_tpu.models import graph as jgraph
from duckdb_vss_tpu.models.hnsw import HNSWIndex as JHNSW
from duckdb_vss_tpu.ops.pallas_beam import pack_meta as j_pack_meta
from duckdb_vss_tpu.utils.config import HNSWConfig as JConfig
from duckdb_vss_tpu_torch.models import graph as tgraph
from duckdb_vss_tpu_torch.models.flat import FlatIndex
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.ops import fused_beam as fb
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.convert import (GRAPH_FIELDS,
                                                index_from_arrays,
                                                index_to_arrays)

torch.set_num_threads(2)


def _clustered(seed, n, d=32, nq=64, n_centers=64):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    v = (centers[rng.integers(0, n_centers, n)]
         + 0.25 * rng.normal(size=(n, d))).astype(np.float32)
    q = (centers[rng.integers(0, n_centers, nq)]
         + 0.25 * rng.normal(size=(nq, d))).astype(np.float32)
    return v, q


def _truth(v, q, k=10):
    d2 = (v * v).sum(1)[None, :] - 2.0 * (q @ v.T)
    return np.argsort(d2, 1, kind="stable")[:, :k]


def recall_at_k(got, want):
    return float(np.mean([len(set(g) & set(w)) / want.shape[1]
                          for g, w in zip(got.tolist(), want.tolist())]))


@pytest.fixture(scope="module")
def port_index():
    v, q = _clustered(1, 6000)
    idx = HNSWIndex(32, HNSWConfig(), capacity=6000, device="cpu")
    idx.add(v, np.arange(6000) + 100)
    return idx, v, q


@pytest.fixture(scope="module")
def jax_built():
    """A JAX bulk-built index (fused layout, as on the chip), its state
    as numpy arrays, and its data."""
    v, q = _clustered(2, 5000)
    keys = np.arange(5000, dtype=np.int64) * 2
    jidx = JHNSW(32, JConfig(), capacity=5000)
    jidx.layout = "neighborhood"
    jidx.add(v, keys)
    arrays = {f: np.asarray(getattr(jidx.store, f))
              for f in ("_vectors", "_vec_sq", "_valid", "_keys")}
    arrays.update({f: np.asarray(getattr(jidx.graph, f))
                   for f in GRAPH_FIELDS})
    arrays["dims"] = 32
    return jidx, arrays, v, q, keys


def test_jax_graph_carried_across(jax_built):
    """(a) The port searches the JAX package's own bulk-built graph."""
    jidx, arrays, v, q, keys = jax_built
    tidx = index_from_arrays(arrays, HNSWConfig(), device="cpu")
    assert len(tidx) == 5000 and tidx.store._key_to_slot[10] == 5

    js, jk = jidx.search(q, 10, ef=64)
    ts, tk = tidx.search(q, 10, ef=64)
    want = keys[_truth(v, q)]
    r_jax, r_port = recall_at_k(jk, want), recall_at_k(tk, want)
    assert r_port >= r_jax - 0.01, (r_jax, r_port)
    both = jk == tk
    assert both.mean() > 0.9
    np.testing.assert_allclose(ts[both], js[both], rtol=1e-5, atol=1e-6)

    # the port's own layout of that graph is the JAX package's, bit for bit
    jv, jsc, jsq = jgraph.make_neighborhood_tables(
        jidx.store._vectors, jidx.store._vec_sq, jidx.graph.neighbors0)
    jmeta = jax.jit(j_pack_meta)(jidx.graph.neighbors0, jsc, jsq)
    tv, tsc, tsq, tmeta = tidx.tables.neighborhood(tidx.layout,
                                                   tidx.nbr_budget_bytes)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tmeta.numpy(), np.asarray(jmeta))

    # and the state round-trips
    back = index_to_arrays(tidx)
    for f in GRAPH_FIELDS + ("_vectors", "_keys"):
        np.testing.assert_array_equal(back[f], arrays[f], err_msg=f)


def test_port_built_index_recall(port_index):
    """(b) End to end on the port: bulk build, then fused search."""
    idx, v, q = port_index
    want = _truth(v, q) + 100
    calls = fb.beam_search_plain.calls
    scores, got = idx.search(q, 10, ef=64)
    assert fb.beam_search_plain.calls == calls + 1  # one chunk, CPU tensors
    assert recall_at_k(got, want) >= 0.90
    exact = ((q[:, None, :] - v[got - 100]) ** 2).sum(-1)
    np.testing.assert_allclose(scores, exact, rtol=1e-4, atol=1e-4)
    assert idx.search_distance_count > 0 and idx.build_distance_count > 0
    # query chunking gives the same answers
    _, got2 = idx.search(q, 10, ef=64, chunk=24)
    np.testing.assert_array_equal(got2, got)
    # the graph is coherent: entry at max level, no self edges
    levels = idx.graph.levels.numpy()
    assert levels[int(idx.graph.entry_node)] == int(idx.graph.max_level)
    nb0 = idx.graph.neighbors0.numpy()[:6000]
    assert not (nb0 == np.arange(6000)[:, None]).any()


def test_search_ties_go_to_higher_slot():
    """_finish_search: equal exact distances resolve to the higher slot."""
    b, ef = 2, 16
    vecs = torch.zeros((40, 128))
    vecs[:, 0] = torch.arange(40, dtype=torch.float32) % 4  # 4-way ties
    vec_sq = (vecs * vecs).sum(1)
    ids = torch.arange(ef, dtype=torch.int32).repeat(b, 1) * 2
    scores = torch.zeros((b, ef))
    q = torch.zeros((b, 128))
    s, i = tgraph._finish_search(vecs, vec_sq, torch.ones(40, dtype=bool),
                                 q, (q * q).sum(1), MetricKind.L2SQ, 6,
                                 scores, ids)
    assert i[0].tolist() == [28, 24, 20, 16, 12, 8]
    assert s[0].tolist() == [0.0] * 6


def test_tombstones_never_returned():
    """(c) Removed keys are filtered from the results."""
    v, q = _clustered(3, 5000)
    idx = HNSWIndex(32, HNSWConfig(), capacity=5000, device="cpu")
    idx.add(v, np.arange(5000))
    _, before = idx.search(q, 10)
    dead = np.unique(before[:, :3])
    assert idx.remove(dead) == len(dead)
    _, after = idx.search(q, 10)
    assert not set(after.ravel().tolist()) & set(dead.tolist())
    assert (after >= 0).all()
    assert len(idx) == 5000 - len(dead)


def test_default_device_is_cuda():
    """(d) No silent CPU fallback: the default device is CUDA."""
    if torch.cuda.is_available():
        assert HNSWIndex(8).device.type == "cuda"
        assert FlatIndex(8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HNSWIndex(8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FlatIndex(8)


def test_out_of_slice_calls_raise(jax_built):
    """(e) Calls that leave the fused kernel's path run, and agree with
    the JAX package; only settings that name nothing raise."""
    jidx, arrays, v, q, keys = jax_built
    want = keys[_truth(v, q)]
    tidx = index_from_arrays(arrays, HNSWConfig(), device="cpu")
    # the step-by-step beam over the int8 tiles on both sides: wider than
    # the fused kernel's gate, and the hop rerank
    jidx.use_pallas_beam = tidx.use_pallas_beam = False
    try:
        for kw in (dict(ef=144), dict(expand=16), dict(hop_rerank=2)):
            fused = fb.beam_search_plain.calls
            _, jk = jidx.search(q, 10, **kw)
            _, tk = tidx.search(q, 10, **kw)
            assert fb.beam_search_plain.calls == fused, kw
            np.testing.assert_array_equal(tk, jk, err_msg=str(kw))
            assert recall_at_k(tk, want) >= 0.95, kw
        tidx.use_pallas_beam = True
        _, tk = tidx.search(q, 10, ef=144)  # above the gate all the same
        assert fb.beam_search_plain.calls == fused
        np.testing.assert_array_equal(tk, jidx.search(q, 10, ef=144)[1])
        # a table over the memory budget: per-candidate gathers from the
        # bf16 traversal copy, which is the JAX package's path on the CPU
        tidx.nbr_budget_bytes = 1 << 20
        jidx.layout = "auto"
        assert tidx.tables.neighborhood(tidx.layout,
                                        tidx.nbr_budget_bytes) is None
        _, jk = jidx.search(q, 10)
        _, tk = tidx.search(q, 10)
        assert fb.beam_search_plain.calls == fused
        assert recall_at_k(tk, want) >= recall_at_k(jk, want) - 0.01
        assert (tk == jk).mean() > 0.95  # bf16 products round differently
    finally:
        jidx.use_pallas_beam = True
        jidx.layout = "neighborhood"
    # one row into the built graph, on both sides
    new = v[:1] + 0.01
    for idx in (jidx, tidx):
        idx.add(new, np.array([10**6]))
    assert len(tidx) == len(jidx) == 5001
    assert tidx.search(new, 1)[1][0, 0] == jidx.search(new, 1)[1][0, 0] == 10**6
    # an index grown from nothing, below the bulk threshold
    small = HNSWIndex(32, device="cpu", layout="flat", use_pallas=True)
    small.add(v[:300], np.arange(300))
    with pytest.raises(ValueError, match="traversal_dtype='f32'"):
        small.search(v[:300], 1)  # the gather kernel takes no bf16 table
    small.traversal_dtype = "f32"
    _, tk = small.search(v[:300], 1)
    # two batches into an empty graph link mostly through batch peers;
    # tests/test_torch_insert.py holds that case against the JAX package
    assert (tk[:, 0] == np.arange(300)).mean() >= 0.9
    # every call of the index surface is ported (tests/test_torch_
    # hnsw_api.py holds them); settings that name nothing raise
    for bad in (dict(layout="tiles"), dict(traversal_dtype="f16"),
                dict(descent="greedy"), dict(scalar_kind="f16"),
                dict(query_transfer_dtype="f16")):
        with pytest.raises(ValueError):
            HNSWIndex(32, device="cpu", **bad)


@pytest.mark.gpu
def test_chip_smoke_kernel_check_on_card():
    """(f) K1 against its plain version on the card (chip_smoke's random
    table checks for ip, cosine and unaligned meta rows, and l2sq at ef
    128 / expand 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu "
                    "tests/test_torch_hnsw.py` on the GPU machine")
    import chip_smoke

    errs = chip_smoke.kernel_checks_random(torch.device("cuda"))
    assert set(errs) == {"ip", "cosine", "l2sq-97"}
    args = chip_smoke.random_beam_inputs(torch.device("cuda"), ef=128)
    kw = dict(ef=128, expand=8, m0=32, d=128, max_steps=64,
              metric=MetricKind.L2SQ)
    chip_smoke.compare_beam("random-l2sq-ef128-e8", args, kw)
