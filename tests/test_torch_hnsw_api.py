"""Port parity: the rest of HNSWIndex (isolate, compact, stats, the
usearch helpers, cluster, join, the bf16 store, query transfer dtypes)
against the JAX package, after the same removals on both sides of one
carried-across graph.

Tolerances:
- isolate and compact are integer bookkeeping: every GraphState array
  and the compacted store arrays (vectors, norms, keys) equal the JAX
  package's bit for bit; stats() returns an equal dict;
- searches then run the step-by-step beam over the int8 tiles on both
  sides (as tests/test_torch_beam.py holds it), then the exact rerank:
  distances within the f32 bound derived in tests/test_torch_topk.py
  (sums in another order), keys identical wherever that bound
  separates the reference's neighbouring distances;
- cluster: identical keys, scores within 1e-5; join: an equal dict;
- the bf16 store: the port's recall@10 at least the JAX package's
  - 0.01 (the two run different beams on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_vss_tpu.models.graph import GraphState as JGraphState
from duckdb_vss_tpu.models.hnsw import HNSWIndex as JHNSW
from duckdb_vss_tpu.utils.config import HNSWConfig as JConfig
from duckdb_vss_tpu_torch.models.flat import row_sq_norms
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.utils.config import HNSWConfig
from duckdb_vss_tpu_torch.utils.convert import (GRAPH_FIELDS, host_array,
                                                index_from_arrays,
                                                index_to_arrays)
from chip_smoke import blocking_pairs
from test_torch_beam import _clustered
from test_torch_topk import (assert_same_ids_within_ties,
                             assert_scores_within, score_bound)

torch.set_num_threads(2)

N, D, NQ = 5000, 32, 40
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
STORE_FIELDS = ("_vectors", "_vec_sq", "_valid", "_keys")


def jax_arrays(jidx):
    """A JAX index's state as index_from_arrays takes it."""
    st = jidx.store
    out = {f: np.asarray(getattr(st, f)) for f in STORE_FIELDS}
    out.update({f: np.asarray(getattr(jidx.graph, f)) for f in GRAPH_FIELDS})
    out.update(dims=jidx.dims, _next_slot=st._next_slot,
               _free_slots=np.asarray(st._free_slots, np.int64))
    return out


def jax_index_from(arrays, config=None):
    """A JAX HNSWIndex holding ``arrays`` (port arrays included: a bf16
    store as uint16 bits), tiles on the CPU, off its fused kernel."""
    import ml_dtypes

    vectors = np.asarray(arrays["_vectors"])
    bf16 = vectors.dtype.itemsize == 2
    jidx = JHNSW(int(arrays["dims"]), config or JConfig(),
                 capacity=vectors.shape[0],
                 scalar_kind="bf16" if bf16 else "f32")
    st = jidx.store
    st._vectors = jnp.asarray(vectors.view(ml_dtypes.bfloat16) if bf16
                              else vectors)
    st._vec_sq = jnp.asarray(arrays["_vec_sq"])
    st._valid = jnp.asarray(arrays["_valid"])
    st._keys = np.asarray(arrays["_keys"], np.int64).copy()
    st._key_to_slot = {int(k): i for i, k in enumerate(st._keys.tolist())
                       if k >= 0}
    st.size = len(st._key_to_slot)
    st._next_slot = int(arrays["_next_slot"])
    st._free_slots = [int(s) for s in arrays["_free_slots"]]
    jidx.graph = JGraphState(**{f: jnp.asarray(arrays[f])
                                for f in GRAPH_FIELDS})
    jidx.layout, jidx.use_pallas_beam = "neighborhood", False
    return jidx


@pytest.fixture(scope="module")
def built():
    """One JAX bulk-built index's state, its data and held-out queries."""
    v, q = _clustered(51, N, NQ)
    jidx = JHNSW(D, JConfig(), capacity=N)
    jidx.layout = "flat"
    jidx.add(v, np.arange(N, dtype=np.int64) * 3)
    return jax_arrays(jidx), v, q


def _pair(built, remove=True):
    """Fresh JAX and port indexes on the built state, both searching
    through the step-by-step beam over the int8 tiles, after the same
    removals: every seventh key and the entry node."""
    arrays, v, q = built
    jidx = jax_index_from(arrays)
    tidx = index_from_arrays(arrays, HNSWConfig(), device="cpu",
                             layout="neighborhood", use_pallas_beam=False)
    if remove:
        entry_key = int(arrays["_keys"][int(arrays["entry_node"])])
        dead = np.unique(np.r_[np.arange(0, N * 3, 21), entry_key])
        assert jidx.remove(dead) == tidx.remove(dead) == len(dead)
    return jidx, tidx


def assert_same_graph(jidx, tidx):
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(tidx.graph, f).numpy(),
                                      np.asarray(getattr(jidx.graph, f)),
                                      err_msg=f)


def assert_same_search(jidx, tidx, q, v, **kw):
    js, jk = jidx.search(q, 10, **kw)
    ts, tk = tidx.search(q, 10, **kw)
    bound = score_bound(q, v, "l2sq")
    assert_scores_within(ts, js, bound, "l2sq")
    assert_same_ids_within_ties(tk, jk, js, 2 * bound, "l2sq")
    return tk


@pytest.mark.parametrize("isolate_first", [True, False])
def test_isolate_and_compact_bitwise(built, isolate_first):
    arrays, v, q = built
    jidx, tidx = _pair(built)
    dead_keys = set(np.arange(0, N * 3, 21).tolist())
    if isolate_first:
        jidx.isolate()
        tidx.isolate()
        assert_same_graph(jidx, tidx)
        nb0 = tidx.graph.neighbors0.numpy()
        valid = tidx.store._valid.numpy()
        assert valid[nb0[nb0 >= 0]].all(), "an edge into a tombstone"
        un = tidx.graph.upper_neighbors.numpy()
        assert valid[un[un >= 0]].all(), "an upper edge into a tombstone"
        # live entries first in every base list
        assert not ((nb0[:, 1:] >= 0) & (nb0[:, :-1] < 0)).any()
        assert tidx.is_dirty and "nbr" not in tidx.tables.built
        got = assert_same_search(jidx, tidx, q, v)
        assert not set(got.ravel().tolist()) & dead_keys
    jidx.compact()
    tidx.compact()
    assert_same_graph(jidx, tidx)
    ja, ta = jax_arrays(jidx), index_to_arrays(tidx)
    for f in STORE_FIELDS + ("_next_slot", "_free_slots"):
        np.testing.assert_array_equal(ta[f], ja[f], err_msg=f)
    assert tidx.store._key_to_slot == jidx.store._key_to_slot
    n_live = len(tidx)
    assert n_live == N - len(dead_keys) - 1
    assert tidx.store.capacity == 8192  # compact keeps the capacity
    levels = tidx.graph.levels.numpy()
    assert (levels[:n_live] >= 0).all() and (levels[n_live:] == -1).all()
    assert (np.diff(levels[:n_live]) <= 0).all()  # level descending
    assert int(tidx.graph.entry_node) == 0
    got = assert_same_search(jidx, tidx, q, v)
    assert not set(got.ravel().tolist()) & dead_keys
    assert tidx.stats()["levels"][0]["nodes"] == n_live


def test_stats_equal(built):
    jidx, tidx = _pair(built)
    tidx.build_distance_count = jidx.build_distance_count = 123
    for idx in (jidx, tidx):
        idx.search(built[2][:8], 10)
    assert tidx.search_distance_count == jidx.search_distance_count > 0
    js, ts = jidx.stats(), tidx.stats()
    assert ts == js
    assert len(ts["levels"]) == ts["max_level"] + 1 >= 2


def test_helpers_equal(built):
    """contains, count, rename, get_vector, distance_between,
    export_keys, on both sides after the same calls."""
    jidx, tidx = _pair(built)
    for idx in (jidx, tidx):
        assert idx.contains(3) and not idx.contains(21)
        assert idx.count(3) == 1 and idx.count(4) == 0
        assert idx.rename(3, 10**7)
        assert not idx.rename(6, 10**7)  # the new key is taken
        assert not idx.rename(21, 5)  # the old key is gone
    np.testing.assert_array_equal(tidx.export_keys(), jidx.export_keys())
    np.testing.assert_array_equal(tidx.get_vector(10**7),
                                  jidx.get_vector(10**7))
    for a, b in ((10**7, 9), (12, 15), (30, 30)):
        np.testing.assert_allclose(tidx.distance_between(a, b),
                                   jidx.distance_between(a, b), rtol=1e-5,
                                   atol=1e-6)
    assert tidx.distance_between(30, 30) == 0.0
    assert tidx.is_dirty


def test_cluster_matches_jax(built):
    """The nearest node at level 1 (and at a level past the top, clamped)
    for every query: the JAX package's keys, exact scores. A removed
    node stays a cluster head (key -1) until isolate or compact, on both
    sides."""
    _, v, q = built
    for remove in (True, False):
        jidx, tidx = _pair(built, remove=remove)
        for level in (1, 99):
            jk, js = jidx.cluster(q, level=level, chunk=16)
            tk, ts = tidx.cluster(q, level=level, chunk=16)
            np.testing.assert_array_equal(tk, jk)
            np.testing.assert_allclose(ts, js, **SCORE_TOL)
    assert (tk >= 0).all()
    tk, ts = tidx.cluster(q, level=1)
    levels = tidx.graph.levels.numpy()
    slots = np.array([tidx.store._key_to_slot[int(k)] for k in tk])
    assert (levels[slots] >= 1).all()
    exact = ((q - v[tk // 3]) ** 2).sum(1)
    np.testing.assert_allclose(ts, exact, rtol=1e-4, atol=1e-4)


def _join_pair(built, n=300):
    """Proposers: n held-out rows in an index of each package. join reads
    only their rows, so they go into the stores directly."""
    _, v, _ = built
    rng = np.random.default_rng(52)
    rows = v[rng.integers(0, N, n)] + 0.05 * rng.normal(size=(n, D)).astype(
        np.float32)
    keys = np.arange(n) + 10**6
    ja = JHNSW(D, JConfig(), capacity=n)
    ta = HNSWIndex(D, HNSWConfig(), capacity=n, device="cpu")
    for a in (ja, ta):
        a.store.add(rows, keys)
    return ja, ta, keys


def test_join_matches_jax_and_is_stable(built):
    jidx, tidx = _pair(built)
    ja, ta, men = _join_pair(built)
    want = ja.join(jidx, k=8)
    got = ta.join(tidx, k=8)
    assert got == want and len(got) > 200
    # stability: no proposer and candidate prefer each other over their
    # partners within the k lists
    pref_s, pref_k = tidx.search(np.stack([ta.get_vector(m) for m in men]),
                                 8)
    assert blocking_pairs(got, men, pref_s, pref_k) == 0
    assert blocking_pairs({}, men, pref_s, pref_k) > 0  # the check bites
    with pytest.raises(ValueError, match="matching metric"):
        ta.join(HNSWIndex(D + 1, device="cpu"))
    assert HNSWIndex(D, device="cpu").join(tidx) == {}


@pytest.mark.parametrize("transfer", ["bf16", "int8"])
def test_query_transfer_dtypes_match_jax(built, transfer):
    jidx, tidx = _pair(built, remove=False)
    jidx.query_transfer_dtype = tidx.query_transfer_dtype = transfer
    assert_same_search(jidx, tidx, built[2], built[1])
    with pytest.raises(ValueError, match="query_transfer_dtype"):
        HNSWIndex(D, device="cpu", query_transfer_dtype="f16")


def test_bf16_store_recall(built):
    """scalar_kind="bf16" on both sides, each package's own bulk build:
    the port's recall@10 within 0.01 of the JAX package's; the traversal
    copy is the store itself, whose bits are the JAX store's."""
    _, v, q = built
    keys = np.arange(N, dtype=np.int64)
    jidx = JHNSW(D, JConfig(), capacity=N, scalar_kind="bf16")
    jidx.add(v, keys)
    tidx = HNSWIndex(D, HNSWConfig(), capacity=N, device="cpu",
                     scalar_kind="bf16")
    tidx.add(v, keys)
    assert tidx.tables.traversal() is tidx.store._vectors
    np.testing.assert_array_equal(
        host_array(tidx.store._vectors),
        np.asarray(jidx.store._vectors).view(np.uint16))
    d2 = (v * v).sum(1)[None, :] - 2.0 * (q @ v.T)
    want = np.argsort(d2, 1, kind="stable")[:, :10]

    def recall(got):
        return np.mean([len(set(a) & set(b)) / 10
                        for a, b in zip(got.tolist(), want.tolist())])

    r_jax = recall(jidx.search(q, 10, ef=48)[1])
    r_port = recall(tidx.search(q, 10, ef=48)[1])
    assert r_port >= r_jax - 0.01, (r_port, r_jax)
    assert r_port >= 0.9, r_port


def test_bf16_compact_keeps_the_store_dtype(built, tmp_path):
    """compact of a bf16 store: the graph arrays equal the JAX package's
    bit for bit and the rows hold its values. The JAX package widens the
    store to f32 there (its compact pads with f32 zeros), and its file of
    that index no longer loads; the port keeps bf16, and its file loads
    back to the same arrays."""
    from duckdb_vss_tpu_torch.utils import persist

    arrays, v, q = built
    bf = dict(arrays)
    rows = torch.from_numpy(np.array(arrays["_vectors"])).to(torch.bfloat16)
    bf["_vectors"] = host_array(rows)
    bf["_vec_sq"] = row_sq_norms(rows.float().numpy())  # as a bf16 add
    jidx = jax_index_from(bf)
    tidx = index_from_arrays(bf, HNSWConfig(), device="cpu",
                             layout="neighborhood", use_pallas_beam=False)
    dead = np.arange(0, N * 3, 15)
    for idx in (jidx, tidx):
        idx.remove(dead)
        idx.compact()
    assert_same_graph(jidx, tidx)
    assert tidx.store._vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tidx.store._vectors.float().numpy(),
        np.asarray(jidx.store._vectors).astype(np.float32))
    path = str(tmp_path / "bf16.vss")
    persist.save_index(tidx, path)
    back = persist.load_index(path, lazy=False, device="cpu")
    want = index_to_arrays(tidx)
    got = index_to_arrays(back)
    for f in STORE_FIELDS + GRAPH_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
