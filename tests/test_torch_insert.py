"""Port parity: the incremental insert path (models/build.insert_batch,
HNSWIndex.add) against the JAX package, and insert plus search end to end.

Both packages start from one graph that the JAX package built and insert
the same batches into the same slots with the same levels. The level
bookkeeping (levels, upper_slot, upper_node, upper_count, entry_node,
max_level) must be equal. Neighbor lists are compared as sets per row:
mean Jaccard >= 0.98, not identity, because a candidate beam's order
rests on f32 sums that the two libraries take in different orders, and
one flipped near-tie changes a row. Self-recall@1 and recall@10 of the
port may be at most 0.01 under the JAX package's. The back-link
resolvers alone, on handmade conflicts, must equal the JAX result
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_vss_tpu.models import build as jbuild
from duckdb_vss_tpu.models.hnsw import HNSWIndex as JHNSW
from duckdb_vss_tpu.models.hnsw import _default_build_steps as j_build_steps
from duckdb_vss_tpu.utils.config import HNSWConfig as JConfig
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch.models import build as tbuild
from duckdb_vss_tpu_torch.models import graph as port_graph
from duckdb_vss_tpu_torch.models.graph import make_neighborhood_tables
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex, _default_build_steps
from duckdb_vss_tpu_torch.ops.fused_beam import pack_meta
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.convert import GRAPH_FIELDS, index_from_arrays

torch.set_num_threads(2)

D, M, M0, CAP, BB = 32, 8, 16, 4096, 128
MIN_JACCARD = 0.98
RECALL_SLACK = 0.01
EXACT_FIELDS = ("levels", "upper_slot", "upper_node", "upper_count",
                "entry_node", "max_level")


def _clustered(seed, n, d=D, n_centers=48):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    return (centers[rng.integers(0, n_centers, n)]
            + 0.25 * rng.normal(size=(n, d))).astype(np.float32)


def _jax_index(**kw):
    idx = JHNSW(D, JConfig(m=M, m0=M0), capacity=CAP, build_batch=BB,
                traversal_dtype="f32", **kw)
    idx.layout = "flat"
    return idx


def _port_copy(jidx, **kw):
    arrays = {f: np.asarray(getattr(jidx.store, f))
              for f in ("_vectors", "_vec_sq", "_valid", "_keys")}
    arrays.update({f: np.asarray(getattr(jidx.graph, f))
                   for f in GRAPH_FIELDS})
    arrays["dims"] = D
    return index_from_arrays(arrays, HNSWConfig(m=M, m0=M0), device="cpu",
                             build_batch=BB, layout="flat",
                             traversal_dtype="f32", **kw)


def mean_jaccard(a, b, rows):
    out = []
    for x, y in zip(a[rows].tolist(), b[rows].tolist()):
        x, y = set(x) - {-1}, set(y) - {-1}
        out.append(len(x & y) / len(x | y) if x | y else 1.0)
    return float(np.mean(out))


def assert_graphs_agree(tgraph, jgraph, n_rows):
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(tgraph, f).numpy(),
                                      np.asarray(getattr(jgraph, f)), f)
    rows = np.arange(n_rows)
    j0 = mean_jaccard(tgraph.neighbors0.numpy(),
                      np.asarray(jgraph.neighbors0), rows)
    n_up = int(jgraph.upper_count)
    ju = mean_jaccard(tgraph.upper_neighbors.numpy().reshape(-1, M),
                      np.asarray(jgraph.upper_neighbors).reshape(-1, M),
                      np.arange(n_up * 8))  # L_MAX windows of M per slot
    assert j0 >= MIN_JACCARD and ju >= MIN_JACCARD, (j0, ju)
    return j0, ju


def _recalls(idx, v, keys, probe):
    """(self-recall@1 of the probed rows, recall@10 against numpy)."""
    q = v[probe]
    _, got1 = idx.search(q, 1, ef=32)
    _, got10 = idx.search(q, 10, ef=64)
    d2 = (v * v).sum(1)[None, :] - 2.0 * (q @ v.T)
    want = keys[np.argsort(d2, 1, kind="stable")[:, :10]]
    r10 = np.mean([len(set(g) & set(w)) / 10
                   for g, w in zip(got10.tolist(), want.tolist())])
    return float((got1[:, 0] == keys[probe]).mean()), float(r10)


def test_default_build_steps_match_jax():
    for ef_c, expand in [(128, 4), (64, 4), (200, 2), (16, 1), (128, 0)]:
        assert _default_build_steps(ef_c, expand) == j_build_steps(ef_c, expand)


def test_insert_batch_matches_jax():
    """insert_batch itself, three batches into a JAX-built graph: the
    same slots and levels on both sides, a level above the graph's top
    (entry promotion), a pad row, a batch that is not full."""
    n0 = 3000
    v = _clustered(41, n0 + 3 * BB)
    jidx = _jax_index()
    jidx.add(v[:n0], np.arange(n0, dtype=np.int64))  # the JAX insert path
    tidx = _port_copy(jidx)
    rng = np.random.default_rng(42)
    top = int(jidx.graph.max_level)
    steps = _default_build_steps(128, 4)
    for i in range(3):
        new = v[n0 + i * BB:n0 + (i + 1) * BB]
        if i == 2:
            new = new[:BB - 9]  # a partial batch: -1 pad rows
        keys = np.arange(len(new), dtype=np.int64) + 10**6 * (i + 1)
        js = np.asarray(jidx.store.add(new, keys), np.int32)
        ts = np.asarray(tidx.store.add(new, keys), np.int32)
        np.testing.assert_array_equal(ts, js)
        slots = np.full(BB, -1, np.int32)
        slots[:len(js)] = js
        levels = np.floor(-np.log(rng.random(BB)) / np.log(M)).astype(np.int32)
        if i == 1:
            levels[7] = top + 1  # promotes the entry point
        jidx.graph, jn = jbuild.insert_batch(
            jidx.graph, jidx.store._vectors, jidx.store._vec_sq,
            jnp.asarray(slots), jnp.asarray(levels), JMetric.L2SQ, M, M0, 128,
            expand=4, prune="diversity", backlink_cols=4, r_rounds=2,
            max_steps_base=steps, max_steps_upper=16)
        before = tidx.graph.neighbors0.clone()
        old = tidx.graph
        tidx.graph, tn = tbuild.insert_batch(
            old, tidx.store._vectors, tidx.store._vec_sq,
            torch.from_numpy(slots), torch.from_numpy(levels),
            MetricKind.L2SQ, M, M0, 128, expand=4, prune="diversity",
            backlink_cols=4, r_rounds=2, max_steps_base=steps,
            max_steps_upper=16)
        assert torch.equal(old.neighbors0, before)  # the input state stands
        assert abs(int(tn) - int(jn)) <= 0.02 * int(jn), (int(tn), int(jn))
        assert_graphs_agree(tidx.graph, jidx.graph, int(js.max()) + 1)
    assert int(tidx.graph.max_level) == top + 1
    nb0 = tidx.graph.neighbors0.numpy()
    n = tidx.store._next_slot
    assert not (nb0[:n] == np.arange(n)[:, None]).any()  # no self edges
    # the reachability floor: an inserted node has an in-link from its
    # nearest forward target, unless more than r_rounds nodes of a batch
    # share that target or a later batch evicted it; as often as in JAX
    jnb0 = np.asarray(jidx.graph.neighbors0)

    def linked(nb):
        return np.mean([(nb[nb[s, 0]] == s).any() for s in range(n0, n)])

    assert linked(nb0) >= max(0.9, linked(jnb0) - 0.01)


def test_hnsw_add_matches_jax():
    """Insert and search end to end, through HNSWIndex.add: from empty
    below the bulk threshold (5 batches, the last one partial), then three more
    batches into the graph that stands, with progress reported; then
    search on both."""
    n0, n1 = 600, 3 * BB
    v = _clustered(43, n0 + n1)
    keys = np.arange(n0 + n1, dtype=np.int64) * 3 + 5
    jidx = _jax_index(seed=77)
    tidx = HNSWIndex(D, HNSWConfig(m=M, m0=M0), capacity=CAP, seed=77,
                     device="cpu", build_batch=BB, layout="flat",
                     traversal_dtype="f32")
    for lo, hi, n_batches in ((0, n0, 5), (n0, n0 + n1, 3)):
        seen = []
        js = jidx.add(v[lo:hi], keys[lo:hi])
        ts = tidx.add(v[lo:hi], keys[lo:hi], on_progress=seen.append)
        np.testing.assert_array_equal(ts, js)
        assert_graphs_agree(tidx.graph, jidx.graph, hi)
        assert seen[-1] == 1.0 and seen == sorted(seen)
        assert len(seen) == n_batches
    assert tidx.build_distance_count > 0
    assert abs(tidx.build_distance_count - jidx.build_distance_count) \
        <= 0.02 * jidx.build_distance_count
    probe = np.arange(0, n0 + n1, 3)
    j_self, j_r10 = _recalls(jidx, v, keys, probe)
    t_self, t_r10 = _recalls(tidx, v, keys, probe)
    assert t_self >= j_self - RECALL_SLACK, (t_self, j_self)
    assert t_r10 >= j_r10 - RECALL_SLACK, (t_r10, j_r10)
    assert t_self >= 0.97


@pytest.mark.parametrize("layout", ["flat", "neighborhood"])
def test_two_inserts_on_one_seed_give_one_graph(layout):
    """The same rows inserted twice through the port, into two copies of
    one JAX-built graph with the level generator at the same point: every
    graph array, the store, the int8 tables (the neighborhood layout,
    the card's insert path) and the distance count equal, bit for bit.
    The JAX package's insert of the same rows: the level bookkeeping
    equal, the neighbor lists as this file's other tests hold them."""
    n0, n1 = 1000, 3 * BB - 17
    v = _clustered(47, n0 + n1)
    keys = np.arange(n0 + n1, dtype=np.int64) + 7
    jidx = _jax_index(seed=5)
    jidx.add(v[:n0], keys[:n0])
    ports = [_port_copy(jidx) for _ in range(2)]
    jidx.layout = layout
    for t in ports:
        t.layout = layout
        t._level_rng.bit_generator.state = jidx._level_rng.bit_generator.state
        if layout == "neighborhood":
            assert t.tables.neighborhood(t.layout, t.nbr_budget_bytes)
    for idx in [jidx] + ports:
        idx.add(v[n0:], keys[n0:])
    a, b = ports
    for f in GRAPH_FIELDS:
        assert torch.equal(getattr(a.graph, f), getattr(b.graph, f)), f
    for f in ("_vectors", "_vec_sq", "_valid"):
        assert torch.equal(getattr(a.store, f), getattr(b.store, f)), f
    np.testing.assert_array_equal(a.store._keys, b.store._keys)
    assert a.build_distance_count == b.build_distance_count > 0
    if layout == "neighborhood":
        assert all(torch.equal(x, y) for x, y in zip(
            a.tables.built["nbr"], b.tables.built["nbr"]))
    assert_graphs_agree(a.graph, jidx.graph, n0 + n1)


def test_add_keeps_the_int8_layout_valid():
    """Bulk build, then incremental adds through the int8 neighborhood
    layout: the row-updated tables equal a rebuild from the final graph
    bit for bit, the fused search finds the inserted rows, and the
    batched back-link variant keeps them findable too."""
    n0, n1 = 4200, 300
    v = _clustered(44, n0 + n1)
    keys = np.arange(n0 + n1, dtype=np.int64)
    for backlinks in ("rounds", "batched"):
        idx = HNSWIndex(D, HNSWConfig(m=M, m0=M0), capacity=n0 + n1,
                        device="cpu", build_batch=BB, layout="neighborhood")
        idx.add(v[:n0], keys[:n0])  # bulk path
        if backlinks == "batched":  # opt-in: HNSWIndex never selects it
            idx.search(v[:4], 1)  # builds the layout
            cached = idx.tables.built["nbr"]
            slots = idx.store.add(v[n0:n0 + BB], keys[n0:n0 + BB])
            st = torch.from_numpy(np.asarray(slots, np.int32))
            idx.graph, _ = tbuild.insert_batch(
                idx.graph, idx.store._vectors, idx.store._vec_sq, st,
                torch.zeros(BB, dtype=torch.int32), MetricKind.L2SQ, M, M0,
                128, expand=4, backlink_cols=4, r_rounds=2, max_steps_base=16,
                max_steps_upper=16, backlinks="batched", nbr_vecs=cached[0],
                nbr_scale=cached[1], nbr_sq=cached[2])
            port_graph.update_neighborhood_rows(
                *cached, idx.store._vectors, idx.store._vec_sq,
                idx.graph.neighbors0, st)
            n_new = BB
        else:
            idx.add(v[n0:], keys[n0:])  # incremental, layout active
            n_new = n1
        assert "nbr" in idx.tables.built
        fv, fsc, fsq = make_neighborhood_tables(
            idx.store._vectors, idx.store._vec_sq, idx.graph.neighbors0)
        fm = pack_meta(idx.graph.neighbors0, fsc, fsq)
        for got, want in zip(idx.tables.built["nbr"], (fv, fsc, fsq, fm)):
            assert torch.equal(got, want)
        _, got = idx.search(v[n0:n0 + n_new], 1, ef=32)
        self_rec = float((got[:, 0] == keys[n0:n0 + n_new]).mean())
        assert self_rec >= 0.95, (backlinks, self_rec)


def _handmade(seed=45):
    """12 nodes, rows of 4. Requests: three for target 0 (ranks 0-2),
    one for the full row 1 (overflow: prune), a source already in row 2,
    one inactive, one for the empty row 3, two for target 4."""
    rng = np.random.default_rng(seed)
    vec = rng.normal(size=(12, 128)).astype(np.float32)
    table = np.full((8, 4), -1, np.int32)
    table[0] = [5, 6, -1, -1]
    table[1] = [5, 6, 7, 8]
    table[2] = [9, 5, -1, -1]
    table[4] = [6, 7, 8, -1]
    tgt = np.array([0, 0, 0, 1, 2, 3, 3, 4, 4], np.int32)
    src = np.array([9, 10, 11, 9, 9, 10, 11, 10, 11], np.int32)
    act = np.array([1, 1, 1, 1, 1, 0, 1, 1, 1], bool)
    return vec, table, tgt, src, act


@pytest.mark.parametrize("variant", ["rounds", "batched"])
@pytest.mark.parametrize("prune", ["diversity", "truncate"])
@pytest.mark.parametrize("r_rounds", [1, 2, 4])
def test_apply_backlinks_matches_jax_exactly(variant, prune, r_rounds):
    vec, table, tgt, src, act = _handmade()
    sq = (vec * vec).sum(1)
    name = "_apply_backlinks" + ("_batched" if variant == "batched" else "")
    want = getattr(jbuild, name)(
        jnp.asarray(table), jnp.asarray(vec), jnp.asarray(sq),
        jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(act),
        jnp.asarray(tgt), JMetric.L2SQ, r_rounds, prune)
    got = getattr(tbuild, name)(
        torch.from_numpy(table.copy()), torch.from_numpy(vec),
        torch.from_numpy(sq), torch.from_numpy(tgt), torch.from_numpy(src),
        torch.from_numpy(act), torch.from_numpy(tgt), MetricKind.L2SQ,
        r_rounds, prune)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[5:] == -1).all()  # untouched rows
    # the same requests against one level's window of a packed table
    wide = np.full((8, 12), -1, np.int32)
    wide[:, 4:8] = table
    wide[:, :4] = 3  # the other windows must stay as they are
    want = getattr(jbuild, name)(
        jnp.asarray(wide), jnp.asarray(vec), jnp.asarray(sq),
        jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(act),
        jnp.asarray(tgt), JMetric.L2SQ, r_rounds, prune, col_off=4, m_cap=4)
    got_w = getattr(tbuild, name)(
        torch.from_numpy(wide.copy()), torch.from_numpy(vec),
        torch.from_numpy(sq), torch.from_numpy(tgt), torch.from_numpy(src),
        torch.from_numpy(act), torch.from_numpy(tgt), MetricKind.L2SQ,
        r_rounds, prune, col_off=4, m_cap=4)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_w.numpy()[:, 4:8], got.numpy())


@pytest.mark.parametrize("r_rounds", [1, 2])
def test_force_nearest_backlink_matches_jax_exactly(r_rounds):
    vec, table, tgt, src, act = _handmade(46)
    sq = (vec * vec).sum(1)
    want = jbuild._force_nearest_backlink(
        jnp.asarray(table), jnp.asarray(vec), jnp.asarray(sq),
        jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(act), JMetric.L2SQ,
        r_rounds)
    got = tbuild._force_nearest_backlink(
        torch.from_numpy(table.copy()), torch.from_numpy(vec),
        torch.from_numpy(sq), torch.from_numpy(tgt), torch.from_numpy(src),
        torch.from_numpy(act), MetricKind.L2SQ, r_rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[1] != table[1]).sum() == 1  # full row: one eviction
    assert (got.numpy()[2] == table[2]).all()  # source already present
