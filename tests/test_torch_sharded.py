"""Port parity: sharding on one device (duckdb_vss_tpu_torch.parallel.
sharded) against the JAX package's, one port case for each case of
tests/test_sharded.py, plus the level stream, the placement, the
ef_local policy and cross-opened files.

The JAX side runs on conftest's virtual 8-CPU mesh (make_mesh(4, 2)),
the port side on make_mesh(4, 2, device="cpu"): four shards stacked on
one device.

Tolerances:
- the flat index is an exact path: scores within the f32 bound of
  tests/test_torch_topk.py (sums in another order), ids equal wherever
  that bound separates the JAX package's neighbouring scores;
- the approximate paths run one graph on both sides: the JAX-built
  graph is carried into the port (convert.sharded_from_arrays, norms as
  given) and both search the same queries; the port must reach at least
  the JAX package's recall there. The port's own build must pass the
  JAX test's own floor;
- host bookkeeping is exact: placement, slot allocation, the levels
  drawn (bulk and insert order), compaction's permutations (every
  array after remove and compact bit for bit), and the saved file (the
  same state saved by both packages is byte-identical);
- a JAX-written file loads in the port with equal arrays and searches
  within the bound (the JAX load re-sums the norms on the device, the
  port by numpy); a port-written file reloads in the port bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from duckdb_vss_tpu.parallel import sharded as jsh
from duckdb_vss_tpu.utils.config import HNSWConfig as JConfig
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch.models.graph import sample_levels
from duckdb_vss_tpu_torch.ops import fused_beam as fb
from duckdb_vss_tpu_torch.parallel import sharded as tsh
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.convert import (sharded_from_arrays,
                                                sharded_to_arrays)
from test_torch_topk import (assert_same_ids_within_ties,
                             assert_scores_within, score_bound)
from torch_flat_worker import FLAT_CASES, case_data, run_case

torch.set_num_threads(2)

FIELDS = tsh.ShardedGraph._fields
SMALL = dict(m=4, m0=8)  # the JAX cases' small graph config


@pytest.fixture(scope="module")
def jmesh():
    return jsh.make_mesh(4, 2)


@pytest.fixture(scope="module")
def tmesh():
    return tsh.make_mesh(4, 2, device="cpu")


def test_mesh_places_shards_and_defaults_to_the_card(monkeypatch):
    """Rank r of P owns shards [r*S/P, (r+1)*S/P); make_mesh asks for
    the card unless told otherwise, and raises without one."""
    cpu = torch.device("cpu")
    assert tsh.Mesh(4, 1, cpu, world_size=2, rank=1).shards == range(2, 4)
    assert tsh.Mesh(8, 2, cpu, world_size=4, rank=0).shards == range(0, 2)
    mesh = tsh.make_mesh(4, 2, device="cpu")
    assert mesh.shape == {"q": 2, "shard": 4} and mesh.shards == range(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsh.make_mesh(4)


def jax_arrays(j):
    """A JAX ShardedHNSWIndex's state as sharded_from_arrays takes it."""
    out = {"dims": j.dims, "_keys": j._keys.copy(),
           "_next_slot": j._next_slot.copy(),
           "_free_slots": [list(f) for f in j._free_slots],
           "pl_assign": j.placement.assign.copy(),
           "pl_load": j.placement.load.copy()}
    for f in ("_vectors", "_vec_sq", "_valid"):
        out[f] = np.asarray(getattr(j, f))
    for f in FIELDS:
        out[f] = np.asarray(getattr(j.graph, f))
    return out


def carried(j, tmesh, **settings):
    """The port index on the JAX index's state, its level generator at
    the same point of its stream."""
    cfg = HNSWConfig(**{f: getattr(j.config, f) for f in (
        "m", "m0", "ef_construction", "ef_search")},
        metric=MetricKind(j.config.metric.value))
    idx = sharded_from_arrays(jax_arrays(j), cfg, tmesh,
                              build_batch=j.build_batch, **settings)
    idx._rng.bit_generator.state = j._rng.bit_generator.state
    return idx


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def assert_same_state(port, j, skip=()):
    """Every array and the host bookkeeping equal, bit for bit."""
    got, want = sharded_to_arrays(port), jax_arrays(j)
    for name in want:
        if name in skip:
            continue
        if name == "_free_slots":
            assert [list(map(int, f)) for f in got[name]] == \
                [list(map(int, f)) for f in want[name]], name
        else:
            np.testing.assert_array_equal(_bits(got[name]),
                                          _bits(want[name]), err_msg=name)


def recall(got, want):
    return float(np.mean([len(set(a) & set(b)) / want.shape[1]
                          for a, b in zip(got.tolist(), want.tolist())]))


def truth(v, q, k):
    v2 = (v * v).sum(1)
    return np.argsort(v2[None, :] - 2.0 * (q @ v.T), 1)[:, :k]


def clustered(seed, n, nq, d, n_centers=64, sigma=0.25):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    v = (centers[rng.integers(0, n_centers, n)]
         + sigma * rng.normal(size=(n, d)).astype(np.float32))
    q = (centers[rng.integers(0, n_centers, nq)]
         + sigma * rng.normal(size=(nq, d)).astype(np.float32))
    return v, q


# ---------------------------------------------------------------------------
# the flat index (exact)
# ---------------------------------------------------------------------------


def _flat_pair(jmesh, tmesh, metric, d, cap=1024):
    return (jsh.ShardedFlatIndex(d, JMetric(metric), jmesh,
                                 capacity_per_shard=cap),
            tsh.ShardedFlatIndex(d, MetricKind(metric), tmesh,
                                 capacity_per_shard=cap))


def _assert_flat_equal(j, t, q, k, metric):
    s_j, k_j = j.search(q, k)
    s_t, k_t = t.search(q, k)
    bound = score_bound(q, t._vectors.reshape(-1, t.d_pad)[:, :t.dims]
                        .numpy(), metric)
    assert_scores_within(s_t, s_j, bound, metric)
    assert_same_ids_within_ties(k_t, k_j, s_j, 2 * bound, metric)


def test_sharded_flat_exact_parity(jmesh, tmesh):
    rng = np.random.default_rng(3)
    n, d, k = 3000, 24, 10
    v = rng.normal(size=(n, d)).astype(np.float32)
    j, t = _flat_pair(jmesh, tmesh, "l2sq", d)
    j.add(v, np.arange(n))
    t.add(v, np.arange(n))
    np.testing.assert_array_equal(t._keys, j._keys)
    np.testing.assert_array_equal(t._counts, j._counts)
    _assert_flat_equal(j, t, rng.normal(size=(13, d)).astype(np.float32),
                       k, "l2sq")


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_sharded_flat_metrics(jmesh, tmesh, metric):
    rng = np.random.default_rng(5)
    n, d, k = 1000, 16, 5
    v = rng.normal(size=(n, d)).astype(np.float32)
    j, t = _flat_pair(jmesh, tmesh, metric, d)
    j.add(v, np.arange(n))
    t.add(v, np.arange(n))
    _assert_flat_equal(j, t, rng.normal(size=(5, d)).astype(np.float32), k,
                       metric)


def test_sharded_flat_grow(jmesh, tmesh):
    rng = np.random.default_rng(7)
    n1, n2, d, k = 3000, 3000, 16, 5
    v = rng.normal(size=(n1 + n2, d)).astype(np.float32)
    j, t = _flat_pair(jmesh, tmesh, "l2sq", d)
    for idx in (j, t):
        idx.add(v[:n1], np.arange(n1))
        idx.add(v[n1:], np.arange(n1, n1 + n2))  # exceeds 1024 a shard
    assert t.cap == j.cap > 1024
    _assert_flat_equal(j, t, rng.normal(size=(9, d)).astype(np.float32), k,
                       "l2sq")


def _f64_truth(case):
    """A flat case's exact top-k in float64: (scores [nq, k], ids [nq,
    k], the f32 score bound per query)."""
    metric, k = FLAT_CASES[case][0], FLAT_CASES[case][-1]
    v, q = case_data(case)
    v64, q64 = v.astype(np.float64), q.astype(np.float64)
    dot = q64 @ v64.T
    q_sq, v_sq = (q64 * q64).sum(1)[:, None], (v64 * v64).sum(1)[None, :]
    s = {"l2sq": q_sq - 2.0 * dot + v_sq, "ip": 1.0 - dot,
         "cosine": 1.0 - dot / np.sqrt(q_sq * v_sq)}[metric]
    ids = np.argsort(s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, ids, 1), ids, score_bound(q, v, metric)


def _assert_true(case, scores, keys, who):
    """Scores within the f32 bound of the float64 truth, ids equal where
    that bound separates the truth's neighbouring scores."""
    metric = FLAT_CASES[case][0]
    want_s, want_i, bound = _f64_truth(case)
    try:
        assert_scores_within(scores, want_s, bound, metric)
        assert_same_ids_within_ties(keys, want_i, want_s, 2 * bound, metric)
    except AssertionError as e:
        raise AssertionError(f"{case}, {who} against the float64 truth "
                             f"(printed as JAX): {e}") from None


@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_sharded_flat_matches_float64_truth(jmesh, tmesh, case):
    """Each sharded flat case through both packages in one process, each
    held to the float64 truth within the f32 bound (the port against
    the JAX package is test_sharded_flat_metrics and _grow)."""
    s_t, k_t = run_case(tsh.ShardedFlatIndex, MetricKind, tmesh, case)
    s_j, k_j = run_case(jsh.ShardedFlatIndex, JMetric, jmesh, case)
    _assert_true(case, s_t, k_t, "port")
    _assert_true(case, s_j, k_j, "JAX")


FRESH_PROCESSES, AT_ONCE = 24, 6


def test_sharded_flat_first_sqrt_in_fresh_processes(tmp_path):
    """The sharded flat cases in fresh processes (tests/
    torch_flat_worker.py, two torch threads, no JAX), the cosine scan
    first, each process's results held to the float64 truth. The first
    square root of a process is where torch.sqrt on the CPU (MKL's
    vsSqrt, split over the threads) once returned about half of a
    [8, 1024] block from a 12-bit estimate: the cosine scan then missed
    its bound by ~1e-4, in ~1 of 5 such processes. ops/distance.ieee_sqrt
    takes numpy's sqrt on the CPU instead."""
    worker = os.path.join(os.path.dirname(__file__), "torch_flat_worker.py")
    outs = [str(tmp_path / f"p{i}.npz") for i in range(FRESH_PROCESSES)]
    for start in range(0, FRESH_PROCESSES, AT_ONCE):
        procs = [subprocess.Popen([sys.executable, worker, out],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for out in outs[start:start + AT_ONCE]]
        for proc in procs:
            log = proc.communicate(timeout=300)[0].decode()
            assert proc.returncode == 0, log
    for i, out in enumerate(outs):
        got = np.load(out)
        for case in FLAT_CASES:
            _assert_true(case, got[f"{case}_scores"], got[f"{case}_keys"],
                         f"fresh process {i}")


# ---------------------------------------------------------------------------
# the HNSW index (approximate: one graph on both sides)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def recall_case(jmesh):
    """tests/test_sharded.py's recall graph: 4000 x 32 through the
    insert path, and its queries."""
    rng = np.random.default_rng(21)
    n, d = 4000, 32
    v = rng.normal(size=(n, d)).astype(np.float32)
    j = jsh.ShardedHNSWIndex(d, JConfig(), jmesh, capacity_per_shard=2048,
                             build_batch=128)
    j.add(v, np.arange(n))
    q = rng.normal(size=(100, d)).astype(np.float32)
    return j, v, q


def test_sharded_hnsw_recall(recall_case, tmesh):
    j, v, q = recall_case
    want = truth(v, q, 10)
    r_jax = recall(j.search(q, 10, ef=64)[1], want)
    t = carried(j, tmesh)
    r_port = recall(t.search(q, 10, ef=64)[1], want)
    assert r_port >= r_jax and r_port >= 0.9, (r_port, r_jax)


def test_sharded_search_chunked_matches_unchunked(recall_case, tmesh):
    j, v, q = recall_case
    t = carried(j, tmesh)
    s1, k1 = t.search(q, 10, ef=64, chunk=32)
    s2, k2 = t.search(q, 10, ef=64, chunk=1024)
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(s1, s2)
    want = truth(v, q, 10)
    assert recall(k1, want) >= recall(j.search(q, 10, ef=64, chunk=32)[1],
                                      want)


@pytest.fixture(scope="module")
def incremental_case(jmesh, tmesh):
    """500 rows, then 100 more, through the insert path on both sides."""
    rng = np.random.default_rng(23)
    d = 16
    v1 = rng.normal(size=(500, d)).astype(np.float32)
    v2 = rng.normal(size=(100, d)).astype(np.float32)
    j = jsh.ShardedHNSWIndex(d, JConfig(), jmesh, capacity_per_shard=1024,
                             build_batch=64)
    t = tsh.ShardedHNSWIndex(d, HNSWConfig(), tmesh, capacity_per_shard=1024,
                             build_batch=64)
    for idx in (j, t):
        idx.add(v1, np.arange(500))
        idx.add(v2, np.arange(1000, 1100))
    return j, t, v2


def test_sharded_hnsw_incremental(incremental_case, tmesh):
    j, t, v2 = incremental_case
    found_port = (t.search(v2[:10], 1, ef=64)[1][:, 0] >= 1000).mean()
    assert found_port >= 0.9
    found_jax = (j.search(v2[:10], 1, ef=64)[1][:, 0] >= 1000).mean()
    found_carried = (carried(j, tmesh).search(v2[:10], 1, ef=64)[1][:, 0]
                     >= 1000).mean()
    assert found_carried >= found_jax


@pytest.fixture(scope="module")
def bulk_case(jmesh, tmesh):
    """tests/test_sharded.py's single-chip comparison: 6000 x 24
    clustered rows, bulk-built into four shards on both sides."""
    v, q = clustered(5, 6000, 128, 24)
    j = jsh.ShardedHNSWIndex(24, JConfig(), jmesh, capacity_per_shard=2048,
                             build_batch=128)
    t = tsh.ShardedHNSWIndex(24, HNSWConfig(), tmesh,
                             capacity_per_shard=2048, build_batch=128)
    for idx in (j, t):
        idx.add(v, np.arange(len(v)))
    return j, t, v, q


def test_sharded_search_matches_singlechip_recall(bulk_case, tmesh):
    j, t, v, q = bulk_case
    want = truth(v, q, 5)
    assert recall(t.search(q, 5, ef=48)[1], want) > 0.9
    r_jax = recall(j.search(q, 5, ef=48)[1], want)
    assert recall(carried(j, tmesh).search(q, 5, ef=48)[1], want) >= r_jax


@pytest.mark.parametrize("path", ["bulk", "insert"])
def test_level_stream_equals_jax(path, bulk_case, incremental_case):
    """Both packages draw every node's level from one generator in one
    order: the bulk path all shards' levels, shard by shard, before any
    build; the insert path per build_batch step, shard by shard. So the
    graphs' levels and the generators' states end up equal."""
    j, t = (bulk_case if path == "bulk" else incremental_case)[:2]
    np.testing.assert_array_equal(
        tsh.gather_shards(t.mesh, t.graph.levels).numpy(),
        np.asarray(j.graph.levels))
    assert t._rng.bit_generator.state == j._rng.bit_generator.state


def test_sample_levels_equal_jax(jmesh, tmesh):
    j = jsh.ShardedHNSWIndex(16, JConfig(), jmesh, seed=99)
    t = tsh.ShardedHNSWIndex(16, HNSWConfig(), tmesh, seed=99)
    for n in (0, 1, 7, 4096):
        np.testing.assert_array_equal(
            sample_levels(t._rng, n, t.config.m), j._sample_levels(n))


def _pathological_keys(n, s):
    return np.concatenate([np.arange(n // 2, dtype=np.int64) * s,
                           10_000_000 + np.arange(n // 2, dtype=np.int64)])


def test_virtual_placement_equals_jax():
    keys = _pathological_keys(1024, 4)
    rng = np.random.default_rng(1)
    jp, tp = jsh.VirtualPlacement(4), tsh.VirtualPlacement(4)
    for batch in (keys, rng.integers(0, 1 << 40, 777), keys + 3):
        np.testing.assert_array_equal(tp.place(batch), jp.place(batch))
        np.testing.assert_array_equal(tp.assign, jp.assign)
        np.testing.assert_array_equal(tp.load, jp.load)
    tp.unplace_counts([5, 0, 2, 1])
    jp.unplace_counts([5, 0, 2, 1])
    np.testing.assert_array_equal(tp.load, jp.load)
    np.testing.assert_array_equal(tsh._splitmix64(keys),
                                  jsh._splitmix64(keys))
    np.testing.assert_array_equal(tsh.shard_keys(keys, 4),
                                  jsh.shard_keys(keys, 4))


def test_virtual_placement_balances_pathological_keys(jmesh, tmesh):
    rng = np.random.default_rng(0)
    n, d, s = 1024, 16, 4
    keys = _pathological_keys(n, s)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    j = jsh.ShardedHNSWIndex(d, JConfig(**SMALL), jmesh,
                             capacity_per_shard=1024, build_batch=64)
    t = tsh.ShardedHNSWIndex(d, HNSWConfig(**SMALL), tmesh,
                             capacity_per_shard=1024, build_batch=64)
    for idx in (j, t):
        idx.add(vecs, keys)
    np.testing.assert_array_equal(t.counts, j.counts)
    assert t.counts.sum() == n and t.counts.max() <= 2 * n // s
    assert_same_state(t, j, skip=("_vec_sq",) + FIELDS[:4])
    hit = (t.search(vecs[:16], 1, ef=32)[1][:, 0] == keys[:16]).mean()
    assert hit >= 0.75
    hit_jax = (j.search(vecs[:16], 1, ef=32)[1][:, 0] == keys[:16]).mean()
    hit_carried = (carried(j, tmesh).search(vecs[:16], 1, ef=32)[1][:, 0]
                   == keys[:16]).mean()
    assert hit_carried >= hit_jax


def _delete_compact_grow(idx, vecs, keys, more):
    """tests/test_sharded.py's delete/compact/grow lifecycle, with its
    floors; returns the searches' keys."""
    n = len(keys)
    dead = keys[100:160]
    assert idx.remove(dead) == 60
    assert len(idx) == n - 60
    got = [idx.search(vecs[100:110], 2, ef=32)[1]]
    assert not np.isin(got[0], dead).any()
    idx.compact()
    assert len(idx) == n - 60
    got.append(idx.search(vecs[:8], 1, ef=32)[1])
    assert (got[1][:, 0] == keys[:8]).mean() >= 0.75
    idx.add(vecs[100:160] + 0.01, dead + 10_000)  # reuses compacted slots
    assert len(idx) == n
    idx.reserve(4096)
    assert idx.cap == 4096
    idx.add(more, 50_000 + np.arange(len(more), dtype=np.int64))
    got.append(idx.search(more[:4], 1, ef=32)[1])
    assert (got[2][:, 0] >= 50_000).all()
    return got


def test_sharded_delete_compact_grow(jmesh, tmesh):
    rng = np.random.default_rng(31)
    n, d = 512, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    more = rng.normal(size=(64, d)).astype(np.float32)
    keys = np.arange(n, dtype=np.int64)
    own = tsh.ShardedHNSWIndex(d, HNSWConfig(**SMALL), tmesh,
                               capacity_per_shard=1024, build_batch=64)
    own.add(vecs, keys)
    _delete_compact_grow(own, vecs, keys, more)
    # the same steps on one graph: the removal, the compaction and the
    # slot reuse are bookkeeping, equal bit for bit
    j = jsh.ShardedHNSWIndex(d, JConfig(**SMALL), jmesh,
                             capacity_per_shard=1024, build_batch=64)
    j.add(vecs, keys)
    t = carried(j, tmesh)
    for idx in (j, t):
        idx.remove(keys[100:160])
    assert_same_state(t, j)
    for idx in (j, t):
        idx.isolate()
    assert_same_state(t, j)
    for idx in (j, t):
        idx.compact()
    assert_same_state(t, j)
    assert t.stats() == j.stats()
    for idx in (j, t):
        idx.add(vecs[100:160] + 0.01, keys[100:160] + 10_000)
        idx.reserve(4096)
    assert_same_state(t, j, skip=("_vec_sq",) + FIELDS[:4])
    hit = {}
    for name, idx in (("jax", j), ("port", t)):
        idx.add(more, 50_000 + np.arange(64, dtype=np.int64))
        hit[name] = (idx.search(more[:4], 1, ef=32)[1][:, 0] >= 50_000).mean()
    assert hit["port"] >= hit["jax"]


def test_sharded_persist_roundtrip(tmesh, tmp_path):
    rng = np.random.default_rng(37)
    n, d = 512, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    keys = np.arange(n, dtype=np.int64) * 7
    idx = tsh.ShardedHNSWIndex(d, HNSWConfig(**SMALL), tmesh,
                               capacity_per_shard=1024, build_batch=64)
    idx.add(vecs, keys)
    idx.remove(keys[:10])
    path = str(tmp_path / "sharded.vss")
    idx.save(path)
    idx2 = tsh.ShardedHNSWIndex.load(path, tmesh)
    assert len(idx2) == len(idx)
    q = vecs[20:36]
    s1, k1 = idx.search(q, 3, ef=32)
    s2, k2 = idx2.search(q, 3, ef=32)
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(s1, s2)
    assert (idx2.placement.assign == idx.placement.assign).all()


def test_sharded_bf16_scalar_kind(jmesh, tmesh, tmp_path):
    v, _ = clustered(41, 1024, 0, 32, n_centers=16, sigma=0.2)
    keys = np.arange(len(v), dtype=np.int64)
    t = tsh.ShardedHNSWIndex(32, HNSWConfig(), tmesh, capacity_per_shard=512,
                             build_batch=64, scalar_kind="bf16")
    t.add(v, keys)
    assert t._vectors.dtype == torch.bfloat16
    q = v[:32]
    _, got = t.search(q, 5, ef=48)
    assert (got[:, 0] == keys[:32]).mean() >= 0.9
    path = str(tmp_path / "sh_bf16.vss")
    t.save(path)
    t2 = tsh.ShardedHNSWIndex.load(path, tmesh)
    assert t2.scalar_kind == "bf16" and t2._vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(t2.search(q, 5, ef=48)[1], got)
    # one graph on both sides: the JAX package's bf16 build, carried
    j = jsh.ShardedHNSWIndex(32, JConfig(), jmesh, capacity_per_shard=512,
                             build_batch=64, scalar_kind="bf16")
    j.add(v, keys)
    want = truth(v, q, 5)
    c = carried(j, tmesh)
    assert c._vectors.dtype == torch.bfloat16
    assert recall(c.search(q, 5, ef=48)[1], want) >= recall(
        j.search(q, 5, ef=48)[1], want)


def test_sharded_neighborhood_layout(recall_case, tmesh):
    """layout="neighborhood" on the CPU: the per-shard int8 tables and
    kernel K1's plain version, one call per shard per chunk, on the
    recall case's graph."""
    j, v, _ = recall_case
    idx = carried(j, tmesh, layout="neighborhood")
    calls = fb.beam_search_plain.calls
    _, keys = idx.search(v[:8], 5)
    assert fb.beam_search_plain.calls - calls == idx.n_shards
    assert float(np.mean(keys[:, 0] == np.arange(8))) >= 0.9
    # the auto layout's budget sums the tables of every shard on the device
    per_shard = idx.cap * idx.config.m0 * idx.d_pad
    idx.nbr_budget_bytes = per_shard * idx.n_shards
    assert all(t.fits(idx.nbr_budget_bytes) for t in idx.tables.values())
    idx.nbr_budget_bytes -= 1
    assert not any(t.fits(idx.nbr_budget_bytes)
                   for t in idx.tables.values())
    idx.layout = "auto"  # on the CPU: the bf16 traversal copy, no K1
    calls = fb.beam_search_plain.calls
    idx.search(v[:8], 5)
    assert fb.beam_search_plain.calls == calls


@pytest.mark.parametrize("s", [1, 4, 8])
@pytest.mark.parametrize("ef", [16, 64, 128])
def test_ef_local_policy_equals_jax(s, ef, monkeypatch):
    """The per-shard beam width the JAX search hands its SPMD program,
    read by a stand-in program, equals the port's policy, by default
    and with ef_local=ef."""
    k = 10
    seen = []

    def program(*args, k, ef, **kw):
        seen.append(ef)
        b = args[7].shape[0]
        return (np.zeros((b, k), np.float32), np.full((b, k), -1, np.int32))

    monkeypatch.setattr(jsh, "_search_sharded_hnsw", program)
    j = jsh.ShardedHNSWIndex(16, JConfig(), jsh.make_mesh(s, 1),
                             capacity_per_shard=1024)
    monkeypatch.setattr(j, "_tables", lambda: ((None, None), None))
    q = np.zeros((3, 16), np.float32)
    j.search(q, k, ef=ef)
    j.search(q, k, ef=ef, ef_local=ef)
    assert seen == [tsh.ef_local_policy(ef, k, s),
                    tsh.ef_local_policy(ef, k, s, ef_local=ef)]


# ---------------------------------------------------------------------------
# files, both ways
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def persisted(jmesh, tmp_path_factory):
    """A JAX-built index with tombstones and a free-list, saved."""
    rng = np.random.default_rng(43)
    n, d = 512, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    keys = np.arange(n, dtype=np.int64) * 7
    j = jsh.ShardedHNSWIndex(d, JConfig(**SMALL), jmesh,
                             capacity_per_shard=1024, build_batch=64)
    j.add(vecs, keys)
    j.remove(keys[:10])
    path = str(tmp_path_factory.mktemp("sh") / "jax.vss")
    j.save(path)
    return j, path, vecs[20:36]


def test_jax_file_loads_in_port(persisted, tmesh):
    j, path, q = persisted
    jl = jsh.ShardedHNSWIndex.load(path, jsh.make_mesh(4, 2))
    t = tsh.ShardedHNSWIndex.load(path, tmesh)
    assert_same_state(t, j, skip=("_vec_sq",))
    s_j, k_j = jl.search(q, 3, ef=32)
    s_t, k_t = t.search(q, 3, ef=32)
    bound = score_bound(q, np.asarray(j._vectors).reshape(-1, j.d_pad)
                        [:, :j.dims], "l2sq")
    assert_scores_within(s_t, s_j, bound, "l2sq")
    assert_same_ids_within_ties(k_t, k_j, s_j, 2 * bound, "l2sq")


def test_port_file_loads_in_jax(persisted, tmesh, tmp_path):
    """The port saves the JAX index's carried state byte for byte as the
    JAX package does, and the JAX package loads it."""
    j, jax_path, q = persisted
    t = carried(j, tmesh)
    path = str(tmp_path / "port.vss")
    t.save(path)
    with open(path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    jl = jsh.ShardedHNSWIndex.load(path, jsh.make_mesh(4, 2))
    assert_same_state(t, jl, skip=("_vec_sq",))
    np.testing.assert_array_equal(jl.search(q, 3, ef=32)[1],
                                  j.search(q, 3, ef=32)[1])


def test_port_file_reloads_bit_for_bit(tmesh, tmp_path):
    """A port-built index (every norm summed by numpy) with tombstones, a
    compaction and a free-list reloads to the same arrays and searches
    to the same keys and scores, bit for bit."""
    rng = np.random.default_rng(47)
    n, d = 512, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    keys = np.arange(n, dtype=np.int64) * 7
    t = tsh.ShardedHNSWIndex(d, HNSWConfig(**SMALL), tmesh,
                             capacity_per_shard=1024, build_batch=64)
    t.add(vecs, keys)
    t.remove(keys[:20])
    t.compact()
    t.remove(keys[30:35])
    path = str(tmp_path / "port.vss")
    t.save(path)
    t2 = tsh.ShardedHNSWIndex.load(path, tmesh)
    a, b = sharded_to_arrays(t), sharded_to_arrays(t2)
    for name in a:
        if name == "_free_slots":
            assert [list(f) for f in a[name]] == [list(f) for f in b[name]]
        else:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    q = vecs[40:56]
    s1, k1 = t.search(q, 3, ef=32)
    s2, k2 = t2.search(q, 3, ef=32)
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(s1, s2)
