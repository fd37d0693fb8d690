"""Port parity: the measured CPU baseline (duckdb_vss_tpu_torch.utils.
cpu_baseline, native/cpu_hnsw.cpp compiled into build/native/ for this
host) against the JAX package's, on one graph: a JAX-built index carried
into the port (convert.index_from_arrays).

The two bindings run one C++ source built twice (the JAX package loads
the committed native/libcpu_hnsw.so, the port compiles its own for this
host), so floating-point code generation may differ: the ids must agree
on at least 99% of (query, rank) pairs. Recall and tombstone filtering
are held to the JAX test's floors.
"""

import numpy as np
import pytest
import torch

from duckdb_vss_tpu.models.hnsw import HNSWIndex as JHNSW
from duckdb_vss_tpu.utils import cpu_baseline as jcb
from duckdb_vss_tpu.utils.config import HNSWConfig as JConfig
from duckdb_vss_tpu_torch.utils import cpu_baseline as tcb
from duckdb_vss_tpu_torch.utils.config import HNSWConfig
from duckdb_vss_tpu_torch.utils.convert import index_from_arrays
from test_torch_hnsw_api import jax_arrays
from test_torch_sharded import clustered, recall, truth

torch.set_num_threads(2)

N, D, K = 8000, 32, 10


@pytest.fixture(scope="module")
def indexes():
    """A JAX index, its port copy, the data and the exact top-k."""
    v, q = clustered(42, N, 200, D)
    j = JHNSW(D, JConfig(), capacity=N)
    j.add(v, np.arange(N))
    t = index_from_arrays(jax_arrays(j), HNSWConfig(), device="cpu")
    return j, t, v, q, truth(v, q, K)


def test_cpu_baseline_equals_jax(indexes):
    j, t, _, q, gt = indexes
    ids_t, secs = tcb.CPUBaseline(t).search(q, K, ef=64, n_threads=2)
    ids_j, _ = jcb.CPUBaseline(j).search(q, K, ef=64, n_threads=2)
    assert secs > 0
    assert (ids_t == ids_j).mean() >= 0.99
    assert recall(ids_t, gt) > 0.9


def test_cpu_baseline_filters_tombstones(indexes):
    j, t, v, q, gt = indexes
    dead = gt[:50, 0]
    t2 = index_from_arrays(jax_arrays(j), HNSWConfig(), device="cpu")
    assert t2.remove(dead) == len(np.unique(dead))
    ids, _ = tcb.CPUBaseline(t2).search(q[:50], K, ef=64, n_threads=2)
    assert not np.isin(ids, dead).any()


def test_cpu_baseline_bf16_store_is_upcast(indexes):
    """A bf16 store crosses as f32 rows: the baseline searches the
    rounded rows and still finds the neighbours."""
    j, _, v, q, gt = indexes
    arrays = jax_arrays(j)
    rows = torch.from_numpy(np.array(arrays["_vectors"])).to(
        torch.bfloat16)
    arrays["_vectors"] = rows.view(torch.int16).numpy().view(np.uint16)
    t = index_from_arrays(arrays, HNSWConfig(), device="cpu")
    base = tcb.CPUBaseline(t)
    assert base.vectors.dtype == np.float32
    np.testing.assert_array_equal(base.vectors, rows.float().numpy())
    ids, _ = base.search(q, K, ef=64, n_threads=2)
    assert recall(ids, gt) > 0.9


def test_cpu_baseline_equals_jax_on_an_ivf_bulk_graph(monkeypatch):
    """On a graph the JAX package bulk-builds through its IVF kNN sweep
    (forced at this size, 32,768 rows of 1,024 tight clusters), both
    bindings return the same ids, and the baseline's one-entry greedy
    descent finds fewer neighbours than the engine's exact seeding of
    the same graph. This is what the baseline shows over the card's
    1M-row bulk-built graph."""
    n = 32_768
    v, q = clustered(46, n, 200, D, n_centers=1024)
    monkeypatch.setenv("DVT_BUILD_KNN", "ivf")
    j = JHNSW(D, JConfig(), capacity=n)
    j.add(v, np.arange(n))
    t = index_from_arrays(jax_arrays(j), HNSWConfig(), device="cpu")
    gt = truth(v, q, K)
    ids_t, _ = tcb.CPUBaseline(t).search(q, K, ef=64, n_threads=2)
    ids_j, _ = jcb.CPUBaseline(j).search(q, K, ef=64, n_threads=2)
    assert (ids_t == ids_j).mean() >= 0.99
    engine = recall(np.asarray(j.search(q, K)[1]), gt)
    assert recall(ids_t, gt) < engine - 0.05


def test_cpu_baseline_own_build():
    """The baseline's own insertion build (cpu_hnsw_build), at the JAX
    test's floor."""
    v, q = clustered(44, N, 200, D)
    rng = np.random.default_rng(45)
    levels = np.minimum(np.floor(-np.log(np.maximum(rng.random(N), 1e-12))
                                 / np.log(16.0)), 8).astype(np.int32)
    base, build_s = tcb.CPUBaseline.build(v, levels, m=16, m0=32,
                                          ef_construction=128, n_threads=2)
    assert build_s > 0
    ids, _ = base.search(q, K, ef=32, n_threads=2)
    assert recall(ids, truth(v, q, K)) > 0.93


def test_library_is_built_for_this_host():
    """The port loads its own build under build/native/, never the
    committed native/libcpu_hnsw.so."""
    lib = tcb.get_lib()
    assert tcb.LIB_BUILT.exists()
    assert lib._name == str(tcb.LIB_BUILT)
    assert tcb.LIB_BUILT.stat().st_mtime >= tcb.LIB_SOURCE.stat().st_mtime
