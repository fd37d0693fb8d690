"""Port parity: the entry module (duckdb_vss_tpu_torch.entry) against the
JAX package's entry module (__graft_entry__.py), and one graph per seed
from the bulk build.

- entry: the JAX entry's nine arguments are carried through numpy into
  the port's tensors (utils/convert) and the port's step runs on them.
  The final rerank is an exact f32 path, so ids must be equal wherever
  the score bound of tests/test_torch_topk.py separates the JAX
  package's neighbouring scores, and scores within that bound; the beam
  before it scores the same bf16 table in the same order, so n_dist is
  equal. The port's own entry(device="cpu") builds its own graph and
  must reach the JAX entry's recall on its own graph, less 0.02;
- dryrun_multichip runs its own asserts (the JAX function's) on 1, 2, 4
  and 8 shards of one device;
- reproducibility: two bulk builds on one seed through the IVF sweep
  give equal graph arrays and an equal n_distances, in both packages.
  The centre sums of k-means are the op that decides it: the port's
  equal the JAX package's bit for bit, since both add each centre's
  rows one after another in slot order.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_vss_tpu.models import bulk as jbulk
from duckdb_vss_tpu.utils.config import HNSWConfig as JConfig
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch import entry as tentry
from duckdb_vss_tpu_torch.models import bulk as tbulk
from duckdb_vss_tpu_torch.models.graph import GraphState
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.convert import device_tensor
from test_torch_bulk import _store
from test_torch_topk import (assert_same_ids_within_ties,
                             assert_scores_within, score_bound)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__  # noqa: E402

torch.set_num_threads(2)

# the dtypes of the entry's arguments after the GraphState
ARG_DTYPES = (torch.float32, torch.float32, torch.bool, torch.float32,
              torch.bfloat16, torch.bfloat16, torch.float32, torch.int32)


@pytest.fixture(scope="module")
def jax_entry():
    fn, args = __graft_entry__.entry()
    scores, ids, n_dist = jax.device_get(jax.jit(fn)(*args))
    return args, np.asarray(scores), np.asarray(ids), int(n_dist)


def _to_port(args):
    """The JAX entry's arguments as the port's CPU tensors."""
    state = GraphState(**{f: device_tensor(np.asarray(getattr(args[0], f)),
                                           torch.int32, "cpu")
                          for f in GraphState._fields})
    return (state,) + tuple(device_tensor(np.asarray(a), dt, "cpu")
                            for a, dt in zip(args[1:], ARG_DTYPES))


def _recall(ids, vectors, valid, queries, k=10):
    """recall@k of slot ids against the exact l2sq scan of the live rows."""
    v = vectors[valid].astype(np.float64)
    q = queries.astype(np.float64)
    d2 = (q * q).sum(1)[:, None] - 2.0 * q @ v.T + (v * v).sum(1)[None]
    want = np.nonzero(valid)[0][np.argsort(d2, axis=1, kind="stable")[:, :k]]
    return float(np.mean([len(set(g) & set(w)) / k
                          for g, w in zip(ids.tolist(), want.tolist())]))


def test_entry_step_matches_jax_on_its_graph(jax_entry):
    args, j_s, j_i, j_nd = jax_entry
    t_args = _to_port(args)
    t_s, t_i, t_nd = tentry.search_step(*t_args)
    t_s, t_i = t_s.numpy(), t_i.numpy()
    assert t_s.shape == t_i.shape == (8, 10)
    q = np.asarray(args[4])
    bound = score_bound(q, np.asarray(args[1]), "l2sq")
    assert_scores_within(t_s, j_s, bound, "l2sq")
    assert_same_ids_within_ties(t_i, j_i, j_s, 2 * bound, "l2sq")
    assert int(t_nd) == j_nd


def test_entry_runs_on_the_cpu(jax_entry):
    args, _, j_i, _ = jax_entry
    fn, t_args = tentry.entry(device="cpu")
    assert len(t_args) == 9
    scores, ids, _ = fn(*t_args)
    s, i = scores.numpy(), ids.numpy()
    assert s.shape == i.shape == (8, 10)
    assert (s[:, 1:] >= s[:, :-1] - 1e-5).all()
    assert (i >= 0).all()
    got = _recall(i, t_args[1].numpy(), t_args[3].numpy(),
                  t_args[4].numpy())
    want = _recall(j_i, np.asarray(args[1]), np.asarray(args[3]),
                   np.asarray(args[4]))
    assert got >= want - 0.02, (got, want)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_dryrun_multichip(n_devices, capsys):
    tentry.dryrun_multichip(n_devices, device="cpu")
    shards = n_devices // (2 if n_devices % 2 == 0 and n_devices >= 4
                           else 1)
    assert capsys.readouterr().out.strip().endswith(f"n={64 * shards}")


def test_entry_defaults_to_the_card():
    """No CPU fallback: without a CUDA device the default raises."""
    if torch.cuda.is_available():
        fn, args = tentry.entry()
        assert args[1].is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        tentry.dryrun_multichip(2)


N_REPRO = 8192  # knn="ivf" runs the k-means at any size (64 centres)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_ivf_build_is_the_same_twice(package, monkeypatch):
    """Two bulk builds on one seed give one graph. The JAX case states
    the contract the port keeps on the card (chip_smoke.py checks it
    there at 1M rows)."""
    monkeypatch.setenv("DVT_BUILD_KNN", "ivf")
    v, store, sq, levels = _store(3, N_REPRO, 32)
    slots = np.arange(N_REPRO, dtype=np.int32)

    def build():
        stats = {}
        if package == "port":
            g = tbulk.bulk_build(torch.from_numpy(store),
                                 torch.from_numpy(sq), slots, levels,
                                 HNSWConfig(), MetricKind.L2SQ,
                                 host_vectors=v, stats_out=stats, knn="ivf")
        else:
            g = jbulk.bulk_build(jnp.asarray(store), jnp.asarray(sq), slots,
                                 levels, JConfig(), JMetric.L2SQ,
                                 host_vectors=v, stats_out=stats)
        return ({f: np.asarray(getattr(g, f)) for f in GraphState._fields},
                stats["n_distances"])

    (first, nd1), (second, nd2) = build(), build()
    for f in GraphState._fields:
        np.testing.assert_array_equal(first[f], second[f], err_msg=f)
    assert nd1 == nd2


@pytest.mark.parametrize("crowded", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_kmeans_sums_in_the_stated_order(normalize, crowded):
    """The centre sums add each centre's rows one after another from
    zero in slot-chunk order: equal bit for bit to numpy's unbuffered
    sequential add of the same rows, and to the JAX package's
    scatter-add on the CPU. Normalized rows are scaled by rsqrt, which
    XLA and torch round differently in the last bit, so there
    the assignments and counts are compared with the JAX package's.
    ``crowded`` puts every row in one centre, more rows than a chunk,
    which the sums then take alone."""
    rng = np.random.default_rng(7)
    n, d, c, ab = 6000, 32, 64, 2048
    _, store, sq, _ = _store(9, n, d)
    chunks = np.full((3 * ab,), -1, np.int32)
    chunks[:n] = rng.permutation(n)
    chunks = chunks.reshape(3, ab)
    init = store[chunks[0, :c]]
    if crowded:
        init[1:] = 1e3
    if normalize:
        init = init / np.sqrt((init * init).sum(1, keepdims=True))
    t_store, t_sq = torch.from_numpy(store), torch.from_numpy(sq)
    t_c, t_a, t_n = tbulk._kmeans_pass(t_store, t_sq,
                                       torch.from_numpy(chunks),
                                       torch.from_numpy(init), normalize)
    rows = chunks.reshape(-1)[:n]
    x = tbulk._kmeans_rows(t_store, t_sq, torch.from_numpy(rows),
                           normalize).numpy()
    asg = t_a.numpy()[:n]
    sums = np.zeros((c, store.shape[1]), np.float32)
    np.add.at(sums, asg, x)
    counts = np.bincount(asg, minlength=c)
    np.testing.assert_array_equal(t_n.numpy(), counts)
    means = sums / np.float32(np.maximum(counts, 1))[:, None]
    np.testing.assert_array_equal(
        t_c.numpy(), np.where((counts > 0)[:, None], means, init))
    j_c, j_a, j_n = jax.device_get(jbulk._kmeans_pass(
        jnp.asarray(store), jnp.asarray(sq), jnp.asarray(chunks),
        jnp.asarray(init), normalize))
    np.testing.assert_array_equal(t_a.numpy(), np.asarray(j_a))
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    if not normalize:
        np.testing.assert_array_equal(t_c.numpy(), np.asarray(j_c))
