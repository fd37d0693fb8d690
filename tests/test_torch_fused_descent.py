"""Port parity: kernel K3's module (ops/fused_descent.py), the search's
upper-level descent, and mxu_descent around it.

On the CPU the wrapper runs the kernel's plain PyTorch version (flat_topk
over blocks of the upper table, the descent's body before the kernel),
because the tensors lie on the CPU. It is held here to the contract the
kernel keeps: each query's n_seeds smallest scores over the live rows,
equal scores to the lowest slot, INF_SCORE past the live rows. On
integer data every score is exact in f32, so a numpy oracle in float64
gives the same scores bit for bit, ties included; on random data
mxu_descent is held to the JAX package's within rounding ties. The CUDA
kernel is held to the plain version on the card by the gpu-marked tests
and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_vss_tpu.models.graph import mxu_descent as j_mxu_descent
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch.models.graph import mxu_descent
from duckdb_vss_tpu_torch.ops import fused_descent as fd
from duckdb_vss_tpu_torch.ops.cuda_build import MAX_SMEM_BYTES
from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.padding import INF_SCORE
from tests.test_torch_topk import assert_same_ids_within_ties, score_bound

torch.set_num_threads(2)

N_SEEDS = 8


def _integer_table(seed, u, d=128, b=6, dead=0.1):
    """Small integers (exact in bf16, their products and sums exact in
    f32), a tenth of the rows dead, and planted equal scores: rows 3, 11
    and 40 repeat row 5, so every query scores them alike."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-3, 4, size=(u, d)).astype(np.float32)
    for r in (3, 11, 40):
        v[r] = v[5]
    nodes = np.arange(u, dtype=np.int32)
    nodes[rng.random(u) < dead] = -1
    nodes[[3, 5, 11, 40]] = [3, 5, 11, 40]
    q = rng.integers(-3, 4, size=(b, d)).astype(np.float32)
    q[1] = v[5]  # the planted rows are this query's best
    return q, v, nodes


def _oracle(q, v, nodes, k, metric):
    """Exact (score, slot) order in float64: ascending scores, the lowest
    slot first among equal ones, INF_SCORE past the live rows."""
    dot = q.astype(np.float64) @ v.astype(np.float64).T
    if metric == MetricKind.IP:
        s = 1.0 - dot
    else:
        s = np.maximum((q.astype(np.float64) ** 2).sum(1)[:, None] - 2 * dot
                       + (v.astype(np.float64) ** 2).sum(1)[None, :], 0.0)
    s = np.where(nodes[None, :] >= 0, s, np.inf)
    order = np.argsort(s, axis=1, kind="stable")[:, :k]
    got = np.take_along_axis(s, order, 1)
    return np.where(np.isfinite(got), got, INF_SCORE), order


def _plain(q, v, nodes, k, metric):
    t = torch.from_numpy(v)
    nd = torch.from_numpy(nodes)
    sq = (t * t).sum(1) * (nd >= 0)
    return fd.fused_descent(torch.from_numpy(q), t.to(torch.bfloat16), sq,
                            nd, k, metric)


@pytest.mark.parametrize("metric", [MetricKind.L2SQ, MetricKind.IP])
@pytest.mark.parametrize("u", [1000, 20_000])
def test_descent_exact_on_integer_data(metric, u):
    """Scores and slots equal to the exact order on data where f32 is
    exact: a row count that is no multiple of any tile (1000), one of
    several blocks (20,000), dead rows, and equal scores (the planted
    rows) resolved to the lowest slot."""
    q, v, nodes = _integer_table(u, u)
    s, i = _plain(q, v, nodes, N_SEEDS, metric)
    want_s, want_i = _oracle(q, v, nodes, N_SEEDS, metric)
    np.testing.assert_array_equal(s.numpy(), want_s.astype(np.float32))
    live = want_s < INF_SCORE
    np.testing.assert_array_equal(i.numpy()[live], want_i[live])
    if metric == MetricKind.L2SQ:  # query 1 is row 5: 5 and its copies
        assert i.numpy()[1, :4].tolist() == [3, 5, 11, 40]


@pytest.mark.parametrize("metric", ["l2sq", "ip", "cosine"])
def test_mxu_descent_matches_jax(metric):
    """mxu_descent's seeds against the JAX package's on random data: the
    same nodes wherever no rounding tie can reorder them."""
    rng = np.random.default_rng(7)
    u, d, b = 4096, 128, 12
    v = rng.normal(size=(u, d)).astype(np.float32)
    v[9] = 0.0  # a zero row: cosine's zero-norm rule
    nodes = np.where(rng.random(u) < 0.1, -1,
                     rng.permutation(10 * u)[:u]).astype(np.int32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    sq = ((v * v).sum(1) * (nodes >= 0)).astype(np.float32)
    m = MetricKind(metric)
    got, nd = mxu_descent(
        torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(sq),
        torch.from_numpy(nodes), torch.tensor(-5, dtype=torch.int32),
        torch.from_numpy(q), m, N_SEEDS)
    want, want_nd = j_mxu_descent(
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(sq), jnp.asarray(nodes),
        jnp.int32(-5), jnp.asarray(q), jnp.asarray((q * q).sum(1)),
        JMetric(metric), N_SEEDS)
    assert int(nd) == int(want_nd) == int((nodes >= 0).sum()) * b
    s, _ = _plain(q, v, nodes, N_SEEDS, m)
    tol = 2.0 * score_bound(q, v, metric)
    assert_same_ids_within_ties(got.numpy(), np.asarray(want), s.numpy(),
                                tol, metric)


def test_mxu_descent_fewer_live_rows_than_seeds():
    """Five live rows of 300: those five nodes in score order, then -1;
    the fallback to the entry node only where no row lives."""
    q, v, nodes = _integer_table(3, 300, b=4)
    nodes[:] = -1
    live = [7, 50, 120, 121, 299]
    nodes[live] = np.array(live) + 1000
    sq = torch.from_numpy((v * v).sum(1) * (nodes >= 0))
    seeds, nd = mxu_descent(
        torch.from_numpy(v).to(torch.bfloat16), sq, torch.from_numpy(nodes),
        torch.tensor(42, dtype=torch.int32), torch.from_numpy(q),
        MetricKind.L2SQ, N_SEEDS)
    _, order = _oracle(q, v, nodes, 5, MetricKind.L2SQ)
    np.testing.assert_array_equal(seeds.numpy()[:, :5], order + 1000)
    assert (seeds.numpy()[:, 5:] == -1).all()
    assert int(nd) == 5 * 4


def test_mxu_descent_empty_upper_level():
    """No upper level yet: every seed is the entry node."""
    q, v, nodes = _integer_table(4, 256, b=3)
    nodes[:] = -1
    seeds, nd = mxu_descent(
        torch.from_numpy(v).to(torch.bfloat16), torch.zeros(256),
        torch.from_numpy(nodes), torch.tensor(17, dtype=torch.int32),
        torch.from_numpy(q), MetricKind.L2SQ, N_SEEDS)
    assert (seeds.numpy() == 17).all() and int(nd) == 0


@pytest.mark.parametrize("b, u, slots, want", [
    (8192, 65_536, 132, 4),  # a batch chunk: 32 query tiles x 4
    (1808, 65_536, 132, 16),  # the last chunk of a 10,000-query call
    (256, 393_216, 132, 128),  # an insert step over the upper-slot table
    (1, 65_536, 132, 128),  # a statement: one query, the most slices
    (1, 300, 132, 5),  # never more slices than 64-row tiles
    (100_000, 65_536, 132, 1),  # more query tiles than blocks
])
def test_descent_slices_fill_the_card(b, u, slots, want):
    """The table's slices come from B and U alone: with the query tiles
    (256 queries a block at d = 128) they fill the card's resident
    blocks once."""
    warps = fd.block_warps(128, N_SEEDS)
    assert warps == 16
    assert fd.n_slices(b, u, warps, slots) == want


def test_descent_plan_fits_and_checks():
    """Every width and seed count the wrapper takes fits one block's
    shared memory, and MAX_D is the widest that does; what it does not
    take raises (on the card: the plain version on the CPU takes any)."""
    for d in range(128, fd.MAX_D + 1, 128):
        for k in (1, 8, 9, 32):
            w = fd.block_warps(d, k)
            assert fd.smem_bytes(w, d) <= MAX_SMEM_BYTES
    assert fd.smem_bytes(1, fd.MAX_D + 128) > MAX_SMEM_BYTES
    assert fd.MAX_D >= 4096  # 1,536-, 3,072- and 4,096-d embeddings
    assert [fd.block_warps(d, 8) for d in (128, 256, 1024, 2048, 4096)] == [
        16, 8, 4, 2, 1]
    for d, k in ((96, 8), (fd.MAX_D + 128, 8), (128, 0), (128, 33)):
        with pytest.raises(ValueError):
            fd.block_warps(d, k)


def test_fused_descent_rejects_other_devices():
    q, v, nodes = _integer_table(5, 256, b=2)
    t = torch.from_numpy(v).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fd.fused_descent(torch.from_numpy(q).to("meta"), t, t[:, 0],
                         torch.from_numpy(nodes).to("meta"), 8,
                         MetricKind.L2SQ)


@pytest.mark.parametrize("first, other", [("fused_descent", "fused_beam"),
                                          ("fused_beam", "fused_descent")])
def test_first_search_kernel_builds_both(monkeypatch, first, other):
    """Whichever of K1 and K3 loads first builds both in one nvcc call
    when both are stale, so a fresh checkout pays one build time; one
    that is built already is left alone."""
    from duckdb_vss_tpu_torch.ops import cuda_build

    built = []
    monkeypatch.setattr(cuda_build, "build", built.append)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    for other_stale, want in ((True, [first, other]), (False, [first])):
        built.clear()
        monkeypatch.setattr(cuda_build, "stale", lambda name, s=other_stale: (
            name == first or s))
        cuda_build.load(first)
        assert built == [want]
    built.clear()
    monkeypatch.setattr(cuda_build, "stale", lambda name: False)
    lib = cuda_build.load(first)
    assert lib.endswith(f"lib{first}.so") and built == []


def test_other_kernel_builds_alone(monkeypatch):
    """A kernel outside SEARCH_KERNELS (K2) builds only itself, even
    when the search kernels are stale."""
    from duckdb_vss_tpu_torch.ops import cuda_build

    built = []
    monkeypatch.setattr(cuda_build, "build", built.append)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(cuda_build, "stale", lambda name: True)
    assert "gather_scores" not in cuda_build.SEARCH_KERNELS
    cuda_build.load("gather_scores")
    assert built == [["gather_scores"]]


def test_plain_version_counts_no_kernel_queries():
    """The trace counter of K3's engagement counts launches only: a
    descent that runs the plain version, as every one on the CPU does,
    adds nothing to it while the profiler records."""
    from duckdb_vss_tpu_torch.utils import tracing

    q, v, nodes = _integer_table(8, 256, b=3)
    tracing.reset_counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        mxu_descent(torch.from_numpy(v).to(torch.bfloat16),
                    torch.from_numpy((v * v).sum(1)), torch.from_numpy(nodes),
                    torch.tensor(0, dtype=torch.int32), torch.from_numpy(q),
                    MetricKind.L2SQ, N_SEEDS)
        got = tracing.counters()
    tracing.reset_counters()
    assert "descent.kernel_queries" not in got


def test_plain_version_counts_its_calls():
    q, v, nodes = _integer_table(6, 256, b=2)
    calls, launches = fd.fused_descent_plain.calls, fd.fused_descent.launches
    _plain(q, v, nodes, N_SEEDS, MetricKind.L2SQ)
    assert fd.fused_descent_plain.calls == calls + 1
    assert fd.fused_descent.launches == launches


@pytest.mark.gpu
def test_fused_descent_on_card():
    """K3 against its plain version on the card: B of 1, 256, 1,808 and
    8,192, 65,536 rows and 65,488 (no multiple of the 128-row tile), then
    the plans of wider rows (8, 4, 2 and 1 warps a block), k of 4, 16
    and 32, and the insert cell's step (256 rows, 393,216 mostly dead),
    all three metrics (chip_smoke.descent_checks_random, whose
    tolerance, descent_bound, states why)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu "
                    "tests/test_torch_fused_descent.py` on the GPU machine")
    import chip_smoke

    ratios = chip_smoke.descent_checks_random(torch.device("cuda"))
    want = 3 * (8 + len(chip_smoke.DESCENT_PLAN_CASES))
    assert len(ratios) == want and max(ratios.values()) <= 1.0


@pytest.mark.gpu
def test_search_on_card_goes_through_k3():
    """One HNSWIndex.search on the card raises K3's launch count and
    never runs its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu "
                    "tests/test_torch_fused_descent.py` on the GPU machine")
    import chip_smoke

    chip_smoke.descent_engaged(torch.device("cuda"))
