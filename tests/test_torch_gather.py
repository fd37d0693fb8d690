"""Port parity: kernel K2's module (ops/fused_gather.py) against the JAX
package.

On the CPU the wrapper runs the kernel's plain PyTorch version, because
the tensors lie on the CPU. It is held against
``duckdb_vss_tpu.models.graph.gather_scores`` at Precision.HIGHEST
(rtol/atol 1e-5: f32 sums in another order; the JAX function reads the
cached norms, the kernel sums them from the row) and, once, against the
TPU kernel itself in interpret mode. INF_SCORE must stand exactly where
id < 0. The CUDA kernel is compared with the plain version on the card
by the gpu-marked test and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from duckdb_vss_tpu.models.graph import gather_scores as j_gather_scores
from duckdb_vss_tpu.ops.pallas_gather import gather_scores_pallas
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch.ops import fused_gather as fg
from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.padding import INF_SCORE

torch.set_num_threads(2)


def _inputs(seed, n=512, d=128, b=9, c=40):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, d)).astype(np.float32)
    v[5] = 0.0  # a zero row: cosine's zero-norm case
    q = rng.normal(size=(b, d)).astype(np.float32)
    q[2] = 0.0  # a zero query
    ids = rng.integers(0, n, size=(b, c)).astype(np.int32)
    ids[rng.random((b, c)) < 0.2] = -1
    ids[:, 3] = 5  # every query meets the zero row
    ids[4] = -1  # a row with no candidate at all
    return v, q, ids


@pytest.mark.parametrize("metric", ["l2sq", "ip", "cosine"])
@pytest.mark.parametrize("d", [128, 256])
def test_gather_scores_plain_matches_jax(metric, d):
    v, q, ids = _inputs(11, d=d)
    v_sq, q_sq = (v * v).sum(1), (q * q).sum(1)
    want = np.asarray(j_gather_scores(
        jnp.asarray(v), jnp.asarray(v_sq), jnp.asarray(ids), jnp.asarray(q),
        jnp.asarray(q_sq), JMetric(metric), precision=lax.Precision.HIGHEST))
    calls = fg.gather_scores_plain.calls
    got = fg.gather_scores_kernel(
        torch.from_numpy(v), torch.from_numpy(ids), torch.from_numpy(q),
        torch.from_numpy(q_sq), MetricKind(metric)).numpy()
    assert fg.gather_scores_plain.calls == calls + 1  # CPU tensors
    live = ids >= 0
    assert live.any() and (~live).any()
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)
    assert (got[~live] == np.float32(INF_SCORE)).all()
    if metric == "cosine":
        zero_row = ids[2] == 5
        assert (got[2][live[2] & ~zero_row] == 1.0).all()  # zero query only
        assert (got[2][zero_row] == 0.0).all()  # zero query, zero row
        assert got[0, 3] == 1.0  # zero row only


def test_gather_scores_plain_matches_pallas_interpret():
    """The TPU kernel itself, in interpret mode (one case: it unrolls
    2 x 8 x 128 row copies). atol/rtol 1e-4: both sum the row's norm."""
    v, q, ids = _inputs(12, b=8, c=40)
    q_sq = (q * q).sum(1)
    want = np.asarray(gather_scores_pallas(
        jnp.asarray(v), jnp.asarray(ids), jnp.asarray(q), jnp.asarray(q_sq),
        JMetric.L2SQ, interpret=True))
    got = fg.gather_scores_plain(
        torch.from_numpy(v), torch.from_numpy(ids), torch.from_numpy(q),
        torch.from_numpy(q_sq), MetricKind.L2SQ).numpy()
    live = ids >= 0
    np.testing.assert_allclose(got[live], want[live], rtol=1e-4, atol=1e-4)
    assert (got[~live] == np.float32(INF_SCORE)).all()
    assert (want[~live] == np.float32(INF_SCORE)).all()


def test_gather_scores_kernel_rejects_what_it_does_not_take():
    """The CUDA wrapper raises on a wrong device; the shape and dtype
    checks need CUDA tensors and run in the gpu-marked test."""
    v, q, ids = _inputs(13)
    meta = torch.from_numpy(v).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fg.gather_scores_kernel(meta, torch.from_numpy(ids),
                                torch.from_numpy(q),
                                torch.from_numpy((q * q).sum(1)),
                                MetricKind.L2SQ)
    with pytest.raises(ValueError, match="unknown metric"):
        fg.gather_scores_plain(torch.from_numpy(v), torch.from_numpy(ids),
                               torch.from_numpy(q),
                               torch.from_numpy((q * q).sum(1)), "hamming")


@pytest.mark.gpu
def test_gather_scores_kernel_on_card():
    """K2 against its plain version on the card, and its input checks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu "
                    "tests/test_torch_gather.py` on the GPU machine")
    import chip_smoke

    dev = torch.device("cuda")
    errs = chip_smoke.gather_checks_random(dev)
    assert set(errs) == {"l2sq", "ip", "cosine"}
    chip_smoke.gather_rejects(dev)
