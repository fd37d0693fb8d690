"""Port parity: duckdb_vss_tpu_torch.ops.distance against the JAX package.

Same numpy inputs through both; exact f32 products on both sides (JAX at
Precision.HIGHEST, the port with TF32 off), so scores agree to f32
rounding of different summation orders (rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_vss_tpu.ops import distance as jd
from duckdb_vss_tpu.utils.config import MetricKind as JMetric
from duckdb_vss_tpu_torch.ops import distance as td
from duckdb_vss_tpu_torch.utils.config import MetricKind

torch.set_num_threads(2)


def _inputs(seed, b=37, n=300, d=48):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, d)).astype(np.float32)
    v = rng.normal(size=(n, d)).astype(np.float32)
    # zero-norm rows on both sides exercise cosine's special cases
    q[3] = 0.0
    v[[5, 17]] = 0.0
    return q, v


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_score_matrix_matches_jax(metric):
    q, v = _inputs(1)
    want = np.asarray(jd.score_matrix(jnp.asarray(q), jnp.asarray(v),
                                      JMetric(metric)))
    got = td.score_matrix(torch.from_numpy(q), torch.from_numpy(v),
                          MetricKind(metric)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_score_matrix_precomputed_norms(metric):
    q, v = _inputs(2)
    q_sq, v_sq = (q * q).sum(1), (v * v).sum(1)
    want = np.asarray(jd.score_matrix(
        jnp.asarray(q), jnp.asarray(v), JMetric(metric),
        vec_sq=jnp.asarray(v_sq), query_sq=jnp.asarray(q_sq)))
    got = td.score_matrix(
        torch.from_numpy(q), torch.from_numpy(v), MetricKind(metric),
        vec_sq=torch.from_numpy(v_sq), query_sq=torch.from_numpy(q_sq)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cosine_zero_norm_cases():
    """usearch zero-norm semantics: both zero -> 0, exactly one -> 1."""
    q, v = _inputs(3)
    got = td.score_matrix(torch.from_numpy(q), torch.from_numpy(v),
                          MetricKind.COSINE).numpy()
    assert got[3, 5] == 0.0 and got[3, 17] == 0.0
    assert got[3, 0] == 1.0 and got[0, 5] == 1.0


def test_dot_and_norms_match_jax():
    q, v = _inputs(4)
    np.testing.assert_allclose(
        td.dot_scores(torch.from_numpy(q), torch.from_numpy(v)).numpy(),
        np.asarray(jd.dot_scores(jnp.asarray(q), jnp.asarray(v))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td.sq_norms(torch.from_numpy(v)).numpy(),
                               np.asarray(jd.sq_norms(jnp.asarray(v))),
                               rtol=1e-6)


def test_bf16_table_scores_like_jax():
    """A bf16 table scores bf16-rounded operands with f32 sums, as the JAX
    package's DEFAULT-precision bf16 products do."""
    q, v = _inputs(5)
    want = np.asarray(jd.score_matrix(
        jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16),
        JMetric.IP, precision=None))
    got = td.score_matrix(torch.from_numpy(q),
                          torch.from_numpy(v).to(torch.bfloat16),
                          MetricKind.IP).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_pair_scores_matches_jax(metric):
    """Row-aligned scores, zero-norm rows included (row 3 of q, rows 5
    and 17 of v): both sides sum 48 f32 products, rtol 1e-5."""
    q, v = _inputs(6)
    a, b = q, v[:37]
    want = np.asarray(jd.pair_scores(jnp.asarray(a), jnp.asarray(b),
                                     JMetric(metric)))
    got = td.pair_scores(torch.from_numpy(a), torch.from_numpy(b),
                         MetricKind(metric)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if metric == "cosine":
        z = torch.zeros((1, 8))
        x = torch.ones((1, 8))
        assert td.pair_scores(z, z, MetricKind.COSINE).item() == 0.0
        assert td.pair_scores(z, x, MetricKind.COSINE).item() == 1.0
        assert td.pair_scores(x, z, MetricKind.COSINE).item() == 1.0


@pytest.mark.parametrize("name", sorted(jd.SCALAR_FUNCTIONS))
def test_scalar_functions_match_jax(name):
    """The six SQL scalar functions on the same inputs (rtol 1e-5: f32
    sums in another order); array_value stacks scalars and columns."""
    jfn, tfn = jd.SCALAR_FUNCTIONS[name], td.SCALAR_FUNCTIONS[name]
    if name == "array_value":
        col = np.arange(5, dtype=np.float32)
        for args in ((1.0, 2.0, 3.0), (col, 2.0, col * 3)):
            np.testing.assert_array_equal(
                tfn(*args).numpy(), np.asarray(jfn(*args)), err_msg=str(args))
        return
    q, v = _inputs(7)
    a, b = q[:20], v[:20]
    want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
    got = tfn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # numpy arrays are taken as they are
    np.testing.assert_allclose(tfn(a, b).numpy(), got, rtol=0, atol=0)


@pytest.mark.parametrize("metric", ["l2sq", "cosine", "ip"])
def test_metric_score_to_function_value_matches_jax(metric):
    """Index scores turned into the SQL function's value equal the JAX
    package's conversion and the function itself (rtol 1e-4, as the JAX
    package's own test). No zero rows: there the cosine metric (0 for two
    zero rows) and array_cosine_distance (1) differ by definition."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    v = rng.normal(size=(8, 16)).astype(np.float32)
    s = td.score_matrix(torch.from_numpy(q), torch.from_numpy(v),
                        MetricKind(metric))
    got = td.metric_score_to_function_value(s, MetricKind(metric)).numpy()
    want = np.asarray(jd.metric_score_to_function_value(
        jnp.asarray(s.numpy()), JMetric(metric)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    fn = {"l2sq": td.array_distance, "cosine": td.array_cosine_distance,
          "ip": td.array_negative_inner_product}[metric]
    direct = np.stack([fn(np.repeat(qi[None], 8, 0), v).numpy() for qi in q])
    np.testing.assert_allclose(got, direct, rtol=1e-4, atol=1e-4)
