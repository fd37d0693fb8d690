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


SQRT_BITS = [
    (0x401A67EB, 0x3FC6D0F9), (0x3F984001, 0x3F8B9975),
    (0x400AFC6E, 0x3FBCA0B5), (0x402A43F5, 0x3FD0C6FD),
    (0x4011C516, 0x3FC12D23), (0x3E17FE87, 0x3EC541ED),
    (0x4001BD71, 0x3FB63EDD), (0x401130EA, 0x3FC0CADC),
    (0x00000000, 0x00000000), (0x00000001, 0x1A3504F3),
    (0x7F800000, 0x7F800000), (0x3F800000, 0x3F800000),
]


@pytest.mark.parametrize("what", ["ieee_sqrt", "score_matrix", "pair_scores"])
def test_cpu_sqrt_is_correctly_rounded(what):
    """The port's square roots on the CPU are IEEE (correctly rounded),
    as XLA's and CUDA's are: ieee_sqrt gives the correctly rounded root
    of inputs that torch.sqrt on the CPU rounds one ulp low, and the
    cosine scores equal numpy's f32 evaluation of the same dot products
    and norms, bit for bit, over ~20,000 values. torch.sqrt on the CPU
    is MKL's vsSqrt: within one ulp only (with it, 28 of the 20,480
    cosine scores here were one ulp off), and its first call in a
    process, split over threads, once returned half of its elements
    from a 12-bit estimate (test_torch_sharded.py's fresh processes)."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.normal(size=(40, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(512, 32)).astype(np.float32))
    one, eps = np.float32(1.0), np.float32(1e-30)
    if what == "ieee_sqrt":
        # bits of x and of its correctly rounded root (the f64 root
        # rounded to f32); MKL's vsSqrt gives the root one ulp lower for
        # the first eight; then 0, the least subnormal, inf and 1
        x = np.array(SQRT_BITS, dtype=np.uint32)[:, 0].view(np.float32)
        got = td.ieee_sqrt(torch.from_numpy(x)).numpy()
        want = np.array(SQRT_BITS, dtype=np.uint32)[:, 1].view(np.float32)
    elif what == "score_matrix":
        q_sq, v_sq = td.sq_norms(q), td.sq_norms(v)
        got = td.score_matrix(q, v, MetricKind.COSINE, vec_sq=v_sq,
                              query_sq=q_sq).numpy()
        den = np.sqrt(q_sq.numpy()[:, None] * v_sq.numpy()[None, :])
        want = one - td.dot_scores(q, v).numpy() / np.maximum(den, eps)
    else:
        a, b = q.repeat(512, 1), v.repeat(40, 1)
        got = td.pair_scores(a, b, MetricKind.COSINE).numpy()
        den = np.sqrt(((a * a).sum(-1) * (b * b).sum(-1)).numpy())
        want = one - (a * b).sum(-1).numpy() / np.maximum(den, eps)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
