"""Batched distance computation (port of duckdb_vss_tpu/ops/distance.py).

Index metric semantics follow usearch (lower score = closer):
- l2sq:   sum((a-b)^2), no sqrt
- cos:    1 - <a,b>/(|a||b|), with zero-norm handling
          (both zero -> 0, one zero -> 1)
- ip:     1 - <a,b>

All three are one ``Q @ V^T`` product plus an elementwise epilogue.
An f32 table is scored in true f32 (the package turns TF32 off), the
counterpart of the JAX package's Precision.HIGHEST. A bf16 table (the
bulk build's kNN sweeps, the upper-level descent table, a bf16 store)
is scored the way the JAX package scores it: queries rounded to bf16,
products and sums in f32.

SQL scalar-function semantics follow DuckDB's array functions, which
the extension matches by name:
- array_distance                = sqrt(l2sq)   (Euclidean)
- array_cosine_distance         = 1 - cosine_similarity
- array_negative_inner_product  = -<a,b>
Their orderings equal the index metrics', so an index scan keeps the
exact row order of the brute-force projection.
"""

from __future__ import annotations

import numpy as np
import torch

from duckdb_vss_tpu_torch.utils.config import MetricKind

_EPS = 1e-30


def dot_scores(queries: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] inner products in f32.

    Mixed dtypes run in the TABLE's dtype (queries are cast down, as in
    the JAX package). bf16 operands are widened before the product so
    the result keeps f32 sums: a bf16 matmul in torch would round its
    output to bf16."""
    if queries.dtype != vectors.dtype:
        queries = queries.to(vectors.dtype)
    return queries.float() @ vectors.float().T


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Element-wise square root, correctly rounded (IEEE 754), as XLA's
    and CUDA's are. On the CPU torch.sqrt is MKL's vsSqrt, which is
    within one ulp only, and whose first call in a process, split over
    threads, has returned about half of its elements from a 12-bit
    estimate (relative error ~3e-4): the CPU takes numpy's sqrt."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))  # 0-d: a scalar


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, f32."""
    x = x.float()
    return (x * x).sum(-1)


def score_matrix(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    metric: MetricKind,
    vec_sq: torch.Tensor | None = None,
    query_sq: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pairwise index-metric scores [B, N]; lower = closer.

    ``vec_sq`` / ``query_sq`` are optional precomputed squared norms."""
    dot = dot_scores(queries, vectors)
    if metric == MetricKind.IP:
        return 1.0 - dot
    if vec_sq is None:
        vec_sq = sq_norms(vectors)
    if query_sq is None:
        query_sq = sq_norms(queries)
    if metric == MetricKind.L2SQ:
        return torch.clamp_min(query_sq[:, None] - 2.0 * dot + vec_sq[None, :],
                               0.0)
    if metric == MetricKind.COSINE:
        q_zero = query_sq[:, None] <= 0.0
        v_zero = vec_sq[None, :] <= 0.0
        denom = ieee_sqrt(query_sq[:, None] * vec_sq[None, :])
        score = 1.0 - dot / torch.clamp_min(denom, _EPS)
        # usearch zero-norm handling: both zero -> 0, exactly one zero -> 1
        score = torch.where(q_zero | v_zero, 1.0, score)
        return torch.where(q_zero & v_zero, 0.0, score)
    raise ValueError(f"unknown metric {metric}")


def pair_scores(a: torch.Tensor, b: torch.Tensor,
                metric: MetricKind) -> torch.Tensor:
    """Row-aligned index-metric scores: [B, D] x [B, D] -> [B]."""
    a, b = a.float(), b.float()
    dot = (a * b).sum(-1)
    if metric == MetricKind.IP:
        return 1.0 - dot
    if metric == MetricKind.L2SQ:
        diff = a - b
        return (diff * diff).sum(-1)
    if metric == MetricKind.COSINE:
        a2, b2 = (a * a).sum(-1), (b * b).sum(-1)
        a_zero, b_zero = a2 <= 0.0, b2 <= 0.0
        score = 1.0 - dot / torch.clamp_min(ieee_sqrt(a2 * b2), _EPS)
        score = torch.where(a_zero | b_zero, 1.0, score)
        return torch.where(a_zero & b_zero, 0.0, score)
    raise ValueError(f"unknown metric {metric}")


# ---------------------------------------------------------------------------
# DuckDB-compatible scalar functions (elementwise over row-aligned pairs):
# what projections in the SQL layer evaluate; the index metrics above are
# their order-preserving counterparts. Arguments are tensors or anything
# torch.as_tensor takes.
# ---------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def array_distance(a, b) -> torch.Tensor:
    """Euclidean distance (with sqrt), row-aligned [.., D] -> [..]."""
    diff = _f32(a) - _f32(b)
    return ieee_sqrt((diff * diff).sum(-1))


def array_inner_product(a, b) -> torch.Tensor:
    return (_f32(a) * _f32(b)).sum(-1)


def array_negative_inner_product(a, b) -> torch.Tensor:
    return -array_inner_product(a, b)


def array_cosine_similarity(a, b) -> torch.Tensor:
    a, b = _f32(a), _f32(b)
    dot = (a * b).sum(-1)
    denom = ieee_sqrt((a * a).sum(-1) * (b * b).sum(-1))
    return dot / torch.clamp_min(denom, _EPS)


def array_cosine_distance(a, b) -> torch.Tensor:
    return 1.0 - array_cosine_similarity(a, b)


def array_value(*args) -> torch.Tensor:
    """DuckDB array_value(a, b, ...): stack scalars/columns into vectors."""
    arrs = [_f32(a) for a in args]
    if any(a.ndim for a in arrs):
        n = next(a.shape[0] for a in arrs if a.ndim)
        arrs = [torch.broadcast_to(a, (n,)) for a in arrs]
    return torch.stack(arrs, dim=-1)


# Function name -> implementation, for the expression layer.
SCALAR_FUNCTIONS = {
    "array_distance": array_distance,
    "array_inner_product": array_inner_product,
    "array_negative_inner_product": array_negative_inner_product,
    "array_cosine_similarity": array_cosine_similarity,
    "array_cosine_distance": array_cosine_distance,
    "array_value": array_value,
}


def metric_score_to_function_value(score: torch.Tensor,
                                   metric: MetricKind) -> torch.Tensor:
    """An index-metric score as the value of the SQL function that orders
    by it (the projected distance column, without re-gathering rows)."""
    if metric == MetricKind.L2SQ:
        return ieee_sqrt(torch.clamp_min(score, 0.0))  # array_distance
    if metric == MetricKind.COSINE:
        return score  # array_cosine_distance == the cosine metric score
    if metric == MetricKind.IP:
        return score - 1.0  # 1 - dot  ->  -dot
    raise ValueError(f"unknown metric {metric}")
