"""Batched distance computation (port of duckdb_vss_tpu/ops/distance.py).

Index metric semantics follow usearch (lower score = closer):
- l2sq:   sum((a-b)^2), no sqrt
- cos:    1 - <a,b>/(|a||b|), with zero-norm handling
          (both zero -> 0, one zero -> 1)
- ip:     1 - <a,b>

All three are one ``Q @ V^T`` product plus an elementwise epilogue.
An f32 table is scored in true f32 (the package turns TF32 off), the
counterpart of the JAX package's Precision.HIGHEST. A bf16 table (the
bulk build's kNN sweeps, the upper-level descent table) is scored the
way the JAX package scores it: queries rounded to bf16, products and
sums in f32. The SQL scalar functions wait for the SQL slice.
"""

from __future__ import annotations

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
        denom = torch.sqrt(query_sq[:, None] * vec_sq[None, :])
        score = 1.0 - dot / torch.clamp_min(denom, _EPS)
        # usearch zero-norm handling: both zero -> 0, exactly one zero -> 1
        score = torch.where(q_zero | v_zero, 1.0, score)
        return torch.where(q_zero & v_zero, 0.0, score)
    raise ValueError(f"unknown metric {metric}")
