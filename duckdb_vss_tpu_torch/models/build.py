"""Neighbor selection helpers of the batched HNSW construction (port of
the part of duckdb_vss_tpu/models/build.py that the bulk build uses).

- select_diverse: usearch's ``refine_`` diversity heuristic, batched:
  pairwise candidate distances as one batched product + a masked
  sequential keep-scan over the candidates;
- _group_ranks: rank of each edge request within its target group,
  the machinery behind the reverse-candidate lists.

The incremental insert path (insert_batch, back-link rounds) comes with
the insert slice.
"""

from __future__ import annotations

import torch

from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.padding import INF_SCORE

_EPS = 1e-30


def _pairwise_scores(
    vecs: torch.Tensor,  # [B, C, D]
    sq: torch.Tensor,  # [B, C]
    metric: MetricKind,
) -> torch.Tensor:
    """All-pairs index-metric scores within each candidate set: [B, C, C]."""
    vecs = vecs.float()
    dot = torch.bmm(vecs, vecs.transpose(1, 2))
    if metric == MetricKind.IP:
        return 1.0 - dot
    if metric == MetricKind.L2SQ:
        return torch.clamp_min(sq[:, :, None] - 2.0 * dot + sq[:, None, :], 0.0)
    if metric == MetricKind.COSINE:
        denom = torch.sqrt(sq[:, :, None] * sq[:, None, :])
        score = 1.0 - dot / torch.clamp_min(denom, _EPS)
        zero_i = sq[:, :, None] <= 0.0
        zero_j = sq[:, None, :] <= 0.0
        score = torch.where(zero_i | zero_j, 1.0, score)
        return torch.where(zero_i & zero_j, 0.0, score)
    raise ValueError(f"unknown metric {metric}")


def select_diverse(
    vectors: torch.Tensor,
    vec_sq: torch.Tensor,
    cand_ids: torch.Tensor,  # [B, C] ascending by score, -1 padded
    cand_scores: torch.Tensor,  # [B, C]
    m_out: int,
    metric: MetricKind,
    backfill: bool = False,
) -> torch.Tensor:
    """usearch ``refine_``, batched.

    Walk candidates in ascending-distance order; keep c iff for every
    already-kept r: dist(c, target) < dist(c, r). Returns [B, m_out]
    int32 selected ids, -1 padded, in selection order.

    backfill=True fills remaining slots with the closest rejected
    candidates (the HNSW paper's keepPrunedConnections).

    The keep-scan is sequential over C: one small step per candidate
    (C launches of a few elementwise kernels on the GPU)."""
    b, c = cand_ids.shape
    safe = cand_ids.clamp_min(0).long()
    pair = _pairwise_scores(vectors[safe], vec_sq[safe], metric)  # [B, C, C]
    valid = (cand_ids >= 0) & (cand_scores < INF_SCORE)
    # closer[b, i, j]: candidate i is at least as close to j as to target
    closer = pair <= cand_scores[:, :, None]
    kept = torch.zeros((b, c), dtype=torch.bool, device=cand_ids.device)
    n_kept = torch.zeros((b,), dtype=torch.int32, device=cand_ids.device)
    for i in range(c):
        take = valid[:, i] & (n_kept < m_out) & ~(kept & closer[:, i]).any(1)
        kept[:, i] = take
        n_kept += take
    # compact kept ids to the front (then rejected-but-valid, then invalid)
    rank = torch.arange(c, device=cand_ids.device)[None, :]
    key = torch.where(kept, rank, torch.where(valid, c + rank, 2 * c + rank))
    order = torch.argsort(key, dim=1)
    packed = torch.gather(cand_ids, 1, order)[:, :m_out]
    pos = torch.arange(packed.shape[1], device=cand_ids.device)[None, :]
    limit = (valid.sum(1) if backfill else n_kept)[:, None]
    out = torch.where(pos < limit, packed, -1)
    if out.shape[1] < m_out:  # fewer candidates than slots
        out = torch.cat([out, out.new_full((b, m_out - out.shape[1]), -1)], 1)
    return out


def _group_ranks(tgt: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Rank of each edge request within its target group, closest first.

    tgt [P] (-1 = inactive, ranked into their own trailing group),
    dist [P]. Returns rank [P] int32 (0 = closest request for that
    target; equal distances keep request order)."""
    p = tgt.shape[0]
    key_t = torch.where(tgt >= 0, tgt, 2**30)
    ord1 = torch.sort(dist, stable=True).indices
    ord2 = torch.sort(key_t[ord1], stable=True).indices
    order = ord1[ord2]  # sorted by (target, dist)
    ts = key_t[order]
    pos = torch.arange(p, device=tgt.device)
    is_start = torch.ones((p,), dtype=torch.bool, device=tgt.device)
    is_start[1:] = ts[1:] != ts[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = torch.empty((p,), dtype=torch.int32, device=tgt.device)
    rank[order] = (pos - seg_start).to(torch.int32)
    return rank
