"""Blockwise top-k selection (port of duckdb_vss_tpu/ops/topk.py).

The scan streams [block_n, D] vector blocks through one product each and
keeps every block's top-k; one final selection over the union gives the
global top-k. Invalid/padded/deleted rows are masked to INF_SCORE.

Tie order is part of the contract: among equal scores the lowest index
wins, as lax.top_k and the JAX package's exact_topk_small resolve them.
``torch.topk`` promises no tie order, so ``smallest_k`` selects by value
with ``torch.topk`` and then resolves the ties at the k-th value by
position. The JAX package's approximate per-block selection
(lax.approx_max_k, a TPU hardware top-k that XLA computes exactly on
other backends) is exact here, which costs no recall.
"""

from __future__ import annotations

import torch

from duckdb_vss_tpu_torch.ops.distance import score_matrix, sq_norms
from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.padding import INF_SCORE


def smallest_k(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact ascending top-k (smallest scores) of ``s`` [B, N], k <= N.

    Returns (scores [B, k], positions [B, k] int64). Ties resolve to the
    lowest position, both inside the k and at the k-th value.

    It stands in for the JAX package's ``exact_topk_small`` (a two-level
    tournament that beats lax.top_k on the TPU) and for lax.top_k: same
    scores, same positions, for any N (no multiple of 128 needed), and
    distinct positions also where a row has fewer than k finite
    scores."""
    b, n = s.shape
    if k >= n:
        out, pos = torch.sort(s, dim=1, stable=True)
        return out, pos
    kth = torch.topk(s, k, dim=1, largest=False, sorted=True).values[:, -1:]
    less = s < kth
    eq = s == kth
    need = k - less.sum(dim=1, keepdim=True, dtype=torch.int32)
    eq_rank = torch.cumsum(eq, dim=1, dtype=torch.int32)
    sel = less | (eq & (eq_rank <= need))  # exactly k per row
    lane = torch.arange(n, 0, -1, device=s.device, dtype=torch.int32)
    # selected positions carry distinct keys n - pos, the rest 0: the top
    # k keys are exactly the selected positions, lowest position first
    pos = torch.topk(torch.where(sel, lane, 0), k, dim=1).indices
    sc = torch.gather(s, 1, pos)
    order = torch.sort(sc, dim=1, stable=True).indices
    return torch.gather(sc, 1, order), torch.gather(pos, 1, order)


def merge_topk(
    scores_a: torch.Tensor,
    ids_a: torch.Tensor,
    scores_b: torch.Tensor,
    ids_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two ascending candidate sets [B, ka] + [B, kb] -> best k."""
    cat_s = torch.cat([scores_a, scores_b], dim=1)
    cat_i = torch.cat([ids_a, ids_b], dim=1)
    out_s, pos = smallest_k(cat_s, k)
    return out_s, torch.gather(cat_i, 1, pos)


def _pad_k(scores, ids, k):
    """Pad a [B, kk] result to k columns with (INF_SCORE, -1)."""
    b, kk = scores.shape
    if kk == k:
        return scores, ids
    scores = torch.cat([scores, scores.new_full((b, k - kk), INF_SCORE)], 1)
    ids = torch.cat([ids, ids.new_full((b, k - kk), -1)], 1)
    return scores, ids


def flat_topk_dense(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    k: int,
    metric: MetricKind,
    vec_sq: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-product top-k for small N: [B, D] x [N, D] -> ([B, k], [B, k]).

    k may exceed N: results are padded with (INF_SCORE, -1) past N."""
    n = vectors.shape[0]
    q_f32 = queries.float()
    s = score_matrix(q_f32, vectors, metric, vec_sq=vec_sq,
                     query_sq=sq_norms(q_f32))
    if valid is not None:
        s = torch.where(valid[None, :], s, INF_SCORE)
    scores, pos = smallest_k(s, min(k, n))
    return _pad_k(scores, pos.to(torch.int32), k)


def flat_topk_stashed(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    k: int,
    metric: MetricKind,
    vec_sq: torch.Tensor,
    valid: torch.Tensor,
    block_n: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact streaming top-k with one global extraction phase.

    Keeps the whole [B, N] score matrix (block by block, as the scan
    makes it) with each 128-wide bin's minimum and its position, then
    runs k extraction passes: the argmin over the [B, N/128] bin minima,
    the winner's bin read again from the stash with every place taken
    from it masked, its new minimum. The same scores and ids, in the same
    tie order (lowest bin, then lowest lane), as ``flat_topk``'s
    per-block selection. Where a row has fewer than k finite scores, the
    places past them carry INF_SCORE with ids that may repeat (as in the
    JAX package); callers mask by ``score >= INF_SCORE``.

    Off by default: ``flat_topk`` takes this path only within its
    ``stash_bytes`` budget (0)."""
    b = queries.shape[0]
    n = vectors.shape[0]
    nb, bpb = n // block_n, block_n // 128
    q_f32 = queries.float()
    q_sq = sq_norms(q_f32)
    stash = torch.empty((nb, b, block_n), dtype=torch.float32,
                        device=queries.device)
    for i in range(nb):
        blk = slice(i * block_n, (i + 1) * block_n)
        stash[i] = torch.where(valid[None, blk], score_matrix(
            q_f32, vectors[blk], metric, vec_sq=vec_sq[blk], query_sq=q_sq),
            INF_SCORE)
    bins = stash.view(nb, b, bpb, 128)
    bin_min, bin_pos = bins.min(dim=3)  # [nb, B, bpb]: the first minimum
    bin_min = bin_min.permute(1, 0, 2).reshape(b, nb * bpb)
    bin_pos = bin_pos.permute(1, 0, 2).reshape(b, nb * bpb)
    rows = torch.arange(b, device=queries.device)
    lane = torch.arange(128, device=queries.device)
    out_s = torch.full((b, k), INF_SCORE, dtype=torch.float32,
                       device=queries.device)
    out_i = torch.full((b, k), -1, dtype=torch.int64, device=queries.device)
    for j in range(k):
        sc, g = bin_min.min(dim=1)  # the first (lowest) bin on ties
        out_s[:, j] = sc
        out_i[:, j] = g * 128 + bin_pos[rows, g]
        bin_row = bins[g // bpb, rows, g % bpb]  # [B, 128]
        taken = torch.where(out_i[:, :j + 1] // 128 == g[:, None],
                            out_i[:, :j + 1] % 128, -1)
        bin_row = torch.where((lane[None, :, None] == taken[:, None, :])
                              .any(dim=2), INF_SCORE, bin_row)
        bin_min[rows, g], bin_pos[rows, g] = bin_row.min(dim=1)
    return out_s, out_i.to(torch.int32)


def flat_topk(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    k: int,
    metric: MetricKind,
    vec_sq: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
    block_n: int = 16384,
    stash_bytes: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k over [block_n, D] blocks.

    ``vectors`` must be [N, D] with N divisible by ``block_n`` (the store
    guarantees this); returns ascending (scores [B, k], ids [B, k] int32).
    The product runs in the table's dtype (see dot_scores); norms are
    f32 always. With k <= 32, ``block_n`` a multiple of 128 and the
    [B, N] f32 scores within ``stash_bytes`` (default 0: never, as the
    JAX package's DVT_FLAT_STASH_GB), the selection runs through
    ``flat_topk_stashed`` instead, with the same results."""
    n = vectors.shape[0]
    if n <= block_n:
        return flat_topk_dense(queries, vectors, k, metric, vec_sq, valid)
    if n % block_n:
        raise ValueError(f"row count {n} is not a multiple of {block_n}")
    if vec_sq is None:
        vec_sq = sq_norms(vectors)
    if (k <= 32 and block_n % 128 == 0
            and queries.shape[0] * n * 4 <= stash_bytes):
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool, device=vectors.device)
        return flat_topk_stashed(queries, vectors, k, metric, vec_sq, valid,
                                 block_n)
    q_f32 = queries.float()
    q_sq = sq_norms(q_f32)
    kc = min(k, block_n)
    all_s, all_i = [], []
    for off in range(0, n, block_n):
        s = score_matrix(q_f32, vectors[off:off + block_n], metric,
                         vec_sq=vec_sq[off:off + block_n], query_sq=q_sq)
        if valid is not None:
            s = torch.where(valid[None, off:off + block_n], s, INF_SCORE)
        blk_s, pos = smallest_k(s, kc)
        all_s.append(blk_s)
        all_i.append(pos.to(torch.int32) + off)
    all_s = torch.cat(all_s, dim=1)
    all_i = torch.cat(all_i, dim=1)
    scores, pos = smallest_k(all_s, min(k, all_s.shape[1]))
    return _pad_k(scores, torch.gather(all_i, 1, pos), k)
