"""HNSW graph state and search (port of duckdb_vss_tpu/models/graph.py,
the part on the main path).

Layout, as in the JAX package:
- the base layer is one [cap, M0] int32 table (sentinel -1);
- upper layers live in a compacted [cap_u, L_MAX*M] packed table
  addressed through an upper-slot indirection (level l in columns
  [(l-1)*M, l*M));
- traversal reads the neighborhood-materialized int8 layout
  (make_neighborhood_tables): every node's M0 neighbor vectors as one
  contiguous [M0, D] int8 tile, plus its packed meta row (pack_meta).

Search runs four steps: mxu_descent scores every upper-level node and
takes the best as seeds; seed_beam scores, dedups and sorts them; the
fused beam kernel (ops/fused_beam.py) runs the base-layer beam; and
_finish_search drops tombstones and reranks exactly in f32.

Not on this slice's path, and so not here yet: the non-fused XLA beam
(beam_search), greedy/beam descent, the augmented table, the hop
rerank and update_neighborhood_rows. They come with the insert slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from duckdb_vss_tpu_torch.ops.fused_beam import fused_beam_search
from duckdb_vss_tpu_torch.ops.topk import flat_topk, smallest_k
from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.padding import INF_SCORE

# Static cap on levels above base. P(level >= 8) = M^-8 (~2e-10 at M=16).
L_MAX = 8

# upper tables hold cap // UPPER_DIV slots; P(level >= 1) = 1/M = 1/16 for
# the default M, so 1/4 gives 4x headroom (overflow levels are clamped).
UPPER_DIV = 4

# the fused kernel's gate (graph.py in the JAX package): wider beams or
# expansions run the non-fused beam, which arrives with the insert slice
FUSED_MAX_EF = 128
FUSED_MAX_EXPAND = 8

_EPS = 1e-30


class GraphState(NamedTuple):
    """Device-resident HNSW graph. The three scalars are 0-d int32
    tensors on the graph's device."""

    neighbors0: torch.Tensor  # [cap, M0] int32, -1 padded
    upper_neighbors: torch.Tensor  # [cap_u, L_MAX * M] int32, level-major
    upper_slot: torch.Tensor  # [cap] int32; slot into upper tables, -1 if level 0
    upper_node: torch.Tensor  # [cap_u] int32; owning node of an upper slot
    levels: torch.Tensor  # [cap] int32; node level, -1 for unused slot
    entry_node: torch.Tensor  # [] int32; -1 while empty
    max_level: torch.Tensor  # [] int32; -1 while empty
    upper_count: torch.Tensor  # [] int32; allocated upper slots

    @property
    def capacity(self) -> int:
        return self.neighbors0.shape[0]


def _full(shape, fill, device):
    return torch.full(shape, fill, dtype=torch.int32, device=device)


def make_graph(cap: int, m: int, m0: int,
               device: torch.device | str) -> GraphState:
    cap_u = max(cap // UPPER_DIV, 64)
    return GraphState(
        neighbors0=_full((cap, m0), -1, device),
        upper_neighbors=_full((cap_u, L_MAX * m), -1, device),
        upper_slot=_full((cap,), -1, device),
        upper_node=_full((cap_u,), -1, device),
        levels=_full((cap,), -1, device),
        entry_node=_full((), -1, device),
        max_level=_full((), -1, device),
        upper_count=_full((), 0, device),
    )


def grow_graph(state: GraphState, new_cap: int) -> GraphState:
    """Capacity growth (analog of reserve/resize)."""
    cap = state.capacity
    if new_cap <= cap:
        return state
    new_cap_u = max(new_cap // UPPER_DIV, 64)

    def pad(arr, rows):
        extra = _full((rows - arr.shape[0],) + tuple(arr.shape[1:]), -1,
                      arr.device)
        return torch.cat([arr, extra])

    return state._replace(
        neighbors0=pad(state.neighbors0, new_cap),
        upper_neighbors=pad(state.upper_neighbors, new_cap_u),
        upper_slot=pad(state.upper_slot, new_cap),
        upper_node=pad(state.upper_node, new_cap_u),
        levels=pad(state.levels, new_cap),
    )


# ---------------------------------------------------------------------------
# distance helpers for gathered candidate sets
# ---------------------------------------------------------------------------


def gather_scores(
    vectors: torch.Tensor,  # [cap, D]
    vec_sq: torch.Tensor,  # [cap]
    ids: torch.Tensor,  # [B, C] int32 (may contain -1; clipped, mask separately)
    queries: torch.Tensor,  # [B, D]
    q_sq: torch.Tensor,  # [B]
    metric: MetricKind,
) -> torch.Tensor:
    """Index-metric scores of gathered candidates: [B, C] f32.

    An f32 table scores in true f32 (the exact rerank); a bf16 table
    scores bf16 operands with f32 sums."""
    safe = ids.clamp_min(0).long()
    vecs = vectors[safe]  # [B, C, D]
    q = queries.to(vectors.dtype)
    dot = torch.bmm(vecs.float(), q.float()[:, :, None])[:, :, 0]
    if metric == MetricKind.IP:
        return 1.0 - dot
    return metric_epilogue(dot, vec_sq[safe], q_sq, metric)


def metric_epilogue(dot, v_sq, q_sq, metric: MetricKind) -> torch.Tensor:
    """Index-metric score from a raw dot product + squared norms."""
    if metric == MetricKind.IP:
        return 1.0 - dot
    if metric == MetricKind.L2SQ:
        return torch.clamp_min(q_sq[:, None] - 2.0 * dot + v_sq, 0.0)
    if metric == MetricKind.COSINE:
        denom = torch.sqrt(q_sq[:, None] * v_sq)
        score = 1.0 - dot / torch.clamp_min(denom, _EPS)
        score = torch.where((q_sq[:, None] <= 0.0) | (v_sq <= 0.0), 1.0, score)
        return torch.where((q_sq[:, None] <= 0.0) & (v_sq <= 0.0), 0.0, score)
    raise ValueError(f"unknown metric {metric}")


def make_neighborhood_tables(
    vectors: torch.Tensor,  # [cap, d_pad] f32 store
    vec_sq: torch.Tensor,  # [cap]
    neighbors0: torch.Tensor,  # [cap, M0]
    chunk: int = 32768,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Neighborhood-materialized traversal layout: for every node, its M0
    base-layer neighbors' vectors stored contiguously as one int8 tile
    with one symmetric dequant scale per neighbor vector.

    Returns (nbr_vecs [cap, M0, d_pad] int8, nbr_scale [cap, M0] f32,
    nbr_sq [cap, M0] f32), bit for bit what the JAX package builds
    (round half to even). Rows at padding positions
    (neighbor -1) hold node 0's vector; the id table masks them. Built
    in chunks of rows so the f32 gather temporary stays bounded
    (0.5 GB per 32768 rows at d=128, M0=32)."""
    cap, d_pad = vectors.shape
    m0 = neighbors0.shape[1]
    table = torch.empty((cap, m0, d_pad), dtype=torch.int8,
                        device=vectors.device)
    scales = torch.empty((cap, m0), dtype=torch.float32, device=vectors.device)
    for off in range(0, cap, chunk):
        nb = neighbors0[off:off + chunk].clamp_min(0).long()
        rows = vectors[nb].float()  # [S, M0, D]
        absmax = rows.abs().amax(dim=-1)
        # times f32(1/127), not / 127: XLA rewrites the JAX package's
        # jitted division by a constant into this product
        scale = torch.where(absmax > 0, absmax * (1.0 / 127.0), 1.0)
        q8 = torch.clamp(torch.round(rows / scale[..., None]), -127, 127)
        table[off:off + nb.shape[0]] = q8.to(torch.int8)
        scales[off:off + nb.shape[0]] = scale
    sq = vec_sq[neighbors0.clamp_min(0).long()]
    return table, scales, sq


def quantize_queries_i8(queries: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric int8 quantization: (q8 [B, D], scale [B])."""
    absmax = queries.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q8 = torch.clamp(torch.round(queries / scale[:, None]), -127, 127)
    return q8.to(torch.int8), scale


# ---------------------------------------------------------------------------
# search: descent + seed beam + fused base beam + exact rerank
# ---------------------------------------------------------------------------


def mxu_descent(
    upper_vecs: torch.Tensor,  # [u_lim, D] bf16 vectors of level>=1 nodes
    upper_vec_sq: torch.Tensor,  # [u_lim] f32
    upper_node: torch.Tensor,  # [u_lim] int32 owning node, -1 if slot unused
    entry_node: torch.Tensor,  # [] int32 fallback when no upper nodes exist
    queries: torch.Tensor,  # [B, D] f32
    metric: MetricKind,
    n_seeds: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact coarse routing: score EVERY upper-level node against every
    query (one blockwise product over a ~1/M fraction of the index) and
    take the best n_seeds as base-layer seeds. Returns (seeds [B,
    n_seeds] int32, n_dist [])."""
    b = queries.shape[0]
    live = upper_node >= 0
    n_dist = live.sum() * b
    score, slot = flat_topk(
        queries, upper_vecs, n_seeds, metric, vec_sq=upper_vec_sq,
        valid=live, block_n=min(16384, upper_vecs.shape[0]))
    seeds = torch.where(score < INF_SCORE,
                        upper_node[slot.clamp_min(0).long()], -1)
    # no upper level yet: fall back to the entry node as the only seed
    has = (seeds >= 0).any(dim=1, keepdim=True)
    return torch.where(has, seeds, entry_node), n_dist


def seed_beam(
    vectors: torch.Tensor,
    vec_sq: torch.Tensor,
    seeds: torch.Tensor,  # [B, P] int32 (-1 allowed)
    queries: torch.Tensor,
    q_sq: torch.Tensor,
    metric: MetricKind,
    ef: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's starting beam: score, dedup and sort the
    descent seeds into (seed_s [B, ef] ascending, INF padded, seed_i
    [B, ef] int32). Repeated seeds keep their id with an INF score, as
    in the JAX package; the first merge turns those ids into -1."""
    b, p = seeds.shape
    seed_valid = seeds >= 0
    seed_s = gather_scores(vectors, vec_sq, seeds, queries, q_sq, metric)
    seed_s = torch.where(seed_valid, seed_s, INF_SCORE)
    dup = torch.triu(seeds[:, :, None] == seeds[:, None, :], 1).any(dim=1)
    seed_s = torch.where(dup, INF_SCORE, seed_s)
    seed_i = torch.where(seed_valid, seeds, -1)
    if p < ef:
        seed_s = torch.cat([seed_s, seed_s.new_full((b, ef - p), INF_SCORE)], 1)
        seed_i = torch.cat([seed_i, seed_i.new_full((b, ef - p), -1)], 1)
    seed_s, pos = smallest_k(seed_s, ef)
    return seed_s.contiguous(), torch.gather(seed_i, 1, pos).contiguous()


def check_fused_gate(ef: int, expand: int, hop_rerank: int = 0) -> None:
    """Raise for the search settings this slice does not run: they need
    the non-fused beam or the hop rerank, which arrive with the insert
    slice. Nothing else is run in their place."""
    if ef > FUSED_MAX_EF or expand > FUSED_MAX_EXPAND:
        raise NotImplementedError(
            f"ef={ef} > {FUSED_MAX_EF} or expand={expand} > "
            f"{FUSED_MAX_EXPAND} needs the non-fused beam search, which "
            "arrives with the insert-path slice")
    if hop_rerank:
        raise NotImplementedError(
            "hop_rerank > 0 arrives with the insert-path slice")


def search_graph(
    state: GraphState,
    vectors: torch.Tensor,
    vec_sq: torch.Tensor,
    valid_mask: torch.Tensor,  # [cap] bool; tombstone filter for RESULTS only
    queries: torch.Tensor,  # [B, D] (padded)
    k: int,
    ef: int,
    metric: MetricKind,
    upper_vecs: torch.Tensor,
    upper_vec_sq: torch.Tensor,
    upper_nodes: torch.Tensor,
    nbr_vecs: torch.Tensor,
    nbr_meta: torch.Tensor,
    expand: int = 4,
    max_steps: int | None = None,
    n_seeds: int = 8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """End-to-end ANN search through the fused beam kernel. Returns
    (scores [B, k] ascending exact index-metric values, ids [B, k] slot
    ids with -1 fill, n_dist [])."""
    ef_eff = max(ef, k)
    check_fused_gate(ef_eff, expand)
    queries = queries.float()
    q_sq = (queries * queries).sum(-1)
    seeds, n_dist0 = mxu_descent(upper_vecs, upper_vec_sq, upper_nodes,
                                 state.entry_node, queries, metric, n_seeds)
    seed_s, seed_i = seed_beam(vectors, vec_sq, seeds, queries, q_sq, metric,
                               ef_eff)
    # recall saturates by ef/2 steps (measured in the JAX package), so the
    # fixed-trip kernel needs no early exit and search no host sync
    steps = max_steps if max_steps is not None else max(8, ef_eff // 2)
    m0 = state.neighbors0.shape[1]
    scores, ids, n_dist1, _n_exp = fused_beam_search(
        queries, q_sq, seed_s, seed_i, nbr_meta, nbr_vecs,
        ef=ef_eff, expand=expand, m0=m0, d=queries.shape[1],
        max_steps=steps, metric=metric)
    n_dist = n_dist0 + n_dist1 + (seeds >= 0).sum()
    return _finish_search(vectors, vec_sq, valid_mask, queries, q_sq, metric,
                          k, scores, ids, n_dist)


def _finish_search(vectors, vec_sq, valid_mask, queries, q_sq, metric, k,
                   scores, ids, n_dist):
    """Tombstone filter, then exact f32 rerank. Deterministic tie order:
    equal exact distances resolve to the higher slot id. Torch has no
    two-key sort, so: a stable sort by id descending, then a stable sort
    by score."""
    live = valid_mask[ids.clamp_min(0).long()] & (ids >= 0)
    exact = gather_scores(vectors, vec_sq, ids, queries, q_sq, metric)
    exact = torch.where(live & (scores < INF_SCORE), exact, INF_SCORE)
    by_id = torch.sort(-ids, dim=1, stable=True).indices
    exact = torch.gather(exact, 1, by_id)
    ids = torch.gather(ids, 1, by_id)
    out_s, order = torch.sort(exact, dim=1, stable=True)
    out_s = out_s[:, :k]
    out_i = torch.gather(ids, 1, order[:, :k])
    return out_s, torch.where(out_s >= INF_SCORE, -1, out_i), n_dist
