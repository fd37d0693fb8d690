"""HNSW graph state and search (port of duckdb_vss_tpu/models/graph.py).

Layout, as in the JAX package:
- the base layer is one [cap, M0] int32 table (sentinel -1);
- upper layers live in a compacted [cap_u, L_MAX*M] packed table
  addressed through an upper-slot indirection (level l in columns
  [(l-1)*M, l*M));
- the neighborhood-materialized int8 layout (make_neighborhood_tables)
  holds every node's M0 neighbor vectors as one contiguous [M0, D] int8
  tile, plus its packed meta row (pack_meta); update_neighborhood_rows
  refreshes the rows an insert batch changed.

Search: a descent picks base-layer seeds (mxu_descent scores every
upper-level node, through kernel K3, ops/fused_descent.py, on the card;
beam_descent walks the upper levels), the base-layer
beam runs either through the fused kernel K1 (ops/fused_beam.py, ef <=
128 and expand <= 8 over the int8 layout) or through ``beam_search``,
the step-by-step beam, whose per-step scoring reads the int8 tiles, or
kernel K2 (ops/fused_gather.py), or plain gathers; _finish_search drops
tombstones, reranks exactly in f32 and optionally expands one hop.
``search_graph`` takes that path from the tables it is given
(``Tables``); ``SearchTables`` builds and keeps them for one graph and
its store, for HNSWIndex and for each shard of ShardedHNSWIndex.

``beam_search`` ends early the way the JAX package's while-loop does,
but looks at the ``done`` flag only every ``sync_every`` steps (one host
read each): a step taken after ``done`` selects nothing and changes
nothing, so the beam and the distance count are the same.
``sync_every=0`` runs the fixed trip count with no host read, to the
same results.

Both indexes draw node levels with ``sample_levels`` and compact
through ``compaction_plan``.

The augmented traversal table (make_aug_table, off by default) folds a
row's metric terms into the row itself, so the step-by-step beam scores
a candidate with one row gather and no norm gather.
"""

from __future__ import annotations

import math
import weakref
from typing import NamedTuple

import numpy as np
import torch

from duckdb_vss_tpu_torch.ops.distance import ieee_sqrt
from duckdb_vss_tpu_torch.ops.fused_beam import fused_beam_search, pack_meta
from duckdb_vss_tpu_torch.ops.fused_descent import fused_descent
from duckdb_vss_tpu_torch.ops.fused_gather import gather_scores_kernel
from duckdb_vss_tpu_torch.ops.topk import smallest_k
from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.padding import INF_SCORE, pad_dim
from duckdb_vss_tpu_torch.utils.tracing import annotate, count, span

# Static cap on levels above base. P(level >= 8) = M^-8 (~2e-10 at M=16).
L_MAX = 8

# upper tables hold cap // UPPER_DIV slots; P(level >= 1) = 1/M = 1/16 for
# the default M, so 1/4 gives 4x headroom (overflow levels are clamped).
UPPER_DIV = 4

# the fused kernel's gate (graph.py in the JAX package): wider beams or
# expansions run the step-by-step beam
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


def sample_levels(rng: np.random.Generator, n: int, m: int) -> np.ndarray:
    """Exponential level sampling -ln(U)/ln(M), the JAX package's
    sampler on the same numpy generator, so both draw the same levels
    from the same seed."""
    u = rng.random(n)
    inv_log_m = 1.0 / math.log(max(m, 2))
    lv = np.floor(-np.log(np.maximum(u, 1e-12)) * inv_log_m)
    return np.minimum(lv, L_MAX).astype(np.int32)


class CompactPlan(NamedTuple):
    """Where compaction moves one graph's nodes (host arrays)."""

    order: np.ndarray  # [n_live] old slot of each new slot
    remap: np.ndarray  # [cap + 1] int32 new slot of each old one; -1 for
    # a dead slot and at [cap], where an id of -1 is sent
    old_uslot: np.ndarray  # [n_up] old upper slot of each new upper slot
    upper_slot: np.ndarray  # [cap] int32, the new graph's
    upper_node: np.ndarray  # [cap_u] int32
    levels: np.ndarray  # [cap] int32
    entry_node: int
    max_level: int
    upper_count: int


def compaction_plan(valid: np.ndarray, levels: np.ndarray,
                    upper_slot: np.ndarray, cap_u: int) -> CompactPlan:
    """usearch compact()'s slot permutation of one graph: live nodes
    move to the front ordered by level descending, then by old slot (so
    the entry, the highest level, lands in slot 0), and the upper slots
    follow the new order."""
    cap = len(valid)
    live = np.nonzero(valid)[0]
    n_live = len(live)
    order = live[np.lexsort((live, -levels[live]))]
    remap = np.full((cap + 1,), -1, np.int32)
    remap[order] = np.arange(n_live)
    lv = levels[order]
    up = np.nonzero(lv >= 1)[0]
    new_uslot = np.full((cap,), -1, np.int32)
    new_uslot[up] = np.arange(len(up))
    upper_node = np.full((cap_u,), -1, np.int32)
    upper_node[:len(up)] = up
    new_levels = np.full((cap,), -1, np.int32)
    new_levels[:n_live] = lv
    return CompactPlan(order, remap, upper_slot[order[up]], new_uslot,
                       upper_node, new_levels, 0 if n_live else -1,
                       int(lv.max()) if n_live else -1, len(up))


def compact_graph(state: GraphState, plan: CompactPlan) -> GraphState:
    """The graph moved by ``plan``: each live node's lists in its new
    slot with every id remapped (edges into tombstones become -1), -1
    past the live rows."""
    dev, cap = state.neighbors0.device, state.capacity
    remap = torch.from_numpy(plan.remap).to(dev)

    def moved(tbl, rows):
        out = torch.full_like(tbl, -1)
        old = tbl[torch.from_numpy(rows).to(dev).long()]
        out[:len(rows)] = remap[torch.where(old >= 0, old, cap).long()]
        return out

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return GraphState(
        neighbors0=moved(state.neighbors0, plan.order),
        upper_neighbors=moved(state.upper_neighbors, plan.old_uslot),
        upper_slot=on_dev(plan.upper_slot), upper_node=on_dev(plan.upper_node),
        levels=on_dev(plan.levels), entry_node=scalar(plan.entry_node),
        max_level=scalar(plan.max_level), upper_count=scalar(plan.upper_count))


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
    aug: bool = False,
) -> torch.Tensor:
    """Index-metric scores of gathered candidates: [B, C] f32.

    An f32 table scores in true f32 (the exact rerank); a bf16 table
    scores bf16 operands with f32 sums.

    aug=True: ``vectors`` is an augmented traversal table whose rows
    fold the member-side metric terms into the dot (make_aug_table) and
    ``q_sq`` carries the query-side bias: score = dot + bias."""
    safe = ids.clamp_min(0).long()
    vecs = vectors[safe]  # [B, C, D]
    q = queries.to(vectors.dtype)
    dot = torch.bmm(vecs.float(), q.float()[:, :, None])[:, :, 0]
    if aug:
        return dot + q_sq[:, None]
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
        denom = ieee_sqrt(q_sq[:, None] * v_sq)
        score = 1.0 - dot / torch.clamp_min(denom, _EPS)
        score = torch.where((q_sq[:, None] <= 0.0) | (v_sq <= 0.0), 1.0, score)
        return torch.where((q_sq[:, None] <= 0.0) & (v_sq <= 0.0), 0.0, score)
    raise ValueError(f"unknown metric {metric}")


def aug_width(d_pad: int, metric: MetricKind) -> int:
    """Row width of the augmented traversal table (a multiple of 128)."""
    if metric == MetricKind.L2SQ:
        return pad_dim(d_pad + 2)  # two lanes for the hi/lo split of |v|^2
    return d_pad


def make_aug_table(
    vectors: torch.Tensor,  # [cap, d_pad] store (zero-padded past dims)
    vec_sq: torch.Tensor,  # [cap] f32
    metric: MetricKind,
) -> torch.Tensor:
    """Augmented traversal table: one bf16 row per member that folds ALL
    member-side metric terms into a single dot product, so the beam
    gathers one row per candidate and no norm.

      l2sq:   row = [-2v | hi(|v|^2), lo(|v|^2)] ; q_aug = [q | 1, 1]
              dot = |v|^2 - 2 v.q ; + bias (= |q|^2) = l2sq. |v|^2 is
              split into two bf16 lanes (hi and the exact residual) to
              keep ~16 mantissa bits: a single bf16 norm costs recall.
      ip:     row = [-v];        q_aug = [q];      bias 1  -> 1 - v.q
      cosine: row = [-v/|v|];    q_aug = [q/|q|];  bias 1  -> 1 - cos
              (zero-norm rows stay 0: the exact rerank restores the
              zero-norm cases)

    The proxy is monotone in the true metric per query; emitted
    distances always come from the exact rerank. Bit for bit the JAX
    package's table."""
    cap, d_pad = vectors.shape
    dtype = torch.bfloat16
    if metric == MetricKind.L2SQ:
        out = torch.zeros((cap, aug_width(d_pad, metric)), dtype=dtype,
                          device=vectors.device)
        out[:, :d_pad] = (-2.0 * vectors).to(dtype)
        hi = vec_sq.to(dtype)
        out[:, d_pad] = hi
        out[:, d_pad + 1] = (vec_sq - hi.float()).to(dtype)
        return out
    if metric == MetricKind.IP:
        return (-vectors).to(dtype)
    if metric == MetricKind.COSINE:
        inv = torch.rsqrt(torch.clamp_min(vec_sq, _EPS))
        return (-vectors * inv[:, None]).to(dtype)
    raise ValueError(f"unknown metric {metric}")


def make_aug_queries(
    queries: torch.Tensor,  # [B, d_pad] f32 (zero-padded past dims)
    q_sq: torch.Tensor,  # [B]
    metric: MetricKind,
    d_aug: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Query side of make_aug_table: (q_aug [B, d_aug] f32, bias [B]
    f32) with proxy score = dot(row_aug, q_aug) + bias."""
    b, d_pad = queries.shape
    if metric == MetricKind.L2SQ:
        q_aug = torch.zeros((b, d_aug), dtype=torch.float32,
                            device=queries.device)
        q_aug[:, :d_pad] = queries
        q_aug[:, d_pad:d_pad + 2] = 1.0
        return q_aug, q_sq
    if metric == MetricKind.IP:
        return queries, torch.ones_like(q_sq)
    if metric == MetricKind.COSINE:
        inv = torch.rsqrt(torch.clamp_min(q_sq, _EPS))
        return queries * inv[:, None], torch.ones_like(q_sq)
    raise ValueError(f"unknown metric {metric}")


def _quantize_rows_i8(rows: torch.Tensor):
    """Symmetric int8 quantization along the last axis: (q8, scale)."""
    absmax = rows.abs().amax(dim=-1)
    # times f32(1/127), not / 127: XLA rewrites the JAX package's
    # jitted division by a constant into this product
    scale = torch.where(absmax > 0, absmax * (1.0 / 127.0), 1.0)
    q8 = torch.clamp(torch.round(rows / scale[..., None]), -127, 127)
    return q8.to(torch.int8), scale


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
        q8, scale = _quantize_rows_i8(vectors[nb].float())  # [S, M0, D]
        table[off:off + nb.shape[0]] = q8
        scales[off:off + nb.shape[0]] = scale
    sq = vec_sq[neighbors0.clamp_min(0).long()]
    return table, scales, sq


@span("insert.rows")
def update_neighborhood_rows(nbr_vecs, nbr_scale, nbr_sq, nbr_meta,
                             vectors, vec_sq, neighbors0, new_slots):
    """Refresh the neighborhood layout for the rows an insert batch
    changed: the new nodes' own rows plus their forward targets (the
    only rows insert_batch amends through back-links, both subsets of
    the new nodes' forward lists, which are neighbors0[new_slots] after
    the batch). B*(M0+1) row recomputes instead of a whole-table
    rebuild.

    The four tables are updated IN PLACE and returned. new_slots may
    hold -1 (inactive pad) and rows may repeat. Every row is recomputed
    from the current neighbors0, so repeats write identical values, and
    an inactive entry rewrites row 0 with the values it already has:
    nothing needs masking."""
    safe_new = new_slots.clamp_min(0).long()
    fwd = torch.where(new_slots[:, None] >= 0, neighbors0[safe_new], -1)
    rows = torch.cat([new_slots, fwd.reshape(-1)]).clamp_min(0).long()
    nbr = neighbors0[rows]  # [R, M0]
    safe = nbr.clamp_min(0).long()
    q8, scale = _quantize_rows_i8(vectors[safe].float())
    sq = vec_sq[safe]  # unmasked, matching the full build
    nbr_vecs[rows] = q8
    nbr_scale[rows] = scale
    nbr_sq[rows] = sq
    nbr_meta[rows] = pack_meta(nbr, scale, sq)
    return nbr_vecs, nbr_scale, nbr_sq, nbr_meta


def quantize_queries_i8(queries: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric int8 quantization: (q8 [B, D], scale [B])."""
    return _quantize_rows_i8(queries)


def _int8_tile_scores(nbr_vecs, nbr_scale, nbr_sq, sel_safe, q_i8, q_scale,
                      q_sq, metric):
    """Scores of the candidates held in the int8 tiles of the selected
    nodes ``sel_safe`` [B, E]: [B, E*M0]. The int8 x int8 products are
    summed exactly: in f32 while every partial sum stays below 2^24
    (127^2 d), else in f64."""
    b = sel_safe.shape[0]
    d = q_i8.shape[1]
    cand = nbr_vecs[sel_safe].reshape(b, -1, d)  # [B, E*M0, D] i8
    wide = torch.float32 if 127 * 127 * d < 2**24 else torch.float64
    dot_i = torch.bmm(cand.to(wide), q_i8.to(wide)[:, :, None])[:, :, 0]
    v_scale = nbr_scale[sel_safe].reshape(b, -1)
    v_sq = nbr_sq[sel_safe].reshape(b, -1)
    dot = dot_i.float() * v_scale * q_scale[:, None]
    return metric_epilogue(dot, v_sq, q_sq, metric)


def fetch_upper_neighbors(state: GraphState, ids: torch.Tensor,
                          level: int) -> torch.Tensor:
    """Neighbor lists of ``ids`` at upper ``level`` (1-based): [..., M]."""
    m = state.upper_neighbors.shape[1] // L_MAX
    slot = state.upper_slot[ids.clamp_min(0).long()]
    has = (ids >= 0) & (slot >= 0)
    lvl_idx = min(max(int(level) - 1, 0), L_MAX - 1)
    nbrs = state.upper_neighbors[slot.clamp_min(0).long()]
    nbrs = nbrs[..., lvl_idx * m:(lvl_idx + 1) * m]
    return torch.where(has[..., None], nbrs, -1)


# ---------------------------------------------------------------------------
# greedy upper-level descent
# ---------------------------------------------------------------------------


def greedy_descent(
    state: GraphState,
    vectors: torch.Tensor,
    vec_sq: torch.Tensor,
    queries: torch.Tensor,  # [B, D]
    q_sq: torch.Tensor,
    stop_level: torch.Tensor,  # [B] int32: descend while level > stop_level
    metric: MetricKind,
    max_iters_per_level: int = 64,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy 1-NN walk from the entry point down to stop_level+1.

    Returns (cur_node [B], cur_score [B], n_dist []). Queries whose
    stop_level >= max_level start at the entry untouched. One host read
    of max_level, and one of ``moved`` per walk step."""
    b = queries.shape[0]
    cur = state.entry_node.expand(b)
    cur_score = torch.where(
        cur >= 0,
        gather_scores(vectors, vec_sq, cur[:, None], queries, q_sq,
                      metric)[:, 0],
        INF_SCORE)
    n_dist = torch.tensor(b, dtype=torch.int64, device=queries.device)
    max_level = int(state.max_level)
    for lvl in range(min(max_level, L_MAX), 0, -1):
        for _ in range(max_iters_per_level):
            nbrs = fetch_upper_neighbors(state, cur, lvl)  # [B, M]
            valid = nbrs >= 0
            s = gather_scores(vectors, vec_sq, nbrs, queries, q_sq, metric)
            s = torch.where(valid, s, INF_SCORE)
            best_pos = torch.argmin(s, dim=1, keepdim=True)
            best_s = torch.gather(s, 1, best_pos)[:, 0]
            best_id = torch.gather(nbrs, 1, best_pos)[:, 0]
            active_q = (lvl > stop_level) & (cur >= 0)
            improve = active_q & (best_s < cur_score)
            cur = torch.where(improve, best_id, cur)
            cur_score = torch.where(improve, best_s, cur_score)
            n_dist = n_dist + (valid & active_q[:, None]).sum()
            if not bool(improve.any()):
                break
    return cur, cur_score, n_dist


# ---------------------------------------------------------------------------
# beam search at one level
# ---------------------------------------------------------------------------


def beam_search(
    state: GraphState,
    vectors: torch.Tensor,
    vec_sq: torch.Tensor,
    queries: torch.Tensor,  # [B, D]
    q_sq: torch.Tensor,  # [B]
    entry_nodes: torch.Tensor,  # [B, P] int32 seeds (-1 allowed)
    ef: int,
    metric: MetricKind,
    level: int = 0,  # 0 = base layer; >0 = upper layer
    expand: int = 2,  # E: beam entries expanded per step
    max_steps: int | None = None,
    active: torch.Tensor | None = None,  # [B] bool; inactive queries idle
    use_pallas: bool = False,  # score through kernel K2 (f32 table only)
    aug: bool = False,  # vectors/queries/q_sq are augmented (make_aug_table)
    nbr_vecs: torch.Tensor | None = None,  # [cap, M0, D] i8 neighborhood
    nbr_scale: torch.Tensor | None = None,  # [cap, M0] f32 dequant scales
    nbr_sq: torch.Tensor | None = None,  # [cap, M0]
    sync_every: int = 4,  # read ``done`` every so many steps; 0 = never
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched best-first beam search, one step at a time. Returns
    (scores [B, ef] ascending, ids [B, ef], n_dist []). Tombstones are
    NOT filtered here: the filter applies to results, not traversal.

    Per-step scoring, in the JAX package's order of choice: the int8
    neighborhood tiles when given (base layer only), kernel K2 when
    ``use_pallas`` (not with an augmented table), else gather_scores on
    ``vectors`` (f32 or bf16; with ``aug``, an augmented table, its
    queries and their bias).

    The beam ends at ``max_steps`` or when every beam entry is
    expanded or empty. That flag is read on the host every
    ``sync_every`` steps; steps taken past it change nothing (see the
    module docstring). ``beam_search.steps`` counts the steps taken by
    all calls."""
    b, p = entry_nodes.shape
    dev = queries.device
    base = level == 0
    tiles = nbr_vecs is not None and base
    if max_steps is None:
        max_steps = 3 * ef // expand + 8
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)
    if use_pallas and not tiles and not aug \
            and vectors.dtype != torch.float32:
        raise ValueError(
            "use_pallas scores through the gather+score kernel, which takes "
            f"an f32 table; the traversal table is {vectors.dtype}. Build "
            "the index with traversal_dtype='f32'")

    # init beam from entry points
    seed_valid = (entry_nodes >= 0) & active[:, None]
    seed_s = gather_scores(vectors, vec_sq, entry_nodes, queries, q_sq, metric,
                           aug=aug)
    seed_s = torch.where(seed_valid, seed_s, INF_SCORE)
    # dedup seeds (the same entry may be given twice); a repeat keeps its
    # id with an INF score
    dup = torch.triu(entry_nodes[:, :, None] == entry_nodes[:, None, :],
                     1).any(dim=1)
    scores = torch.where(dup, INF_SCORE, seed_s)
    ids = torch.where(seed_valid, entry_nodes, -1)
    if p < ef:
        scores = torch.cat([scores, scores.new_full((b, ef - p), INF_SCORE)], 1)
        ids = torch.cat([ids, ids.new_full((b, ef - p), -1)], 1)
    elif p > ef:
        scores, pos = smallest_k(scores, ef)
        ids = torch.gather(ids, 1, pos)
    expanded = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    n_dist = seed_valid.sum()
    beam_pos = torch.arange(ef, device=dev)
    if tiles:
        q_i8, q_scale = quantize_queries_i8(queries.float())

    it = 0
    while it < max_steps:
        # select E best unexpanded candidates
        sel_key = torch.where(expanded | (scores >= INF_SCORE), INF_SCORE,
                              scores)
        sel_s, sel_pos = smallest_k(sel_key, expand)  # [B, E]
        sel_live = sel_s < INF_SCORE
        sel_ids = torch.where(sel_live, torch.gather(ids, 1, sel_pos), -1)
        hit = ((beam_pos[None, None, :] == sel_pos[:, :, None])
               & sel_live[:, :, None]).any(dim=1)
        expanded = expanded | hit

        if base:
            nbrs = torch.where(
                (sel_ids >= 0)[:, :, None],
                state.neighbors0[sel_ids.clamp_min(0).long()], -1)
        else:
            nbrs = fetch_upper_neighbors(state, sel_ids, level)
        nbrs = nbrs.reshape(b, -1)  # [B, E*M]
        valid = (nbrs >= 0) & active[:, None]
        in_beam = (nbrs[:, :, None] == ids[:, None, :]).any(dim=2)
        # dedup within the new candidate block (keep first occurrence)
        dup_new = torch.triu(nbrs[:, :, None] == nbrs[:, None, :],
                             1).any(dim=1)
        keep = valid & ~in_beam & ~dup_new
        kept_ids = torch.where(keep, nbrs, -1)

        if tiles:
            s = _int8_tile_scores(nbr_vecs, nbr_scale, nbr_sq,
                                  sel_ids.clamp_min(0).long(), q_i8, q_scale,
                                  q_sq, metric)
        elif use_pallas and not aug:
            s = gather_scores_kernel(vectors, kept_ids, queries, q_sq, metric)
        else:
            s = gather_scores(vectors, vec_sq, nbrs, queries, q_sq, metric,
                              aug=aug)
        s = torch.where(keep, s, INF_SCORE)
        n_dist = n_dist + keep.sum()

        # merge into beam: top-ef of (beam + new)
        cat_s = torch.cat([scores, s], 1)
        scores, pos = smallest_k(cat_s, ef)
        ids = torch.gather(torch.cat([ids, kept_ids], 1), 1, pos)
        expanded = torch.gather(
            torch.cat([expanded, torch.zeros_like(keep)], 1), 1, pos)
        it += 1
        if sync_every and it % sync_every == 0 and it < max_steps:
            if bool((expanded | (scores >= INF_SCORE)).all()):
                break
    beam_search.steps += it
    return scores, ids, n_dist


beam_search.steps = 0


def upper_table(upper_node: torch.Tensor, upper_count: torch.Tensor,
                vectors: torch.Tensor, vec_sq: torch.Tensor):
    """(rows [u_lim, D] bf16, sq [u_lim] f32, nodes [u_lim] int32): the
    vectors of upper-level nodes for mxu_descent, masked where the node
    is -1 and compacted to a power-of-two bucket of upper_count (upper
    slots are allocated sequentially, so rows past upper_count are never
    live)."""
    n_up = int(upper_count)
    u_lim = min(upper_node.shape[0],
                max(256, 1 << max(0, n_up - 1).bit_length()))
    node = upper_node[:u_lim]
    safe = node.clamp_min(0).long()
    live = node >= 0
    rows = torch.where(live[:, None], vectors[safe], 0.0)
    return rows.to(torch.bfloat16), vec_sq[safe] * live, node


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
    query (a ~1/M fraction of the index) and take the best n_seeds as
    base-layer seeds: kernel K3 on the card, whose scores never reach
    device memory, its plain version (flat_topk over blocks) on the
    CPU. Returns (seeds [B, n_seeds] int32, n_dist [])."""
    b = queries.shape[0]
    live = upper_node >= 0
    n_dist = live.sum() * b
    score, slot = fused_descent(queries, upper_vecs, upper_vec_sq,
                                upper_node, n_seeds, metric)
    seeds = torch.where(score < INF_SCORE,
                        upper_node[slot.clamp_min(0).long()], -1)
    # no upper level yet: fall back to the entry node as the only seed
    has = (seeds >= 0).any(dim=1, keepdim=True)
    return torch.where(has, seeds, entry_node), n_dist


def beam_descent(
    state: GraphState,
    vectors: torch.Tensor,
    vec_sq: torch.Tensor,
    queries: torch.Tensor,  # [B, D]
    q_sq: torch.Tensor,
    metric: MetricKind,
    descent_ef: int = 16,
    n_seeds: int = 4,
    descent_steps: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Small-beam descent through the upper levels: a greedy hill-climb
    through levels max..2, then one short beam at level 1, whose best
    entries are the base-layer seeds. Returns (seed_ids [B, n_seeds],
    n_dist [])."""
    b = queries.shape[0]
    stop_level = torch.ones((b,), dtype=torch.int32, device=queries.device)
    cur, _, nd0 = greedy_descent(state, vectors, vec_sq, queries, q_sq,
                                 stop_level, metric)
    _scores, ids, nd1 = beam_search(
        state, vectors, vec_sq, queries, q_sq, cur[:, None], descent_ef,
        metric, level=1, expand=4, max_steps=descent_steps or descent_ef,
        active=(state.max_level >= 1).expand(b))
    seeds = ids[:, :n_seeds]
    return torch.where(seeds >= 0, seeds, cur[:, None]), nd0 + nd1


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


# ---------------------------------------------------------------------------
# the tables a search reads
# ---------------------------------------------------------------------------


class Tables(NamedTuple):
    """The derived tables one search reads, already built; search_graph
    takes its path from which of them are given."""

    upper: tuple | None = None  # upper_table's (rows, sq, nodes)
    tiles: tuple | None = None  # make_neighborhood_tables' 3 tables
    meta: torch.Tensor | None = None  # pack_meta rows of the tiles
    trav: torch.Tensor | None = None  # bf16 traversal copy of the store
    aug: torch.Tensor | None = None  # make_aug_table


class SearchTables:
    """Owner of the tables derived from one graph and its store that a
    search reads: the upper-level table (``upper``), the int8
    neighborhood layout and its meta rows (``nbr``), the bf16 traversal
    copy (``trav``) and the augmented table (``aug``). Each is built at
    its first use, on the store's device, and kept in ``built`` until
    ``drop`` names it; the index decides what each mutation drops.

    ``source(index)`` returns the current (GraphState, store rows, their
    squared norms); the index is held weakly, so that no reference
    cycle keeps a dropped index's device memory alive until the next
    garbage collection. The layout's gate:
    capacity x M0 x d_pad bytes of int8 tiles, times ``share`` (the
    layouts that share the device's memory), within the budget;
    ``auto_on_cpu`` whether layout="auto" takes it on a CPU device."""

    def __init__(self, index, source, metric: MetricKind, share: int = 1,
                 auto_on_cpu: bool = True):
        self._index = weakref.ref(index)
        self._source = source
        self.metric = metric
        self.share = int(share)
        self.auto_on_cpu = bool(auto_on_cpu)
        self.built: dict = {}

    def source(self):
        """(GraphState, vectors, vec_sq) as they are now."""
        return self._source(self._index())

    def drop(self, *names: str) -> None:
        """Forget the named tables, every table when none is named."""
        for name in names or tuple(self.built):
            self.built.pop(name, None)

    def fits(self, budget_bytes: int) -> bool:
        graph, vectors, _ = self.source()
        cap, d_pad = vectors.shape
        return (cap * graph.neighbors0.shape[1] * d_pad * self.share
                <= budget_bytes)

    def use_layout(self, layout: str, budget_bytes: int) -> bool:
        """"neighborhood" forces the layout, "flat" refuses it, "auto"
        takes it where it fits the budget."""
        if layout != "auto":
            return layout == "neighborhood"
        on_card = self.source()[1].device.type == "cuda"
        return (on_card or self.auto_on_cpu) and self.fits(budget_bytes)

    def upper(self):
        """upper_table's (rows, sq, nodes)."""
        if "upper" not in self.built:
            g, v, sq = self.source()
            self.built["upper"] = upper_table(g.upper_node, g.upper_count,
                                              v, sq)
        return self.built["upper"]

    def neighborhood(self, layout: str, budget_bytes: int):
        """(nbr_vecs, nbr_scale, nbr_sq, nbr_meta), None while the
        layout is off. The incremental insert refreshes its rows in
        place (update_neighborhood_rows)."""
        if not self.use_layout(layout, budget_bytes):
            return None
        if "nbr" not in self.built:
            g, v, sq = self.source()
            tiles = make_neighborhood_tables(v, sq, g.neighbors0)
            self.built["nbr"] = (*tiles, pack_meta(g.neighbors0, *tiles[1:]))
        return self.built["nbr"]

    def traversal(self, dtype: str = "bf16"):
        """The bf16 traversal copy: the store itself when it is bf16,
        None for dtype "f32" (the f32 store)."""
        vectors = self.source()[1]
        if vectors.dtype == torch.bfloat16:
            return vectors
        if dtype == "f32":
            return None
        if "trav" not in self.built:
            self.built["trav"] = vectors.to(torch.bfloat16)
        return self.built["trav"]

    def aug(self):
        if "aug" not in self.built:
            _, v, sq = self.source()
            self.built["aug"] = make_aug_table(v, sq, self.metric)
        return self.built["aug"]

    def for_search(self, layout: str, budget_bytes: int,
                   descent: str = "mxu", traversal: str = "bf16",
                   use_aug: bool = False, fused: bool = True) -> Tables:
        """The tables a search asks for, built in this order: the upper
        table for the mxu descent; the layout where its gate passes,
        with the meta rows when ``fused`` (kernel K1); the traversal
        copy for the beam descent and for gathers without the augmented
        table; the augmented table, with ``use_aug``, a bf16 traversal
        and no layout."""
        upper = self.upper() if descent == "mxu" else None
        nbr = self.neighborhood(layout, budget_bytes)
        use_aug = use_aug and traversal != "f32" and nbr is None
        want_trav = descent == "beam" or (nbr is None and not use_aug)
        return Tables(
            upper=upper,
            tiles=None if nbr is None else nbr[:3],
            meta=nbr[3] if nbr is not None and fused else None,
            trav=self.traversal(traversal) if want_trav else None,
            aug=self.aug() if use_aug else None)


# ---------------------------------------------------------------------------
# full search (descent + base beam + tombstone filter + exact rerank)
# ---------------------------------------------------------------------------


def search_graph(
    state: GraphState,
    vectors: torch.Tensor,
    vec_sq: torch.Tensor,
    valid_mask: torch.Tensor,  # [cap] bool; tombstone filter for RESULTS only
    queries: torch.Tensor,  # [B, D] (padded)
    k: int,
    ef: int,
    metric: MetricKind,
    tables: Tables = Tables(),
    expand: int = 2,
    max_steps: int | None = None,
    use_pallas: bool = False,
    descent_ef: int = 16,
    n_seeds: int = 4,
    descent_steps: int | None = None,
    hop_rerank: int = 0,  # expand the top-`hop_rerank` results one hop
    # at the finish and merge exactly (see _finish_search)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """End-to-end ANN search. Returns (scores [B, k] ascending exact
    index-metric values, ids [B, k] slot ids with -1 fill, n_dist []).

    The path follows ``tables`` (Tables), and is chosen here alone:
    - the descent: mxu_descent over ``tables.upper`` (one exact product
      over all upper-level nodes), else the level-1 beam walk
      (beam_descent) over the traversal table;
    - the base beam: kernel K1 over the meta rows and the int8 tiles
      while ef <= 128 and expand <= 8; else ``beam_search``, scoring
      through the tiles, else the augmented table (one gather per
      candidate instead of two), else the traversal table (``trav``, a
      bf16 copy of ``vectors``, or ``vectors`` itself), through kernel
      K2 with ``use_pallas``.
    The final rerank always reads the store, so emitted distances are
    exact f32 sums of the stored rows."""
    with annotate("search.descent"):
        queries = queries.float()
        q_sq = (queries * queries).sum(-1)
        trav = vectors if tables.trav is None else tables.trav
        if tables.upper is not None:
            seeds, n_dist0 = mxu_descent(*tables.upper, state.entry_node,
                                         queries, metric, n_seeds)
        else:
            seeds, n_dist0 = beam_descent(
                state, trav, vec_sq, queries, q_sq, metric,
                descent_ef=descent_ef, n_seeds=n_seeds,
                descent_steps=descent_steps)
    ef_eff = max(ef, k)
    nbr_vecs, nbr_scale, nbr_sq = tables.tiles or (None, None, None)
    if (tables.meta is not None and nbr_vecs is not None
            and ef_eff <= FUSED_MAX_EF and expand <= FUSED_MAX_EXPAND):
        with annotate("search.seed"):
            seed_s, seed_i = seed_beam(vectors, vec_sq, seeds, queries, q_sq,
                                       metric, ef_eff)
            n_dist0 = n_dist0 + (seeds >= 0).sum()
        # recall saturates by ef/2 steps (measured in the JAX package), so
        # the fixed-trip kernel needs no early exit and search no host sync
        steps = max_steps if max_steps is not None else max(8, ef_eff // 2)
        m0 = state.neighbors0.shape[1]
        with annotate("search.beam"):
            scores, ids, n_dist1, n_exp = fused_beam_search(
                queries, q_sq, seed_s, seed_i, tables.meta, nbr_vecs,
                ef=ef_eff, expand=expand, m0=m0, d=queries.shape[1],
                max_steps=steps, metric=metric)
        count("k1.distances", n_dist1)
        count("k1.expansions", n_exp)
    else:
        with annotate("search.beam"):
            aug = tables.aug is not None and nbr_vecs is None
            if aug:
                beam_q, beam_bias = make_aug_queries(queries, q_sq, metric,
                                                     tables.aug.shape[1])
                beam_tab = tables.aug
            else:
                beam_tab, beam_q, beam_bias = trav, queries, q_sq
            scores, ids, n_dist1 = beam_search(
                state, beam_tab, vec_sq, beam_q, beam_bias, seeds, ef_eff,
                metric, level=0, expand=expand, max_steps=max_steps,
                use_pallas=use_pallas, aug=aug, nbr_vecs=nbr_vecs,
                nbr_scale=nbr_scale, nbr_sq=nbr_sq)
    with annotate("search.finish"):
        out = _finish_search(vectors, vec_sq, valid_mask, queries, q_sq,
                             metric, k, scores, ids, n_dist0 + n_dist1,
                             hop_rerank, state.neighbors0, tables.tiles)
    count("search.queries", queries.shape[0])
    count("search.distances", out[2])
    return out


def _sort_score_then_high_id(scores, ids, k):
    """The first k of (score ascending, id descending). Torch has no
    two-key sort, so: a stable sort by id descending, then a stable
    sort by score."""
    by_id = torch.sort(-ids, dim=1, stable=True).indices
    scores = torch.gather(scores, 1, by_id)
    ids = torch.gather(ids, 1, by_id)
    out_s, order = torch.sort(scores, dim=1, stable=True)
    out_s = out_s[:, :k]
    out_i = torch.gather(ids, 1, order[:, :k])
    return out_s, torch.where(out_s >= INF_SCORE, -1, out_i)


def _finish_search(vectors, vec_sq, valid_mask, queries, q_sq, metric, k,
                   scores, ids, n_dist, hop=0, neighbors0=None, tiles=None):
    """Tombstone filter, then exact f32 rerank. Deterministic tie order:
    equal exact distances resolve to the higher slot id.

    hop > 0 adds a one-hop rerank expansion: score the NEIGHBORS of the
    top-hop results (through the int8 ``tiles`` when the layout is
    given, else by gathers from the store), keep the best 16 that are new, live
    and distinct, rescore those exactly and merge them into the top-k."""
    live = valid_mask[ids.clamp_min(0).long()] & (ids >= 0)
    exact = gather_scores(vectors, vec_sq, ids, queries, q_sq, metric)
    exact = torch.where(live & (scores < INF_SCORE), exact, INF_SCORE)
    out_s, out_i = _sort_score_then_high_id(exact, ids, k)
    if not hop:
        return out_s, out_i, n_dist
    b = queries.shape[0]
    h = min(int(hop), k)
    src = out_i[:, :h]
    safe_src = src.clamp_min(0).long()
    nbrs = torch.where((src >= 0)[:, :, None], neighbors0[safe_src], -1)
    cand = nbrs.reshape(b, -1)  # [B, h*M0]
    if tiles is not None:
        # the tiles of nbr_vecs[src] ARE the vectors of neighbors0[src],
        # column-aligned with `cand`
        q_i8, q_scale = quantize_queries_i8(queries)
        s_c = _int8_tile_scores(*tiles, safe_src, q_i8, q_scale, q_sq,
                                metric)
    else:
        s_c = gather_scores(vectors, vec_sq, cand, queries, q_sq, metric)
    # mask BEFORE selecting: the top results are each other's neighbors,
    # so without it the best by score are mostly ids already returned
    in_out = (cand[:, :, None] == out_i[:, None, :]).any(dim=2)
    sorted_c, order_c = torch.sort(cand, dim=1, stable=True)
    dup_sorted = torch.cat(
        [torch.zeros((b, 1), dtype=torch.bool, device=cand.device),
         sorted_c[:, 1:] == sorted_c[:, :-1]], 1)
    dup = torch.zeros_like(dup_sorted).scatter_(1, order_c, dup_sorted)
    live_c = valid_mask[cand.clamp_min(0).long()]
    keep = (cand >= 0) & live_c & ~in_out & ~dup
    s_c = torch.where(keep, s_c, INF_SCORE)
    n_dist = n_dist + (cand >= 0).sum()
    top_s, pos = smallest_k(s_c, min(16, cand.shape[1]))
    cand_r = torch.gather(cand, 1, pos)  # [B, r]
    ok_r = (top_s < INF_SCORE) & (cand_r >= 0)
    exact_r = gather_scores(vectors, vec_sq, cand_r, queries, q_sq, metric)
    m_s = torch.cat([out_s, torch.where(ok_r, exact_r, INF_SCORE)], 1)
    m_i = torch.cat([out_i, torch.where(ok_r, cand_r, -1)], 1)
    out_s, out_i = _sort_score_then_high_id(m_s, m_i, k)
    return out_s, out_i, n_dist
