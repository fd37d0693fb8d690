"""Batched HNSW construction (port of duckdb_vss_tpu/models/build.py).

- select_diverse: usearch's ``refine_`` diversity heuristic, batched:
  pairwise candidate distances as one batched product + a masked
  sequential keep-scan over the candidates;
- _group_ranks: rank of each edge request within its target group;
- insert_batch: a batch of B new nodes runs the layered candidate
  search together (a beam per level), selects diverse neighbors, writes
  forward edges, and applies back edges in conflict-free rounds: edge
  requests are ranked within their target group and each round writes
  one request per target (rank r), merging and re-pruning that target's
  list. Requests beyond the last round are dropped. Nodes of one batch
  reach each other through their nearest batch peers, which seed every
  beam.

Where the JAX package scatters with ``mode="drop"`` on an out-of-range
index, the port selects the live rows first and writes only those. Each
round's targets are unique, so no write depends on the order in which
the device applies it. The neighbor tables are cloned once per batch
and then amended in place.
"""

from __future__ import annotations

import torch

from duckdb_vss_tpu_torch.models.graph import (L_MAX, GraphState, beam_search,
                                               gather_scores, mxu_descent)
from duckdb_vss_tpu_torch.ops.distance import ieee_sqrt
from duckdb_vss_tpu_torch.ops.topk import smallest_k
from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.padding import INF_SCORE
from duckdb_vss_tpu_torch.utils.tracing import annotate, span

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
        denom = ieee_sqrt(sq[:, :, None] * sq[:, None, :])
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


def _merge_and_prune(rows, extra, vectors, vec_sq, t_vec, t_sq, m_cap,
                     metric, prune):
    """New neighbor rows for targets whose current ``rows`` [P, m_cap]
    take the requests ``extra`` [P, R] (-1 = none): sort the union by
    distance to the target; on overflow prune with the diversity
    heuristic ("diversity") or keep the closest ("truncate")."""
    merged = torch.cat([rows, extra], 1)
    d = gather_scores(vectors, vec_sq, merged, t_vec, t_sq, metric)
    d = torch.where(merged >= 0, d, INF_SCORE)
    count = (merged >= 0).sum(1)
    s_d2, order = torch.sort(d, dim=1, stable=True)
    s_ids = torch.where(s_d2 < INF_SCORE, torch.gather(merged, 1, order), -1)
    appended = s_ids[:, :m_cap]
    if prune != "diversity":
        return appended
    pruned = select_diverse(vectors, vec_sq, s_ids, s_d2, m_cap, metric)
    return torch.where((count > m_cap)[:, None], pruned, appended)


def _window(table, rows, col_off, m_cap):
    """The m_cap-wide window at col_off of the given table rows."""
    out = table[rows.long()]
    return out if col_off is None else out[:, col_off:col_off + m_cap]


def _write_window(table, rows, col_off, m_cap, values):
    """table[rows, window] = values, in place; ``rows`` are unique."""
    if col_off is None:
        table[rows.long()] = values
    else:
        table[rows.long(), col_off:col_off + m_cap] = values


def _request_ranks(vectors, vec_sq, tgt, src, act, metric):
    """Target vectors and norms, and each request's rank among the
    requests for the same target, closest source first."""
    safe_t = tgt.clamp_min(0).long()
    t_vec, t_sq = vectors[safe_t], vec_sq[safe_t]
    s_d = gather_scores(vectors, vec_sq, src[:, None], t_vec, t_sq,
                        metric)[:, 0]
    return t_vec, t_sq, _group_ranks(torch.where(act, tgt, -1), s_d)


def _apply_backlinks(
    table: torch.Tensor,  # [T, W] neighbor table, amended in place
    vectors: torch.Tensor,
    vec_sq: torch.Tensor,
    tgt: torch.Tensor,  # [P] target node id
    src: torch.Tensor,  # [P] new neighbor to add
    act: torch.Tensor,  # [P] bool
    tgt_row: torch.Tensor,  # [P] row index into table (== tgt for the base
    #                         layer, upper_slot[tgt] for upper layers)
    metric: MetricKind,
    r_rounds: int,
    prune: str = "diversity",
    col_off: int | None = None,  # column offset into a wider packed table
    m_cap: int | None = None,  # list width when col_off is given
) -> torch.Tensor:
    """Append src into tgt's neighbor row with overflow pruning,
    resolving same-target conflicts over ``r_rounds`` rounds: round r
    serves each target's rank-r request, so a round's rows are unique.
    Only the rounds that the deepest target group needs are run (one
    host read); requests past r_rounds are dropped."""
    if m_cap is None:
        m_cap = table.shape[1]
    t_vec, t_sq, ranks = _request_ranks(vectors, vec_sq, tgt, src, act, metric)
    rounds = min(int(torch.where(act, ranks, -1).max()) + 1, r_rounds)
    for r in range(rounds):
        sel = torch.nonzero(act & (ranks == r))[:, 0]
        rows = _window(table, tgt_row[sel], col_off, m_cap)
        new = src[sel][:, None]
        # drop a src already present
        new = torch.where((rows == new).any(1, keepdim=True), -1, new)
        new_rows = _merge_and_prune(rows, new, vectors, vec_sq, t_vec[sel],
                                    t_sq[sel], m_cap, metric, prune)
        _write_window(table, tgt_row[sel], col_off, m_cap, new_rows)
    return table


def _apply_backlinks_batched(
    table: torch.Tensor,
    vectors: torch.Tensor,
    vec_sq: torch.Tensor,
    tgt: torch.Tensor,
    src: torch.Tensor,
    act: torch.Tensor,
    tgt_row: torch.Tensor,
    metric: MetricKind,
    r_rounds: int,  # max requests merged per target (rank cap)
    prune: str = "diversity",
    col_off: int | None = None,
    m_cap: int | None = None,
) -> torch.Tensor:
    """Single-pass variant of _apply_backlinks: merge a target's row
    with ALL of its (up to r_rounds closest) requests at once and prune
    the union once. A valid resolution of concurrent back-links, not the
    same one as the sequential rounds; opt-in (``backlinks="batched"``)."""
    if m_cap is None:
        m_cap = table.shape[1]
    t_vec, t_sq, ranks = _request_ranks(vectors, vec_sq, tgt, src, act, metric)
    keep = torch.nonzero(act & (ranks < r_rounds))[:, 0]
    # per-target request table: row = tgt_row, col = rank (unique)
    req = torch.full((table.shape[0], r_rounds), -1, dtype=torch.int32,
                     device=table.device)
    req[tgt_row[keep].long(), ranks[keep].long()] = src[keep]
    own = torch.nonzero(act & (ranks == 0))[:, 0]  # one writer per target
    rows = _window(table, tgt_row[own], col_off, m_cap)
    extra = req[tgt_row[own].long()]  # [P, rr]
    dup = (extra[:, :, None] == rows[:, None, :]).any(dim=2)
    extra = torch.where(dup, -1, extra)
    new_rows = _merge_and_prune(rows, extra, vectors, vec_sq, t_vec[own],
                                t_sq[own], m_cap, metric, prune)
    _write_window(table, tgt_row[own], col_off, m_cap, new_rows)
    return table


def _force_nearest_backlink(
    table: torch.Tensor,  # [T, Mcap], amended in place
    vectors: torch.Tensor,
    vec_sq: torch.Tensor,
    tgt: torch.Tensor,  # [B] the new node's CLOSEST forward target
    src: torch.Tensor,  # [B] the new node
    act: torch.Tensor,  # [B]
    metric: MetricKind,
    r_rounds: int,
) -> torch.Tensor:
    """Guarantee src an in-link from its nearest forward target.

    A bulk build saturates every neighbor row, so an incremental
    back-link must displace an edge through the diversity heuristic, and
    a new point is the most redundant candidate at its CLOSEST targets,
    which reject it. Here the nearest target always adopts the new
    node, evicting its farthest current neighbor (an empty slot first,
    since empties sort as INF)."""
    ranks = _group_ranks(torch.where(act, tgt, -1),
                         torch.zeros_like(tgt, dtype=torch.float32))
    rounds = min(int(torch.where(act, ranks, -1).max()) + 1, r_rounds)
    col = torch.arange(table.shape[1], device=table.device)[None]
    for r in range(rounds):
        sel = torch.nonzero(act & (ranks == r))[:, 0]
        t = tgt[sel].long()
        rows = table[t]
        new = src[sel][:, None]
        present = (rows == new).any(1, keepdim=True)
        d = gather_scores(vectors, vec_sq, rows, vectors[t], vec_sq[t], metric)
        d = torch.where(rows >= 0, d, INF_SCORE)  # empty slots evict first
        victim = torch.argmax(d, dim=1, keepdim=True)  # first maximum
        table[t] = torch.where((col == victim) & ~present, new, rows)
    return table


@span("insert.step")
def insert_batch(
    state: GraphState,
    vectors: torch.Tensor,  # [cap, D], already holds the new vectors
    vec_sq: torch.Tensor,  # [cap]
    new_slots: torch.Tensor,  # [B] int32 (-1 = inactive pad row)
    new_levels: torch.Tensor,  # [B] int32 sampled levels
    metric: MetricKind,
    m: int,
    m0: int,
    ef_construction: int,
    ef_upper: int = 32,
    expand: int = 2,
    r_rounds: int = 4,
    prune: str = "diversity",
    nbr_vecs: torch.Tensor | None = None,  # int8 neighborhood layout for
    nbr_scale: torch.Tensor | None = None,  # the base-layer candidate
    nbr_sq: torch.Tensor | None = None,  # search (make_neighborhood_tables)
    backlinks: str = "rounds",  # "rounds" | "batched"
    backlink_cols: int | None = None,  # request back-edges only from the
    # closest backlink_cols forward targets (None = all)
    max_steps_base: int | None = None,  # cap on the base-layer beam's steps
    max_steps_upper: int | None = None,  # same for the upper-level beams
) -> tuple[GraphState, torch.Tensor]:
    """Insert a batch of new nodes. Returns (state, n_dist).

    Per level from the top: beam search for candidates, diversity
    selection, forward edges, back edges, for the whole batch at once.
    With the int8 neighborhood tables the base-layer beam scores through
    them; the CALLER keeps them consistent with neighbors0 across
    batches (graph.update_neighborhood_rows). The input state's tables
    are left as they were."""
    apply_backlinks = (_apply_backlinks_batched if backlinks == "batched"
                       else _apply_backlinks)
    dev = new_slots.device
    b = new_slots.shape[0]
    with annotate("insert.upper"):
        active = new_slots >= 0
        safe_slots = new_slots.clamp_min(0).long()
        q = vectors[safe_slots]
        q_sq = vec_sq[safe_slots]
        new_levels = torch.where(active, new_levels.clamp_max(L_MAX), -1)

        # ---- allocate upper slots for nodes with level >= 1 -------------
        has_upper = active & (new_levels >= 1)
        cap_u = state.upper_neighbors.shape[0]
        u_off = torch.cumsum(has_upper, 0, dtype=torch.int32) - 1
        u_slot_new = torch.where(has_upper, state.upper_count + u_off, -1)
        # table full
        u_slot_new = torch.where(u_slot_new < cap_u, u_slot_new, -1)
        got = torch.nonzero(u_slot_new >= 0)[:, 0]
        upper_slot = state.upper_slot.clone()
        upper_slot[safe_slots[got]] = u_slot_new[got]
        upper_node = state.upper_node.clone()
        upper_node[u_slot_new[got].long()] = new_slots[got]
        # nodes that failed upper allocation fall back to level 0
        new_levels = torch.where(has_upper & (u_slot_new < 0), 0, new_levels)
        live = torch.nonzero(active)[:, 0]
        levels = state.levels.clone()
        levels[safe_slots[live]] = new_levels[live]
        upper_neighbors = state.upper_neighbors.clone()
        state = state._replace(
            upper_slot=upper_slot, upper_node=upper_node, levels=levels,
            upper_neighbors=upper_neighbors,
            upper_count=(state.upper_count + got.numel()).to(torch.int32))

        # ---- intra-batch peer candidates (within-batch reachability) ----
        peer_s = _pairwise_scores(q[None], q_sq[None], metric)[0]  # [B, B]
        self_mask = torch.eye(b, dtype=torch.bool, device=dev)
        peer_s = torch.where(self_mask | ~active[None, :] | ~active[:, None],
                             INF_SCORE, peer_s)
        peer_top, peer_pos = smallest_k(peer_s, min(16, b))
        # fewer active peers than columns: the INF-masked picks (self among
        # them) are dropped, or the batch would seed self-edges
        peer_ok = peer_top < INF_SCORE
        peer_ids = torch.where(peer_ok, new_slots[peer_pos], -1)
        peer_levels = torch.where(peer_ok, new_levels[peer_pos], -1)

        n_dist = torch.zeros((), dtype=torch.int64, device=dev)

        # ---- phase A: upper levels, top down (one host read of the top) -
        seeds = state.entry_node.expand(b)[:, None]
        max_level = int(state.max_level)
        top_lvl = min(max(max_level, int(new_levels.max()), 0), L_MAX)
        blc_u = min(backlink_cols or m, m)
        for lvl in range(top_lvl, 0, -1):
            write_here = active & (new_levels >= lvl)
            touch = write_here.any() | (lvl <= max_level)
            peer_here = torch.where(peer_levels >= lvl, peer_ids, -1)
            scores, ids, nd = beam_search(
                state, vectors, vec_sq, q, q_sq,
                torch.cat([seeds, peer_here], 1), ef_upper, metric, level=lvl,
                expand=1, active=active & touch, max_steps=max_steps_upper)
            n_dist = n_dist + nd
            self_hit = ids == new_slots[:, None]  # never link a node to itself
            ids = torch.where(self_hit, -1, ids)
            scores = torch.where(self_hit, INF_SCORE, scores)

            sel = select_diverse(vectors, vec_sq, ids, scores, m, metric)
            sel = torch.where(write_here[:, None], sel, -1)
            # forward edges: the level's m-wide window of the packed row
            col_off = (lvl - 1) * m
            row = torch.where(write_here, upper_slot[safe_slots], -1)
            wr = torch.nonzero(row >= 0)[:, 0]
            _write_window(upper_neighbors, row[wr], col_off, m, sel[wr])

            # back edges at this level: targets' rows live at upper_slot[tgt]
            tgt = sel[:, :blc_u].reshape(-1)
            src = new_slots.repeat_interleave(blc_u)
            act = (tgt >= 0) & (src >= 0)
            tgt_uslot = torch.where(act, upper_slot[tgt.clamp_min(0).long()],
                                    -1)
            act = act & (tgt_uslot >= 0)
            apply_backlinks(upper_neighbors, vectors, vec_sq, tgt, src, act,
                            tgt_uslot, metric, r_rounds, prune,
                            col_off=col_off, m_cap=m)

            # seed the next level with this level's best (else keep the seeds)
            best = torch.where(ids[:, :1] >= 0, ids[:, :1], seeds[:, :1])
            seeds = torch.where(touch, best, seeds[:, :1])

    with annotate("insert.base"):
        # ---- phase B: base layer --------------------------------------
        # exact coarse routing for the base seeds: score the batch against
        # ALL upper-level nodes (a greedy top-down walk strands clustered
        # inserts in the wrong region)
        u_safe = upper_node.clamp_min(0).long()
        mxu_seeds, nd_mxu = mxu_descent(
            vectors[u_safe].to(torch.bfloat16),
            vec_sq[u_safe] * (upper_node >= 0),
            upper_node, state.entry_node, q, metric, n_seeds=8)
        n_dist = n_dist + nd_mxu
        # never seed a node with itself
        mxu_seeds = torch.where(mxu_seeds == new_slots[:, None], -1,
                                mxu_seeds)

        scores, ids, nd = beam_search(
            state, vectors, vec_sq, q, q_sq,
            torch.cat([seeds, mxu_seeds, peer_ids], 1), ef_construction,
            metric, level=0, expand=expand, active=active,
            max_steps=max_steps_base,
            nbr_vecs=nbr_vecs, nbr_scale=nbr_scale, nbr_sq=nbr_sq)
        n_dist = n_dist + nd
        self_hit = ids == new_slots[:, None]
        ids = torch.where(self_hit, -1, ids)
        scores = torch.where(self_hit, INF_SCORE, scores)
        sel = select_diverse(vectors, vec_sq, ids, scores, m0, metric)
        sel = torch.where(active[:, None], sel, -1)
        neighbors0 = state.neighbors0.clone()
        neighbors0[safe_slots[live]] = sel[live]

    with annotate("insert.backlinks"):
        # sel is in selection order, closest first, so its first blc columns
        # ARE the closest targets
        blc = min(backlink_cols or m0, m0)
        tgt = sel[:, :blc].reshape(-1)
        src = new_slots.repeat_interleave(blc)
        act = (tgt >= 0) & (src >= 0)
        apply_backlinks(neighbors0, vectors, vec_sq, tgt, src, act,
                        torch.where(act, tgt, -1), metric, r_rounds, prune)
        # reachability floor: the nearest forward target always adopts the
        # new node (see _force_nearest_backlink)
        _force_nearest_backlink(neighbors0, vectors, vec_sq, sel[:, 0],
                                new_slots, active & (sel[:, 0] >= 0), metric,
                                r_rounds)

        # ---- entry point / max level update -----------------------------
        batch_best = torch.argmax(torch.where(active, new_levels, -1))  # first
        batch_max = new_levels[batch_best]
        promote = batch_max > state.max_level
        entry = torch.where(promote, new_slots[batch_best], state.entry_node)
        top = torch.where(promote, batch_max, state.max_level)
        # first-ever batch: entry may still be unset if all levels were 0
        need_entry = (entry < 0) & active.any()
        first_active = torch.argmax(active.to(torch.int32))
        state = state._replace(
            neighbors0=neighbors0,
            entry_node=torch.where(need_entry, new_slots[first_active],
                                   entry).to(torch.int32),
            max_level=torch.where(need_entry, top.clamp_min(0),
                                  top).to(torch.int32))
    return state, n_dist
