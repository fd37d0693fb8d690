"""Bulk HNSW construction from a kNN graph (port of
duckdb_vss_tpu/models/bulk.py).

The path a CREATE INDEX over an existing table takes:
- phase 0: every upper level is a kNN + diversity-prune graph over its
  (geometrically shrinking) node subset (_build_upper_levels);
- phase 1: kNN lists for all rows, exact below IVF_MIN_N rows and
  IVF-pruned above it (k-means, then each sorted query chunk scores only
  the members of its nearest clusters);
- phase 1.5 (IVF only): one NN-descent round (_refine_knn);
- phase 2: reverse candidates, then a per-node diversity prune over
  (kNN ∪ reverse-kNN ∪ level-1 skeleton ∪ pseudo-random links) with
  keepPruned backfill;
- phase 2.5: label-propagation + bridge-tree connectivity repair.

The JAX package chooses exact or IVF from the row count or the
DVT_BUILD_KNN environment variable; here it is the ``knn`` keyword
("auto" | "exact" | "ivf"). Its TPU-only tactics (jit programs per
shape, donated buffers, queue drains) have no counterpart: PyTorch runs
eagerly, and the tables are updated in place. The kNN sweeps score
against a bf16 copy of the store (bf16 operands, f32 sums), as in the
JAX package; the JAX package's approximate per-block top-k is exact
here (ops/topk.smallest_k).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from duckdb_vss_tpu_torch.models.build import _group_ranks, select_diverse
from duckdb_vss_tpu_torch.models.graph import (L_MAX, UPPER_DIV, GraphState,
                                               gather_scores, make_graph)
from duckdb_vss_tpu_torch.ops.distance import (dot_scores, ieee_sqrt,
                                                 score_matrix)
from duckdb_vss_tpu_torch.ops.topk import flat_topk, smallest_k
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.padding import INF_SCORE

# an add of at least this many rows into an empty graph bulk-builds
# (HNSWIndex.bulk_threshold's default; the sharded index's, summed over
# its shards); smaller adds insert incrementally
BULK_THRESHOLD = 4096

KNN_K = 48  # forward kNN candidates per node
REV_R = 16  # reverse-kNN candidates kept per node
RAND_S = 8  # pseudo-random small-world candidates per node

# IVF-pruned kNN sweep (phase 1) from this row count up
IVF_MIN_N = 131_072
# upper levels at least this large route through the same sweep
IVF_LEVEL_MIN_N = 32_768
IVF_AVG_CLUSTER = 2048  # target mean cluster size
IVF_CAND_MAX = 49_152  # candidate rows scored per query chunk
IVF_QB = 4096  # query rows per chunk (sorted-order, cluster-coherent)
IVF_KMEANS_ITERS = 4
IVF_ASSIGN_CHUNK = 65_536
# reverse-candidate source cap (phase 2): above this many flattened
# forward edges, only the closest REV_SRC_COLS ranks per node feed the
# reverse lists, through the chunked pass
REV_SRC_MAX = 128 * 1024 * 1024
REV_SRC_COLS = 12
REV_EDGE_CHUNK = 8 * 1024 * 1024
REV_MERGE_SEG = 1 << 20  # rows per merge segment of the chunked pass
# neighbors-of-neighbors refinement (phase 1.5): each node is rescored
# against the kNN lists of its REFINE_J closest current neighbors
REFINE_J = 8
REFINE_ROUNDS = 1
REFINE_SEG_ROWS = 2 * 1024 * 1024  # rows per Gauss-Seidel segment

_BIG = 2**30


def _knn_block(q_block, slots, vectors, vec_sq, valid, k, metric, block_n):
    """Top-(k+1) for one query block, self-match removed -> top-k."""
    scores, ids = flat_topk(q_block, vectors, k + 1, metric, vec_sq=vec_sq,
                            valid=valid, block_n=block_n)
    self_hit = ids == slots[:, None]
    scores = torch.where(self_hit, INF_SCORE, scores)
    ids = torch.where(self_hit, -1, ids)
    sc, pos = smallest_k(scores, k)
    return sc, torch.gather(ids, 1, pos)


def _prune_chunk(cand_ids, cand_scores, vectors, vec_sq, m_out, metric):
    """Sort candidates by score (stable) and diversity-prune to m_out."""
    s_sc, order = torch.sort(cand_scores, dim=1, stable=True)
    s_ids = torch.gather(cand_ids, 1, order)
    s_ids = torch.where(s_sc < INF_SCORE, s_ids, -1)
    return select_diverse(vectors, vec_sq, s_ids, s_sc, m_out, metric,
                          backfill=True)


def _write_level(un, upper_slot, chunk_nodes, sel, lvl_cols):
    """Scatter one chunk's level lists into their column window of the
    packed upper table. Rows are unique (one per node)."""
    us_rows = torch.where(chunk_nodes >= 0,
                          upper_slot[chunk_nodes.clamp_min(0).long()], -1)
    ok = us_rows >= 0
    un[us_rows[ok].long()[:, None], lvl_cols[None, :]] = sel[ok]


def _chunk_positions(ci, qb, n_l, device):
    pos = ci * qb + torch.arange(qb, dtype=torch.int32, device=device)
    return torch.where(pos < n_l, pos, -1)


def _upper_level_build(vectors, vec_sq, nodes_j, n_l, lv, upper_slot, un,
                       k_l, m, metric, block_n, qb, n_chunks):
    """One small upper level: kNN + diversity prune for every qb-chunk of
    the level's node set, written into the level's column window of
    ``un`` (updated in place)."""
    cap_s = nodes_j.shape[0]
    dev = vectors.device
    row_live = torch.arange(cap_s, device=dev) < n_l
    sub = torch.where(row_live[:, None], vectors[nodes_j.long()], 0.0)
    sub_sq = vec_sq[nodes_j.long()] * row_live
    sub_bf = sub.to(torch.bfloat16)
    lvl_cols = (lv - 1) * m + torch.arange(m, device=dev)
    for ci in range(n_chunks):
        posm = _chunk_positions(ci, qb, n_l, dev)
        q_block = sub[posm.clamp_min(0).long()]
        sc, ids = _knn_block(q_block, posm, sub_bf, sub_sq, row_live, k_l,
                             metric, block_n)
        sel = _prune_chunk(ids, sc, sub, sub_sq, m, metric)
        sel_global = torch.where(sel >= 0, nodes_j[sel.clamp_min(0).long()],
                                 -1)
        chunk_nodes = torch.where(posm >= 0,
                                  nodes_j[posm.clamp_min(0).long()], -1)
        _write_level(un, upper_slot, chunk_nodes, sel_global, lvl_cols)
    return un


def _upper_level_from_knn(vectors, vec_sq, nodes_j, n_l, lv, upper_slot,
                          knn_ids, knn_sc, un, m, metric, qb, n_chunks):
    """A large upper level from precomputed kNN tables ([cap_s, K] in the
    level's local row order, holding global slot ids): per chunk,
    diversity-prune each node's list to m and write it into ``un``."""
    dev = vectors.device
    lvl_cols = (lv - 1) * m + torch.arange(m, device=dev)
    for ci in range(n_chunks):
        posm = _chunk_positions(ci, qb, n_l, dev)
        safe = posm.clamp_min(0).long()
        chunk_nodes = torch.where(posm >= 0, nodes_j[safe], -1)
        ids = torch.where(chunk_nodes[:, None] >= 0, knn_ids[safe], -1)
        sc = torch.where(ids >= 0, knn_sc[safe], INF_SCORE)
        sel = _prune_chunk(ids, sc, vectors, vec_sq, m, metric)
        _write_level(un, upper_slot, chunk_nodes, sel, lvl_cols)
    return un


def _reverse_candidates(knn_ids, knn_scores, rev_r):
    """[N, K] forward lists -> [N, rev_r] reverse candidates per node: for
    every edge (u -> v) record u as a candidate of v, keeping the rev_r
    closest per target (rank within the target's group)."""
    n, kk = knn_ids.shape
    src = torch.arange(n, dtype=torch.int32,
                       device=knn_ids.device).repeat_interleave(kk)
    tgt = knn_ids.reshape(-1)
    dist = knn_scores.reshape(-1)
    act = tgt >= 0
    ranks = _group_ranks(torch.where(act, tgt, -1), dist)
    keep = act & (ranks < rev_r)
    out = torch.full((n, rev_r), -1, dtype=torch.int32, device=knn_ids.device)
    out[tgt[keep].long(), ranks[keep].long()] = src[keep]
    return out


def _pow2_divisor(cap: int, target: int, base: int = 16384) -> int:
    """Largest base*2^j <= target that divides cap (0 if none)."""
    if cap % base != 0:
        return 0
    d = base
    while d * 2 <= min(target, cap) and cap % (d * 2) == 0:
        d *= 2
    return d if d <= cap else 0


def _reverse_candidates_chunked(knn_ids, knn_sc, rev_r, n_cols):
    """Chunked-edge-list variant of _reverse_candidates (same result: the
    rev_r closest sources per target, closest first, -1 padded). Each
    source-row chunk ranks its edges within their target groups, and
    its winners merge into a running [cap, rev_r] table; a target's
    global top-rev_r is a subset of the union of its per-chunk
    top-rev_r's, so the merge is exact."""
    cap = knn_ids.shape[0]
    dev = knn_ids.device
    rows_target = max(16384, REV_EDGE_CHUNK // max(n_cols, 1))
    rows_chunk = _pow2_divisor(cap, rows_target)
    seg = _pow2_divisor(cap, REV_MERGE_SEG)
    if rows_chunk == 0 or seg == 0:  # non-block-rounded capacity
        return _reverse_candidates(
            knn_ids[:, :n_cols], knn_sc[:, :n_cols], rev_r)
    best_ids = torch.full((cap, rev_r), -1, dtype=torch.int32, device=dev)
    best_sc = torch.full((cap, rev_r), INF_SCORE, dtype=torch.float32,
                         device=dev)
    for off in range(0, cap, rows_chunk):
        tgt = knn_ids[off:off + rows_chunk, :n_cols].reshape(-1)
        dist = knn_sc[off:off + rows_chunk, :n_cols].reshape(-1)
        src = (off + torch.arange(rows_chunk, dtype=torch.int32, device=dev)
               ).repeat_interleave(n_cols)
        act = tgt >= 0
        ranks = _group_ranks(torch.where(act, tgt, -1), dist)
        keep = act & (ranks < rev_r)
        row, col = tgt[keep].long(), ranks[keep].long()
        chunk_ids = torch.full_like(best_ids, -1)
        chunk_sc = torch.full_like(best_sc, INF_SCORE)
        chunk_ids[row, col] = src[keep]
        chunk_sc[row, col] = dist[keep]
        for start in range(0, cap, seg):
            cat_i = torch.cat([best_ids[start:start + seg],
                               chunk_ids[start:start + seg]], 1)
            cat_s = torch.cat([best_sc[start:start + seg],
                               chunk_sc[start:start + seg]], 1)
            m_s, order = torch.sort(cat_s, dim=1, stable=True)
            m_s = m_s[:, :rev_r]
            m_i = torch.gather(cat_i, 1, order[:, :rev_r])
            best_ids[start:start + seg] = torch.where(m_s < INF_SCORE, m_i, -1)
            best_sc[start:start + seg] = m_s
    return best_ids


# ---------------------------------------------------------------------------
# IVF-pruned kNN sweep
# ---------------------------------------------------------------------------


def _kmeans_rows(vectors, vec_sq, slots, normalize):
    """The f32 rows k-means clusters (unit length for cosine and ip)."""
    safe = slots.clamp_min(0).long()
    x = vectors[safe].float()
    if normalize:
        x = x * torch.rsqrt(torch.clamp_min(vec_sq[safe], 1e-30))[:, None]
    return x


def _kmeans_assign(vectors, vec_sq, slot_chunks, centers, normalize):
    """Each row's nearest center in l2 (bf16 products), one slot chunk
    at a time: asg [n_chunks*AB] int32."""
    c_bf = centers.to(torch.bfloat16)
    c_sq = (centers * centers).sum(1)
    asgs = []
    for sl in slot_chunks:
        x = _kmeans_rows(vectors, vec_sq, sl, normalize)
        d2 = c_sq[None, :] - 2.0 * dot_scores(x.to(torch.bfloat16), c_bf)
        asgs.append(torch.argmin(d2, dim=1).to(torch.int32))
    return torch.cat(asgs)


def _kmeans_pass(vectors, vec_sq, slot_chunks, centers, normalize):
    """One Lloyd iteration over slot chunks: assign + accumulate.

    slot_chunks [n_chunks, AB] (-1 pad). Returns (new_centers, asg
    [n_chunks*AB] int32, counts [C]). Clustering always runs in l2 space
    (cosine and ip rows are normalized first): a routing heuristic.

    Each center's sum adds its rows one after another from zero, in
    slot-chunk order: the order of the JAX package's scatter-add on the
    CPU, and one order on every device (a scatter-add on the GPU adds
    with float atomics, in whatever order they land, so two builds on
    one seed would differ). The sums run over whole centers at a time,
    at most AB rows of them (a larger center alone), so no more rows
    are held at once than in the assignment."""
    c, ab = centers.shape[0], slot_chunks.shape[1]
    asg = _kmeans_assign(vectors, vec_sq, slot_chunks, centers, normalize)
    slots = slot_chunks.reshape(-1)
    live = slots >= 0
    counts = torch.bincount(asg[live], minlength=c).to(torch.int32)
    # a stable sort by center puts each center's rows together, in order
    by_center = torch.sort(torch.where(live, asg, c), stable=True).indices
    ends = np.cumsum(counts.cpu().numpy())
    sums = torch.empty_like(centers)
    lo = start = 0
    while lo < c:
        hi = max(lo + 1, int(np.searchsorted(ends, start + ab, "right")))
        rows = slots[by_center[start:int(ends[hi - 1])]]
        sums[lo:hi] = torch.segment_reduce(
            _kmeans_rows(vectors, vec_sq, rows, normalize), "sum",
            lengths=counts[lo:hi], axis=0)
        lo, start = hi, int(ends[hi - 1])
    new_centers = torch.where((counts > 0)[:, None],
                              sums / torch.clamp_min(counts, 1)[:, None],
                              centers)
    return new_centers, asg, counts


def _refine_chunk(vectors_bf, vec_sq, knn_ids, sl, metric):
    """Refined top-K lists for one chunk of rows: each row rescored
    against its own list ∪ the lists of its REFINE_J closest neighbors."""
    kk = knn_ids.shape[1]
    j = min(REFINE_J, kk)
    qb = sl.shape[0]
    safe = sl.clamp_min(0).long()
    own = knn_ids[safe]  # [qb, K]
    hop = knn_ids[own[:, :j].clamp_min(0).long()]  # [qb, j, K]
    hop = torch.where((own[:, :j] >= 0)[..., None], hop, -1)
    cand = torch.cat([own, hop.reshape(qb, j * kk)], dim=1)
    # drop self and duplicates (selection below is order-free)
    cand = torch.where(cand == sl[:, None], -1, cand)
    c_sorted = torch.sort(cand, dim=1).values
    dup = torch.zeros_like(c_sorted, dtype=torch.bool)
    dup[:, 1:] = c_sorted[:, 1:] == c_sorted[:, :-1]
    c_sorted = torch.where(dup, -1, c_sorted)
    c_safe = c_sorted.clamp_min(0).long()
    q = vectors_bf[safe].float()
    q_sq = vec_sq[safe]
    dot = torch.bmm(vectors_bf[c_safe].float(), q[:, :, None])[:, :, 0]
    c_sq = vec_sq[c_safe]
    if metric == MetricKind.IP:
        sc = 1.0 - dot
    elif metric == MetricKind.L2SQ:
        sc = torch.clamp_min(q_sq[:, None] - 2.0 * dot + c_sq, 0.0)
    else:  # cosine (zero-norm rows score 1, matching score_matrix)
        denom = ieee_sqrt(torch.clamp_min(q_sq[:, None] * c_sq, 1e-30))
        sc = torch.where((q_sq[:, None] <= 0) | (c_sq <= 0), 1.0,
                         1.0 - dot / denom)
    sc = torch.where((c_sorted >= 0) & (sl[:, None] >= 0), sc, INF_SCORE)
    # own list is inside cand, so top-K over cand can only improve
    new_sc, pos = smallest_k(sc, kk)
    new_ids = torch.gather(c_sorted, 1, pos)
    return torch.where(new_sc < INF_SCORE, new_ids, -1), new_sc


def _refine_knn(vectors_bf, vec_sq, knn_ids, knn_sc, slots_t, qb, metric):
    """One NN-descent round over the kNN tables (updated in place). Within
    a segment every chunk reads the tables as they were at its start
    (the JAX package's gather-only segment program); segments apply in
    order, so later segments see earlier refinements."""
    n = slots_t.shape[0]
    seg = min(REFINE_SEG_ROWS, -(-n // qb) * qb)
    for off in range(0, n, seg):
        chunk = slots_t[off:off + seg]
        sl_seg = torch.full((seg,), -1, dtype=torch.int32,
                            device=slots_t.device)
        sl_seg[:chunk.shape[0]] = chunk
        outs = [_refine_chunk(vectors_bf, vec_sq, knn_ids,
                              sl_seg[c:c + qb], metric)
                for c in range(0, seg, qb)]
        upd_ids = torch.cat([o[0] for o in outs])
        upd_sc = torch.cat([o[1] for o in outs])
        ok = sl_seg >= 0
        rows = sl_seg[ok].long()
        knn_ids[rows] = upd_ids[ok]
        knn_sc[rows] = upd_sc[ok]
    return knn_ids, knn_sc


def _ivf_knn_scan(q_chunks, cand_chunks, vectors, vectors_bf, vec_sq, cap, k,
                  metric):
    """Score every query chunk against its candidate slots; scatter the
    per-row top-k (self removed) into [cap, k] tables."""
    dev = vectors.device
    knn_ids = torch.full((cap, k), -1, dtype=torch.int32, device=dev)
    knn_sc = torch.full((cap, k), INF_SCORE, dtype=torch.float32, device=dev)
    for q_slots, cand_slots in zip(q_chunks, cand_chunks):
        q_safe = q_slots.clamp_min(0).long()
        c_safe = cand_slots.clamp_min(0).long()
        s = score_matrix(vectors[q_safe].to(vectors_bf.dtype),
                         vectors_bf[c_safe], metric, vec_sq=vec_sq[c_safe],
                         query_sq=vec_sq[q_safe])
        s = torch.where((cand_slots >= 0)[None, :], s, INF_SCORE)
        sc, pos = smallest_k(s, k + 1)
        ids = cand_slots[pos]
        sc = torch.where(ids == q_slots[:, None], INF_SCORE, sc)
        ids = torch.where(sc < INF_SCORE, ids, -1)
        sc_k, p2 = smallest_k(sc, k)
        ok = q_slots >= 0
        rows = q_slots[ok].long()
        knn_ids[rows] = torch.gather(ids, 1, p2)[ok]
        knn_sc[rows] = sc_k[ok]
    return knn_ids, knn_sc


def _ivf_candidates(asg, slots, centers, qb, cand_max):
    """Host-side probe assembly. Rows sorted by cluster; each qb-chunk of
    sorted rows gets the members of the clusters nearest to its present
    clusters (full clusters, nearest-first) up to cand_max slots.

    Returns (q_slot_chunks [nc, qb], cand_slot_chunks [nc, cand_max])."""
    n = len(slots)
    c = len(centers)
    order = np.argsort(asg, kind="stable")
    slots_sorted = slots[order]
    asg_sorted = asg[order]
    counts = np.bincount(asg, minlength=c)
    starts = np.zeros(c + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    c_sq = (centers * centers).sum(1)
    cd = c_sq[:, None] - 2.0 * (centers @ centers.T) + c_sq[None, :]
    nc = -(-n // qb)
    q_chunks = np.full((nc, qb), -1, np.int32)
    cand = np.full((nc, cand_max), -1, np.int32)
    for ci in range(nc):
        lo, hi = ci * qb, min(n, (ci + 1) * qb)
        q_chunks[ci, : hi - lo] = slots_sorted[lo:hi]
        c_lo, c_hi = int(asg_sorted[lo]), int(asg_sorted[hi - 1])
        d_min = cd[c_lo : c_hi + 1].min(axis=0)  # [C]
        near = np.argsort(d_min, kind="stable")
        fill = 0
        for cc in near:
            s, e = int(starts[cc]), int(starts[cc + 1])
            take = min(e - s, cand_max - fill)
            if take > 0:
                cand[ci, fill : fill + take] = slots_sorted[s : s + take]
                fill += take
            if fill >= cand_max:
                break
    return q_chunks, cand


def _n_clusters(n: int) -> int:
    target = max(1, n // IVF_AVG_CLUSTER)
    return int(np.clip(1 << int(round(np.log2(target))), 64, 2048))


def _ivf_knn_sweep(vectors, vectors_bf, vec_sq, slots, knn_k, metric):
    """IVF-pruned kNN lists for all rows: (knn_ids, knn_sc) [cap, K]."""
    n = len(slots)
    cap = vectors.shape[0]
    dev = vectors.device
    c = _n_clusters(n)
    # cluster directions for cosine and ip (spherical k-means): raw-l2
    # clusters are a poor proxy for ip on variable-norm data
    normalize = metric in (MetricKind.COSINE, MetricKind.IP)
    ab = min(IVF_ASSIGN_CHUNK, n)  # no all-pad chunk rows below 64k rows
    n_pad = -(-n // ab) * ab
    slot_chunks = np.full((n_pad,), -1, np.int32)
    slot_chunks[:n] = slots
    slot_chunks_t = torch.from_numpy(slot_chunks.reshape(-1, ab)).to(dev)
    init_idx = np.linspace(0, n - 1, c).astype(np.int64)
    centers = vectors[torch.from_numpy(
        slots[init_idx].astype(np.int64)).to(dev)].float()
    if normalize:
        csq = (centers * centers).sum(1)
        centers = centers * torch.rsqrt(torch.clamp_min(csq, 1e-30))[:, None]
    for _ in range(IVF_KMEANS_ITERS):
        centers, _asg, _counts = _kmeans_pass(
            vectors, vec_sq, slot_chunks_t, centers, normalize)
    # a final assignment-only pass, so the probe lists are built against
    # the same centers _ivf_candidates ranks with
    asg = _kmeans_assign(vectors, vec_sq, slot_chunks_t, centers, normalize)
    asg_np = asg.cpu().numpy()[:n]
    centers_np = centers.cpu().numpy().astype(np.float32)
    q_chunks, cand = _ivf_candidates(asg_np, np.asarray(slots, np.int32),
                                     centers_np, IVF_QB, IVF_CAND_MAX)
    # columns that are padding in every chunk only ever score INF: drop
    # them (below IVF_CAND_MAX rows every chunk probes all rows)
    width = max(int((cand >= 0).sum(1).max()), knn_k + 1)
    cand = np.ascontiguousarray(cand[:, :width])
    return _ivf_knn_scan(torch.from_numpy(q_chunks).to(dev),
                         torch.from_numpy(cand).to(dev), vectors, vectors_bf,
                         vec_sq, cap, knn_k, metric)


# ---------------------------------------------------------------------------
# phase 0: upper levels
# ---------------------------------------------------------------------------


def _build_upper_levels(vectors, vec_sq, slots, levels, m, metric, cap,
                        query_block=4096, vectors_bf=None):
    """Every upper level as a kNN + diversity-prune graph over its node
    subset; lists are forward-only (search never needs back-edges).

    Returns (upper_neighbors [cap_u, L_MAX*m], upper_slot [cap],
    upper_node [cap_u], upper_count, entry_node, max_level, lv_clamped
    [n] — levels after upper-capacity clamping)."""
    dev = vectors.device
    cap_u = max(cap // UPPER_DIV, 64)
    up_slots = slots[levels >= 1]
    n_up = min(len(up_slots), cap_u)  # overflow clamps to level 0
    up_slots = up_slots[:n_up]
    upper_slot_np = np.full((cap,), -1, np.int32)
    upper_slot_np[up_slots] = np.arange(n_up, dtype=np.int32)
    upper_node_np = np.full((cap_u,), -1, np.int32)
    upper_node_np[:n_up] = up_slots
    un = torch.full((cap_u, L_MAX * m), -1, dtype=torch.int32, device=dev)
    upper_slot = torch.from_numpy(upper_slot_np).to(dev)
    upper_node = torch.from_numpy(upper_node_np).to(dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    # overflow-clamped nodes are level 0 everywhere (levels array, entry,
    # max_level) so the graph stays self-consistent
    lv_clamped = np.where(upper_slot_np[slots] >= 0, levels, 0)
    max_level = int(lv_clamped.max()) if len(levels) else -1
    if max_level < 0:
        return (un, upper_slot, upper_node, scalar(0), scalar(-1),
                scalar(-1), lv_clamped)
    entry = int(slots[lv_clamped == max_level][0])
    for lv in range(1, min(max_level, L_MAX) + 1):
        nodes_l = slots[lv_clamped >= lv]
        n_l = len(nodes_l)
        if n_l < 2:
            continue
        cap_s = max(256, 1 << (n_l - 1).bit_length())
        pad_nodes = np.zeros((cap_s,), np.int32)
        pad_nodes[:n_l] = nodes_l
        nodes_j = torch.from_numpy(pad_nodes).to(dev)
        k_l = min(2 * m, cap_s - 1)
        block_n = cap_s if cap_s < 16384 else 16384
        qb = min(query_block, cap_s)
        n_chunks = -(-cap_s // qb)
        if n_l >= IVF_LEVEL_MIN_N:
            # large level (level 1 at >= ~500k rows): the IVF sweep on the
            # level's node subset, compacted to the level's rows
            vbf = vectors_bf if vectors_bf is not None else vectors.to(
                torch.bfloat16)
            lids, lsc = _ivf_knn_sweep(vectors, vbf, vec_sq, nodes_l, k_l,
                                       metric)
            lids, lsc = lids[nodes_j.long()], lsc[nodes_j.long()]
            un = _upper_level_from_knn(vectors, vec_sq, nodes_j, n_l, lv,
                                       upper_slot, lids, lsc, un, m, metric,
                                       qb, n_chunks)
        else:
            un = _upper_level_build(vectors, vec_sq, nodes_j, n_l, lv,
                                    upper_slot, un, k_l, m, metric, block_n,
                                    qb, n_chunks)
    return (un, upper_slot, upper_node, scalar(n_up), scalar(entry),
            scalar(max_level), lv_clamped)


# ---------------------------------------------------------------------------
# bulk_build
# ---------------------------------------------------------------------------


def _bulk_prune_step(neighbors0, knn_ids, knn_sc, rev, un, upper_slot,
                     vectors, vec_sq, chunk_slots, live_slots, m0, m, metric):
    """Diversity-prune one chunk of nodes to M0 base-layer neighbors,
    written into ``neighbors0`` in place."""
    safe = chunk_slots.clamp_min(0).long()
    fwd_i = knn_ids[safe]  # [CH, K]
    fwd_s = knn_sc[safe]
    rev_i = rev[safe]  # [CH, R]
    # level-1 skeleton edges from the packed upper table (columns 0..m)
    us = upper_slot[safe]
    skel_i = torch.where((us >= 0)[:, None], un[us.clamp_min(0).long()][:, :m],
                         -1)
    # deterministic pseudo-random long-range candidates: the JAX
    # package's uint32 hash, in int64 with explicit 32-bit wraps
    n_live = live_slots.shape[0]
    j = torch.arange(RAND_S, dtype=torch.int64, device=safe.device)[None, :]
    h = ((safe[:, None] * 2654435761) & 0xFFFFFFFF) + j * 40503
    h = (h & 0xFFFFFFFF) % n_live
    rand_i = live_slots[h]
    extra_i = torch.cat([rev_i, skel_i, rand_i], dim=1)
    # drop extras already in the forward list, duplicated, or self
    dup_fwd = (extra_i[:, :, None] == fwd_i[:, None, :]).any(dim=2)
    dup_self = torch.triu(extra_i[:, :, None] == extra_i[:, None, :],
                          1).any(dim=1)
    self_hit = extra_i == chunk_slots[:, None]
    extra_i = torch.where(dup_fwd | dup_self | self_hit, -1, extra_i)
    extra_s = gather_scores(vectors, vec_sq, extra_i, vectors[safe],
                            vec_sq[safe], metric)
    extra_s = torch.where(extra_i >= 0, extra_s, INF_SCORE)
    cand_i = torch.cat([fwd_i, extra_i], dim=1)
    cand_s = torch.cat([fwd_s, extra_s], dim=1)
    cand_i = torch.where(chunk_slots[:, None] >= 0, cand_i, -1)
    sel = _prune_chunk(cand_i, cand_s, vectors, vec_sq, m0, metric)
    ok = chunk_slots >= 0
    neighbors0[chunk_slots[ok].long()] = sel[ok]


def _padded_chunk(slots_t, off, size):
    chunk = slots_t[off:off + size]
    if chunk.shape[0] < size:
        chunk = torch.cat([chunk, chunk.new_full((size - chunk.shape[0],), -1)])
    return chunk


def bulk_build(
    vectors: torch.Tensor,  # [cap, D] padded store (first n rows live)
    vec_sq: torch.Tensor,
    slots: np.ndarray,  # [n] int32 slot ids of the rows to index
    levels: np.ndarray,  # [n] int32 sampled levels
    config: HNSWConfig,
    metric: MetricKind,
    query_block: int = 8192,
    knn_k: int = KNN_K,
    rev_r: int = REV_R,
    prune_chunk: int = 8192,
    host_vectors: np.ndarray | None = None,  # original rows, for repair
    stats_out: dict | None = None,
    knn: str = "auto",
) -> GraphState:
    """Build a fresh GraphState over ``slots`` (an empty-graph bulk load).

    ``knn`` chooses phase 1: "exact" (blockwise sweep), "ivf" (k-means
    pruned sweep + one NN-descent round) or "auto" (IVF from IVF_MIN_N
    rows). ``stats_out``, if given, receives "n_distances" (the analytic
    count of distance evaluations) and "phase_s" (seconds per phase,
    each ended by a device synchronize)."""
    if knn not in ("auto", "exact", "ivf"):
        raise ValueError(f"knn must be auto, exact or ivf, got {knn!r}")
    dev = vectors.device
    phase_s: dict[str, float] = {}
    t0 = [time.perf_counter()]

    def mark(phase):
        if stats_out is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            phase_s[phase] = now - t0[0]
            t0[0] = now

    cap = vectors.shape[0]
    n = len(slots)
    m, m0 = config.m, config.m0
    levels = np.minimum(np.asarray(levels, np.int32), L_MAX)
    slots = np.asarray(slots, np.int32)
    slots_t = torch.from_numpy(slots).to(dev)
    valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
    valid[slots_t.long()] = True

    # ---- 0. upper levels --------------------------------------------
    state = make_graph(cap, m, m0, dev)
    vectors_bf = vectors.to(torch.bfloat16)
    (un, upper_slot, upper_node, upper_count, entry, max_lv,
     lv_clamped) = _build_upper_levels(
        vectors, vec_sq, slots, levels, m, metric, cap,
        query_block=query_block, vectors_bf=vectors_bf)
    lv_of_slot = np.full((cap,), -1, np.int32)
    lv_of_slot[slots] = lv_clamped
    state = state._replace(
        upper_neighbors=un, upper_slot=upper_slot, upper_node=upper_node,
        upper_count=upper_count, levels=torch.from_numpy(lv_of_slot).to(dev),
        entry_node=entry, max_level=max_lv)
    max_level = int(max_lv)
    if max_level < 0 and n:
        state = state._replace(
            entry_node=torch.tensor(int(slots[0]), dtype=torch.int32,
                                    device=dev),
            max_level=torch.tensor(0, dtype=torch.int32, device=dev))
    mark("phase0_upper_levels")

    # ---- 1. kNN sweep (bf16 table) ------------------------------------
    use_ivf = knn == "ivf" or (knn == "auto" and n >= IVF_MIN_N)
    qb = query_block
    if use_ivf:
        knn_ids, knn_sc = _ivf_knn_sweep(vectors, vectors_bf, vec_sq, slots,
                                         knn_k, metric)
    else:
        knn_ids = torch.full((cap, knn_k), -1, dtype=torch.int32, device=dev)
        knn_sc = torch.full((cap, knn_k), INF_SCORE, dtype=torch.float32,
                            device=dev)
        block_n = min(16384, cap)
        for off in range(0, n, qb):
            chunk = _padded_chunk(slots_t, off, qb)
            sc, ids = _knn_block(vectors[chunk.clamp_min(0).long()], chunk,
                                 vectors_bf, vec_sq, valid, knn_k, metric,
                                 block_n)
            take = min(qb, n - off)
            rows = chunk[:take].long()
            knn_ids[rows] = ids[:take]
            knn_sc[rows] = sc[:take]
    mark("phase1_knn_sweep")
    if use_ivf:
        # NN-descent: the IVF sweep misses ~1% of true neighbors
        # (cluster-boundary rows outside the probed set); one
        # neighbors-of-neighbors pass recovers most of them
        for _ in range(REFINE_ROUNDS):
            knn_ids, knn_sc = _refine_knn(vectors_bf, vec_sq, knn_ids,
                                          knn_sc, slots_t, qb, metric)
        mark("phase1.5_refine")
    del vectors_bf

    # ---- 2. reverse candidates + diversity prune to M0 --------------
    rev_cols = knn_ids.shape[1]
    if cap * rev_cols > REV_SRC_MAX:
        rev_cols = min(rev_cols, REV_SRC_COLS)
        if cap > 8 * 1024 * 1024:
            rev_r = min(rev_r, 8)
        rev = _reverse_candidates_chunked(knn_ids, knn_sc, rev_r, rev_cols)
    else:
        rev = _reverse_candidates(knn_ids[:, :rev_cols],
                                  knn_sc[:, :rev_cols], rev_r)
    neighbors0 = state.neighbors0
    for off in range(0, n, prune_chunk):
        _bulk_prune_step(neighbors0, knn_ids, knn_sc, rev, un, upper_slot,
                         vectors, vec_sq, _padded_chunk(slots_t, off,
                                                        prune_chunk),
                         slots_t, m0, m, metric)
    mark("phase2_prune")

    # ---- 2.5 connectivity repair --------------------------------------
    del knn_ids, knn_sc, rev
    labels = _component_labels(neighbors0, valid)
    if host_vectors is not None:
        _bridge_components(neighbors0, labels.cpu().numpy(),
                           np.asarray(host_vectors, np.float32), slots)
    mark("phase2.5_repair")
    if stats_out is not None:
        stats_out["n_distances"] = _distance_cost(
            n, cap, lv_clamped, max_level, use_ivf, query_block, knn_k,
            rev_r, config.m0)
        stats_out["phase_s"] = phase_s
    return state._replace(neighbors0=neighbors0)


def _ivf_distance_cost(n: int) -> int:
    """Distances the IVF-pruned sweep computes for n rows: k-means passes
    (IVF_KMEANS_ITERS + 1 final assign) plus the per-chunk scoring, at
    the JAX package's padded shapes (so both packages report one count)."""
    c = _n_clusters(n)
    n_pad = -(-n // IVF_ASSIGN_CHUNK) * IVF_ASSIGN_CHUNK
    kmeans = (IVF_KMEANS_ITERS + 1) * n_pad * c
    sweep = -(-n // IVF_QB) * IVF_QB * IVF_CAND_MAX
    return kmeans + sweep


def _distance_cost(n, cap, lv_clamped, max_level, use_ivf, query_block,
                   knn_k, rev_r, m0) -> int:
    """Analytic count of distance evaluations for one bulk_build, from
    the same branch conditions and padded shapes the phases used."""
    nd = 0
    for lv in range(1, min(max_level, L_MAX) + 1):
        n_l = int((lv_clamped >= lv).sum())
        if n_l < 2:
            continue
        cap_s = max(256, 1 << (n_l - 1).bit_length())
        qb_l = min(query_block, cap_s)
        if n_l >= IVF_LEVEL_MIN_N:
            nd += _ivf_distance_cost(n_l)
        else:
            nd += -(-cap_s // qb_l) * qb_l * cap_s
    if use_ivf:
        nd += _ivf_distance_cost(n)
    else:
        nd += -(-n // query_block) * query_block * cap
    n_cand = knn_k + rev_r + m0 + RAND_S
    nd += n * (n_cand - knn_k)  # gather_scores on the extras
    nd += n * n_cand * n_cand  # select_diverse pairwise matrix
    return nd


# ---------------------------------------------------------------------------
# connectivity repair: kNN graphs on clustered data form islands; HNSW
# requires reachability from the entry point. Label propagation finds the
# weakly-connected components on the device; a Prim tree over component
# representatives adds bidirectional bridge edges.
# ---------------------------------------------------------------------------


def _component_labels(neighbors, node_mask, max_iters=128):
    """Weakly-connected component labels via min-label propagation:
    labels [N] (min slot id in the component; 2^30 for masked-out rows).
    One host check of convergence per sweep."""
    n = neighbors.shape[0]
    labels = torch.where(node_mask, torch.arange(
        n, dtype=torch.int32, device=neighbors.device), _BIG)
    for _ in range(max_iters):
        new = _label_sweep(neighbors, node_mask, labels)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def _label_sweep(neighbors, node_mask, labels):
    """One min-label propagation sweep (edges forward, then reverse, one
    column at a time so every temporary is [N]-sized), followed by three
    pointer-doubling hops."""
    n, m = neighbors.shape
    fwd = labels.clone()
    for j in range(m):  # node takes the min over its out-neighbors
        nb = neighbors[:, j]
        lab_nb = torch.where(nb >= 0, labels[nb.clamp_min(0).long()], _BIG)
        fwd = torch.minimum(fwd, lab_nb)
    new = fwd.clone()
    for j in range(m):  # and scatters its label into them
        nb = neighbors[:, j]
        has = nb >= 0
        new.scatter_reduce_(0, nb[has].long(), fwd[has], reduce="amin")
    for _ in range(3):
        # label[i] is a slot in i's own component, so label[label[i]]
        # is a valid (possibly smaller) member label
        lab2 = new[new.clamp(0, n - 1).long()]
        new = torch.where(node_mask, torch.minimum(new, lab2), _BIG)
    return new


def _bridge_components(neighbors0, labels_np, host_vecs, slots):
    """Add bidirectional bridge edges (in place) so all components are
    reachable. labels_np [cap], host_vecs [n, D] aligned with slots.
    Returns the number of bridges added."""
    live = labels_np[slots]
    comps, inv, counts = np.unique(live, return_inverse=True,
                                   return_counts=True)
    n_comp = len(comps)
    if n_comp <= 1:
        return 0
    # representative of each component: member closest to the comp mean
    members_all = np.argsort(inv, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(counts)])
    reps = np.empty(n_comp, np.int64)  # index into slots
    rep_vecs = np.empty((n_comp, host_vecs.shape[1]), np.float32)
    for c in range(n_comp):
        members = members_all[bounds[c]:bounds[c + 1]]
        mv = host_vecs[members]
        mean = mv.mean(axis=0)
        best = members[np.argmin(((mv - mean) ** 2).sum(1))]
        reps[c] = best
        rep_vecs[c] = host_vecs[best]
    d2 = np.empty((n_comp, n_comp), np.float32)
    for lo in range(0, n_comp, 256):  # row blocks bound the [.,.,D] temp
        d2[lo:lo + 256] = ((rep_vecs[lo:lo + 256, None, :]
                            - rep_vecs[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    # Prim's tree over representatives, rooted at the largest component
    root = int(np.argmax(counts))
    in_tree = np.zeros(n_comp, bool)
    in_tree[root] = True
    best_d = d2[root].copy()
    parent = np.full(n_comp, root, np.int64)
    bridges = []
    for _ in range(n_comp - 1):
        b = int(np.argmin(np.where(in_tree, np.inf, best_d)))
        a = int(parent[b])
        bridges.append((int(slots[reps[a]]), int(slots[reps[b]])))
        in_tree[b] = True
        closer = (d2[b] < best_d) & ~in_tree
        best_d[closer] = d2[b][closer]
        parent[closer] = b
    # install bridges bidirectionally into the last (least useful) slot
    # of each endpoint's list; a node in several bridges keeps the last
    last = {}
    for a, b in bridges:
        last[a] = b
        last[b] = a
    dev = neighbors0.device
    rows = torch.tensor(list(last.keys()), dtype=torch.int64, device=dev)
    vals = torch.tensor(list(last.values()), dtype=torch.int32, device=dev)
    neighbors0[rows, neighbors0.shape[1] - 1] = vals
    return len(bridges)
