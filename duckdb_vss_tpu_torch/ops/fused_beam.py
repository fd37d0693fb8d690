"""The fused base-layer beam search: kernel K1 on the H100, and its plain
PyTorch version (port of duckdb_vss_tpu/ops/pallas_beam.py).

``fused_beam_search`` runs the whole base-layer beam search for a batch
of queries, for at most ``max_steps`` steps. Each step, per query:
  1. pick the E best unexpanded beam entries (E argmin passes, ties to
     the lowest position: on an ascending beam, the first E positions
     that are unexpanded and finite);
  2. fetch each one's packed meta row (pack_meta: M0 neighbor ids, M0
     dequant scales, M0 squared norms) and its int8 [M0, D] neighbor
     tile (graph.make_neighborhood_tables);
  3. score int8 x bf16(q) products (rounded to bf16) summed in f32 in
     the order of ``ordered_row_sum``, times the scale, then the metric
     epilogue;
  4. drop id < 0, dead selections, ids already in the beam and repeats
     within the block (first copy kept);
  5. merge with the ascending beam and keep the top ef (stable: beam
     entries before candidates, candidates in block order).
A step that selects nothing changes nothing, and neither does any step
after it: the kernel stops there, the plain version runs the fixed trip
count, and the two agree.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/fused_beam.cu, built with nvcc for sm_90a at first use into
build/kernels/ and bound through ctypes) or raises. On a CPU tensor it
runs ``beam_search_plain``, the same algorithm in plain PyTorch (a
replica of the JAX package's test oracle, tests/test_pallas_beam.py).
"""

from __future__ import annotations

import ctypes

import torch

from duckdb_vss_tpu_torch.ops import cuda_build
from duckdb_vss_tpu_torch.ops.cuda_build import (MAX_SMEM_BYTES, METRIC_CODE,
                                                check_tensor)
from duckdb_vss_tpu_torch.ops.distance import ieee_sqrt
from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.padding import INF_SCORE

_EPS = 1e-30

KERNEL = "fused_beam"
SOURCE = cuda_build.source_path(KERNEL)
_lib: ctypes.CDLL | None = None


def pack_meta(neighbors0: torch.Tensor, nbr_scale: torch.Tensor,
              nbr_sq: torch.Tensor) -> torch.Tensor:
    """Packed per-node meta row: [M0 ids (i32) | M0 scales (f32 bits) |
    M0 norms (f32 bits) | -1 pad], padded to a multiple of 128 ints as
    in the JAX package (the kernel reads only the first 3*M0)."""
    m0 = neighbors0.shape[1]
    row = torch.cat([neighbors0.to(torch.int32),
                     nbr_scale.contiguous().view(torch.int32),
                     nbr_sq.contiguous().view(torch.int32)], dim=1)
    width = ((3 * m0 + 127) // 128) * 128
    if width != 3 * m0:
        row = torch.cat([row, row.new_full((row.shape[0], width - 3 * m0),
                                           -1)], dim=1)
    return row


def smem_bytes(ef: int, expand: int, m0: int, d: int) -> int:
    """Dynamic shared memory of one kernel block, the layout that
    fused_beam.cu carves out of what the wrapper passes it: the E int8
    tiles, the E staged meta rows (16-byte multiples), the query in
    bf16, the survivors' 8-byte keys and the two copy barriers, then
    4-byte words: the dedup's hash table (ids and positions, more than
    ef + C slots each), two beams (scores, ids, expanded flags), the
    survivors' ids, the kept list, the selected nodes and a few
    counters."""
    c = expand * m0
    meta_row = (3 * m0 + 3) // 4 * 4
    slots = 1 << (ef + c).bit_length()
    words = 2 * slots + 6 * ef + 2 * c + expand + 4
    return c * d + expand * meta_row * 4 + 2 * d + 8 * (c + 2) + 4 * words


def check_kernel_shapes(ef: int, expand: int, m0: int, d: int) -> None:
    """Raise for shapes the kernel does not take. It never clamps."""
    if ef < 1 or expand < 1 or m0 < 1 or expand > ef:
        raise ValueError(f"bad beam shape ef={ef} expand={expand} m0={m0}")
    if d % 16:
        raise ValueError(f"d={d} must be a multiple of 16 (16-byte tile "
                         "copies and loads)")
    need = smem_bytes(ef, expand, m0, d)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused beam needs {need} bytes of shared memory for ef={ef}, "
            f"expand={expand}, M0={m0}, d_pad={d}; a Hopper block has "
            f"{MAX_SMEM_BYTES}")


def ordered_row_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of p [..., d] (f32, d a multiple of 16) in
    one stated order, add for add the order of the kernel's eight lanes
    a row, so that both give the same bits on any device and any build.
    The axis is cut into runs of 128 (the last one padded with zeros,
    which change no sum); lane l of 8 owns the 16 elements at 16 * l of
    every run; its accumulator i of 4 starts at 0 and adds the lane's
    elements 4 * i .. 4 * i + 3 of each run one after the other; the
    lane's sum is (a0 + a1) + (a2 + a3); the lanes add as a butterfly:
    l with l + 4, then l with l + 2, then 0 with 1."""
    p = torch.nn.functional.pad(p, (0, -p.shape[-1] % 128))
    p = p.reshape(*p.shape[:-1], -1, 8, 4, 4)  # [.., run, lane, acc, elem]
    acc = torch.zeros_like(p[..., 0, :, :, 0])
    for run in range(p.shape[-4]):
        for elem in range(4):
            acc = acc + p[..., run, :, :, elem]
    t = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    t = t[..., :4] + t[..., 4:]
    t = t[..., :2] + t[..., 2:]
    return t[..., 0] + t[..., 1]


def plain_select(beam_s: torch.Tensor, beam_e: torch.Tensor, expand: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step 1 of the plain version: E argmin passes over the unexpanded
    finite entries. Returns (pos [B, E], ok [B, E], the flags with the
    live selections marked)."""
    ef_pos = torch.arange(beam_s.shape[1], device=beam_s.device)[None]
    key = torch.where(beam_e | (beam_s >= INF_SCORE), INF_SCORE, beam_s)
    sel_pos, sel_ok = [], []
    for _e in range(expand):
        pos = torch.argmin(key, dim=1)  # first minimum, as jnp.argmin
        hit = ef_pos == pos[:, None]
        ok = torch.gather(key, 1, pos[:, None])[:, 0] < INF_SCORE
        sel_pos.append(pos)
        sel_ok.append(ok)
        beam_e = beam_e | (hit & ok[:, None])
        key = torch.where(hit, INF_SCORE, key)
    return torch.stack(sel_pos, 1), torch.stack(sel_ok, 1), beam_e


def plain_merge(beam_s, beam_i, beam_e, cand_s, cand_i, ef: int):
    """Step 5 of the plain version: the first ef of the stable sort of
    [beam, candidates] by score (dropped candidates carry INF_SCORE).
    Returns the new (scores, ids, expanded flags)."""
    pool_s = torch.cat([beam_s, cand_s], 1)
    pool_i = torch.cat([beam_i, cand_i], 1)
    pool_e = torch.cat([beam_e, torch.zeros_like(cand_s, dtype=torch.bool)],
                       1)
    new_s, order = torch.sort(pool_s, dim=1, stable=True)
    order = order[:, :ef]
    new_s = new_s[:, :ef]
    new_i = torch.where(new_s >= INF_SCORE, -1, torch.gather(pool_i, 1, order))
    return new_s, new_i, torch.gather(pool_e, 1, order)


def plain_step(beam_s, beam_i, beam_e, q_bf, q_sq, nbr_tbl, scale_tbl, sq_tbl,
               nbr_vecs, *, ef: int, expand: int, m0: int, d: int,
               metric: MetricKind):
    """One step of the plain version. Returns the new (scores, ids,
    expanded flags), the candidates kept per query [B] and the live
    selections per query [B]."""
    b = beam_s.shape[0]
    c = expand * m0
    pos, sel_ok, beam_e = plain_select(beam_s, beam_e, expand)
    picked = torch.gather(beam_i, 1, pos)
    sel = torch.where(sel_ok, picked, 0).clamp_min(0).long()  # [B, E]
    nb = nbr_tbl[sel].reshape(b, c)
    vs = scale_tbl[sel].reshape(b, c)
    vq = sq_tbl[sel].reshape(b, c)
    cand = nbr_vecs[sel].reshape(b, c, d).to(torch.bfloat16)
    dot = ordered_row_sum((cand * q_bf[:, None, :]).float()) * vs
    if metric == MetricKind.L2SQ:
        s_new = torch.clamp_min(q_sq[:, None] - 2.0 * dot + vq, 0.0)
    elif metric == MetricKind.IP:
        s_new = 1.0 - dot
    else:
        qz = q_sq[:, None] <= 0.0
        vz = vq <= 0.0
        denom = ieee_sqrt(q_sq[:, None] * vq)
        s_new = 1.0 - dot / torch.clamp_min(denom, _EPS)
        s_new = torch.where(qz | vz, 1.0, s_new)
        s_new = torch.where(qz & vz, 0.0, s_new)
    sel_valid = sel_ok[:, :, None].expand(b, expand, m0).reshape(b, c)
    in_beam = (nb[:, :, None] == beam_i[:, None, :]).any(dim=2)
    dup_new = torch.triu(nb[:, :, None] == nb[:, None, :], 1).any(dim=1)
    keep = (nb >= 0) & sel_valid & ~in_beam & ~dup_new
    beam_s, beam_i, beam_e = plain_merge(
        beam_s, beam_i, beam_e, torch.where(keep, s_new, INF_SCORE),
        torch.where(keep, nb, -1), ef)
    return beam_s, beam_i, beam_e, keep.sum(1), sel_ok.sum(1)


def beam_search_plain(
    queries: torch.Tensor,  # [B, D] f32
    q_sq: torch.Tensor,  # [B]
    seed_scores: torch.Tensor,  # [B, ef] f32 ascending (INF padded)
    seed_ids: torch.Tensor,  # [B, ef] i32 (-1 padded)
    meta_packed: torch.Tensor,  # [cap, W] i32 (pack_meta)
    nbr_vecs: torch.Tensor,  # [cap, M0, D] i8
    *,
    ef: int,
    expand: int,
    m0: int,
    d: int,
    max_steps: int,
    metric: MetricKind,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in plain PyTorch, for the fixed trip count.
    The seed beam must be ascending (graph.seed_beam sorts it): the
    kernel selects and merges by position and relies on it. Returns
    (scores [B, ef], ids [B, ef], n_dist [], n_expanded []): n_dist
    counts the candidates kept, n_expanded the live selections (each
    one reads a tile)."""
    beam_search_plain.calls += 1
    b = queries.shape[0]
    tables = (meta_packed[:, :m0],
              meta_packed[:, m0:2 * m0].contiguous().view(torch.float32),
              meta_packed[:, 2 * m0:3 * m0].contiguous().view(torch.float32),
              nbr_vecs)
    q_bf = queries.to(torch.bfloat16)
    beam_s, beam_i = seed_scores, seed_ids
    beam_e = torch.zeros((b, ef), dtype=torch.bool, device=queries.device)
    n_dist = torch.zeros((), dtype=torch.int64, device=queries.device)
    n_exp = torch.zeros((), dtype=torch.int64, device=queries.device)
    for _ in range(max_steps):
        beam_s, beam_i, beam_e, kept, live = plain_step(
            beam_s, beam_i, beam_e, q_bf, q_sq, *tables, ef=ef,
            expand=expand, m0=m0, d=d, metric=metric)
        n_dist = n_dist + kept.sum()
        n_exp = n_exp + live.sum()
    return beam_s, beam_i, n_dist, n_exp


beam_search_plain.calls = 0


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use in this process (or reused
    when it is newer than its source; with K3's when that is stale too,
    cuda_build.SEARCH_KERNELS) and bound through ctypes."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_beam_launch.argtypes = [p] * 9 + [i] * 9 + [p]
        lib.fused_beam_launch.restype = i
        lib.fused_beam_error_string.argtypes = [i]
        lib.fused_beam_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fused_beam_search(
    queries: torch.Tensor,
    q_sq: torch.Tensor,
    seed_scores: torch.Tensor,
    seed_ids: torch.Tensor,
    meta_packed: torch.Tensor,
    nbr_vecs: torch.Tensor,
    *,
    ef: int,
    expand: int,
    m0: int,
    d: int,
    max_steps: int,
    metric: MetricKind,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused beam search. Returns (scores [B, ef], ids [B, ef], n_dist [],
    n_expanded []). The seed beam must be ascending, INF padded. CPU
    tensors run beam_search_plain; CUDA tensors launch kernel K1 (one
    thread block per query, which stops at the first step that selects
    nothing) or raise."""
    kw = dict(ef=ef, expand=expand, m0=m0, d=d, max_steps=max_steps,
              metric=metric)
    dev = queries.device
    if dev.type == "cpu":
        return beam_search_plain(queries, q_sq, seed_scores, seed_ids,
                                 meta_packed, nbr_vecs, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_beam_search: unsupported device {dev}")
    check_kernel_shapes(ef, expand, m0, d)
    b = queries.shape[0]
    cap, w = meta_packed.shape
    if w < 3 * m0:
        raise ValueError(f"meta rows hold {w} ints, need {3 * m0}")
    check_tensor(queries, "queries", torch.float32, (b, d), dev)
    check_tensor(q_sq, "q_sq", torch.float32, (b,), dev)
    check_tensor(seed_scores, "seed_scores", torch.float32, (b, ef), dev)
    check_tensor(seed_ids, "seed_ids", torch.int32, (b, ef), dev)
    check_tensor(meta_packed, "meta_packed", torch.int32, (cap, w), dev)
    check_tensor(nbr_vecs, "nbr_vecs", torch.int8, (cap, m0, d), dev)
    if nbr_vecs.data_ptr() % 16:
        raise ValueError("nbr_vecs must be 16-byte aligned")
    lib = _library()
    out_s = torch.empty((b, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, ef), dtype=torch.int32, device=dev)
    counts = torch.empty((b, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_beam_launch(
            queries.data_ptr(), q_sq.data_ptr(), seed_scores.data_ptr(),
            seed_ids.data_ptr(), meta_packed.data_ptr(), nbr_vecs.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), counts.data_ptr(),
            b, ef, expand, m0, d, w, max_steps, METRIC_CODE[metric],
            smem_bytes(ef, expand, m0, d), stream)
    if rc != 0:
        raise RuntimeError("fused_beam kernel launch failed: "
                           + lib.fused_beam_error_string(rc).decode())
    fused_beam_search.launches += 1
    totals = counts.sum(dim=0, dtype=torch.int64)
    return out_s, out_i, totals[0], totals[1]


fused_beam_search.launches = 0
