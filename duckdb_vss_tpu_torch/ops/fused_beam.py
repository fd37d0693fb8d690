"""The fused base-layer beam search: kernel K1 on the H100, and its plain
PyTorch version (port of duckdb_vss_tpu/ops/pallas_beam.py).

``fused_beam_search`` runs the whole base-layer beam search for a batch
of queries, for a fixed number of steps. Each step, per query:
  1. pick the E best unexpanded beam entries (E argmin passes, ties to
     the lowest position);
  2. fetch each one's packed meta row (pack_meta: M0 neighbor ids, M0
     dequant scales, M0 squared norms) and its int8 [M0, D] neighbor
     tile (graph.make_neighborhood_tables);
  3. score int8 x bf16(q) products (rounded to bf16) summed in f32,
     times the scale, then the metric epilogue;
  4. drop id < 0, dead selections, ids already in the beam and repeats
     within the block (first copy kept);
  5. merge with the ascending beam and keep the top ef (stable: beam
     entries before candidates, candidates in block order).

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
    tiles, then 4-byte words for the query, the pool (beam +
    candidates: scores, ids, expanded flags), the merge output, the
    selection keys, the raw candidate ids, the E meta rows and a few
    counters."""
    c = expand * m0
    p = ef + c
    words = d + 3 * p + 4 * ef + c + 3 * c + 2 * expand + 4
    return expand * m0 * d + 4 * words


def check_kernel_shapes(ef: int, expand: int, m0: int, d: int) -> None:
    """Raise for shapes the kernel does not take. It never clamps."""
    if ef < 1 or expand < 1 or m0 < 1 or expand > ef:
        raise ValueError(f"bad beam shape ef={ef} expand={expand} m0={m0}")
    if d % 16:
        raise ValueError(f"d={d} must be a multiple of 16 (int4 tile loads)")
    need = smem_bytes(ef, expand, m0, d)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused beam needs {need} bytes of shared memory for ef={ef}, "
            f"expand={expand}, M0={m0}, d_pad={d}; a Hopper block has "
            f"{MAX_SMEM_BYTES}")


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
    """The kernel's algorithm in plain PyTorch. Returns (scores [B, ef],
    ids [B, ef], n_dist [], n_expanded []): n_dist counts the candidates
    kept, n_expanded the live selections (each one reads a tile)."""
    beam_search_plain.calls += 1
    b = queries.shape[0]
    c = expand * m0
    nbr_tbl = meta_packed[:, :m0]
    scale_tbl = meta_packed[:, m0:2 * m0].contiguous().view(torch.float32)
    sq_tbl = meta_packed[:, 2 * m0:3 * m0].contiguous().view(torch.float32)
    q_bf = queries.to(torch.bfloat16)
    beam_s, beam_i = seed_scores, seed_ids
    beam_e = torch.zeros((b, ef), dtype=torch.bool, device=queries.device)
    ef_pos = torch.arange(ef, device=queries.device)[None]
    n_dist = torch.zeros((), dtype=torch.int64, device=queries.device)
    n_exp = torch.zeros((), dtype=torch.int64, device=queries.device)
    for _ in range(max_steps):
        key = torch.where(beam_e | (beam_s >= INF_SCORE), INF_SCORE, beam_s)
        sel_ids, sel_ok = [], []
        for _e in range(expand):
            pos = torch.argmin(key, dim=1)  # first minimum, as jnp.argmin
            hit = ef_pos == pos[:, None]
            ok = torch.gather(key, 1, pos[:, None])[:, 0] < INF_SCORE
            picked = torch.gather(beam_i, 1, pos[:, None])[:, 0]
            sel_ids.append(torch.where(ok, picked, 0))
            sel_ok.append(ok)
            beam_e = beam_e | (hit & ok[:, None])
            key = torch.where(hit, INF_SCORE, key)
        sel = torch.stack(sel_ids, 1).clamp_min(0).long()  # [B, E]
        sel_ok = torch.stack(sel_ok, 1)
        n_exp = n_exp + sel_ok.sum()
        nb = nbr_tbl[sel].reshape(b, c)
        vs = scale_tbl[sel].reshape(b, c)
        vq = sq_tbl[sel].reshape(b, c)
        cand = nbr_vecs[sel].reshape(b, c, d).to(torch.bfloat16)
        dot = (cand * q_bf[:, None, :]).float().sum(-1) * vs
        if metric == MetricKind.L2SQ:
            s_new = torch.clamp_min(q_sq[:, None] - 2.0 * dot + vq, 0.0)
        elif metric == MetricKind.IP:
            s_new = 1.0 - dot
        else:
            qz = q_sq[:, None] <= 0.0
            vz = vq <= 0.0
            denom = torch.sqrt(q_sq[:, None] * vq)
            s_new = 1.0 - dot / torch.clamp_min(denom, _EPS)
            s_new = torch.where(qz | vz, 1.0, s_new)
            s_new = torch.where(qz & vz, 0.0, s_new)
        sel_valid = sel_ok[:, :, None].expand(b, expand, m0).reshape(b, c)
        in_beam = (nb[:, :, None] == beam_i[:, None, :]).any(dim=2)
        dup_new = torch.triu(nb[:, :, None] == nb[:, None, :], 1).any(dim=1)
        keep = (nb >= 0) & sel_valid & ~in_beam & ~dup_new
        n_dist = n_dist + keep.sum()
        pool_s = torch.cat([beam_s, torch.where(keep, s_new, INF_SCORE)], 1)
        pool_i = torch.cat([beam_i, torch.where(keep, nb, -1)], 1)
        pool_e = torch.cat([beam_e, torch.zeros_like(keep)], 1)
        new_s, order = torch.sort(pool_s, dim=1, stable=True)
        order = order[:, :ef]
        beam_s = new_s[:, :ef]
        beam_i = torch.where(beam_s >= INF_SCORE, -1,
                             torch.gather(pool_i, 1, order))
        beam_e = torch.gather(pool_e, 1, order)
    return beam_s, beam_i, n_dist, n_exp


beam_search_plain.calls = 0


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use in this process (or reused
    when it is newer than its source) and bound through ctypes."""
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
    n_expanded []). CPU tensors run beam_search_plain; CUDA tensors
    launch kernel K1 (one thread block per query) or raise."""
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
