"""The two ends of the base-layer search around kernel K1, on the H100:
kernel K4, the seed beam, and kernel K5, the finish.

``seed_kernel`` computes what models/graph.seed_beam computes: the P
descent seeds of each query scored, a repeated seed kept with
INF_SCORE, a seed < 0 as (INF_SCORE, -1), sorted ascending (equal
scores by position) into K1's starting beam [B, ef], INF_SCORE / -1
past them. It adds the seeds >= 0 (repeats included) to the search's
distance count ``n_dist`` in place, as search_graph counted them.

``finish_kernel`` computes what models/graph._finish_search computes,
from the same arguments (the one-hop expansion, graph._one_hop, runs
after either): each beam entry rescored exactly against
the store where its id is >= 0, its slot is live and its beam score is
below INF_SCORE (else INF_SCORE), then the first k of (score ascending,
id descending, position ascending), with -1 where the score is
INF_SCORE. A beam too wide for a block's shared memory (ef > 29,056)
is ranked in a buffer on the card (``finish_spills``).

Scores are those of graph.gather_scores and graph.metric_epilogue: an
f32 store in f32 (no TF32), a bf16 store with the query rounded to
bf16 and f32 sums, the cached squared norms, the correctly rounded
square root; the dot's additions run in another order than the plain
version's, so scores agree within f32 rounding.

Both launch the hand-written kernels of csrc/search_ends.cu (built with
nvcc for sm_90a at first use into build/kernels/, with K1's and K3's,
cuda_build.SEARCH_KERNELS, and bound through ctypes) on CUDA tensors,
and raise on any other device: search_graph runs the plain versions
(graph.seed_beam, graph._finish_search) on the CPU. A launch adds the
queries it took to the trace counter ``seed.kernel_queries`` or
``finish.kernel_queries``.
"""

from __future__ import annotations

import ctypes

import torch

from duckdb_vss_tpu_torch.ops import cuda_build
from duckdb_vss_tpu_torch.ops.cuda_build import (MAX_SMEM_BYTES, METRIC_CODE,
                                                check_tensor)
from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.tracing import count

KERNEL = "search_ends"
SOURCE = cuda_build.source_path(KERNEL)
SEED_WARPS = 8  # K4: queries a block, one warp each
STORE_DTYPES = (torch.float32, torch.bfloat16)
_lib: ctypes.CDLL | None = None


def seed_smem_bytes(p: int) -> int:
    """K4's dynamic shared memory: each warp's P scores and ids."""
    return SEED_WARPS * p * 8


def finish_spills(ef: int) -> bool:
    """Whether K5 ranks a beam of ef in a buffer on the card: its ef
    exact scores and ids (8 bytes each) pass a block's shared memory
    (ef > 29,056)."""
    return ef * 8 > MAX_SMEM_BYTES


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use in this process (with K1's
    and K3's when those are stale too) and bound through ctypes."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.search_seed_launch.argtypes = ([p, i] + [p] * 7 + [i] * 5
                                           + [p])
        lib.search_seed_launch.restype = i
        lib.search_finish_launch.argtypes = ([p, i] + [p] * 9 + [i] * 5
                                             + [p])
        lib.search_finish_launch.restype = i
        lib.search_ends_error_string.argtypes = [i]
        lib.search_ends_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_store(vectors, vec_sq, queries, q_sq):
    """The store, its norms and the queries as both kernels read them.
    Returns (device, B, D)."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"search_ends: kernels run on CUDA tensors, not "
                         f"{dev}; the plain versions are graph.seed_beam "
                         "and graph._finish_search")
    cap, d = vectors.shape
    b = queries.shape[0]
    if vectors.dtype not in STORE_DTYPES:
        raise ValueError(f"search_ends: store dtype {vectors.dtype}")
    if d % 8:
        raise ValueError(f"search_ends: row width {d} must be a multiple "
                         "of 8 (16-byte row vectors)")
    check_tensor(vectors, "vectors", vectors.dtype, (cap, d), dev)
    check_tensor(vec_sq, "vec_sq", torch.float32, (cap,), dev)
    check_tensor(queries, "queries", torch.float32, (b, d), dev)
    check_tensor(q_sq, "q_sq", torch.float32, (b,), dev)
    if vectors.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("vectors and queries must be 16-byte aligned")
    return dev, b, d


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.search_ends_error_string(rc).decode())


def seed_kernel(vectors: torch.Tensor, vec_sq: torch.Tensor,
                seeds: torch.Tensor, queries: torch.Tensor,
                q_sq: torch.Tensor, metric: MetricKind, ef: int,
                n_dist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K4: K1's starting beam (seed_s [B, ef] f32 ascending,
    INF_SCORE padded; seed_i [B, ef] int32) from the seeds [B, P] int32.
    Adds the seeds >= 0 to ``n_dist`` (a 0-d int64 tensor on the card)
    in place."""
    dev, b, d = _check_store(vectors, vec_sq, queries, q_sq)
    p = seeds.shape[1]
    check_tensor(seeds, "seeds", torch.int32, (b, p), dev)
    check_tensor(n_dist, "n_dist", torch.int64, (), dev)
    if p < 1 or ef < 1 or seed_smem_bytes(p) > MAX_SMEM_BYTES:
        raise ValueError(f"seed kernel: P={p}, ef={ef}: P must lie in 1.."
                         f"{MAX_SMEM_BYTES // seed_smem_bytes(1)}, ef >= 1")
    out_s = torch.empty((b, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, ef), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.search_seed_launch(
            vectors.data_ptr(), vectors.dtype == torch.bfloat16,
            vec_sq.data_ptr(), seeds.data_ptr(), queries.data_ptr(),
            q_sq.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            n_dist.data_ptr(), b, p, d, ef, METRIC_CODE[metric],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "seed")
    seed_kernel.launches += 1
    count("seed.kernel_queries", b)
    return out_s, out_i


seed_kernel.launches = 0


def finish_kernel(vectors: torch.Tensor, vec_sq: torch.Tensor,
                  valid_mask: torch.Tensor, queries: torch.Tensor,
                  q_sq: torch.Tensor, metric: MetricKind, k: int,
                  scores: torch.Tensor, ids: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K5: the exact top k of the beam (scores [B, ef] f32, ids
    [B, ef] int32): (out_s [B, k] f32 ascending, out_i [B, k] int32, -1
    where out_s is INF_SCORE)."""
    dev, b, d = _check_store(vectors, vec_sq, queries, q_sq)
    ef = scores.shape[1]
    check_tensor(valid_mask, "valid_mask", torch.bool, (vectors.shape[0],),
                 dev)
    check_tensor(scores, "scores", torch.float32, (b, ef), dev)
    check_tensor(ids, "ids", torch.int32, (b, ef), dev)
    if not 1 <= k <= ef:
        raise ValueError(f"finish kernel: k={k} must lie in 1..ef={ef}")
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    spill = (torch.empty((b, 2 * ef), dtype=torch.float32, device=dev)
             if finish_spills(ef) else None)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.search_finish_launch(
            vectors.data_ptr(), vectors.dtype == torch.bfloat16,
            vec_sq.data_ptr(), valid_mask.data_ptr(), queries.data_ptr(),
            q_sq.data_ptr(), scores.data_ptr(), ids.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(),
            None if spill is None else spill.data_ptr(), b, d, ef, k,
            METRIC_CODE[metric], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "finish")
    finish_kernel.launches += 1
    count("finish.kernel_queries", b)
    return out_s, out_i


finish_kernel.launches = 0
