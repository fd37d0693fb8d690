"""Fused row gather + distance scoring: kernel K2 on the H100, and its
plain PyTorch version (port of duckdb_vss_tpu/ops/pallas_gather.py).

``gather_scores_kernel`` computes ``metric(q[b], vectors[ids[b, c]])``
for candidate ids [B, C] against an f32 table [N, D] (D a multiple of
128, the store's d_pad), with INF_SCORE where ``ids[b, c] < 0``. The dot
and the row's squared norm both come from the fetched row, in f32 (the
cached norms are not read), then the metric epilogue:
  l2sq    max(q_sq + v_sq - 2 dot, 0)
  ip      1 - dot
  cosine  1 - dot / max(sqrt(q_sq v_sq), eps); 1 if exactly one norm
          is zero, 0 if both are.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/gather_scores.cu, built with nvcc for sm_90a at first use into
build/kernels/ and bound through ctypes) or raises. On a CPU tensor it
runs ``gather_scores_plain``, the same function in plain PyTorch. The
non-fused beam search (models/graph.beam_search, ``use_pallas=True``)
is its caller.
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

KERNEL = "gather_scores"
SOURCE = cuda_build.source_path(KERNEL)
_lib: ctypes.CDLL | None = None


def gather_scores_plain(
    vectors: torch.Tensor,  # [N, D] f32
    ids: torch.Tensor,  # [B, C] i32, -1 allowed
    queries: torch.Tensor,  # [B, D] f32
    q_sq: torch.Tensor,  # [B] f32
    metric: MetricKind,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather, f32 products and
    sums, the norm from the gathered row, the epilogue, the INF mask."""
    gather_scores_plain.calls += 1
    rows = vectors[ids.clamp_min(0).long()].float()  # [B, C, D]
    dot = (rows * queries.float()[:, None, :]).sum(-1)
    qs = q_sq[:, None]
    if metric == MetricKind.IP:
        s = 1.0 - dot
    elif metric == MetricKind.L2SQ:
        v_sq = (rows * rows).sum(-1)
        s = torch.clamp_min(qs + v_sq - 2.0 * dot, 0.0)
    elif metric == MetricKind.COSINE:
        v_sq = (rows * rows).sum(-1)
        s = 1.0 - dot / torch.clamp_min(ieee_sqrt(qs * v_sq), _EPS)
        s = torch.where((qs <= 0.0) | (v_sq <= 0.0), 1.0, s)
        s = torch.where((qs <= 0.0) & (v_sq <= 0.0), 0.0, s)
    else:
        raise ValueError(f"unknown metric {metric}")
    return torch.where(ids >= 0, s, INF_SCORE)


gather_scores_plain.calls = 0


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use in this process (or reused
    when it is newer than its source) and bound through ctypes."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gather_scores_launch.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.gather_scores_launch.restype = i
        lib.gather_scores_error_string.argtypes = [i]
        lib.gather_scores_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def gather_scores_kernel(
    vectors: torch.Tensor,
    ids: torch.Tensor,
    queries: torch.Tensor,
    q_sq: torch.Tensor,
    metric: MetricKind,
) -> torch.Tensor:
    """Fused gather + score: [B, C] f32 index-metric scores, INF_SCORE
    for id < 0. CPU tensors run gather_scores_plain; CUDA tensors launch
    kernel K2 (one thread block per query row) or raise."""
    dev = vectors.device
    if dev.type == "cpu":
        return gather_scores_plain(vectors, ids, queries, q_sq, metric)
    if dev.type != "cuda":
        raise ValueError(f"gather_scores_kernel: unsupported device {dev}")
    if vectors.dim() != 2 or ids.dim() != 2:
        raise ValueError("vectors must be [N, D] and ids [B, C], got "
                         f"{tuple(vectors.shape)} and {tuple(ids.shape)}")
    n, d = vectors.shape
    b, c = ids.shape
    if d % 128 or 4 * d > MAX_SMEM_BYTES:  # the query row is staged there
        raise ValueError(f"row width {d} must be a multiple of 128 of at "
                         f"most {MAX_SMEM_BYTES // 4} floats")
    check_tensor(vectors, "vectors", torch.float32, (n, d), dev)
    check_tensor(ids, "ids", torch.int32, (b, c), dev)
    check_tensor(queries, "queries", torch.float32, (b, d), dev)
    check_tensor(q_sq, "q_sq", torch.float32, (b,), dev)
    if vectors.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("vectors and queries must be 16-byte aligned")
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b == 0 or c == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gather_scores_launch(
            vectors.data_ptr(), ids.data_ptr(), queries.data_ptr(),
            q_sq.data_ptr(), out.data_ptr(), b, c, d, METRIC_CODE[metric],
            stream)
    if rc != 0:
        raise RuntimeError("gather_scores kernel launch failed: "
                           + lib.gather_scores_error_string(rc).decode())
    gather_scores_kernel.launches += 1
    return out


gather_scores_kernel.launches = 0
