"""Exact L2 search in plain PyTorch: the reference every answer is held to.

Squared L2 distances as ||q||^2 - 2 q.x + ||x||^2 in float32 with TF32
off (the configurations state float32 storage and exact float32
scores), the k smallest per query over every row held, in blocks of
queries and rows so that it fits beside nothing else on the card. The
distance of one returned row is taken again in float64 as sum((q - x)^2).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for float32 products on the card, restored after.
    The CPU has no TF32: there ``round_tf32`` stands in for it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties to
    even): what the tensor cores do to a product's inputs."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def topk_l2sq(rows: torch.Tensor, queries: torch.Tensor, k: int,
              tf32: bool = False, block_q: int = 2048,
              block_n: int = 1 << 20) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, k] ascending float32, row indices [B, k] int64): the
    exact k nearest rows of each query. ``tf32`` computes the products
    in TF32 instead: the control, not the reference."""
    n = rows.shape[0]
    rows = rows.float()
    queries = queries.float()
    if tf32 and rows.device.type == "cpu":
        rows, queries = round_tf32(rows), round_tf32(queries)
    r_sq = (rows * rows).sum(1)
    out_s, out_i = [], []
    with matmul_precision(tf32):
        for q0 in range(0, queries.shape[0], block_q):
            q = queries[q0:q0 + block_q]
            q_sq = (q * q).sum(1)
            best_s = best_i = None
            for n0 in range(0, n, block_n):
                x = rows[n0:n0 + block_n]
                s = (q_sq[:, None] - 2.0 * (q @ x.T)
                     + r_sq[None, n0:n0 + block_n]).clamp_min_(0.0)
                s, i = torch.topk(s, min(k, s.shape[1]), dim=1,
                                  largest=False, sorted=True)
                i = i + n0
                if best_s is not None:
                    s, pos = torch.topk(torch.cat([best_s, s], 1), k, dim=1,
                                        largest=False, sorted=True)
                    i = torch.gather(torch.cat([best_i, i], 1), 1, pos)
                best_s, best_i = s, i
            out_s.append(best_s)
            out_i.append(best_i)
    return torch.cat(out_s), torch.cat(out_i)


def l2sq_f64(rows: torch.Tensor, queries: torch.Tensor,
             idx: torch.Tensor) -> torch.Tensor:
    """float64 sum((q - x)^2) of each query [B, d] against its rows
    ``idx`` [B, k] (valid indices only)."""
    x = rows[idx].double()
    return ((x - queries.double()[:, None, :]) ** 2).sum(-1)
