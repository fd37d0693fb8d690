"""Shape/padding utilities (copy of duckdb_vss_tpu/utils/padding.py).

The port keeps the JAX package's padded layouts at its public functions
(d_pad = pad_dim(D), capacity buckets, the -1 / INF_SCORE sentinels) so
that both packages can be held against each other on the same arrays.
On the GPU the 128-wide feature padding also keeps every int8 tile row
a multiple of 16 bytes, which the fused beam kernel's vector loads need.
"""

from __future__ import annotations

import numpy as np

LANE = 128
SUBLANE_F32 = 8

# Sentinel id used for padded / absent slots in neighbor lists and results.
# The reference uses `free_key_` tombstone keys and u32 slots
# (duckdb_vss/src/include/usearch/index.hpp:1587); we use int32 with -1.
INVALID_ID = np.int32(-1)

# Large-but-finite "infinity" for padded distances. Using finite values keeps
# top-k/sort semantics well-defined in f32 without NaN hazards.
INF_SCORE = np.float32(3.0e38)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def pad_dim(n: int, multiple: int = LANE) -> int:
    """Padded size for a dimension (at least one full tile)."""
    return max(round_up(max(n, 1), multiple), multiple)


def pad_rows_np(arr: np.ndarray, n_pad: int, fill: float = 0.0) -> np.ndarray:
    """Pad axis 0 of a numpy array to ``n_pad`` with ``fill``."""
    n = arr.shape[0]
    if n == n_pad:
        return arr
    out = np.full((n_pad,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:n] = arr
    return out


def pad_2d_np(arr: np.ndarray, n_pad: int, d_pad: int, fill: float = 0.0) -> np.ndarray:
    """Pad a [N, D] numpy array to [n_pad, d_pad] with ``fill``.

    Zero-fill on the feature axis is semantics-preserving for all three
    metrics (l2sq / cosine / inner-product) because padded coordinates
    contribute 0 to dot products and squared norms.
    """
    n, d = arr.shape
    if n == n_pad and d == d_pad:
        return arr
    out = np.full((n_pad, d_pad), fill, dtype=arr.dtype)
    out[:n, :d] = arr
    return out


def round_up_capacity(n: int, minimum: int = 1024) -> int:
    """Capacity bucket for the vector store: a power of two, or
    1.5x a power of two for large stores (>= 49152).

    Pure powers of two waste up to 2x HBM at scale (10M rows would
    allocate 16.8M); the extra 1.5x buckets cap padding waste at ~33%
    while keeping the program-shape count bounded (every distinct
    capacity costs a multi-minute remote compile on the TPU backend).
    All buckets >= 49152 are multiples of 16384, the flat scan's block
    size."""
    n = max(int(n), minimum)
    p2 = 1 << (n - 1).bit_length()
    p15 = 3 * (p2 // 4)  # 1.5x the next-lower power of two
    if p15 >= n and p15 >= 49152:
        return p15
    return p2
