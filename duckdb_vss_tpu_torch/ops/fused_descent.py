"""The upper-level descent's scan: kernel K3 on the H100, and its plain
PyTorch version.

``fused_descent`` scores every row of the upper table against every
query and returns each query's ``k`` smallest index-metric scores over
the live rows (node >= 0), ascending, with their slots; equal scores go
to the lowest slot (the contract of topk.smallest_k). Queries are
rounded to bf16 against the bf16 table, products and sums are f32, the
query norms are the f32 queries' (as flat_topk scores a bf16 table).
Places past a query's live rows carry INF_SCORE.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/fused_descent.cu, built with nvcc for sm_90a at first use into
build/kernels/ and bound through ctypes) or raises; the [B, U] score
matrix never reaches device memory. On a CPU tensor it runs
``fused_descent_plain``: flat_topk over blocks of the table, the
descent's body before the kernel.

The kernel's plan comes from the call's shapes alone (``block_warps``,
``n_slices``): a block of 16 warps (fewer for wide rows, down to one
at D > 2,816) owns 16 queries a warp, and the table is cut into as
many slices as fill the card's resident blocks once, at most 128.

Limits, checked by the wrapper: D a multiple of 128 up to MAX_D (6,016,
the widest row whose 16 queries fit one block's shared memory), k up
to 32. A wider row or more seeds raises on the card; the plain version
on the CPU takes any.
"""

from __future__ import annotations

import ctypes
import math

import torch

from duckdb_vss_tpu_torch.ops import cuda_build
from duckdb_vss_tpu_torch.ops.cuda_build import (MAX_SMEM_BYTES, METRIC_CODE,
                                                check_tensor)
from duckdb_vss_tpu_torch.ops.topk import flat_topk
from duckdb_vss_tpu_torch.utils.config import MetricKind
from duckdb_vss_tpu_torch.utils.tracing import count

KERNEL = "fused_descent"
SOURCE = cuda_build.source_path(KERNEL)
TILE_ROWS = 64  # table rows a tile
PANEL = 128  # depth of one staged panel; D must be a multiple of it
MAX_K = 32
MAX_SLICES = 128
WARP_CHOICES = (16, 8, 4, 2, 1)
_lib: ctypes.CDLL | None = None
_slots: dict = {}  # (device index, warps, k <= 8, smem) -> resident blocks


def smem_bytes(warps: int, d: int) -> int:
    """Dynamic shared memory of one scan block, the layout that
    fused_descent.cu carves out: the block's queries in bf16 (16 rows a
    warp, all of D), two staged table panels of 64 x 128 bf16 with two
    tiles' norms and nodes, and for each query its norm, its bound, and
    the scores of a tile that met the bound (f32) with their columns
    (one byte each)."""
    rows = 16 * warps
    return (rows * d * 2 + 2 * TILE_ROWS * PANEL * 2 + 2 * TILE_ROWS * 8
            + rows * 12 + rows * TILE_ROWS * 5)


# the widest row the one-warp block takes: its 16 queries in bf16 fill
# what shared memory the rest of its layout leaves
MAX_D = ((MAX_SMEM_BYTES - smem_bytes(1, 0)) // (16 * 2) // PANEL) * PANEL


def check_shapes(d: int, k: int) -> None:
    """Raise for shapes the kernel does not take. It never clamps."""
    if d % PANEL or not PANEL <= d <= MAX_D:
        raise ValueError(f"fused descent: d={d} must be a multiple of "
                         f"{PANEL} up to {MAX_D}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused descent: n_seeds={k} must lie in 1..{MAX_K}")


def block_warps(d: int, k: int) -> int:
    """Warps of a scan block: the most of WARP_CHOICES whose queries'
    panels fit in a block's shared memory (16 at d = 128, 8 up to 512,
    4 up to 1,280, 2 up to 2,816, 1 up to MAX_D)."""
    check_shapes(d, k)
    return next(w for w in WARP_CHOICES
                if smem_bytes(w, d) <= MAX_SMEM_BYTES)


def n_slices(b: int, u: int, warps: int, slots: int) -> int:
    """Table slices of the scan's grid: as many as, with the query
    tiles, fill the ``slots`` blocks the card holds at once (one wave),
    at least 1, at most MAX_SLICES and one tile each."""
    q_tiles = max(1, -(-b // (16 * warps)))
    tiles = -(-u // TILE_ROWS)
    return max(1, min(tiles, MAX_SLICES, slots // q_tiles))


def fused_descent_plain(queries: torch.Tensor, table: torch.Tensor,
                        table_sq: torch.Tensor, nodes: torch.Tensor, k: int,
                        metric: MetricKind
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: flat_topk over blocks of
    the table (the largest power of two up to 16,384 that divides its
    row count: the upper table of a 1.5 x 2^k capacity bucket is no
    multiple of 16,384). Returns (scores [B, k], slots [B, k] int32);
    a slot past the live rows may be any row's."""
    fused_descent_plain.calls += 1
    return flat_topk(queries, table, k, metric, vec_sq=table_sq,
                     valid=nodes >= 0,
                     block_n=math.gcd(16384, table.shape[0]))


fused_descent_plain.calls = 0


def _library() -> ctypes.CDLL:
    """The kernel library, built at first use in this process (with K1's
    when that is stale too, cuda_build.SEARCH_KERNELS) and bound through
    ctypes."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_descent_launch.argtypes = [p] * 8 + [i] * 8 + [p]
        lib.fused_descent_launch.restype = i
        lib.fused_descent_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.fused_descent_occupancy.restype = i
        lib.fused_descent_error_string.argtypes = [i]
        lib.fused_descent_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused descent {what} failed: "
                           + lib.fused_descent_error_string(rc).decode())


def resident_blocks(dev: torch.device, warps: int, k: int, smem: int) -> int:
    """Scan blocks the card holds at once: its SMs times the blocks of
    this shape one SM holds (CUDA's occupancy calculator), once per
    device and shape."""
    key = (dev.index, warps, k <= 8, smem)
    if key not in _slots:
        lib = _library()
        blocks = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _raise_on(lib, lib.fused_descent_occupancy(
                warps, k, smem, ctypes.byref(blocks)), "occupancy query")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _slots[key] = sms * max(1, blocks.value)
    return _slots[key]


def fused_descent(queries: torch.Tensor, table: torch.Tensor,
                  table_sq: torch.Tensor, nodes: torch.Tensor, k: int,
                  metric: MetricKind) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query's k best live rows of the upper table: (scores [B, k]
    f32 ascending, INF_SCORE padded; slots [B, k] int32). CPU tensors
    run fused_descent_plain; CUDA tensors launch kernel K3 (the scan,
    and the merge of its slices when there are several) or raise. A
    launch adds B to the trace counter ``descent.kernel_queries``."""
    dev = queries.device
    if dev.type == "cpu":
        return fused_descent_plain(queries, table, table_sq, nodes, k, metric)
    if dev.type != "cuda":
        raise ValueError(f"fused_descent: unsupported device {dev}")
    b, d = queries.shape
    u = table.shape[0]
    warps = block_warps(d, k)
    queries = queries.contiguous()
    check_tensor(queries, "queries", torch.float32, (b, d), dev)
    check_tensor(table, "table", torch.bfloat16, (u, d), dev)
    check_tensor(table_sq, "table_sq", torch.float32, (u,), dev)
    check_tensor(nodes, "nodes", torch.int32, (u,), dev)
    if u < 1:
        raise ValueError("fused descent: the upper table has no rows")
    if queries.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError("queries and table must be 16-byte aligned")
    lib = _library()
    smem = smem_bytes(warps, d)
    slices = n_slices(b, u, warps, resident_blocks(dev, warps, k, smem))
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    part_s = part_i = None
    if slices > 1:
        part_s = torch.empty((slices, b, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((slices, b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_descent_launch(
            queries.data_ptr(), table.data_ptr(), table_sq.data_ptr(),
            nodes.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            0 if part_s is None else part_s.data_ptr(),
            0 if part_i is None else part_i.data_ptr(),
            b, u, d, k, METRIC_CODE[metric], warps, slices, smem, stream)
    _raise_on(lib, rc, "launch")
    fused_descent.launches += 1
    count("descent.kernel_queries", b)
    return out_s, out_i


fused_descent.launches = 0
