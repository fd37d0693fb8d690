"""Where kernel K1's time goes, on the card.

``phase_shares`` compiles csrc/fused_beam.cu once more with
tools/k1_phase_clocks.cuh included, so that the K1_PHASE hooks in the
source (empty in the normal build) sum clock64() per phase in thread 0
of every block, launches it once on the inputs given and returns each
phase's share of the clocks the blocks were resident. chip_smoke.py
calls it at the search chunk's shape.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from duckdb_vss_tpu_torch.ops import cuda_build
from duckdb_vss_tpu_torch.ops import fused_beam as fb

HEADER = Path(__file__).with_name("k1_phase_clocks.cuh")
PHASES = ["select + start copies", "wait for meta rows", "dedup + compact",
          "wait for tiles", "score + prune", "merge"]
REST = "prologue, last selection, output"


def phase_shares(args, kw) -> tuple[float, dict[str, float]]:
    """Clocks a block is resident, on average, and the share of each of
    PHASES (and REST) in them, for one launch of K1 on ``args`` (the
    tensors of fused_beam_search, on the card) with the keywords ``kw``."""
    q, q_sq, seed_s, seed_i, meta, nv = args
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cuda_build.BUILD_DIR / "libfused_beam_phase_clocks.so"
    cmd = cuda_build.nvcc_command(fb.SOURCE, out)
    cmd[1:1] = ["-include", str(HEADER)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}"
                           f"{res.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_beam_launch.argtypes = [p] * 9 + [i] * 9 + [p]
    lib.fused_beam_launch.restype = i
    lib.k1_phase_clocks_read.argtypes = [p]
    lib.k1_phase_clocks_read.restype = i

    b, ef = seed_s.shape
    out_s = torch.empty((b, ef), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, ef), dtype=torch.int32, device=q.device)
    counts = torch.empty((b, 2), dtype=torch.int32, device=q.device)
    rc = lib.fused_beam_launch(
        q.data_ptr(), q_sq.data_ptr(), seed_s.data_ptr(), seed_i.data_ptr(),
        meta.data_ptr(), nv.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        counts.data_ptr(), b, ef, kw["expand"], kw["m0"], kw["d"],
        meta.shape[1], kw["max_steps"], cuda_build.METRIC_CODE[kw["metric"]],
        fb.smem_bytes(ef, kw["expand"], kw["m0"], kw["d"]),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 8)()
    rc = rc or lib.k1_phase_clocks_read(buf)
    if rc != 0:
        raise RuntimeError(f"K1 with phase clocks: cudaError {rc}")
    blocks, total = max(int(buf[6]), 1), max(int(buf[7]), 1)
    shares = {name: int(c) / total for name, c in zip(PHASES, buf)}
    shares[REST] = 1.0 - sum(shares.values())
    return total / blocks, shares
