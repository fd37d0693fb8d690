"""The bulk build's seconds per phase and its peak device memory.

Runs on the card. Builds chip_smoke.py's path-1 data (bench.py's
SIFT-shaped clustered generator, 1M x 128 from seed 1234) into an
HNSWIndex twice in one process and prints, per build, the seconds of
each build phase (``build_stats["phase_s"]``), ``n_distances`` and
``torch.cuda.max_memory_allocated`` above what was resident before the
build, then the card's name and power limit. Run from the repository
root:

    python -m duckdb_vss_tpu_torch.tools.build_peak
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.utils.config import HNSWConfig


def make_data(rng, n, d, n_centers=4096, sigma=0.25, chunk=200_000):
    """bench.py's SIFT-shaped clustered generator: (rows [n, d], the
    centres they are drawn around). chip_smoke.py's data comes from it."""
    centers = rng.normal(size=(n_centers, d)).astype(np.float32)
    out = np.empty((n, d), np.float32)
    for off in range(0, n, chunk):
        m = min(chunk, n - off)
        asg = rng.integers(0, n_centers, m)
        out[off:off + m] = centers[asg] + sigma * rng.normal(
            size=(m, d)).astype(np.float32)
    return out, centers


def main() -> int:
    n, d = 1_000_000, 128
    dev = torch.device("cuda")
    vecs, _ = make_data(np.random.default_rng(1234), n, d)
    keys = np.arange(n, dtype=np.int64)
    for r in range(2):
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        idx = HNSWIndex(d, HNSWConfig(), capacity=n, device=dev)
        t0 = time.perf_counter()
        idx.add(vecs, keys)
        torch.cuda.synchronize()
        print(json.dumps({
            "build": r, "n": n, "d": d,
            "seconds": time.perf_counter() - t0,
            "phase_s": idx.build_stats["phase_s"],
            "n_distances": int(idx.build_stats["n_distances"]),
            "peak_gib": (torch.cuda.max_memory_allocated() - resident)
            / 2**30,
            "index_gib": (torch.cuda.memory_allocated() - resident) / 2**30,
        }), flush=True)
        del idx
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
