"""The sharded flat cases of tests/test_torch_sharded.py, and one fresh
process that runs them through the port alone.

``FLAT_CASES`` names the four cases (three metrics on one table, and a
table that outgrows its first capacity); ``case_data`` makes a case's
rows and queries from its seed and ``run_case`` adds them to a
ShardedFlatIndex of either package and searches, so the in-process
tests and this worker run the same cases.

As a script it is one fresh process on the CPU with two torch threads,
no JAX: the cosine case first, so that its scan makes the process's
first square root, then the other three. Each case's scores and keys
go to <out>.npz as ``<case>_scores`` / ``<case>_keys``.

Usage:
  python torch_flat_worker.py <out.npz>
"""

import os
import sys

import numpy as np

# case -> (metric, seed, rows of each add, dims, queries, k)
FLAT_CASES = {
    "cosine": ("cosine", 5, (1000,), 16, 5, 5),
    "l2sq": ("l2sq", 5, (1000,), 16, 5, 5),
    "ip": ("ip", 5, (1000,), 16, 5, 5),
    "grow": ("l2sq", 7, (3000, 3000), 16, 9, 5),  # exceeds 1024 a shard
}


def case_data(case: str):
    """(rows [n, d] f32, queries [nq, d] f32) of a case, from its seed."""
    _, seed, adds, d, nq, _ = FLAT_CASES[case]
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(sum(adds), d)).astype(np.float32)
    return v, rng.normal(size=(nq, d)).astype(np.float32)


def run_case(flat_cls, metric_cls, mesh, case: str):
    """Add a case's rows to ``flat_cls(d, metric_cls(metric), mesh)`` in
    its adds and search its queries. Returns (scores, keys) [nq, k]."""
    metric, _, adds, d, _, k = FLAT_CASES[case]
    v, q = case_data(case)
    index = flat_cls(d, metric_cls(metric), mesh, capacity_per_shard=1024)
    off = 0
    for n in adds:
        index.add(v[off:off + n], np.arange(off, off + n))
        off += n
    return index.search(q, k)


def main(out: str) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(2)
    from duckdb_vss_tpu_torch.parallel import sharded as tsh
    from duckdb_vss_tpu_torch.utils.config import MetricKind

    mesh = tsh.make_mesh(4, 2, device="cpu")
    results = {}
    for case in FLAT_CASES:
        scores, keys = run_case(tsh.ShardedFlatIndex, MetricKind, mesh, case)
        results[f"{case}_scores"], results[f"{case}_keys"] = scores, keys
    np.savez(out, **results)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
