"""Entry points of the port (counterpart of the JAX package's entry
module, __graft_entry__.py).

- entry(device): one search step over a populated graph, returned as a
  plain function on tensors and its example arguments: the mxu descent
  over the upper-level table, the step-by-step base beam over the bf16
  traversal copy, and the exact f32 rerank.
- dryrun_multichip(n, device, devices): the whole sharded lifecycle on a
  mesh of n // q shards x q replicas (q = 2 for an even n >= 4, else
  1): add, search, remove, compact, grow and add again, search
  (sharded_lifecycle, which returns the index it leaves), and the
  sharded flat index as an exact cross-check. With ``devices`` (n
  device names) the mesh is the JAX entry's grid, one slot per device;
  without it every shard sits on ``device``. Under an initialized
  torch.distributed group the ranks split the shards (make_mesh).

Run both on the card: ``python -m duckdb_vss_tpu_torch.entry`` (the dry
run with one slot per card, then the step). Without a CUDA device that
raises; the tests pass ``device="cpu"`` or ``devices=["cpu"] * n``.
"""

from __future__ import annotations

import numpy as np
import torch

from duckdb_vss_tpu_torch.models.graph import Tables, search_graph
from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.parallel.sharded import (ShardedFlatIndex,
                                                   ShardedHNSWIndex,
                                                   make_mesh)
from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind
from duckdb_vss_tpu_torch.utils.device import resolve_device


def search_step(state, vectors, vec_sq, valid, q, trav, uv, uvsq, unode):
    """The operating point of a search: the mxu descent over the
    upper-level table, bf16 traversal gathers, exact f32 rerank.
    Returns (scores [B, 10], slot ids [B, 10], n_dist)."""
    return search_graph(state, vectors, vec_sq, valid, q, k=10, ef=64,
                        metric=MetricKind.L2SQ,
                        tables=Tables(upper=(uv, uvsq, unode), trav=trav))


def entry(device: str | torch.device = "cuda"):
    """Return (fn, example_args): ``fn(*example_args)`` searches 8
    queries over a 512 x 64 HNSW index built on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, d = 512, 64
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    idx = HNSWIndex(d, HNSWConfig(), capacity=n, build_batch=128,
                    device=dev)
    idx.add(vecs, np.arange(n))
    queries = idx.store.prepare_queries(
        rng.normal(size=(8, d)).astype(np.float32))
    uv, uvsq, unode = idx.tables.upper()
    example_args = (idx.graph, idx.store._vectors, idx.store._vec_sq,
                    idx.store._valid, queries, idx.tables.traversal(),
                    uv, uvsq, unode)
    return search_step, example_args


def sharded_lifecycle(n_devices: int,
                      device: str | torch.device = "cuda",
                      devices: list | None = None):
    """The sharded HNSW half of dryrun_multichip, with its asserts: add,
    search, remove, compact, grow and add again, search. Returns (the
    index after its last step, the rows, their keys, the rows added
    after the growth)."""
    n_q = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_shards=n_devices // n_q, n_q=n_q, device=device,
                     devices=devices)

    rng = np.random.default_rng(0)
    d = 32
    n = 64 * mesh.shape["shard"]
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    keys = np.arange(n, dtype=np.int64)

    # full sharded HNSW lifecycle: insert + delete + compact + grow +
    # merged search (the full mutation surface, per shard)
    sh = ShardedHNSWIndex(d, HNSWConfig(), mesh, capacity_per_shard=1024,
                          build_batch=32)
    sh.add(vecs, keys)
    scores, got = sh.search(vecs[:4], 3, ef=32)
    assert got.shape == (4, 3)
    assert (got[:, 0] == keys[:4]).mean() >= 0.5, got[:, 0]
    # delete a slice; deleted keys must vanish from results
    dead = keys[n // 2: n // 2 + 8]
    assert sh.remove(dead) == len(dead)
    _, got2 = sh.search(vecs[n // 2: n // 2 + 4], 3, ef=32)
    assert not (np.isin(got2, dead)).any(), got2
    # compact repacks live rows; results still exclude the dead
    sh.compact()
    _, got3 = sh.search(vecs[:4], 3, ef=32)
    assert (got3[:, 0] == keys[:4]).mean() >= 0.5, got3[:, 0]
    assert not (np.isin(got3, dead)).any()
    # grow + incremental insert after compaction
    sh.reserve(2048)
    extra = rng.normal(size=(8, d)).astype(np.float32)
    sh.add(extra, np.arange(10_000, 10_008))
    _, got4 = sh.search(extra[:2], 1, ef=32)
    assert (got4[:, 0] >= 10_000).all(), got4
    return sh, vecs, keys, extra


def dryrun_multichip(n_devices: int,
                     device: str | torch.device = "cuda",
                     devices: list | None = None) -> None:
    """One sharded insert, delete, compact, grow and search cycle on a
    mesh of ``n_devices`` (vector shards x query groups), on ``devices``
    (one slot each) or all on ``device``; raises on any wrong answer."""
    sh, vecs, keys, _ = sharded_lifecycle(n_devices, device, devices)
    # sharded flat path (exact) as a cross-check
    sf = ShardedFlatIndex(sh.dims, MetricKind.L2SQ, sh.mesh,
                          capacity_per_shard=1024)
    sf.add(vecs, keys)
    _, fk = sf.search(vecs[:4], 1)
    assert (fk[:, 0] == keys[:4]).all(), fk[:, 0]
    print(f"dryrun_multichip ok: mesh={dict(sh.mesh.shape)} n={len(vecs)}")


if __name__ == "__main__":
    # one slot per card, as the JAX entry runs one per device
    resolve_device("cuda")  # raises without a card
    n_cards = torch.cuda.device_count()
    dryrun_multichip(n_cards, devices=[f"cuda:{i}" for i in range(n_cards)])
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])
