"""One rank of tests/test_torch_multiprocess.py: a ShardedFlatIndex scan
and the ShardedHNSWIndex lifecycle of tests/multiproc_worker.py (bulk
build, search, insert, delete, compact, save/load), run by the port in a
torch.distributed gloo group on the CPU. Every rank runs the same host
code on the same data; each holds its block of the 4 shards. Each rank
writes its results, ids and scores in full, to result_r<rank>.json in
<outdir>, so the test can hold every rank, and every group size, to one
answer.

Usage:
  python torch_multiproc_worker.py <rank> <world_size> <port> <outdir>
"""

import json
import os
import sys

N_SHARDS = 4


def main():
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    outdir = sys.argv[4]

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from duckdb_vss_tpu_torch.parallel.sharded import (ShardedFlatIndex,
                                                       ShardedHNSWIndex,
                                                       make_mesh)
    from duckdb_vss_tpu_torch.utils.config import HNSWConfig, MetricKind

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(N_SHARDS, device="cpu")
        assert len(mesh.shards) == N_SHARDS // world, mesh

        rng = np.random.default_rng(42)  # one stream on every rank
        n, d, k = 8192, 32, 10
        v = rng.normal(size=(n, d)).astype(np.float32)
        keys = np.arange(n, dtype=np.int64)
        res = {}

        def record(name, out):
            res[name + "_scores"] = out[0].astype(float).tolist()
            res[name + "_keys"] = out[1].tolist()
            return out

        idx = ShardedHNSWIndex(d, HNSWConfig(), mesh,
                               capacity_per_shard=2 * n // N_SHARDS,
                               build_batch=256)
        idx.add(v, keys)  # >= 4096 rows into empty graphs: the bulk path

        q = v[:256] + 1e-3 * rng.normal(size=(256, d)).astype(np.float32)
        v2 = (v * v).sum(1)
        gt = np.argsort(v2[None, :] - 2.0 * (q @ v.T), 1)[:, :k]

        def recall(got):
            return float(np.mean([len(set(a) & set(b)) / k
                                  for a, b in zip(got.tolist(),
                                                  gt.tolist())]))

        flat = ShardedFlatIndex(d, MetricKind.L2SQ, mesh)
        flat.add(v, keys)
        res["flat_recall"] = recall(record("flat", flat.search(q, k))[1])
        del flat

        _, got = record("bulk", idx.search(q, k, ef=48))
        res["bulk_recall"] = recall(got)
        res["bulk_self"] = float((got[:, 0] == np.arange(256)).mean())

        extra = rng.normal(size=(128, d)).astype(np.float32)
        idx.add(extra, np.arange(100_000, 100_128))
        _, got_e = record("insert", idx.search(extra[:64], 1, ef=64))
        res["insert_found"] = float((got_e[:, 0] >= 100_000).mean())

        idx.remove(keys[:64])
        _, got_d = record("delete", idx.search(v[:64], 5, ef=64))
        res["deleted_leaked"] = int(
            len(set(got_d.ravel().tolist()) & set(range(64))))

        idx.compact()
        res["stats"] = idx.stats()
        _, got_c = record("compact", idx.search(q, k, ef=48))
        res["post_compact_recall"] = recall(got_c)

        path = os.path.join(outdir, "mp_index.vss")
        idx.save(path)
        idx2 = ShardedHNSWIndex.load(path, mesh)
        s1, g1 = idx.search(q[:64], k, ef=48)
        s2, g2 = record("reload", idx2.search(q[:64], k, ef=48))
        res["roundtrip_equal"] = bool((g1 == g2).all() and (s1 == s2).all())
        res["count"] = len(idx)
        res["counts"] = idx.counts.tolist()
        res["placement_load"] = idx.placement.load.tolist()
    finally:
        dist.destroy_process_group()

    with open(os.path.join(outdir, f"result_r{rank}.json"), "w") as f:
        json.dump(res, f)
    assert res["flat_recall"] >= 0.99, res["flat_recall"]
    assert res["bulk_recall"] >= 0.90, res["bulk_recall"]
    assert res["bulk_self"] >= 0.95, res["bulk_self"]
    assert res["insert_found"] >= 0.9, res["insert_found"]
    assert res["deleted_leaked"] == 0, res["deleted_leaked"]
    assert res["post_compact_recall"] >= 0.90, res["post_compact_recall"]
    assert res["roundtrip_equal"]
    print(f"[r{rank}] TORCH MULTIPROC OK", flush=True)


if __name__ == "__main__":
    main()
