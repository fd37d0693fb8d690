"""One rank of tests/test_torch_collective.py, in a torch.distributed
gloo group on the CPU. Every rank makes the same data from one seed and
holds its block of the 4 shards. It writes to coll_r<rank>.npz in
<outdir>:

- ``device_<dtype>`` / ``shards_<dtype>``: a [4, ...] tensor of f32,
  int64, bool and bf16 (as its bits) gathered from every rank's slices
  by all_gather_on_device and by gather_shards;
- ``merge_scores`` / ``merge_ids``: _merge of the seeded per-shard
  [S, B, k] results (merge_inputs), and ``alone_*`` the same merge
  before the group exists;
- ``flat_*`` / ``flat_alone_*``: a ShardedFlatIndex search in the group
  and before it;
- ``gathers`` / ``list_gathers``: how many all_gather_into_tensor and
  list all_gather calls the merge and the flat search made;
- ``collectives``: the mesh's routing.

Usage:
  python torch_collective_worker.py <rank> <world_size> <port> <outdir>
"""

import os
import sys

import numpy as np
import torch

N_SHARDS = 4
SEED = 11
CAP = 4096


def full_tensors() -> dict:
    """The [4, ...] tensors every rank slices, one per dtype."""
    rng = np.random.default_rng(SEED)
    return {
        "f32": torch.from_numpy(rng.normal(size=(4, 6, 5)).astype(np.float32)),
        "int64": torch.from_numpy(rng.integers(-2**40, 2**40, (4, 7))),
        "bool": torch.from_numpy(rng.random((4, 9)) < 0.5),
        "bf16": torch.from_numpy(rng.normal(size=(4, 6, 8)).astype(
            np.float32)).to(torch.bfloat16),
    }


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy, bf16 as its 16-bit patterns."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def merge_inputs(b: int = 16, k: int = 10):
    """Per-shard search results [S, B, k], ascending in each row, drawn
    from few values so equal scores meet across shards at the cut; some
    rows end in INF_SCORE with id -1, as a shard with fewer than k
    results does. Global ids are shard * CAP + slot."""
    rng = np.random.default_rng(SEED + 1)
    scores = np.sort(rng.integers(0, 6, (N_SHARDS, b, k)).astype(np.float32)
                     * np.float32(0.5), axis=2)
    slots = np.stack([np.stack([rng.choice(CAP, k, replace=False)
                                for _ in range(b)]) for _ in range(N_SHARDS)])
    gids = np.arange(N_SHARDS)[:, None, None] * CAP + slots
    short = rng.random((N_SHARDS, b)) < 0.25
    scores[:, :, -3:][short] = np.float32(3.0e38)
    gids[:, :, -3:][short] = -1
    return scores, gids.astype(np.int64)


def flat_data(n: int = 512, d: int = 8, nq: int = 20):
    rng = np.random.default_rng(SEED + 2)
    # a coarse grid of values: equal distances across shards
    v = rng.integers(-2, 3, (n, d)).astype(np.float32)
    q = rng.integers(-2, 3, (nq, d)).astype(np.float32)
    return v, q


def main():
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    outdir = sys.argv[4]
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch.distributed as dist

    from duckdb_vss_tpu_torch.parallel import sharded as tsh
    from duckdb_vss_tpu_torch.utils.config import MetricKind

    k = 10
    scores, gids = merge_inputs(k=k)
    v, q = flat_data()
    out = {}

    def flat_search(mesh):
        flat = tsh.ShardedFlatIndex(v.shape[1], MetricKind.L2SQ, mesh)
        flat.add(v, np.arange(len(v)))
        return flat.search(q, k)

    alone = tsh.make_mesh(N_SHARDS, device="cpu")
    s, i = tsh._merge(alone, torch.from_numpy(scores),
                      torch.from_numpy(gids), k)
    out["alone_scores"], out["alone_ids"] = s.numpy(), i.numpy()
    out["flat_alone_scores"], out["flat_alone_keys"] = flat_search(alone)

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    gathers = [0, 0]
    real = dist.all_gather_into_tensor, dist.all_gather

    def counted(i, fn):
        def run(*args, **kw):
            gathers[i] += 1
            return fn(*args, **kw)
        return run

    try:
        mesh = tsh.make_mesh(N_SHARDS, device="cpu")
        out["collectives"] = np.array(str(mesh.collectives))
        sl = slice(mesh.shards.start, mesh.shards.stop)
        for name, full in full_tensors().items():
            local = full[sl]
            out[f"device_{name}"] = bits(tsh.all_gather_on_device(mesh,
                                                                   local))
            out[f"shards_{name}"] = bits(tsh.gather_shards(mesh, local))
        dist.all_gather_into_tensor, dist.all_gather = (
            counted(0, real[0]), counted(1, real[1]))
        s, i = tsh._merge(mesh, torch.from_numpy(scores[sl]),
                          torch.from_numpy(gids[sl]), k)
        out["merge_scores"], out["merge_ids"] = s.numpy(), i.numpy()
        out["flat_scores"], out["flat_keys"] = flat_search(mesh)
        out["gathers"], out["list_gathers"] = map(np.array, gathers)
    finally:
        dist.all_gather_into_tensor, dist.all_gather = real
        dist.destroy_process_group()
    np.savez(os.path.join(outdir, f"coll_r{rank}.npz"), **out)
    print(f"[r{rank}] TORCH COLLECTIVE OK", flush=True)


if __name__ == "__main__":
    main()
