"""The sharded index's collectives (duckdb_vss_tpu_torch/parallel/
sharded.py) on the CPU, where they run on gloo:

- all_gather_on_device and gather_shards, run by 1-rank and 2-rank
  gloo groups (tests/torch_collective_worker.py) on CPU tensors of f32,
  int64, bool and bf16, give the one-process stack bit for bit;
- _merge of per-shard results whose scores tie across shards, run by
  those groups, gives the JAX package's merge (lax.all_gather +
  lax.top_k in jax.shard_map over 4 of conftest's CPU devices, as its
  sharded search does): the same ids in the same tie order, the same
  score bits;
- a group, even of one rank, runs the collective and answers as no
  group does (the merge and a ShardedFlatIndex search);
- under a group whose backend carries CUDA tensors (the backend string
  patched on a gloo group), the mesh sends only CUDA tensors to the
  card's gather (stand-ins here: there is no card) and refuses a rank
  whose slots name two cards.

Each subprocess has its own timeout and one thread.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import lax
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from duckdb_vss_tpu_torch.parallel import sharded as tsh
from torch_collective_worker import (N_SHARDS, bits, full_tensors,
                                     merge_inputs)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_collective_worker.py")
TIMEOUT_S = 120
WORLDS = (1, 2)
K = 10


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{world: [each rank's npz]}: both groups run at once."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in WORLDS}
    procs = []
    for w in WORLDS:
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(w), str(port), str(dirs[w])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
            for r in range(w)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        assert "TORCH COLLECTIVE OK" in out, out[-4000:]
    return {w: [dict(np.load(dirs[w] / f"coll_r{r}.npz")) for r in range(w)]
            for w in WORLDS}


@pytest.mark.parametrize("dtype", ["f32", "int64", "bool", "bf16"])
@pytest.mark.parametrize("world", WORLDS)
def test_gather_equals_the_stack(results, world, dtype):
    """Every rank gets the [S, ...] stack of every rank's slices, by the
    device gather and by gather_shards, in the tensor's own dtype."""
    want = bits(full_tensors()[dtype])
    for res in results[world]:
        assert str(res["collectives"]) == "host"
        for how in ("device", "shards"):
            got = res[f"{how}_{dtype}"]
            assert got.dtype == want.dtype, how
            np.testing.assert_array_equal(got, want, err_msg=how)


def jax_merge(scores: np.ndarray, gids: np.ndarray, k: int):
    """The JAX package's merge (duckdb_vss_tpu/parallel/sharded.py,
    _search_sharded_hnsw's shard_fn): each of 4 CPU devices holds one
    shard's [B, k] results, all-gathers them over the shard axis and
    cuts the shard-major concatenation with lax.top_k."""
    mesh = JMesh(np.array(jax.devices()[:N_SHARDS]), ("shard",))

    def shard_fn(s, g):
        all_s = lax.all_gather(s[0], "shard", axis=0)
        all_g = lax.all_gather(g[0], "shard", axis=0)
        b = s.shape[1]
        cat_s = jnp.moveaxis(all_s, 0, 1).reshape(b, -1)
        cat_g = jnp.moveaxis(all_g, 0, 1).reshape(b, -1)
        neg, pos = lax.top_k(-cat_s, k)
        return -neg, jnp.take_along_axis(cat_g, pos, axis=1)

    spec = P("shard", None, None)
    s, g = jax.shard_map(shard_fn, mesh=mesh, in_specs=(spec, spec),
                         out_specs=(P(), P()), check_vma=False)(
        jnp.asarray(scores), jnp.asarray(gids.astype(np.int32)))
    return np.asarray(s), np.asarray(g).astype(np.int64)


@pytest.mark.parametrize("world", WORLDS)
def test_merge_equals_the_jax_shard_map(results, world):
    scores, gids = merge_inputs(k=K)
    # the data has ties across shards at the cut, and short shards
    cat = np.sort(scores.transpose(1, 0, 2).reshape(len(scores[0]), -1), 1)
    assert (cat[:, K - 1] == cat[:, K]).any()
    assert (gids == -1).any()
    want_s, want_g = jax_merge(scores, gids, K)
    for res in results[world]:
        np.testing.assert_array_equal(res["merge_ids"], want_g)
        np.testing.assert_array_equal(res["merge_scores"].view(np.int32),
                                      want_s.view(np.int32))


@pytest.mark.parametrize("world", WORLDS)
def test_group_runs_the_collective_and_answers_as_before(results, world):
    """A group of any size, one rank too, gathers (two all-gathers into
    one tensor for the merge, two for the flat search's, no list
    all-gather) and answers as no group."""
    for res in results[world]:
        assert (int(res["gathers"]), int(res["list_gathers"])) == (4, 0)
        for a, b in (("merge_scores", "alone_scores"),
                     ("merge_ids", "alone_ids"),
                     ("flat_scores", "flat_alone_scores"),
                     ("flat_keys", "flat_alone_keys")):
            np.testing.assert_array_equal(res[a], res[b], err_msg=a)


@pytest.mark.parametrize("backend,card", [
    ("gloo", False), ("cpu:gloo", False), ("nccl", True),
    ("cpu:gloo,cuda:nccl", True), ("cpu:gloo, cuda:nccl", True)])
def test_backend_carries_cuda(backend, card):
    assert tsh._carries_cuda(backend) is card


@pytest.fixture
def card_group(monkeypatch):
    """A 1-rank gloo group in this process whose backend reads as
    "cpu:gloo,cuda:nccl"; destroyed after the test."""
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    monkeypatch.setattr(dist, "get_backend",
                        lambda group=None: "cpu:gloo,cuda:nccl")
    try:
        yield
    finally:
        dist.destroy_process_group()


class _CudaStandIn:
    """What the routing reads of a CUDA tensor; its results are cut on
    the CPU, as there is no card here."""
    is_cuda = True
    device = torch.device("cpu")


def test_card_group_routes_only_cuda_tensors_to_the_card(card_group,
                                                         monkeypatch):
    """Every gather is one all_gather_into_tensor: of the tensor itself
    on its card when it is a CUDA tensor (the stand-ins), else of its
    host copy."""
    mesh = tsh.make_mesh(N_SHARDS, device="cpu")
    assert mesh.collectives == "card"
    by_device = {"card": 0, "cpu": 0}
    real = tsh.all_gather_on_device
    results = []

    def counted(m, t):
        if t.is_cuda:
            by_device["card"] += 1
            return results.pop(0)
        by_device["cpu"] += 1
        return real(m, t)

    monkeypatch.setattr(tsh, "all_gather_on_device", counted)
    # a CPU tensor is gathered on the host, in its dtype
    t = full_tensors()["bf16"]
    assert torch.equal(tsh.gather_shards(mesh, t).view(torch.int16),
                       t.view(torch.int16))
    assert by_device == {"card": 0, "cpu": 1}
    # a CUDA tensor is gathered on the card, then downloaded once
    results.append(torch.arange(4.0))
    assert torch.equal(tsh.gather_shards(mesh, _CudaStandIn()),
                       torch.arange(4.0))
    assert by_device == {"card": 1, "cpu": 1}
    # the merge gathers CUDA results on the card and cuts them there
    scores, gids = merge_inputs(k=K)
    results += [torch.from_numpy(scores), torch.from_numpy(gids)]
    s, i = tsh._merge(mesh, _CudaStandIn(), _CudaStandIn(), K)
    assert by_device == {"card": 3, "cpu": 1}
    # CPU results go through the host's gather, twice
    s2, i2 = tsh._merge(mesh, torch.from_numpy(scores),
                        torch.from_numpy(gids), K)
    assert by_device == {"card": 3, "cpu": 3}
    want_s, want_i = tsh._merge(tsh.Mesh(N_SHARDS, 1, torch.device("cpu")),
                                torch.from_numpy(scores),
                                torch.from_numpy(gids), K)
    for got in ((s, i), (s2, i2)):
        assert torch.equal(got[0], want_s) and torch.equal(got[1], want_i)


@pytest.mark.parametrize("devices,raises", [
    (["cuda:0", "cuda:1"], True),  # one rank over two cards
    (["cuda:1", "cuda:1"], False),  # two slots of the rank's own card
    (["cuda:0", "cpu"], False),
])
def test_card_group_keeps_a_rank_on_one_card(card_group, monkeypatch,
                                             devices, raises):
    monkeypatch.setattr(tsh, "_slot_device", torch.device)  # no card here
    if raises:
        with pytest.raises(ValueError, match="one card"):
            tsh.make_mesh(2, devices=devices)
    else:
        assert tsh.make_mesh(2, devices=devices).collectives == "card"


def test_host_group_allows_a_rank_over_two_cards(monkeypatch):
    """A group of the CPU alone gathers on the host, whatever cards a
    rank's slots name."""
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        monkeypatch.setattr(tsh, "_slot_device", torch.device)
        mesh = tsh.make_mesh(2, devices=["cuda:0", "cuda:1"])
        assert mesh.collectives == "host"
    finally:
        dist.destroy_process_group()
