"""The port's sharded index across processes: tests/torch_multiproc_worker.py
runs the whole ShardedHNSWIndex lifecycle (bulk build, search, insert,
delete, compact, save/load) in a torch.distributed gloo group on the
CPU, each rank holding its block of the 4 shards. Both ranks of a
2-process group must return the same keys and scores, bit for bit, and
so must a 1-process group over the same data: the merge gathers every
shard's [B, k] results and cuts them in one order, whoever holds the
shards. Each subprocess has its own timeout, so a hang fails the test.
"""

import json
import os
import socket
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_multiproc_worker.py")
TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_group(world: int, outdir) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, WORKER, str(rank), str(world), str(port),
         str(outdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env) for rank in range(world)]


def _finish(procs) -> list:
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
        assert "TORCH MULTIPROC OK" in out, out[-4000:]
    return outs


def test_two_ranks_equal_one_process(tmp_path):
    two, one = tmp_path / "two", tmp_path / "one"
    two.mkdir()
    one.mkdir()
    groups = [_start_group(2, two), _start_group(1, one)]
    for procs in groups:
        _finish(procs)
    results = [json.load(open(two / f"result_r{r}.json")) for r in range(2)]
    single = json.load(open(one / "result_r0.json"))
    assert results[0] == results[1]
    assert results[0] == single
    assert single["count"] == 8192 + 128 - 64
    assert sum(single["counts"]) == single["count"]
    # the two files hold the same index
    with open(two / "mp_index.vss", "rb") as a, \
            open(one / "mp_index.vss", "rb") as b:
        assert a.read() == b.read()
