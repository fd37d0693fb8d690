"""The system under test, as a configuration deploys it.

``SingleIndex`` is one ``HNSWIndex`` on one device. ``ShardedIndex`` is
one ``ShardedHNSWIndex`` over ``shards`` processes, one shard and one
card a rank, in one "cpu:gloo,cuda:nccl" group (gloo alone on the CPU,
for the tests). The benchmark's process is rank 0: it starts the other
ranks (``python -m portbench.rank``), which meet it on a free local
port, make the same data from the seed and make the same calls. Before
each call rank 0 broadcasts whether the window goes on and which query
set comes next, so no rank waits in a collective for a call that never
comes.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch

COLLECTIVE_TIMEOUT_S = 240


def hnsw_config(cfg: dict):
    from duckdb_vss_tpu_torch import HNSWConfig, MetricKind

    return HNSWConfig(metric=MetricKind(cfg["metric"]),
                      ef_construction=cfg["ef_construction"],
                      ef_search=cfg["ef_search"], m=cfg["m"], m0=cfg["m0"])


def peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _gather_json(obj, world: int) -> list:
    """Every rank's ``obj`` (plain JSON), gathered on the host."""
    import torch.distributed as dist

    b = torch.frombuffer(bytearray(json.dumps(obj).encode()),
                         dtype=torch.uint8)
    n = torch.tensor([b.numel()], dtype=torch.int64)
    ns = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(ns, n)
    buf = torch.zeros(max(int(x) for x in ns), dtype=torch.uint8)
    buf[:b.numel()] = b
    bufs = [torch.zeros_like(buf) for _ in range(world)]
    dist.all_gather(bufs, buf)
    return [json.loads(bytes(x[:int(k)].numpy()))
            for x, k in zip(bufs, ns)]


class SingleIndex:
    def __init__(self, run, capacity: int):
        from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex

        cfg = run.cell.config
        self.run = run
        self.index = HNSWIndex(cfg["dims"], hnsw_config(cfg),
                               capacity=capacity, device=run.device)

    def build(self, rows, keys) -> None:
        self.index.add(rows, keys)
        self.run.extra["build_stats"] = [self.index.build_stats]

    def search(self, queries, k):
        return self.index.search(queries, k)

    def announce(self, item: int) -> None:
        pass

    def finish(self, mine: dict) -> list:
        """Each rank's report (trace.report) with its peak bytes under
        "peak"; frees nothing."""
        return [dict(mine, peak=peak_bytes(self.run.device))]

    def abort(self) -> None:
        pass


class ShardedIndex:
    def __init__(self, run, capacity: int):
        import torch.distributed as dist

        from duckdb_vss_tpu_torch.parallel.sharded import (ShardedHNSWIndex,
                                                           make_mesh)

        cfg = run.cell.config
        self.run, self.world = run, int(cfg["shards"])
        self.procs, self.logs, self.log_dir = [], [], None
        if run.rank == 0:
            self._start_ranks()
        on_card = run.device.type == "cuda"
        kw = dict(device_id=run.device) if on_card else {}
        dist.init_process_group(
            "cpu:gloo,cuda:nccl" if on_card else "gloo",
            init_method=f"tcp://127.0.0.1:{run.port}",
            world_size=self.world, rank=run.rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S), **kw)
        mesh = make_mesh(self.world, device=run.device)
        self.index = ShardedHNSWIndex(cfg["dims"], hnsw_config(cfg), mesh,
                                      capacity_per_shard=capacity)

    def _start_ranks(self) -> None:
        run = self.run
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            run.port = s.getsockname()[1]
        env = dict(os.environ, NCCL_SHM_DISABLE="1")
        self.log_dir = log_dir = tempfile.mkdtemp(prefix="portbench-ranks-")
        cell_file = os.path.join(log_dir, "cell.json")
        with open(cell_file, "w") as f:
            json.dump(dataclasses.asdict(run.cell), f)
        for r in range(1, self.world):
            path = os.path.join(log_dir, f"rank{r}.log")
            f = open(path, "w")
            self.logs.append((path, f))
            dev = (f"cuda:{r}" if run.device.type == "cuda" else "cpu")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.rank", "--cell-file",
                 cell_file, "--seed", str(run.seed), "--trace",
                 str(int(run.trace)), "--rank", str(r), "--port",
                 str(run.port), "--device", dev],
                stdout=f, stderr=subprocess.STDOUT, env=env,
                cwd=str(run.root)))

    def build(self, rows, keys) -> None:
        self.index.add(rows, keys)
        self.run.extra["build_stats"] = self.index.build_stats

    def search(self, queries, k):
        return self.index.search(queries, k)

    def announce(self, item: int) -> None:
        """Rank 0: the window goes on with ``item``."""
        import torch.distributed as dist

        dist.broadcast(torch.tensor([1, item], dtype=torch.int64), 0)

    def receive(self):
        """The other ranks: the next item, or None when the window has
        closed."""
        import torch.distributed as dist

        t = torch.zeros(2, dtype=torch.int64)
        dist.broadcast(t, 0)
        return int(t[1]) if int(t[0]) else None

    def finish(self, mine: dict) -> list:
        """Close the window on every rank, gather each rank's report
        (trace.report) with its peak bytes under "peak", and leave the
        group; rank 0 then waits for the other ranks' processes, and
        raises where one of them exited with another code than 0."""
        import torch.distributed as dist

        if self.run.rank == 0:
            dist.broadcast(torch.zeros(2, dtype=torch.int64), 0)
        every = _gather_json(dict(mine, peak=peak_bytes(self.run.device)),
                             self.world)
        dist.destroy_process_group()
        self.index = None
        self.stop_ranks()
        return every

    def abort(self) -> None:
        """Stop the other ranks at once (rank 0, after a failure)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for _, f in self.logs:
            f.close()
        self.procs = []
        self._remove_logs()

    def _remove_logs(self) -> None:
        if self.log_dir is not None:
            shutil.rmtree(self.log_dir, ignore_errors=True)
            self.log_dir = None

    def stop_ranks(self, timeout_s: float = 120.0) -> None:
        """Wait for the other ranks (rank 0), then stop any left."""
        t0 = time.perf_counter()
        for p in self.procs:
            try:
                p.wait(timeout=max(1.0, timeout_s
                                   - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                pass
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        bad = [(i + 1, p.returncode) for i, p in enumerate(self.procs)
               if p.returncode != 0]
        for path, f in self.logs:
            f.close()
        self.procs = []
        tails = []
        for r, rc in bad:
            with open(self.logs[r - 1][0]) as f:
                tails.append(f"rank {r} exited {rc}:\n{f.read()[-3000:]}")
        self._remove_logs()
        if tails:
            raise RuntimeError("\n".join(tails))
