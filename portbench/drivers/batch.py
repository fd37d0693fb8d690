"""Batch search: a closed loop of one caller, each call one query set.

Parameters (traffic/<mix>.json): ``queries_per_call`` (one call's
batch), ``query_sets`` (fresh sets drawn from the seed; the window
cycles through them), ``k``, ``trace_calls`` (the calls of a traced
run). Each call is the index's ``search`` with host arrays in and out,
on one index or on the configuration's shards (programs.py).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import datagen
from portbench.programs import ShardedIndex, SingleIndex
from portbench.reference.judge import Answers


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, tr = run.cell.config, run.cell.traffic
        self.k = int(tr["k"])
        self.per_call = int(tr["queries_per_call"])
        self.n_sets = int(tr["query_sets"])
        self.calls = []

    def setup(self) -> None:
        cfg, run, dev = self.cfg, self.run, self.run.device
        n, d = cfg["n_rows"], cfg["dims"]
        cents = datagen.centres(cfg, run.seed, dev)
        self.rows = datagen.clustered(cfg, run.seed, "rows", n, dev,
                                      cents).cpu().numpy()
        self.queries = datagen.clustered(
            cfg, run.seed, "queries", self.n_sets * self.per_call, dev,
            cents).cpu().numpy().reshape(self.n_sets, self.per_call, d)
        del cents
        sharded = int(cfg.get("shards", 1)) > 1
        self.prog = (ShardedIndex if sharded else SingleIndex)(
            run, cfg["capacity_per_shard" if sharded else "capacity"])
        self.prog.build(self.rows, np.arange(n, dtype=np.int64))
        self.prog.search(self.queries[0], self.k)  # every shape, warm

    def call(self, i: int) -> int:
        s = i % self.n_sets
        self.prog.announce(s)
        scores, keys = self.prog.search(self.queries[s], self.k)
        self.calls.append((s, keys, scores))
        return self.per_call

    def follow(self) -> None:
        """A rank other than 0: the calls rank 0 announces."""
        while (s := self.prog.receive()) is not None:
            self.prog.search(self.queries[s], self.k)

    def finish(self, mine: dict) -> list:
        out = self.prog.finish(mine)
        self.prog = None
        return out

    def groups(self) -> tuple[dict, torch.Tensor]:
        dev = self.run.device
        q = torch.from_numpy(self.queries.reshape(-1, self.cfg["dims"]))
        base = np.arange(self.per_call, dtype=np.int64)
        calls = [(s * self.per_call + base, keys, scores)
                 for s, keys, scores in self.calls]
        return ({"queries": Answers(q.to(dev), calls)},
                torch.from_numpy(self.rows).to(dev))
