"""Insert: a closed loop of one caller, each call one chunk of new rows.

Parameters (traffic/<mix>.json): ``rows_per_call`` (one ``add`` into
the index built in set-up), ``capacity`` (reserved in set-up, so the
window's rows grow nothing; the rows it can take are drawn from the
seed in set-up), ``check_queries`` (searched after the window), ``k``
and ``trace_calls``. After the window the index answers the check
queries and searches every appended row for itself; both are judged
against every row it then holds.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import datagen
from portbench.programs import SingleIndex
from portbench.reference.judge import Answers


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, tr = run.cell.config, run.cell.traffic
        self.k = int(tr["k"])
        self.per_call = int(tr["rows_per_call"])
        self.capacity = int(tr["capacity"])
        self.n_check = int(tr["check_queries"])
        self.added = 0

    def setup(self) -> None:
        cfg, run, dev = self.cfg, self.run, self.run.device
        n = cfg["n_rows"]
        cents = datagen.centres(cfg, run.seed, dev)
        self.rows = datagen.clustered(cfg, run.seed, "rows", n, dev,
                                      cents).cpu().numpy()
        self.prog = SingleIndex(run, self.capacity)
        room = self.prog.index.store.capacity - n
        self.new = datagen.clustered(cfg, run.seed, "insert", room, dev,
                                     cents).cpu().numpy()
        self.checks = datagen.clustered(cfg, run.seed, "queries",
                                        self.n_check, dev,
                                        cents).cpu().numpy()
        del cents
        self.prog.build(self.rows, np.arange(n, dtype=np.int64))
        self._add()  # warm: the first insert builds the int8 layout

    def _add(self) -> int | None:
        a, b = self.added, self.added + self.per_call
        if b > len(self.new):
            return None
        n = self.cfg["n_rows"]
        self.prog.index.add(self.new[a:b], np.arange(n + a, n + b))
        self.added = b
        return self.per_call

    def call(self, i: int) -> int | None:
        return self._add()

    def finish(self, mine: dict) -> list:
        """The peak; then the index answers the check queries and each
        appended row's own search; then it is freed."""
        out = self.prog.finish(mine)
        idx, k = self.prog.index, self.k
        s, keys = idx.search(self.checks, k)
        self.check_calls = [(np.arange(self.n_check), keys, s)]
        s, keys = idx.search(self.new[:self.added], k)
        self.self_calls = [(np.arange(self.added), keys, s)]
        self.prog = None
        return out

    def groups(self) -> tuple[dict, torch.Tensor]:
        dev, n = self.run.device, self.cfg["n_rows"]
        rows = torch.from_numpy(np.concatenate(
            [self.rows, self.new[:self.added]])).to(dev)
        return {"queries": Answers(torch.from_numpy(self.checks).to(dev),
                                   self.check_calls),
                "self": Answers(rows[n:], self.self_calls,
                                self_keys=np.arange(n, n + self.added))}, rows
