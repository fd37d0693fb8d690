"""Point statements: a closed loop of one connection, one statement at a
time, as DuckDB's in-process users issue them.

Parameters (traffic/<mix>.json): ``query_pool`` (fresh literal queries
drawn from the seed; the window takes them in turn), ``k`` (the
statement's LIMIT), ``warm_statements`` and ``trace_calls``. Set-up
loads the rows into an in-memory ``Database`` (no WAL) and runs
``CREATE INDEX ... USING HNSW`` with the configuration's options; each
call is one ``Database.execute`` of
``SELECT id, array_distance(vec, q) AS d FROM items ORDER BY
array_distance(vec, q) LIMIT k``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import datagen
from portbench.programs import peak_bytes
from portbench.reference.judge import Answers


def vec_literal(v) -> str:
    """A FLOAT[d] SQL literal that parses back to ``v``'s float32 values
    exactly (each element as the shortest repr of its double). Frozen
    copy of chip_smoke.py's ``vec_literal``."""
    return ("[" + ", ".join(repr(float(x)) for x in v)
            + f"]::FLOAT[{len(v)}]")


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, tr = run.cell.config, run.cell.traffic
        self.k = int(tr["k"])
        self.n_pool = int(tr["query_pool"])
        self.n_warm = int(tr["warm_statements"])
        self.answers = []

    def statement(self, q) -> str:
        lit = vec_literal(q)
        return (f"SELECT id, array_distance(vec, {lit}) AS d FROM items "
                f"ORDER BY array_distance(vec, {lit}) LIMIT {self.k}")

    def setup(self) -> None:
        from duckdb_vss_tpu_torch.sql.engine import Database

        cfg, run, dev = self.cfg, self.run, self.run.device
        n, d = cfg["n_rows"], cfg["dims"]
        cents = datagen.centres(cfg, run.seed, dev)
        self.rows = datagen.clustered(cfg, run.seed, "rows", n, dev,
                                      cents).cpu().numpy()
        self.pool = datagen.clustered(cfg, run.seed, "queries", self.n_pool,
                                      dev, cents).cpu().numpy()
        del cents
        self.stmts = [self.statement(q) for q in self.pool]
        self.db = db = Database(path=None, device=dev)
        db.execute(f"CREATE TABLE items (id BIGINT, vec FLOAT[{d}])")
        db.table("items").insert({"id": np.arange(n, dtype=np.int64),
                                  "vec": self.rows})
        db.execute(
            "CREATE INDEX items_idx ON items USING HNSW (vec) WITH ("
            f"metric = '{cfg['metric']}', M = {cfg['m']}, M0 = {cfg['m0']}, "
            f"ef_construction = {cfg['ef_construction']}, "
            f"ef_search = {cfg['ef_search']})")
        run.extra["build_stats"] = [db.indexes["items_idx"].index.build_stats]
        plan = db.execute("EXPLAIN " + self.stmts[0])
        if "HNSW_INDEX_SCAN" not in plan:
            raise RuntimeError(f"the statement takes no index scan:\n{plan}")
        for i in range(self.n_warm):
            db.execute(self.stmts[i % self.n_pool])

    def call(self, i: int) -> int:
        j = i % self.n_pool
        res = self.db.execute(self.stmts[j])
        self.answers.append((j, res["id"], res["d"]))
        return 1

    def finish(self, mine: dict) -> list:
        out = [dict(mine, peak=peak_bytes(self.run.device))]
        self.db = None
        return out

    def groups(self) -> tuple[dict, torch.Tensor]:
        dev, k = self.run.device, self.k
        whole = [a for a in self.answers if len(a[1]) == k == len(a[2])]
        calls = [(np.array([j]), np.asarray(ids)[None], np.asarray(d)[None])
                 for j, ids, d in self.answers
                 if not (len(ids) == k == len(d))]
        if whole:
            calls.append((np.array([a[0] for a in whole]),
                          np.stack([np.asarray(a[1]) for a in whole]),
                          np.stack([np.asarray(a[2]) for a in whole])))
        return ({"queries": Answers(torch.from_numpy(self.pool).to(dev),
                                    calls, kind="l2")},
                torch.from_numpy(self.rows).to(dev))
