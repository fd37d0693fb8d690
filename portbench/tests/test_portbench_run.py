"""Whole runs of small cells on the CPU: the result line, the guards,
and each fault a cell can have coming out as not correct. The look for
a card is skipped (``execute`` on the CPU); everything else is the run
as the benchmark makes it."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.spec import ROOT
from portbench.tests.conftest import run_small, small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["sift1m.batch", "sift1m.point-sql",
                                  "sift1m.insert", "bigann-4m.batch"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(name, trace):
    cell = small(name)
    out = run_small(cell, trace=trace)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(out["metrics"]) <= want
    if trace:
        assert set(out) == set(KEYS + ["breakdown", "checks"])
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert want - {"recall_at_10"} <= set(out["metrics"])
        assert "breakdown" not in out
    for c in out["checks"].values():
        assert set(c) in ({"value", "max"}, {"value", "min"})
    json.dumps(out)


def test_no_card_no_result():
    """Without a card the run exits with another code than 0 and prints
    no result."""
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "sift1m.batch", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import torch, sys\n"
            "from portbench.tests.conftest import run_small, small\n"
            "from portbench.run import forbidden_loaded\n"
            "out = run_small(small('sift1m.point-sql'))\n"
            "assert out['correct']\n"
            "print(forbidden_loaded())\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'duckdb_vss_tpu_torch', 'jax', 'duckdb_vss_tpu'}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert lines[-2] == "[]" and lines[-1] == "['duckdb_vss_tpu_torch']"


def test_forbidden_names_compare_whole():
    from portbench.run import forbidden_loaded

    sys.modules["duckdb_vss_tpu_torch_x"] = sys.modules["json"]
    try:
        assert "duckdb_vss_tpu" not in forbidden_loaded()
        sys.modules["duckdb_vss_tpu.fake"] = sys.modules["json"]
        assert "duckdb_vss_tpu" in forbidden_loaded()
    finally:
        sys.modules.pop("duckdb_vss_tpu_torch_x")
        sys.modules.pop("duckdb_vss_tpu.fake", None)


def test_jax_in_another_rank_gives_no_result(tmp_path, monkeypatch):
    """A rank other than 0 that holds a module called jax exits with
    another code than 0, and rank 0 raises instead of returning a
    result. The ranks inherit the environment, rank 0 (this process)
    does not run the planted module."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys, types\nsys.modules.setdefault('jax', "
        "types.ModuleType('jax'))\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with pytest.raises(RuntimeError, match="jax loaded by the end of set-up"):
        run_small(small("bigann-4m.batch"), seconds=0.2)
    assert "jax" not in sys.modules


# -- faults in the timed path -------------------------------------------

def _half_left_out(monkeypatch):
    from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex

    real = HNSWIndex.search

    def search(self, queries, k, **kw):
        s, keys = real(self, queries, k, **kw)
        return s[:len(s) // 2], keys[:len(keys) // 2]
    monkeypatch.setattr(HNSWIndex, "search", search)


def _answer_altered(monkeypatch):
    from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex

    real = HNSWIndex.search

    def search(self, queries, k, **kw):
        s, keys = real(self, queries, k, **kw)
        keys = keys.copy()
        keys[0, k - 1] = (keys[0, k - 1] + 1) % len(self)
        return s, keys
    monkeypatch.setattr(HNSWIndex, "search", search)


def _state_unchanged(monkeypatch):
    from duckdb_vss_tpu_torch.models import hnsw

    monkeypatch.setattr(hnsw, "insert_batch", lambda graph, *a, **kw: (
        graph, torch.zeros((), dtype=torch.int64)))


def _exchange_left_out(monkeypatch):
    from duckdb_vss_tpu_torch.ops.topk import smallest_k
    from duckdb_vss_tpu_torch.parallel import sharded

    real = sharded._merge

    def merge(mesh, scores, gids, k):
        real(mesh, scores, gids, k)  # every rank still meets the collective
        s, b, kk = scores.shape
        out_s, pos = smallest_k(scores.permute(1, 0, 2).reshape(b, s * kk), k)
        return out_s, torch.gather(
            gids.permute(1, 0, 2).reshape(b, s * kk), 1, pos)
    monkeypatch.setattr(sharded, "_merge", merge)


@pytest.mark.parametrize("name,fault", [
    ("sift1m.batch", _half_left_out),
    ("sift1m.batch", _answer_altered),
    ("sift1m.point-sql", _answer_altered),
    ("sift1m.insert", _state_unchanged),
    ("bigann-4m.batch", _exchange_left_out),
])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = small(name)
    fault(monkeypatch)
    out = run_small(cell, seconds=0.2)
    assert out["correct"] is False, out["checks"]
