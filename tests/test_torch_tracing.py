"""The port's profiler hooks (duckdb_vss_tpu_torch.utils.tracing): trace()
writes a TensorBoard trace file of the enclosed work, and annotate()
names a region in it. On the CPU the trace holds host activity only."""

import glob
import json
import os

import numpy as np
import torch

from duckdb_vss_tpu_torch.models.hnsw import HNSWIndex
from duckdb_vss_tpu_torch.utils.config import HNSWConfig
from duckdb_vss_tpu_torch.utils.tracing import annotate, trace

torch.set_num_threads(2)


def _events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_holds_the_annotated_search(tmp_path):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(2000, 16)).astype(np.float32)
    idx = HNSWIndex(16, HNSWConfig(), capacity=2000, device="cpu",
                    layout="flat")
    idx.add(v, np.arange(2000))
    log_dir = str(tmp_path / "tb")
    with trace(log_dir) as where:
        with annotate("x"):
            _, keys = idx.search(v[:8], 5)
    assert where == log_dir
    assert (keys[:, 0] == np.arange(8)).mean() >= 0.9
    names = [e.get("name") for e in _events(log_dir)]
    assert "x" in names
    assert any(str(n).startswith("aten::") for n in names)


def test_annotate_outside_a_trace_is_harmless():
    with annotate("nothing recorded"):
        assert torch.ones(2).sum() == 2
