"""Small cells for the CPU tests: the cells of BENCHMARK.json with their
sizes cut so that a run takes seconds on the CPU."""

from __future__ import annotations

import pytest

SMALL_CONFIG = dict(n_rows=6000, dims=32, capacity=8192,
                    capacity_per_shard=4096)
SMALL_TRAFFIC = dict(queries_per_call=100, query_sets=2, query_pool=50,
                     warm_statements=2, trace_calls=3, rows_per_call=256,
                     capacity=12288, check_queries=50)


def small(name: str):
    from portbench.spec import find_cell

    cell = find_cell(name)
    cell.config.update(SMALL_CONFIG)
    cell.config["generator"] = dict(cell.config["generator"], n_centers=64)
    cell.traffic.update({k: v for k, v in SMALL_TRAFFIC.items()
                         if k in cell.traffic})
    return cell


@pytest.fixture
def small_cell():
    return small


def run_small(cell, seed=12345678901, seconds=0.5, trace=False,
              on_answers=None):
    import time

    import torch

    from portbench.run import execute

    return execute(cell, seed, seconds, trace, torch.device("cpu"),
                   time.perf_counter(), on_answers)
