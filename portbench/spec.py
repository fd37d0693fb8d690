"""BENCHMARK.json and the files it names.

A cell (one entry of ``workloads``) is found by its name; its
configuration, traffic mix, limits and metric readers are files found
by their names, so a later change adds a cell, a mix or a metric by
adding files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file, as run
    traffic: dict  # the traffic mix's parameters
    limits: dict  # limits/<cell>.json
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, bench: dict | None = None,
              root: Path = ROOT) -> Cell:
    """The cell called ``name``, with every file it names loaded."""
    bench = load_benchmark(root) if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(by_name))})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(root / "portbench" / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)


def metric_reader(name: str, root: Path = ROOT):
    """The module of ``metrics/<name>.py``, or, where a variant such as
    ``idle_share.sql`` has no file of its own, of the file named by the
    part before the first dot (``metrics/idle_share.py``). ``read(run)``
    returns the metric's value, or None where the run holds nothing to
    read; an optional ``SPANS`` lists the calls it needs wrapped
    (spans.py)."""
    metrics = root / "portbench" / "metrics"
    path = metrics / f"{name}.py"
    if not path.exists():
        path = metrics / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
