"""Cells, configurations, traffic mixes, limits and metric readers are
found by name; a new one is taken up with no edit to an existing file."""

from __future__ import annotations

import json
import shutil

import pytest

from portbench import spec


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_every_cell_finds_its_files(name):
    cell = spec.find_cell(name)
    bench = spec.load_benchmark()
    w = {w["name"]: w for w in bench["workloads"]}[name]
    assert cell.config["name"] == w["config"]
    assert cell.chips == w["chips"]
    assert cell.traffic["driver"]
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    for m in cell.per_layer:
        assert m["moves"] in reported


def test_unknown_cell_names_the_cells():
    with pytest.raises(KeyError, match="sift1m.batch"):
        spec.find_cell("no-such.cell")


def test_a_new_cell_is_found_from_new_files_alone(tmp_path):
    """A copy of the benchmark, with a configuration, a traffic mix, the
    cell's limits and a metric reader added as new files and entries:
    every existing file but BENCHMARK.json is byte for byte as it was."""
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_benchmark()
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "sift1m.json").read_text())
    cfg.update(name="sift2m", n_rows=2_000_000)
    (pb / "configs" / "sift2m.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "small-batch.json").write_text(json.dumps(
        {"driver": "batch", "queries_per_call": 64, "query_sets": 8,
         "k": 10, "trace_calls": 50}))
    (pb / "limits" / "sift2m.small-batch.json").write_text(
        (pb / "limits" / "sift1m.batch.json").read_text())
    (pb / "metrics" / "calls_traced.py").write_text(
        "def read(run):\n    return run.calls\n")
    bench["configs"].append({"name": "sift2m", "source": "x",
                             "file": "portbench/configs/sift2m.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "sift2m.small-batch",
                               "config": "sift2m", "traffic": "small-batch",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "search_qps",
                               "workloads": ["sift2m.small-batch"]})
    bench["end_to_end"][0]["workloads"].append("sift2m.small-batch")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.find_cell("sift2m.small-batch", root=tmp_path)
    assert cell.config["n_rows"] == 2_000_000
    assert cell.traffic["queries_per_call"] == 64
    assert [m["name"] for m in cell.per_layer] == ["calls_traced"]
    assert {m["name"] for m in cell.end_to_end} == {"search_qps", "setup_s"}

    class R:
        calls = 7
    assert spec.metric_reader("calls_traced", root=tmp_path).read(R) == 7
    # a variant reads through its base's file until it brings its own
    assert spec.metric_reader("calls_traced.sql", root=tmp_path).read(R) == 7
    (pb / "metrics" / "calls_traced.sql.py").write_text(
        "def read(run):\n    return 2 * run.calls\n")
    assert spec.metric_reader("calls_traced.sql", root=tmp_path).read(R) == 14
    after = {p: p.read_bytes() for p in before}
    assert after == before
