"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's files are found by name
(spec.py). Set-up makes the data on the card from the seed, builds the
program's state and warms every shape the window uses; the window is a
closed loop of the traffic mix's calls, ended by the first call that
completes after ``--seconds``. With ``--trace 1`` the benchmark's
wrappers (spans.py) and torch.profiler run over the mix's
``trace_calls`` calls instead, and the line carries the per-layer
metrics, the device's busy and window seconds and the breakdown. Once
the window has closed and the peak memory is read, the program's state
is freed and the plain reference judges every answer (reference/).

The run fails, printing no result, without enough CUDA cards or when
JAX or the JAX package is loaded by the end of set-up or of the window.
The last line of standard output is the result; the numbers compared,
each beside its limit, are the last lines of standard error and the
last key of the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "duckdb_vss_tpu")


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that the run may not hold,
    compared whole: ``duckdb_vss_tpu_torch`` is not ``duckdb_vss_tpu``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout (the port's own nvcc builds go to build/kernels/)."""
    cache = root / "build" / "portbench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ["USE_FLAX"] = "0"
    os.environ["NCCL_SHM_DISABLE"] = "1"


@dataclasses.dataclass
class Run:
    """One run's state, shared by the driver, the wrappers and the
    metric readers."""
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: object
    rank: int = 0
    port: int = 0
    root: Path = dataclasses.field(
        default_factory=lambda: Path(__file__).resolve().parents[1])
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0  # queries, statements or rows in the window
    calls: int = 0
    call_index: int = -1
    latencies: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)
    kept: dict = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)
    numbers: dict = dataclasses.field(default_factory=dict)
    profile: object = None  # trace.Profile of the traced run


def driver_for(run: Run):
    name = run.cell.traffic["driver"]
    return importlib.import_module(f"portbench.drivers.{name}").Driver(run)


def window(run: Run, drv, max_calls: int | None = None) -> None:
    """The closed loop: calls until one completes after run.seconds (or
    after max_calls calls, or when the mix has no more work)."""
    t0 = time.perf_counter()
    i = 0
    while True:
        run.call_index = i
        t = time.perf_counter()
        units = drv.call(i)
        if units is None:
            break
        run.latencies.append(time.perf_counter() - t)
        run.units += units
        i += 1
        if (time.perf_counter() - t0 >= run.seconds
                or (max_calls is not None and i >= max_calls)):
            break
    run.window_s = time.perf_counter() - t0
    run.calls = i


def host_sample() -> tuple:
    """(host clock, this process's CPU seconds, its involuntary context
    switches, the machine's steal ticks or None)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8])
    except (OSError, IndexError, ValueError):
        steal = None
    return (time.perf_counter(), ru.ru_utime + ru.ru_stime, ru.ru_nivcsw,
            steal)


def host_line(run: Run, before: tuple, after: tuple) -> str:
    """What the host did in the window, for the run's standard error:
    the process's CPU seconds over the window's, its involuntary context
    switches and the machine's steal ticks, and the spread of the calls'
    latencies (their coefficient of variation, and the relative standard
    error of the window's mean call that it implies)."""
    wall = after[0] - before[0]
    lat = run.latencies
    cv = se = float("nan")
    if len(lat) > 1:
        mean = sum(lat) / len(lat)
        sd = (sum((x - mean) ** 2 for x in lat) / (len(lat) - 1)) ** 0.5
        cv, se = sd / mean, sd / mean / len(lat) ** 0.5
    steal = (after[3] - before[3] if None not in (after[3], before[3])
             else "n/a")
    return (f"host: cpu {(after[1] - before[1]) / wall:.4f} of the window's "
            f"{wall:.3f} s, involuntary switches {after[2] - before[2]}, "
            f"steal ticks {steal}, load {os.getloadavg()[0]:.2f}; calls "
            f"{len(lat)}, latency cv {cv:.4f}, standard error of the mean "
            f"{se:.5f}")


def refuse_forbidden(when: str) -> None:
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"portbench: {', '.join(bad)} loaded by the end of "
                         f"{when}; the run measures the port alone")


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float = T_START, on_answers=None) -> dict:
    """Set-up, window, judgement and metrics of one run: the result.
    ``on_answers(groups, rows)``, if given, also sees what was judged
    (readings.py runs the control on it)."""
    import torch

    from portbench import spans
    from portbench.reference.judge import checks, judge, passed
    from portbench.spec import metric_reader
    from portbench.trace import WINDOW, Profile, report

    run = Run(cell, int(seed), float(seconds), bool(trace), device)
    drv = driver_for(run)
    readers = {m["name"]: metric_reader(m["name"])
               for m in (cell.per_layer if trace else cell.end_to_end)}
    try:
        drv.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        run.setup_s = time.perf_counter() - t_start
        refuse_forbidden("set-up")
        before = host_sample()
        if trace:
            wanted = list({(s["target"], s["label"]): s
                           for r in readers.values()
                           for s in getattr(r, "SPANS", [])}.values())
            with spans.installed(wanted, run), Profile() as prof:
                with torch.profiler.record_function(WINDOW):
                    window(run, drv, int(cell.traffic["trace_calls"]))
                after = host_sample()
            run.profile = prof
        else:
            window(run, drv)
            after = host_sample()
        print(host_line(run, before, after), file=sys.stderr)
        ranks = drv.finish(report(run.profile))
        run.extra["ranks"] = ranks
    except BaseException:
        prog = getattr(drv, "prog", None)
        if prog is not None:
            prog.abort()
        raise
    refuse_forbidden("the window")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    groups, rows = drv.groups()
    run.numbers = judge(groups, rows, int(cell.traffic["k"]),
                        cell.limits["score_gap"]["max"])
    if on_answers is not None:
        on_answers(groups, rows)
    del groups, rows
    chk = checks(run.numbers, cell.config, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": passed(chk), "attempted": run.units,
           "failed": run.numbers["missing"], "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda"
                      else device.type,
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                      "count": cell.chips,
                      "memory_peak_bytes": max(r["peak"] for r in ranks)}}
    if trace:
        busies = [r["busy_s"] for r in ranks if r["busy_s"] is not None]
        out["device"]["busy_s"] = sum(busies) / len(busies)
        out["device"]["window_s"] = run.profile.window_s
        out["breakdown"] = run.profile.breakdown()
    out["checks"] = chk
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from portbench.spec import ROOT, find_cell

    set_cache_dirs(ROOT)
    import torch

    cell = find_cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = execute(cell, a.seed, a.seconds, bool(a.trace),
                  torch.device("cuda", 0))
    for name, c in out["checks"].items():
        lim = f"<= {c['max']}" if "max" in c else f">= {c['min']}"
        print(f"check {name}: {c['value']!r} (limit {lim})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
