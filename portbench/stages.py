"""Where the card's idle time falls among the program's own spans, in
one traced run of a cell.

    python3 -m portbench.stages --workload <cell> --seed <n> [--seconds <s>]

From the root of a checkout, with a card. Runs the cell as
``python3 -m portbench.run ... --trace 1`` does (set-up, the traced
calls, the judgement, the per-layer metrics), then prints one JSON line:
the result's ``correct``, ``metrics`` and ``breakdown``; each traced
call's ms; the window's idle seconds and how they split by the
innermost program span open on the window's host thread
(program_spans.py, names with a prefix of ``PROGRAM``; PyTorch's
operators and the benchmark's own wrappers are looked through), with
``(outside the program)`` for idle time in no such span; each program
span's count and summed seconds; and the program's counters. A program
without spans puts all of its idle time outside the program.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys

from portbench.program_spans import counters, merged, window_tid

PROGRAM = ("index.", "search.", "sql.", "insert.", "sharded.")
OUTSIDE = "(outside the program)"


def innermost(spans, lo: float, hi: float) -> list:
    """[(start, end, name)] cutting [lo, hi] by the innermost span open
    in each piece (None where none is). ``spans`` (start, end, name)
    nest as the calls of one host thread do."""
    out, stack, cur = [], [], lo

    def emit(end, name):
        nonlocal cur
        if end > cur:
            out.append((cur, end, name))
            cur = end

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            top = stack.pop()
            emit(top[1], top[2])
        emit(a, stack[-1][2] if stack else None)
        stack.append((a, b, name))
    while stack:
        top = stack.pop()
        emit(top[1], top[2])
    emit(hi, None)
    return out


def idle_by_span(prof) -> dict:
    """Idle seconds of the card in the window, by the innermost program
    span open on the window's host thread when it was idle."""
    lo, hi = prof.window
    tid = window_tid(prof)
    spans = [(a, b, n) for n, rng in prof.ranges.items()
             if n.startswith(PROGRAM) for a, b, t in rng
             if tid is None or t == tid]
    busy = merged((max(o[0], lo), min(o[1], hi)) for o in prof.in_window())
    ends = [e for _, e in busy]
    out = {}
    for a, b, name in innermost(spans, lo, hi):
        idle = b - a
        j = bisect.bisect_right(ends, a)
        while j < len(busy) and busy[j][0] < b:
            idle -= min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
        key = name or OUTSIDE
        out[key] = out.get(key, 0.0) + idle / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def span_seconds(prof) -> dict:
    """{program span: [count, summed seconds]} on every host thread."""
    return {n: [len(r), sum(b - a for a, b, _ in r) / 1e6]
            for n, r in sorted(prof.ranges.items()) if n.startswith(PROGRAM)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    a = ap.parse_args(argv)

    import torch

    import portbench.run as R
    from portbench.spec import ROOT, find_cell

    R.set_cache_dirs(ROOT)
    cell = find_cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench.stages: {a.workload} needs {cell.chips} CUDA "
              "card(s)", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    runs = []
    window = R.window

    def kept_window(run, drv, max_calls=None):
        runs.append(run)
        return window(run, drv, max_calls)

    R.window = kept_window
    out = R.execute(cell, a.seed, a.seconds, True, torch.device("cuda", 0))
    run = runs[0]
    prof = run.profile
    idle = idle_by_span(prof)
    total = sum(idle.values())
    print(json.dumps({
        "workload": a.workload, "seed": a.seed,
        "device": out["device"], "correct": out["correct"],
        "metrics": {k: v["value"] for k, v in out["metrics"].items()},
        "call_ms": [x * 1e3 for x in run.latencies],
        "window_s": prof.window_s, "idle_s": total,
        "idle_in_program_share": (1.0 - idle.get(OUTSIDE, 0.0) / total
                                  if total else None),
        "idle_by_span": idle, "span_seconds": span_seconds(prof),
        "counters": counters(), "breakdown": out["breakdown"]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
