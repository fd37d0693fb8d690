"""The readings a cell's limits are set from, on the chip, in one process.

    python3 -m portbench.readings --workload <cell> --seeds 11,12,... \\
        --control-seeds 3 --seconds 3

For each seed, one run of the cell as the benchmark makes it (set-up,
a window of ``--seconds`` at the cell's own load and sizes, the
judgement) prints the numbers compared; on the first ``--control-seeds``
seeds the control (reference/control.py: the reference in the program's
place, in TF32) is judged on the same queries, held to the cell's limits
as the program is, and its numbers and verdict printed beside them. Each
line is JSON. The command exits with code 1 where the control came out
correct on any seed, or the program not correct. Nothing here runs in
the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args(argv)

    from portbench.run import execute, set_cache_dirs
    from portbench.spec import ROOT, find_cell

    set_cache_dirs(ROOT)
    import torch

    from portbench.reference.control import control_groups
    from portbench.reference.judge import checks, judge, passed

    dev = torch.device("cuda", 0)
    cell = find_cell(a.workload)
    failed = []
    for n, seed in enumerate(int(s) for s in a.seeds.split(",")):
        control = {}

        def on_answers(groups, rows):
            if n < a.control_seeds:
                k = int(cell.traffic["k"])
                control.update(judge(control_groups(groups, rows, k), rows,
                                     k, cell.limits["score_gap"]["max"]))

        out = execute(cell, seed, a.seconds, False, dev,
                      time.perf_counter(), on_answers)
        control_correct = (passed(checks(control, cell.config, cell.limits))
                           if control else None)
        if not out["correct"] or control_correct:
            failed.append(seed)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "correct": out["correct"],
                          "program": {k: v["value"] for k, v in
                                      out["checks"].items()},
                          "control": control,
                          "control_correct": control_correct,
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()}}), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if failed:
        print(f"portbench.readings: the program not correct, or the control "
              f"correct, on seeds {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
