"""A rank other than 0 of a sharded configuration's run.

Started by programs.ShardedIndex in the benchmark's process (rank 0),
never by hand, with the cell as rank 0 runs it (a file rank 0
writes). It makes the cell's data from the seed as rank 0 does,
builds its shard, and makes each call rank 0 announces until the window
closes; with ``--trace 1`` it profiles those calls and hands rank 0 its
card's busy seconds and its NCCL kernels' times. It writes nothing but
its log. Where JAX or the JAX package is loaded by the end of set-up or
of the window, it says so and exits with code 3 once the group has
closed, so that rank 0 prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell-file", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", required=True)
    a = ap.parse_args(argv)

    import torch

    from portbench.run import Run, driver_for, forbidden_loaded
    from portbench.spec import Cell
    from portbench.trace import WINDOW, Profile, report

    dev = torch.device(a.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with open(a.cell_file) as f:
        cell = Cell(**json.load(f))
    run = Run(cell, a.seed, 0.0, bool(a.trace), dev,
              rank=a.rank, port=a.port)
    drv = driver_for(run)
    drv.setup()
    bad = {n: "set-up" for n in forbidden_loaded()}
    prof = None
    if run.trace:
        with Profile() as prof:
            with torch.profiler.record_function(WINDOW):
                drv.follow()
    else:
        drv.follow()
    for n in forbidden_loaded():
        bad.setdefault(n, "the window")
    drv.prog.finish(report(prof))
    if bad:
        print(f"portbench: rank {a.rank}: "
              + ", ".join(f"{n} loaded by the end of {w}"
                          for n, w in sorted(bad.items()))
              + "; the run measures the port alone", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
