"""collective_ms: device ms per call of the exchange between the ranks
(parallel/sharded.py ``all_gather_on_device`` under ``_merge``), from
every rank's trace. For each collective of the traced calls it takes
the shortest of the ranks' NCCL kernels: the last rank to reach it waits
for no one, so its kernel is the exchange alone. The wait for the
slowest rank is collective_wait_ms."""

from portbench.trace import per_collective


def read(run):
    ops = per_collective(run.extra.get("ranks") or [])
    if ops is None or not run.calls:
        return None
    return sum(min(o) for o in ops) / 1e3 / run.calls
