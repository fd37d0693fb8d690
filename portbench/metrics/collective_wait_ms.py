"""collective_wait_ms: device ms per call by which the first rank to
reach each collective waits for the last, from every rank's trace: for
each collective of the traced calls, its longest NCCL kernel less its
shortest (collective_ms), summed. It reads how far the ranks run out of
step, by host issue or by uneven shards."""

from portbench.trace import per_collective


def read(run):
    ops = per_collective(run.extra.get("ranks") or [])
    if ops is None or not run.calls:
        return None
    return sum(max(o) - min(o) for o in ops) / 1e3 / run.calls
