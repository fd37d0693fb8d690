"""search_qps: queries answered in the window over the window's seconds
(host clock; the window ends at the first call completed after
--seconds). ``search_qps.sharded`` is the same reading on rank 0 of the
sharded cell, across every shard, kept apart for its own bound: the
sharded search spreads wider from run to run."""


def read(run):
    return run.units / run.window_s if run.window_s > 0 else None
