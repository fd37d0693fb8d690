"""host_waits (``.search``, the batch cell): the points a traced call at
which the host blocked on the card, as the program counts them: its
``index.host_waits`` counter (program_spans.counters(), counted while
the traced calls ran) over the traced calls. 1.0 where each search waits
once, for its results; more where some path still waits on a copy.
Unlike host_syncs it also sees the waits of copies to the card. None
where the program keeps no such counter (one written before it, or a
run on the CPU)."""

from portbench.program_spans import counters


def per_call(c, calls):
    if not c or not calls or "index.host_waits" not in c:
        return None
    return c["index.host_waits"] / calls


def read(run):
    return None if run.profile is None else per_call(counters(), run.calls)
