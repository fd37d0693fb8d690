"""span_idle_ms: ms per traced call in which rank 0's card ran no
operation while the program was inside one of its call-level spans
(``index.search``, ``sharded.search``, ``index.add``; program_spans.py):
the spans' union less the card's operations inside it, from the trace.
It splits the window's idle time (idle_share) into the part inside the
program and the part in the benchmark's loop. Its variants (``.search``,
``.sharded``, ``.sql``, ``.insert``) are this reading in the cells whose
end-to-end metric each moves. None where the program has no such
span, or the card ran nothing (a run on the CPU)."""

from portbench.program_spans import call_idle_us


def read(run):
    prof = run.profile
    if prof is None or not run.calls or not prof.in_window():
        return None
    idle = call_idle_us(prof)
    return None if idle is None else idle / 1e3 / run.calls
