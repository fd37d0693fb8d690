"""host_syncs: device-to-host copies (the trace's ``gpu_memcpy`` events
named DtoH) launched inside the program's call-level spans
(program_spans.py), per traced call: each is a point where the host
waits for the card. Its variants (``.search``, ``.sharded``, ``.sql``,
``.insert``) are this reading in the cells whose end-to-end metric each
moves. None where the program has no such span, or the card ran
nothing (a run on the CPU)."""

from portbench.program_spans import dtoh_in_calls


def read(run):
    prof = run.profile
    if prof is None or not run.calls or not prof.in_window():
        return None
    n = dtoh_in_calls(prof)
    return None if n is None else n / run.calls
