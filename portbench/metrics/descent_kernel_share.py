"""descent_kernel_share (and ``.sql``, the same reading in the point-SQL
cell): the share, in %, of the searched queries whose upper-level
descent ran in kernel K3 (csrc/fused_descent.cu): the program's
``descent.kernel_queries`` counter over its ``search.queries`` counter
(program_spans.counters(), counted while the traced calls ran). 100
where every search descends through the kernel on the card. None where
the program keeps no such counter (a program without K3, or a run on
the CPU)."""

from portbench.program_spans import counters


def share(c):
    if (not c or not c.get("search.queries")
            or "descent.kernel_queries" not in c):
        return None
    return 100.0 * c["descent.kernel_queries"] / c["search.queries"]


def read(run):
    return None if run.profile is None else share(counters())
