"""finish_kernel_share: the share, in %, of the searched queries whose
exact rerank and top k ran in kernel K5 (csrc/search_ends.cu): the
program's ``finish.kernel_queries`` counter over its ``search.queries``
counter (program_spans.counters(), counted while the traced calls ran).
100 where every search on the card goes through the kernel. None where
the program keeps no such counter (a program without the kernel, or a
run on the CPU, where graph._finish_search runs)."""

from portbench.program_spans import counters


def share(c):
    if (not c or not c.get("search.queries")
            or "finish.kernel_queries" not in c):
        return None
    return 100.0 * c["finish.kernel_queries"] / c["search.queries"]


def read(run):
    return None if run.profile is None else share(counters())
