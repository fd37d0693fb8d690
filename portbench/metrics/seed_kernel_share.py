"""seed_kernel_share: the share, in %, of the searched queries whose
seed beam ran in kernel K4 (csrc/search_ends.cu): the program's
``seed.kernel_queries`` counter over its ``search.queries`` counter
(program_spans.counters(), counted while the traced calls ran). 100
where every search on the card goes through the kernel. None where the
program keeps no such counter (a program without the kernel, or a run
on the CPU, where graph.seed_beam runs)."""

from portbench.program_spans import counters


def share(c):
    if (not c or not c.get("search.queries")
            or "seed.kernel_queries" not in c):
        return None
    return 100.0 * c["seed.kernel_queries"] / c["search.queries"]


def read(run):
    return None if run.profile is None else share(counters())
