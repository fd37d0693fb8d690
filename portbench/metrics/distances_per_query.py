"""distances_per_query: the program's ``search.distances`` counter over
its ``search.queries`` counter (program_spans.counters(), counted while
the traced calls ran): the search's work per query, the exact descent's
scores of every upper-level node with the beam's and the rerank's. None
where the program keeps no such counters."""

from portbench.program_spans import counters


def per_query(c):
    if not c or not c.get("search.queries") or "search.distances" not in c:
        return None
    return c["search.distances"] / c["search.queries"]


def read(run):
    return None if run.profile is None else per_query(counters())
