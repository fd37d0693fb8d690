"""host_waits on fixed counters: the program's waits over the traced
calls, and None where the program keeps no such counter (as one written
before it) or the run was not traced."""

from __future__ import annotations

import pytest

from portbench import program_spans
from portbench.spec import metric_reader


class _Run:
    def __init__(self, profile, calls):
        self.profile, self.calls = profile, calls


def test_waits_per_traced_call(monkeypatch):
    reader = metric_reader("host_waits.search")
    assert reader.per_call({"index.host_waits": 8}, 8) == 1.0
    assert reader.per_call({"index.host_waits": 33,
                            "search.queries": 80_000}, 8) == 4.125
    monkeypatch.setattr(program_spans, "counters", lambda: {
        "index.host_waits": 16, "search.queries": 80_000})
    monkeypatch.setattr(reader, "counters", program_spans.counters)
    assert reader.read(_Run(object(), 8)) == 2.0
    assert reader.read(_Run(None, 8)) is None  # an untraced run


@pytest.mark.parametrize("c, calls", [
    (None, 8), ({}, 8), ({"search.queries": 80_000}, 8),
    ({"index.host_waits": 8}, 0)])
def test_reads_nothing_without_the_counter(c, calls):
    assert metric_reader("host_waits.search").per_call(c, calls) is None
