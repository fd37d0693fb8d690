"""descent_kernel_share on fixed counters: the kernel's queries over the
searched ones, and None where the program keeps no kernel counter (as
one written before kernel K3) or the run was not traced."""

from __future__ import annotations

import pytest

from portbench import program_spans
from portbench.spec import metric_reader


class _Run:
    def __init__(self, profile):
        self.profile = profile


def test_share_of_the_searched_queries(monkeypatch):
    reader = metric_reader("descent_kernel_share")
    assert reader.share({"search.queries": 10_000,
                         "descent.kernel_queries": 10_000}) == 100.0
    assert reader.share({"search.queries": 8,
                         "descent.kernel_queries": 2}) == 25.0
    monkeypatch.setattr(program_spans, "counters", lambda: {
        "search.queries": 4, "descent.kernel_queries": 4})
    monkeypatch.setattr(reader, "counters", program_spans.counters)
    assert reader.read(_Run(object())) == 100.0
    assert reader.read(_Run(None)) is None  # an untraced run


@pytest.mark.parametrize("c", [None, {}, {"search.queries": 5},
                               {"search.queries": 0,
                                "descent.kernel_queries": 0}])
def test_reads_nothing_without_the_counter(c):
    assert metric_reader("descent_kernel_share").share(c) is None
