"""seed_kernel_share and finish_kernel_share on fixed counters: the
kernels' queries over the searched ones, and None where the program
keeps no such counter (as one written before kernels K4 and K5) or the
run was not traced."""

from __future__ import annotations

import pytest

from portbench import program_spans
from portbench.spec import metric_reader


class _Run:
    def __init__(self, profile):
        self.profile = profile


@pytest.mark.parametrize("name, counter", [
    ("seed_kernel_share", "seed.kernel_queries"),
    ("finish_kernel_share", "finish.kernel_queries")])
def test_share_of_the_searched_queries(monkeypatch, name, counter):
    reader = metric_reader(name)
    assert reader.share({"search.queries": 10_000, counter: 10_000}) == 100.0
    assert reader.share({"search.queries": 8, counter: 2}) == 25.0
    monkeypatch.setattr(reader, "counters", lambda: {
        "search.queries": 4, counter: 4})
    assert reader.read(_Run(object())) == 100.0
    assert reader.read(_Run(None)) is None  # an untraced run


@pytest.mark.parametrize("name", ["seed_kernel_share", "finish_kernel_share"])
@pytest.mark.parametrize("c", [None, {}, {"search.queries": 5},
                               {"search.queries": 5,
                                "descent.kernel_queries": 5}])
def test_reads_nothing_without_the_counter(name, c):
    assert metric_reader(name).share(c) is None
