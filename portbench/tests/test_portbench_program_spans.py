"""The readers of the program's own spans and counters on fixed trace
events: the card's idle time inside and outside a call-level span, the
device-to-host copies launched inside one, the SQL layer's self time,
the distances per query, and the idle time by innermost span; each
reads None where the program has no such span or counter."""

from __future__ import annotations

import pytest

from portbench import program_spans, stages
from portbench.spec import metric_reader
from portbench.trace import WINDOW, Profile


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _profile(events):
    p = Profile()
    p._parse([_x("user_annotation", WINDOW, 0, 200)] + events)
    return p


def _calls():
    """Two call-level spans on the window's thread, [10, 60] and
    [100, 140], one more on another thread; kernels [20, 40] inside
    the first, [50, 80] across its end, [150, 160] outside both; a
    DtoH copy launched in each span and one outside, an HtoD copy
    inside."""
    ev = [
        _x("user_annotation", "index.search", 10, 50),
        _x("user_annotation", "sharded.search", 100, 40),
        _x("user_annotation", "index.search", 0, 200, tid=2),
        _x("kernel", "k1", 20, 20, corr=1),
        _x("kernel", "k2", 50, 30, corr=2),
        _x("kernel", "k3", 150, 10, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 45, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 145, 1, corr=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 55, 1, corr=4),
        _x("cuda_runtime", "cudaMemcpyAsync", 130, 1, corr=5),
        _x("cuda_runtime", "cudaMemcpyAsync", 170, 1, corr=6),
        _x("cuda_runtime", "cudaMemcpyAsync", 12, 1, corr=7),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 81, 2,
           corr=4),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 131, 2, corr=5),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 171, 2,
           corr=6),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 13, 1,
           corr=7),
    ]
    return _profile(ev)


class _Run:
    calls = 2

    def __init__(self, profile):
        self.profile = profile


def test_span_idle_is_idle_inside_the_call_spans_only():
    """Inside [10, 60] the card runs [13, 14], [20, 40], [50, 60]: 19 us
    idle; inside [100, 140] the copy [131, 133]: 38 us idle. The thread
    2 span and the idle time outside the calls do not count."""
    p = _calls()
    assert program_spans.call_idle_us(p) == pytest.approx(19 + 38)
    ms = metric_reader("span_idle_ms.search").read(_Run(p))
    assert ms == pytest.approx(57 / 1e3 / 2)


def test_host_syncs_count_dtoh_copies_launched_inside_a_call():
    p = _calls()
    assert program_spans.dtoh_in_calls(p) == 2  # not the one at 170
    assert metric_reader("host_syncs.sharded").read(_Run(p)) == 1.0


def test_sql_self_is_the_statement_less_its_search():
    ev = [_x("user_annotation", "sql.execute", 0, 100),
          _x("user_annotation", "sql.parse", 1, 9),
          _x("user_annotation", "index.search", 20, 30),
          _x("user_annotation", "sql.execute", 110, 40),
          _x("user_annotation", "index.search", 120, 10),
          _x("user_annotation", "sql.execute", 160, 20),
          _x("user_annotation", "index.search", 160, 20, tid=2)]
    p = _profile(ev)
    assert program_spans.self_us(p, "sql.execute", "index.search") == [
        70, 30, 20]
    assert metric_reader("sql_self_ms").read(_Run(p)) == pytest.approx(
        30 / 1e3)


def test_distances_per_query_from_counters(monkeypatch):
    reader = metric_reader("distances_per_query")
    assert reader.per_query({"search.queries": 8,
                             "search.distances": 536_000}) == 67_000
    monkeypatch.setattr(program_spans, "counters", lambda: {
        "search.queries": 10, "search.distances": 700})
    monkeypatch.setattr(reader, "counters", program_spans.counters)
    assert reader.read(_Run(_calls())) == 70
    assert reader.read(_Run(None)) is None  # an untraced run


@pytest.mark.parametrize("c", [None, {}, {"search.distances": 5},
                               {"search.queries": 0, "search.distances": 5}])
def test_distances_per_query_reads_nothing_without_counters(c):
    assert metric_reader("distances_per_query").per_query(c) is None


def test_readers_read_none_without_program_spans():
    """A trace of a program without spans (the window and a kernel with
    a copy) reads None, not 0, in each reader of spans; so does one
    with spans where the card ran nothing (a run on the CPU)."""
    bare = _profile([_x("kernel", "k", 20, 20, corr=1),
                     _x("cuda_runtime", "cudaMemcpyAsync", 5, 1, corr=2),
                     _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
                        40, 2, corr=2)])
    cpu = _profile([_x("user_annotation", "index.search", 10, 50),
                    _x("user_annotation", "sql.execute", 5, 80)])
    for p in (bare, cpu):
        for name in ("span_idle_ms.search", "host_syncs.insert"):
            assert metric_reader(name).read(_Run(p)) is None
    assert metric_reader("sql_self_ms").read(_Run(bare)) is None
    assert metric_reader("span_idle_ms.sql").read(_Run(None)) is None


def test_idle_by_innermost_span():
    """Window [0, 200]: index.search [10, 110] holds search.beam [30, 60]
    and index.download [80, 100]; the card runs [40, 50] and [100,
    120]. Idle: beam 20, download 20, the search's own 10 + 20 + 0 (its
    [10, 30], [60, 80]; [100, 110] is busy), outside 10 + 80."""
    p = _profile([
        _x("user_annotation", "index.search", 10, 100),
        _x("user_annotation", "search.beam", 30, 30),
        _x("user_annotation", "index.download", 80, 20),
        _x("user_annotation", "portbench.descent", 35, 5),
        _x("cpu_op", "aten::copy_", 82, 5),
        _x("kernel", "k", 40, 10), _x("kernel", "k", 100, 20)])
    idle = stages.idle_by_span(p)
    assert idle == pytest.approx({
        "search.beam": 20e-6, "index.download": 20e-6,
        "index.search": 40e-6, stages.OUTSIDE: 90e-6})
    assert stages.span_seconds(p)["index.search"] == [1, pytest.approx(
        100e-6)]
    bare = _profile([_x("kernel", "k", 40, 10)])
    assert stages.idle_by_span(bare) == pytest.approx(
        {stages.OUTSIDE: 190e-6})
