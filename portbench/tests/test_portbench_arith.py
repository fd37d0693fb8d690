"""The yardstick's arithmetic on fixed inputs: K1's byte bound, the
trace's busy time, idle share, annotation attribution and breakdown,
and the exchange between ranks apart from the wait for the slowest."""

from __future__ import annotations

import pytest

from portbench.roofline import beam_bound_s
from portbench.spec import metric_reader
from portbench.trace import WINDOW, Profile, report, union_us


def test_k1_bound_at_the_search_chunk():
    """chip_smoke.py's figure for B=8192, ef 64, M0 32, d 128 with the
    run's counts (530,876 live selections, 7,445,215 kept rows): 0.3491
    ms, bound by bytes."""
    ms = beam_bound_s(8192, 64, 32, 128, 530_876, 7_445_215) * 1e3
    assert ms == pytest.approx(0.3491, abs=5e-5)
    # twice the rows, twice the row bytes: still bytes, not operations
    assert beam_bound_s(8192, 64, 32, 128, 530_876, 2 * 7_445_215) > \
        beam_bound_s(8192, 64, 32, 128, 530_876, 7_445_215)


def test_union_counts_overlaps_once():
    assert union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert union_us([]) == 0


def _events():
    """A window of 100 us on host thread 1: a descent annotation
    launching two kernels, a copy outside it, and a host operator."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0,
         "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.descent",
         "ts": 5, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 35,
         "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 6, "dur": 1, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10, "dur": 1, "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 40, "dur": 1, "tid": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "topk", "ts": 10, "dur": 20,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 20, "dur": 20,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 80,
         "dur": 10, "args": {"correlation": 3}},
    ]
    p = Profile()
    p._parse(ev)
    return p


def test_busy_idle_and_attribution():
    p = _events()
    assert p.window_s == pytest.approx(100e-6)
    assert p.busy_s() == pytest.approx(40e-6)  # [10, 40] and [80, 90]
    idle = 100.0 * (1.0 - p.busy_s() / p.window_s)
    assert idle == pytest.approx(60.0)
    assert {o[2] for o in p.launched_in("portbench.descent")} == {"topk",
                                                                 "gemm"}
    assert p.count("portbench.descent") == 1
    b = p.breakdown()
    assert b["device_ops"][0] == ["topk", pytest.approx(20e-6)]
    gaps = dict((n, s) for n, s in b["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(40e-6)  # [40, 80]
    # [0, 10] and [90, 100] begin where no operator runs
    assert gaps["(host code outside any operator)"] == pytest.approx(20e-6)


def test_a_ranks_report_lists_its_nccl_kernels_in_order():
    ev = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0,
           "dur": 100, "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllGather",
           "ts": 50, "dur": 7},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 5, "dur": 9},
          {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllGather",
           "ts": 20, "dur": 3}]
    p = Profile()
    p._parse(ev)
    r = report(p)
    assert r["nccl_us"] == [3, 7]
    assert r["busy_s"] == pytest.approx(19e-6)
    assert report(None) == {"busy_s": None, "window_s": None, "nccl_us": []}


class _Run:
    calls = 2
    extra = {"ranks": [{"nccl_us": [10.0, 20.0]}, {"nccl_us": [3.0, 25.0]},
                       {"nccl_us": [5.0, 21.0]}, {"nccl_us": [4.0, 30.0]}]}


def test_collective_is_the_last_ranks_kernel_and_wait_the_rest():
    """Each collective's shortest kernel is the exchange (the rank that
    came last waits for no one); its longest less its shortest is the
    wait for the slowest rank."""
    ex = metric_reader("collective_ms").read(_Run)
    wait = metric_reader("collective_wait_ms").read(_Run)
    assert ex == pytest.approx((3 + 20) / 1e3 / 2)
    assert wait == pytest.approx(((10 - 3) + (30 - 20)) / 1e3 / 2)


@pytest.mark.parametrize("ranks", [
    [{"nccl_us": [1.0]}, {"nccl_us": [1.0, 2.0]}],  # counts differ
    [{"nccl_us": []}, {"nccl_us": []}],  # no collective (the CPU)
    [],
])
def test_collective_readers_find_nothing_to_read(ranks):
    class R(_Run):
        extra = {"ranks": ranks}
    assert metric_reader("collective_ms").read(R) is None
    assert metric_reader("collective_wait_ms").read(R) is None
