"""The port's spans and counters, recorded only while torch.profiler is
recording (port of duckdb_vss_tpu/utils/tracing.py: the JAX package
exposes the XLA profiler, the port torch.profiler).

Usage:

    from duckdb_vss_tpu_torch.utils.tracing import (annotate, counters,
                                                    trace)

    with trace("build/tb"):             # torch.profiler -> TensorBoard dir
        idx.search(q, 10)               # its spans and counts land there
    counters()                          # {"search.queries": ..., ...}

    with annotate("my.region"):         # a span of the caller's own
        ...

**Spans.** ``annotate(name)`` (a context manager) and ``span(name)`` (a
decorator) open one. While torch.profiler records, a span is
``torch.profiler.record_function(name)``: a ``user_annotation`` in the
trace, on the same clock as the operators and kernels launched inside
it, and nested by the host thread's call stack (every span of a call
lies inside that call's outermost span). While it does not record, a
span costs one check of the profiler's state and a shared no-op
context, under a microsecond, and nothing else: no dispatcher
operation, no NVTX range, no allocation. A recorded span costs about
10 us of host time (two profiler events).

**Counters.** ``count(name, value)`` adds ``value`` (a Python int or a
device scalar) to a counter, while the profiler records and never
otherwise. A device value is kept as it is, so a count launches no
operation and waits for nothing; ``counters()`` sums every counter's
device values once, on their devices, and reads each sum back then.
Counts accumulate over every recorded stretch until ``reset_counters()``.

The names, one place for all of them (PERF.md documents them as the
contract between the program and the benchmark, portbench/):

- index API (models/hnsw.py): ``index.search`` holds ``index.upload``
  (a chunk's prepare_queries and its copy to the device) and
  ``index.download`` (scores and slots to the host, the key map);
  ``index.add`` holds the insert's spans.
- search (models/graph.py, search_graph): ``search.descent`` (mxu or
  beam descent), ``search.seed`` (seed_beam), ``search.beam`` (K1, or
  the step-by-step beam_search), ``search.finish`` (_finish_search);
  every operator of search_graph runs inside one of them. Counters
  ``search.queries`` (rows searched), ``search.distances`` (the n_dist
  search_graph returns), ``k1.distances`` and ``k1.expansions`` (K1's
  returned counts), ``descent.kernel_queries`` (the queries kernel K3,
  the fused descent, took: counted at its launch, ops/fused_descent.py).
- SQL (sql/): ``sql.execute`` (all of Database.execute) holds
  ``sql.parse``, then per statement ``sql.plan`` (binding, the
  index-scan rewrite), the operators ``sql.scan`` (``index.search``
  inside an index scan), ``sql.filter``, ``sql.topn``, ``sql.project``,
  and ``sql.result`` (the column batch).
- insert (models/build.py): ``insert.step`` (one insert_batch call)
  holds ``insert.upper`` (the batch's upper slots and peers, phase A),
  ``insert.base`` (phase B: mxu seeds, beam, selection) and
  ``insert.backlinks``; ``insert.rows`` (update_neighborhood_rows)
  follows each step. Counter ``insert.rows`` (rows inserted).
- shards (parallel/sharded.py): ``sharded.search`` holds
  ``sharded.upload``, ``sharded.issue`` (every shard's search_graph),
  ``sharded.gather`` (results to a row's device, all_gather_on_device),
  ``sharded.merge`` (the merge's top-k) and ``sharded.download``
  (results to the host, _keys_of).

The trace records host activity, and the card's when CUDA is available:
every PyTorch operator and the kernels it launched, and the package's
own kernels K1, K2 and K3 (launched through ctypes, so no operator names
them; CUPTI records them as kernels all the same).
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import ProfilerActivity, record_function

# True while the profiler records on this thread: one call into C
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_counts: dict[str, list] = {}  # name -> Python ints and device scalars


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed work into ``log_dir`` as a TensorBoard
    trace file (``<worker>.<time>.pt.trace.json``)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir


def annotate(name: str):
    """A span called ``name`` around a ``with`` block: the profiler's
    ``record_function`` while it records, else a shared no-op."""
    return record_function(name) if _recording() else _OFF


def span(name: str):
    """Decorator: every call of the function is a span called ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)

        return spanned

    return wrap


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a scalar tensor on any device) to the
    counter ``name`` while the profiler records; else do nothing."""
    if _recording():
        _counts.setdefault(name, []).append(value)


def counters() -> dict[str, int]:
    """Every counter's total: each device's values summed there and
    read back once."""
    out = {}
    for name, values in _counts.items():
        total, on = 0, {}
        for v in values:
            if isinstance(v, torch.Tensor):
                on.setdefault(v.device, []).append(v.reshape(()).long())
            else:
                total += int(v)
        out[name] = total + sum(int(torch.stack(ts).sum())
                                for ts in on.values())
    return out


def reset_counters() -> None:
    """Forget every count."""
    _counts.clear()
