"""Profiler hooks (port of duckdb_vss_tpu/utils/tracing.py): the JAX
package exposes the XLA profiler, the port torch.profiler.

Usage:

    from duckdb_vss_tpu_torch.utils.tracing import trace, annotate

    with trace("build/tb"):             # torch.profiler -> TensorBoard dir
        idx.search(q, 10)

    with annotate("bulk_build"):        # named region in the trace
        idx.add(vecs, keys)

The trace records host activity, and the card's when CUDA is available:
every PyTorch operator and the kernels it launched, and the package's own
kernels K1 and K2 (launched through ctypes, so no operator names them;
CUPTI records them as kernels all the same).
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import ProfilerActivity


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


@contextlib.contextmanager
def annotate(name: str):
    """Named region that appears on the profiler timeline (and as an NVTX
    range once CUDA is initialized)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
