"""Device timing on CUDA events.

``device_time`` launches ``fn`` back to back between two CUDA events on
the current stream and returns the mean seconds per call. PyTorch
returns before the device finishes, so a host clock without a
synchronize would time the enqueue, not the work.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def device_time(fn: Callable[..., Any], *args: Any, iters: int = 20,
                warm: int = 2) -> float:
    """Mean seconds per call of fn(*args) on the current CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time needs a CUDA device")
    for _ in range(warm):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
