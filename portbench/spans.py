"""The benchmark's own wrappers around the calls into the port's layers.

A metric reader (metrics/<name>.py) may list in ``SPANS`` the calls it
needs wrapped during the traced run, each a dict:

- ``target``: "<module>:<attribute path>", the function or method as
  its callers reach it (a module that imported it by name is the one to
  name);
- ``label``: the span's name;
- ``annotate``: wrap the call in torch.profiler.record_function(label),
  so the trace can tell which device operations it launched;
- ``clock``: record the call's seconds on the host clock, the device
  synchronized before the clock stops, in ``run.spans[label]`` as
  (index of the benchmark's call, seconds);
- ``keep``: a function (args, kwargs, result) -> value, appended to
  ``run.kept[label]``.

The pattern is chip_smoke.py's ``clocked``. Nothing is wrapped in a
run with ``--trace 0``.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

import torch


def _resolve(target: str):
    mod_name, path = target.split(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


def _wrap(fn, spec: dict, run):
    label = spec["label"]

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        ctx = (torch.profiler.record_function(label) if spec.get("annotate")
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            result = fn(*args, **kwargs)
        if spec.get("clock"):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            run.spans.setdefault(label, []).append(
                (run.call_index, time.perf_counter() - t0))
        if spec.get("keep"):
            run.kept.setdefault(label, []).append(
                spec["keep"](args, kwargs, result))
        return result

    return wrapper


def seconds_per_call(run, label: str) -> dict:
    """{index of the benchmark's call: seconds} of the clocked spans
    called ``label``, the spans of one call summed."""
    per = {}
    for i, s in run.spans.get(label, []):
        per[i] = per.get(i, 0.0) + s
    return per


@contextlib.contextmanager
def installed(specs: list, run):
    """Wrap every call of ``specs`` for the block's duration."""
    saved = []
    try:
        for spec in specs:
            owner, name = _resolve(spec["target"])
            saved.append((owner, name, owner.__dict__.get(name)))
            setattr(owner, name, _wrap(getattr(owner, name), spec, run))
        yield
    finally:
        for owner, name, old in reversed(saved):
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
