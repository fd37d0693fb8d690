"""The program's own spans and counters, as the traced run finds them.

The port opens its spans through ``duckdb_vss_tpu_torch.utils.tracing``
(PERF.md lists the names): while torch.profiler records, each is a
``user_annotation`` in the trace, on the clock of the kernels it
launched. Its counters are ``tracing.counters()``. A program that has
no such span or counter (one written before them) gives the readers
nothing to read: each then returns None and raises nothing.

The call-level spans, one per call into the index API or the sharded
index, are ``CALL_SPANS``. Only spans on the host thread that ran the
benchmark's window are read.
"""

from __future__ import annotations

from portbench.trace import WINDOW

CALL_SPANS = ("index.search", "sharded.search", "index.add")


def window_tid(prof):
    """The host thread that ran the benchmark's window (None: any)."""
    win = prof.ranges.get(WINDOW)
    return win[0][2] if win else None


def spans(prof, names) -> list:
    """(start, end) in us of every span called one of ``names`` on the
    window's host thread, in start order."""
    tid = window_tid(prof)
    return sorted((a, b) for n in names for a, b, t in prof.ranges.get(n, [])
                  if tid is None or t == tid)


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(xs: list, ys: list) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def call_idle_us(prof) -> float | None:
    """Microseconds inside the union of the call-level spans in which
    the card ran no operation (kernel, copy or set); None without such
    a span."""
    calls = merged(spans(prof, CALL_SPANS))
    if not calls:
        return None
    busy = merged((o[0], o[1]) for o in prof.device_ops)
    return sum(b - a for a, b in calls) - overlap_us(calls, busy)


def dtoh_in_calls(prof) -> int | None:
    """Device-to-host copies launched inside a call-level span (each one
    a point where the host waits for the card); None without such a
    span."""
    if not spans(prof, CALL_SPANS):
        return None
    return len({o[4] for name in CALL_SPANS
                for o in prof.launched_in(name, ("gpu_memcpy",))
                if "DtoH" in o[2]})


def self_us(prof, parent: str, child: str) -> list:
    """Each ``parent`` span's microseconds less the part of it that its
    ``child`` spans cover, in start order."""
    kids = merged(spans(prof, (child,)))
    return [(b - a) - overlap_us([[a, b]], kids)
            for a, b in spans(prof, (parent,))]


def counters() -> dict | None:
    """The program's counters (tracing.counters()), or None where the
    program keeps none."""
    try:
        from duckdb_vss_tpu_torch.utils.tracing import counters as read
    except ImportError:
        return None
    return read()
