"""The traced run's profile, read from torch.profiler's trace.

``Profile`` runs torch.profiler (CPU and CUDA activity) around the traced
calls, writes the trace to a file under TMPDIR, reads it back and
deletes it. The readers (metrics/*.py) ask it for the device operations
(kernels, copies, sets) in the traced window, those launched inside one
of the benchmark's annotations (spans.py), the device's busy time, and
the breakdown of the result line. The busy-time union is a frozen copy
of ``union_ms`` in chip_smoke.py's ``overlap_of``.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import torch

WINDOW = "portbench.window"  # the annotation around the traced calls
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def report(prof) -> dict:
    """What a rank hands rank 0 when the window closes: its card's busy
    and window seconds, and the microseconds of each NCCL kernel of the
    window in the order they ran (None and [] in an untraced run)."""
    if prof is None:
        return {"busy_s": None, "window_s": None, "nccl_us": []}
    return {"busy_s": prof.busy_s(), "window_s": prof.window_s,
            "nccl_us": [o[1] - o[0] for o in sorted(prof.in_window(
                ("kernel",))) if "nccl" in o[2].lower()]}


def per_collective(ranks: list) -> list | None:
    """Each NCCL kernel's microseconds on every rank, one tuple a
    collective: the ranks run the same collectives in the same order.
    None when no rank ran one or their counts differ."""
    lists = [r.get("nccl_us") or [] for r in ranks]
    if not lists or not lists[0] or len({len(x) for x in lists}) != 1:
        return None
    return list(zip(*lists))


class Profile:
    """torch.profiler over a block; then its events, parsed."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        self._parse(events)
        return False

    def _parse(self, events) -> None:
        self.device_ops = []  # (ts, end, name, cat, correlation)
        self.launch = {}  # correlation -> (ts, tid) of the host's launch
        self.ranges = {}  # annotation name -> sorted [(ts, end, tid)]
        host = []  # (ts, end, tid, name) of host operators
        for e in events:
            cat, ph = e.get("cat"), e.get("ph")
            if ph != "X":
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device_ops.append((ts, ts + dur, e.get("name", cat),
                                        cat, args.get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    self.launch[args["correlation"]] = (ts, e.get("tid"))
            elif cat in ("user_annotation", "cpu_op"):
                host.append((ts, ts + dur, e.get("tid"), e.get("name", "")))
                if cat == "user_annotation":
                    self.ranges.setdefault(e.get("name", ""), []).append(
                        (ts, ts + dur, e.get("tid")))
        for v in self.ranges.values():
            v.sort()
        win = self.ranges.get(WINDOW)
        self.window = (win[0][0], win[-1][1]) if win else (
            (min(o[0] for o in self.device_ops),
             max(o[1] for o in self.device_ops)) if self.device_ops
            else (0.0, 0.0))
        tid = win[0][2] if win else None
        self.host = sorted(h for h in host if tid is None or h[2] == tid)
        self._host_ts = [h[0] for h in self.host]

    # -- what the readers ask ---------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def in_window(self, cats=DEVICE_CATS):
        a, b = self.window
        return [o for o in self.device_ops
                if o[3] in cats and o[1] > a and o[0] < b]

    def busy_s(self) -> float:
        """Seconds of the traced window in which the device ran an
        operation (kernels, copies, sets), overlaps counted once."""
        a, b = self.window
        return union_us((max(o[0], a), min(o[1], b))
                        for o in self.in_window()) / 1e6

    def launched_in(self, name: str, cats=DEVICE_CATS):
        """Device operations whose host launch lies inside an annotation
        called ``name`` on the same host thread."""
        rng = self.ranges.get(name, [])
        starts = [r[0] for r in rng]
        out = []
        for o in self.device_ops:
            if o[3] not in cats or o[4] not in self.launch:
                continue
            ts, tid = self.launch[o[4]]
            i = bisect.bisect_right(starts, ts) - 1
            while i >= 0 and rng[i][0] <= ts:
                if rng[i][1] >= ts and rng[i][2] == tid:
                    out.append(o)
                    break
                if ts - rng[i][0] > 60e6:
                    break
                i -= 1
        return out

    def count(self, name: str) -> int:
        """How many annotations called ``name`` the trace holds."""
        return len(self.ranges.get(name, []))

    def _host_at(self, t: float) -> str:
        """The innermost host operator running at time t."""
        i = bisect.bisect_right(self._host_ts, t) - 1
        for j in range(i, max(i - 4000, -1), -1):
            h = self.host[j]
            if h[1] >= t and h[3] != WINDOW:
                return h[3]
        return "(host code outside any operator)"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time in the window, and
        the longest idle gaps of the device, summed by what the host was
        running when each began: seconds, at most ``top`` of each."""
        ops = {}
        for o in self.in_window():
            ops[o[2]] = ops.get(o[2], 0.0) + (o[1] - o[0]) / 1e6
        spans = sorted((o[0], o[1]) for o in self.in_window())
        gaps, end = [], self.window[0]
        for a, b in spans:
            if a > end:
                gaps.append((a - end, end))
            end = max(end, b)
        if self.window[1] > end:
            gaps.append((self.window[1] - end, end))
        gaps.sort(reverse=True)
        idle = {}
        for length, start in gaps[:500]:
            name = self._host_at(start + 0.5)
            idle[name] = idle.get(name, 0.0) + length / 1e6

        def top_of(d):
            return [[k[:120], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": top_of(ops), "idle_gaps": top_of(idle)}
