"""The device trace of a stretch of warm buffers, reduced.

``torch.profiler`` traces the card's activity (no host operators, whose
recording would slow the host path many times over) over a fixed
stretch early in the window; its Chrome trace gives each device
operation (kernels, copies, sets) with its start and length. From them:
the seconds in which the device ran anything (the union of its
operations), the device time by operation name, and the idle gaps
between operations, each named by the benchmark's host span it fell in.
The host spans are on ``time.perf_counter``; a synchronisation at the
start of the stretch, whose runtime call the trace records, ties that
clock to the trace's.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Stretch:
    """Starts the profiler at ``start`` and ends it at ``stop``."""

    def __init__(self):
        self.prof = None
        self.summary = None

    def start(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CUDA
                if torch.cuda.is_available()
                else torch.profiler.ProfilerActivity.CPU]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = _now()
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def stop(self, buffers: int, spans: list):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = _now() - self.t0
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        host = [(t0, t1, name) for name, _, t0, t1 in spans
                if t1 >= self.t0]
        self.summary = reduce(events, window_s, buffers, host, self.t0)


def _now() -> float:
    import time

    return time.perf_counter()


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events: list, window_s: float, buffers: int, host: list,
           anchor: float) -> dict:
    """busy_s, window_s, buffers, the top device operations by time and
    the longest idle gaps by host span; busy_s is None where the trace
    holds no device operation. ``host``: (start, end, name) spans on
    the host clock; ``anchor``: the host time just before the stretch's
    first synchronisation."""
    dev = []
    sync = None
    by_name = defaultdict(float)
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        if e.get("cat") in DEVICE_CATS:
            dev.append((ts, ts + dur))
            by_name[e.get("name", "?")] += dur * 1e-6
        elif "DeviceSynchronize" in str(e.get("name", "")):
            sync = ts if sync is None else min(sync, ts)
    spans = []
    if sync is not None:
        offset = sync - anchor * 1e6
        spans = [(a * 1e6 + offset, b * 1e6 + offset, n) for a, b, n in host]
    busy = _union(dev)
    gaps = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        name = next((n for s, t, n in spans if s <= mid <= t),
                    "driver" if spans else "unattributed")
        gaps.append([name, (b - a) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(([n, s] for n, s in by_name.items()), key=lambda o: -o[1])
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6 if busy else None,
            "window_s": window_s, "buffers": buffers,
            "device_ops": ops[:10], "idle_gaps": gaps[:10]}
