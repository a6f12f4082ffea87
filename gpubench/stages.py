"""The program's own spans in a traced run, and the idle gaps they name.

Under ``GRAMTOOLS_TPU_TIMERS=1`` (a ``--trace 1`` run) the port records
host-clock spans in ``gramtools_tpu_torch.common.timers.SPANS``: one
``quasimap_reads`` span a call, one ``iteration`` a buffer with its
``read_parse``, ``rng_draws``, ``scan_submit`` and ``record_complete``,
and the engine's stages under them, each with the id of the buffer it
works on. ``window(run)`` picks this run's share: the calls that end
after the benchmark's first span (the window's), and the last call
before them (set-up's warm buffer). A program without the store gives
None, and so does every reader built on it.

``reduce`` is ``trace.reduce`` with the program's spans beside the
benchmark's: the same busy seconds from the same device operations,
each idle gap named ``<benchmark span>/<innermost program span>``, and
the trace clock's skew against the host clock over the stretch.

    python3 -m gpubench.stages --workload <cell> --seed <n> --seconds <s> --out <file>

makes one traced run of a cell, prints its result line as
``gpubench.run`` does, and writes to ``--out`` the run's idle gaps so
named, the skew, and the window's spans by buffer and by stage.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from collections import defaultdict

from . import run as bench_run, spec, trace

_plain_reduce = trace.reduce


class Window:
    """This run's program spans: ``records`` (the store's, in order),
    ``calls`` (indexes of the window's ``quasimap_reads`` spans),
    ``warm`` (index of set-up's call, or None), ``buffers`` (ids of the
    window's buffers, in order)."""

    def __init__(self, records, calls, warm):
        self.records, self.calls, self.warm = records, calls, warm
        inside = set(calls)
        self.iterations = [i for i, r in enumerate(records)
                           if r.name == "iteration" and r.parent in inside]
        self.buffers = [records[i].buffer for i in self.iterations]

    def by_buffer(self, names) -> dict:
        """{buffer id: seconds in spans named ``names``} over the
        window's buffers (0.0 where a buffer has none)."""
        keep = set(self.buffers)
        out = dict.fromkeys(self.buffers, 0.0)
        for r in self.records:
            if r.name in names and r.buffer in keep:
                out[r.buffer] += r.end - r.start
        return out

    def spans(self, name):
        keep = set(self.buffers)
        return [r for r in self.records
                if r.name == name and r.buffer in keep]

    def self_seconds(self, i: int) -> float:
        """Span ``i``'s duration less the union of its children."""
        r = self.records[i]
        kids = [[c.start, c.end] for c in self.records[i + 1:]
                if c.parent == i]
        covered = sum(b - a for a, b in _union(kids))
        return (r.end - r.start) - covered


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def program_records(run):
    """The program's spans: ``run["program_spans"]`` where the harness
    passes them, else the program's store; None where it has none."""
    if run.get("program_spans") is not None:
        return list(run["program_spans"])
    try:
        from gramtools_tpu_torch.common.timers import SPANS
    except ImportError:
        return None
    return list(SPANS.records)


def window(run):
    """The ``Window`` of this run, or None where the program recorded no
    call span in it."""
    records = program_records(run)
    bench = run.get("spans") or []
    if not records or not bench:
        return None
    return split(records, min(t0 for _, _, t0, _ in bench))


def split(records, first: float):
    """The ``Window`` of the calls that end at or after host time
    ``first``; None where there is none."""
    calls = [i for i, r in enumerate(records)
             if r.name == "quasimap_reads" and r.end is not None]
    inside = [i for i in calls if records[i].end >= first]
    before = [i for i in calls if records[i].end < first]
    if not inside:
        return None
    return Window(records, inside, before[-1] if before else None)


def median_ms(seconds: dict):
    """The median of a {buffer: seconds} dict, ms; None where empty."""
    return statistics.median(seconds.values()) * 1e3 if seconds else None


# ---- the device trace, named by the program's spans ----------------------

def reduce(events: list, window_s: float, buffers: int, host: list,
           anchor: float, program: list) -> dict:
    """``trace.reduce``'s summary, its gaps named by the innermost
    program span (the shortest covering the gap's midpoint) after the
    benchmark's; ``gaps`` all idle gaps as [name, seconds, buffer];
    ``skew_us`` the trace clock less the host clock at the stretch's
    last synchronisation, with the two tied at its first."""
    out = _plain_reduce(events, window_s, buffers, host, anchor)
    syncs = sorted((float(e.get("ts", 0)), float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X"
                   and "DeviceSynchronize" in str(e.get("name", "")))
    if not syncs:
        return out
    offset = syncs[0][0] - anchor * 1e6
    last_ts, last_dur = syncs[-1]
    out["skew_us"] = (last_ts + last_dur - (anchor + window_s) * 1e6) - offset
    bench = [(a * 1e6 + offset, b * 1e6 + offset, n) for a, b, n in host]
    prog = [(r.start * 1e6 + offset, r.end * 1e6 + offset, r.name, r.buffer)
            for r in program if r.end is not None]
    busy = _union([float(e.get("ts", 0)),
                   float(e.get("ts", 0)) + float(e.get("dur", 0))]
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") in trace.DEVICE_CATS)
    gaps = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        name = next((n for s, t, n in bench if s <= mid <= t), "driver")
        cover = [(t - s, n, buf) for s, t, n, buf in prog if s <= mid <= t]
        buf = None
        if cover:
            _, inner, buf = min(cover, key=lambda c: c[0])
            name = f"{name}/{inner}"
        gaps.append([name, (b - a) * 1e-6, buf])
    gaps.sort(key=lambda g: -g[1])
    out["gaps"] = gaps
    out["idle_gaps"] = [g[:2] for g in gaps[:10]]
    return out


@contextlib.contextmanager
def capture():
    """Replaces ``trace.reduce`` by ``reduce`` with the program's spans
    for the block; yields the dict that receives its summary."""
    got = {}

    def named(events, window_s, buffers, host, anchor):
        got.update(reduce(events, window_s, buffers, host, anchor,
                          program_records({}) or []))
        return _plain_reduce(events, window_s, buffers, host, anchor)

    trace.reduce = named
    try:
        yield got
    finally:
        trace.reduce = _plain_reduce


def breakdown(win: Window) -> dict:
    """The window's spans by buffer and stage, each call's parts, and
    set-up's call by stage (seconds)."""
    recs = win.records
    stage = defaultdict(lambda: defaultdict(float))
    counts = defaultdict(lambda: defaultdict(int))
    keep = set(win.buffers)
    for r in recs:
        if r.buffer in keep and r.name != "iteration":
            stage[r.buffer][r.name] += r.end - r.start
            for key, n in (r.counts or {}).items():
                counts[r.buffer][key] += n
    per_buffer = []
    for i, b in zip(win.iterations, win.buffers):
        r = recs[i]
        per_buffer.append({"buffer": b, "start": r.start,
                           "iteration_s": r.end - r.start,
                           "self_s": win.self_seconds(i),
                           "stages_s": dict(stage[b]),
                           "counts": dict(counts[b])})
    calls = []
    for i in win.calls:
        parts = defaultdict(float)
        for r in recs[i + 1:]:
            if r.parent == i and r.name != "iteration":
                parts[r.name] += r.end - r.start
        calls.append({"call_s": recs[i].end - recs[i].start,
                      "self_s": win.self_seconds(i), "parts_s": dict(parts)})
    warm = None
    if win.warm is not None:
        w = recs[win.warm]
        warm = defaultdict(float)
        for r in recs:
            if w.start <= r.start and r.end <= w.end:
                warm[r.name] += r.end - r.start
    return {"buffers": per_buffer, "calls": calls,
            "warm_call_s": dict(warm) if warm is not None else None}


def main(argv=None) -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(prog="python3 -m gpubench.stages")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    import torch

    cell = spec.load_cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        bench_run.log(f"{cell.name} needs a CUDA device")
        return 2
    with capture() as named:
        result = bench_run.run_cell(cell, args.seed, args.seconds, True,
                                    args.device, t_start,
                                    workers=min(os.cpu_count() or 1, 8))
    print(json.dumps(result), flush=True)
    # a process of its own: its first call is set-up's, the rest the window's
    records = program_records({}) or []
    calls = [r for r in records if r.name == "quasimap_reads"]
    win = split(records, calls[1].start) if len(calls) > 1 else None
    out = {"result": result, "trace": named,
           "spans": breakdown(win) if win is not None else None}
    with open(args.out, "w") as fh:
        json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
