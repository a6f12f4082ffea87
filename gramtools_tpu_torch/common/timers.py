"""Per-phase timing + peak-memory reports, and a device trace.

Parity: libgramtools src/common/timer_report.cpp:10-48 (TimerReport)
plus the sdsl memory monitor the reference wraps around FM-index
construction (src/prg/make_data_structures.cpp:12-29): each phase
records its peak RSS alongside wall time (Linux VmHWM, reset per phase
via /proc/self/clear_refs when writable; falls back to the monotone
high-water mark otherwise); a copy of gramtools_tpu/common/timers.py.

``device_trace`` is the port of the reference package's
(a ``jax.profiler`` trace there): a ``torch.profiler`` trace of the
host and, where a GPU is in use, of the device, written as a Chrome
trace (open it in chrome://tracing or Perfetto).

``SPANS`` is the mapping path's span store, filled only under
``GRAMTOOLS_TPU_TIMERS=1``: the driver's call, its buffers and their
parts (``mapping/quasimap.py``) and the engine's stages
(``mapping/engine.py``), each a ``Span`` on ``time.perf_counter``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

log = logging.getLogger("gramtools_tpu")


def _read_vm_hwm_bytes() -> Optional[int]:
    """Peak resident set size of this process, bytes (Linux)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def _reset_vm_hwm() -> bool:
    """Reset the kernel's peak-RSS counter so the next VmHWM read is a
    per-phase peak (writing '5' to clear_refs; needs permission)."""
    try:
        with open("/proc/self/clear_refs", "w") as fh:
            fh.write("5\n")
        return True
    except OSError:
        return False


class TimerReport:
    def __init__(self):
        # (name, seconds, peak_rss_bytes or None)
        self.entries: List[Tuple[str, float, Optional[int]]] = []
        self._start = None
        self._name = None

    def start(self, name: str):
        self._name = name
        _reset_vm_hwm()
        self._start = time.perf_counter()

    def stop(self):
        if self._name is None:
            return
        self.entries.append((self._name, time.perf_counter() - self._start,
                             _read_vm_hwm_bytes()))
        self._name = None

    @contextlib.contextmanager
    def phase(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop()

    def report(self):
        log.info("Timer report:")
        total = 0.0
        for name, elapsed, peak in self.entries:
            mem = f"  peak {peak / 1e6:8.1f}MB" if peak else ""
            log.info("  %-24s %8.2fs%s", name, elapsed, mem)
            total += elapsed
        log.info("  %-24s %8.2fs", "TOTAL", total)

    def as_dict(self):
        """Per-phase {seconds, peak_mem_mb} for command report JSONs."""
        return {name: {
            "seconds": round(elapsed, 3),
            "peak_mem_mb": round(peak / 1e6, 1) if peak else None,
        } for name, elapsed, peak in self.entries}


@contextlib.contextmanager
def device_trace(log_dir):
    """Profile the region; on exit write ``log_dir/trace.json``. Yields
    the profiler, whose ``key_averages()`` give the time by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


@dataclasses.dataclass(slots=True)
class Span:
    """One host-clock span of the mapping path: ``start`` and ``end`` on
    ``time.perf_counter``; ``buffer`` the id of the reads buffer it works
    on (None outside one); ``parent`` the index in the store of the span
    open around it (None at the top); ``counts`` what a stage counted
    (the host re-maps' rows by reason)."""
    name: str
    buffer: Optional[int]
    start: float
    end: Optional[float]
    parent: Optional[int]
    counts: Optional[dict] = None


class SpanStore:
    """Spans in memory, in the order they opened; nothing is written to
    disk. ``span`` opens one around a block; ``add`` records one timed
    by its caller (an engine stage), under the innermost open span and
    with its buffer. Buffer ids come from one counter for the life of
    the store, so they are unique across calls and across ``clear``."""

    def __init__(self):
        self.records: List[Span] = []
        self._open: List[int] = []
        self._buffers = itertools.count()

    def new_buffer(self) -> int:
        return next(self._buffers)

    def now(self) -> float:
        return time.perf_counter()

    def _enclosing(self):
        if not self._open:
            return None, None
        i = self._open[-1]
        return i, self.records[i].buffer

    @contextlib.contextmanager
    def span(self, name: str, buffer: Optional[int] = None,
             start: Optional[float] = None):
        """A span around the block; ``buffer`` None takes the enclosing
        span's; ``start`` backdates it to an earlier clock reading."""
        parent, outer = self._enclosing()
        self.records.append(Span(name, outer if buffer is None else buffer,
                                 self.now() if start is None else start,
                                 None, parent))
        self._open.append(len(self.records) - 1)
        try:
            yield
        finally:
            self.records[self._open.pop()].end = self.now()

    def add(self, name: str, start: float, end: Optional[float] = None,
            counts: Optional[dict] = None, buffer: Optional[int] = None):
        """Records a span that ended at ``end`` (now, if None)."""
        parent, outer = self._enclosing()
        self.records.append(Span(name, outer if buffer is None else buffer,
                                 start, self.now() if end is None else end,
                                 parent, counts))

    def clear(self):
        self.records.clear()
        self._open.clear()


class _Off:
    """The recorder while timing is off: records nothing, reads no
    clock."""

    _null = contextlib.nullcontext()

    def new_buffer(self) -> None:
        return None

    def now(self) -> float:
        return 0.0

    def span(self, name, buffer=None, start=None):
        return self._null

    def add(self, name, start, end=None, counts=None, buffer=None):
        pass


SPANS = SpanStore()
OFF = _Off()


def recorder():
    """``SPANS`` under ``GRAMTOOLS_TPU_TIMERS=1``, else ``OFF``."""
    return SPANS if os.environ.get("GRAMTOOLS_TPU_TIMERS") == "1" else OFF
