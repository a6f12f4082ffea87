"""A device trace around a region of the program.

Port of gramtools_tpu/common/timers.py ``device_trace`` (a
``jax.profiler`` trace there): a ``torch.profiler`` trace of the host
and, where a GPU is in use, of the device, written as a Chrome trace
(open it in chrome://tracing or Perfetto). The per-phase wall timers,
``TimerReport``, import no JAX and are the shared module's.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import torch


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
