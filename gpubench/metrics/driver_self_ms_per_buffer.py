"""The driver's own time, ms a buffer: the median over the window's
``iteration`` spans (``mapping/quasimap.py``) of each one's duration
less the part its child spans cover (the read parse, the RNG draws, the
engine's two pipeline calls)."""
from gpubench import stages


def read(run):
    win = stages.window(run)
    if win is None:
        return None
    return stages.median_ms({b: win.self_seconds(i) for i, b
                             in zip(win.iterations, win.buffers)})
