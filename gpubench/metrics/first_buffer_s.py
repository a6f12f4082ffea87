"""Set-up's warm buffer, s: the duration of the program's
``quasimap_reads`` span just before the window, the first call of a
run's process (tables built and uploaded, kernels loaded, first
launches)."""
from gpubench import stages


def read(run):
    win = stages.window(run)
    if win is None or win.warm is None:
        return None
    r = win.records[win.warm]
    return r.end - r.start
