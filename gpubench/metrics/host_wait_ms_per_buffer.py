"""The host's wait on the card, then the copy home, ms a buffer: the
median over the window's buffers of the engine's ``complete_get``
spans."""
from gpubench import stages


def read(run):
    win = stages.window(run)
    if win is None:
        return None
    return stages.median_ms(win.by_buffer({"complete_get"}))
