"""The host's kmer screen and seeding, ms a buffer: the median over the
window's buffers of the engine's ``submit_filter`` and ``submit_seed``
spans."""
from gpubench import stages


def read(run):
    win = stages.window(run)
    if win is None:
        return None
    return stages.median_ms(win.by_buffer({"submit_filter", "submit_seed"}))
