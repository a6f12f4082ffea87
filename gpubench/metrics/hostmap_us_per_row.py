"""The host's exact re-maps, us a row: the seconds of the engine's
``complete_hostmap`` spans over the window's buffers, divided by the
rows those spans counted (unseeded, overflow, record_flagged). The row
count goes to standard error."""
import sys

from gpubench import stages


def read(run):
    win = stages.window(run)
    if win is None:
        return None
    spans = win.spans("complete_hostmap")
    rows = sum(sum((r.counts or {}).values()) for r in spans)
    if not rows:
        return None
    print(f"gpubench: hostmap_us_per_row over {rows} rows", file=sys.stderr)
    return sum(r.end - r.start for r in spans) / rows * 1e6
