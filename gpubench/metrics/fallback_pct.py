"""Rows re-mapped exactly on the host, % of the rows the engine took:
``host_fallbacks / (device_mapped + host_fallbacks)`` over the window."""


def read(run):
    c = run["counters"]
    rows = c["device_mapped"] + c["host_fallbacks"]
    return 100.0 * c["host_fallbacks"] / rows if rows else None
