"""The device's idle share of the traced stretch, %: 100 less the
union of its operations over the stretch's wall time."""


def read(run):
    tr = run["trace"]
    if not tr or tr["busy_s"] is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
