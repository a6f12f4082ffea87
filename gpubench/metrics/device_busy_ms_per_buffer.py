"""Device busy time a buffer, ms: the union of the device's operations
over the traced stretch, divided by the buffers submitted in it."""


def read(run):
    tr = run["trace"]
    if not tr or tr["busy_s"] is None or not tr["buffers"]:
        return None
    return tr["busy_s"] / tr["buffers"] * 1e3
