"""The engine's host seconds a buffer, ms: the sum of its stage timers
(``GRAMTOOLS_TPU_TIMERS=1``) over the window's buffers."""


def read(run):
    if not run["timers"] or not run["buffers"]:
        return None
    return sum(run["timers"].values()) / run["buffers"] * 1e3
