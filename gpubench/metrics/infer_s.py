"""Seconds of ``LevelGenotyper`` on the window's coverage (host
clock)."""


def read(run):
    g = run["genotype"]
    return g["infer_s"] if g else None
