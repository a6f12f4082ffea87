"""Seconds of the coverage dumps and the jVCF, personalised reference
and VCF writers (host clock)."""


def read(run):
    g = run["genotype"]
    return g["outputs_s"] if g else None
