"""The comparison that decides ``correct``.

Mapping: one reads file of the window, drawn from the seed, is mapped
again by the plain reference, and the program's answer for it (the
stats and coverage that its ``quasimap_reads`` call returned, and the
per-base coverage that call added) must equal the reference's exactly:
each number below is a sum of absolute differences, with the limit 0.

Genotyping: the haploid calls that the program wrote to its VCF are
held to the truth, the allele sequence that the sample's haplotype
takes through each level-1 site. ``call_errors`` counts the sites whose
call is null or names another sequence.
"""
from __future__ import annotations

import gzip
import sys

import numpy as np

from .reference.quasimap import STATS

# the mapping's numbers compare exactly; a configuration that genotypes
# states the limit of ``call_errors`` under "limits" (each with the
# readings it was set from in PERF.md section 2)
LIMITS = {"stats_diff": 0, "allele_sum_diff": 0, "grouped_diff": 0,
          "per_base_diff": 0}


def mapping_numbers(program: dict, ref) -> dict:
    """``program``: stats (dict), allele_sum, grouped (lists by site) and
    per_base (by PRG position) of the sampled file."""
    stats = sum(abs(int(program["stats"][k]) - int(ref.stats[k]))
                for k in STATS)
    return {"stats_diff": stats,
            "allele_sum_diff": _nested_diff(program["allele_sum"],
                                            ref.allele_sum),
            "grouped_diff": _grouped_diff(program["grouped"], ref.grouped),
            "per_base_diff": int(np.abs(program["per_base"].astype(np.int64)
                                        - ref.per_base.astype(np.int64))
                                 .sum())}


def _nested_diff(a: list, b: list) -> int:
    total = abs(len(a) - len(b)) * 10 ** 6
    for x, y in zip(a, b):
        if len(x) != len(y):
            total += sum(x) + sum(y)
        else:
            total += sum(abs(p - q) for p, q in zip(x, y))
    return int(total)


def _grouped_diff(a: list, b: list) -> int:
    total = abs(len(a) - len(b)) * 10 ** 6
    for x, y in zip(a, b):
        for key in set(x) | set(y):
            total += abs(x.get(key, 0) - y.get(key, 0))
    return int(total)


def vcf_calls(path) -> list:
    """(REF and ALT alleles, the called allele index or None) of each
    record of a VCF, in order."""
    out = []
    with gzip.open(path, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            alleles = [f[3]] + ([] if f[4] == "." else f[4].split(","))
            gt = f[9].split(":")[0]
            out.append((alleles, None if gt in (".", "./.") else
                        int(gt.split("/")[0])))
    return out


def call_errors(vcf_path, level1_sites: np.ndarray, path: np.ndarray,
                spans: np.ndarray) -> int:
    """Level-1 sites whose call is null or another sequence than the
    haplotype's. ``level1_sites``: the level-1 site indexes in PRG order
    (one VCF record each); ``spans``: each site's [start, end) in
    ``path``."""
    calls = vcf_calls(vcf_path)
    if len(calls) != level1_sites.size:
        return 10 ** 6 + abs(len(calls) - level1_sites.size)
    lut = np.frombuffer(b"NACGT", np.uint8)
    wrong = null = 0
    for (alleles, gt), site in zip(calls, level1_sites):
        if gt is None:
            null += 1
            continue
        a, b = spans[site]
        wrong += alleles[gt] != lut[path[a:b]].tobytes().decode()
    print(f"gpubench: calls: {wrong} wrong, {null} null of "
          f"{len(calls)} level-1 sites", file=sys.stderr)
    return wrong + null
