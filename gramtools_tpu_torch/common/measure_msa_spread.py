"""Times host genotyping, haploid and diploid, of the MSA workload under
each of its divergence spreads.

Run from the root of a checkout, on the CPU:

    python3 -m gramtools_tpu_torch.common.measure_msa_spread --out DIR \\
        [--cli gramtools_tpu_torch.cli ...]

For each spread of ``common/workload.SPREADS`` and each of SEEDS it writes
the ``build --prgs_bed`` input of ``make_msa_workload`` at a small size
(4 regions of 1-4 kb on an 80 kb reference, 2,000 reads, k = 10) into
``DIR/<spread>_<seed>``, prints the built graph's shape, then builds it
with each ``--cli`` (a package's CLI module taking this package's
commands; this package's by default) and runs ``genotype --engine
host`` with ``--ploidy haploid`` and ``diploid``, each in a process of
its own, JOBS at a time, each cut at LIMIT_S seconds. One
JSON line a run: its wall seconds, the Genotyping seconds of its timer
report, whether it was cut, and whether its jVCF equals the first
CLI's. Under the "even" spread most seeds' diploid runs are cut: the
model weighs every pair of a site's alleles (``infer/model.py``), and a
nested site's alleles can combine thousands of ways.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..prg.linearise import PrgString
from .workload import SPREADS, graph_shape, make_msa_workload

PLOIDIES = ("haploid", "diploid")
SEEDS = (1, 2, 3, 42)
LIMIT_S = 300.0
JOBS = 6


def _cli(module: str, args: list, log: Path, limit: float) -> dict:
    """``python -m module args`` with its output into ``log``, cut at
    ``limit`` seconds: its wall seconds, exit code and whether it was
    cut."""
    env = dict(os.environ, GRAMTOOLS_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-m", module] + args,
                                stdout=fh, stderr=subprocess.STDOUT, env=env)
        try:
            rc, cut = proc.wait(timeout=limit), False
        except subprocess.TimeoutExpired:
            proc.kill()
            rc, cut = proc.wait(), True
    return {"seconds": time.perf_counter() - t0, "rc": rc, "cut": cut}


def _genotyping_s(log: Path):
    """The Genotyping seconds of a run's timer report, or None."""
    got = re.findall(r"Genotyping\s+([0-9.]+)s", log.read_text())
    return float(got[-1]) if got else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--cli", nargs="+", default=["gramtools_tpu_torch.cli"])
    a = ap.parse_args(argv)
    runs = []
    for spread, seed in ((sp, se) for sp in SPREADS for se in SEEDS):
        work = a.out / f"{spread}_{seed}"
        work.mkdir(parents=True, exist_ok=True)
        make_msa_workload(work, ref_len=80_000, n_regions=4, n_reads=2_000,
                          seed=seed, load=False, spread=spread)
        shape = graph_shape(PrgString.from_file(work / "gram" / "prg").ints)
        print(json.dumps({"spread": spread, "seed": seed, "shape": shape}),
              flush=True)
        for i, cli in enumerate(a.cli):
            gram = work / f"gram_{i}"
            got = _cli(cli, ["build", "--gram_dir", str(gram), "--prgs_bed",
                             str(work / "regions.bed"), "--ref",
                             str(work / "ref.fa"), "--kmer_size", "10",
                             "--force"], work / f"build_{i}.log", LIMIT_S)
            if got["rc"] != 0:
                raise RuntimeError(f"{cli} build failed ({work.name})")
            runs += [(work.name, i, cli, ploidy) for ploidy in PLOIDIES]

    def genotype(run):
        name, i, cli, ploidy = run
        work = a.out / name
        out = work / f"g_{i}_{ploidy}"
        log = work / f"g_{i}_{ploidy}.log"
        got = _cli(cli, ["genotype", "--gram_dir", str(work / f"gram_{i}"),
                         "--genotype_dir", str(out), "--reads",
                         str(work / "reads.fq"), "--sample_id", "s",
                         "--seed", "7", "--engine", "host", "--ploidy",
                         ploidy, "--force"], log, LIMIT_S)
        got["genotyping_s"] = _genotyping_s(log)
        return got

    with ThreadPoolExecutor(JOBS) as pool:
        results = list(pool.map(genotype, runs))
    for (name, i, cli, ploidy), got in zip(runs, results):
        jvcf = Path("genotype") / "genotyped.json"
        first = a.out / name / f"g_0_{ploidy}" / jvcf
        mine = a.out / name / f"g_{i}_{ploidy}" / jvcf
        same = (None if got["rc"] != 0 or not first.exists() else
                mine.read_bytes() == first.read_bytes())
        print(json.dumps({"workload": name, "cli": cli, "ploidy": ploidy,
                          **got, "jvcf_equals_first_cli": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
