"""The M. tuberculosis-scale workload that the port is measured on.

bench.py's seeded generators: a linear graph with biallelic SNP sites,
haplotypes sampled through it and reads sampled from the haplotypes;
the index is built by the reference package's ``build`` command (it
imports no JAX). ``chip_smoke.py`` and ``parallel/measure_mesh.py``
both map these reads.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np


def reference_sequence(prg_ints) -> str:
    """Reference-allele sequence of a non-nested linear PRG: the DNA
    outside sites plus the first allele of every site."""
    ints = np.asarray(prg_ints, dtype=np.int64)
    mpos = np.flatnonzero(ints > 4)
    parts = []
    prev = 0
    j = 0
    while j < mpos.size:
        entry = mpos[j]
        m = ints[entry]
        parts.append(ints[prev:entry])
        parts.append(ints[entry + 1:mpos[j + 1]])      # first allele
        j += 1
        while j + 1 < mpos.size and ints[mpos[j + 1]] == m + 1:
            j += 1                                     # to the site's end
        prev = mpos[j] + 1
        j += 1
    parts.append(ints[prev:])
    return "".join(np.array(list("NACGT"))[np.concatenate(parts)])


def make_workload(work: Path, genome_len: int = 4_400_000,
                  num_sites: int = 100_000, n_reads: int = 40_000,
                  read_len: int = 150, kmer_size: int = 10, seed: int = 42):
    """Writes ``prg.bin``, ``ref.fa``, ``reads.fq`` and the built index
    ``gram/`` into ``work``. Returns (idx, kmer_index, reads, a one-line
    summary)."""
    import bench
    from gramtools_tpu.cli import run as tpu_cli
    from gramtools_tpu.index.build import load_all
    from gramtools_tpu.prg.linearise import PrgString

    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    prg_ints = bench.build_synthetic_mtb_graph(rng, genome_len, num_sites)
    prg = PrgString(prg_ints)
    prg.write(work / "prg.bin")
    ref = reference_sequence(prg_ints)
    with open(work / "ref.fa", "w") as fh:
        fh.write(">ref\n")
        for i in range(0, len(ref), 60):
            fh.write(ref[i:i + 60] + "\n")
    paths = bench.sample_haplotypes(prg_ints, dict(prg.end_positions), rng,
                                    n_paths=8)
    reads = bench.sample_reads(rng, paths, n_reads, read_len)
    bench.write_fastq(work / "reads.fq", reads)
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    if tpu_cli(["build", "--gram_dir", str(work / "gram"),
                "--prg", str(work / "prg.bin"), "--ref", str(work / "ref.fa"),
                "--kmer_size", str(kmer_size), "--force"]) != 0:
        raise RuntimeError("build failed")
    build_s = time.perf_counter() - t0
    idx, kmer_index = load_all(work / "gram")
    summary = (f"{genome_len} bp genome, {num_sites} sites, fm size "
               f"{idx.fm.size}, {n_reads} reads of {read_len} bp; generated "
               f"in {gen_s:.1f} s, index built (k={kmer_size}) in "
               f"{build_s:.1f} s")
    return idx, kmer_index, reads, summary
