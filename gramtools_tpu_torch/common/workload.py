"""The M. tuberculosis-scale workload that the port is measured on.

Seeded generators, copied from the repository's bench.py: a linear
graph with biallelic SNP sites, haplotypes sampled through it and reads
sampled from the haplotypes; the index is built by this package's
``build`` command. ``chip_smoke.py`` and
``parallel/measure_mesh.py`` both map these reads.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np


def build_synthetic_mtb_graph(rng, genome_len, num_sites):
    """Linear PRG: random genome with evenly spread biallelic SNPs."""
    seq = rng.randint(1, 5, size=genome_len).astype(np.uint32)
    positions = np.sort(rng.choice(np.arange(1, genome_len - 1),
                                   size=num_sites, replace=False))
    out = np.empty(genome_len + 4 * num_sites, dtype=np.uint32)
    cursor = 0
    prev = 0
    for i, pos in enumerate(positions):
        site = 5 + 2 * i
        chunk = seq[prev:pos]
        out[cursor : cursor + chunk.size] = chunk
        cursor += chunk.size
        ref_base = seq[pos]
        alt_base = ref_base % 4 + 1
        out[cursor : cursor + 5] = [site, ref_base, site + 1, alt_base,
                                    site + 1]
        cursor += 5
        prev = pos + 1
    chunk = seq[prev:]
    out[cursor : cursor + chunk.size] = chunk
    cursor += chunk.size
    return out[:cursor]


def sample_haplotypes(prg_ints, end_positions, rng, n_paths):
    """Splices random-allele haplotype sequences out of a linear PRG,
    recursing into nested sites."""
    ints = np.asarray(prg_ints, dtype=np.int64)
    n = ints.size
    is_marker = ints > 4
    # next marker position at-or-after each index
    next_marker = np.full(n + 1, n, dtype=np.int64)
    mpos = np.flatnonzero(is_marker)
    if mpos.size:
        idx = np.searchsorted(mpos, np.arange(n), side="left")
        next_marker[:n] = np.where(idx < mpos.size, mpos[np.minimum(
            idx, mpos.size - 1)], n)
    entries = {int(ints[p]): int(p) for p in mpos if ints[p] % 2 == 1}
    # per-site allele spans (between the entry and end markers, split at
    # top-level even-marker positions, which for value m+1 are exactly
    # the positions holding m+1 -- nested sites use different markers);
    # end_positions is keyed by the even (allele) marker m+1
    spans = {}
    for m, entry in entries.items():
        end = end_positions[m + 1]
        seps = [int(p) for p in range(entry + 1, end + 1)
                if ints[p] == m + 1]
        lo = entry + 1
        sp = []
        for s in seps:
            sp.append((lo, s))
            lo = s + 1
        spans[m] = sp

    def walk(lo, hi, parts, r):
        i = lo
        while i < hi:
            v = int(ints[i])
            if v > 4:
                m = v if v % 2 == 1 else v - 1
                sp = spans[m]
                a, b = sp[r.randint(len(sp))]
                walk(a, b, parts, r)
                i = end_positions[m + 1] + 1
            else:
                j = min(int(next_marker[i]), hi)
                parts.append(ints[i:j])
                i = j

    paths = []
    for _ in range(n_paths):
        parts = []
        walk(0, n, parts, rng)
        paths.append(np.concatenate(parts).astype(np.uint8))
    return paths


def sample_reads(rng, paths, n_reads, read_len):
    reads = np.empty((n_reads, read_len), dtype=np.uint8)
    for i in range(n_reads):
        path = paths[rng.randint(len(paths))]
        start = rng.randint(0, path.size - read_len)
        reads[i] = path[start : start + read_len]
    return reads


def write_fastq(path, reads):
    lut = np.frombuffer(b"NACGT", dtype="S1")
    with open(path, "w") as fh:
        qual = "I" * reads.shape[1]
        for i, r in enumerate(reads):
            seq = lut[r].tobytes().decode()
            fh.write(f"@r{i}\n{seq}\n+\n{qual}\n")



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
                  read_len: int = 150, kmer_size: int = 10, seed: int = 42,
                  load: bool = True):
    """Writes ``prg.bin``, ``ref.fa``, ``reads.fq`` and the built index
    ``gram/`` into ``work``. Returns (idx, kmer_index, reads, a one-line
    summary); ``load=False`` leaves the index on disk (idx and kmer_index
    None), for a caller that only writes the workload."""
    from ..cli import run as cli
    from ..index.build import load_all
    from ..prg.linearise import PrgString

    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    prg_ints = build_synthetic_mtb_graph(rng, genome_len, num_sites)
    prg = PrgString(prg_ints)
    prg.write(work / "prg.bin")
    ref = reference_sequence(prg_ints)
    with open(work / "ref.fa", "w") as fh:
        fh.write(">ref\n")
        for i in range(0, len(ref), 60):
            fh.write(ref[i:i + 60] + "\n")
    paths = sample_haplotypes(prg_ints, dict(prg.end_positions), rng,
                              n_paths=8)
    reads = sample_reads(rng, paths, n_reads, read_len)
    write_fastq(work / "reads.fq", reads)
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    if cli(["build", "--gram_dir", str(work / "gram"),
            "--prg", str(work / "prg.bin"), "--ref", str(work / "ref.fa"),
            "--kmer_size", str(kmer_size), "--force"]) != 0:
        raise RuntimeError("build failed")
    build_s = time.perf_counter() - t0
    idx, kmer_index = load_all(work / "gram") if load else (None, None)
    summary = (f"{genome_len} bp genome, {num_sites} sites, "
               + (f"fm size {idx.fm.size}, " if load else "")
               + f"{n_reads} reads of {read_len} bp; generated in "
               f"{gen_s:.1f} s, index built (k={kmer_size}) in "
               f"{build_s:.1f} s")
    return idx, kmer_index, reads, summary
