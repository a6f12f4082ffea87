"""The workloads that the port is measured on.

Seeded generators. Two graph profiles are copies of the repository's
bench.py: a linear graph with biallelic SNP sites (``snp``, the
M. tuberculosis-scale default) and its ``mixed`` profile (70% SNPs, 10%
deletions, 10% insertions, 5% four-allele sites, 5% nested sites);
haplotypes sampled through a graph and reads sampled from the
haplotypes; the index is built by this package's ``build`` command.
``make_msa_workload`` writes what ``build --prgs_bed`` reads (a
reference, a bed of regions, one MSA a region, the rows from a two-level
tree of clades and members) and builds it. ``chip_smoke.py`` and
``parallel/measure_mesh.py`` map these reads.
"""
from __future__ import annotations

import json
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


def build_mixed_graph(rng, genome_len, num_sites):
    """Linear PRG with SNPs, deletions, insertions, multi-allelic and
    nested sites (BENCH_PROFILE=mixed): exercises direct-deletion jump
    targets, adjacent-marker chains and larger per-step marker fan-out."""
    seq = rng.randint(1, 5, size=genome_len).astype(np.uint32)
    # keep >=12bp between variant anchors so ref spans never collide
    positions = 12 + np.sort(rng.choice(
        np.arange((genome_len - 24) // 12), size=num_sites,
        replace=False)) * 12
    kinds = rng.choice(5, size=num_sites,
                       p=[0.70, 0.10, 0.10, 0.05, 0.05])
    out = []
    marker = 5
    prev = 0
    for pos, kind in zip(positions, kinds):
        out.append(seq[prev:pos])
        m = marker
        if kind == 0:    # SNP
            ref = [int(seq[pos])]
            alts = [[int(seq[pos]) % 4 + 1]]
            marker += 2
        elif kind == 1:  # deletion (direct-deletion allele)
            dl = int(rng.randint(1, 6))
            ref = [int(b) for b in seq[pos : pos + dl]]
            alts = [[]]
            marker += 2
        elif kind == 2:  # insertion
            ref = [int(seq[pos])]
            ins = [int(b) for b in rng.randint(1, 5, size=rng.randint(1, 9))]
            alts = [[int(seq[pos])] + ins]
            marker += 2
        elif kind == 3:  # multi-allelic SNP
            b = int(seq[pos])
            ref = [b]
            alts = [[(b + j) % 4 + 1] for j in range(3)]
            marker += 2
        else:            # nested: alt carries an inner biallelic SNP
            b = int(seq[pos])
            mi = m + 2
            inner_ref = b % 4 + 1
            inner_alt = (b + 1) % 4 + 1
            ref = [b, b % 4 + 1]
            alts = [[b, mi, inner_ref, mi + 1, inner_alt, mi + 1,
                     (b + 2) % 4 + 1]]
            marker += 4
        site = [m] + ref
        for a in alts:
            site += [m + 1] + a
        site += [m + 1]
        out.append(np.asarray(site, dtype=np.uint32))
        prev = pos + max(len(ref) if kind == 1 else 1, 1)
    out.append(seq[prev:])
    return np.concatenate(out)


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
    """Reference-allele sequence of a linear PRG: the DNA outside sites
    plus the first allele of every site, nested sites within a first
    allele taken by their first allele too."""
    ints = np.asarray(prg_ints, dtype=np.int64)
    mpos = np.flatnonzero(ints > 4)
    vals = ints[mpos]
    # the last position of each even marker: the end of its site
    last = dict(zip(vals.tolist(), mpos.tolist()))
    parts = []
    prev = 0
    j = 0
    while j < mpos.size:
        p = int(mpos[j])
        parts.append(ints[prev:p])
        if vals[j] % 2:
            prev = p + 1                   # into the site's first allele
        else:                              # its first allele ends here
            prev = last[int(vals[j])] + 1
            j = int(np.searchsorted(mpos, prev)) - 1
        j += 1
    parts.append(ints[prev:])
    return "".join(np.array(list("NACGT"))[np.concatenate(parts)])


def site_table(prg_ints) -> dict:
    """Each site of a linear PRG by its index ((odd marker - 5) / 2, the
    index of the coverage files): ``alleles`` its number of alleles,
    ``depth`` its nesting depth (1 for a site outside every other), and
    ``empty`` the (site, allele) pairs of its direct-deletion alleles,
    the alleles with no base and no nested site."""
    ints = np.asarray(prg_ints, dtype=np.int64)
    mpos = np.flatnonzero(ints > 4)
    vals = ints[mpos]
    last = dict(zip(vals.tolist(), mpos.tolist()))
    n_sites = int((vals.max() - 3) // 2) if vals.size else 0
    alleles = np.zeros(n_sites, dtype=np.int64)
    depth = np.zeros(n_sites, dtype=np.int64)
    empty = []
    stack = []                               # (site index, allele start)
    for p, v in zip(mpos.tolist(), vals.tolist()):
        if v % 2:
            s = (v - 5) // 2
            depth[s] = len(stack) + 1
            alleles[s] = 1
            stack.append([s, p + 1])
            continue
        s, start = stack[-1]
        if s != (v - 6) // 2:
            raise ValueError(f"marker {v} at {p} closes no open site")
        if p == start:
            empty.append((s, int(alleles[s]) - 1))
        if p == last[v]:
            stack.pop()
        else:
            alleles[s] += 1
            stack[-1][1] = p + 1
    if stack:
        raise ValueError("a site is left open")
    return {"alleles": alleles, "depth": depth, "empty": empty}


def graph_shape(prg_ints) -> dict:
    """What kinds of site a graph holds: its sites, its deepest nesting,
    its sites with 3 or more alleles and its direct-deletion alleles."""
    t = site_table(prg_ints)
    return {"sites": int(t["alleles"].size),
            "max_depth": int(t["depth"].max(initial=0)),
            "nested_sites": int((t["depth"] >= 2).sum()),
            "multi_allelic_sites": int((t["alleles"] >= 3).sum()),
            "deletion_alleles": len(t["empty"])}


def _write_reference(path: Path, name: str, seq: str):
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(seq), 60):
            fh.write(seq[i:i + 60] + "\n")


def _build(args) -> float:
    """``build`` of this package with ``args``; its seconds."""
    from ..cli import run as cli

    t0 = time.perf_counter()
    if cli(["build"] + args + ["--force"]) != 0:
        raise RuntimeError("build failed")
    return time.perf_counter() - t0


def make_workload(work: Path, genome_len: int = 4_400_000,
                  num_sites: int = 100_000, n_reads: int = 40_000,
                  read_len: int = 150, kmer_size: int = 10, seed: int = 42,
                  load: bool = True, profile: str = "snp"):
    """Writes ``prg.bin``, ``ref.fa``, ``reads.fq`` and the built index
    ``gram/`` into ``work``, the graph of ``profile``: "snp"
    (``build_synthetic_mtb_graph``) or "mixed" (``build_mixed_graph``).
    Returns (idx, kmer_index, reads, a one-line summary); ``load=False``
    leaves the index on disk (idx and kmer_index None), for a caller
    that only writes the workload."""
    from ..index.build import load_all
    from ..prg.linearise import PrgString

    graphs = {"snp": build_synthetic_mtb_graph, "mixed": build_mixed_graph}
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    prg_ints = graphs[profile](rng, genome_len, num_sites)
    prg = PrgString(prg_ints)
    prg.write(work / "prg.bin")
    _write_reference(work / "ref.fa", "ref", reference_sequence(prg_ints))
    paths = sample_haplotypes(prg_ints, dict(prg.end_positions), rng,
                              n_paths=8)
    reads = sample_reads(rng, paths, n_reads, read_len)
    write_fastq(work / "reads.fq", reads)
    gen_s = time.perf_counter() - t0

    build_s = _build(["--gram_dir", str(work / "gram"),
                      "--prg", str(work / "prg.bin"),
                      "--ref", str(work / "ref.fa"),
                      "--kmer_size", str(kmer_size)])
    idx, kmer_index = load_all(work / "gram") if load else (None, None)
    shape = (f" ({json.dumps(graph_shape(prg_ints))})"
             if profile != "snp" else "")
    summary = (f"{genome_len} bp genome, {num_sites} sites{shape}, "
               + (f"fm size {idx.fm.size}, " if load else "")
               + f"{n_reads} reads of {read_len} bp; generated in "
               f"{gen_s:.1f} s, index built (k={kmer_size}) in "
               f"{build_s:.1f} s")
    return idx, kmer_index, reads, summary


def _diverge(rng, grid, rows, inserts, cols, snp: float, indel: float):
    """One branch of the MSA tree, shared by ``rows``, over the root's
    columns ``cols``: SNPs at rate ``snp``, and indel events at rate
    ``indel``, half of them deletions of 1-6 columns (gaps in ``rows``),
    half insertions of 1-6 bases (columns of their own after a root
    column, gaps in every other row)."""
    L = grid.shape[1]
    pos = cols[rng.rand(cols.size) < snp]
    shift = rng.randint(1, 4, size=pos.size)
    sub = grid[np.ix_(rows, pos)]
    grid[np.ix_(rows, pos)] = np.where(sub > 0, (sub - 1 + shift) % 4 + 1, 0)
    for p in cols[rng.rand(cols.size) < indel]:
        p, n = int(min(max(p, 8), L - 15)), int(rng.randint(1, 7))
        if rng.rand() < 0.5:
            grid[np.ix_(rows, np.arange(p, p + n))] = 0
        else:
            inserts.setdefault(p, []).append(
                (rows, rng.randint(1, 5, size=n).astype(np.int8)))


MSA_ROWS, MSA_CLADES, REGION_LEN = 24, 4, (1_000, 4_000)
SPREADS = {
    # the clades diverge in hypervariable windows of 20-40 columns, one
    # about every 150 (~4% of a region's columns), and the members
    # barely: the graph chip_smoke.py genotypes
    "windows": {"window_every": 150, "clade": (0.15, 0.01),
                "member": (0.001, 0.0002)},
    # every column diverges, the clades as much as the windows do on
    # average: nested sites whose alleles can combine thousands of ways,
    # on which the diploid model's allele pairs do not finish in minutes
    # (PERF.md section 7; common/measure_msa_spread.py)
    "even": {"window_every": None, "clade": (0.04, 0.005),
             "member": (0.01, 0.005)},
}
"""The MSA tree's divergence: (SNP, indel) rates a column for the
clades and for the members. Not taken from a published alignment
(PERF.md section 4)."""


def msa_rows(rng, root, spread: str = "windows"):
    """An MSA of MSA_ROWS rows (an int8 matrix, 0 a gap, 1-4 a base)
    whose first row is ``root`` (base codes 1-4) with gaps only where
    another row inserts: a two-level tree. MSA_CLADES clades diverge from
    the root, each over the columns of ``spread`` (SPREADS); every other
    row is a member of clade (row - 1) % MSA_CLADES and diverges from it
    over the whole region."""
    s = SPREADS[spread]
    L = len(root)
    grid = np.tile(np.asarray(root, dtype=np.int8), (MSA_ROWS, 1))
    inserts = {}
    all_cols = np.arange(8, L - 8)
    if s["window_every"] is None:
        clade_cols = all_cols
    else:
        hot = np.zeros(L, dtype=bool)
        for start in np.flatnonzero(rng.rand(L - 56) < 1 / s["window_every"]):
            hot[8 + start:8 + start + rng.randint(20, 41)] = 1
        clade_cols = np.flatnonzero(hot)
    members = np.arange(1, MSA_ROWS)
    for c in range(MSA_CLADES):
        _diverge(rng, grid, members[(members - 1) % MSA_CLADES == c],
                 inserts, clade_cols, *s["clade"])
    for r in members:
        _diverge(rng, grid, np.array([r]), inserts, all_cols, *s["member"])
    cols, prev = [], 0
    for p in sorted(inserts):
        cols.append(grid[:, prev:p + 1])
        for rows, seq in inserts[p]:
            block = np.zeros((MSA_ROWS, seq.size), dtype=np.int8)
            block[rows] = seq
            cols.append(block)
        prev = p + 1
    cols.append(grid[:, prev:])
    return np.concatenate(cols, axis=1)


def _threads_reference(msa, lut) -> bool:
    """Whether the PRG that ``build --prgs_bed`` makes of ``msa`` starts
    with its first row: the build requires the reference to be the
    graph's first path, and prg/msa.py's clusters, taken in label order,
    do not always put the first row in the first."""
    from ..prg.linearise import prg_string_to_ints
    from ..prg.msa import msa_to_prg_string

    rows = [lut[row].tobytes().decode() for row in msa]
    return reference_sequence(prg_string_to_ints(msa_to_prg_string(
        rows))) == rows[0].replace("-", "")


def make_msa_workload(work: Path, ref_len: int = 2_000_000,
                      n_regions: int = 40, n_reads: int = 20_000,
                      kmer_size: int = 10, seed: int = 42,
                      load: bool = True, spread: str = "windows"):
    """The input of ``build --prgs_bed`` and its build: ``ref.fa`` (one
    sequence of ``ref_len`` random bases), ``regions.bed`` (``n_regions``
    regions of REGION_LEN bp, one in each equal stretch of the
    reference) and ``msa/region_<i>.msa`` (``msa_rows``' alignment under
    ``spread``, the first row the reference's own region; a region whose
    PRG would not start with that row is drawn again), built into
    ``gram/``; then ``reads.fq``, ``n_reads`` reads of 150 bp sampled
    from 8 haplotypes through the built PRG. The built graph must hold a site
    at nesting depth 2 or more, a site with 3 or more alleles and a
    direct-deletion allele, or this raises. Returns what
    ``make_workload`` returns."""
    from ..index.build import load_all
    from ..prg.linearise import PrgString

    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    ref = rng.randint(1, 5, size=ref_len).astype(np.int8)
    lut = np.frombuffer(b"-ACGT", dtype="S1")
    _write_reference(work / "ref.fa", "ref", lut[ref].tobytes().decode())
    (work / "msa").mkdir(exist_ok=True)
    stretch = ref_len // n_regions
    with open(work / "regions.bed", "w") as bed:
        for i in range(n_regions):
            n = int(rng.randint(REGION_LEN[0], REGION_LEN[1] + 1))
            start = i * stretch + int(rng.randint(1, stretch - n))
            msa = msa_rows(rng, ref[start:start + n], spread)
            while not _threads_reference(msa, lut):
                msa = msa_rows(rng, ref[start:start + n], spread)
            path = work / "msa" / f"region_{i:02d}.msa"
            with open(path, "w") as fh:
                for r, row in enumerate(msa):
                    fh.write(f">s{r}\n{lut[row].tobytes().decode()}\n")
            bed.write(f"ref\t{start}\t{start + n}\t{path}\n")
    gen_s = time.perf_counter() - t0

    build_s = _build(["--gram_dir", str(work / "gram"),
                      "--prgs_bed", str(work / "regions.bed"),
                      "--ref", str(work / "ref.fa"),
                      "--kmer_size", str(kmer_size)])
    t0 = time.perf_counter()
    prg = PrgString.from_file(work / "gram" / "prg")
    prg_ints = np.asarray(prg.ints)
    shape = graph_shape(prg_ints)
    if (shape["max_depth"] < 2 or not shape["multi_allelic_sites"]
            or not shape["deletion_alleles"]):
        raise AssertionError(f"the MSA graph lacks a kind of site: {shape}")
    paths = sample_haplotypes(prg_ints, dict(prg.end_positions), rng,
                              n_paths=8)
    reads = sample_reads(rng, paths, n_reads, 150)
    write_fastq(work / "reads.fq", reads)
    gen_s += time.perf_counter() - t0
    idx, kmer_index = load_all(work / "gram") if load else (None, None)
    summary = (f"{ref_len} bp reference, {n_regions} MSA regions of "
               f"{REGION_LEN[0]}-{REGION_LEN[1]} bp and {MSA_ROWS} rows "
               f"({spread} spread), "
               f"built by build --prgs_bed ({json.dumps(shape)}), "
               + (f"fm size {idx.fm.size}, " if load else "")
               + f"{n_reads} reads of 150 bp; generated in "
               f"{gen_s:.1f} s, built (k={kmer_size}) in {build_s:.1f} s")
    return idx, kmer_index, reads, summary
