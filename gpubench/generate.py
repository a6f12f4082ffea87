"""Traffic and graph generators of the benchmark, frozen.

The graph profiles follow the repository's ``bench.py`` profiles
(``snp``: a linear graph of evenly spread biallelic SNPs; ``mixed``: 70%
SNPs, 10% deletions, 10% insertions, 5% four-allele SNPs and 5% nested
sites), drawn from a configuration's ``graph_seed``, with every base
(genome and inserted alleles) drawn independently at the configuration's
GC share: the genome's composition, and no repeats. Haplotype paths are
walked through the graph with the allele taken at every site kept as the
truth; reads are drawn from one path, vectorised, from a run's seed.
Base codes are 1-4 for A, C, G, T, markers are 5 and up.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def draw_bases(rng, n: int, gc_share: float) -> np.ndarray:
    """``n`` base codes, each drawn independently: C and G each at
    ``gc_share / 2``, A and T each at ``(1 - gc_share) / 2``."""
    at, gc = (1 - gc_share) / 2, gc_share / 2
    return rng.choice(4, size=n, p=[at, gc, gc, at]).astype(np.uint32) + 1


def build_snp_graph(rng, genome_len: int, num_sites: int,
                    gc_share: float) -> np.ndarray:
    """Linear PRG: a random genome with evenly spread biallelic SNPs."""
    seq = draw_bases(rng, genome_len, gc_share)
    positions = np.sort(rng.choice(np.arange(1, genome_len - 1),
                                   size=num_sites, replace=False))
    out = np.empty(genome_len + 4 * num_sites, dtype=np.uint32)
    cursor = 0
    prev = 0
    for i, pos in enumerate(positions):
        site = 5 + 2 * i
        chunk = seq[prev:pos]
        out[cursor:cursor + chunk.size] = chunk
        cursor += chunk.size
        ref_base = seq[pos]
        alt_base = ref_base % 4 + 1
        out[cursor:cursor + 5] = [site, ref_base, site + 1, alt_base,
                                  site + 1]
        cursor += 5
        prev = pos + 1
    chunk = seq[prev:]
    out[cursor:cursor + chunk.size] = chunk
    cursor += chunk.size
    return out[:cursor]


def build_mixed_graph(rng, genome_len: int, num_sites: int,
                      gc_share: float) -> np.ndarray:
    """Linear PRG with SNPs, deletions, insertions, four-allele SNPs and
    sites nested two deep, variant anchors at least 12 bp apart."""
    seq = draw_bases(rng, genome_len, gc_share)
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
        elif kind == 1:  # deletion (an empty allele)
            dl = int(rng.randint(1, 6))
            ref = [int(b) for b in seq[pos:pos + dl]]
            alts = [[]]
            marker += 2
        elif kind == 2:  # insertion
            ref = [int(seq[pos])]
            ins = [int(b) for b in draw_bases(rng, rng.randint(1, 9),
                                              gc_share)]
            alts = [[int(seq[pos])] + ins]
            marker += 2
        elif kind == 3:  # four-allele SNP
            b = int(seq[pos])
            ref = [b]
            alts = [[(b + j) % 4 + 1] for j in range(3)]
            marker += 2
        else:            # nested: the alt allele carries a biallelic SNP
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


PROFILES = {"snp": build_snp_graph, "mixed": build_mixed_graph}


def make_graph(profile: str, genome_len: int, num_sites: int,
               graph_seed: int, gc_share: float
               ) -> "tuple[np.ndarray, np.random.RandomState]":
    """The PRG ints of ``profile``, and the generator after drawing it,
    from which the haplotype paths are drawn next."""
    rng = np.random.RandomState(graph_seed)
    return PROFILES[profile](rng, genome_len, num_sites, gc_share), rng


def site_spans(ints: np.ndarray) -> "tuple[dict, dict]":
    """Each site's odd marker -> its alleles' [start, end) spans, and
    each even marker -> the position of its last occurrence (the site's
    end)."""
    mpos = np.flatnonzero(ints > 4)
    vals = ints[mpos]
    end = dict(zip(vals.tolist(), mpos.tolist()))
    spans = {}
    open_sites = []
    for p, v in zip(mpos.tolist(), vals.tolist()):
        if v % 2:
            open_sites.append(v)
            spans[v] = [[p + 1, None]]
            continue
        m = v - 1
        if m != open_sites[-1]:
            continue            # a nested site's marker inside an allele
        spans[m][-1][1] = p
        if p == end[v]:
            open_sites.pop()
        else:
            spans[m].append([p + 1, None])
    return spans, end


def sample_haplotypes(ints: np.ndarray, rng, n_paths: int
                      ) -> "tuple[list, np.ndarray, np.ndarray]":
    """``n_paths`` haplotype sequences walked through the PRG, a random
    allele at every site on the path (nested sites inside a taken allele
    included); the truth, (n_paths, sites) allele indexes, -1 where a
    site is off the path; and each site's [start, end) in each path,
    (n_paths, sites, 2), -1 off the path."""
    ints = np.asarray(ints, dtype=np.int64)
    spans, end = site_spans(ints)
    n_sites = len(spans)
    mpos = np.flatnonzero(ints > 4)
    paths = []
    truth = np.full((n_paths, n_sites), -1, dtype=np.int64)
    where = np.full((n_paths, n_sites, 2), -1, dtype=np.int64)
    for h in range(n_paths):
        parts = []
        length = 0
        # frames of [position, end of the span walked, site or -1]
        stack = [[0, ints.size, -1]]
        while stack:
            frame = stack[-1]
            lo, hi, site = frame
            j = int(np.searchsorted(mpos, lo))
            nxt = int(mpos[j]) if j < mpos.size else ints.size
            if lo >= hi or nxt >= hi:
                parts.append(ints[lo:hi])
                length += max(hi - lo, 0)
                stack.pop()
                if site >= 0:
                    where[h, site, 1] = length
                continue
            parts.append(ints[lo:nxt])
            length += nxt - lo
            m = int(ints[nxt])
            sp = spans[m]
            a = rng.randint(len(sp))
            s = (m - 5) // 2
            truth[h, s] = a
            where[h, s, 0] = length
            frame[0] = end[m + 1] + 1
            stack.append(list(sp[a]) + [s])
        paths.append(np.concatenate(parts).astype(np.uint8))
    return paths, truth, where


def sample_reads(rng: np.random.Generator, path: np.ndarray, n_reads: int,
                 read_len: int, revcomp_share: float, error_rate: float
                 ) -> np.ndarray:
    """(n_reads, read_len) uint8 reads drawn uniformly from ``path``: a
    share reverse-complemented, then substitutions at ``error_rate`` a
    base, uniform along the read, each to one of the three other
    bases."""
    starts = rng.integers(0, path.size - read_len + 1, size=n_reads)
    reads = path[starts[:, None] + np.arange(read_len)]
    flip = rng.random(n_reads) < revcomp_share
    reads[flip] = (5 - reads[flip])[:, ::-1]
    if error_rate > 0:
        hit = rng.random(reads.shape) < error_rate
        shift = rng.integers(1, 4, size=int(hit.sum()), dtype=np.uint8)
        reads[hit] = (reads[hit] - 1 + shift) % 4 + 1
    return reads


def write_fastq(path: Path, reads: np.ndarray):
    """FASTQ of ``reads`` (codes 1-4), quality 'I' throughout."""
    n, length = reads.shape
    lut = np.frombuffer(b"NACGT", dtype=np.uint8)
    seq = lut[reads]
    nl = np.full((n, 1), ord("\n"), dtype=np.uint8)
    body = np.concatenate([seq, nl, np.frombuffer(b"+\n", np.uint8)[None]
                           .repeat(n, 0),
                           np.full((n, length), ord("I"), np.uint8), nl],
                          axis=1)
    with open(path, "wb") as fh:
        for i in range(n):
            fh.write(b"@r%d\n" % i)
            fh.write(body[i].tobytes())


def reference_sequence(ints: np.ndarray) -> str:
    """The PRG's reference path: every site's first allele."""
    ints = np.asarray(ints, dtype=np.int64)
    spans, end = site_spans(ints)
    mpos = np.flatnonzero(ints > 4)
    parts = []
    stack = [[0, ints.size]]
    while stack:
        frame = stack[-1]
        lo, hi = frame
        if lo >= hi:
            stack.pop()
            continue
        j = int(np.searchsorted(mpos, lo))
        nxt = int(mpos[j]) if j < mpos.size else ints.size
        if nxt >= hi:
            parts.append(ints[lo:hi])
            stack.pop()
            continue
        parts.append(ints[lo:nxt])
        m = int(ints[nxt])
        frame[0] = end[m + 1] + 1
        stack.append(list(spans[m][0]))
    return np.frombuffer(b"NACGT", np.uint8)[np.concatenate(parts)] \
        .tobytes().decode()


def level1_sites(ints: np.ndarray) -> np.ndarray:
    """The indexes ((marker - 5) / 2) of the sites outside every other
    site, in PRG order."""
    ints = np.asarray(ints, dtype=np.int64)
    mpos = np.flatnonzero(ints > 4)
    vals = ints[mpos]
    end = dict(zip(vals.tolist(), mpos.tolist()))
    out = []
    depth = 0
    for p, v in zip(mpos.tolist(), vals.tolist()):
        if v % 2:
            if depth == 0:
                out.append((v - 5) // 2)
            depth += 1
        elif p == end[v]:
            depth -= 1
    return np.asarray(out, dtype=np.int64)
