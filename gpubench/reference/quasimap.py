"""Quasimap of one reads file by the plain reference.

Each read is searched forward and reverse-complemented (quasimap.cpp:
both orientations count in the stats); an orientation with a kmer off
every path is ``missing_kmer``, one whose search dies is
``no_extension``, and a mapped one records coverage for the mapping
instance that its selection seed draws. Read i's seed is the i-th raw
draw of mt19937(seed), drawn in blocks of the buffer size as quasimap's
driver draws them. A read's seed states are its last kmer's, from
``kmer_states``. The reads are split over worker processes, each with
its own copy of the coverage graph; their counts add up.
"""
from __future__ import annotations

import multiprocessing as mp
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .coverage import Coverage, record_search_states
from .fm import FMIndex
from .graph import build_cov_graph
from .linearise import PrgString
from .rng import RandomInclusiveInt, first_raw_draws
from .kmer_states import build_kmer_states, states_at
from .search import PrgIndex, search_read_backwards
from .seqs import read_fastq, revcomp_rows

STATS = ("all_reads_count", "skipped_reads_count", "missing_kmer_reads_count",
         "no_extension_reads_count", "exact_mapped_reads_count")
_FM_ARRAYS = ("sa", "bwt", "occ", "sym_start", "sym_end", "marker_prefix",
              "marker_sa_pos")
_KMER_ARRAYS = ("codes", "offsets", "lo", "hi", "trav", "n_trav", "ing",
                "n_ing")


def build_index(prg_path: Path, kmer_size: int, out: Path):
    """Writes the reference's FM arrays and kmer states under ``out``."""
    prg = PrgString.from_file(prg_path)
    out.mkdir(parents=True, exist_ok=True)
    fm = FMIndex.build(prg.ints)
    for name in _FM_ARRAYS:
        np.save(out / f"{name}.npy", getattr(fm, name))
    idx = PrgIndex(prg.ints, build_cov_graph(prg), fm, dict(prg.end_positions))
    for name, a in build_kmer_states(idx, kmer_size).items():
        np.save(out / f"kmer_{name}.npy", a)


def _load(path: Path) -> np.ndarray:
    # a read-only view of the mapped file: the workers share its pages
    return np.load(path, mmap_mode="r").view(np.ndarray)


def load_index(prg_path: Path, index_dir: Path, kmer_size: int
               ) -> "tuple[PrgIndex, np.ndarray, dict]":
    """The index, a table over the 4**k kmer codes (True for a kmer on
    some path of the graph) and the kmer states."""
    prg = PrgString.from_file(prg_path)
    fm = FMIndex(*(_load(index_dir / f"{name}.npy") for name in _FM_ARRAYS))
    idx = PrgIndex(prg.ints, build_cov_graph(prg), fm, dict(prg.end_positions))
    states = {name: _load(index_dir / f"kmer_{name}.npy")
              for name in _KMER_ARRAYS}
    table = np.zeros(4 ** kmer_size, dtype=bool)
    table[states["codes"]] = True
    return idx, table, states


def read_kmer_codes(reads: np.ndarray, k: int) -> np.ndarray:
    """(n, L - k + 1) codes of each read's kmers (reads of codes 1-4)."""
    win = np.lib.stride_tricks.sliding_window_view(
        reads.astype(np.int64) - 1, k, axis=1)
    return win @ (4 ** np.arange(k - 1, -1, -1, dtype=np.int64))


@dataclass
class Result:
    """What a reads file maps to: quasimap's stats, allele-sum coverage,
    grouped allele counts, and per-base coverage by PRG position (0
    off every allele)."""

    stats: dict
    allele_sum: list
    grouped: list
    per_base: np.ndarray


def selection_seeds(seed: int, n_reads: int, buffer_size: int) -> list:
    rng = RandomInclusiveInt(seed)
    seeds = []
    while len(seeds) < n_reads:
        seeds.extend(rng.raw_block(buffer_size))
    return seeds[:n_reads]


def _seed_lookup(states: dict, last_kmers: np.ndarray, k: int) -> dict:
    """Each distinct last kmer (its bytes) -> its search states."""
    out = {}
    codes = states["codes"].astype(np.int64)
    weights = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    for row in np.unique(last_kmers, axis=0):
        code = int((row.astype(np.int64) - 1) @ weights)
        pos = int(np.searchsorted(codes, code))
        if pos < codes.size and codes[pos] == code:
            out[row.tobytes()] = states_at(states, pos)
    return out


def _map_rows(idx, table, states, k, reads, seeds):
    stats = dict.fromkeys(STATS, 0)
    coverage = Coverage.empty(idx)
    first = first_raw_draws(np.asarray(seeds, dtype=np.uint32))
    orients = (reads, revcomp_rows(reads))
    screened = []
    for orient in orients:
        if orient.shape[1] >= k:
            screened.append(table[read_kmer_codes(orient, k)].all(axis=1))
        else:
            screened.append(np.zeros(orient.shape[0], dtype=bool))
    seeds_of = _seed_lookup(states, np.concatenate(
        [o[ok, o.shape[1] - k:] for o, ok in zip(orients, screened)]), k)
    for orient, ok in zip(orients, screened):
        for i in range(orient.shape[0]):
            stats["all_reads_count"] += 1
            read = orient[i]
            if not ok[i]:
                stats["missing_kmer_reads_count"] += 1
                continue
            seed = seeds_of.get(read[read.size - k:].tobytes())
            states = (search_read_backwards(read, seed, k, idx)
                      if seed else [])
            if not states:
                stats["no_extension_reads_count"] += 1
                continue
            record_search_states(coverage, states, int(read.size), idx,
                                 seeds[i], int(first[i]))
            stats["exact_mapped_reads_count"] += 1
    return Result(stats, coverage.allele_sum, coverage.grouped_counts,
                  per_base_by_position(idx.graph, idx.prg))


def per_base_by_position(graph, ints) -> np.ndarray:
    """A coverage graph's per-base counts laid out by PRG position: the
    count of the allele base at each position, 0 elsewhere."""
    ints = np.asarray(ints)
    cov_start = np.array([nd.cov_start for nd in graph.nodes], dtype=np.int64)
    out = np.zeros(ints.size, dtype=np.uint16)
    pos = np.flatnonzero(ints <= 4)
    node = np.asarray(graph.ra_node)[pos]
    pos, node = pos[node >= 0], node[node >= 0]
    start = cov_start[node]
    pos, start = pos[start >= 0], start[start >= 0]
    out[pos] = graph.coverage[start + np.asarray(graph.ra_offset)[pos]]
    return out


_WORKER = {}


def _init_worker(prg_path, index_dir, kmer_size):
    idx, table, states = load_index(Path(prg_path), Path(index_dir),
                                    kmer_size)
    _WORKER.update(idx=idx, table=table, states=states, k=kmer_size)


def _map_chunk(args):
    reads, seeds = args
    w = _WORKER
    w["idx"].graph.coverage[:] = 0
    return _map_rows(w["idx"], w["table"], w["states"], w["k"], reads, seeds)


def merge(parts: list) -> Result:
    stats = {key: sum(p.stats[key] for p in parts) for key in STATS}
    allele_sum = [list(map(sum, zip(*site))) for site in
                  zip(*(p.allele_sum for p in parts))]
    grouped = []
    for sites in zip(*(p.grouped for p in parts)):
        merged = {}
        for d in sites:
            for key, val in d.items():
                merged[key] = merged.get(key, 0) + val
        grouped.append(merged)
    per_base = np.minimum(sum(p.per_base.astype(np.int64) for p in parts),
                          np.iinfo(np.uint16).max).astype(np.uint16)
    return Result(stats, allele_sum, grouped, per_base)


def map_file(reads_path: Path, prg_path: Path, index_dir: Path,
             kmer_size: int, seed: int, buffer_size: int,
             workers: int) -> Result:
    """The reference's result for a reads file."""
    reads = read_fastq(reads_path)
    seeds = selection_seeds(seed, reads.shape[0], buffer_size)
    bounds = np.linspace(0, reads.shape[0], workers + 1).astype(int)
    chunks = [(reads[a:b], seeds[a:b]) for a, b in zip(bounds, bounds[1:])
              if b > a]
    ctx = mp.get_context("spawn")
    with ctx.Pool(len(chunks), initializer=_init_worker,
                  initargs=(str(prg_path), str(index_dir), kmer_size)) as pool:
        parts = pool.map(_map_chunk, chunks)
        pool.close()
        pool.join()
    return merge(parts)
