"""Index build driver: PRG ints -> PrgIndex (+ on-disk artifacts).

Parity: libgramtools src/build/build.cpp:8-72 (cov graph -> FM-index ->
masks -> kmer index), re-shaped: masks are implicit in the dense occ /
marker-rank tables of FMIndex.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..mapping.search import PrgIndex
from ..prg.graph import build_cov_graph
from ..prg.linearise import PrgString
from .fm import FMIndex
from .kmer_index_vec import ArrayKmerIndex, build_kmer_index_vectorised


def build_prg_index(prg: PrgString, graph=None) -> PrgIndex:
    graph = build_cov_graph(prg) if graph is None else graph
    fm = FMIndex.build(prg.ints)
    return PrgIndex(prg.ints, graph, fm, dict(prg.end_positions))


def build_all(prg: PrgString, kmer_size: int, gram_dir: str | Path,
              graph=None):
    """Build and persist the full index artifact set (the stage checkpoint
    contract: build artifacts are what genotype consumes); ``graph`` is
    the PRG's coverage graph where the caller has built it already."""
    gram_dir = Path(gram_dir)
    gram_dir.mkdir(parents=True, exist_ok=True)
    prg.write(gram_dir / "prg")
    idx = build_prg_index(prg, graph)
    idx.fm.save(gram_dir / "fm_index.npz")
    kmer_index = build_kmer_index_vectorised(idx, kmer_size)
    kmer_index.save(gram_dir / "kmer_index.npz")
    return idx, kmer_index


def load_all(gram_dir: str | Path):
    gram_dir = Path(gram_dir)
    prg = PrgString.from_file(gram_dir / "prg")
    graph = build_cov_graph(prg)  # deterministic, fast: rebuilt on load
    fm = FMIndex.load(gram_dir / "fm_index.npz")
    idx = PrgIndex(prg.ints, graph, fm, dict(prg.end_positions))
    kmer_index = ArrayKmerIndex.load(gram_dir / "kmer_index.npz")
    return idx, kmer_index
