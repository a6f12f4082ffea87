"""Variant-aware (vBWT) backward search -- host reference implementation.

Semantics ported from libgramtools:
  * BWT backward search        src/genotype/quasimap/search/BWT_search.cpp
  * vBWT marker jumps          src/genotype/quasimap/search/vBWT_jump.cpp
  * encapsulated-state split   src/genotype/quasimap/search/encapsulated_search.cpp

This scalar engine is the correctness oracle for the batched JAX engine
(search_jax.py) and runs the build-time kmer indexing. States are
lightweight tuples; paths are immutable tuples so states can be shared.

A `SearchState` is (sa_lo, sa_hi, traversed, traversing):
  traversed  -- tuple of (site_ID, allele_ID) loci entered AND exited
  traversing -- tuple of (site_ID, ALLELE_UNKNOWN) loci entered, not exited
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .fm import FMIndex
from .graph import CoverageGraph
from .markers import ALLELE_UNKNOWN, is_site_marker

Locus = Tuple[int, int]


@dataclass(frozen=True)
class SearchState:
    lo: int
    hi: int
    traversed: Tuple[Locus, ...] = ()
    traversing: Tuple[Locus, ...] = ()

    def has_path(self) -> bool:
        return bool(self.traversed or self.traversing)


class PrgIndex:
    """FM-index + graph metadata bundle (parity: PRG_Info, prg_info.hpp:22-59)."""

    def __init__(self, prg_ints: np.ndarray, graph: CoverageGraph, fm: FMIndex,
                 last_allele_positions: Dict[int, int]):
        self.prg = prg_ints
        self.graph = graph
        self.fm = fm
        self.last_allele_positions = last_allele_positions
        self.num_sites = graph.num_sites


# --- base extension (BWT_search.cpp:28-94) ----------------------------------


def search_base_backwards(base: int, states: List[SearchState], idx: PrgIndex
                          ) -> List[SearchState]:
    fm = idx.fm
    out: List[SearchState] = []
    for s in states:
        lo, hi = fm.base_next_sa_interval(base, s.lo, s.hi)
        if lo <= hi:
            out.append(SearchState(lo, hi, s.traversed, s.traversing))
    return out


# --- marker jumps (vBWT_jump.cpp) -------------------------------------------


def left_markers_search(state: SearchState, idx: PrgIndex) -> List[Locus]:
    """Targets of all markers in the state's SA interval (vBWT_jump.cpp:94-117).

    Uses the marker-rank tables for an O(1) count + gather instead of the
    reference's per-position scan.
    """
    hits = idx.fm.markers_in_interval(state.lo, state.hi)
    results: List[Locus] = []
    g = idx.graph
    for sa_idx in hits:
        prg_index = int(idx.fm.sa[sa_idx])
        site = int(g.ra_target_site[prg_index])
        allele = int(g.ra_target_allele[prg_index])
        if site % 2 == 0:  # allele (even) marker
            # if not at the site's final marker, it marks a site exit
            if idx.last_allele_positions[site] != prg_index - 1:
                site -= 1
        results.append((site, allele))
    return results


def _update_variant_site_path(traversed, traversing, allele_id, site_id):
    """vBWT_jump.cpp:51-69."""
    if not traversing:
        return traversed + ((site_id, allele_id),), traversing
    last = traversing[-1]
    assert last[0] == site_id and last[1] == ALLELE_UNKNOWN
    return traversed + ((site_id, allele_id),), traversing[:-1]


def exiting_site_search_state(locus: Locus, state: SearchState, idx: PrgIndex
                              ) -> SearchState:
    """vBWT_jump.cpp:76-92: jump to the site-entry marker's SA row."""
    site_marker, allele_id = locus
    traversed, traversing = _update_variant_site_path(
        state.traversed, state.traversing, allele_id, site_marker)
    row = int(idx.fm.sym_start[site_marker])
    return SearchState(row, row, traversed, traversing)


def entering_site_search_state(allele_marker: int, state: SearchState,
                               idx: PrgIndex) -> SearchState:
    """vBWT_jump.cpp:29-44: widen to the whole allele-marker block."""
    lo, hi = idx.fm.symbol_interval(allele_marker)
    traversing = state.traversing + ((allele_marker - 1, ALLELE_UNKNOWN),)
    return SearchState(lo, hi, state.traversed, traversing)


def _extend_targets_site_exit(locus: Locus, state: SearchState, idx: PrgIndex):
    """vBWT_jump.cpp:185-228. Returns (next_locus, state, commit)."""
    site_marker = locus[0]
    commit = True
    new_state = exiting_site_search_state(locus, state, idx)
    next_target: Locus = (0, 0)

    target_map = idx.graph.target_map
    while site_marker in target_map:
        targets = target_map[site_marker]
        assert len(targets) == 1, "site entry points to >1 marker"
        next_site_marker = targets[-1][0]
        if next_site_marker % 2 == 0:  # exit followed by an entry
            next_target = (next_site_marker, 0)
            commit = False
            break
        else:  # double exit
            parent_site = idx.graph.par_map[site_marker]
            assert parent_site[0] == next_site_marker
            new_state = exiting_site_search_state(
                (next_site_marker, parent_site[1]), new_state, idx)
            site_marker = next_site_marker
    return next_target, new_state, commit


def _extend_targets_site_entry(locus: Locus, state: SearchState, idx: PrgIndex):
    """vBWT_jump.cpp:230-265. Returns list of (locus, state, commit)."""
    variant_marker = locus[0]
    new_state = entering_site_search_state(variant_marker, state, idx)
    extensions = [((0, 0), new_state, True)]

    for target_id, dd_allele in idx.graph.target_map.get(variant_marker, ()):
        if is_site_marker(target_id):  # direct deletion
            assert dd_allele != ALLELE_UNKNOWN
            extensions.append(((target_id, dd_allele), new_state, False))
        else:  # double entry
            extensions.append(((target_id, ALLELE_UNKNOWN), new_state, False))
    return extensions


def search_state_vbwt_jumps(state: SearchState, idx: PrgIndex) -> List[SearchState]:
    """Worklist chase of adjacent-marker chains (vBWT_jump.cpp:134-183)."""
    marker_targets = left_markers_search(state, idx)
    if not marker_targets:
        return []

    results: List[SearchState] = []
    to_process = [(t, state) for t in marker_targets]
    while to_process:
        target_locus, cur_state = to_process.pop()
        if is_site_marker(target_locus[0]):
            extensions = [_extend_targets_site_exit(target_locus, cur_state, idx)]
        else:
            extensions = _extend_targets_site_entry(target_locus, cur_state, idx)
        for new_locus, new_state, commit in extensions:
            if commit:
                results.append(new_state)
            if new_locus[0] != 0:
                to_process.append((new_locus, new_state))
    return results


def process_markers_search_states(states: List[SearchState], idx: PrgIndex
                                  ) -> List[SearchState]:
    """vBWT_jump.cpp:119-132: append jump states after the originals."""
    jumped: List[SearchState] = []
    for s in states:
        jumped.extend(search_state_vbwt_jumps(s, idx))
    return states + jumped


# --- encapsulated split (encapsulated_search.cpp) ---------------------------


def handle_allele_encapsulated_state(state: SearchState, idx: PrgIndex
                                     ) -> List[SearchState]:
    assert not state.has_path()
    out: List[SearchState] = []
    cache: Optional[SearchState] = None
    g = idx.graph
    for sa_index in range(state.lo, state.hi + 1):
        prg_index = int(idx.fm.sa[sa_index])
        node = g.node(int(g.ra_node[prg_index]))
        site_marker, allele_id = node.site_id, node.allele_id
        if site_marker == 0:
            if cache is not None:
                out.append(cache)
                cache = None
            out.append(SearchState(sa_index, sa_index))
            continue
        path = ((site_marker, allele_id),)
        if cache is None:
            cache = SearchState(sa_index, sa_index, path)
        elif cache.traversed == path:
            assert cache.hi + 1 == sa_index
            cache = SearchState(cache.lo, sa_index, path)
        else:
            out.append(cache)
            cache = SearchState(sa_index, sa_index, path)
    if cache is not None:
        out.append(cache)
    return out


def handle_allele_encapsulated_states(states: List[SearchState], idx: PrgIndex
                                      ) -> List[SearchState]:
    out: List[SearchState] = []
    for s in states:
        if s.has_path():
            out.append(s)
        else:
            out.extend(handle_allele_encapsulated_state(s, idx))
    return out


# --- read search driver (quasimap.cpp:227-268) ------------------------------


def initial_state(idx: PrgIndex) -> SearchState:
    return SearchState(0, idx.fm.size - 1)


def search_read_backwards(read: np.ndarray, seed_states: List[SearchState],
                          skip: int, idx: PrgIndex) -> List[SearchState]:
    """Extend seed states (covering the last ``skip`` bases) right-to-left."""
    states = seed_states
    for pos in range(len(read) - skip - 1, -1, -1):
        base = int(read[pos])
        if base == 0:
            return []
        states = process_markers_search_states(states, idx)
        states = search_base_backwards(base, states, idx)
        if not states:
            break
    return handle_allele_encapsulated_states(states, idx)


def search_pattern(pattern: np.ndarray, idx: PrgIndex) -> List[SearchState]:
    """Full vBWT search of a pattern from scratch (used for kmer indexing:
    build/kmer_index/build.cpp:35-46 semantics)."""
    base = int(pattern[-1])
    if base == 0:
        return []
    states = search_base_backwards(base, [initial_state(idx)], idx)
    for pos in range(len(pattern) - 2, -1, -1):
        base = int(pattern[pos])
        if base == 0:
            return []
        states = process_markers_search_states(states, idx)
        states = search_base_backwards(base, states, idx)
        if not states:
            break
    return states
