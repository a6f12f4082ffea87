"""Build-time precomputation of vBWT jump outcomes.

The reference chases adjacent-marker chains with a data-dependent
worklist per read per base (vBWT_jump.cpp:134-265). The chains are pure
functions of the *graph*, not of the read: for a given jump-target locus
the set of committed result states -- their SA intervals and the path
operations they apply -- is fixed. We enumerate them once at build time
into dense tables; the device kernel then handles a marker hit with one
table gather plus a bounded masked loop, with no divergent control flow.

Tables (for L distinct jump loci, B = max outcomes/locus, O = max
ops/outcome):
  pos_to_locus[prg_pos]      -> locus index (-1 if position has no target);
                                the reference's last-allele adjustment
                                (vBWT_jump.cpp:108-112) is baked in here.
  out_lo/out_hi[L, B]        -> committed SA interval (or -1 = unused slot)
  out_ops_kind[L, B, O]      -> 0 none | 1 exit | 2 enter
  out_ops_site[L, B, O]      -> site marker of the op
  out_ops_allele[L, B, O]    -> allele (exit ops only)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .markers import ALLELE_UNKNOWN, is_site_marker
from .search import PrgIndex

OP_NONE, OP_EXIT, OP_ENTER = 0, 1, 2


def _chain_outcomes(idx: PrgIndex, locus: Tuple[int, int]):
    """Host symbolic run of search_state_vbwt_jumps for one target locus.
    Returns list of (lo, hi, ops) with ops = [(kind, site, allele), ...]."""
    fm = idx.fm
    g = idx.graph
    outcomes = []
    # worklist entries: (locus, interval or None, ops-so-far)
    to_process = [(locus, None, [])]
    while to_process:
        cur_locus, interval, ops = to_process.pop()
        site_or_marker = cur_locus[0]
        if is_site_marker(site_or_marker):
            # --- site exit chain (vBWT_jump.cpp:185-228)
            site_marker, allele = cur_locus
            ops = ops + [(OP_EXIT, site_marker, allele)]
            row = int(fm.sym_start[site_marker])
            interval = (row, row)
            commit = True
            next_target = None
            while site_marker in g.target_map:
                targets = g.target_map[site_marker]
                assert len(targets) == 1
                nxt = targets[-1][0]
                if nxt % 2 == 0:  # exit followed by an entry
                    next_target = (nxt, 0)
                    commit = False
                    break
                parent = g.par_map[site_marker]
                assert parent[0] == nxt
                ops = ops + [(OP_EXIT, nxt, parent[1])]
                row = int(fm.sym_start[nxt])
                interval = (row, row)
                site_marker = nxt
            if commit:
                outcomes.append((interval[0], interval[1], ops))
            if next_target is not None:
                to_process.append((next_target, interval, ops))
        else:
            # --- site entry (vBWT_jump.cpp:230-265)
            marker = site_or_marker
            lo, hi = idx.fm.symbol_interval(marker)
            ops = ops + [(OP_ENTER, marker - 1, ALLELE_UNKNOWN)]
            outcomes.append((lo, hi, ops))
            for target_id, dd_allele in g.target_map.get(marker, ()):
                if is_site_marker(target_id):  # direct deletion
                    to_process.append(((target_id, dd_allele), None, ops))
                else:  # double entry
                    to_process.append(((target_id, ALLELE_UNKNOWN), None, ops))
    return outcomes


@dataclass
class JumpTable:
    pos_to_locus: np.ndarray        # (len_prg,) int32
    out_lo: np.ndarray              # (L, B) int32, -1 unused
    out_hi: np.ndarray              # (L, B) int32
    ops_kind: np.ndarray            # (L, B, O) int8
    ops_site: np.ndarray            # (L, B, O) int32
    ops_allele: np.ndarray          # (L, B, O) int32
    max_outcomes: int
    max_ops: int


def build_jump_table(idx: PrgIndex) -> JumpTable:
    prg = idx.prg
    g = idx.graph
    n = prg.size

    # adjusted locus per PRG position (left_markers_search semantics)
    pos_to_key: Dict[int, Tuple[int, int]] = {}
    follow = np.flatnonzero(np.asarray(g.ra_target_site) != 0)
    for pos, site, allele in zip(
            follow.tolist(), np.asarray(g.ra_target_site)[follow].tolist(),
            np.asarray(g.ra_target_allele)[follow].tolist()):
        if site % 2 == 0 and idx.last_allele_positions[site] != pos - 1:
            site -= 1
        pos_to_key[pos] = (site, allele)

    locus_index: Dict[Tuple[int, int], int] = {}
    all_outcomes: List[list] = []
    for key in pos_to_key.values():
        if key not in locus_index:
            locus_index[key] = len(all_outcomes)
            all_outcomes.append(_chain_outcomes(idx, key))

    L = max(len(all_outcomes), 1)
    B = max((len(o) for o in all_outcomes), default=1)
    B = max(B, 1)
    O = max((len(ops) for outs in all_outcomes for _, _, ops in outs), default=1)
    O = max(O, 1)

    pos_to_locus = np.full(n, -1, dtype=np.int32)
    pos_to_locus[np.fromiter(pos_to_key, np.int64, len(pos_to_key))] = \
        np.fromiter((locus_index[k] for k in pos_to_key.values()), np.int32,
                    len(pos_to_key))

    out_lo = np.full((L, B), -1, dtype=np.int32)
    out_hi = np.full((L, B), -1, dtype=np.int32)
    ops_kind = np.zeros((L, B, O), dtype=np.int8)
    ops_site = np.zeros((L, B, O), dtype=np.int32)
    ops_allele = np.full((L, B, O), ALLELE_UNKNOWN, dtype=np.int32)
    for li, outs in enumerate(all_outcomes):
        for bi, (lo, hi, ops) in enumerate(outs):
            out_lo[li, bi] = lo
            out_hi[li, bi] = hi
            for oi, (kind, site, allele) in enumerate(ops):
                ops_kind[li, bi, oi] = kind
                ops_site[li, bi, oi] = site
                ops_allele[li, bi, oi] = allele

    return JumpTable(pos_to_locus, out_lo, out_hi, ops_kind, ops_site,
                     ops_allele, B, O)
