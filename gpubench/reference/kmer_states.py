"""Every kmer's search states, by a level-synchronous numpy expansion.

Frozen copy of the vectorised kmer-index builder: level d holds all
live search states of all d-base kmer suffixes as flat arrays; a step
fans out marker jumps from the jump table (``jump_table.py``), then
extends every state by each of the four bases. After k levels the
states are grouped by kmer code (base b at weight 4**(k-1-i) for the
i-th base, code b - 1). A kmer's states equal the backward search of
its bases from the whole graph, markers processed before each base but
the first (build/kmer_index/build.cpp), which the tests check against
``search.py`` directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .jump_table import JumpTable, OP_ENTER, OP_EXIT, build_jump_table
from .markers import ALLELE_UNKNOWN
from .search import PrgIndex, SearchState

MAX_PATH = 8


class KmerPathOverflow(Exception):
    pass


@dataclass
class _Level:
    lo: np.ndarray
    hi: np.ndarray
    code: np.ndarray        # uint32 base-4 kmer code of the suffix so far
    trav: np.ndarray        # (N, P, 2) int32
    n_trav: np.ndarray
    ing: np.ndarray         # (N, P, 2) int32
    n_ing: np.ndarray

    @property
    def n(self):
        return self.lo.size

    def select(self, mask_or_idx):
        return _Level(self.lo[mask_or_idx], self.hi[mask_or_idx],
                      self.code[mask_or_idx], self.trav[mask_or_idx],
                      self.n_trav[mask_or_idx], self.ing[mask_or_idx],
                      self.n_ing[mask_or_idx])


def _concat(a: _Level, b: _Level) -> _Level:
    return _Level(*[np.concatenate([x, y]) for x, y in
                    zip(a.__dict__.values(), b.__dict__.values())])


def _jump_expand(level: _Level, idx: PrgIndex, jt: JumpTable) -> _Level:
    """All marker-jump result states of all states in `level`."""
    fm = idx.fm
    mstart = fm.marker_prefix[level.lo]
    mend = fm.marker_prefix[level.hi + 1]
    cnt = (mend - mstart).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return _Level(*[x[:0] for x in level.__dict__.values()])
    parent = np.repeat(np.arange(level.n), cnt)
    start_of = np.repeat(np.cumsum(cnt) - cnt, cnt)
    rank = np.arange(total) - start_of
    hit_idx = np.repeat(mstart.astype(np.int64), cnt) + rank
    prg_pos = fm.sa[fm.marker_sa_pos[hit_idx]]
    loc = jt.pos_to_locus[prg_pos]
    assert (loc >= 0).all(), "marker row without jump locus"

    # expand outcomes: per hit, the valid outcome slots of its locus
    out_valid = jt.out_lo[loc] >= 0                      # (total, B)
    n_out = out_valid.sum(axis=1).astype(np.int64)
    hit_of_out = np.repeat(np.arange(total), n_out)
    b_idx = np.nonzero(out_valid)[1]                     # aligned with hit_of_out
    loc_of_out = loc[hit_of_out]
    parent_of_out = parent[hit_of_out]

    new_lo = jt.out_lo[loc_of_out, b_idx]
    new_hi = jt.out_hi[loc_of_out, b_idx]
    code = level.code[parent_of_out]
    trav = level.trav[parent_of_out].copy()
    n_trav = level.n_trav[parent_of_out].copy()
    ing = level.ing[parent_of_out].copy()
    n_ing = level.n_ing[parent_of_out].copy()

    kinds = jt.ops_kind[loc_of_out, b_idx]               # (M, O)
    sites = jt.ops_site[loc_of_out, b_idx]
    alleles = jt.ops_allele[loc_of_out, b_idx]
    M = new_lo.size
    rows = np.arange(M)
    for o in range(kinds.shape[1]):
        kind = kinds[:, o]
        is_exit = kind == OP_EXIT
        is_enter = kind == OP_ENTER
        if is_exit.any():
            if (n_trav[is_exit] >= MAX_PATH).any():
                raise KmerPathOverflow("traversed path overflow in kmer index")
            has_ing = n_ing > 0
            pop = is_exit & has_ing
            n_ing[pop] -= 1
            r = rows[is_exit]
            trav[r, n_trav[r], 0] = sites[is_exit, o]
            trav[r, n_trav[r], 1] = alleles[is_exit, o]
            n_trav[r] += 1
        if is_enter.any():
            if (n_ing[is_enter] >= MAX_PATH).any():
                raise KmerPathOverflow("traversing path overflow in kmer index")
            r = rows[is_enter]
            ing[r, n_ing[r], 0] = sites[is_enter, o]
            ing[r, n_ing[r], 1] = ALLELE_UNKNOWN
            n_ing[r] += 1
    return _Level(new_lo.astype(np.int32), new_hi.astype(np.int32), code,
                  trav, n_trav, ing, n_ing)


def _base_extend(level: _Level, idx: PrgIndex, depth: int) -> _Level:
    """Extend every state by each of the 4 bases (prepending left)."""
    fm = idx.fm
    outs = []
    for base in (1, 2, 3, 4):
        first = int(fm.sym_start[base])
        new_lo = first + fm.occ[base - 1, level.lo]
        new_hi = first + fm.occ[base - 1, level.hi + 1] - 1
        keep = new_lo <= new_hi
        sub = level.select(keep)
        sub.lo = new_lo[keep].astype(np.int32)
        sub.hi = new_hi[keep].astype(np.int32)
        sub.code = sub.code + np.uint32((base - 1) * (4 ** depth))
        outs.append(sub)
    out = outs[0]
    for other in outs[1:]:
        out = _concat(out, other)
    return out


def build_kmer_states(idx: PrgIndex, kmer_size: int,
                                jt: Optional[JumpTable] = None) -> dict:
    if jt is None:
        jt = build_jump_table(idx)
    fm = idx.fm
    P = MAX_PATH
    # level 0: one state, full SA interval, no marker processing before the
    # first base (kmer_index/build.cpp:35-46)
    level = _Level(
        lo=np.zeros(1, dtype=np.int32),
        hi=np.asarray([fm.size - 1], dtype=np.int32),
        code=np.zeros(1, dtype=np.uint32),
        trav=np.zeros((1, P, 2), dtype=np.int32),
        n_trav=np.zeros(1, dtype=np.int32),
        ing=np.zeros((1, P, 2), dtype=np.int32),
        n_ing=np.zeros(1, dtype=np.int32),
    )
    level = _base_extend(level, idx, 0)
    for depth in range(1, kmer_size):
        jumped = _jump_expand(level, idx, jt)
        level = _concat(level, jumped)
        level = _base_extend(level, idx, depth)

    # group states by kmer code; stable sort keeps in-level creation order
    order = np.argsort(level.code, kind="stable")
    level = level.select(order)
    codes, starts = np.unique(level.code, return_index=True)
    offsets = np.concatenate([starts, [level.n]]).astype(np.int64)
    return {"codes": codes.astype(np.uint32), "offsets": offsets,
            "lo": level.lo, "hi": level.hi, "trav": level.trav,
            "n_trav": level.n_trav, "ing": level.ing, "n_ing": level.n_ing}


def states_at(arrays: dict, pos: int) -> list:
    """The search states of the kmer at row ``pos`` of ``codes``."""
    out = []
    for si in range(int(arrays["offsets"][pos]),
                    int(arrays["offsets"][pos + 1])):
        nt, ni = int(arrays["n_trav"][si]), int(arrays["n_ing"][si])
        out.append(SearchState(
            int(arrays["lo"][si]), int(arrays["hi"][si]),
            tuple(map(tuple, arrays["trav"][si, :nt].tolist())),
            tuple(map(tuple, arrays["ing"][si, :ni].tolist()))))
    return out
