"""Vectorised kmer-index builder + array-backed kmer index.

The reference indexes all 4^k kmers by incremental cached backward
search (build/kmer_index/build.cpp). The scalar DFS (kmer_index.py)
reproduces that exactly but is Python-bound; this builder runs the
same level-synchronous expansion entirely in numpy:

  level d holds ALL live search states of all d-length kmer suffixes as
  flat arrays (lo, hi, kmer_code, paths). One level step is:
    1. marker fan-out: exact per-state hit counts from the marker-rank
       prefix (no bound, repeat/cumsum indexing), jump outcomes from the
       precomputed jump table (jump_table.py), path ops applied with
       masked writes;
    2. LF extension by each of the 4 bases (states x 4), dropping empty
       intervals.

  After k levels, states are grouped by kmer code into a CSR layout
  (ArrayKmerIndex) that serialises to npz and answers dict-style
  queries for the mapping engines.

Path capacity is P entries per state; a state exceeding it aborts the
build (raise) -- k-length kmers cross few sites, so P=8 is generous.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..mapping.jump_table import JumpTable, OP_ENTER, OP_EXIT, build_jump_table
from ..mapping.search import PrgIndex, SearchState
from ..prg.markers import ALLELE_UNKNOWN
from .fm import save_npz

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


class ArrayKmerIndex:
    """CSR kmer index: sorted kmer codes -> packed SearchStates."""

    def __init__(self, kmer_size, codes, offsets, lo, hi, trav, n_trav, ing,
                 n_ing):
        self.kmer_size = kmer_size
        self.codes = codes          # (K,) uint32 sorted
        self.offsets = offsets      # (K+1,)
        self.lo = lo
        self.hi = hi
        self.trav = trav            # (n_states, P, 2)
        self.n_trav = n_trav
        self.ing = ing
        self.n_ing = n_ing

    @staticmethod
    def encode_kmer(kmer: np.ndarray) -> int:
        """bases (left-to-right, 1..4) -> base-4 code; leftmost base is the
        highest digit (matches _base_extend's prepend exponent)."""
        code = 0
        k = len(kmer)
        for i, b in enumerate(kmer):
            code += (int(b) - 1) * (4 ** (k - 1 - i))
        return code

    def _search(self, codes):
        """np.searchsorted into the sorted codes, through an int64 copy
        made once: searching the uint32 array itself with int64 or
        Python-int keys casts all of it on every call."""
        if getattr(self, "_codes64", None) is None:
            self._codes64 = self.codes.astype(np.int64)
        return np.searchsorted(self._codes64, codes)

    def _find(self, code: int) -> int:
        pos = int(self._search(code))
        if pos < self.codes.size and int(self.codes[pos]) == code:
            return pos
        return -1

    def contains_code(self, code: int) -> bool:
        return self._find(code) >= 0

    def states_for_code(self, code: int) -> List[SearchState]:
        pos = self._find(code)
        if pos < 0:
            return []
        out = []
        for si in range(int(self.offsets[pos]), int(self.offsets[pos + 1])):
            nt, ni = int(self.n_trav[si]), int(self.n_ing[si])
            out.append(SearchState(
                int(self.lo[si]), int(self.hi[si]),
                tuple(map(tuple, self.trav[si, :nt].tolist())),
                tuple(map(tuple, self.ing[si, :ni].tolist()))))
        return out

    # --- dict-style adapter (kmer bytes keyed, as the scalar index) --------

    def __contains__(self, kmer_bytes: bytes) -> bool:
        return self.contains_code(
            self.encode_kmer(np.frombuffer(kmer_bytes, dtype=np.uint8)))

    def get(self, kmer_bytes: bytes, default=None):
        states = self.states_for_code(
            self.encode_kmer(np.frombuffer(kmer_bytes, dtype=np.uint8)))
        return states if states else default

    def __getitem__(self, kmer_bytes: bytes):
        states = self.get(kmer_bytes)
        if states is None:
            raise KeyError(kmer_bytes)
        return states

    def num_kmers(self) -> int:
        return int(self.codes.size)

    # --- vectorised read screening -----------------------------------------

    def read_kmer_codes(self, read: np.ndarray) -> np.ndarray:
        """Codes of every kmer of the read (vectorised sliding window)."""
        k = self.kmer_size
        c = (read.astype(np.int64) - 1)
        powers = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
        windows = np.lib.stride_tricks.sliding_window_view(c, k)
        return windows @ powers

    def all_kmers_indexed(self, read: np.ndarray) -> bool:
        """quasimap.cpp:212-225 parity, without per-kmer Python lookups."""
        if read.size < self.kmer_size:
            return False
        codes = self.read_kmer_codes(read)
        pos = self._search(codes)
        pos_c = np.clip(pos, 0, self.codes.size - 1)
        return bool(np.all((pos < self.codes.size)
                           & (self.codes[pos_c] == codes)))

    def _presence_bitmap(self):
        """Dense kmer-presence table (4^k bools, lazily built): O(1)
        membership instead of binary search. 16MB at k=12; falls back to
        searchsorted beyond 2^28 codes."""
        if getattr(self, "_present", None) is None:
            space = 4 ** self.kmer_size
            if space > 2 ** 28:
                self._present = False
            else:
                present = np.zeros(space, dtype=bool)
                present[self.codes] = True
                self._present = present
        return None if self._present is False else self._present

    def batch_all_indexed(self, reads: List[np.ndarray]) -> np.ndarray:
        """all_kmers_indexed for a whole batch: one window matmul + one
        searchsorted over the concatenation of every read's kmers."""
        k = self.kmer_size
        sizes = np.array([r.size for r in reads])
        ok = sizes >= k
        use = [r for r, o in zip(reads, ok) if o]
        if not use:
            return ok & False
        # concatenate reads with a -1 sentinel between them: windows
        # crossing a boundary contain the sentinel and are masked out
        total = int(sum(r.size for r in use)) + len(use) - 1
        flat = np.full(total, -1, dtype=np.int64)
        cursor = 0
        counts = []
        for r in use:
            flat[cursor : cursor + r.size] = r.astype(np.int64) - 1
            cursor += r.size + 1
            counts.append(r.size - k + 1)
        # Horner slide: k shifted passes beat an int64 window matmul
        # (numpy integer matmul is a scalar loop, ~3x slower)
        n_win = total - k + 1
        codes = flat[:n_win].copy()
        in_read = flat[:n_win] >= 0
        for j in range(1, k):
            seg = flat[j : j + n_win]
            codes <<= 2
            codes += seg
            in_read &= seg >= 0
        codes = np.where(in_read, codes, 0)
        present = self._presence_bitmap()
        if present is not None:
            hit = present[np.where(in_read, codes, 0)] | ~in_read
        else:
            pos = self._search(codes)
            pos_c = np.clip(pos, 0, max(self.codes.size - 1, 0))
            hit = ((pos < self.codes.size)
                   & (self.codes[pos_c] == codes)) | ~in_read
        # per-read verdict: all in-read windows hit
        starts = np.concatenate(
            [[0], (np.cumsum(sizes[ok] + 1))[:-1]]).astype(np.int64)
        # window w belongs to read r iff starts[r] <= w < starts[r]+counts[r];
        # reduceat over hit with read start offsets covers exactly those
        # windows plus the sentinel-masked gaps (which are forced True)
        all_hit = np.minimum.reduceat(hit.astype(np.int8), starts).astype(bool)
        out = ok.copy()
        out[ok] = all_hit
        return out

    def batch_all_indexed_matrix(self, mat: np.ndarray) -> np.ndarray:
        """all_kmers_indexed for an equal-length batch (n, L) uint8 with
        no unknown bases: Horner slide over row-aligned windows, no
        sentinel concatenation.

        Processed in row chunks with int32 codes (k <= 14 fits 28 bits):
        the whole-batch int64 version spills the cache past ~10k rows and
        went superlinear at throughput-mode buffer sizes."""
        n, L = mat.shape
        k = self.kmer_size
        if L < k:
            return np.zeros(n, dtype=bool)
        n_win = L - k + 1
        present = self._presence_bitmap()
        out = np.empty(n, dtype=bool)
        chunk = max(1, (1 << 21) // max(n_win, 1))  # ~8MB of int32 codes
        for c0 in range(0, n, chunk):
            m = mat[c0:c0 + chunk].astype(np.int32)
            m -= 1
            codes = m[:, :n_win].copy()
            for j in range(1, k):
                codes <<= 2
                codes += m[:, j : j + n_win]
            if present is not None:
                hit = present[codes]
            else:
                pos = self._search(codes.reshape(-1))
                pos_c = np.clip(pos, 0, max(self.codes.size - 1, 0))
                hit = (((pos < self.codes.size)
                        & (self.codes[pos_c] == codes.reshape(-1)))
                       .reshape(codes.shape))
            out[c0:c0 + chunk] = hit.all(axis=1)
        return out

    def _seed_indices(self, last_kmers: np.ndarray):
        """(owner_row, sidx): one entry per seed state of the batch;
        sidx = global index into the CSR state arrays."""
        k = self.kmer_size
        powers = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
        codes = (last_kmers.astype(np.int64) - 1) @ powers
        pos = self._search(codes)
        pos_c = np.clip(pos, 0, max(self.codes.size - 1, 0))
        found = (pos < self.codes.size) & (self.codes[pos_c] == codes)
        starts = np.where(found, self.offsets[pos_c], 0)
        counts = np.where(found, self.offsets[np.minimum(pos_c + 1,
                                                         self.offsets.size - 1)]
                          - starts, 0)
        total = int(counts.sum())
        owner = np.repeat(np.arange(codes.size), counts)
        first_of = np.repeat(np.cumsum(counts) - counts, counts)
        sidx = np.repeat(starts, counts) + (np.arange(total) - first_of)
        return owner.astype(np.int32), sidx

    def seed_batch_indices(self, last_kmers: np.ndarray):
        """Seed lookup returning only (owner_row, sidx): the device
        record path keeps the state payloads RESIDENT on device
        (record_jax.SeedTables) and gathers them by sidx there, so the
        host neither gathers nor ships the (n, P, 2) path arrays
        (~22MB/buffer through a ~25MB/s relay link)."""
        return self._seed_indices(last_kmers)

    def seed_batch(self, last_kmers: np.ndarray):
        """Vectorised seed lookup for a batch: last_kmers (R, k) uint8.

        Returns (owner_row, lo, hi, trav, n_trav, ing, n_ing, sidx): one
        entry per seed state, owner_row = read row it belongs to (rows
        whose kmer is absent contribute no states), sidx = global CSR
        state index.
        """
        owner, sidx = self._seed_indices(last_kmers)
        return (owner, self.lo[sidx], self.hi[sidx],
                self.trav[sidx], self.n_trav[sidx], self.ing[sidx],
                self.n_ing[sidx], sidx)

    # --- serialisation -----------------------------------------------------

    def save(self, path):
        save_npz(
            path, kmer_size=np.int32(self.kmer_size), codes=self.codes,
            offsets=self.offsets, lo=self.lo, hi=self.hi, trav=self.trav,
            n_trav=self.n_trav, ing=self.ing, n_ing=self.n_ing)

    @classmethod
    def load(cls, path) -> "ArrayKmerIndex":
        with np.load(path) as z:
            return cls(int(z["kmer_size"]), z["codes"], z["offsets"], z["lo"],
                       z["hi"], z["trav"], z["n_trav"], z["ing"], z["n_ing"])


def build_kmer_index_vectorised(idx: PrgIndex, kmer_size: int,
                                jt: Optional[JumpTable] = None
                                ) -> ArrayKmerIndex:
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
    return ArrayKmerIndex(kmer_size, codes.astype(np.uint32), offsets,
                          level.lo, level.hi, level.trav, level.n_trav,
                          level.ing, level.n_ing)
