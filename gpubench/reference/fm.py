"""FM-index over the linearised PRG, as dense device-friendly arrays.

Re-design of the reference's sdsl `csa_wt` wavelet-tree index
(include/common/data_types.hpp:33-37) for TPU consumption:

  * ``sa``        int32[n]  -- full suffix array (the reference also
                              stores the full SA: sampling density 1)
  * ``bwt``       int32[n]  -- BWT symbols (0 sentinel, 1-4 DNA, >=5 markers)
  * ``occ``       int32[4, n+1] -- cumulative DNA occurrence counts:
                              occ[c-1, i] = #occurrences of base c in
                              bwt[0:i]. Replaces the reference's four
                              rank-supported bit masks
                              (make_data_structures.cpp:113-156).
  * ``sym_start/sym_end`` -- per-symbol SA interval (the C array +
                              char2comp of sdsl, indexed by symbol value)
  * ``marker_prefix`` int32[n+1] -- cumulative count of marker symbols in
                              the BWT; with ``marker_sa_pos`` (the sorted
                              BWT positions holding markers) this answers
                              "which markers sit in SA interval [lo,hi]"
                              in O(1)+gather, replacing the reference's
                              per-position scan (vBWT_jump.cpp:94-117).

n = len(prg) + 1 (sentinel row included, as in sdsl).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .seqs import suffix_array


class FMIndex:
    def __init__(self, sa, bwt, occ, sym_start, sym_end, marker_prefix, marker_sa_pos):
        self.sa = sa
        self.bwt = bwt
        self.occ = occ
        self.sym_start = sym_start
        self.sym_end = sym_end
        self.marker_prefix = marker_prefix
        self.marker_sa_pos = marker_sa_pos

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, prg_ints: np.ndarray) -> "FMIndex":
        text = np.asarray(prg_ints, dtype=np.uint32)
        sa = suffix_array(text)
        n = sa.size  # len(text) + 1

        t = np.empty(n, dtype=np.int64)
        t[:-1] = text
        t[-1] = 0
        bwt = t[(sa.astype(np.int64) - 1) % n].astype(np.int32)

        # Dense DNA occurrence tables (prefix counts)
        occ = np.zeros((4, n + 1), dtype=np.int32)
        for c in range(1, 5):
            occ[c - 1, 1:] = np.cumsum(bwt == c, dtype=np.int32)

        # Per-symbol SA intervals
        max_sym = int(t.max())
        counts = np.bincount(t.astype(np.int64), minlength=max_sym + 1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
        ends = (starts + counts - 1).astype(np.int32)

        # Marker occurrences in the BWT
        marker_mask = bwt > 4
        marker_prefix = np.zeros(n + 1, dtype=np.int32)
        marker_prefix[1:] = np.cumsum(marker_mask, dtype=np.int32)
        marker_sa_pos = np.flatnonzero(marker_mask).astype(np.int32)

        return cls(sa, bwt, occ, starts, ends, marker_prefix, marker_sa_pos)

    # -- queries -------------------------------------------------------------

    @property
    def size(self) -> int:
        return int(self.sa.size)

    def rank_base(self, base: int, i: int) -> int:
        """# occurrences of DNA base (1-4) in bwt[0:i] (BWT_search.cpp:8-22)."""
        return int(self.occ[base - 1, i])

    def base_next_sa_interval(self, base: int, lo: int, hi: int):
        """One LF-mapping step (BWT_search.cpp:45-76). Returns (lo', hi'),
        empty iff lo' > hi'."""
        first = int(self.sym_start[base])
        new_lo = first + int(self.occ[base - 1, lo])
        new_hi = first + int(self.occ[base - 1, hi + 1]) - 1
        return new_lo, new_hi

    def symbol_interval(self, sym: int):
        """Full SA interval of a symbol (vBWT_jump.cpp:3-21)."""
        return int(self.sym_start[sym]), int(self.sym_end[sym])

    def markers_in_interval(self, lo: int, hi: int) -> np.ndarray:
        """SA indices in [lo, hi] whose BWT symbol is a marker, ascending."""
        a = int(self.marker_prefix[lo])
        b = int(self.marker_prefix[hi + 1])
        return self.marker_sa_pos[a:b]
