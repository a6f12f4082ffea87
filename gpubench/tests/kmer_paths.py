"""The kmers of a PRG found without an index, for the tests: every run
of k bases along some path of the graph. The bases that may follow each
base on a path are worked out from the markers, and every base position
is extended k - 1 times along them. The tests hold the reference's kmer
states and the port's kmer index to this set."""
from __future__ import annotations

import numpy as np


def _allele_starts(ints: np.ndarray):
    """Each site marker -> the start positions of its alleles, and each
    allele marker -> the position of its last occurrence (the site's
    end)."""
    mpos = np.flatnonzero(ints > 4)
    vals = ints[mpos]
    end = dict(zip(vals.tolist(), mpos.tolist()))
    starts = {}
    for p, v in zip(mpos.tolist(), vals.tolist()):
        if v % 2:
            starts[v] = [p + 1]
        elif p != end[v]:
            starts[v - 1].append(p + 1)
    return starts, end, mpos


def successors(ints: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """CSR of the base positions that may follow each position on a
    path: ``targets[offsets[p]:offsets[p + 1]]`` for position p."""
    ints = np.asarray(ints, dtype=np.int64)
    n = ints.size
    starts, end, mpos = _allele_starts(ints)
    # the base positions a walk reaches from position q before it reads
    # another base; markers resolved from the right, each only needs
    # positions after it
    reach = {}

    def resolve(q):
        if q >= n:
            return ()
        if ints[q] <= 4:
            return (q,)
        return reach[q]

    for q in mpos[::-1].tolist():
        v = int(ints[q])
        if v % 2:                       # a site's entry: any allele
            out = []
            for s in starts[v]:
                if ints[s] == v + 1:    # an empty allele: past the site
                    out.extend(resolve(end[v + 1] + 1))
                else:
                    out.extend(resolve(s))
            reach[q] = tuple(dict.fromkeys(out))
        else:                           # an allele's end: past the site
            reach[q] = resolve(end[v] + 1)
    nxt = np.arange(1, n + 1)
    deg = np.zeros(n, dtype=np.int64)
    plain = np.zeros(n, dtype=bool)
    plain[:-1] = ints[1:] <= 4
    deg[plain] = 1
    follow_marker = np.flatnonzero(~plain[:-1] & (ints[1:] > 4))
    lists = {int(p): reach[int(p) + 1] for p in follow_marker}
    for p, r in lists.items():
        deg[p] = len(r)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offsets[1:])
    targets = np.empty(int(offsets[-1]), dtype=np.int64)
    targets[offsets[:-1][plain]] = nxt[plain]
    for p, r in lists.items():
        targets[offsets[p]:offsets[p] + len(r)] = r
    return offsets, targets


def kmer_table(ints: np.ndarray, k: int) -> np.ndarray:
    """A boolean table over the 4**k kmer codes (base b at weight
    4**(k-1-i) for the i-th base, code b - 1): True for the kmers on some
    path of the PRG."""
    ints = np.asarray(ints, dtype=np.int64)
    offsets, targets = successors(ints)
    pos = np.flatnonzero(ints <= 4)
    code = ints[pos] - 1
    for _ in range(k - 1):
        deg = offsets[pos + 1] - offsets[pos]
        owner = np.repeat(np.arange(pos.size), deg)
        first = np.repeat(offsets[pos], deg)
        j = np.arange(owner.size) - np.repeat(np.cumsum(deg) - deg, deg)
        pos = targets[first + j]
        code = code[owner] * 4 + ints[pos] - 1
    table = np.zeros(4 ** k, dtype=bool)
    table[code] = True
    return table

