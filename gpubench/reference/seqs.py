"""Sequence helpers: base codes, reverse complement, FASTQ reading and
the suffix array by prefix doubling."""
from __future__ import annotations

import numpy as np

_DECODE = np.frombuffer(b"NACGT", dtype=np.uint8)
_ENCODE = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _ENCODE[_c] = _i + 1
    _ENCODE[ord(chr(_c).lower())] = _i + 1


def decode_dna(arr: np.ndarray) -> str:
    """Base codes 1-4 -> an ACGT string ('N' for 0)."""
    return _DECODE[np.clip(np.asarray(arr), 0, 4)].tobytes().decode("ascii")


def revcomp_rows(reads: np.ndarray) -> np.ndarray:
    """Reverse complement of each row of base codes 1-4 (0 stays 0)."""
    return np.where(reads > 0, 5 - reads, 0)[:, ::-1].astype(np.uint8)


def read_fastq(path) -> np.ndarray:
    """The reads of a FASTQ file of equal-length reads, as an (n, L)
    uint8 matrix of base codes (0 for any other letter)."""
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    seqs = lines[1::4]
    if seqs and not seqs[-1]:
        seqs = seqs[:-1]
    if not seqs:
        return np.zeros((0, 0), dtype=np.uint8)
    length = len(seqs[0])
    if any(len(s) != length for s in seqs):
        raise ValueError(f"{path}: reads of unequal length")
    raw = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    return _ENCODE[raw].reshape(len(seqs), length)


def suffix_array(text: np.ndarray) -> np.ndarray:
    """SA of ``text + [0]`` (the 0 sentinel the smallest symbol), int32,
    by prefix doubling. ``text`` values must all be >= 1."""
    t = np.empty(text.size + 1, dtype=np.int64)
    t[:-1] = text
    t[-1] = 0
    n = t.size
    _, rank = np.unique(t, return_inverse=True)
    rank = rank.astype(np.int64)
    k = 1
    while True:
        shifted = np.full(n, -1, dtype=np.int64)
        shifted[:n - k] = rank[k:]
        order = np.lexsort((shifted, rank))
        r1, r2 = rank[order], shifted[order]
        changed = np.ones(n, dtype=bool)
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.cumsum(changed) - 1
        if rank[order[-1]] == n - 1:
            return order.astype(np.int32)
        k *= 2
