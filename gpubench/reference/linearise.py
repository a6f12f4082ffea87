"""Linearised PRG: binary (de)serialisation and readable converters.

Three PRG text notations interoperate (as in the reference):
  * binary: little-endian 4-byte unsigned ints (the build artifact)
  * bracketed (nested): "T[cCCC[A,g]CT,]ATTTT" -- '[' opens a site,
    ',' separates alleles, ']' closes
  * numbered (legacy, non-nested only): "AAA5CC6TA6AC"

Parity: libgramtools src/prg/linearised_prg.cpp (PRG_String:8-80,
ints_to_prg_string:133-164, prg_string_to_ints:166-213, encode_prg:241-265).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from .markers import is_site_marker

_BASE_CHARS = {"a": 1, "c": 2, "g": 3, "t": 4}
_INT_TO_CHAR = "0ACGT"


class PrgString:
    """An int-encoded linear PRG plus its site-end-position map.

    ``end_positions`` maps each even (allele) marker to the index of its
    final occurrence, which closes the site (linearised_prg.cpp:52-80).
    Duplicate odd (site) markers raise, as in the reference.
    """

    def __init__(self, ints):
        self.ints = np.ascontiguousarray(ints, dtype=np.uint32)
        if self.ints.size and self.ints.min() < 1:
            raise ValueError("PRG ints must be >= 1")
        self.end_positions: Dict[int, int] = {}
        self._map_ends_and_check_duplicates()

    def _map_ends_and_check_duplicates(self):
        seen_sites = set()
        marker_pos = np.flatnonzero(self.ints > 4)
        for pos in marker_pos:
            m = int(self.ints[pos])
            if is_site_marker(m):
                if m in seen_sites:
                    raise ValueError(
                        f"PRG consistency error: site marker {m} used for two different sites"
                    )
                seen_sites.add(m)
            else:
                self.end_positions[m] = int(pos)

    # --- binary IO ---------------------------------------------------------

    @classmethod
    def from_file(cls, path: str | Path, endianness: str = "little") -> "PrgString":
        raw = Path(path).read_bytes()
        n = len(raw) // 4
        arr = np.frombuffer(raw[: n * 4], dtype="<u4" if endianness == "little" else ">u4")
        return cls(arr.astype(np.uint32))

    def write(self, path: str | Path, endianness: str = "little"):
        dt = "<u4" if endianness == "little" else ">u4"
        Path(path).write_bytes(self.ints.astype(dt).tobytes())

    def __len__(self):
        return int(self.ints.size)

    def __eq__(self, other):
        return isinstance(other, PrgString) and np.array_equal(self.ints, other.ints)


def prg_string_to_ints(string_prg: str) -> np.ndarray:
    """Bracketed nested PRG notation -> int array.

    Sites are numbered in '[' encounter order (linearised_prg.cpp:166-213).
    """
    out = np.empty(len(string_prg), dtype=np.uint32)
    stack = []
    max_marker = 3
    for i, c in enumerate(string_prg):
        if c == "[":
            max_marker += 2
            stack.append(max_marker)
            out[i] = max_marker
        elif c == "]":
            out[i] = stack.pop() + 1
        elif c == ",":
            out[i] = stack[-1] + 1
        else:
            base = _BASE_CHARS.get(c.lower())
            if base is None:
                raise ValueError(f"{c!r} is not a nucleotide char")
            out[i] = base
    if stack:
        raise ValueError("unbalanced '[' in PRG string")
    return out


def ints_to_prg_string(ints) -> str:
    """Int array -> bracketed notation (linearised_prg.cpp:133-164)."""
    arr = np.asarray(ints)
    chars = []
    last_allele_indices: Dict[int, int] = {}
    for pos, v in enumerate(arr):
        v = int(v)
        if v > 4:
            if v % 2 == 1:
                chars.append("[")
            else:
                chars.append(",")
                last_allele_indices[v] = pos
        else:
            chars.append(_INT_TO_CHAR[v])
    for pos in last_allele_indices.values():
        chars[pos] = "]"
    return "".join(chars)


def encode_prg(prg_raw: str) -> np.ndarray:
    """Numbered (non-nested) notation -> int array.

    Digit runs concatenate into one marker ("56" would be marker 56, so
    only valid for non-nested PRGs); legacy odd site-end markers are kept
    as written (linearised_prg.cpp:241-265).
    """
    out = []
    digits = ""

    def flush():
        nonlocal digits
        if digits:
            out.append(int(digits))
            digits = ""

    for c in prg_raw:
        base = _BASE_CHARS.get(c.lower())
        if base is not None:
            flush()
            out.append(base)
        elif c.isdigit():
            digits += c
        else:
            raise ValueError(f"unexpected char {c!r} in numbered PRG")
    flush()
    return np.asarray(out, dtype=np.uint32)


def normalise_legacy_end_markers(ints) -> np.ndarray:
    """Rewrite legacy '5G6C5' site ends to the modern even form '5G6C6'.

    The reference's older PRG format closed a site by repeating the odd
    site marker; gramtools rewrites these on load. Our PrgString requires
    modern form, so numbered-PRG tests route through this helper.
    """
    arr = np.array(ints, dtype=np.uint32, copy=True)
    seen = set()
    for i, v in enumerate(arr):
        v = int(v)
        if v > 4 and v % 2 == 1:
            if v in seen:
                arr[i] = v + 1  # odd end marker -> even
            else:
                seen.add(v)
    return arr
