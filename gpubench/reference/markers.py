"""Marker conventions of the linearised PRG.

A linearised PRG is an int sequence where 1..4 encode A,C,G,T and
integers >= 5 are variant markers: odd = site entry, even = allele
delimiter; the *last* occurrence of an even marker closes its site.
Parity: libgramtools include/common/data_types.hpp:58-86.
"""
from __future__ import annotations

FIRST_ALLELE = 0
ALLELE_UNKNOWN = -1  # never a valid allele ID

MIN_MARKER = 5


def is_marker(m: int) -> bool:
    return m > 4


def is_site_marker(m: int) -> bool:
    if m <= 4:
        raise ValueError(f"{m} is not a variant marker (>4)")
    return m % 2 == 1


def is_allele_marker(m: int) -> bool:
    return not is_site_marker(m)


def site_id_to_index(site_id: int) -> int:
    """site ID 5 -> 0, 7 -> 1, ... (data_types.hpp:78-81)."""
    if not is_site_marker(site_id):
        raise ValueError(f"{site_id} is not a site ID")
    return (site_id - 5) // 2


def index_to_site_id(idx: int) -> int:
    return idx * 2 + 5
