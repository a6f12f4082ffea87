"""Deterministic RNG matching the reference's std::mt19937 +
libstdc++ std::uniform_int_distribution.

The reference selects one mapping instance per multi-mapping read with
RandomInclusiveInt (libgramtools src/common/random.cpp:4-19): an
mt19937 engine seeded with a 32-bit seed, drawn through
uniform_int_distribution<uint32_t>(min, max). To reproduce its genotype
calls bit-for-bit we replicate both the engine and libstdc++'s
downscaling algorithm (rejection sampling then integer division).

numpy's RandomState uses the same MT19937 engine and scalar seeding
(init_genrand), so we use it for raw 32-bit draws and implement the
distribution on top.
"""
from __future__ import annotations

import numpy as np

_URNG_RANGE = (1 << 32) - 1  # mt19937 max - min


class RandomInclusiveInt:
    """Replica of gram::RandomInclusiveInt (common/random.cpp:4-19)."""

    def __init__(self, seed: int | None):
        if seed is None:
            seed = int(np.random.SeedSequence().entropy) & 0xFFFFFFFF
        self.seed = int(seed) & 0xFFFFFFFF
        self._state = np.random.RandomState(self.seed)

    def _raw(self) -> int:
        # One raw 32-bit mt19937 output.
        return int(self._state.randint(0, 1 << 32, dtype=np.uint32))

    def raw_block(self, n: int) -> list:
        """n raw draws in one call; identical stream to n _raw() calls
        (full-range uint32 randint consumes one twist output per value)."""
        return self._state.randint(0, 1 << 32, size=n,
                                   dtype=np.uint32).tolist()

    def generate(self, lo: int, hi: int) -> int:
        """uniform_int_distribution<uint32_t>(lo, hi) draw, libstdc++ algorithm.

        libstdc++ (bits/uniform_int_dist.h) with urngrange = 2^32-1 and
        urange = hi-lo+1 <= 2^32-1 performs:
            scaling = urngrange / urange   (integer division)
            past    = urange * scaling
            do r = raw() while r >= past
            return lo + r / scaling
        """
        urange = hi - lo + 1
        if urange <= 0:
            raise ValueError("empty range")
        if urange == (1 << 32):
            return lo + self._raw()
        scaling = _URNG_RANGE // urange
        past = urange * scaling
        while True:
            r = self._raw()
            if r < past:
                return lo + r // scaling


# --- batch fast path --------------------------------------------------------
#
# Mapping-instance selection draws exactly ONE uniform_int per read
# (coverage_common.cpp:166-177). Constructing a full mt19937 per read is
# ~200us; instead the FIRST raw output of mt19937(seed) is computed for a
# whole read buffer at once with vectorised numpy (init recurrence to
# index 397 + one twist + tempering). The rare rejection case
# (raw >= past, probability < range/2^32) falls back to the full engine.

_MASK = np.uint32(0xFFFFFFFF)


def first_raw_draws(seeds: np.ndarray) -> np.ndarray:
    """First 32-bit output of std::mt19937(seed) for each seed, vectorised."""
    seeds = np.asarray(seeds, dtype=np.uint32)
    mt_prev = seeds.copy()
    mt1 = None
    mt397 = None
    f = np.uint32(1812433253)
    for i in range(1, 398):
        mt_prev = (f * (mt_prev ^ (mt_prev >> np.uint32(30)))
                   + np.uint32(i)) & _MASK
        if i == 1:
            mt1 = mt_prev.copy()
        if i == 397:
            mt397 = mt_prev
    upper = np.uint32(0x80000000)
    lower = np.uint32(0x7FFFFFFF)
    y = (seeds & upper) | (mt1 & lower)
    mag = np.where((y & np.uint32(1)).astype(bool), np.uint32(0x9908B0DF),
                   np.uint32(0))
    y0 = mt397 ^ (y >> np.uint32(1)) ^ mag
    # tempering
    y0 = y0 ^ (y0 >> np.uint32(11))
    y0 = y0 ^ ((y0 << np.uint32(7)) & np.uint32(0x9D2C5680))
    y0 = y0 ^ ((y0 << np.uint32(15)) & np.uint32(0xEFC60000))
    y0 = y0 ^ (y0 >> np.uint32(18))
    return y0


def generate_fast(seed: int, first_raw: int, lo: int, hi: int) -> int:
    """uniform_int_distribution(lo, hi) on mt19937(seed) using the
    precomputed first output; exact (falls back on rejection)."""
    urange = hi - lo + 1
    scaling = _URNG_RANGE // urange
    past = urange * scaling
    r = int(first_raw)
    if r < past:
        return lo + r // scaling
    return RandomInclusiveInt(seed).generate(lo, hi)
