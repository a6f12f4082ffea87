"""Numpy helpers of the genealogy-log engine, copied unchanged.

These sit in gramtools_tpu/mapping/search_jax_log.py and record_jax.py,
which import ``jax`` at the top, so the port carries its own copy of
each (only the package-relative imports became absolute). They decide
the phase plan, the row padding and the budgets -- and so which rows
overflow -- and turn the device's flat results back into states, paths,
flags and loci on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .device_index import _next_pow2, _round_up


@dataclass
class LogConfig:
    # N: live-state capacity. This is a CAP, not the per-step width --
    # auto_phases right-sizes the warm pool to the row count and shrinks
    # after die-off, so a large cap costs nothing on sparse graphs but
    # stops dense graphs (many kmer seeds per read) from spilling whole
    # reads to the host engine at seeding time.
    pool: int = 262144
    hits: int = 2048     # G: marker hits per step per 4096 rows


def _row_capacity(n_rows: int) -> int:
    """Batch-row padding: pow2 for small batches; past 4096 rows, pow2
    wastes up to ~2x device work (a 5000-read buffer is 10000 oriented
    rows -> 16384), so pad to a 2048 multiple instead. Kept unchanged:
    R fixes the phase plan and budgets, and so which rows overflow."""
    if n_rows <= 4096:
        return _next_pow2(n_rows, floor=8)
    return _round_up(n_rows, 2048)


def _phase4(entry):
    """Phase entries are (n_steps, pool, hits[, narrow_w[, kind]]):
    3-tuples are classic wide-step phases (narrow_w = 0); a 4th element
    > 0 selects the narrow-interval step with that wide-state budget; a
    5th element "locked" selects the slot-locked narrow step (pool slot
    i <-> read i; pool must equal the per-shard row count)."""
    if len(entry) == 5:
        return entry
    if len(entry) == 4:
        return entry + ("",)
    n_steps, pool, hits = entry
    return n_steps, pool, hits, 0, ""


def _unpack_result(flat: np.ndarray, phases, num_reads: int,
                   n_outcomes: int, n_shards: int = 1):
    """Host-side split of the scan+pack output into GLOBAL row space.

    For n_shards > 1 the flat array is the shard-order concatenation of
    per-shard blocks [rid | lo | hi | pref | ovf | lp | le]; local read
    ids map to global rows (local * S + shard), per-shard log references
    (non-negative prefs and log parents) shift by the shard's log
    offset, and the overflow flags land at their global rows. Returns
    (carry_np, log_parent, log_event) with carry arrays concatenated
    over shards."""
    S = n_shards
    N = phases[-1][1]
    L = sum(e[0] * e[2] for e in phases) * n_outcomes
    block = 4 * N + num_reads + 2 * L
    assert flat.size == S * block, (flat.size, S, block)
    rid = np.empty(S * N, flat.dtype)
    lo = np.empty(S * N, flat.dtype)
    hi = np.empty(S * N, flat.dtype)
    pref = np.empty(S * N, flat.dtype)
    ovf = np.zeros(S * num_reads, dtype=bool)
    lp = np.empty(S * L, flat.dtype)
    le = np.empty(S * L, flat.dtype)
    for s in range(S):
        seg = flat[s * block:(s + 1) * block]
        r = seg[:N]
        p = seg[3 * N:4 * N]
        if S > 1:
            r = np.where(r >= 0, r * S + s, r)
            p = np.where((seg[:N] >= 0) & (p >= 0), p + s * L, p)
        rid[s * N:(s + 1) * N] = r
        lo[s * N:(s + 1) * N] = seg[N:2 * N]
        hi[s * N:(s + 1) * N] = seg[2 * N:3 * N]
        pref[s * N:(s + 1) * N] = p
        ovf_local = seg[4 * N:4 * N + num_reads].astype(bool)
        if S > 1:
            rows = np.arange(num_reads) * S + s
            ovf[rows] = ovf_local
        else:
            ovf = ovf_local
        lseg = seg[4 * N + num_reads:]
        lps = lseg[:L]
        if S > 1:
            lps = np.where(lps >= 0, lps + s * L, lps)
        lp[s * L:(s + 1) * L] = lps
        le[s * L:(s + 1) * L] = lseg[L:]
    return (rid, lo, hi, pref, ovf), lp, le


# --------------------------------------------------------------------------
# fused record path (copied from record_jax.py and search_jax_log.py)
# --------------------------------------------------------------------------

# static budgets (overflow -> per-row host fallback). Per-state caps:
MAX_CHAIN = 32       # genealogy chain depth (events per state)
TCAP = 16            # traversed/traversing loci per state
KCAP = 12            # base (level-1) sites per state
# per-buffer expansion budgets, scaled with the row count R
ECAP_BASE = 4096     # encapsulated-split occurrence expansion slots
TRCAP_BASE = 4096    # traversing-state occurrence expansion slots
WCAP_BASE = 8192     # per-base walk lanes (selected-state occurrences)
EMITCAP_BASE = 32768  # per-base walk emissions per buffer
LCAP_BASE = 61440    # compacted traversed-loci lanes


def buffer_caps(R: int):
    """(ecap, trcap, wcap, emitcap, lcap) for an R-row buffer: the
    constants at R<=10240, scaled linearly above."""
    s = max(R, 10240)
    return (max(ECAP_BASE, (ECAP_BASE * s) // 10240),
            max(TRCAP_BASE, (TRCAP_BASE * s) // 10240),
            max(WCAP_BASE, (WCAP_BASE * s) // 10240),
            max(EMITCAP_BASE, (EMITCAP_BASE * s) // 10240),
            max(LCAP_BASE, (LCAP_BASE * s) // 10240))


# fallback reason bits (per-row int32 mask; 0 = no fallback)
FB_CHAIN = 1        # genealogy chain deeper than MAX_CHAIN / TCAP paths
FB_ENC = 2          # encapsulated-split expansion spilled ecap
FB_DUP_SITE = 4     # duplicate site in one state's own path
FB_TRAV = 8         # traversing-state expansion spilled trcap
FB_KCAP = 16        # more base sites per state than KCAP
FB_CONFLICT = 32    # same (state, site) with conflicting alleles
FB_RNG = 64         # mt19937 uniform_int rejection branch
FB_TRIPS = 128      # selected loci spilled trip_cap
FB_WALK = 256       # per-base walk lanes spilled wcap
FB_EMIT = 512       # per-base emissions spilled emitcap
FB_LOCI = 1024      # compacted traversed-loci lanes spilled lcap
FB_NAMES = {FB_CHAIN: "chain_depth", FB_ENC: "encapsulated_spill",
            FB_DUP_SITE: "dup_site", FB_TRAV: "traversing_spill",
            FB_KCAP: "kcap", FB_CONFLICT: "allele_conflict",
            FB_RNG: "rng_rejection", FB_TRIPS: "trip_spill",
            FB_WALK: "walk_spill", FB_EMIT: "emit_spill",
            FB_LOCI: "loci_spill"}


def finalise_cov_diff(cov_diff: np.ndarray) -> np.ndarray:
    """Prefix-sum the diff array into per-base counts (uint16 range,
    saturated -- equivalent to per-increment saturation for +1 ranges)."""
    counts = np.cumsum(cov_diff[:-1].astype(np.int64))
    return np.minimum(counts, np.iinfo(np.uint16).max).astype(np.uint16)


def _pack_reads2(reads_T: np.ndarray) -> np.ndarray:
    """(steps, SR) uint8 base codes 0..4 -> (steps/4, SR) uint8 packed
    2-bit codes (code = base-1 mod 4; zero-pads become 3 and are masked
    on device by row_len -- see search_log.unpack_reads2)."""
    steps = reads_T.shape[0]
    assert steps % 4 == 0, steps
    pr = (reads_T - np.uint8(1)) & np.uint8(3)
    return (pr[0::4] | (pr[1::4] << 2) | (pr[2::4] << 4)
            | (pr[3::4] << 6)).astype(np.uint8)


def _unpack_record_result(flat: np.ndarray, num_reads: int, trip_cap: int,
                          n_shards: int = 1):
    """Host-side split of the fused record output into GLOBAL row space.

    For n_shards > 1 the flat array is the shard-order concatenation of
    per-shard blocks [ovf | fallback | mapped | t_row | t_site |
    t_allele]; flag bits land at their global rows (local * S + shard)
    and the triples' local rows globalise likewise. Returns (overflow,
    fallback, mapped, loci_rows) with loci_rows the neighbour-deduped
    (row, site, allele) triples."""
    S = n_shards
    R = num_reads
    block = 3 * R + 3 * trip_cap
    assert flat.size == S * block, (flat.size, S, block)
    ovf = np.zeros(S * R, dtype=bool)
    fallback = np.zeros(S * R, dtype=np.int32)   # reason bitmask, 0 = ok
    mapped = np.zeros(S * R, dtype=bool)
    loci_parts = []
    for s in range(S):
        seg = flat[s * block:(s + 1) * block]
        rows_g = (np.arange(R) * S + s) if S > 1 else np.arange(R)
        ovf[rows_g] = seg[:R].astype(bool)
        fallback[rows_g] = seg[R:2 * R]
        mapped[rows_g] = seg[2 * R:3 * R].astype(bool)
        t = seg[3 * R:]
        t_row = t[:trip_cap]
        t_site = t[trip_cap:2 * trip_cap]
        t_allele = t[2 * trip_cap:3 * trip_cap]
        valid = t_row < R
        uniq = np.ones(trip_cap, dtype=bool)
        if trip_cap > 1:
            uniq[1:] = ((t_row[1:] != t_row[:-1])
                        | (t_site[1:] != t_site[:-1])
                        | (t_allele[1:] != t_allele[:-1]))
        keep = valid & uniq
        g_row = t_row[keep] * S + s if S > 1 else t_row[keep]
        loci_parts.append(np.stack(
            [g_row, t_site[keep], t_allele[keep]], axis=1).astype(np.int64))
    loci_rows = (np.concatenate(loci_parts) if len(loci_parts) > 1
                 else loci_parts[0])
    return ovf, fallback, mapped, loci_rows


def auto_phases(steps: int, num_reads: int, cfg: LogConfig,
                n_seed_states: int = 0, narrow: Optional[bool] = None):
    """Segment plan sized from the state/hit decay of the scan (live
    states and marker hits peak right after seeding and settle to ~1
    state per row within a few steps): 2 warm steps at the full
    budgets, 4 mid steps at (1.5R, G/4), then the tail at (1.25R, G/8)
    -- narrow, then slot-locked. States sliced off by a shrink flag
    their read for exact host re-mapping and budget overflow triggers
    a same-shape retry pass, so an under-provisioned plan costs
    fallback/retry work, never correctness.

    The warm pool is max(pow2(4 x rows), pow2(2 x seed states)); the
    seed-state term is a grow-only ratchet that matters only for
    high-fan-out graphs (small k). Copied unchanged from the JAX
    engine: the plan decides which rows overflow, so both engines must
    make the same one."""
    import os
    if narrow is None:
        narrow = os.environ.get("GRAMTOOLS_TPU_NARROW", "1") == "1"
    WARM, MID = 2, 4
    # slot-locked tail starts once states are ~unique: after LOCK_AFTER
    # steps the matched suffix is k + LOCK_AFTER bases long, so the
    # multi-state (flagged -> host) read fraction is ~n/4^(k+LOCK_AFTER)
    lock_after = int(os.environ.get("GRAMTOOLS_TPU_LOCK_AFTER", "14"))
    pool_warm = min(cfg.pool, max(_next_pow2(4 * num_reads, floor=64),
                                  _next_pow2(2 * n_seed_states, floor=64)
                                  if n_seed_states else 64))
    pool_mid = min(pool_warm, max(_round_up(3 * num_reads // 2, 64), 64))
    hits_mid = min(cfg.hits, max(cfg.hits // 4, 8))
    pool_tail = min(pool_mid, max(_round_up(5 * num_reads // 4, 64), 64))
    # tail hit budget: the newborn block's gathers are Theta(hits*B)
    # per step, so the divisor trades device time against overflow
    # retries
    tail_div = int(os.environ.get("GRAMTOOLS_TPU_TAIL_HITS_DIV", "8"))
    hits_tail = min(hits_mid, max(cfg.hits // tail_div, 8))
    # narrow-step wide budget: sized to the per-step newborn volume (the
    # only states that re-widen mid-tail); repeats/dense graphs past the
    # budget flag -> same-shape retry -> exact host re-map
    wide_w = min(pool_tail, max(hits_tail, 64)) if narrow else 0
    narrow_len = max(lock_after - WARM - MID, 0) if narrow else None
    plan = []
    remaining = steps
    segments = [(WARM, pool_warm, cfg.hits, 0, ""),
                (MID, pool_mid, hits_mid, 0, "")]
    if narrow and num_reads <= pool_tail:
        segments += [(narrow_len, pool_tail, hits_tail, wide_w, ""),
                     (None, num_reads, hits_tail,
                      min(num_reads, wide_w), "locked")]
    else:
        segments += [(None, pool_tail, hits_tail, wide_w or 0, "")]
    for length, pool, hits, nw, kind in segments:
        n = remaining if length is None else min(length, remaining)
        if n <= 0:
            continue
        if kind == "locked":
            entry = (n, pool, hits, nw, kind)
        elif nw:
            entry = (n, pool, hits, nw)
        else:
            entry = (n, pool, hits)
        if plan and plan[-1][1:] == entry[1:]:
            plan[-1] = (plan[-1][0] + n,) + entry[1:]
        else:
            plan.append(entry)
        remaining -= n
    return tuple(plan)


def _filter_buffer_rows(buffer, kmer_index, k, stats):
    """Kmer-presence screen over both orientations of a read buffer.

    Returns (results_skeleton, rows, rows_mat): rows is the list of
    mappable (buffer_index, oriented_read) pairs; rows_mat is the
    stacked row matrix when the equal-length fast path applied (else
    None). Used by LogBatchedEngine.scan_submit."""
    from gramtools_tpu.common.seq import _COMPLEMENT_LUT, revcomp
    from gramtools_tpu.mapping.quasimap import (ReadBatch,
                                                 all_read_kmers_in_index)

    results = [[] for _ in range(len(buffer))]
    if isinstance(buffer, ReadBatch):
        # matrix-backed buffer: no per-read Python objects anywhere
        nz = np.flatnonzero(~buffer.invalid)
        L0 = buffer.mat.shape[1]
        sizes = np.where(buffer.invalid, 0, L0).astype(np.int64)
    else:
        sizes = np.array([r.size for r in buffer], dtype=np.int64)
        nz = np.flatnonzero(sizes > 0)
    stats.all_reads_count += 2 * len(buffer)
    stats.skipped_reads_count += 2 * int(len(buffer) - nz.size)
    if nz.size == 0:
        return results, [], None
    matrix_filter = getattr(kmer_index, "batch_all_indexed_matrix", None)
    equal_len = (sizes[nz] == sizes[nz[0]]).all()
    rows_mat = None
    if equal_len and matrix_filter is not None and sizes[nz[0]] >= k:
        # equal-length fast path: one (2n, L) matrix, vectorised
        # revcomp + filter, row views into the matrix afterwards
        fwd = (buffer.mat[nz] if isinstance(buffer, ReadBatch)
               else np.stack([buffer[i] for i in nz]))
        native = None
        bitmap_fn = getattr(kmer_index, "_presence_bitmap", None)
        present = bitmap_fn() if bitmap_fn is not None else None
        if present is not None:
            from gramtools_tpu.index.native import native_kmer_screen
            native = native_kmer_screen(fwd, k, present)
        if native is not None:
            # fused revcomp + rolling-code screen with early exit
            # (gramtools_tpu/native/screen.cpp)
            mat, passed = native
        else:
            mat = np.empty((2 * nz.size, fwd.shape[1]), dtype=np.uint8)
            mat[0::2] = fwd
            mat[1::2] = _COMPLEMENT_LUT[fwd[:, ::-1]]
            passed = matrix_filter(mat)
        owners = np.repeat(nz, 2)
        stats.missing_kmer_reads_count += int(np.count_nonzero(~passed))
        hit = np.flatnonzero(passed)
        rows = [(int(owners[j]), mat[j]) for j in hit]
        rows_mat = mat[hit]
    else:
        oriented_all = []
        owners = []
        for i in nz:
            read = buffer[i]
            oriented_all.append(read)
            oriented_all.append(revcomp(read))
            owners.extend((i, i))
        batch_filter = getattr(kmer_index, "batch_all_indexed", None)
        if batch_filter is not None:
            passed = batch_filter(oriented_all)
        else:
            passed = np.array([all_read_kmers_in_index(k, r, kmer_index)
                               for r in oriented_all])
        rows = []
        for j, (i, oriented) in enumerate(zip(owners, oriented_all)):
            if passed[j]:
                rows.append((int(i), oriented))
            else:
                stats.missing_kmer_reads_count += 1
    return results, rows, rows_mat


class PathReplayer:
    """Reconstructs (traversed, traversing) for final states from the
    genealogy log + the seed paths, replaying jump-table ops root->leaf
    (the host twin of the flat engine's device op loop)."""

    def __init__(self, jt, B: int):
        from gramtools_tpu.mapping.jump_table import OP_ENTER, OP_EXIT

        self._OP_EXIT, self._OP_ENTER = OP_EXIT, OP_ENTER
        self.kind = np.asarray(jt.ops_kind)
        self.site = np.asarray(jt.ops_site)
        self.allele = np.asarray(jt.ops_allele)
        self.B = B
        self._cache: dict = {}

    def replay(self, pref: int, log_parent: np.ndarray, log_event: np.ndarray,
               seed_paths) -> "tuple[tuple, tuple]":
        events: List[int] = []
        while pref >= 0:
            events.append(int(log_event[pref]))
            pref = int(log_parent[pref])
        trav, ing = seed_paths(-pref - 1)
        trav, ing = list(trav), list(ing)
        for event in reversed(events):
            ops = self._cache.get(event)
            if ops is None:
                li, b = divmod(event, self.B)
                ops = [(int(k), int(s), int(a)) for k, s, a in zip(
                    self.kind[li, b], self.site[li, b], self.allele[li, b])
                    if k != 0]
                self._cache[event] = ops
            for kind, site, allele in ops:
                if kind == self._OP_EXIT:
                    if ing:
                        ing.pop()
                    trav.append((site, allele))
                else:  # OP_ENTER
                    from gramtools_tpu.prg.markers import ALLELE_UNKNOWN
                    ing.append((site, ALLELE_UNKNOWN))
        return tuple(trav), tuple(ing)


def replay_paths_vectorised(f_read_id, f_pref, log_parent, log_event,
                            s_trav, s_nt, s_ing, s_ni, jt, B):
    """Batch path reconstruction: chase all genealogy chains at once
    (one gather per depth level), then apply the jump-table ops of each
    chain root->leaf with masked writes. Returns per live state:
    (pool_index, trav (n,T,2), n_trav, ing (n,I,2), n_ing)."""
    from gramtools_tpu.prg.markers import ALLELE_UNKNOWN
    from gramtools_tpu.mapping.jump_table import OP_ENTER, OP_EXIT

    sel = np.flatnonzero(f_read_id >= 0)
    n = sel.size
    kind2 = np.asarray(jt.ops_kind).reshape(-1, jt.max_ops)
    site2 = np.asarray(jt.ops_site).reshape(-1, jt.max_ops)
    allele2 = np.asarray(jt.ops_allele).reshape(-1, jt.max_ops)
    O = jt.max_ops
    if n == 0:
        return (sel, np.zeros((0, 1, 2), np.int64), np.zeros(0, np.int64),
                np.zeros((0, 1, 2), np.int64), np.zeros(0, np.int64))

    p = f_pref[sel].astype(np.int64)
    events = []
    guard = 0
    while (p >= 0).any():
        pc = np.clip(p, 0, max(log_event.size - 1, 0))
        events.append(np.where(p >= 0, log_event[pc], -1))
        p = np.where(p >= 0, log_parent[pc], p)
        guard += 1
        if guard > 1_000_000:
            raise RuntimeError("genealogy log cycle")
    seed_idx = (-p - 1).astype(np.int64)
    D = len(events)

    P0 = s_trav.shape[1] if s_trav.ndim == 3 else 0
    I0 = s_ing.shape[1] if s_ing.ndim == 3 else 0
    Tcap = max(P0 + D * O, 1)
    Icap = max(I0 + D * O, 1)
    trav = np.zeros((n, Tcap, 2), dtype=np.int64)
    ing = np.zeros((n, Icap, 2), dtype=np.int64)
    if P0:
        trav[:, :P0] = s_trav[seed_idx]
    if I0:
        ing[:, :I0] = s_ing[seed_idx]
    n_trav = s_nt[seed_idx].astype(np.int64)
    n_ing = s_ni[seed_idx].astype(np.int64)
    ar = np.arange(n)
    for d in range(D - 1, -1, -1):
        ev = events[d]
        valid = ev >= 0
        evc = np.clip(ev, 0, kind2.shape[0] - 1)
        for o in range(O):
            kind = np.where(valid, kind2[evc, o], 0)
            ex = kind == OP_EXIT
            if ex.any():
                n_ing = np.where(ex & (n_ing > 0), n_ing - 1, n_ing)
                rows = ar[ex]
                trav[rows, n_trav[rows], 0] = site2[evc, o][ex]
                trav[rows, n_trav[rows], 1] = allele2[evc, o][ex]
                n_trav = np.where(ex, n_trav + 1, n_trav)
            en = kind == OP_ENTER
            if en.any():
                rows = ar[en]
                ing[rows, n_ing[rows], 0] = site2[evc, o][en]
                ing[rows, n_ing[rows], 1] = ALLELE_UNKNOWN
                n_ing = np.where(en, n_ing + 1, n_ing)
    return sel, trav, n_trav, ing, n_ing
