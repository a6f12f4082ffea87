"""The vBWT scan steps in plain torch (int32 throughout).

Port of gramtools_tpu/mapping/search_jax_log.py: ``_build_log_step``
(the wide step), ``_build_narrow_step`` (hole-allocated and slot-locked
narrow steps), ``_lock_pool`` and ``_resize_pool``. Each step maps
``(carry, base_row, log_base) -> (carry, (rec_parent, rec_event))``
with carry ``(read_id, lo, hi, pref, overflow)``; see the JAX module
for the algorithm. What differs from JAX, and why:

  * JAX drops out-of-range scatter writes (``mode="drop"``); torch
    raises. Every masked write goes to an explicit dump slot, so
    ``overflow`` carries ``num_reads + 1`` flags here: index
    ``num_reads`` is the dump slot and is never read back.
  * Duplicate scatter indices land only on dump slots or write the same
    value, so CUDA's arbitrary choice among duplicate writers is safe.
  * Every gather index is clamped explicitly, as in the JAX code.
  * No step reads a value back to the host or copies one from it:
    launches stay asynchronous (no ``torch.tensor`` on the device, no
    scalar assigned through an index tensor). The steps never write
    into their inputs.
"""
from __future__ import annotations

import torch

from ..ops.prefix import cumsum

I32 = torch.int32


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(I32)


def dense_occ_rows(di):
    """Dense (n+1, 4) prefix-table gather: occ_rows(rows) -> (..., 4)."""
    n = di.size
    return lambda rows: di.occ[rows.clamp(0, n)]


def _scatter_rows(fill: torch.Tensor, dest: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """fill.at[dest].set(values) on a fresh copy of ``fill``."""
    out = fill.clone()
    out[dest] = values
    return out


def _set_flags(flags: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flags.at[idx].set(True) on a fresh copy of ``flags``
    (``index_fill_`` takes the value as a kernel argument; ``out[idx] =
    True`` would copy a host scalar to the device, a synchronisation)."""
    return flags.clone().index_fill_(0, idx.to(torch.int64), True)


class _Consts:
    """Per-step-shape index vectors, built once per phase (the JAX scan
    body gets the same hoisting from jit)."""

    def __init__(self, di, N: int, G: int):
        dev = di.device
        B = di.n_outcomes
        self.bases = torch.arange(1, 5, dtype=I32, device=dev)
        self.g = torch.arange(G, dtype=I32, device=dev)
        self.arB = torch.arange(B, dtype=I32, device=dev)
        self.arN = torch.arange(N, dtype=I32, device=dev)
        self.onesN = torch.ones(N, dtype=I32, device=dev)
        self.gB = self.g[:, None] * B + self.arB[None, :]      # (G,B)
        self.out_cat = torch.cat([di.out_lo, di.out_hi])        # (2L,B)


def _hits_and_newborns(di, k: _Consts, G: int, N: int, cnt, active,
                       cols, hit_field_of, occ_rows, log_base):
    """Shared middle of the wide and narrow steps: global hit
    enumeration, marker rank -> jump locus, outcome intervals and LF of
    the newborns. ``cols`` are the per-state fields gathered per hit
    after start_of: the hit field, base, pref, rid (and the narrow
    step's single flag). ``hit_field_of`` maps the gathered (G, C) hit
    rows and hit_pos to the jump locus."""
    B = di.n_outcomes
    L = di.out_lo.shape[0]
    nz = cnt > 0
    nzi = _i32(nz)
    two = cumsum(torch.stack([cnt, nzi]))                  # (2,N)
    cum, nzc = two[0], two[1]
    total = cum[-1]
    start_of = cum - cnt                                   # (N,)
    rank = nzc - nzi                                       # run index
    # hit -> owning state: run starts come in increasing state order,
    # so owner(g) = nz_states[#run_starts_at_or_before_g - 1]; both
    # scatters share one (2G+1,) buffer (slot 2G = dump)
    sc_idx = torch.cat([
        torch.where(nz & (rank < G), rank, 2 * G),
        torch.where(nz & (start_of < G), G + start_of, 2 * G)])
    sc = _scatter_rows(torch.zeros(2 * G + 1, dtype=I32, device=cnt.device),
                       sc_idx, torch.cat([k.arN, k.onesN]))
    nz_states, starts01 = sc[:G], sc[G:2 * G]
    rank_of_g = cumsum(starts01)
    s_of_g = nz_states[(rank_of_g - 1).clamp(0, G - 1)].clamp(0, N - 1)
    hit_ok = k.g < total.clamp(max=G)
    # every per-hit state field in ONE (N,C) stacked gather
    hit_cols = torch.stack([start_of] + cols, dim=1)[s_of_g]   # (G,C)
    hit_pos = hit_cols[:, 1] + (k.g - hit_cols[:, 0])
    j_base = hit_cols[:, 2]                                # (G,)
    # states whose hits spill past the budget flag their read
    spilled = active & (cum > G) & (cnt > 0)
    loc = torch.where(hit_ok, hit_field_of(hit_cols, hit_pos), -1)  # (G,)

    li = loc.clamp(0, L - 1)
    jbound = k.out_cat[torch.cat([li, li + L])]            # (2G,B)
    j_lo, j_hi = jbound[:G], jbound[G:]
    cand_ok = (loc >= 0)[:, None] & (j_lo >= 0)
    jrows = occ_rows(torch.cat([j_lo, j_hi + 1]))          # (2G,B,4)
    jrow_lo, jrow_hi = jrows[:G], jrows[G:]
    j_onehot = (j_base[:, None] == k.bases)[:, None, :]    # (G,1,4)
    j_first = di.sym_start[j_base.clamp(0, 4)][:, None]
    e_lo = j_first + (jrow_lo * j_onehot).sum(dim=2, dtype=I32)
    e_hi = j_first + (jrow_hi * j_onehot).sum(dim=2, dtype=I32) - 1
    cand_ok = cand_ok & (e_lo <= e_hi)

    # genealogy log records for this step's candidates
    rec_parent = hit_cols[:, 3][:, None].expand(G, B)
    rec_event = li[:, None] * B + k.arB[None, :]           # (G,B)
    c_pref = log_base + k.gB
    c_rid = hit_cols[:, 4][:, None].expand(G, B)
    return (spilled, cand_ok, e_lo, e_hi, c_pref, c_rid,
            rec_parent, rec_event)


def _lf_extend(di, k: _Consts, occ_rows, lo, hi, base):
    """LF-extension of [lo, hi] by base plus the marker counts at both
    ends (one (2n,) occ gather)."""
    n = lo.shape[0]
    rows2 = occ_rows(torch.cat([lo, hi + 1]))              # (2n,4)
    row_lo, row_hi = rows2[:n], rows2[n:]
    onehot = base[:, None] == k.bases                      # (n,4)
    first = di.sym_start[base.clamp(0, 4)]
    nlo = first + (row_lo * onehot).sum(dim=1, dtype=I32)
    nhi = first + (row_hi * onehot).sum(dim=1, dtype=I32) - 1
    # markers in bwt[0:i) = i - #dna(<i) - #sentinel(<i)
    sent = di.sentinel_row
    m_lo = lo - row_lo.sum(dim=1, dtype=I32) - _i32(lo > sent)
    m_hi = (hi + 1) - row_hi.sum(dim=1, dtype=I32) - _i32(hi + 1 > sent)
    return nlo, nhi, m_lo, m_hi


def build_log_step(di, cfg, num_reads: int, occ_rows=None):
    """Wide step (port of _build_log_step). occ_rows: (rows) -> (...,4)
    gather over the occ table; default the dense di.occ gather."""
    B = di.n_outcomes
    N = cfg.pool
    G = cfg.hits
    if occ_rows is None:
        occ_rows = dense_occ_rows(di)
    mrl = di.marker_rank_locus
    n_mrl = mrl.shape[0]
    k = _Consts(di, N, G)
    fills = torch.zeros(4, dtype=I32, device=di.device)
    fills[:1].fill_(-1)

    def hit_field_of(hit_cols, hit_pos):
        return mrl[hit_pos.clamp(0, n_mrl - 1)]

    def step(carry, base_row, log_base):
        read_id, lo, hi, pref, overflow = carry
        valid = read_id >= 0
        rid = read_id.clamp(0, num_reads - 1)
        base = torch.where(valid, base_row[rid], 0)        # (N,)
        active = valid & (base > 0)

        nlo, nhi, m_lo, m_hi = _lf_extend(di, k, occ_rows, lo, hi, base)
        ext_alive = active & (nlo <= nhi)
        kept_lo = torch.where(active, nlo, lo)
        kept_hi = torch.where(active, nhi, hi)
        keep = ext_alive | (valid & ~active)               # padding steps persist
        cnt = torch.where(active, m_hi - m_lo, 0)          # (N,)

        (spilled, cand_ok, e_lo, e_hi, c_pref, c_rid, rec_parent,
         rec_event) = _hits_and_newborns(
            di, k, G, N, cnt, active, [m_lo, base, pref, rid], hit_field_of,
            occ_rows, log_base)

        # dense repack: survivors then newborns
        flags = torch.cat([keep, cand_ok.reshape(-1)])
        pos = cumsum(flags) - 1
        dest = torch.where(flags & (pos < N), pos, N)      # N = dump slot
        all_rid = torch.cat([rid, c_rid.reshape(-1)])
        dropped = flags & (pos >= N)
        ovf_idx = torch.cat([torch.where(spilled, rid, num_reads),
                             torch.where(dropped, all_rid, num_reads)])
        overflow = _set_flags(overflow, ovf_idx)

        cat = torch.stack([
            torch.cat([torch.where(keep, read_id, -1),
                       torch.where(cand_ok, c_rid, -1).reshape(-1)]),
            torch.cat([kept_lo, e_lo.reshape(-1)]),
            torch.cat([kept_hi, e_hi.reshape(-1)]),
            torch.cat([pref, c_pref.reshape(-1)]),
        ], dim=1)                                          # (N+GB, 4)
        out = _scatter_rows(fills.expand(N + 1, 4), dest, cat)[:N]
        return ((out[:, 0], out[:, 1], out[:, 2], out[:, 3], overflow),
                (rec_parent, rec_event))

    return step


def build_narrow_step(di, cfg, num_reads: int, wide_budget: int,
                      occ_rows=None, locked: bool = False, narrow_rows=None):
    """Narrow-interval step (port of _build_narrow_step): one packed
    narrow_tab gather per singleton state, the classic sub-path for up
    to ``wide_budget`` wide states. locked=False hole-allocates the
    pool; locked=True pins slot i to read i (pool == num_reads).
    narrow_rows: (rows) -> packed narrow_tab entries; default the
    di.narrow_tab gather (the SA-range-sharded index injects its own)."""
    B = di.n_outcomes
    N = cfg.pool
    G = cfg.hits
    W = wide_budget
    n = di.size
    if occ_rows is None:
        occ_rows = dense_occ_rows(di)
    if narrow_rows is None:
        narrow_rows = lambda rows: di.narrow_tab[rows.clamp(0, n - 1)]
    mrl = di.marker_rank_locus
    n_mrl = mrl.shape[0]
    HB = G * B
    if locked and N != num_reads:
        raise ValueError(f"locked step needs pool == num_reads, got "
                         f"{N} and {num_reads}")
    k = _Consts(di, N, G)
    dev = di.device
    arN = k.arN
    arHB_fill = torch.full((HB + 1,), N, dtype=I32, device=dev)
    w_fill = torch.full((W + 1,), N, dtype=I32, device=dev)
    wball_fill = torch.zeros((N + 1, 4), dtype=I32, device=dev)
    dump_row = torch.full((1, 4), -1, dtype=I32, device=dev)
    if locked:
        nb_zero = torch.zeros(N + 1, dtype=I32, device=dev)
        ones_hb = torch.ones(HB, dtype=I32, device=dev)

    def hit_field_of(hit_cols, hit_pos):
        # hitfield: marker rank (wide) or the jump locus itself (narrow)
        direct = hit_cols[:, 5] == 1
        return torch.where(direct, hit_cols[:, 1],
                           mrl[hit_pos.clamp(0, n_mrl - 1)])

    def step(carry, base_row, log_base):
        read_id, lo, hi, pref, overflow = carry
        valid = read_id >= 0
        if locked:
            rid = arN                                      # slot i <-> read i
            base = torch.where(valid, base_row, 0)         # no gather
        else:
            rid = read_id.clamp(0, num_reads - 1)
            base = torch.where(valid, base_row[rid], 0)
        active = valid & (base > 0)
        single = lo == hi

        # 1. narrow path: ONE packed int32 gather per state
        t = narrow_rows(lo)
        sym = t >> 24                 # 0 sentinel, 1-4 DNA, 5 marker
        val = t & 0xFFFFFF            # LF destination / jump locus

        # 2. wide sub-path: classic occ rows for <= W wide states
        wideflag = active & ~single
        w_ord = cumsum(wideflag)
        w_rank = w_ord - _i32(wideflag)
        w_slot = _scatter_rows(
            w_fill, torch.where(wideflag & (w_rank < W), w_rank, W), arN)
        w_idx = w_slot[:W].clamp(0, N - 1)
        w_live = w_slot[:W] < N
        w_lo, w_hi, w_base = lo[w_idx], hi[w_idx], base[w_idx]
        w_nlo, w_nhi, w_mlo, w_mhi = _lf_extend(di, k, occ_rows, w_lo, w_hi,
                                                w_base)
        wcols = torch.stack([w_nlo, w_nhi, w_mlo, w_mhi], dim=1)
        wball = _scatter_rows(wball_fill, torch.where(w_live, w_idx, N),
                              wcols)[:N]
        covered = single | (wideflag & (w_rank < W))
        spill_w = wideflag & (w_rank >= W)

        # 3. merged extension + marker counts
        nlo = torch.where(single, val, wball[:, 0])
        nhi = torch.where(single, val, wball[:, 1])
        ok = torch.where(single, sym == base, wball[:, 0] <= wball[:, 1])
        ext_alive = active & covered & ok
        kept_lo = torch.where(active & covered, nlo, lo)
        kept_hi = torch.where(active & covered, nhi, hi)
        keep = ext_alive | (valid & ~active)               # padding steps persist
        cnt = torch.where(active & covered,
                          torch.where(single, _i32(sym == 5),
                                      wball[:, 3] - wball[:, 2]), 0)

        # 4-5. hit enumeration, loci, newborns: as the wide step
        hitfield = torch.where(single, val, wball[:, 2])
        (spilled, cand_ok, e_lo, e_hi, c_pref, c_rid, rec_parent,
         rec_event) = _hits_and_newborns(
            di, k, G, N, cnt, active,
            [hitfield, base, pref, rid, _i32(single)], hit_field_of,
            occ_rows, log_base)

        cand = cand_ok.reshape(-1)                         # (HB,)
        all_rid_c = c_rid.reshape(-1)
        up = torch.stack([torch.where(keep, read_id, -1),
                          kept_lo, kept_hi, pref], dim=1)  # (N,4)
        ncols = torch.stack([all_rid_c, e_lo.reshape(-1),
                             e_hi.reshape(-1), c_pref.reshape(-1)], dim=1)
        if locked:
            # 6L. slot-locked placement: newborn -> its read's slot;
            # per-read newborn count, a read may hold ONE state
            nb_cnt = nb_zero.index_add(
                0, torch.where(cand, all_rid_c, N), ones_hb)[:N]
            conflict = (nb_cnt > 1) | ((nb_cnt == 1) & keep)
            rc = all_rid_c.clamp(0, N - 1)
            place = cand & (nb_cnt[rc] == 1) & ~keep[rc]
            dest = torch.where(place, all_rid_c, N)
            # overflow: all flag classes are (N,) slot-aligned vectors
            overflow = torch.cat([
                overflow[:N] | spilled | spill_w | conflict, overflow[N:]])
            out = _scatter_rows(torch.cat([up, dump_row]), dest, ncols)[:N]
            # conflicted reads are host-bound: clear the slot so their
            # half-complete state never reaches the result merge
            rid_out = torch.where(conflict, -1, out[:, 0])
            return ((rid_out, out[:, 1], out[:, 2], out[:, 3], overflow),
                    (rec_parent, rec_event))

        # 6. hole allocation: newborns scatter into dead slots
        hole = ~keep
        h_ord = cumsum(hole)
        c_ord = cumsum(cand)
        h_rank = h_ord - _i32(hole)
        c_rank = c_ord - _i32(cand)
        n_holes = h_ord[-1]
        slot_of_rank = _scatter_rows(
            arHB_fill, torch.where(hole & (h_rank < HB), h_rank, HB),
            arN)[:HB]
        placed_ok = cand & (c_rank < n_holes.clamp(max=HB))
        dest = torch.where(placed_ok,
                           slot_of_rank[c_rank.clamp(0, HB - 1)], N)
        dropped = cand & ~placed_ok
        ovf_idx = torch.cat([
            torch.where(spilled | spill_w, rid, num_reads),
            torch.where(dropped, all_rid_c, num_reads)])
        overflow = _set_flags(overflow, ovf_idx)
        out = _scatter_rows(torch.cat([up, dump_row]), dest, ncols)[:N]
        return ((out[:, 0], out[:, 1], out[:, 2], out[:, 3], overflow),
                (rec_parent, rec_event))

    return step


def lock_pool(carry, pool: int, num_reads: int):
    """Transition into a slot-locked phase: scatter each read's SOLE
    live state into slot rid; reads holding >1 state are flagged
    overflow for the exact host path. pool == num_reads."""
    read_id, lo, hi, pref, overflow = carry
    R = pool
    dev = read_id.device
    valid = read_id >= 0
    ridc = read_id.clamp(0, R - 1)
    cnt = torch.zeros(R + 1, dtype=I32, device=dev).index_add(
        0, torch.where(valid, ridc, R),
        torch.ones_like(ridc))[:R]
    overflow = torch.cat([overflow[:R] | (cnt > 1), overflow[R:]])
    place = valid & (cnt[ridc] == 1)
    dest = torch.where(place, ridc, R)
    cat = torch.stack([ridc, lo, hi, pref], dim=1)
    out = _scatter_rows(torch.full((R + 1, 4), -1, dtype=I32, device=dev),
                        dest, cat)[:R]
    # unplaced slots: read_id -1, numeric fields zeroed
    placed = out[:, 0] >= 0
    return (out[:, 0], torch.where(placed, out[:, 1], 0),
            torch.where(placed, out[:, 2], 0),
            torch.where(placed, out[:, 3], 0), overflow)


def resize_pool(carry, pool: int, num_reads: int):
    """Live states are dense-packed at the pool front, so shrinking is
    slicing; states sliced off flag their read for exact host
    re-mapping."""
    read_id, lo, hi, pref, overflow = carry
    N = read_id.shape[0]
    if N == pool:
        return carry
    if N > pool:
        tail = read_id[pool:]
        overflow = _set_flags(overflow,
                              torch.where(tail >= 0, tail, num_reads))
        return (read_id[:pool], lo[:pool], hi[:pool], pref[:pool], overflow)
    pad = pool - N
    z = lambda a: torch.cat([a, torch.zeros(pad, dtype=a.dtype,
                                            device=a.device)])
    return (torch.cat([read_id, torch.full((pad,), -1, dtype=read_id.dtype,
                                           device=read_id.device)]),
            z(lo), z(hi), z(pref), overflow)
