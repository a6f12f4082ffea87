"""Device-side selection and coverage recording for one scanned buffer.

Port of gramtools_tpu/mapping/record_jax.py: after the phased scan, on
the same device and without a host round trip,

  1. replay the genealogy log into every pool state's traversed and
     traversing paths (``replay_device``; K7, ops/replay.py);
  2. split no-path states into encapsulated pseudo-states, count
     non-variant occurrences, build each state's loci with their
     ancestor chains, flag duplicate sites and allele conflicts, group
     states into classes by their base-site key rows and pick one class
     per read with the mt19937 first draw (``select_and_record_device``,
     K8: on CUDA the hand kernels of csrc/select.cu through
     ops/select.py, on the CPU the plain version ``select_torch``);
  3. walk every selected occurrence base by base and add its per-node
     envelopes into the persistent ``cov_diff`` array
     (``_record_per_base_device``, K9: on CUDA the hand kernels of
     csrc/walk.cu through ops/walk.py, on the CPU the plain version).

Rows that hit a static budget or a rare edge case set a fallback bit
(``search_log_host.FB_*``) and contribute nothing here; the engine
re-maps them exactly on the host. All arithmetic is the JAX package's,
bit for bit; what differs, and why:

  * JAX drops out-of-range scatter writes (``mode="drop"``) and clamps
    gathers; torch raises. Every masked write goes to an explicit dump
    slot past the end, and only dump slots take duplicate writes.
  * ``lax.sort(..., num_keys=k)`` becomes stable sorts from the last key
    to the first (``_lexsort``). Where a sort carries non-key operands
    (the class sort and the plain version's emission sort), ties may
    come out in another order than XLA's; what is read from them (the
    selected states, the per-(row, node) envelopes) does not depend on
    that order. The CUDA per-base recorder does not sort at all: it
    folds the emissions into a (row, node) table (ops/walk.py). The
    CUDA selection sorts the loci lanes twice by radix on packed keys,
    and ranks each row's states' key rows a row at a time
    (csrc/select.cu).
  * The uint32 selection pick is done in int64 (every value < 2**32).
  * ``cov_diff`` is updated in place, which stands in for JAX's buffer
    donation.
  * Nothing reads a value back to the host: the whole record program
    is enqueued without a synchronisation.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .coverage_fast import SiteMeta
from .search import PrgIndex

from ..ops.replay import JumpOps, SeedPaths, replay
from ..ops.select import select_cuda, triples_cuda
from ..ops.walk import BIG, per_base_cuda, walk_torch
from .device_index import _as_i32 as _i32
from .search_log_host import (FB_CHAIN, FB_CONFLICT, FB_DUP_SITE, FB_EMIT,
                              FB_ENC, FB_KCAP, FB_LOCI, FB_RNG, FB_TRAV,
                              FB_TRIPS, FB_WALK, KCAP, MAX_CHAIN, TCAP,
                              buffer_caps)

I32 = torch.int32
I64 = torch.int64
_URNG_RANGE = (1 << 32) - 1
_PAD = -1            # key padding: sorts before any site marker (>= 5)


def step_table(nt_walk: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """(n_nodes, 8) int32: each node's nt_walk row (n_edges, seq_len,
    in_bubble, edge_off), then the targets of its out-edges 0 and 1
    (``edges[edge_off]``, ``edges[edge_off + 1]``; -1 where the node has
    fewer edges), then two zeros. The CUDA walk reads one 32-byte row a
    node and goes to the next node without a second load, except at an
    entry whose allele names an edge past the second."""
    n_edges, off = nt_walk[:, 0], nt_walk[:, 3]
    out = np.zeros((nt_walk.shape[0], 8), np.int64)
    out[:, :4] = nt_walk
    for k in (0, 1):
        has = n_edges > k
        out[:, 4 + k] = -1
        out[has, 4 + k] = edges[off[has] + k]
    return out


@dataclass
class RecordTables:
    """Graph and selection tables on the engine's device (the fields of
    record_jax.RecordTables that the record program reads)."""

    ra_node: torch.Tensor       # (len_prg,) PRG position -> node
    ra_offset: torch.Tensor     # (len_prg,) offset within the node's seq
    nt_site: torch.Tensor       # (n_nodes,) site marker or 0
    nt_allele: torch.Tensor     # (n_nodes,) allele (ALLELE_UNKNOWN = -1)
    nt_edges: torch.Tensor      # (n_edges,) CSR edge targets
    nt_cov_start: torch.Tensor  # (n_nodes,) flat coverage offset, -1 none
    anc_len: torch.Tensor       # (n_sites,) ancestor-chain lengths
    anc_site: torch.Tensor      # (n_sites, A)
    anc_allele: torch.Tensor    # (n_sites, A)
    base_site: torch.Tensor     # (n_sites,) level-1 ancestor marker
    nt_walk: torch.Tensor       # (n_nodes, 4) [n_edges, seq_len,
                                #  in_bubble, edge_off] per node
    nt_step: torch.Tensor       # (n_nodes, 8) nt_walk's row, then the
                                #  targets of edges 0 and 1 (-1 where
                                #  the node has fewer), 0, 0: the CUDA
                                #  walk's one load per node (port only)
    cov_size: int               # flat per-base coverage length
    n_nodes: int
    max_anc: int

    @classmethod
    def build(cls, idx: PrgIndex, device) -> "RecordTables":
        g = idx.graph
        nt = g.node_tables()
        sm = SiteMeta(idx)
        n_nodes = int(nt.seq_len.size)
        nt_walk = np.stack([nt.n_edges, nt.seq_len, nt.in_bubble,
                            nt.edge_offset[:n_nodes]], axis=1)
        return cls(
            ra_node=_i32(g.ra_node, device),
            ra_offset=_i32(g.ra_offset, device),
            nt_site=_i32(nt.site_id, device),
            nt_allele=_i32(nt.allele_id, device),
            nt_edges=_i32(nt.edges, device),
            nt_cov_start=_i32(nt.cov_start, device),
            anc_len=_i32(sm.anc_len, device),
            anc_site=_i32(sm.anc_site, device),
            anc_allele=_i32(sm.anc_allele, device),
            base_site=_i32(sm.base_site, device),
            nt_walk=_i32(nt_walk, device),
            nt_step=_i32(step_table(nt_walk, nt.edges), device),
            cov_size=int(g.coverage.size),
            n_nodes=n_nodes,
            max_anc=int(sm.max_depth),
        )


@dataclass
class SeedTables:
    """The kmer index's seed states, resident on the device: uploaded
    once per kmer index, then each buffer ships only the placed state
    indices. Paths are CSR-packed (most seed states carry 0-2 loci)."""

    k_lo: torch.Tensor       # (Ns,) seed SA interval lo
    k_hi: torch.Tensor       # (Ns,)
    paths: SeedPaths         # path lengths, CSR offsets and flat loci
    n_states: int

    @classmethod
    def build(cls, kmer_index, device) -> "SeedTables":
        def csr(arr, lens):
            lens64 = lens.astype(np.int64)
            off = np.zeros(lens64.size, np.int64)
            off[1:] = np.cumsum(lens64)[:-1]
            total = int(lens64.sum())
            rows = np.repeat(np.arange(lens64.size), lens64)
            slots = np.arange(total) - np.repeat(off, lens64)
            flat = (arr[rows, slots].astype(np.int32) if total
                    else np.zeros((1, 2), np.int32))
            return off, flat

        toff, t_flat = csr(kmer_index.trav, kmer_index.n_trav)
        ioff, i_flat = csr(kmer_index.ing, kmer_index.n_ing)
        return cls(
            k_lo=_i32(kmer_index.lo, device),
            k_hi=_i32(kmer_index.hi, device),
            paths=SeedPaths(
                k_nt=_i32(kmer_index.n_trav, device),
                k_ni=_i32(kmer_index.n_ing, device),
                k_toff=_i32(toff, device), k_ioff=_i32(ioff, device),
                t_flat=_i32(t_flat, device), i_flat=_i32(i_flat, device),
                max_path=int(kmer_index.trav.shape[1])),
            n_states=int(kmer_index.lo.size),
        )


# --------------------------------------------------------------------------
# stage 1: genealogy replay
# --------------------------------------------------------------------------

def replay_device(di, f_pref, log_parent, log_event, st: SeedTables, alive,
                  stage: int = 99):
    """Rebuild (trav (N, TCAP, 2), n_trav, ing (N, TCAP, 2), n_ing, bad)
    for every pool state (see ops/replay.py). f_pref: (N,) genealogy
    refs (negative = seed-state index -p-1 into the resident
    SeedTables); alive: (N,) bool. stage < 99 stops early, as the JAX
    function does (profiling only; ops/replay.py)."""
    O = di.n_ops
    ops = JumpOps(di.ops_kind.reshape(-1, O), di.ops_site.reshape(-1, O),
                  di.ops_allele.reshape(-1, O))
    return replay(f_pref, alive, log_parent, log_event, st.paths, ops,
                  MAX_CHAIN, TCAP, stage)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _arange(n: int, dev, dtype=I32) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=dev)


def _expand_budget(widths, cap: int):
    """Per-item [0, width) expansion into a static budget of ``cap``
    lanes. Returns (item_of (cap,), offset (cap,), valid (cap,),
    spilled (M,) -- the item had occurrences past the cap). item_of
    comes from marking each run's start lane with item + 1, then a
    prefix max (run starts are strictly increasing, so marks never
    collide; lane ``cap`` is the dump slot)."""
    widths = widths.to(I32)
    dev = widths.device
    M = widths.shape[0]
    cum = torch.cumsum(widths, 0, dtype=I32)
    total = cum[-1]
    start = cum - widths
    nz = widths > 0
    g = _arange(cap, dev)
    dest = torch.where(nz & (start < cap), start.clamp(0, cap - 1), cap)
    marks = torch.zeros(cap + 1, dtype=I32, device=dev).scatter_reduce_(
        0, dest.to(I64), _arange(M, dev) + 1, "amax")
    item_of = (torch.cummax(marks[:cap], 0).values - 1).clamp(0, max(M - 1, 0))
    valid = g < total.clamp(max=cap)
    offset = g - start[item_of]
    spilled = nz & (cum > cap)
    return item_of, offset, valid, spilled


def _segment_first(group_start_flags):
    """Index of each element's group start (prefix max of flagged idx)."""
    n = group_start_flags.shape[0]
    idx = torch.where(group_start_flags, _arange(n, group_start_flags.device),
                      0)
    return torch.cummax(idx, 0).values


def _flag_rows(R, cond, rows):
    """(R,) bool with True at rows[i] where cond[i] (slot R = dump)."""
    dest = torch.where(cond, rows, R).to(I64)
    return torch.zeros(R + 1, dtype=torch.bool, device=rows.device
                       ).index_fill_(0, dest, True)[:R]


def _flag_rows_bit(R, cond, rows, bit):
    """(R,) int32 with ``bit`` at rows[i] where cond[i]."""
    dest = torch.where(cond, rows, R).to(I64)
    return torch.zeros(R + 1, dtype=I32, device=rows.device
                       ).index_fill_(0, dest, bit)[:R]


def _bit_where(cond, bit):
    """(n,) int32: ``bit`` where cond, else 0."""
    return cond.to(I32) * bit


def _neighbor_diff(*cols):
    """Element i differs from i-1 in any column (True at i=0)."""
    out = None
    for c in cols:
        d = torch.cat([torch.ones(1, dtype=torch.bool, device=c.device),
                       c[1:] != c[:-1]])
        out = d if out is None else (out | d)
    return out


def _count_rows(R, cond, rows):
    """(R,) int32 count of i with cond[i] per rows[i] (slot R = dump)."""
    dest = torch.where(cond, rows, R).to(I64)
    return torch.zeros(R + 1, dtype=I32, device=rows.device).index_add_(
        0, dest, torch.ones(dest.shape[0], dtype=I32, device=rows.device))[:R]


def _lexsort(keys, *operands):
    """Stable lexicographic sort by ``keys`` (first key most
    significant): ``lax.sort(keys + operands, num_keys=len(keys))``.
    Returns the sorted keys then the operands in the same order."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else k[perm]
        order = torch.sort(kk, stable=True).indices
        perm = order if perm is None else perm[order]
    return [k[perm] for k in keys] + [o[perm] for o in operands]


# --------------------------------------------------------------------------
# stages 2-5
# --------------------------------------------------------------------------

def select_and_record_device(di, rt: RecordTables,
                             f_rid, f_lo, f_hi, trav, n_trav, ing, n_ing,
                             state_bad, row_ok, row_first_raw, row_len,
                             cov_diff, trip_cap: int = 0, stage: int = 99):
    """Selection + recording for one scanned buffer.

    Pool states (N,): f_rid, f_lo, f_hi, the replayed paths and
    state_bad; rows (R,): row_ok, row_first_raw (the mt19937 first draw,
    values in [0, 2**32), any integer type) and row_len; cov_diff:
    (cov_size + 1,) int32, added into IN PLACE. Returns (fallback (R,)
    int32 reason bits, mapped (R,) bool, trip_row, trip_site,
    trip_allele) -- the trip arrays are (trip_cap,) sorted by (row,
    site, allele), row > R marking unused slots.

    ``stage`` is the JAX function's profiling argument
    (GRAMTOOLS_TPU_RECORD_STAGE; the default 99 runs everything): a
    value below 99 returns after the numbered block, with the fallback
    bits so far, ``mapped`` all False, ``trip_row`` all R + 1 and zero
    sites and alleles, so that a block's device time is the difference
    of two prefixes. ``cov_diff`` is added into from stage 6 on.

    CUDA tensors run K8's hand kernels (ops/select.py, csrc/select.cu)
    with K9 between their two launches; CPU tensors the plain version,
    ``select_torch``; the two are the same function. The budgets
    (``buffer_caps``) and ``KCAP`` are read here at each call."""
    if trip_cap <= 0:
        trip_cap = 16 * row_ok.shape[0]
    args = (di, rt, f_rid, f_lo, f_hi, trav, n_trav, ing, n_ing, state_bad,
            row_ok, row_first_raw, row_len, cov_diff, trip_cap, stage)
    if f_rid.device.type == "cuda":
        return _select_cuda(*args)
    if f_rid.device.type == "cpu":
        return select_torch(*args)
    raise ValueError(f"selection: unsupported device {f_rid.device}")


def _stage_out(fallback, trip_cap: int):
    """A stage's early return: the fallback bits so far, nothing mapped,
    no triples."""
    R, dev = fallback.shape[0], fallback.device
    z = torch.zeros(trip_cap, dtype=I32, device=dev)
    return (fallback, torch.zeros(R, dtype=torch.bool, device=dev),
            torch.full((trip_cap,), R + 1, dtype=I32, device=dev), z,
            z.clone())


def _select_cuda(di, rt: RecordTables, f_rid, f_lo, f_hi, trav, n_trav,
                 ing, n_ing, state_bad, row_ok, row_first_raw, row_len,
                 cov_diff, trip_cap: int, stage: int):
    """K8 on CUDA: stages 0-5 in ``select_cuda``'s launch, K9
    (``_record_per_base_device``) on its state table and selected
    states, then the triples in ``triples_cuda``'s launch."""
    R = row_ok.shape[0]
    ecap, trcap, wcap, emitcap, lcap = buffer_caps(R)
    sel = select_cuda(
        di.sa[:di.size], rt.ra_node, rt.nt_site, rt.nt_allele, rt.anc_len,
        rt.anc_site, rt.anc_allele, rt.base_site, max(rt.max_anc, 0),
        f_rid, f_lo, f_hi, trav, n_trav, ing, n_ing, state_bad, row_ok,
        row_first_raw.to(I64), ecap, lcap, trcap, KCAP, trip_cap,
        stage if stage <= 5 else 99)
    if stage <= 5:
        return _stage_out(sel.fallback, trip_cap)
    fallback = _record_per_base_device(
        di, rt, sel.ps_row, sel.ps_lo, sel.ps_hi, sel.ps_trav, sel.ps_ntrav,
        sel.st_selected, row_len, sel.fallback, cov_diff, wcap, emitcap)
    if stage <= 6:
        return _stage_out(fallback, trip_cap)
    return (fallback, sel.mapped) + triples_cuda(sel, fallback, trip_cap)


def select_torch(di, rt: RecordTables, f_rid, f_lo, f_hi, trav, n_trav,
                 ing, n_ing, state_bad, row_ok, row_first_raw, row_len,
                 cov_diff, trip_cap: int, stage: int):
    """The plain version of ``select_and_record_device`` (its arguments,
    ``trip_cap`` > 0), in torch ops."""
    dev = f_rid.device
    N = f_rid.shape[0]
    R = row_ok.shape[0]
    ecap, trcap, wcap, emitcap, lcap = buffer_caps(R)

    n_ra = rt.ra_node.shape[0]
    ar_n = _arange(N, dev, I64)
    rid_c = f_rid.clamp(0, R - 1)
    alive = (f_rid >= 0) & row_ok[rid_c]
    fallback = _flag_rows_bit(R, state_bad & alive, rid_c, FB_CHAIN)
    if stage <= 0:                     # the floor: the inputs' plumbing
        return _stage_out(fallback, trip_cap)

    has_path = (n_trav > 0) | (n_ing > 0)

    # ---- encapsulated split of no-path states ------------------------------
    np_mask = alive & ~has_path
    widths = torch.where(np_mask, f_hi - f_lo + 1, 0)
    e_item, e_off, e_valid, e_spill = _expand_budget(widths, ecap)
    fallback |= _flag_rows_bit(R, e_spill, rid_c, FB_ENC)
    occ_sa = (f_lo[e_item] + e_off).clamp(0, di.size - 1)
    occ_node = rt.ra_node[di.sa[occ_sa].clamp(0, n_ra - 1)]
    occ_site = torch.where(e_valid, rt.nt_site[occ_node], 0)
    occ_allele = rt.nt_allele[occ_node]
    occ_row = rid_c[e_item]
    nonvar = _count_rows(R, e_valid & (occ_site == 0), occ_row)

    # run-merge consecutive same-(item, site, allele) occurrences: each
    # run becomes one encapsulated pseudo-state at its start lane
    enc = e_valid & (occ_site > 0)
    prev_same = torch.cat([
        torch.zeros(1, dtype=torch.bool, device=dev),
        (e_item[1:] == e_item[:-1]) & (occ_site[1:] == occ_site[:-1])
        & (occ_allele[1:] == occ_allele[:-1]) & enc[:-1] & enc[1:]])
    enc_start = enc & ~prev_same
    nxt_same = torch.cat([prev_same[1:],
                          torch.zeros(1, dtype=torch.bool, device=dev)])
    run_first = _segment_first(enc_start | ~enc)
    enc_hi = torch.zeros(ecap + 1, dtype=I32, device=dev).index_put_(
        (torch.where(enc & ~nxt_same, run_first, ecap).to(I64),),
        occ_sa)[:ecap]

    # ---- unified state table: N pool states then ecap enc lanes ------------
    NS = N + ecap
    live_path = alive & has_path
    ps_row = torch.cat([rid_c, occ_row])
    ps_live = torch.cat([live_path, enc_start])
    ps_lo = torch.cat([f_lo, occ_sa])
    ps_hi = torch.cat([f_hi, enc_hi])
    ps_ntrav = torch.cat([torch.where(live_path, n_trav, 0),
                          enc_start.to(I32)])
    ps_ning = torch.cat([torch.where(live_path, n_ing, 0),
                         torch.zeros(ecap, dtype=I32, device=dev)])
    enc_trav = torch.zeros((ecap, TCAP, 2), dtype=I32, device=dev)
    enc_trav[:, 0, 0] = torch.where(enc_start, occ_site, 0)
    enc_trav[:, 0, 1] = torch.where(enc_start, occ_allele, 0)
    ps_trav = torch.cat([trav, enc_trav], dim=0)
    last_i = (n_ing - 1).clamp(0, TCAP - 1).to(I64)
    ing_parent = torch.cat([torch.where(n_ing > 0, ing[ar_n, last_i, 0], 0),
                            torch.zeros(ecap, dtype=I32, device=dev)])
    if stage <= 1:                     # + encapsulated split, state table
        return _stage_out(fallback, trip_cap)

    # ---- site-uniqueness (duplicate site within one state's own path) ------
    slot = _arange(TCAP, dev)[None, :]
    own_t = torch.where(slot < ps_ntrav[:, None], ps_trav[:, :, 0],
                        2 ** 28 + slot)
    ing_pad = torch.cat([ing, torch.zeros((ecap, TCAP, 2), dtype=I32,
                                          device=dev)], dim=0)
    own_i = torch.where(slot < ps_ning[:, None], ing_pad[:, :, 0],
                        2 ** 28 + TCAP + slot)
    own = torch.sort(torch.cat([own_t, own_i], dim=1), dim=1).values
    dup_site = (own[:, 1:] == own[:, :-1]).any(dim=1) & ps_live
    fallback |= _flag_rows_bit(R, dup_site, ps_row, FB_DUP_SITE)
    if stage <= 2:                     # + duplicate-site check
        return _stage_out(fallback, trip_cap)

    # ---- loci: traversed + traversing-derived + ancestors -------------------
    t_counts = torch.where(ps_live, ps_ntrav, 0)
    li_item, li_off, li_valid, li_spill = _expand_budget(t_counts, lcap)
    fallback |= _flag_rows_bit(R, li_spill, ps_row, FB_LOCI)
    l1_pair = ps_trav[li_item, li_off.clamp(0, TCAP - 1)]     # (lcap, 2)
    l1_site = l1_pair[:, 0]
    l1_allele = l1_pair[:, 1]

    tr_w = torch.where(ps_live & (ps_ning > 0), ps_hi - ps_lo + 1, 0)
    tr_item, tr_off, tr_valid, tr_spill = _expand_budget(tr_w, trcap)
    fallback |= _flag_rows_bit(R, tr_spill, ps_row, FB_TRAV)
    tr_sa = (ps_lo[tr_item] + tr_off).clamp(0, di.size - 1)
    tr_node = rt.ra_node[di.sa[tr_sa].clamp(0, n_ra - 1)]
    l2_site = torch.where(tr_valid, ing_parent[tr_item], 0)
    l2_allele = rt.nt_allele[tr_node]

    base_state = torch.cat([li_item, tr_item])
    base_site_m = torch.cat([l1_site, l2_site])
    base_allele = torch.cat([l1_allele, l2_allele])
    base_valid = torch.cat([li_valid, tr_valid]) & (base_site_m >= 5)

    A = max(rt.max_anc, 0)
    sidx = torch.div(base_site_m - 5, 2, rounding_mode="floor").clamp(
        0, rt.anc_len.shape[0] - 1)
    parts = [(base_state, base_site_m, base_allele, base_valid)]
    for a in range(A):
        parts.append((base_state, rt.anc_site[sidx, a], rt.anc_allele[sidx, a],
                      base_valid & (a < rt.anc_len[sidx])))
    l_state = torch.cat([p[0] for p in parts])
    l_site = torch.cat([p[1] for p in parts])
    l_allele = torch.cat([p[2] for p in parts])
    l_valid = torch.cat([p[3] for p in parts])

    # ---- dedup loci per (state, site, allele); conflicts -> fallback --------
    l_key = torch.where(l_valid, l_state, NS + 1)   # invalid sorts last
    trip_state, trip_site, trip_allele = _lexsort([l_key, l_site, l_allele])
    k_valid = trip_state <= NS
    uniq = _neighbor_diff(trip_state, trip_site, trip_allele)
    trip_keep = uniq & k_valid
    trip_state = trip_state.clamp(0, NS - 1)
    same_ss = (trip_keep & ~_neighbor_diff(trip_state, trip_site)
               & torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                            trip_keep[:-1]]))
    fallback |= _flag_rows_bit(R, same_ss, ps_row[trip_state], FB_CONFLICT)
    LT = trip_state.shape[0]
    if stage <= 3:                     # + loci, ancestors, dedup sort
        return _stage_out(fallback, trip_cap)

    # ---- base-site key rows per state ---------------------------------------
    b_base = rt.base_site[torch.div(trip_site - 5, 2, rounding_mode="floor")
                          .clamp(0, rt.base_site.shape[0] - 1)]
    b_key = torch.where(trip_keep, trip_state, NS + 1)
    kb_state, kb_site = _lexsort([b_key, b_base])
    b_uniq = _neighbor_diff(kb_state, kb_site) & (kb_state <= NS)
    st_start = _neighbor_diff(kb_state)
    # position of each unique (state, base) within its state: count of
    # unique entries since the state's first element
    uniq_cum = torch.cumsum(b_uniq.to(I32), 0, dtype=I32)
    first_idx = _segment_first(st_start)
    uniq_before_state = torch.where(
        first_idx > 0, uniq_cum[(first_idx - 1).clamp(min=0)], 0)
    pos_in_state = uniq_cum - 1 - uniq_before_state
    too_many = b_uniq & (pos_in_state >= KCAP)
    fallback |= _flag_rows_bit(R, too_many, ps_row[kb_state.clamp(0, NS - 1)],
                               FB_KCAP)
    key_mat = torch.full((NS + 1, KCAP), _PAD, dtype=I32, device=dev)
    key_mat.index_put_(
        (torch.where(b_uniq & ~too_many, kb_state, NS).to(I64),
         pos_in_state.clamp(0, KCAP - 1).to(I64)), kb_site)
    key_mat = key_mat[:NS]

    # ---- classes per row: lexicographic multi-key sort ----------------------
    sort_row = torch.where(ps_live, ps_row, R)
    sorted_ops = _lexsort([sort_row] + [key_mat[:, c] for c in range(KCAP)],
                          _arange(NS, dev))
    s_row = sorted_ops[0]
    s_keys = sorted_ops[1:KCAP + 1]
    s_state = sorted_ops[KCAP + 1]
    live_s = s_row < R
    new_row = _neighbor_diff(s_row)
    new_class = (new_row | _neighbor_diff(*s_keys)) & live_s
    class_id = torch.cumsum(new_class.to(I32), 0, dtype=I32) - 1
    row_first_class = class_id[_segment_first(new_row)]
    class_ord = class_id - row_first_class
    n_classes = _count_rows(R, new_class, s_row)

    # ---- uniform pick per row (libstdc++ uniform_int first draw) ------------
    # the uint32 arithmetic of the JAX code, in int64: every value < 2**32
    total = nonvar + n_classes
    active_row = n_classes > 0
    totals = total.clamp(min=1).to(I64)
    scaling = _URNG_RANGE // totals
    past = totals * scaling
    rdraw = row_first_raw.to(I64) & _URNG_RANGE
    fallback |= _bit_where(active_row & (rdraw >= past), FB_RNG)
    selected = 1 + (rdraw // scaling.clamp(min=1)).to(I32)
    chosen_ord = selected - nonvar - 1
    do_record = active_row & (chosen_ord >= 0) & (chosen_ord < n_classes)

    s_row_c = s_row.clamp(0, R - 1)
    sel_sorted = live_s & do_record[s_row_c] & (class_ord ==
                                                chosen_ord[s_row_c])
    st_selected = torch.zeros(NS, dtype=torch.bool, device=dev).scatter_(
        0, s_state.to(I64), sel_sorted)

    mapped = _flag_rows(R, alive, rid_c)  # any live state => "mapped"
    if stage <= 4:                     # + key rows, class sort, pick
        return _stage_out(fallback, trip_cap)

    # ---- preliminary triple-capacity check (BEFORE per-base recording, so
    # spilled rows can still fall back cleanly with zero device traces) ----
    t_row = ps_row[trip_state]
    t_sel = trip_keep & st_selected[trip_state] & (fallback[t_row] == 0)
    t_key = torch.where(t_sel, t_row, R + 1)
    if LT > trip_cap:
        over = torch.sort(t_key).values[trip_cap:]
        fallback |= _flag_rows_bit(R, over <= R, over.clamp(0, R - 1),
                                   FB_TRIPS)
    if stage <= 5:                     # + preliminary triple check
        return _stage_out(fallback, trip_cap)

    # ---- per-base coverage (may add fallback rows; do it before triples) ---
    fallback = _record_per_base_device(
        di, rt, ps_row, ps_lo, ps_hi, ps_trav, ps_ntrav, st_selected,
        row_len, fallback, cov_diff, wcap, emitcap)
    if stage <= 6:                     # + per-base coverage (K9)
        return _stage_out(fallback, trip_cap)

    # ---- triples of the chosen classes, compact prefix of the sort ----------
    t_sel = trip_keep & st_selected[trip_state] & (fallback[t_row] == 0)
    t_key = torch.where(t_sel, t_row, R + 1)
    trip_row_o, trip_site_o, trip_allele_o = _lexsort(
        [t_key, trip_site, trip_allele])
    pad = max(trip_cap - LT, 0)
    if pad:
        trip_row_o = torch.cat([trip_row_o, torch.full(
            (pad,), R + 1, dtype=I32, device=dev)])
        trip_site_o = torch.cat([trip_site_o, torch.zeros(
            pad, dtype=I32, device=dev)])
        trip_allele_o = torch.cat([trip_allele_o, torch.zeros(
            pad, dtype=I32, device=dev)])
    return (fallback, mapped, trip_row_o[:trip_cap], trip_site_o[:trip_cap],
            trip_allele_o[:trip_cap])


def _record_per_base_device(di, rt: RecordTables, ps_row, ps_lo, ps_hi,
                            ps_trav, ps_ntrav, st_selected, row_len,
                            fallback, cov_diff, wcap: int, emitcap: int):
    """Per-base coverage of the selected states (K9): adds their +1/-1
    envelope boundaries into ``cov_diff`` in place and returns fallback
    with its additions (FB_WALK, FB_EMIT). CUDA tensors run the hand
    kernels (ops/walk.py::per_base_cuda, csrc/walk.cu), CPU tensors the
    plain version (``_record_per_base_torch``); the two are the same
    function."""
    if ps_row.device.type == "cuda":
        return per_base_cuda(
            di.sa[:di.size], rt.ra_node, rt.ra_offset, rt.nt_step,
            rt.nt_edges, rt.nt_cov_start, ps_row, ps_lo, ps_hi, ps_trav,
            ps_ntrav, st_selected, row_len, fallback, cov_diff, wcap,
            emitcap, rt.n_nodes + 2)
    if ps_row.device.type == "cpu":
        return _record_per_base_torch(di, rt, ps_row, ps_lo, ps_hi, ps_trav,
                                      ps_ntrav, st_selected, row_len,
                                      fallback, cov_diff, wcap, emitcap)
    raise ValueError(f"per-base recorder: unsupported device {ps_row.device}")


def _record_per_base_torch(di, rt: RecordTables, ps_row, ps_lo, ps_hi,
                           ps_trav, ps_ntrav, st_selected, row_len,
                           fallback, cov_diff, wcap: int, emitcap: int):
    """The plain version: walk lanes = occurrence expansion of the
    selected states; the walk's emissions (row, node, start, end) -> one
    envelope per (row, node) by sorted segment min/max -> +1/-1 boundary
    adds into ``cov_diff`` (in place). Returns fallback with its
    additions."""
    R = row_len.shape[0]
    lanes, w_spill = _walk_lanes(di, rt, ps_row, ps_lo, ps_hi, ps_ntrav,
                                 st_selected, row_len, wcap)
    fallback = fallback | _flag_rows_bit(R, w_spill, ps_row, FB_WALK)
    emits, spill = walk_torch(rt.nt_walk, rt.nt_edges, *lanes, ps_trav,
                              emitcap, rt.n_nodes + 2)
    # emission spill: every read with a selected state falls back
    sel_rows = _flag_rows(R, st_selected, ps_row)
    fallback = fallback | _bit_where(spill & sel_rows, FB_EMIT)
    _add_envelopes(rt, emits, fallback, cov_diff)
    return fallback


def _walk_lanes(di, rt: RecordTables, ps_row, ps_lo, ps_hi, ps_ntrav,
                st_selected, row_len, wcap: int):
    """The selected states' SA occurrences expanded into ``wcap`` walk
    lanes. Returns (walk_torch's lane inputs (valid, cur0, start0,
    remaining0, trav_idx0, w_item, read_of, full), spilled (NS,): the
    state had occurrences past wcap)."""
    R = row_len.shape[0]
    w = torch.where(st_selected, ps_hi - ps_lo + 1, 0)
    w_item, w_off, w_valid, w_spill = _expand_budget(w, wcap)
    occ_sa = (ps_lo[w_item] + w_off).clamp(0, di.size - 1)
    prg_pos = di.sa[occ_sa].clamp(0, rt.ra_node.shape[0] - 1)
    read_of = ps_row[w_item].clamp(0, R - 1)
    return (w_valid, rt.ra_node[prg_pos], rt.ra_offset[prg_pos],
            row_len[read_of].to(I32), ps_ntrav[w_item].to(I32), w_item,
            read_of, w_off == 0), w_spill


def _add_envelopes(rt: RecordTables, emits, fallback, cov_diff):
    """Sort the (emitcap, 4) emissions by (row, node), take each group's
    min start and max end, and add +1/-1 at its boundaries into
    ``cov_diff`` where the row has no fallback bit and the node has
    coverage."""
    dev = emits.device
    R = fallback.shape[0]
    emitcap = emits.shape[0]
    k_row, k_node, s_s, en_s = _lexsort([emits[:, 0], emits[:, 1]],
                                        emits[:, 2], emits[:, 3])
    valid_e = k_row < BIG
    gstart = _neighbor_diff(k_row, k_node)
    dest = torch.where(valid_e, _segment_first(gstart), emitcap).to(I64)
    seg_min = torch.full((emitcap + 1,), BIG, dtype=I32, device=dev
                         ).scatter_reduce_(0, dest, s_s, "amin")[:emitcap]
    seg_max = torch.full((emitcap + 1,), -1, dtype=I32, device=dev
                         ).scatter_reduce_(0, dest, en_s, "amax")[:emitcap]
    is_rep = gstart & valid_e
    rep_node = k_node.clamp(0, rt.n_nodes - 1)
    rep_row = k_row.clamp(0, R - 1)
    covs = rt.nt_cov_start[rep_node]
    keep = is_rep & (fallback[rep_row] == 0) & (covs >= 0)
    # diff-array boundary adds; slot cov_size doubles as the dump slot
    # AND the legitimate end boundary of last-base ranges -- both lie past
    # the prefix-sum horizon, so the aliasing never reaches counts
    ones = torch.ones(emitcap, dtype=I32, device=dev)
    cov_diff.index_add_(0, torch.where(keep, covs + seg_min, rt.cov_size
                                       ).to(I64), ones)
    cov_diff.index_add_(0, torch.where(keep, covs + seg_max + 1, rt.cov_size
                                       ).to(I64), -ones)
