"""The phased scan, its flat result, and the fused record program.

Port of gramtools_tpu/mapping/search_jax_log.py ``_log_search_phases``,
``_occ_rows_for``, ``_packed_body``, ``_unpack_reads2`` and
``_record_body``: JAX's ``lax.scan`` over the steps of a phase becomes a
Python loop, and each step writes its genealogy records ``(rec_parent,
rec_event)`` straight into their place in a preallocated log.

``log_search_packed`` (the non-fused engine) returns one flat int32
result ``[rid | lo | hi | pref | ovf | lp | le]`` (final carry, overflow
flags, then the log parents and events of every step, phase by phase).
``log_search_record`` (the fused engine) keeps the log on the device,
replays it and records the buffer's coverage there (mapping/record.py),
and returns only ``[ovf | fallback | mapped | t_row | t_site |
t_allele]``. Nothing in either reads a value back to the host, so each
is enqueued without a synchronisation.
"""
from __future__ import annotations

import torch

from ..ops.rank import make_packed_occ_rows
from .record import replay_device, select_and_record_device
from .scan_steps import (build_log_step, build_narrow_step, lock_pool,
                         resize_pool)
from .search_log_host import LogConfig, _phase4

I32 = torch.int32


def occ_rows_for(di, blocks, rank: str):
    """Rank implementation for the occ gather: None = the dense
    (n+1, 4) table gather; "packed" = the bit-packed block rank
    (ops/rank.py: the CUDA kernel on a GPU, the torch twin on the CPU)."""
    if rank == "dense" or blocks is None:
        return None
    return make_packed_occ_rows(blocks, di.size)


def _scan_phases(di, reads, carry, phases, num_reads: int, occ_rows,
                 lp: torch.Tensor, le: torch.Tensor, narrow_rows=None):
    """The phase loop (port of _log_search_phases): runs every step of
    every phase on int32 reads (steps, num_reads), writes each step's
    genealogy records into their place in lp/le (preallocated, steps·G·B
    each), and returns the final carry with its (num_reads,) overflow.
    occ_rows / narrow_rows: the occ and narrow_tab gathers (None = the
    dense tables in di)."""
    dev = di.device
    B = di.n_outcomes
    read_id, lo, hi, pref, overflow = carry
    # one dump slot past the last read: see scan_steps
    overflow = torch.cat([overflow.to(torch.bool),
                          torch.zeros(1, dtype=torch.bool, device=dev)])
    carry = (read_id, lo, hi, pref, overflow)
    log_base = 0
    offset = 0
    for entry in phases:
        n_steps, pool, hits, narrow_w, kind = _phase4(entry)
        cfg = LogConfig(pool=pool, hits=hits)
        narrow_ok = narrow_w > 0 and (
            narrow_rows is not None or di.narrow_tab.shape[0] == di.size)
        if kind == "locked" and narrow_ok:
            carry = lock_pool(carry, pool, num_reads)
            step = build_narrow_step(di, cfg, num_reads, narrow_w,
                                     occ_rows=occ_rows, locked=True,
                                     narrow_rows=narrow_rows)
        elif narrow_ok:
            carry = resize_pool(carry, pool, num_reads)
            step = build_narrow_step(di, cfg, num_reads, narrow_w,
                                     occ_rows=occ_rows,
                                     narrow_rows=narrow_rows)
        else:
            carry = resize_pool(carry, pool, num_reads)
            step = build_log_step(di, cfg, num_reads, occ_rows=occ_rows)
        GB = hits * B
        for i in range(n_steps):
            carry, (rec_parent, rec_event) = step(
                carry, reads[offset + i], log_base)
            lp[log_base:log_base + GB] = rec_parent.reshape(-1)
            le[log_base:log_base + GB] = rec_event.reshape(-1)
            log_base += GB
        offset += n_steps
    rid, lo, hi, pref, overflow = carry
    return rid, lo, hi, pref, overflow[:num_reads]


def _log_length(di, phases) -> int:
    return sum(_phase4(e)[0] * _phase4(e)[2] for e in phases) * di.n_outcomes


def log_search_phases(di, reads_T: torch.Tensor, carry, phases,
                      num_reads: int, occ_rows=None, narrow_rows=None):
    """The phased scan with its log returned (port of
    _log_search_phases): reads_T (steps, num_reads) base codes; carry
    (read_id, lo, hi, pref, overflow (num_reads,)). Returns (final
    carry, (log_parent, log_event)). The data- and index-sharded scans
    (parallel/) run it per shard with their own gathers."""
    L = _log_length(di, phases)
    log = torch.empty(2 * L, dtype=I32, device=di.device)
    final = _scan_phases(di, reads_T.to(I32), carry, phases, num_reads,
                         occ_rows, log[:L], log[L:], narrow_rows=narrow_rows)
    return final, (log[:L], log[L:])


def log_search_packed(di, reads_T: torch.Tensor, carry, phases,
                      num_reads: int, blocks=None, rank: str = "dense"
                      ) -> torch.Tensor:
    """Phased scan + pack (port of _log_search_packed).

    reads_T: (steps, num_reads) uint8 base codes on di's device.
    carry: (read_id, lo, hi, pref) int32 of the first phase's pool size
    and overflow bool of num_reads, all on di's device. Returns the
    flat int32 result on the device."""
    N = _phase4(phases[-1])[1]
    L = _log_length(di, phases)
    head = 4 * N + num_reads
    flat = torch.empty(head + 2 * L, dtype=I32, device=di.device)
    # reads ship as uint8; widen on device where comparisons need int
    rid, lo, hi, pref, overflow = _scan_phases(
        di, reads_T.to(I32), carry, phases, num_reads,
        occ_rows_for(di, blocks, rank), flat[head:head + L], flat[head + L:])
    flat[0:N] = rid
    flat[N:2 * N] = lo
    flat[2 * N:3 * N] = hi
    flat[3 * N:4 * N] = pref
    flat[4 * N:head] = overflow.to(I32)
    return flat


def unpack_reads2(reads_p: torch.Tensor, row_len: torch.Tensor, steps: int,
                  kmer_size: int) -> torch.Tensor:
    """2-bit packed read matrix -> (steps, SR) int32 base codes (port of
    _unpack_reads2). reads_p: (ceil(steps/4), SR) uint8, 4 bases a byte
    along the step axis (code = base - 1). Bases past a row's body
    (row_len - k) are 0 (= inactive), as in the zero-padded reads_T."""
    b = reads_p.to(I32)
    codes = torch.stack([(b >> (2 * j)) & 3 for j in range(4)], dim=1
                        ).reshape(4 * reads_p.shape[0], reads_p.shape[1])[:steps]
    n_steps_row = (row_len.to(I32) - kmer_size).clamp(0, steps)
    ar = torch.arange(steps, dtype=I32, device=reads_p.device)
    return torch.where(ar[:, None] < n_steps_row[None, :], codes + 1, 0)


def log_search_record(di, rt, st, reads_p, slot_sidx, slot_row, row_ok,
                      row_first_raw, row_len, cov_diff, phases,
                      num_reads: int, trip_cap: int, kmer_size: int,
                      blocks=None, rank: str = "dense") -> torch.Tensor:
    """The fused scan + select + record program for one buffer (port of
    _record_body / _log_search_record).

    rt, st: the resident record.RecordTables and record.SeedTables.
    reads_p: (steps/4, R) uint8 2-bit packed reads; slot_sidx, slot_row:
    (pool0,) int32 seed-state index and row of each placed first-phase
    slot (-1 = empty); row_ok (R,) bool; row_first_raw (R,) int64
    mt19937 first draws; row_len (R,) int32; cov_diff (cov_size + 1,)
    int32, added into in place. Returns the flat int32 result
    [ovf | fallback | mapped | t_row | t_site | t_allele] (R, R, R and
    trip_cap each) on the device. Enqueued without a synchronisation."""
    dev = di.device
    steps = sum(e[0] for e in phases)
    reads = unpack_reads2(reads_p, row_len, steps, kmer_size)

    # initial carry from the placed (slot -> seed state, row) maps
    sidx_ok = slot_sidx >= 0
    sidc = slot_sidx.clamp(0, st.n_states - 1)
    carry = (torch.where(sidx_ok, slot_row, -1),
             torch.where(sidx_ok, st.k_lo[sidc], 0),
             torch.where(sidx_ok, st.k_hi[sidc], 0),
             torch.where(sidx_ok, -(slot_sidx + 1), 0),
             torch.zeros(num_reads, dtype=torch.bool, device=dev))
    L = _log_length(di, phases)
    log = torch.empty(2 * L, dtype=I32, device=dev)
    lp, le = log[:L], log[L:]
    rid, lo, hi, pref, ovf = _scan_phases(
        di, reads, carry, phases, num_reads, occ_rows_for(di, blocks, rank),
        lp, le)
    trav, n_trav, ing, n_ing, bad = replay_device(di, pref, lp, le, st,
                                                  rid >= 0)
    fallback, mapped, t_row, t_site, t_allele = select_and_record_device(
        di, rt, rid, lo, hi, trav, n_trav, ing, n_ing, bad, row_ok & ~ovf,
        row_first_raw, row_len, cov_diff, trip_cap=trip_cap)
    R = num_reads
    flat = torch.empty(3 * R + 3 * trip_cap, dtype=I32, device=dev)
    for i, part in enumerate((ovf, fallback, mapped)):
        flat[i * R:(i + 1) * R] = part.to(I32)
    for i, part in enumerate((t_row, t_site, t_allele)):
        flat[3 * R + i * trip_cap:3 * R + (i + 1) * trip_cap] = part
    return flat
