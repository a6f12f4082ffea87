"""The phased scan, its flat result, and the fused record program.

Port of gramtools_tpu/mapping/search_jax_log.py ``_log_search_phases``,
``_occ_rows_for``, ``_log_search_probe``, ``make_log_search``,
``_packed_body`` and ``_record_body`` (its ``_unpack_reads2``, K6, is
ops/packed_reads.py, which the scan kernels decode in place): JAX's
``lax.scan`` over the steps of a phase becomes a Python loop, and each
step writes its genealogy records ``(rec_parent, rec_event)`` straight
into their place in a preallocated log.

``log_search_packed`` (the non-fused engine) returns one flat int32
result ``[rid | lo | hi | pref | ovf | lp | le]`` (final carry, overflow
flags, then the log parents and events of every step, phase by phase).
``log_search_record`` (the fused engine) keeps the log on the device,
replays it and records the buffer's coverage there (mapping/record.py),
and returns only ``[ovf | fallback | mapped | t_row | t_site |
t_allele]``. Nothing in either reads a value back to the host, so each
is enqueued without a synchronisation. ``log_search_probe`` is the scan
with its live-state count after each phase (the pool occupancy a
benchmark reports), also without a synchronisation.

The fused program reads two profiling knobs, as the JAX package's
does: ``GRAMTOOLS_TPU_REPLAY_STAGE`` and ``GRAMTOOLS_TPU_RECORD_STAGE``
(default 99, the whole program) stop the replay and the selection after
a numbered block and return dummies of the right shapes
(record.replay_device, record.select_and_record_device), so a block's
device time is a difference of two prefixes. They change the output:
only profiling sets them.
"""
from __future__ import annotations

import os

import torch

from ..ops.locked_step import locked_tail
from ..ops.packed_reads import PackedReads, as_rows
from ..ops.packed_reads import unpack_reads2  # noqa: F401 (re-exported)
from ..ops.rank import PackedOccRows, make_packed_occ_rows
from ..ops.sharded import ShardedTables, sharded_scan
from ..ops.wide_step import wide_steps
from .record import replay_device, select_and_record_device
from .scan_steps import run_phases
from .search_log_host import LogConfig, _phase4, auto_phases

I32 = torch.int32


def occ_rows_for(di, blocks, rank: str):
    """Rank implementation for the occ gather: None = the dense
    (n+1, 4) table gather; "packed" = the bit-packed block rank
    (ops/rank.py: the CUDA kernel on a GPU, the torch twin on the CPU)."""
    if rank == "dense" or blocks is None:
        return None
    return make_packed_occ_rows(blocks, di.size)


def _runs(plan, narrow_ok, split: bool):
    """The phase plan grouped into the scan kernels' runs: ("wide",
    entries) for consecutive wide phases (a narrow phase that narrow_ok
    refuses runs the wide step, as in JAX), ("tail", entries) for a
    hole-allocated narrow phase and the locked phase after it, or either
    alone. ``split``: one run a phase."""
    runs = []
    for e in plan:
        kind = ("wide" if not narrow_ok(e[3])
                else "locked" if e[4] == "locked" else "narrow")
        last = runs[-1] if runs and not split else None
        if last and kind == "wide" and last[0] == "wide":
            last[1].append(e)
        elif (last and kind == "locked" and last[0] == "tail"
              and len(last[1]) == 1 and last[1][0][4] != "locked"):
            last[1].append(e)
        else:
            runs.append(("wide" if kind == "wide" else "tail", [e]))
    return runs


def _scan_phases(di, reads, carry, phases, num_reads: int, occ_rows,
                 lp: torch.Tensor, le: torch.Tensor, narrow_rows=None,
                 collect_live: bool = False):
    """The phase loop (port of _log_search_phases): runs every step of
    every phase on the reads, int32 (steps, num_reads) or the 2-bit
    packed matrix as a ``PackedReads`` (K6: the kernels decode it where
    they load a base), writes each step's genealogy records into their
    place in lp/le (preallocated, steps·G·B each), and returns the final
    carry with its (num_reads,) overflow. occ_rows / narrow_rows: the occ
    and narrow_tab gathers (None = the dense tables in di; occ_rows may
    be the packed rank, a ``PackedOccRows``, or the SA-range-sharded
    tables, a ``ShardedTables``: K10, parallel/sharded_index.py). Over
    the dense tables or the packed rank the plan runs as two calls, each
    one kernel launch on CUDA: ``ops/wide_step.wide_steps`` for the wide
    phases and ``ops/locked_step.locked_tail`` for the hole-allocated
    narrow phase and the locked phase after it. Over the sharded tables
    it is one call of ``ops/sharded.sharded_scan``, the scan in gather
    rounds on the row's cards. Injected gather functions keep the torch
    steps. collect_live=True also returns the live-state count after
    each phase, a (n_phases,) int64 device tensor (the kernels then run
    one phase a call)."""
    dev = di.device
    B = di.n_outcomes
    read_id, lo, hi, pref, overflow = carry
    # one dump slot past the last read: see scan_steps
    overflow = torch.cat([overflow.to(torch.bool),
                          torch.zeros(1, dtype=torch.bool, device=dev)])
    # the kernels read row-major reads and carry fields (a transposed
    # read matrix or a strided carry is copied once; else no copy)
    reads = reads.contiguous()
    carry = tuple(a.contiguous() for a in (read_id, lo, hi, pref)) + (
        overflow,)
    plan = [_phase4(e) for e in phases]
    if isinstance(occ_rows, ShardedTables):
        if collect_live:
            raise ValueError("the live-state probe takes no sharded tables")
        rid, lo, hi, pref, overflow = sharded_scan(
            di, reads, carry, plan, num_reads, lp, le, occ_rows)
        return rid, lo, hi, pref, overflow[:num_reads]
    has_narrow = di.narrow_tab.shape[0] == di.size
    narrow_ok = lambda w: w > 0 and (narrow_rows is not None or has_narrow)
    kernels = narrow_rows is None and (occ_rows is None or isinstance(
        occ_rows, PackedOccRows))
    blocks = occ_rows.blocks if isinstance(occ_rows, PackedOccRows) else None
    live = []
    log_base = 0
    offset = 0
    for kind, run in _runs(plan, narrow_ok, collect_live or not kernels):
        n_run = sum(e[0] for e in run)
        rows = reads[offset:offset + n_run]
        if not kernels:
            carry, _ = run_phases(di, as_rows(rows), carry, run, num_reads,
                                  lp, le, log_base, occ_rows, narrow_rows)
        elif kind == "wide":
            carry = wide_steps(di, rows, carry, [e[:3] for e in run],
                               log_base, lp, le, blocks=blocks)
        else:
            narrow = None if run[0][4] == "locked" else run[0][:4]
            locked = run[-1] if run[-1][4] == "locked" else None
            if locked is not None and locked[1] != num_reads:
                raise ValueError(f"locked phase needs pool == num_reads, "
                                 f"got {locked[1]} and {num_reads}")
            hits, wide_budget = (locked or narrow)[2:4]
            carry = locked_tail(di, rows, carry, log_base, lp, le, hits,
                                wide_budget, blocks=blocks,
                                lock=locked is not None, narrow=narrow)
        log_base += sum(e[0] * e[2] for e in run) * B
        offset += n_run
        if collect_live:
            live.append((carry[0] >= 0).sum())
    rid, lo, hi, pref, overflow = carry
    final = rid, lo, hi, pref, overflow[:num_reads]
    if collect_live:
        return final, torch.stack(live)
    return final


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


def log_search_probe(di, reads_T: torch.Tensor, carry, phases,
                     num_reads: int, blocks=None, rank: str = "dense"):
    """The scan with the live-state count after each phase (port of
    _log_search_probe, bench.py's pool-occupancy probe). Takes what
    log_search_packed takes; returns (final carry, (log_parent,
    log_event), live (n_phases,) int64), all on the device."""
    L = _log_length(di, phases)
    log = torch.empty(2 * L, dtype=I32, device=di.device)
    final, live = _scan_phases(di, reads_T.to(I32), carry, phases,
                               num_reads, occ_rows_for(di, blocks, rank),
                               log[:L], log[L:], collect_live=True)
    return final, (log[:L], log[L:]), live


def make_log_search(di, cfg: LogConfig, num_reads: int, phases=None,
                    blocks=None, rank: str = "dense"):
    """run(reads_T, carry) -> log_search_phases' result with the given
    phases, or auto_phases' plan for the read matrix's step count (port
    of make_log_search). With ``blocks`` and rank "packed" the scan
    gathers through the packed rank."""
    occ_rows = occ_rows_for(di, blocks, rank)

    def run(reads_T, carry):
        p = phases
        if p is None:
            p = auto_phases(reads_T.shape[0], num_reads, cfg)
        return log_search_phases(di, reads_T, carry, tuple(p), num_reads,
                                 occ_rows=occ_rows)
    return run


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
    # K6: the scan kernels decode the packed bases where they load them
    # (the twins, on the CPU, unpack with unpack_reads2)
    reads = PackedReads(reads_p, row_len.to(I32), kmer_size,
                        sum(e[0] for e in phases))

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
    # the profiling knobs (module doc); production leaves them unset
    r_stage = int(os.environ.get("GRAMTOOLS_TPU_REPLAY_STAGE", "99"))
    s_stage = int(os.environ.get("GRAMTOOLS_TPU_RECORD_STAGE", "99"))
    trav, n_trav, ing, n_ing, bad = replay_device(di, pref, lp, le, st,
                                                  rid >= 0, stage=r_stage)
    fallback, mapped, t_row, t_site, t_allele = select_and_record_device(
        di, rt, rid, lo, hi, trav, n_trav, ing, n_ing, bad, row_ok & ~ovf,
        row_first_raw, row_len, cov_diff, trip_cap=trip_cap, stage=s_stage)
    R = num_reads
    flat = torch.empty(3 * R + 3 * trip_cap, dtype=I32, device=dev)
    for i, part in enumerate((ovf, fallback, mapped)):
        flat[i * R:(i + 1) * R] = part.to(I32)
    for i, part in enumerate((t_row, t_site, t_allele)):
        flat[3 * R + i * trip_cap:3 * R + (i + 1) * trip_cap] = part
    return flat
