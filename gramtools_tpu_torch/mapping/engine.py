"""The genealogy-log mapping engine on one torch device or a mesh.

Port of gramtools_tpu/mapping/search_jax_log.py ``LogBatchedEngine``.
The host screens kmers and places the seed states; then one of two
device programs runs:

  * fused (the default, as in the JAX engine): the scan, the genealogy
    replay, the mapping-instance selection and the per-base coverage
    walk all run on the device (search_log.log_search_record,
    mapping/record.py); the per-base counts accumulate in a device diff
    array (``cov_diff``, folded into the graph once per run by
    ``flush_device_coverage``) and only per-row flags and selected-loci
    triples come home;
  * non-fused (``GRAMTOOLS_TPU_DEVICE_RECORD=0``, or a kmer index that
    is not array-backed): the device runs the scan
    (search_log.log_search_packed), and the host replays the log and
    records coverage with the reference's numpy recorder
    (``coverage_fast.select_and_record``).

Rows the device cannot finish (unseeded, overflowed twice, or flagged
by the recorder) are re-mapped and recorded exactly on the host.

``scan_submit`` enqueues the device program and, on a GPU, the copy of
its flat result into pinned host memory, and returns without waiting;
the caller's ``record_complete`` of the previous buffer then overlaps
the device's work. The completion waits on the copy's event: that wait
is the fetch. The JAX engine's eager-fetch thread is not part of this
port (it exists for a remote TPU runtime).

With a mesh (parallel/mesh.py) the buffer's rows round-robin over S
shards: global row r is shard r % S's local row r // S. Shard s runs the
single-device program on its own column and pool-slot ranges on
``mesh.devices[s]``, enqueued without waiting, so shards on distinct
cards overlap; where JAX runs one ``shard_map`` program, this is a loop
over shards. The index and record tables are resident once per distinct
device. The shards' flat results land in shard order in one host
buffer, the layout the unpackers read with ``n_shards=S``, and each
shard adds into its own ``cov_diff`` row on its device, the rows summed
at flush. The per-read seeded selection RNG makes every result
independent of S. Without a mesh, S = 1 and the same loop runs the one
shard on full, contiguous views: no slice copy and no concat.

The environment knobs are the JAX engine's, with the same defaults
(``GRAMTOOLS_TPU_POOL``, ``_HITS``, ``_RANK``, ``_RETRY_MIN``,
``_MAX_HITS_BOOST``, ``_DEVICE_RECORD``; the phase plan reads
``_NARROW``, ``_LOCK_AFTER`` and ``_TAIL_HITS_DIV``), so one environment
gives both engines the same programs, phase plan, budgets and
overflows.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
from typing import Optional

import numpy as np
import torch

from gramtools_tpu.mapping.jump_table import build_jump_table
from gramtools_tpu.mapping.search import PrgIndex, SearchState

from ..common.device import get_device
from ..ops.rank import blocks_tensor, build_packed_occ
from .device_index import DeviceIndex, _round_up
from .record import RecordTables, SeedTables
from .search_log import log_search_packed, log_search_record
from .search_log_host import (FB_NAMES, LogConfig, PathReplayer,
                              _filter_buffer_rows, _pack_reads2,
                              _row_capacity, _unpack_record_result,
                              _unpack_result, auto_phases, finalise_cov_diff,
                              replay_paths_vectorised)

log = logging.getLogger("gramtools_tpu")


class _Pending:
    """A dispatched program's flat result on its way to the host: the
    shards' tensors land in shard order in one host buffer (pinned on a
    GPU, one event per device)."""

    def __init__(self, flats: list):
        self._events = []
        if all(f.device.type == "cpu" for f in flats):
            self._host = flats[0] if len(flats) == 1 else torch.cat(flats)
            return
        host = torch.empty(sum(f.numel() for f in flats),
                           dtype=flats[0].dtype, pin_memory=True)
        off = 0
        for f in flats:
            with torch.cuda.device(f.device):
                host[off:off + f.numel()].copy_(f, non_blocking=True)
            off += f.numel()
        for dev in dict.fromkeys(f.device for f in flats):
            with torch.cuda.device(dev):
                event = torch.cuda.Event()
                event.record()
            self._events.append(event)
        self._host = host

    def get(self) -> np.ndarray:
        for event in self._events:
            event.synchronize()
        return self._host.numpy()


def _on_card(dev: torch.device):
    """Makes ``dev`` the current CUDA device for a shard's launches (the
    hand kernels launch on the current one); nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _to_device(obj, dev: torch.device):
    """A copy of a dataclass of tensors (nested dataclasses and named
    tuples included) with every tensor on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_device(v, dev) for v in obj))
    return obj


class LogBatchedEngine:
    """Mapping engine for quasimap_reads: search_buffer (scan + host
    replay, the oracle-comparison contract) and the pipelined
    scan_submit / record_complete pair (fused or non-fused)."""

    def __init__(self, idx: PrgIndex, kmer_size: int,
                 cfg: Optional[LogConfig] = None, device=None, mesh=None):
        self.idx = idx
        self.kmer_size = kmer_size
        # mesh=None: one device, S = 1, the shard layout is the identity.
        # Otherwise shard s runs on mesh.devices.flat[s]; self.device is
        # shard 0's, where the primary tables live.
        self.mesh = mesh
        if mesh is None:
            self.shard_devices = [get_device(device)]
        else:
            if device is not None:
                raise ValueError("pass the devices in the mesh, not device=")
            self.shard_devices = [get_device(d) for d in mesh.devices.flat]
        self.S = len(self.shard_devices)
        self.device = self.shard_devices[0]
        self._replicas: dict = {}    # (name, device) -> (table, its copy)
        self.jt = build_jump_table(idx)
        self.di = DeviceIndex.build(idx, self.jt, self.device)
        idx.graph.node_tables()  # pre-build for the batched coverage recorder
        if cfg is None:
            cfg = LogConfig(
                pool=int(os.environ.get("GRAMTOOLS_TPU_POOL", LogConfig.pool)),
                hits=int(os.environ.get("GRAMTOOLS_TPU_HITS", LogConfig.hits)))
        self.cfg = cfg
        # rank implementation for the hot occ gather: "dense" (int32
        # prefix-table rows) or "packed" (bit-packed blocks, the CUDA
        # packed-rank kernel on a GPU)
        self.rank = os.environ.get("GRAMTOOLS_TPU_RANK", "dense")
        self.blocks = None
        if self.rank == "packed":
            self.blocks = blocks_tensor(build_packed_occ(idx.fm), self.device)
            # the dense occ table is dead weight in packed mode: a stub
            # keeps it off the device
            self.di = dataclasses.replace(
                self.di, occ=torch.zeros((1, 4), dtype=torch.int32,
                                         device=self.device))
        self.replayer = PathReplayer(self.jt, self.di.n_outcomes)
        self._site_meta = None
        self._last_kmer_index = None
        # device-side selection + coverage recording (mapping/record.py);
        # GRAMTOOLS_TPU_DEVICE_RECORD=0 reverts to the numpy recorder
        self.device_record = os.environ.get(
            "GRAMTOOLS_TPU_DEVICE_RECORD", "1") == "1"
        self.rt = None               # RecordTables, built lazily
        self.st = None               # resident SeedTables (record mode)
        self._st_for = None          # kmer index the SeedTables were built for
        # persistent per-base diff arrays: one per shard, on its device
        self.cov_diff = None
        self.host_fallbacks = 0
        self.device_mapped = 0
        self.device_retried = 0
        # why rows left the device path (observability for tuning)
        self.fallback_reasons = collections.Counter()
        # below this many overflowed reads, exact host re-maps beat a
        # second full-budget device scan
        self.retry_min = int(os.environ.get("GRAMTOOLS_TPU_RETRY_MIN", "16"))
        # adaptive hit budget: when a buffer's overflow rate exceeds 2%
        # the budget doubles for later buffers
        self.hits_boost = 1
        self.max_hits_boost = int(os.environ.get(
            "GRAMTOOLS_TPU_MAX_HITS_BOOST", "8"))
        # sticky shape ratchets: every dispatch reuses the LARGEST shape
        # seen so far (extra rows/states are padding). They fix R, the
        # phases and the budgets -- and so which rows overflow -- exactly
        # as the JAX engine does.
        self._sticky_R = 0
        self._sticky_steps = 0
        self._sticky_seeds = 0       # warm-pool ratchet (high-fan-out only)
        # observability: one entry per distinct dispatched scan shape
        self.dispatch_shapes = set()

    # ---- shard layout ----------------------------------------------------
    # Global row r lives in shard r % S at local column r // S
    # (round-robin keeps shards balanced for partial buffers); a device
    # column c = s*R + local therefore maps back to row local*S + s.
    # For S == 1 both maps are the identity.

    def _cols_of(self, rows_idx, R: int):
        rows_idx = np.asarray(rows_idx)
        return (rows_idx % self.S) * R + rows_idx // self.S

    def _place_states(self, owner_rows: np.ndarray, pool: int):
        """Distribute states into per-shard pools (front-packed).

        Returns (slot (m,), keep (m,), spilled_rows): slot = shard*pool +
        per-shard rank; states ranked past the pool spill their row to
        the host engine. For S == 1 this is the sequential fill."""
        m = owner_rows.size
        shard = owner_rows % self.S
        order = np.argsort(shard, kind="stable")
        cnt = np.bincount(shard, minlength=self.S)
        start = np.zeros(self.S, np.int64)
        start[1:] = np.cumsum(cnt)[:-1]
        rank = np.empty(m, np.int64)
        rank[order] = np.arange(m) - start[shard[order]]
        keep = rank < pool
        slot = shard * pool + np.minimum(rank, pool - 1)
        spilled = np.unique(owner_rows[~keep])
        return slot, keep, spilled

    def _put(self, a: np.ndarray, device=None) -> torch.Tensor:
        """Host array -> device tensor: through pinned memory and an
        asynchronous copy on a GPU (a pageable copy would synchronise)."""
        device = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.clone()

    def _local(self, name: str, dev: torch.device):
        """The engine's table ``name`` (di, blocks, rt, st) resident on
        ``dev``: shard 0's own, else a copy made once per distinct device
        (and again only when the table itself is replaced)."""
        table = getattr(self, name)
        if dev == self.device or table is None:
            return table
        entry = self._replicas.get((name, dev))
        if entry is None or entry[0] is not table:
            entry = (table, _to_device(table, dev))
            self._replicas[(name, dev)] = entry
        return entry[1]

    def _shards(self, R: int, pool0: int):
        """(shard, device, column slice, pool-slot slice) per shard."""
        for s, dev in enumerate(self.shard_devices):
            yield (s, dev, slice(s * R, (s + 1) * R),
                   slice(s * pool0, (s + 1) * pool0))

    def _run_packed(self, reads_T, carry, phases, R) -> _Pending:
        """Enqueue the scan+pack on the device(s); returns without
        waiting."""
        flats = []
        for _, dev, cols, slots in self._shards(R, phases[0][1]):
            put = lambda a: self._put(a, dev)
            with _on_card(dev):
                flats.append(log_search_packed(
                    self._local("di", dev), put(reads_T[:, cols]),
                    tuple(put(a[slots]) for a in carry[:4])
                    + (put(carry[4][cols]),), phases, R,
                    blocks=self._local("blocks", dev), rank=self.rank))
        return _Pending(flats)

    def _scan_rows(self, buffer, kmer_index, kmer_size, stats):
        """Kmer filter + seed + device scan. Returns (results_skeleton,
        rows, carry_np, log_parent, log_event, seed arrays, host_rows)."""
        return self.scan_complete(
            self.scan_submit(buffer, kmer_index, kmer_size, stats))

    def scan_submit(self, buffer, kmer_index, kmer_size, stats,
                    first_raws=None):
        """Host filter + seeding, then the device program, enqueued
        without waiting: returns a pending token, so the device works on
        this buffer while the host finishes the previous one.

        With first_raws (per-read precomputed mt19937 first draws), an
        array-backed kmer index and device_record on, the program is the
        fused scan+select+record (search_log.log_search_record): only
        the placed seed-state indices and the 2-bit reads go to the
        device, and only flags + loci triples come back. Otherwise it is
        the scan alone, for scan_complete."""
        k = kmer_size
        self._last_kmer_index = kmer_index
        results, rows, rows_mat = _filter_buffer_rows(buffer, kmer_index, k,
                                                      stats)
        if not rows:
            return (results, [], None, None, set(), None, None)

        n = len(rows)
        S = self.S
        self._sticky_R = max(self._sticky_R, _row_capacity(-(-n // S)))
        R = self._sticky_R                # rows per shard
        max_len = max(r.size for _, r in rows)
        self._sticky_steps = max(self._sticky_steps,
                                 _round_up(max(max_len - k, 0), 16))
        steps = self._sticky_steps
        reads_T = np.zeros((steps, S * R), dtype=np.uint8)
        cols = self._cols_of(np.arange(n), R)
        host_rows = set()

        seed_fn = getattr(kmer_index, "seed_batch", None)
        arr_index = (seed_fn is not None
                     and getattr(kmer_index, "trav", None) is not None)
        # record mode: fused scan+select+record with RESIDENT seed
        # tables -- the host ships only placed state indices
        record_mode = (self.device_record and first_raws is not None
                       and arr_index)
        if arr_index:
            # vectorised seeding from the array-backed kmer index
            if rows_mat is not None:
                L = rows_mat.shape[1]
                last_kmers = rows_mat[:, L - k:]
                reads_T[: L - k, cols] = rows_mat[:, : L - k][:, ::-1].T
            else:
                last_kmers = np.zeros((n, k), dtype=np.uint8)
                for row, (i, read) in enumerate(rows):
                    last_kmers[row] = read[read.size - k:]
                    body = read[: read.size - k][::-1]
                    reads_T[: body.size, cols[row]] = body
            if record_mode:
                owner, sidx = kmer_index.seed_batch_indices(last_kmers)
                seeds = None
            else:
                (owner, s_lo, s_hi, s_trav, s_nt, s_ing, s_ni,
                 _sidx) = seed_fn(last_kmers)
                seeds = (s_trav, s_nt, s_ing, s_ni)
        else:
            if S > 1:
                raise TypeError(
                    "mesh mapping needs the array-backed kmer index "
                    "(index.kmer_index_vec.build_kmer_index_vectorised); "
                    "the dict oracle index has no seed_batch")
            owner_l: list = []
            lo_l: list = []
            hi_l: list = []
            tups: list = []
            for row, (i, read) in enumerate(rows):
                seed = read[read.size - k:].astype(np.uint8).tobytes()
                states = kmer_index.get(seed, [])
                if not states:
                    host_rows.add(row)
                    continue
                for s in states:
                    owner_l.append(row)
                    lo_l.append(s.lo)
                    hi_l.append(s.hi)
                    tups.append((tuple(s.traversed), tuple(s.traversing)))
                body = read[: read.size - k][::-1]
                reads_T[: body.size, row] = body
            owner = np.asarray(owner_l, dtype=np.int64)
            s_lo = np.asarray(lo_l, dtype=np.int64)
            s_hi = np.asarray(hi_l, dtype=np.int64)
            P0 = max((max(len(t), len(g)) for t, g in tups), default=0)
            P0 = max(P0, 1)
            m = owner.size
            s_trav = np.zeros((m, P0, 2), dtype=np.int32)
            s_ing = np.zeros((m, P0, 2), dtype=np.int32)
            s_nt = np.zeros(m, dtype=np.int32)
            s_ni = np.zeros(m, dtype=np.int32)
            for si, (t, g) in enumerate(tups):
                s_nt[si] = len(t)
                s_ni[si] = len(g)
                for pi, locus in enumerate(t):
                    s_trav[si, pi] = locus
                for pi, locus in enumerate(g):
                    s_ing[si, pi] = locus
            seeds = (s_trav, s_nt, s_ing, s_ni)

        n_states = owner.size
        if steps > 0 and n_states > 0:
            # the marker-hit budget is a global per-step quota shared by
            # all rows: it scales linearly with the row capacity
            # (cfg.hits is per 4096 rows)
            cfg_eff = LogConfig(
                pool=self.cfg.pool,
                hits=self.cfg.hits * max(1, R // 4096) * self.hits_boost)
            per_shard = int(np.bincount(owner % S, minlength=S).max())
            self._sticky_seeds = max(self._sticky_seeds, per_shard)
            phases = auto_phases(steps, R, cfg_eff,
                                 n_seed_states=self._sticky_seeds)
            pool0 = phases[0][1]
            slot, keep, spilled = self._place_states(owner, pool0)
            host_rows.update(int(r) for r in spilled)
            placed = slot[keep]
            seeded = np.zeros(n, dtype=bool)
            seeded[owner[keep]] = True
            host_rows.update(int(r) for r in np.flatnonzero(~seeded))
            if record_mode:
                self._ensure_seed_tables(kmer_index)
                slot_sidx = np.full(S * pool0, -1, np.int32)
                slot_row = np.full(S * pool0, -1, np.int32)
                slot_sidx[placed] = sidx[keep].astype(np.int32)
                # the carry holds shard-local read ids
                slot_row[placed] = (owner[keep] // S).astype(np.int32)
                reads_p = _pack_reads2(reads_T)
                device_out = self._dispatch_record(
                    rows, reads_p, slot_sidx, slot_row, host_rows,
                    first_raws, phases, R)
                return (results, rows, device_out, None, host_rows,
                        (slot_sidx, slot_row), reads_p)
            carry = (np.full(S * pool0, -1, np.int32),
                     np.zeros(S * pool0, np.int32),
                     np.zeros(S * pool0, np.int32),
                     np.zeros(S * pool0, np.int32),
                     np.zeros(S * R, bool))
            rid_c, lo_c, hi_c, pref_c = carry[0], carry[1], carry[2], carry[3]
            rid_c[placed] = (owner[keep] // S).astype(np.int32)
            lo_c[placed] = s_lo[keep]
            hi_c[placed] = s_hi[keep]
            # seed prefs reference the seed list by ORIGINAL index,
            # independent of placement order
            pref_c[placed] = -(np.flatnonzero(keep).astype(np.int32) + 1)
            self.dispatch_shapes.add(
                ("packed", phases, R, reads_T.shape,
                 tuple(a.shape for a in carry)))
            device_out = (self._run_packed(reads_T, carry, phases, R),
                          phases, R)
        else:
            # no extension steps / no seeds: everything via the exact
            # host path
            host_rows.update(range(n))
            carry = None
            device_out = None
        return (results, rows, device_out, seeds, host_rows, carry, reads_T)

    def _ensure_record_tables(self):
        if self.rt is None:
            self.rt = RecordTables.build(self.idx, self.device)
        if self.cov_diff is None:
            self.cov_diff = [torch.zeros(self.rt.cov_size + 1,
                                         dtype=torch.int32, device=dev)
                             for dev in self.shard_devices]

    def _ensure_seed_tables(self, kmer_index):
        """Upload the kmer index's seed-state payloads ONCE
        (record.SeedTables); per buffer only placed indices ship."""
        if self.st is None or self._st_for is not kmer_index:
            self.st = SeedTables.build(kmer_index, self.device)
            self._st_for = kmer_index

    def _dispatch_record(self, rows, reads_p, slot_sidx, slot_row, host_rows,
                         first_raws, phases, R, row_map=None):
        """Enqueue the fused scan+record program for one (sub)buffer.

        row_map: optional original-row ids (retry pass); None = identity.
        Per-row arrays are laid out in shard-major column space
        (self._cols_of). Returns the "record"-tagged token entry."""
        self._ensure_record_tables()
        S = self.S
        nrows = len(rows) if row_map is None else row_map.size
        row_ok = np.ones(S * R, dtype=bool)
        if host_rows:
            row_ok[self._cols_of(np.fromiter(host_rows, dtype=np.int64,
                                             count=len(host_rows)), R)] = False
        # the mt19937 first draws are uint32; the device reads int64
        row_first = np.zeros(S * R, dtype=np.int64)
        row_len = np.zeros(S * R, dtype=np.int32)
        cols = self._cols_of(np.arange(nrows), R)
        src = rows if row_map is None else [rows[int(o)] for o in row_map]
        if src:
            owners = np.fromiter((i for i, _ in src), dtype=np.int64,
                                 count=len(src))
            lens = np.fromiter((r.size for _, r in src), dtype=np.int64,
                               count=len(src))
            row_first[cols] = np.asarray(first_raws)[owners]
            row_len[cols] = lens
        # 4R, not the recorder's 16R default: the JAX engine's budget
        trip_cap = 4 * R
        self.dispatch_shapes.add(
            ("record", phases, R, trip_cap, reads_p.shape))
        flats = []
        for s, dev, cols, slots in self._shards(R, phases[0][1]):
            put = lambda a: self._put(a, dev)
            local = lambda name: self._local(name, dev)
            with _on_card(dev):
                flats.append(log_search_record(
                    local("di"), local("rt"), local("st"),
                    put(reads_p[:, cols]), put(slot_sidx[slots]),
                    put(slot_row[slots]), put(row_ok[cols]),
                    put(row_first[cols]), put(row_len[cols]),
                    self.cov_diff[s], phases, R, trip_cap, self.kmer_size,
                    blocks=local("blocks"), rank=self.rank))
        return ("record", _Pending(flats), R, trip_cap, phases)

    def _empty_carry_np(self, nrows: int):
        """Stand-in when nothing was dispatched."""
        z = np.zeros(0, np.int32)
        return (np.full(0, -1, np.int32), z, z, z,
                np.zeros(max(nrows, 1), dtype=bool))

    def scan_complete(self, token):
        """Waits for a scan_submit token; returns (results_skeleton,
        rows, carry_np, log_parent, log_event, seed arrays, host_rows)
        with carry/overflow in global row space."""
        results, rows, device_out, seeds, host_rows, carry, reads_T = token
        if device_out is not None:
            pending, phases, R = device_out
            carry_np, log_parent, log_event = _unpack_result(
                pending.get(), phases, R, self.di.n_outcomes,
                n_shards=self.S)
            carry_np, log_parent, log_event = self._retry_overflow(
                carry_np, log_parent, log_event, carry, reads_T, len(rows),
                phases, R, host_rows=host_rows)
        else:
            carry_np = self._empty_carry_np(len(rows))
            log_parent = log_event = np.empty(0, dtype=np.int32)
        return (results, rows, carry_np, log_parent, log_event, seeds,
                host_rows)

    def _globalise_init_rid(self, init_read_id):
        """Init-carry read ids are per-shard local: map to global rows."""
        pool0 = init_read_id.size // self.S
        shard = np.arange(init_read_id.size) // pool0
        return np.where(init_read_id >= 0,
                        init_read_id * self.S + shard, -1)

    def _relayout_retry(self, init_carry, ovf_rows, reads_T, nrows, phases,
                        R):
        """Build the retry pass's carry/read matrix: the overflowed rows
        re-numbered 0..n_ovf-1 and redistributed over shards, their
        pass-1 seed states replayed from the init carry (same seed list /
        log references). The retry runs the SAME (phases, R) scan as the
        main pass: with only the overflowed rows live it has the whole
        hit budget and pool to itself. Rows whose seed states spill the
        pool are dropped from the retried set (flag survives -> host
        re-map). Returns (carry2, reads_T2, phases, R, retried_rows) or
        None."""
        S = self.S
        pool0 = phases[0][1]
        ovf_rows = ovf_rows[:S * R]
        init_read_id, init_lo, init_hi, init_pref = init_carry[:4]
        init_rid_g = self._globalise_init_rid(init_read_id)
        for _ in range(2):
            row_map = np.full(nrows, -1, dtype=np.int32)
            row_map[ovf_rows] = np.arange(ovf_rows.size, dtype=np.int32)
            sel = np.flatnonzero(
                (init_rid_g >= 0)
                & np.isin(init_rid_g, ovf_rows, assume_unique=False))
            retry_rows = row_map[init_rid_g[sel]]
            slot, keep, spilled = self._place_states(retry_rows, pool0)
            if not spilled.size:
                break
            # rows whose seed states do not fit the pool must stay OUT of
            # the retried set (their overflow flag must survive the merge
            # -> exact host re-map): drop and re-number
            drop_mask = np.zeros(ovf_rows.size, dtype=bool)
            drop_mask[spilled] = True
            ovf_rows = ovf_rows[~drop_mask]
            if ovf_rows.size == 0:
                return None
        else:
            return None   # still spilling after one re-number: host path
        carry2 = (np.full(S * pool0, -1, np.int32),
                  np.zeros(S * pool0, np.int32),
                  np.zeros(S * pool0, np.int32),
                  np.zeros(S * pool0, np.int32),
                  np.zeros(S * R, dtype=bool))
        carry2[0][slot] = (retry_rows // S).astype(np.int32)
        carry2[1][slot] = init_lo[sel]
        carry2[2][slot] = init_hi[sel]
        carry2[3][slot] = init_pref[sel]     # same seed list / pass-1 log
        reads_T2 = np.zeros((reads_T.shape[0], S * R), dtype=reads_T.dtype)
        cols_src = self._cols_of(ovf_rows, reads_T.shape[1] // S)
        cols_dst = self._cols_of(np.arange(ovf_rows.size), R)
        reads_T2[:, cols_dst] = reads_T[:, cols_src]
        return carry2, reads_T2, phases, R, ovf_rows

    def _relayout_retry_record(self, slot_sidx, slot_row, ovf_rows, reads_p,
                               nrows, phases, R):
        """Record-path twin of _relayout_retry: rebuilds the slot ->
        (seed state, row) maps and the packed read matrix with only the
        overflowed rows live, for a re-dispatch of the SAME (phases, R)
        program. Returns (slot_sidx2, slot_row2, reads_p2, retried_rows)
        or None."""
        S = self.S
        pool0 = phases[0][1]
        ovf_rows = ovf_rows[:S * R]
        shard_of = np.arange(slot_sidx.size) // pool0
        g_row = np.where(slot_sidx >= 0, slot_row * S + shard_of, -1)
        for _ in range(2):
            row_map = np.full(nrows, -1, dtype=np.int32)
            row_map[ovf_rows] = np.arange(ovf_rows.size, dtype=np.int32)
            sel = np.flatnonzero((slot_sidx >= 0)
                                 & np.isin(g_row, ovf_rows))
            retry_rows = row_map[g_row[sel]]
            slot, keep, spilled = self._place_states(retry_rows, pool0)
            if not spilled.size:
                break
            drop_mask = np.zeros(ovf_rows.size, dtype=bool)
            drop_mask[spilled] = True
            ovf_rows = ovf_rows[~drop_mask]
            if ovf_rows.size == 0:
                return None
        else:
            return None
        slot_sidx2 = np.full(S * pool0, -1, np.int32)
        slot_row2 = np.full(S * pool0, -1, np.int32)
        placed = slot[keep]
        slot_sidx2[placed] = slot_sidx[sel[keep]]
        slot_row2[placed] = (retry_rows[keep] // S).astype(np.int32)
        reads_p2 = np.zeros_like(reads_p)
        cols_src = self._cols_of(ovf_rows, reads_p.shape[1] // S)
        cols_dst = self._cols_of(np.arange(ovf_rows.size), R)
        reads_p2[:, cols_dst] = reads_p[:, cols_src]
        return slot_sidx2, slot_row2, reads_p2, ovf_rows

    def _retry_overflow(self, carry_np, log_parent, log_event, init_carry,
                        reads_T, nrows, phases, R, host_rows=()):
        """One full-budget device re-scan of reads the phased plan
        overflowed (budget spill or pool shrink), before any host
        fallback. Pass-2 newborn prefs/log-parents shift by pass-1's log
        length; negative (seed) prefs reference the same seed list.
        Reads that overflow again keep their flag (-> exact host
        re-map)."""
        overflow = carry_np[4]
        # host-bound rows get re-mapped exactly anyway: never retry them
        ovf_flags = overflow[:nrows].copy()
        for r in host_rows:
            ovf_flags[r] = False
        ovf_rows = np.flatnonzero(ovf_flags)
        if ovf_rows.size > max(0.02 * nrows, 8):
            self.hits_boost = min(self.hits_boost * 2, self.max_hits_boost)
        if ovf_rows.size < self.retry_min or reads_T.shape[0] == 0:
            return carry_np, log_parent, log_event

        relayout = self._relayout_retry(init_carry, ovf_rows, reads_T, nrows,
                                        phases, R)
        if relayout is None:
            return carry_np, log_parent, log_event
        carry2, reads_T2, p2, R2, ovf_rows = relayout
        self.dispatch_shapes.add(("packed", p2, R2, reads_T2.shape,
                                  tuple(a.shape for a in carry2)))
        flat2 = self._run_packed(reads_T2, carry2, p2, R2).get()
        c2, lp2, le2 = _unpack_result(flat2, p2, R2, self.di.n_outcomes,
                                      n_shards=self.S)
        lp2 = lp2.copy()
        L1 = log_parent.size
        lp2[lp2 >= 0] += L1

        f_rid, f_lo, f_hi, f_pref, _ = (a.copy() for a in carry_np[:5])
        # pass-1 states of retried reads are incomplete: drop them
        drop = (f_rid >= 0) & np.isin(f_rid, ovf_rows)
        f_rid[drop] = -1
        rid2_f, lo2_f, hi2_f, pref2_f, ovf2 = c2
        live2 = rid2_f >= 0
        pref2_m = pref2_f.copy()
        pref2_m[live2 & (pref2_m >= 0)] += L1
        rid2_m = np.where(live2, ovf_rows[np.clip(rid2_f, 0, ovf_rows.size - 1)],
                          -1).astype(f_rid.dtype)

        overflow = overflow.copy()
        overflow[ovf_rows] = ovf2[:ovf_rows.size]
        self.device_retried += int(ovf_rows.size)
        log.debug("device retry: %d reads, %d still overflowed",
                  ovf_rows.size, int(ovf2[:ovf_rows.size].sum()))
        merged = (np.concatenate([f_rid, rid2_m]),
                  np.concatenate([f_lo, lo2_f]),
                  np.concatenate([f_hi, hi2_f]),
                  np.concatenate([f_pref, pref2_m]),
                  overflow)
        return (merged, np.concatenate([log_parent, lp2]),
                np.concatenate([log_event, le2]))

    def search_buffer(self, buffer, kmer_index, kmer_size, stats):
        from gramtools_tpu.mapping.search import (
            handle_allele_encapsulated_states, search_read_backwards)

        k = kmer_size
        (results, rows, carry_np, log_parent, log_event, seeds,
         host_rows) = self._scan_rows(buffer, kmer_index, kmer_size, stats)
        if not rows:
            return results
        (f_read_id, f_lo, f_hi, f_pref, overflow) = carry_np
        s_trav, s_nt, s_ing, s_ni = seeds

        # group final pool states by read, replaying paths from the log
        def seed_paths(si):
            nt, ni = int(s_nt[si]), int(s_ni[si])
            return (tuple(map(tuple, s_trav[si, :nt].tolist())),
                    tuple(map(tuple, s_ing[si, :ni].tolist())))

        per_row_states: dict = {}
        order = np.argsort(f_read_id, kind="stable")
        for pi in order:
            r = int(f_read_id[pi])
            if r < 0:
                continue
            trav, ing = self.replayer.replay(int(f_pref[pi]), log_parent,
                                             log_event, seed_paths)
            state = SearchState(int(f_lo[pi]), int(f_hi[pi]), trav, ing)
            per_row_states.setdefault(r, []).append(state)

        for row, (i, read) in enumerate(rows):
            if row in host_rows or bool(overflow[row]):
                self.host_fallbacks += 1
                seed = read[read.size - k:].astype(np.uint8).tobytes()
                seed_states = kmer_index.get(seed, [])
                states = (search_read_backwards(read, seed_states, k, self.idx)
                          if seed_states else [])
            else:
                self.device_mapped += 1
                states = handle_allele_encapsulated_states(
                    per_row_states.get(row, []), self.idx)
            results[i].append((states, int(read.size)))
        return results

    def record_buffer(self, buffer, kmer_index, kmer_size, stats, coverage,
                      selection_seeds, first_raws):
        """Scan + vectorised selection/recording for a whole buffer."""
        token = self.scan_submit(buffer, kmer_index, kmer_size, stats,
                                 first_raws=first_raws)
        self.record_complete(token, selection_seeds, first_raws, stats,
                             coverage, kmer_index, kmer_size)

    def flush_device_coverage(self):
        """Fold the device-resident per-base diff array into the graph's
        coverage (called once per run, after the last buffer), then drop
        it. The shards' rows are summed first."""
        if self.cov_diff is None:
            return
        counts = finalise_cov_diff(
            sum(row.cpu().numpy() for row in self.cov_diff))
        g = self.idx.graph
        if g.coverage.size:
            merged = g.coverage.astype(np.int64) + counts
            np.minimum(merged, np.iinfo(np.uint16).max, out=merged)
            g.coverage[:] = merged.astype(np.uint16)
        self.cov_diff = None

    def _record_complete_device(self, token, selection_seeds, first_raws,
                                stats, coverage, kmer_index, kmer_size):
        """Completion for the fused scan+record dispatch: fetch flags +
        triples, retry overflowed rows with a full-budget second pass
        (recorded on the device too), fold triples, host-record fallback
        rows exactly."""
        from gramtools_tpu.mapping.coverage import record_search_states
        from gramtools_tpu.mapping.coverage_fast import fold_loci_rows
        from gramtools_tpu.mapping.search import search_read_backwards

        (results, rows, device_out, _seeds, host_rows, slots, reads_p) = token
        slot_sidx, slot_row = slots
        _, pending, R, trip_cap, phases = device_out
        k = kmer_size if kmer_size is not None else self.kmer_size
        if kmer_index is None:
            kmer_index = self._last_kmer_index
        ovf, fallback, mapped, loci_rows = _unpack_record_result(
            pending.get(), R, trip_cap, n_shards=self.S)
        nrows = len(rows)
        fold_loci_rows(coverage, loci_rows)
        for bit, name in FB_NAMES.items():
            n_bit = int(((fallback[:nrows] & bit) != 0).sum())
            if n_bit:
                self.fallback_reasons[f"record:{name}"] += n_bit

        # full-budget retry pass for rows the phased budgets overflowed.
        # Rows already bound for the exact host path must NOT be retried:
        # the retry records on the device, and the host loop below
        # re-maps host_rows regardless -- retrying them would count their
        # coverage twice (a host_rows row can carry an overflow flag when
        # part of its seed states were placed and the pool dropped them).
        ovf_flags = ovf[:nrows].copy()
        for r in host_rows:
            ovf_flags[r] = False
        ovf_rows = np.flatnonzero(ovf_flags)
        if ovf_rows.size > max(0.02 * nrows, 8):
            self.hits_boost = min(self.hits_boost * 2, self.max_hits_boost)
        if ovf_rows.size >= self.retry_min and reads_p.shape[0] > 0:
            relayout = self._relayout_retry_record(
                slot_sidx, slot_row, ovf_rows, reads_p, nrows, phases, R)
            if relayout is not None:
                slot_sidx2, slot_row2, reads_p2, ovf_rows = relayout
                _, pending2, _, tc2, _ = self._dispatch_record(
                    rows, reads_p2, slot_sidx2, slot_row2, set(),
                    first_raws, phases, R, row_map=ovf_rows)
                ovf2, fb2, mapped2, loci2 = _unpack_record_result(
                    pending2.get(), R, tc2, n_shards=self.S)
                if loci2.shape[0]:
                    loci2[:, 0] = ovf_rows[loci2[:, 0]]
                    fold_loci_rows(coverage, loci2)
                ovf[ovf_rows] = ovf2[:ovf_rows.size]
                fallback[ovf_rows] = fb2[:ovf_rows.size]
                mapped[ovf_rows] = mapped2[:ovf_rows.size]
                self.device_retried += int(ovf_rows.size)

        # exact host path for unseeded / still-overflowed / flagged rows;
        # device rows are tallied vectorised
        host_mask = np.zeros(nrows, dtype=bool)
        for r in host_rows:
            host_mask[r] = True
        need_host = host_mask | ovf[:nrows] | (fallback[:nrows] != 0)
        for row in np.flatnonzero(need_host):
            i, read = rows[row]
            self.fallback_reasons[
                "unseeded" if host_mask[row] else
                "overflow" if ovf[row] else "record_flagged"] += 1
            self.host_fallbacks += 1
            seed = read[read.size - k:].astype(np.uint8).tobytes()
            seed_states = kmer_index.get(seed, [])
            states = (search_read_backwards(read, seed_states, k, self.idx)
                      if seed_states else [])
            if not states:
                stats.no_extension_reads_count += 1
                continue
            stats.exact_mapped_reads_count += 1
            record_search_states(coverage, states, int(read.size),
                                 self.idx, selection_seeds[i],
                                 int(first_raws[i]))
        dev_rows = ~need_host
        n_dev = int(dev_rows.sum())
        n_mapped = int((mapped[:nrows] & dev_rows).sum())
        self.device_mapped += n_dev
        stats.exact_mapped_reads_count += n_mapped
        stats.no_extension_reads_count += n_dev - n_mapped

    def record_complete(self, token, selection_seeds, first_raws, stats,
                        coverage, kmer_index=None, kmer_size=None):
        """Second half of the pipelined record path: waits for the
        device program of ``token`` (submitted by scan_submit). A fused
        token folds the device's loci triples (_record_complete_device);
        a scan token runs the host replay + vectorised selection and
        recording. Hard cases (overflow, unseeded, recorder edge
        features) re-map and record through the exact scalar path."""
        from gramtools_tpu.mapping.coverage import record_search_states
        from gramtools_tpu.mapping.coverage_fast import (SiteMeta,
                                                         select_and_record)
        from gramtools_tpu.mapping.search import (
            handle_allele_encapsulated_states, search_read_backwards)

        if isinstance(token[2], tuple) and token[2][0] == "record":
            return self._record_complete_device(
                token, selection_seeds, first_raws, stats, coverage,
                kmer_index, kmer_size)
        if kmer_index is None:
            kmer_index = self._last_kmer_index
        k = self.kmer_size if kmer_size is None else kmer_size
        (results, rows, carry_np, log_parent, log_event, seeds,
         host_rows) = self.scan_complete(token)
        if not rows:
            return
        (f_read_id, f_lo, f_hi, f_pref, overflow) = carry_np
        s_trav, s_nt, s_ing, s_ni = seeds

        sel, trav, n_trav, ing, n_ing = replay_paths_vectorised(
            f_read_id, f_pref, log_parent, log_event,
            s_trav, s_nt, s_ing, s_ni, self.jt, self.di.n_outcomes)

        nrows = len(rows)
        # rows handled by the scalar path from the start
        scalar_rows = np.zeros(nrows, dtype=bool)
        for r in host_rows:
            scalar_rows[r] = True
        scalar_rows |= overflow[:nrows]

        st_row = f_read_id[sel].astype(np.int64)
        keep = (st_row < nrows) & ~scalar_rows[np.clip(st_row, 0, nrows - 1)]
        sel, st_row = sel[keep], st_row[keep]
        trav, n_trav = trav[keep], n_trav[keep]
        ing, n_ing = ing[keep], n_ing[keep]

        row_seed = np.array([selection_seeds[i] for i, _ in rows],
                            dtype=np.int64)
        row_first = np.array([int(first_raws[i]) for i, _ in rows],
                             dtype=np.int64)
        row_len = np.array([r.size for _, r in rows], dtype=np.int64)

        if self._site_meta is None:
            self._site_meta = SiteMeta(self.idx)
        vec_fallback = select_and_record(
            self.idx, coverage,
            st_row, f_lo[sel].astype(np.int64), f_hi[sel].astype(np.int64),
            trav, n_trav, ing, n_ing,
            row_seed, row_first, row_len, site_meta=self._site_meta)

        has_states = np.zeros(nrows, dtype=bool)
        has_states[st_row] = True

        # scalar path: pre-flagged rows re-map; vector-fallback rows reuse
        # their replayed states
        for row, (i, read) in enumerate(rows):
            if scalar_rows[row]:
                self.host_fallbacks += 1
                seed = read[read.size - k:].astype(np.uint8).tobytes()
                seed_states = kmer_index.get(seed, [])
                states = (search_read_backwards(read, seed_states, k, self.idx)
                          if seed_states else [])
                if not states:
                    stats.no_extension_reads_count += 1
                    continue
                stats.exact_mapped_reads_count += 1
                record_search_states(coverage, states, int(read.size),
                                     self.idx, selection_seeds[i],
                                     int(first_raws[i]))
                continue
            self.device_mapped += 1
            if not has_states[row]:
                stats.no_extension_reads_count += 1
                continue
            stats.exact_mapped_reads_count += 1
            if vec_fallback[row]:
                mask = st_row == row
                states = [
                    SearchState(
                        int(f_lo[s]), int(f_hi[s]),
                        tuple(map(tuple, trav[j, :n_trav[j]].tolist())),
                        tuple(map(tuple, ing[j, :n_ing[j]].tolist())))
                    for j, s in zip(np.flatnonzero(mask), sel[mask])]
                states = handle_allele_encapsulated_states(states, self.idx)
                record_search_states(coverage, states, int(read.size),
                                     self.idx, selection_seeds[i],
                                     int(first_raws[i]))
