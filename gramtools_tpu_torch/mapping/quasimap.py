"""Quasimap driver: map reads onto the PRG and record coverage.

Parity: libgramtools src/genotype/quasimap/quasimap.cpp; the port's copy
of gramtools_tpu/mapping/quasimap.py. The reference buffers 5,000 reads
and maps them with OpenMP threads; here buffers are the unit of
batching for the torch engine (mapping/engine.py) with this host driver
as the reference path. RNG consumption order (one master mt19937 draw
per buffer slot) is preserved so multi-mapping selections are
bit-identical.

The worker pool (``max_threads`` > 1) forks, except once
``torch.cuda.is_initialized()``: a forked child cannot use its parent's
CUDA context, and the fork itself is unsafe beside the CUDA runtime's
threads, so the pool then spawns fresh workers and ships them the
(numpy-backed) index. With a pool, a device engine takes the
non-pipelined path, as in the JAX package: ``engine.search_buffer``
(scan + host replay) per buffer, then selection and recording in the
workers.

Under ``GRAMTOOLS_TPU_TIMERS=1`` a call records spans in
``common/timers.SPANS``: ``quasimap_reads`` around the call, holding
``coverage_empty``; with an engine, one ``iteration`` a buffer under the
buffer's id, holding its ``read_parse`` (the next buffer from
``iter_read_buffers``), ``rng_draws`` (the selection seeds and their
first draws) and the engine's ``scan_submit`` and ``record_complete``
(the latter under the id of the buffer it completes, the one submitted
before); at each file's end a ``read_parse`` with no buffer; after the
loop the last ``record_complete`` and ``coverage_finalise``. Without an
engine the buffers' ``read_parse`` and ``rng_draws`` sit in the call.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import contextlib
import os

import numpy as np
import torch

from ..common.rng import RandomInclusiveInt, first_raw_draws
from ..common.seq import iter_fastx, encode_dna, revcomp
from ..common.timers import recorder
from ..index.kmer_index import KmerIndex
from .coverage import Coverage, record_search_states
from .search import PrgIndex, SearchState, search_read_backwards

# Buffer size 5000 mirrors quasimap.cpp:128 AND pins the per-buffer
# selection-seed RNG stream to the reference's (one draw per slot,
# quasimap.cpp:136-137). Overriding via GRAMTOOLS_TPU_BUFFER (or the
# buffer_size argument) keeps results self-consistent and
# shard-invariant but consumes the RNG in a different order than the
# reference binary would; larger buffers amortise the device scan's
# per-step latency. DEVICE_BUFFER_SIZE is the device-engine default
# (throughput mode): one compiled program per ~40k-row dispatch.
READS_BUFFER_SIZE = int(os.environ.get("GRAMTOOLS_TPU_BUFFER", "5000"))
DEVICE_BUFFER_SIZE = int(os.environ.get("GRAMTOOLS_TPU_BUFFER", "20000"))


@dataclass
class QuasimapStats:
    all_reads_count: int = 0
    skipped_reads_count: int = 0
    missing_kmer_reads_count: int = 0
    no_extension_reads_count: int = 0
    exact_mapped_reads_count: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


def all_read_kmers_in_index(kmer_size: int, read: np.ndarray,
                            kmer_index: KmerIndex) -> bool:
    """quasimap.cpp:212-225: exact mapping needs every read kmer indexed."""
    if read.size < kmer_size:
        return False
    vec = getattr(kmer_index, "all_kmers_indexed", None)
    if vec is not None:
        return vec(read)
    data = read.astype(np.uint8).tobytes()
    for offset in range(read.size - kmer_size + 1):
        if data[offset : offset + kmer_size] not in kmer_index:
            return False
    return True


def quasimap_read(read: np.ndarray, coverage: Coverage, kmer_index: KmerIndex,
                  idx: PrgIndex, kmer_size: int, stats: QuasimapStats,
                  selection_seed: int, first_raw=None):
    """quasimap.cpp:159-194."""
    if not all_read_kmers_in_index(kmer_size, read, kmer_index):
        stats.missing_kmer_reads_count += 1
        return
    seeding_kmer = read[read.size - kmer_size :].astype(np.uint8).tobytes()
    seed_states = kmer_index.get(seeding_kmer)
    if not seed_states:
        states: List[SearchState] = []
    else:
        states = search_read_backwards(read, seed_states, kmer_size, idx)
    if not states:
        stats.no_extension_reads_count += 1
        return
    record_search_states(coverage, states, int(read.size), idx, selection_seed,
                         first_raw)
    stats.exact_mapped_reads_count += 1


def quasimap_forward_reverse(read, coverage, kmer_index, idx, kmer_size,
                             stats, selection_seed, first_raw=None):
    quasimap_read(read, coverage, kmer_index, idx, kmer_size, stats,
                  selection_seed, first_raw)
    quasimap_read(revcomp(read), coverage, kmer_index, idx, kmer_size, stats,
                  selection_seed, first_raw)


class ReadBatch:
    """Equal-length read buffer backed by one (n, L) uint8 matrix.

    Quacks like the legacy list-of-arrays buffer (len, indexing,
    iteration; invalid = non-ACGT reads index as empty arrays,
    utils.cpp:73-80) while letting the batched engine consume the
    matrix directly -- building 20k per-read Python arrays and
    re-stacking them cost ~0.2s/throughput buffer, pure overhead."""

    __slots__ = ("mat", "_invalid")

    def __init__(self, mat: np.ndarray):
        self.mat = mat
        self._invalid = None

    @property
    def invalid(self) -> np.ndarray:
        if self._invalid is None:
            self._invalid = (self.mat == 0).any(axis=1)
        return self._invalid

    def __len__(self):
        return self.mat.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if self.invalid[i]:
            return np.empty(0, dtype=np.uint8)
        return self.mat[i]

    def __iter__(self):
        inv = self.invalid
        empty = np.empty(0, dtype=np.uint8)
        for i in range(self.mat.shape[0]):
            yield empty if inv[i] else self.mat[i]


def iter_read_buffers(reads_fpath, buffer_size: Optional[int] = None
                      ) -> Iterable[List[np.ndarray]]:
    """Buffers of int-encoded reads; non-ACGT reads become empty
    (utils.cpp:73-80). Uses the native C++ parser when built; batches of
    equal-length reads come back as ReadBatch (one matrix, no per-read
    Python objects)."""
    from ..common.sam import detect_format
    from ..index.native import native_read_batches_flat

    size = READS_BUFFER_SIZE if buffer_size is None else buffer_size
    # the native parser only speaks fasta/fastq(.gz); SAM/BAM go through
    # the python decoders in common/sam.py
    native = None
    if detect_format(reads_fpath) in ("fasta", "fastq"):
        native = native_read_batches_flat(reads_fpath, batch_size=size)
    if native is not None:
        for flat, lens in native:
            n = lens.size
            if n and (lens == lens[0]).all() and lens[0] > 0:
                yield ReadBatch(flat.reshape(n, int(lens[0])))
                continue
            offs = np.concatenate([[0], np.cumsum(lens.astype(np.int64))])
            yield [flat[offs[i]:offs[i + 1]]
                   if lens[i] > 0 and not np.any(
                       flat[offs[i]:offs[i + 1]] == 0)
                   else np.empty(0, dtype=np.uint8)
                   for i in range(n)]
        return

    buffer: List[np.ndarray] = []
    for _, seq, _ in iter_fastx(reads_fpath):
        encoded = encode_dna(seq)
        if np.any(encoded == 0):
            encoded = np.empty(0, dtype=np.uint8)
        buffer.append(encoded)
        if len(buffer) == size:
            yield buffer
            buffer = []
    if buffer:
        yield buffer


def quasimap_reads(reads_fpaths: List[str], kmer_index: KmerIndex,
                   idx: PrgIndex, kmer_size: int, seed: Optional[int] = None,
                   engine=None, max_threads: int = 1,
                   buffer_size: Optional[int] = None
                   ) -> "tuple[QuasimapStats, Coverage]":
    """quasimap.cpp:16-141. ``engine`` optionally provides a batched
    (torch) search path: called with a list of reads, returns per-read
    SearchStates lists, or None entries for reads it could not handle.
    ``max_threads`` > 1 forks worker processes over buffer chunks (the
    reference's OpenMP parallel-for analogue); per-read seeds keep the
    selection RNG shard-invariant. ``buffer_size`` overrides the
    5,000-read reference buffer (throughput mode for device engines;
    changes the selection-RNG stream order, stays self-consistent)."""
    rec = recorder()
    with rec.span("quasimap_reads"):
        stats, coverage = _map_buffers(
            reads_fpaths, kmer_index, idx, kmer_size, seed, engine,
            max_threads, buffer_size, rec)
        with rec.span("coverage_finalise"):
            coverage.finalise()
    return stats, coverage


def _map_buffers(reads_fpaths, kmer_index, idx, kmer_size, seed, engine,
                 max_threads, buffer_size, rec):
    """quasimap_reads' loop over the buffers, spans in ``rec``; the
    coverage comes back unfinalised."""
    import logging
    log = logging.getLogger("gramtools_tpu")

    stats = QuasimapStats()
    with rec.span("coverage_empty"):
        coverage = Coverage.empty(idx)
    master_seed_generator = RandomInclusiveInt(seed)
    last_reported = 0
    size = READS_BUFFER_SIZE if buffer_size is None else buffer_size

    pool = _make_pool(max_threads, idx, kmer_index, kmer_size)
    # pipelined engines expose scan_submit/record_complete: the device
    # scans buffer N+1 while the host records buffer N
    pipelined = (engine is not None and pool is None
                 and hasattr(engine, "scan_submit")
                 and hasattr(engine, "record_complete"))
    in_flight = None  # (token, selection_seeds, first_raws, buffer id)
    try:
        for reads_fpath in reads_fpaths:
            buffers = iter_read_buffers(reads_fpath, size)
            while True:
                t0 = rec.now()
                buffer = next(buffers, None)
                if buffer is None:
                    rec.add("read_parse", t0)     # the end of the file
                    break
                buf = rec.new_buffer()
                with (rec.span("iteration", buf, start=t0)
                      if engine is not None else contextlib.nullcontext()):
                    rec.add("read_parse", t0, buffer=buf)
                    # progress every >=10k processed reads
                    # (quasimap.cpp:92-101)
                    if stats.all_reads_count - last_reported >= 10000:
                        log.info("processed %d reads", stats.all_reads_count)
                        last_reported = stats.all_reads_count
                    # one seed drawn per buffer slot, even for unfilled
                    # slots (quasimap.cpp:136-137): preserves RNG stream
                    # parity
                    with rec.span("rng_draws", buf):
                        selection_seeds = master_seed_generator.raw_block(
                            size)
                        first_raws = first_raw_draws(
                            np.asarray(selection_seeds, dtype=np.uint32))
                    if pipelined:
                        with rec.span("scan_submit"):
                            token = engine.scan_submit(
                                buffer, kmer_index, kmer_size, stats,
                                first_raws=first_raws)
                        if in_flight is not None:
                            with rec.span("record_complete", in_flight[3]):
                                engine.record_complete(*in_flight[:3], stats,
                                                       coverage)
                        in_flight = (token, selection_seeds, first_raws, buf)
                    elif engine is not None:
                        _map_buffer_batched(buffer, selection_seeds,
                                            first_raws, coverage, kmer_index,
                                            idx, kmer_size, stats, engine,
                                            pool)
                    elif pool is not None:
                        _map_buffer_pool(buffer, selection_seeds, first_raws,
                                         coverage, idx, stats, pool)
                    else:
                        for i, read in enumerate(buffer):
                            stats.all_reads_count += 2
                            if read.size == 0:
                                stats.skipped_reads_count += 2
                                continue
                            quasimap_forward_reverse(
                                read, coverage, kmer_index, idx, kmer_size,
                                stats, selection_seeds[i], int(first_raws[i]))
        if in_flight is not None:
            with rec.span("record_complete", in_flight[3]):
                engine.record_complete(*in_flight[:3], stats, coverage)
            in_flight = None
        if engine is not None and hasattr(engine, "flush_device_coverage"):
            # per-base coverage accumulated on device -> one transfer/run
            engine.flush_device_coverage()
    finally:
        if pool is not None:
            pool.terminate()
    return stats, coverage


def _map_buffer_batched(buffer, selection_seeds, first_raws, coverage,
                        kmer_index, idx, kmer_size, stats, engine, pool=None):
    """Batched path: the engine searches fwd+rev in one device batch;
    selection + recording are vectorised when the engine supports
    record_buffer, else they stay per-read on host (forked workers when
    pool given)."""
    record_fast = getattr(engine, "record_buffer", None)
    if record_fast is not None and pool is None:
        record_fast(buffer, kmer_index, kmer_size, stats, coverage,
                    selection_seeds, first_raws)
        return
    results = engine.search_buffer(buffer, kmer_index, kmer_size, stats)
    items = []
    for i, read in enumerate(buffer):
        if read.size == 0:
            continue
        for states, read_len in results[i]:
            if not states:
                stats.no_extension_reads_count += 1
                continue
            items.append((states, read_len, selection_seeds[i],
                          int(first_raws[i])))
            stats.exact_mapped_reads_count += 1
    if pool is None:
        # selection + dense counts per read; per-base recording batched
        # over the whole buffer (coverage_fast.record_per_base_batch)
        from .coverage import (record_allele_sum, record_grouped_counts,
                               select_mapping_instance)
        from .coverage_fast import record_per_base_batch

        per_read = []
        for states, read_len, seed_i, first in items:
            selected = select_mapping_instance(states, idx, seed_i, first)
            if not selected.states:
                continue
            per_read.append((selected.states, read_len))
            record_allele_sum(coverage, selected.loci)
            record_grouped_counts(coverage, selected.loci)
        record_per_base_batch(idx, per_read)
    else:
        chunks = _chunk(items, pool._processes)
        for cov_shard, pb_delta in pool.map(_record_chunk, chunks):
            coverage.merge(cov_shard)
            _merge_pb(idx.graph.coverage, pb_delta)


def _map_buffer_pool(buffer, selection_seeds, first_raws, coverage, idx,
                     stats, pool):
    """Host scalar mapping farmed out to forked workers (the reference's
    #pragma omp parallel for over the buffer, quasimap.cpp:90-117)."""
    items = [(read, selection_seeds[i], int(first_raws[i]))
             for i, read in enumerate(buffer)]
    chunks = _chunk(items, pool._processes)
    for cov_shard, pb_delta, stat_delta in pool.map(_map_chunk, chunks):
        coverage.merge(cov_shard)
        _merge_pb(idx.graph.coverage, pb_delta)
        for key, val in stat_delta.items():
            setattr(stats, key, getattr(stats, key) + val)


def _chunk(items, n):
    size = max((len(items) + n - 1) // n, 1)
    return [items[i : i + size] for i in range(0, len(items), size)]


def _merge_pb(target: np.ndarray, delta: np.ndarray):
    """Merge per-base coverage shards with uint16 saturation."""
    if target.size == 0:
        return
    merged = target.astype(np.int64) + delta.astype(np.int64)
    np.minimum(merged, np.iinfo(np.uint16).max, out=merged)
    target[:] = merged.astype(np.uint16)


# --- worker-pool machinery ---------------------------------------------------

_POOL_CTX: Dict[str, object] = {}


def _init_spawn_worker(idx, kmer_index, kmer_size):
    _POOL_CTX["idx"] = idx
    _POOL_CTX["kmer_index"] = kmer_index
    _POOL_CTX["kmer_size"] = kmer_size


def _pool_start_method() -> str:
    return "spawn" if torch.cuda.is_initialized() else "fork"


def _make_pool(max_threads, idx, kmer_index, kmer_size):
    if max_threads <= 1:
        return None
    import multiprocessing as mp

    method = _pool_start_method()
    ctx = mp.get_context(method)
    if method == "fork":
        # children inherit the index structures by fork; no pickling
        _POOL_CTX["idx"] = idx
        _POOL_CTX["kmer_index"] = kmer_index
        _POOL_CTX["kmer_size"] = kmer_size
        return ctx.Pool(processes=max_threads)
    # CUDA initialised: spawn fresh workers and ship the (numpy-backed)
    # index once per worker instead of forking the CUDA runtime
    return ctx.Pool(processes=max_threads, initializer=_init_spawn_worker,
                    initargs=(idx, kmer_index, kmer_size))


def _record_chunk(items):
    idx = _POOL_CTX["idx"]
    idx.graph.coverage[:] = 0  # worker-local copy-on-write slate
    cov = Coverage.empty(idx)
    for states, read_len, seed_i, first in items:
        record_search_states(cov, states, read_len, idx, seed_i, first)
    return cov, idx.graph.coverage


def _map_chunk(items):
    idx = _POOL_CTX["idx"]
    kmer_index = _POOL_CTX["kmer_index"]
    kmer_size = _POOL_CTX["kmer_size"]
    idx.graph.coverage[:] = 0
    cov = Coverage.empty(idx)
    stats = QuasimapStats()
    for read, seed_i, first in items:
        stats.all_reads_count += 2
        if read.size == 0:
            stats.skipped_reads_count += 2
            continue
        quasimap_forward_reverse(read, cov, kmer_index, idx, kmer_size,
                                 stats, seed_i, first)
    return cov, idx.graph.coverage, stats.as_dict()
