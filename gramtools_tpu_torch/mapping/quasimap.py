"""``quasimap_reads`` with a worker pool that is safe beside CUDA.

The port's copy of gramtools_tpu/mapping/quasimap.py ``quasimap_reads``
and ``_make_pool``: the shared ``_pool_start_method`` knows only JAX's
runtime, and would fork a process that holds a CUDA context (a forked
child cannot use it, and the fork itself is unsafe beside the CUDA
runtime's threads). Here the pool spawns once
``torch.cuda.is_initialized()``,
and follows the shared rule otherwise. Everything else -- buffers, the
batched and pooled mapping paths, the workers' functions and their
context ``_POOL_CTX`` -- is the shared module's, imported, not copied.

With a pool, a device engine takes the non-pipelined path, as in the
JAX package: ``engine.search_buffer`` (scan + host replay) per buffer,
then selection and recording in the workers.
"""
from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from gramtools_tpu.common.rng import RandomInclusiveInt, first_raw_draws
from gramtools_tpu.mapping import quasimap as shared
from gramtools_tpu.mapping.coverage import Coverage
from gramtools_tpu.mapping.quasimap import (READS_BUFFER_SIZE, QuasimapStats,
                                            _init_spawn_worker,
                                            _map_buffer_batched,
                                            _map_buffer_pool,
                                            iter_read_buffers,
                                            quasimap_forward_reverse)

log = logging.getLogger("gramtools_tpu")


def _pool_start_method() -> str:
    if torch.cuda.is_initialized():
        return "spawn"
    return shared._pool_start_method()


def _make_pool(max_threads, idx, kmer_index, kmer_size):
    if max_threads <= 1:
        return None
    import multiprocessing as mp

    method = _pool_start_method()
    ctx = mp.get_context(method)
    if method == "fork":
        # children inherit the index structures by fork; no pickling
        shared._POOL_CTX["idx"] = idx
        shared._POOL_CTX["kmer_index"] = kmer_index
        shared._POOL_CTX["kmer_size"] = kmer_size
        return ctx.Pool(processes=max_threads)
    # spawn fresh workers and ship the (numpy-backed) index once per
    # worker; the shared initialiser fills the shared _POOL_CTX
    return ctx.Pool(processes=max_threads, initializer=_init_spawn_worker,
                    initargs=(idx, kmer_index, kmer_size))


def quasimap_reads(reads_fpaths: List[str], kmer_index, idx, kmer_size: int,
                   seed: Optional[int] = None, engine=None,
                   max_threads: int = 1, buffer_size: Optional[int] = None
                   ) -> "tuple[QuasimapStats, Coverage]":
    """The shared module's quasimap_reads (quasimap.cpp:16-141), with
    this module's worker pool."""
    stats = QuasimapStats()
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
    in_flight = None  # (token, selection_seeds, first_raws)
    try:
        for reads_fpath in reads_fpaths:
            for buffer in iter_read_buffers(reads_fpath, size):
                # progress every >=10k processed reads (quasimap.cpp:92-101)
                if stats.all_reads_count - last_reported >= 10000:
                    log.info("processed %d reads", stats.all_reads_count)
                    last_reported = stats.all_reads_count
                # one seed drawn per buffer slot, even for unfilled slots
                # (quasimap.cpp:136-137): preserves RNG stream parity
                selection_seeds = master_seed_generator.raw_block(size)
                first_raws = first_raw_draws(np.asarray(selection_seeds,
                                                        dtype=np.uint32))
                if pipelined:
                    token = engine.scan_submit(buffer, kmer_index, kmer_size,
                                               stats, first_raws=first_raws)
                    if in_flight is not None:
                        engine.record_complete(*in_flight, stats, coverage)
                    in_flight = (token, selection_seeds, first_raws)
                elif engine is not None:
                    _map_buffer_batched(buffer, selection_seeds, first_raws,
                                        coverage, kmer_index, idx, kmer_size,
                                        stats, engine, pool)
                elif pool is not None:
                    _map_buffer_pool(buffer, selection_seeds, first_raws,
                                     coverage, idx, stats, pool)
                else:
                    for i, read in enumerate(buffer):
                        stats.all_reads_count += 2
                        if read.size == 0:
                            stats.skipped_reads_count += 2
                            continue
                        quasimap_forward_reverse(read, coverage, kmer_index,
                                                 idx, kmer_size, stats,
                                                 selection_seeds[i],
                                                 int(first_raws[i]))
        if in_flight is not None:
            engine.record_complete(*in_flight, stats, coverage)
            in_flight = None
        if engine is not None and hasattr(engine, "flush_device_coverage"):
            # per-base coverage accumulated on device -> one transfer/run
            engine.flush_device_coverage()
    finally:
        if pool is not None:
            pool.terminate()
    coverage.finalise()
    return stats, coverage
