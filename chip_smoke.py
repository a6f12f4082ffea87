#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gramtools_tpu_torch) on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port's main path, ``gramtools-tpu-torch genotype --engine
device`` with the packed rank (``GRAMTOOLS_TPU_RANK=packed``) and the
fused device recorder (the default), at the repository's
M. tuberculosis-scale workload: a 4.4 Mb genome with 100,000 biallelic
SNP sites, 150 bp reads, k = 10 (the graph and read generators of
gramtools_tpu_torch/common/workload.py, seeded), then at a
P. falciparum-scale graph past 2**24 index rows (phase 6), then diploid
on a mixed indel, multi-allelic and nested graph and on a nested MSA
graph built by ``build --prgs_bed`` (phase 7). Phases, in this order,
each printing one line or a few:

  0. the card (nvidia-smi name and power limit), the build of the
     six kernel sources and of the probes (the cursor walk and the
     narrow-table chase in one file; K3 with its stage stamps; one nvcc
     each, all started together);
  1. the packed-rank kernel (K1) against its plain torch twin, on a
     small FM index (every prefix length) and on the 4.4 Mb graph's
     records (524,288 random rows plus edge rows; the warm steps'
     newborn query count), also against the dense occ table, with the
     kernel's, the twin's and the dense gather's times (``index_select``
     on the (n+1, 4) table: the one PyTorch call for the same function)
     and the bound;
  1d. the path's own shapes: three 20,000-read buffers (R = 30,720
     rows) through the fused engine on CUDA, timed per buffer on the
     host clock and by the engine's stage timers
     (``GRAMTOOLS_TPU_TIMERS=1``, each key's seconds per buffer), every
     kernel's launches counted buffer by buffer; the second buffer's
     ``scan_submit`` runs under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host
     synchronisation allowed) and its K1 calls (none: the scan kernels
     fold the rank in) and its wide-step (K2), narrow-tail (K3),
     genealogy-replay (K7), selection (K8, csrc/select.cu's two
     launches) and per-base recorder (K9) inputs are kept;
     the third runs
     inside ``gramtools_tpu_torch.common.timers.device_trace`` (a
     ``torch.profiler`` Chrome trace: device busy time, device event
     count, the device time split by kernel name, each hand kernel's
     device time a launch, K8's device events, and the per-base call's
     device events between two marker kernels); then the first buffer's reads go
     through ``scan_submit`` twice more in one trace, each between
     markers: with the scan as its two kernel launches, and with the
     wide and hole-allocated phases as the torch steps with K1 that K2
     and K3 narrow replace (the buffer's device events before and
     after). Then every kept K1 call equals its
     twin and the largest is timed against the dense gather; K7 equals
     its twin bit for bit there and on a forced case (max_chain 2,
     tcap 4, so chains and paths overrun); K9, the whole per-base
     recorder in csrc/walk.cu's four kernels, gives the plain version's
     fallback bits and ``cov_diff`` there and with wcap half the
     lanes, emitcap half the emissions, preset fallback rows and
     max_iter 2, and is timed and traced beside the sort design of the
     same function (torch around the earlier cursor walk kernel, a
     probe that the script builds itself; also timed with a cursor word
     per lane).
     Each kernel's time (CUDA events, the launches queued behind a
     sleep of the card so the host's enqueue does not show), its bound
     (the bytes its inputs need, read once, and its outputs, written
     once, over the HBM rate) and its share of the bound are printed;
     the plain 2-bit read unpack (``ops/packed_reads.unpack_reads2``)
     refuses to run during the three buffers: K6 is decoded inside K2
     and K3, so the buffer has no unpack op;
  1e. the profiling stages on buffer 1's kept inputs: K7 at stages 1
     (the chase), 2 (+ the seed gather) and 99 (+ the ops apply), each
     equal bit for bit to its twin at that stage and timed by queued
     events, and the three blocks' times as prefix differences; the
     selection ``select_and_record_device`` (K8: csrc/select.cu's two
     cooperative launches, K9 between them from stage 6) at stages 0-6
     and 99, each equal bit for bit to the plain version
     (``record.select_torch``) at that stage, stage 99 also to the
     path's own call, and at forced budgets (ecap, trcap, lcap, wcap,
     emitcap, KCAP, trip_cap, first draws in the rejection branch); each
     stage timed by queued events and traced once between markers
     (device events and busy time by stage), the plain version timed
     and traced at stage 99, with K8's bound, share and registers (both
     kernels in both key instances, and ptxas's report); the 128-bit key
     instance, forced, equal to the plain version at every stage; K8's
     grid syncs and sort passes a launch and block 0's time between its
     grid syncs (a build of csrc/select.cu with -DK8_SYNCS, its outputs
     the path's own), one empty grid sync's time on K8's grid (a probe)
     and the sync floor, the syncs times one; stage 4's sizes (live
     states a row, a state's run of sorted lanes);
  1f. the scan kernels on buffer 1's kept inputs: K2 (csrc/wide_step.cu,
     every wide phase in one cooperative launch) and K3 (csrc/
     locked_step.cu, the hole-allocated narrow phase, the lock and the
     locked phase in one cooperative launch), each equal bit for bit
     (carry, flags, every log record) to the path's own call and to its
     plain version, also at forced budgets (every wide phase's hits 64;
     K3's hits 8 and wide budget 4 in both ranges: spills, dropped
     newborns and conflicts); K3 also as two calls (the hole-allocated
     range, then the locked range) and its locked range in two ranges
     of steps; each timed by queued events beside the plain version,
     with its bound and share, K3's two ranges traced alone, and K2's
     time in buffer 2's trace; the locked range's time a step, its
     latency floor (its steps times one dependent narrow-table load,
     timed by a one-thread chase probe); both scan kernels' registers,
     spills and shared memory (cudaFuncGetAttributes, and nvcc
     -Xptxas -v on each path source), their grid syncs a step and their
     time by stage (builds of csrc/wide_step.cu with -DK2_STAMPS and of
     csrc/locked_step.cu with -DK3_STAMPS, whose outputs must equal the
     kernels': the global timer at each stage of tiles 0, T/2 and T-1,
     every tile's publish times and SM, the grid syncs counted), and each
     wide and hole-allocated step's hits and the most hit pairs a tile
     holds; then K6, the 2-bit read decode in K2 and K3: the two
     launches on the path's packed windows equal to them on the plain
     unpack's rows, timed and traced beside them and beside the unpack;
  2. scan parity on one 4,096-read buffer: the flat result of the scan
     on CUDA with the packed rank, on CUDA with the dense rank (each
     must launch K2 and K3 once) and on the CPU in plain torch
     must be equal; the live-state probe
     (``log_search_probe``) on CUDA and on the CPU gives that flat
     result and equal live counts, printed as a share of each phase's
     pool;
  2b. fused parity on one 4,096-read buffer: the fused program's flat
     result and ``cov_diff`` on CUDA (every kernel launched) and on the
     CPU (plain torch, the kernels' twins) must be equal;
  3. end to end: build the graph, then genotype 40,000 reads (two
     20,000-read buffers, so submit and complete overlap), its phase
     seconds read from the run's "Timer report" log lines; the launch
     counts of K2, K3 (its hole-allocated and locked steps), K7, K8 and
     K9 are reset just before and read just after, and each must be
     above 0, the standalone K1's must be 0;
  4. output parity: on the first 4,000 reads, the port's device run
     on CUDA, with the fused recorder and with
     ``GRAMTOOLS_TPU_DEVICE_RECORD=0``, and the port's own host engine
     must write byte-equal VCF (without ##fileDate), jVCF, coverage
     dumps and personalised reference (the port's host engine and
     build are held byte-equal to the JAX package's by the CPU tests,
     tests/test_torch_standalone.py); it runs with 5c, after 5b, in a
     process of its own on the card (``--parity-phases``) beside phase
     6a's dense-rank run, and its lines print there;
  5a. the mesh on the card: the 40,000 reads through the port's
     ``quasimap_reads`` with a ``MeshLogEngine`` of two shards on the
     one card (``make_mesh(devices=[cuda, cuda])``), rank packed, fused
     recorder; stats, allele-sum, grouped counts and per-base coverage
     must equal a 1-shard run's, and the counts of the 2-shard run
     (reset just before it) must show every kernel launched; per-buffer
     host seconds of ``scan_submit`` and ``record_complete`` and the
     fallback share are printed (this one card cannot show copies
     between cards);
  5b. the SA-range-sharded index (K10): one whole 20,000-read buffer's
     scan (R = 30,720, the engine's phases, dense rank) with the index
     split over 4 and over 3 "idx" shards on the card, the scan in
     gather rounds (csrc/sharded_step.cu, two launches a step, no
     collective on one card), must equal the replicated scan's flat
     result, the engine's and the plain version's (the torch steps over
     the shards' masked gathers: one run counts them, another is timed),
     also over 20 repeated scans; K10's launches and collectives (counted
     around one scan), its time by events and traced (in a process of
     its own, ``--trace-k10``; both marked windows or the phase fails)
     beside the replicated dense-rank K2 and K3, its host enqueue, its
     bound;
  5c. ``genotype --engine device --max_threads 2`` on the 4,000 parity
     reads (spawned workers, since CUDA is initialised) must write files
     byte-equal to phase 4's host engine run (in phase 4's process);
  6. past 2**24 index rows: a P. falciparum-scale graph (23.3 Mb, 530,000
     biallelic SNP sites, the same generators, 150 bp reads from 8
     haplotypes, k = 10, seed 42; ~25.4M rows), built and its 4,000
     parity reads genotyped by the port's host engine in a process of
     its own (``--build-large``, the card hidden from it) that starts
     before phase 0, so the host's build overlaps phases 0-5b and the
     host run phase 6a's first run. Its index
     has n >= 2**24 and the one-element stub narrow table, so the
     engine's narrow plan runs every step wide: (a) ``genotype --engine
     device`` of 60,000 reads (three 20,000-read buffers) with the dense
     rank and of 40,000 (two) with the packed rank, each run's
     timer-report phases, host-fallback share and launches (set to 0
     just before and read just after: K2 one launch a scan program, all
     four phases of the plan; K3 and the standalone K1 none; K6, K7, K8
     and K9 above 0) and K8's key instance; (b) on the 4,000 parity
     reads, the device run's files byte-equal to the host engine's (the
     device run in a process of its own, ``--genotype-parity``, beside
     the packed run); (c) the dense run's warm-buffer K2 launch (144
     steps) under the dense rank
     and, on the same inputs, the packed rank, each equal bit for bit to
     its plain version over 20 repeated launches, timed by events, with
     its bound and share; (d) the index-sharded scan (K10) of a buffer
     over 4 and 3 shards equal to the replicated wide-only scan's and
     the plain version's, its launches, time by events and host enqueue
     (as 5b, untraced);
  7. the graphs gramtools is for, genotyped diploid (MixedConfig): the
     mixed graph (bench.py's ``mixed`` profile at its sizes: 4.4 Mb,
     100,000 sites, 70% SNPs, 10% direct deletions, 10% insertions, 5%
     four-allele and 5% nested sites) and a nested MSA graph
     (``build --prgs_bed`` of 40 regions of 1-4 kb, 24 rows each, on a
     2 Mb reference; common/workload.make_msa_workload), both built,
     with their 4,000 parity reads' host-engine diploid runs, by
     ``--build-mixed`` in a process of its own started before phase 0;
     (a) ``genotype --engine device --ploidy diploid`` of the mixed
     graph's 40,000 reads with the dense and with the packed rank: each
     run's phases, fallback share and reasons, launches (set to 0 just
     before, read just after; K2, K3, K7, K8 and K9 each above 0), K8's
     key instance, buffer 1's stage-4 live states a row and rows on its
     warp path, and the mapped reads at four-allele sites and on direct
     deletions (both above 0); (b) its parity reads' device run
     (``--mixed-parity``, a process of its own beside (a)) byte-equal
     to the host engine's: VCF without ##fileDate, jVCF, personalised
     reference, coverage dumps and the report without its timings and
     engine counters; (c) with the card to itself, on the dense run's
     buffer 1: K2 and K3 (its hole-allocated and locked ranges in their
     one launch) under the packed and the dense rank and K8 (K9 between
     its two launches) each equal bit for bit to its plain version over
     20 repeated launches, K7 and K9 once, each timed by events with
     its bound; (d) the MSA graph's 20,000 reads, as (a) with the dense
     rank, and its parity as (b).

``python3 chip_smoke.py --k8-turns <checkout> ...`` runs phases 0, 1,
1d and 1e, then times K8 of the other checkouts (the parent commit,
unpacked with ``git archive`` into a git-ignored directory) and of this
one on buffer 1's selection inputs in turns (the others, this, this,
the others in reverse), each turn a process of its own
(``--time-k8``), and prints no ``ok`` line. ``python3 chip_smoke.py
--scan-only`` runs phases 0, 1, 1d and 1f and stops there, printing
the kernels line but no ``ok`` line (a quick check of the scan kernels;
it is not the smoke run).

The second-to-last line is a JSON object with one entry per kernel of
the path (K1's numbers are those of its largest call on the path;
``launches`` counts phase 3's main path, ``launches_per_buffer`` phase
1d's buffers, ``trace_ms`` the device time a launch in phase 1d's
trace; K9's launch is one call of the whole per-base recorder, four
kernels; K2's is one launch a buffer, every wide phase; K3 narrow's and
K3 locked's are the same launch, one a buffer; K8's are its two
launches a buffer, and its times (phase 1e) are the whole function's,
K9 inside, its entry also holding its grid syncs and sort passes a
launch, one empty grid sync's time and the sync floor; K6's are the K2 and K3 launches that decode packed reads, its
time theirs on the packed windows, its plain time the unpack and the
two launches on its rows; K10's (``sharded_index``) launches are phase
5b's 4-shard scan's, its time that scan's, its plain time the torch
gather scan's; ``launches_large`` counts each kernel's launches in phase
6's two genotype runs (dense and packed rank), and K2's and K10's ``large`` their phase 6 numbers;
``launches_mixed`` and ``launches_msa`` count phase 7's runs, K8's
``warp_rows_mixed`` and ``warp_rows_msa`` the rows of a warm buffer on
stage 4's warp path, and ``mixed`` holds the phase 7c numbers); the
last is
``{"ok": true, "device": {...}}``. Any failed
check raises, and the script exits non-zero; it also exits non-zero,
printing no result, when no CUDA device is available. It imports no
JAX and nothing of the JAX package (it checks so at the end).
"""
from __future__ import annotations

import gzip
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

REPO = Path(__file__).resolve().parent
LIBS = ("packed_rank", "replay", "walk", "wide_step", "locked_step",
        "select", "sharded_step")                        # csrc/<name>.cu
# each entry of the kernels line: its __global__ functions (trace names
# read "(anonymous namespace)::<name>_kernel(...)", or "<name>_kernel<...>"
# for an instance of a scan kernel's template); K3's hole-allocated and
# locked steps share one kernel and one launch on the path
KERNELS = {"packed_rank": ("packed_rank",), "replay": ("replay",),
           "per_base": ("per_base_init", "per_base_expand", "per_base_walk",
                        "per_base_apply"),
           "wide_step": ("wide_steps",), "narrow_step": ("locked_tail",),
           "locked_step": ("locked_tail",), "select": ("select", "triples"),
           "unpack": ("wide_steps", "locked_tail"),
           "sharded_index": ("sharded_open", "sharded_mid")}
# the standalone K1 runs on no path since the scan kernels fold its rank
# in; K6 (the 2-bit read decode, "unpack") runs inside K2 and K3; K10 (the
# scan over sharded tables, "sharded_index") only on the index-sharded
# path (phase 5b); every other kernel must launch on each path
PATH_KERNELS = ("replay", "per_base", "wide_step", "narrow_step",
                "locked_step", "select", "unpack")
LABEL = "per_base"        # the record_function around the per-base call
# the profiling knobs: set, they change the main path's output files
STAGE_KNOBS = ("GRAMTOOLS_TPU_REPLAY_STAGE", "GRAMTOOLS_TPU_RECORD_STAGE")


@dataclass
class SmokeConfig:
    genome_len: int = 4_400_000
    num_sites: int = 100_000
    read_len: int = 150
    kmer_size: int = 10
    e2e_reads: int = 40_000       # two 20,000-read device buffers
    parity_reads: int = 4_000
    scan_reads: int = 4_096       # phases 2 and 2b
    kernel_rows: int = 524_288
    timing_runs: int = 20
    seed: int = 42


def say(msg: str):
    print(msg, flush=True)


def is_kernel(name: str, g: str) -> bool:
    """Whether a trace's kernel ``name`` is the __global__ function
    ``<g>_kernel`` (KERNELS), or an instance of it."""
    return re.search(rf"::{g}_kernel[(<]", name) is not None


def time_ms(fn, runs: int) -> float:
    """Milliseconds of one call of ``fn`` on the card: one warm-up call,
    then ``runs`` calls back to back between two CUDA events, the
    elapsed time over ``runs``. The calls queue up behind a 20 ms sleep
    of the card, so that the host's enqueue (a kernel's launch through
    ctypes and its wrapper's checks take longer than a small kernel
    runs) does not show in the time. Inputs that fit the 50 MB L2 stay
    in it from call to call, as they do on the path (the scan writes
    the log just before the replay reads it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)        # ~20 ms at the H100's ~2 GHz
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / runs


def time_each_ms(fn, runs: int) -> float:
    """Milliseconds of one call of ``fn`` that is hundreds of launches:
    the median of ``runs`` single calls, each queued behind a 50 ms
    sleep of the card and timed alone. Several such calls behind one
    sleep would fill the card's queue of pending launches (about a
    thousand), and the host would then wait, so their time would be the
    host's enqueue."""
    import statistics

    import torch

    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# H100 SXM HBM3 peak (NVIDIA's data sheet), at the 700 W power limit
HBM_BYTES_PER_MS = 3.35e12 / 1e3


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes`` (each input
    byte read once, each output byte written once); the hand kernels
    do a few integer operations a byte, so bytes bound them."""
    return nbytes / HBM_BYTES_PER_MS


def rank_bytes(rows, size: int) -> int:
    """K1's bytes: the rows read, the (M, 4) ranks written, and each
    96-byte block record that the rows need, once."""
    import torch

    M = rows.numel()
    records = torch.unique(rows.to(torch.int64).clamp(0, size) // 128).numel()
    return M * 4 + M * 16 + records * 96


def replay_bytes(f_pref, alive, log_parent, log_event, seeds, ops,
                 max_chain: int, tcap: int) -> int:
    """K7's bytes for these inputs: f_pref and alive; each log record
    (parent, event) the chains visit; each seed state's four CSR words
    and the path slots read; the ops rows of the events applied (kind,
    and site/allele of the non-empty ops); trav and ing (N, tcap, 2),
    n_trav, n_ing and bad written."""
    import torch

    N = f_pref.shape[0]
    L = max(log_parent.shape[0], 1)
    p = torch.where(alive, f_pref, -1)
    chased = [torch.zeros(0, dtype=torch.int32, device=p.device)]
    for _ in range(max_chain):
        live = p >= 0
        if not bool(live.any()):
            break
        pc = p.clamp(0, L - 1)
        chased.append(pc[live])
        p = torch.where(live, log_parent[pc], p)
    log_idx = torch.unique(torch.cat(chased))
    events = torch.unique(log_event[log_idx.to(torch.int64)])
    events = events[events >= 0].to(torch.int64)
    seed = torch.unique((-p - 1).clamp(0, seeds.k_nt.shape[0] - 1))
    p0c = min(seeds.max_path, tcap)
    slots = int((seeds.k_nt[seed].clamp(max=p0c)
                 + seeds.k_ni[seed].clamp(max=p0c)).sum())
    n_ops = ops.kind.shape[1]
    live_ops = int((ops.kind[events] != 0).sum())
    reads = (N * 5 + log_idx.numel() * 8 + seed.numel() * 16 + slots * 8
             + events.numel() * n_ops * 4 + live_ops * 8)
    return reads + N * tcap * 16 + N * 9


def make_workload(cfg: SmokeConfig, work: Path):
    """Graph, reference, reads and the built index
    (gramtools_tpu_torch.common.workload), plus the parity reads.
    Returns (idx, kmer_index, reads)."""
    from gramtools_tpu_torch.common.workload import make_workload as make
    from gramtools_tpu_torch.common.workload import write_fastq

    idx, kmer_index, reads, summary = make(
        work, cfg.genome_len, cfg.num_sites, cfg.e2e_reads, cfg.read_len,
        cfg.kmer_size, cfg.seed)
    write_fastq(work / "reads_parity.fq", reads[:cfg.parity_reads])
    say(f"[workload] {summary}")
    return idx, kmer_index, reads


def warm_hit_budget(cfg: SmokeConfig, kmer_index, reads):
    """(G, R): the warm steps' hit budget and the row capacity of the
    first device buffer, as the engine sets them (cfg.hits per 4096
    rows that pass the kmer screen)."""
    import numpy as np

    from gramtools_tpu_torch.mapping.quasimap import (DEVICE_BUFFER_SIZE,
                                                      QuasimapStats,
                                                      ReadBatch)
    from gramtools_tpu_torch.mapping.search_log_host import (
        LogConfig, _filter_buffer_rows, _row_capacity)

    batch = ReadBatch(np.ascontiguousarray(reads[:DEVICE_BUFFER_SIZE]))
    _, rows, _ = _filter_buffer_rows(batch, kmer_index, cfg.kmer_size,
                                     QuasimapStats())
    R = _row_capacity(len(rows))
    return LogConfig.hits * max(1, R // 4096), R


def phase_kernel(cfg: SmokeConfig, idx, device, b_outcomes: int,
                 warm_hits):
    """Phase 1: the CUDA kernel against its plain twin and the dense
    table. Returns (the largest absolute error, the dense (n+1, 4) table
    on the card, which phase 1d times the gather on, and phase 1b's
    numbers, K1's entry when the path keeps no K1 call)."""
    import numpy as np
    import torch

    from gramtools_tpu_torch.index.fm import FMIndex
    from gramtools_tpu_torch.prg.linearise import prg_string_to_ints
    from gramtools_tpu_torch.ops import rank

    def check(blocks_np, size, rows_np, dense=None):
        blocks = rank.blocks_tensor(blocks_np, device)
        rows = torch.from_numpy(rows_np.astype(np.int32)).to(device)
        return check_rank(cfg, rank, blocks, rows, size, dense)

    # (a) every prefix length of a small FM index
    rng = np.random.RandomState(cfg.seed)
    small = "".join("".join(rng.choice(list("ACGT"), size=50))
                    + "[" + ",".join("".join(rng.choice(list("ACGT"), size=3))
                                     for _ in range(3)) + "]"
                    for _ in range(20))
    fm = FMIndex.build(prg_string_to_ints(small + "ACGTACGT"))
    dense_small = torch.from_numpy(np.ascontiguousarray(fm.occ.T)).to(device)
    a = check(rank.build_packed_occ(fm), fm.size,
              np.arange(-1, fm.size + 8), dense_small)
    say(f"[phase 1a] small FM index (n={fm.size}), every prefix length: "
        f"kernel == twin == dense, {a['ms']:.4f} ms kernel, "
        f"{a['plain_ms']:.4f} ms twin")

    # (b) the 4.4 Mb graph's records, random rows plus the edges
    n = idx.fm.size
    blocks_np = rank.build_packed_occ(idx.fm)
    edges = np.array([-1, 0, 127, 128, 129, n, n + 7])
    rows_b = np.concatenate([rng.randint(0, n + 1, size=cfg.kernel_rows
                                         - edges.size), edges])
    dense = torch.from_numpy(np.ascontiguousarray(idx.fm.occ.T)).to(device)
    b = check(blocks_np, n, rows_b, dense)
    say(f"[phase 1b] graph records (n={n}), M={rows_b.size} rows: kernel == "
        f"twin == dense, {b['ms']:.4f} ms kernel, {b['plain_ms']:.4f} ms "
        f"twin, {b['library_ms']:.4f} ms dense gather (index_select); bound "
        f"{b['bound_ms']:.4f} ms, kernel at {100 * b['share']:.1f}% of it")

    # (c) the warm steps' newborn query count 2*G*B of the first buffer
    G, R = warm_hits
    m_c = 2 * G * b_outcomes
    rows_c = rng.randint(-1, n + 1, size=m_c)
    c = check(blocks_np, n, rows_c, dense)
    say(f"[phase 1c] M=2*G*B={m_c} rows (G={G} at R={R}, B={b_outcomes}): "
        f"kernel == twin, {c['ms']:.4f} ms kernel, {c['plain_ms']:.4f} ms "
        f"twin, {c['library_ms']:.4f} ms dense gather; bound "
        f"{c['bound_ms']:.4f} ms ({100 * c['share']:.1f}%)")
    return (max(a["max_abs_err"], b["max_abs_err"], c["max_abs_err"]),
            dense, b)


def check_rank(cfg: SmokeConfig, rank, blocks, rows, size: int, dense=None):
    """K1 on these rows: kernel == twin (== the dense table's rows where
    given), with the kernel's, the twin's and the dense gather's
    (``index_select`` on the dense (n+1, 4) table, one PyTorch call)
    times, and the bound."""
    import torch

    got = rank.packed_rank_cuda(blocks, rows, size)
    plain = rank.packed_occ_rows_torch(blocks, rows, size)
    err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max())
    if not torch.equal(got, plain):
        raise AssertionError(f"kernel != twin (max abs err {err})")
    out = {"max_abs_err": err,
           "ms": time_ms(lambda: rank.packed_rank_cuda(blocks, rows, size),
                         cfg.timing_runs),
           "plain_ms": time_ms(
               lambda: rank.packed_occ_rows_torch(blocks, rows, size), 3),
           "library_ms": None,
           "bound_ms": bound_ms(rank_bytes(rows, size))}
    if dense is not None:
        clamped = rows.to(torch.int64).clamp(0, size)
        if not torch.equal(got, torch.index_select(dense, 0, clamped)):
            raise AssertionError("kernel != dense occ table")
        out["library_ms"] = time_ms(
            lambda: torch.index_select(dense, 0, clamped), cfg.timing_runs)
    out["share"] = out["bound_ms"] / out["ms"]
    return out


def phase_scan(cfg: SmokeConfig, idx, kmer_index, reads, device):
    """Phase 2: one buffer's flat scan result, three ways; then the
    live-state probe (``log_search_probe``) on CUDA and on the CPU:
    final carry and log equal to the flat result, live counts per phase
    equal."""
    import numpy as np
    import torch

    from gramtools_tpu_torch.mapping.quasimap import QuasimapStats, ReadBatch
    from gramtools_tpu_torch.mapping.device_index import DeviceIndex
    from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
    from gramtools_tpu_torch.mapping.search_log import (log_search_packed,
                                                        log_search_probe)
    from gramtools_tpu_torch.ops import locked_step, wide_step

    os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    engine = LogBatchedEngine(idx, cfg.kmer_size, device=device)
    batch = ReadBatch(np.ascontiguousarray(reads[:cfg.scan_reads]))
    tails = (wide_step.wide_steps.launches, locked_step.locked_tail.launches,
             locked_step.locked_tail.narrow_launches)
    t0 = time.perf_counter()
    token = engine.scan_submit(batch, kmer_index, cfg.kmer_size,
                               QuasimapStats())
    (pending, phases, R), carry, reads_T = token[2], token[5], token[6]
    flat_packed = pending.get()
    packed_s = time.perf_counter() - t0

    def run_dense(dev):
        di = DeviceIndex.build(idx, engine.jt, dev)
        t = time.perf_counter()
        flat = log_search_packed(
            di, torch.from_numpy(reads_T).to(dev),
            tuple(torch.from_numpy(a).to(dev) for a in carry), phases, R)
        out = flat.cpu().numpy()
        return out, time.perf_counter() - t

    flat_dense, dense_s = run_dense(device)
    # both CUDA scans ran as two launches: the wide phases, then the
    # narrow and locked phases
    if phases[-1][4:] != ("locked",) or (
            wide_step.wide_steps.launches,
            locked_step.locked_tail.launches,
            locked_step.locked_tail.narrow_launches) != tuple(
                n + 2 for n in tails):
        raise AssertionError("the CUDA scans did not launch the scan kernels "
                             "once each")
    # the plain run on the CPU uses the packed rank's torch twin
    di_cpu = DeviceIndex.build(idx, engine.jt, "cpu")
    t = time.perf_counter()
    flat_cpu = log_search_packed(
        di_cpu, torch.from_numpy(reads_T),
        tuple(torch.from_numpy(a) for a in carry), phases, R,
        blocks=engine.blocks.cpu(), rank="packed").numpy()
    cpu_s = time.perf_counter() - t
    for name, other in (("dense", flat_dense), ("cpu", flat_cpu)):
        if not np.array_equal(flat_packed, other):
            raise AssertionError(f"flat scan result: packed != {name} "
                                 f"({int((flat_packed != other).sum())} "
                                 "words differ)")
    N = phases[-1][1]
    live = int((flat_packed[:N] >= 0).sum())
    ovf = int(flat_packed[4 * N:4 * N + R].sum())
    say(f"[phase 2] scan of {len(token[1])} rows (R={R}, phases={phases}): "
        f"flat result ({flat_packed.size} int32) equal on {device.type} "
        f"packed, {device.type} dense (each one wide-step and one "
        f"narrow-tail launch) and "
        f"cpu (the plain versions); {live} live states, {ovf} "
        f"rows overflowed; {packed_s:.3f} s submit+scan packed, "
        f"{dense_s:.3f} s dense, {cpu_s:.3f} s cpu")

    def probe(dev, blocks):
        (rid, lo, hi, pref, ovf), (lp, le), live = log_search_probe(
            engine.di if dev == device else di_cpu,
            torch.from_numpy(reads_T).to(dev),
            tuple(torch.from_numpy(a).to(dev) for a in carry), phases, R,
            blocks=blocks, rank="packed")
        flat = torch.cat([rid, lo, hi, pref, ovf.to(torch.int32), lp, le])
        return flat.cpu().numpy(), live.cpu().numpy()

    flat_c, live_c = probe(device, engine.blocks)
    flat_h, live_h = probe(torch.device("cpu"), engine.blocks.cpu())
    for name, flat in ((device.type, flat_c), ("cpu", flat_h)):
        if not np.array_equal(flat, flat_packed):
            raise AssertionError(f"probe on {name}: final carry and log != "
                                 "the flat scan result")
    if not np.array_equal(live_c, live_h):
        raise AssertionError(f"probe live counts: {device.type} {live_c} != "
                             f"cpu {live_h}")
    say(f"[phase 2] log_search_probe, live states after each phase (equal "
        f"on {device.type} and cpu, final carry and log equal to the flat "
        f"result): " + "; ".join(
            f"phase {i} (pool {e[1]}): {n} live = {100 * n / e[1]:.1f}%"
            for i, (e, n) in enumerate(zip(phases, live_c.tolist()))))


def _first_draws(cfg: SmokeConfig, n: int, salt: int):
    """Selection seeds and mt19937 first draws of one buffer."""
    import numpy as np

    from gramtools_tpu_torch.common.rng import RandomInclusiveInt, first_raw_draws

    seeds = RandomInclusiveInt(cfg.seed + salt).raw_block(n)
    return seeds, first_raw_draws(np.asarray(seeds, dtype=np.uint32))


def _profile_device(fn, trace_dir: Path):
    """Runs fn inside gramtools_tpu_torch.common.timers.device_trace
    (a torch.profiler Chrome trace into trace_dir). Returns (device busy
    ms, device event count, [(kernel name, device ms, launches)] by
    device time), or (None, None, []) when it shows no device time."""
    import collections

    import torch

    from gramtools_tpu_torch.common.timers import device_trace

    with device_trace(trace_dir) as prof:
        fn()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    busy_us, kernels, timeline = 0.0, 0, []
    for ev in prof.events():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.name == LABEL):        # the annotation's own span
            continue
        t = getattr(ev, "device_time", None)
        if t is None:
            t = getattr(ev, "cuda_time", 0.0)
        busy_us += t
        kernels += 1
        by_name[ev.name][0] += t
        by_name[ev.name][1] += 1
        timeline.append((ev.time_range.start, t, ev.name))
    top = sorted(((name, us / 1000.0, n) for name, (us, n)
                  in by_name.items()), key=lambda e: -e[1])
    if busy_us <= 0:
        return None, None, [], []
    return busy_us / 1000.0, kernels, top, sorted(timeline)


MARK = "spin_kernel"      # torch.cuda._sleep's kernel: the window markers


def marked(fn):
    """fn inside torch.profiler.record_function(LABEL), with a
    ``torch.cuda._sleep`` kernel launched just before and just after it:
    one stream runs in order, so the device events between two markers
    are the ones fn enqueued (``marked_windows``)."""
    import torch

    def wrapper(*args, **kwargs):
        torch.cuda._sleep(100)
        with torch.profiler.record_function(LABEL):
            out = fn(*args, **kwargs)
        torch.cuda._sleep(100)
        return out
    return wrapper


def marked_windows(timeline):
    """[(device events, device busy ms, span ms)] of each window between
    a pair of markers in a trace's timeline."""
    idx = [i for i, (_, _, name) in enumerate(timeline) if MARK in name]
    out = []
    for a, b in zip(idx[::2], idx[1::2]):
        inside = timeline[a + 1:b]
        if not inside:
            out.append((0, 0.0, 0.0))
            continue
        busy = sum(t for _, t, _ in inside) / 1000.0
        span = (inside[-1][0] + inside[-1][1] - inside[0][0]) / 1000.0
        out.append((len(inside), busy, span))
    return out


def phase_path(cfg: SmokeConfig, idx, kmer_index, reads, device,
               work: Path, dense, k1_b, probe):
    """Phase 1d: the fused engine at the path's shapes, with its stage
    timers on (``GRAMTOOLS_TPU_TIMERS=1``, printed buffer by buffer);
    every kernel's launches counted buffer by buffer; K1's calls, K7's
    and K9's inputs and the selection's inputs and outputs kept from the
    second buffer, and each kernel held against its twin on them; the
    third buffer inside device_trace, its device time split by kernel
    name. Returns (the kernels' JSON entries, without the main path's
    launch counts; the kept calls)."""
    import traceback

    import numpy as np
    import torch

    from gramtools_tpu_torch.mapping import record, search_log
    from gramtools_tpu_torch.mapping.coverage import Coverage
    from gramtools_tpu_torch.mapping.quasimap import (DEVICE_BUFFER_SIZE,
                                                      QuasimapStats,
                                                      ReadBatch)
    from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
    from gramtools_tpu_torch.ops import (locked_step, packed_reads, rank,
                                         replay, wide_step)

    os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    B = DEVICE_BUFFER_SIZE
    os.environ["GRAMTOOLS_TPU_TIMERS"] = "1"
    try:
        engine = LogBatchedEngine(idx, cfg.kmer_size, device=device)
    finally:
        os.environ.pop("GRAMTOOLS_TPU_TIMERS")
    assert engine.device_record and engine._timing
    stats = QuasimapStats()
    coverage = Coverage.empty(idx)
    starts = [0, B, 0]          # the third buffer repeats the first's reads
    captured = {"packed_rank": []}

    def keep(name, fn):
        def wrapper(*args, **kwargs):
            captured[name] = (args, kwargs)
            out = fn(*args, **kwargs)
            captured[name + "_out"] = out
            return out
        return wrapper

    def keep_scan(name, fn):
        def wrapper(*args):
            captured[name] = (args, {})
            out = fn(*args)
            captured[name + "_out"] = out
            return out
        return wrapper

    def keep_rank(blocks, rows, size):
        captured["packed_rank"].append((blocks, rows, size))
        return packed_rank_cuda(blocks, rows, size)

    def refuse_unpack(*args, **kwargs):
        raise AssertionError("the fused path ran unpack_reads2 (K6 is "
                             "decoded inside K2 and K3)")

    packed_rank_cuda = rank.packed_rank_cuda
    locked_tail_cuda = locked_step.locked_tail_cuda
    wide_steps_cuda = wide_step.wide_steps_cuda
    per_base = record._record_per_base_device
    select = search_log.select_and_record_device
    unpack = packed_reads.unpack_reads2
    packed_reads.unpack_reads2 = refuse_unpack
    lines, per_buffer = [], []
    for b, start in enumerate(starts):
        timers0 = dict(engine.timers)
        batch = ReadBatch(np.ascontiguousarray(reads[start:start + B]))
        sel_seeds, firsts = _first_draws(cfg, B, b)
        for fn in _counted().values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if b == 1:
            record.replay = keep("replay", replay.replay)
            record._record_per_base_device = keep("per_base", per_base)
            search_log.select_and_record_device = keep("select", select)
            rank.packed_rank_cuda = keep_rank
            locked_step.locked_tail_cuda = keep_scan("locked",
                                                     locked_tail_cuda)
            wide_step.wide_steps_cuda = keep_scan("wide", wide_steps_cuda)
            torch.cuda.set_sync_debug_mode("error")
            try:
                token = engine.scan_submit(batch, kmer_index, cfg.kmer_size,
                                           stats, first_raws=firsts)
            except RuntimeError:
                say("[phase 1d] scan_submit synchronised under sync debug "
                    "mode:\n" + traceback.format_exc())
                raise
            finally:
                torch.cuda.set_sync_debug_mode("default")
                record.replay = replay.replay
                record._record_per_base_device = per_base
                search_log.select_and_record_device = select
                rank.packed_rank_cuda = packed_rank_cuda
                locked_step.locked_tail_cuda = locked_tail_cuda
                wide_step.wide_steps_cuda = wide_steps_cuda
            busy_ms = kernels = None
        elif b == 2:
            # after the buffer, in the same trace: the per-base recorder
            # alone on buffer 1's inputs, as the kernels and as the sort
            # design (each between markers)
            sort_fn = sort_design(probe_cursor_walk(
                cfg, probe, per_base_lanes(captured["per_base"][0])[0]))
            box = {}

            def traced():
                box["token"] = engine.scan_submit(
                    batch, kmer_index, cfg.kmer_size, stats,
                    first_raws=firsts)
                box["launches"] = {name: fn.launches
                                   for name, fn in _counted().items()}
                record._record_per_base_device = per_base
                for fn in (per_base, sort_fn):
                    marked(fn)(*fresh_cov(captured["per_base"][0]))

            record._record_per_base_device = marked(per_base)
            try:
                busy_ms, kernels, top, timeline = _profile_device(
                    traced, work / "trace")
            finally:
                record._record_per_base_device = per_base
            token = box["token"]
        else:
            token = engine.scan_submit(batch, kmer_index, cfg.kmer_size,
                                       stats, first_raws=firsts)
            busy_ms = kernels = None
        submit_s = time.perf_counter() - t0
        assert token[2][0] == "record", "the fused program did not run"
        R = token[2][2]
        t0 = time.perf_counter()
        token[2][1].get()
        wait_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine.record_complete(token, sel_seeds, firsts, stats, coverage)
        complete_s = time.perf_counter() - t0
        per_buffer.append(box["launches"] if b == 2 else
                          {name: fn.launches for name, fn in _counted().items()})
        timers = {k: round(v - timers0.get(k, 0.0), 4)
                  for k, v in engine.timers.items()}
        lines.append(
            f"buffer {b}: scan_submit {submit_s:.3f} s host, then waited "
            f"{wait_s:.3f} s for the result, record_complete {complete_s:.3f}"
            f" s host, engine timers (s) {timers}, launches {per_buffer[-1]}"
            + ("" if busy_ms is None else
               f"; profiled, with the two per-base calls traced after it: "
               f"device busy {busy_ms:.1f} ms over {kernels} device events")
            + (" [sync debug mode 'error': no synchronisation]"
               if b == 1 else ""))
    packed_reads.unpack_reads2 = unpack
    engine.flush_device_coverage()
    say(f"[phase 1d] fused engine, R={R} rows a buffer, phases "
        f"{sorted({s[1] for s in engine.dispatch_shapes})}: "
        + "; ".join(lines) + f"; device_mapped {engine.device_mapped}, "
        f"host_fallbacks {engine.host_fallbacks}, device_retried "
        f"{engine.device_retried}, fallback_reasons "
        f"{dict(engine.fallback_reasons)}")
    # device ms a launch, from the trace of buffer 2
    trace_ms = dict.fromkeys(KERNELS)
    windows = [None] * 3
    if busy_ms is None:
        say("[phase 1d] trace: the profiler showed no device time")
    else:
        found = marked_windows(timeline)
        if len(found) == 3:
            windows = found
            # the buffer's own device time, without the two calls after it
            busy_ms -= found[1][1] + found[2][1]
            kernels -= found[1][0] + found[2][0]
        else:
            say(f"[phase 1d] trace: {len(found)} marked windows, not 3 "
                f"({sum(MARK in n for _, _, n in timeline)} markers)")
        ours = {k: sum(ms for name, ms, _ in top
                       if any(is_kernel(name, g) for g in KERNELS[k]))
                for k in KERNELS}
        for k in ("packed_rank", "replay", "wide_step", "locked_step",
                  "select"):
            if per_buffer[2][k]:
                trace_ms[k] = ours[k] / per_buffer[2][k]
        k8_events = sum(n for name, _, n in top if any(
            is_kernel(name, g) for g in KERNELS["select"]))
        if windows[0] is not None:
            trace_ms["per_base"] = windows[0][1]
        say(f"[phase 1d] trace of buffer 2 (device_trace, Chrome trace): "
            f"{busy_ms:.2f} ms device busy over {kernels} device events "
            f"({len(top)} kernel names); "
            f"K1 {ours['packed_rank']:.3f} ms, K7 {ours['replay']:.3f} ms, "
            f"K2 {ours['wide_step']:.3f} ms, "
            f"K3 (narrow and locked) {ours['locked_step']:.3f} ms, "
            f"K8 {ours['select']:.3f} ms over {k8_events} device events "
            f"(its 2 launches; with K9's 4 inside, "
            f"{k8_events + len(KERNELS['per_base'])} events), "
            f"K9 {trace_ms['per_base'] or float('nan'):.4f} ms (its 4 "
            f"kernels, the marked call; "
            f"the trace also holds the two per-base calls after the buffer, "
            f"left out of the busy time; by kernel, the mean of 2 calls: "
            + ", ".join(f"{g} " + "{:.4f} ms".format(sum(
                ms for name, ms, _ in top if is_kernel(name, g)) / 2)
                for g in KERNELS["per_base"])
            + "); top kernels by device time: "
            + "; ".join(f"{name[:60]} {ms:.3f} ms x{n}"
                        for name, ms, n in top[:12]))
        if not all(v for k, v in ours.items() if k in PATH_KERNELS):
            say("[phase 1d] trace: names outside at::native: " + "; ".join(
                f"{name[:80]} {ms:.3f} ms x{n}" for name, ms, n in top
                if "at::native" not in name)[:2000])
    captured["tail_windows"] = trace_tail_designs(
        engine, batch, kmer_index, cfg, stats, firsts, work)
    captured["per_buffer"], captured["trace_ms"] = per_buffer, trace_ms
    entry = lambda name, source, replaces, m: kernel_entry(
        name, source, replaces, m, per_buffer, trace_ms)

    # K1: every call of buffer 1 against the twin; the largest one timed.
    # The scan kernels fold its rank in, so the path keeps none: then its
    # entry is phase 1b's (the graph's records, 524,288 rows).
    calls = captured["packed_rank"]
    for blocks, rows, size in calls:
        if not torch.equal(rank.packed_rank_cuda(blocks, rows, size),
                           rank.packed_occ_rows_torch(blocks, rows, size)):
            raise AssertionError("packed_rank kernel != twin on a path call")
    if calls:
        buffer_bytes = sum(rank_bytes(r, n) for _, r, n in calls)
        blocks, rows, size = max(calls, key=lambda c: c[1].numel())
        k1 = check_rank(cfg, rank, blocks, rows, size, dense)
        say(f"[phase 1d] K1 on buffer 1: {len(calls)} calls, "
            f"{sum(c[1].numel() for c in calls)} rows, every call kernel == "
            f"twin, bound of all of them {bound_ms(buffer_bytes):.4f} ms "
            f"({buffer_bytes} bytes); the largest, M={rows.numel()}: "
            f"{k1['ms']:.4f} ms kernel, {k1['plain_ms']:.4f} ms twin, "
            f"{k1['library_ms']:.4f} ms dense gather (index_select); bound "
            f"{k1['bound_ms']:.4f} ms ({rank_bytes(rows, size)} bytes), "
            f"kernel at {100 * k1['share']:.1f}% of it"
            + ("" if trace_ms["packed_rank"] is None else
               f", {trace_ms['packed_rank']:.4f} ms a launch in the trace"))
    else:
        k1 = k1_b
        say("[phase 1d] K1 on buffer 1: no standalone call (the scan kernels "
            "fold the packed rank in); its entry is phase 1b's")
    entries = [entry("packed_rank", "gramtools_tpu_torch/csrc/packed_rank.cu",
                     "gramtools_tpu/ops/rank.py:136", k1)]
    entries.append(entry("replay", "gramtools_tpu_torch/csrc/replay.cu",
                         "gramtools_tpu/mapping/record_jax.py:251",
                         check_replay(cfg, captured["replay"], trace_ms)))
    entries.append(entry("per_base", "gramtools_tpu_torch/csrc/walk.cu",
                         "gramtools_tpu/mapping/record_jax.py:714",
                         check_per_base(cfg, captured["per_base"], windows,
                                        sort_fn)))
    return entries, captured


def check_k6(cfg: SmokeConfig, captured, work: Path, bound: float):
    """K6, the 2-bit read decode inside K2 and K3, on buffer 1's inputs:
    K2 and K3 on the path's packed windows equal (carry, flags, every
    log record) to K2 and K3 on the plain unpack's rows
    (``ops/packed_reads.unpack_reads2``, on the card, itself equal to its
    CPU run); both pairs and the unpack timed by queued events and
    traced once. Returns K6's entry of the kernels line: its time is the
    two launches it runs in, on the packed windows; the plain version's,
    the unpack and the two launches on its rows (the path before the
    decode moved into the kernels); ``bound`` the two launches' byte
    bound with the packed reads (K2's, K3 narrow's and K3 locked's)."""
    import torch

    from gramtools_tpu_torch.ops import locked_step, packed_reads, wide_step

    (wargs, _), (targs, _) = captured["wide"], captured["locked"]
    wreads, treads = wargs[1], targs[1]
    if not (isinstance(wreads, packed_reads.PackedReads)
            and isinstance(treads, packed_reads.PackedReads)):
        raise AssertionError("the path's scan kernels did not get packed "
                             "reads")
    full = packed_reads.PackedReads(                 # the whole matrix
        wreads.packed, wreads.row_len, wreads.kmer_size, wreads.steps)
    unpack = lambda: full.unpack()
    rows = unpack()
    if not torch.equal(rows.cpu(), packed_reads.unpack_reads2(
            full.packed.cpu(), full.row_len.cpu(), full.steps,
            full.kmer_size)):
        raise AssertionError("unpack_reads2 on the card != on the CPU")
    w_rows = rows[wreads.start:wreads.stop]
    t_rows = rows[treads.start:treads.stop]
    lp, le = wargs[5], wargs[6]

    def pair(w, t, lp_, le_):
        wide_step.wide_steps_cuda(wargs[0], w, *wargs[2:5], lp_, le_,
                                  *wargs[7:])
        return locked_step.locked_tail_cuda(targs[0], t, *targs[2:4], lp_,
                                            le_, *targs[6:])

    def run(w, t):
        lp2, le2 = torch.full_like(lp, -7), torch.full_like(le, -7)
        return tuple(pair(w, t, lp2, le2)) + (lp2, le2)

    got = run(wreads, treads)
    try:
        err = _equal(got, run(w_rows, t_rows))
    except AssertionError as e:
        raise AssertionError(f"K2 and K3 on packed reads != on the "
                             f"unpacked rows: {e}") from None
    lp_t, le_t = torch.empty_like(lp), torch.empty_like(le)
    packed_fn = lambda: pair(wreads, treads, lp_t, le_t)
    rows_fn = lambda: pair(w_rows, t_rows, lp_t, le_t)

    def plain_fn():
        r = unpack()
        return pair(r[wreads.start:wreads.stop], r[treads.start:treads.stop],
                    lp_t, le_t)

    m = {"max_abs_err": err, "ms": time_ms(packed_fn, cfg.timing_runs),
         "plain_ms": time_ms(plain_fn, cfg.timing_runs),
         "library_ms": None, "bound_ms": bound}
    rows_ms = time_ms(rows_fn, cfg.timing_runs)
    unpack_ms = time_ms(unpack, cfg.timing_runs)
    windows = trace_each([packed_fn, rows_fn, unpack], work / "trace_k6")
    ubytes = (full.packed.numel() + full.row_len.numel() * 4
              + rows.numel() * 4)
    shown = lambda w: ("not traced" if w is None else
                       f"{w[1]:.4f} ms busy over {w[0]} device events")
    say(f"[phase 1f] K6 (the 2-bit read decode inside K2 and K3) on buffer "
        f"1: K2 on the packed window of steps [{wreads.start}, "
        f"{wreads.stop}) and K3 on [{treads.start}, {treads.stop}) of "
        f"({full.packed.shape[0]}, {full.packed.shape[1]}) packed rows == "
        f"K2 and K3 on unpack_reads2's rows (carry, flags, every log "
        f"record); the unpack equal on the card and the CPU. Queued events: "
        f"K2 + K3 on packed reads {m['ms']:.4f} ms, on the unpacked rows "
        f"{rows_ms:.4f} ms (the decode adds {m['ms'] - rows_ms:+.4f} ms), "
        f"the unpack alone {unpack_ms:.4f} ms (bound "
        f"{bound_ms(ubytes):.4f} ms, {ubytes} bytes), unpack + K2 + K3 "
        f"{m['plain_ms']:.4f} ms; traced: packed {shown(windows[0])}, rows "
        f"{shown(windows[1])}, unpack {shown(windows[2])}; the two "
        f"launches' bound with packed reads {m['bound_ms']:.4f} ms, at "
        f"{100 * m['bound_ms'] / m['ms']:.2f}% of it by events; "
        f"launches a buffer "
        f"{[c['unpack'] for c in captured['per_buffer']]}")
    trace_ms = dict(captured["trace_ms"],
                    unpack=None if windows[0] is None else windows[0][1])
    entry = kernel_entry("unpack", "gramtools_tpu_torch/csrc/scan_common.cuh",
                         "gramtools_tpu/mapping/search_jax_log.py:622", m,
                         captured["per_buffer"], trace_ms)
    entry.update(rows_ms=rows_ms, unpack_ms=unpack_ms,
                 unpack_bound_ms=bound_ms(ubytes))
    return entry


def kernel_entry(name, source, replaces, m, per_buffer, trace_ms):
    """One kernel's entry of the kernels line (without the main path's
    launch counts, which phase 3 adds)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": "bytes",
            "library_ms": m["library_ms"],
            "launches_per_buffer": [c[name] for c in per_buffer],
            "trace_ms": trace_ms[name]}


class _k1_rows:
    """Inside it, the scan twins gather their occ rows through K1 (the
    packed-rank kernel), as the path's torch steps did before the scan
    kernels."""

    def __enter__(self):
        from gramtools_tpu_torch.ops import rank

        self.plain = rank.plain_packed_rows
        rank.plain_packed_rows = rank.make_packed_occ_rows

    def __exit__(self, *exc):
        from gramtools_tpu_torch.ops import rank

        rank.plain_packed_rows = self.plain


def k1_wide_steps(*args, **kwargs):
    """The wide phases as the path ran them before K2: the torch steps,
    their occ gathers through K1."""
    from gramtools_tpu_torch.ops import wide_step

    with _k1_rows():
        return wide_step.wide_steps_torch(*args, **kwargs)


def k1_narrow_tail(di, reads, carry, log_base, lp, le, hits, wide_budget,
                   blocks=None, lock=True, narrow=None):
    """The narrow phase as the path ran it before K3 narrow (the torch
    steps, their occ gathers through K1), then the locked phase as one
    launch of the K3 kernel."""
    from gramtools_tpu_torch.ops import locked_step

    if narrow is None:
        return locked_step.locked_tail(di, reads, carry, log_base, lp, le,
                                       hits, wide_budget, blocks, lock)
    n = narrow[0]
    with _k1_rows():
        carry = locked_step.locked_tail_torch(
            di, reads[:n], carry, log_base, lp, le, hits, wide_budget, blocks,
            False, narrow)
    carry = tuple(a.contiguous() for a in carry)     # the kernel's inputs
    return locked_step.locked_tail(
        di, reads[n:], carry, log_base + n * narrow[2] * di.n_outcomes, lp, le,
        hits, wide_budget, blocks, lock)


def trace_tail_designs(engine, batch, kmer_index, cfg, stats, firsts,
                       work: Path):
    """One buffer's scan_submit twice in one torch.profiler session,
    each between markers: the path (the scan in two launches, K2 and K3)
    and the path before K2 and K3 narrow (the wide and narrow phases as
    torch steps with K1, the locked phase one K3 launch). Returns their
    [(device events, busy ms, span ms)], or [] when the trace shows no
    window."""
    import torch

    from gramtools_tpu_torch.mapping import search_log

    tokens = []
    path = (search_log.wide_steps, search_log.locked_tail)

    def submit():
        tokens.append(engine.scan_submit(batch, kmer_index, cfg.kmer_size,
                                         stats, first_raws=firsts))

    def traced():
        # the session's first events (a profiler session may miss them),
        # not a marker
        torch.ones(1, device=engine.device).add_(1)
        torch.cuda.synchronize()
        marked(submit)()
        search_log.wide_steps, search_log.locked_tail = (k1_wide_steps,
                                                         k1_narrow_tail)
        try:
            marked(submit)()
        finally:
            search_log.wide_steps, search_log.locked_tail = path

    busy, _, _, timeline = _profile_device(traced, work / "trace_tail")
    for token in tokens:
        token[2][1].get()
    windows = marked_windows(timeline) if busy is not None else []
    return windows if len(windows) == 2 else []


def check_replay(cfg: SmokeConfig, call, trace_ms):
    """K7 on the path's inputs and on a forced-bad case (max_chain 2,
    tcap 4): every output equal to the twin's, bit for bit."""
    import torch

    from gramtools_tpu_torch.ops import replay

    args, kwargs = call
    assert args[8] == 99, "the path's replay ran a profiling stage"
    args = args[:8]

    def compare(a):
        got = replay.replay_cuda(*a)
        want = replay.replay_torch(*a)
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  if g.numel() else 0 for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"replay kernel != twin (max abs err {err}, "
                                 f"max_chain {a[6]}, tcap {a[7]})")
        return err, got

    assert not kwargs
    err, got = compare(args)
    forced = args[:6] + (2, 4)
    err_f, got_f = compare(forced)
    m = {"max_abs_err": max(err, err_f),
         "ms": time_ms(lambda: replay.replay_cuda(*args), cfg.timing_runs),
         "plain_ms": time_ms(lambda: replay.replay_torch(*args), 3),
         "library_ms": None}
    nbytes = replay_bytes(*args)
    m["bound_ms"] = bound_ms(nbytes)
    N = args[0].shape[0]
    say(f"[phase 1d] K7 replay at N={N} pool states, log of "
        f"{args[2].shape[0]} records: kernel == twin ({int(args[1].sum())} "
        f"live, {int(got[4].sum())} bad; forced max_chain 2, tcap 4: "
        f"{int(got_f[4].sum())} bad, equal), {m['ms']:.4f} ms kernel, "
        f"{m['plain_ms']:.4f} ms twin; bound {m['bound_ms']:.4f} ms "
        f"({nbytes} bytes), kernel at {100 * m['bound_ms'] / m['ms']:.1f}%"
        + ("" if trace_ms["replay"] is None else
           f", {trace_ms['replay']:.4f} ms a launch in the trace"))
    return m


FORCED_TAIL = (8, 4)     # phase 1f's forced K3 (hits, wide budget)
FORCED_WIDE_HITS = 64    # phase 1f's forced hit budget of each wide phase


def log_bytes(di, le, log_base: int, records: int, row: int) -> int:
    """The log records written once, and per hit pair with a locus past
    0 (``le`` >= B) its locus and outcome words and two occ rows of
    ``row`` bytes for each valid outcome."""
    import torch

    B = di.n_outcomes
    ev = le[log_base:log_base + records].to(torch.int64)
    hit = ev >= B
    li, b = ev // B, ev % B
    outcome = hit & (di.out_lo[li.clamp(0, di.out_lo.shape[0] - 1), b] >= 0)
    return records * 8 + 8 * int(hit.sum()) + 2 * row * int(outcome.sum())


def rows_and_bytes(reads):
    """(int32 base rows, the bytes a launch reads of them): a
    PackedReads window's are its packed rows and the row lengths."""
    from gramtools_tpu_torch.ops.packed_reads import PackedReads

    if isinstance(reads, PackedReads):
        S, R = reads.shape
        first, last = reads.start // 4, (reads.stop - 1) // 4
        return reads.unpack(), (last - first + 1) * R * (S > 0) + 4 * R
    return reads, reads.numel() * 4


def wide_bytes(args, le) -> int:
    """K2's bytes for these inputs (a lower bound): the reads rows, the
    incoming carry and flags read once, the final carry and flags and
    every log record written once; each step's two occ rows (16 bytes
    dense, 32 the packed checkpoint and code vector) of every active
    state; and ``log_bytes``. The active states per step come from
    stepping the plain version."""
    from gramtools_tpu_torch.mapping.scan_steps import (build_log_step,
                                                        resize_pool)
    from gramtools_tpu_torch.mapping.search_log_host import LogConfig
    from gramtools_tpu_torch.ops import rank

    di, reads, carry, phases, log_base, _, _, blocks = args
    reads, reads_bytes = rows_and_bytes(reads)
    S, R = reads.shape
    B = di.n_outcomes
    row = 16 if blocks is None else 32
    occ_rows = (None if blocks is None
                else rank.plain_packed_rows(blocks, di.size))
    c, active, off, base = carry, 0, 0, log_base
    for n_steps, pool, g in phases:
        c = resize_pool(c, pool, R)
        step = build_log_step(di, LogConfig(pool=pool, hits=g), R,
                              occ_rows=occ_rows)
        for i in range(n_steps):
            valid = c[0] >= 0
            active += int((valid & (reads[off + i][c[0].clamp(0, R - 1)]
                                    > 0)).sum())
            c, _ = step(c, reads[off + i], base)
            base += g * B
        off += n_steps
    records = sum(n * g for n, _, g in phases) * B
    return (reads_bytes + carry[0].shape[0] * 16 + 2 * (R + 1)
            + phases[-1][1] * 16 + 2 * row * active
            + log_bytes(di, le, log_base, records, row))


def step_cnts(di, c, row, occ_rows, W=None, locked=False):
    """Each slot's marker hits in one step from the carry ``c`` (the
    plain version's rules): a wide step's active states (W None), or a
    narrow step's singles at a marker and its covered wide states."""
    import torch

    from gramtools_tpu_torch.mapping import scan_steps

    R = row.shape[0]
    rid, lo, hi = c[:3]
    valid = rid >= 0
    base = torch.where(valid, row if locked else row[rid.clamp(0, R - 1)], 0)
    active = valid & (base > 0)
    k = scan_steps._Consts(di, 1, 1)
    _, _, m_lo, m_hi = scan_steps._lf_extend(di, k, occ_rows, lo, hi, base)
    if W is None:
        return torch.where(active, m_hi - m_lo, 0)
    single = lo == hi
    sym = di.narrow_tab[lo.clamp(0, di.size - 1)] >> 24
    wide = active & ~single
    covered = single | (wide & (torch.cumsum(wide.int(), 0) - wide.int() < W))
    return torch.where(active & covered,
                       torch.where(single, (sym == 5).int(), m_hi - m_lo), 0)


def wide_cnts(args):
    """[(each slot's hits, G)] of every step of K2's inputs ``args``,
    stepping the plain version."""
    from gramtools_tpu_torch.mapping.scan_steps import (build_log_step,
                                                        dense_occ_rows,
                                                        resize_pool)
    from gramtools_tpu_torch.mapping.search_log_host import LogConfig
    from gramtools_tpu_torch.ops import rank

    di, reads, carry, phases, log_base, _, _, blocks = args
    reads = rows_and_bytes(reads)[0]
    R = reads.shape[1]
    occ_rows = (dense_occ_rows(di) if blocks is None
                else rank.plain_packed_rows(blocks, di.size))
    c, off, out = carry, 0, []
    for n_steps, pool, g in phases:
        c = resize_pool(c, pool, R)
        step = build_log_step(di, LogConfig(pool=pool, hits=g), R,
                              occ_rows=occ_rows)
        for i in range(n_steps):
            out.append((step_cnts(di, c, reads[off + i], occ_rows), g))
            c, _ = step(c, reads[off + i], log_base)
        off += n_steps
    return out


def narrow_cnts(args):
    """[(each slot's hits, G)] of every hole-allocated step of K3's
    inputs ``args``, stepping the plain version."""
    from gramtools_tpu_torch.mapping.scan_steps import (build_narrow_step,
                                                        dense_occ_rows,
                                                        resize_pool)
    from gramtools_tpu_torch.mapping.search_log_host import LogConfig
    from gramtools_tpu_torch.ops import rank

    di, reads, carry, log_base, _, _, _, _, blocks, _, narrow = args
    n, pool, g, w = narrow
    reads = rows_and_bytes(reads)[0]
    R = reads.shape[1]
    occ_rows = (dense_occ_rows(di) if blocks is None
                else rank.plain_packed_rows(blocks, di.size))
    c = resize_pool(carry, pool, R)
    step = build_narrow_step(di, LogConfig(pool=pool, hits=g), R, w,
                             occ_rows=occ_rows)
    out = []
    for i in range(n):
        out.append((step_cnts(di, c, reads[i], occ_rows, W=w), g))
        c, _ = step(c, reads[i], log_base)
    return out


def tail_bytes(args, le) -> int:
    """K3's bytes for these inputs (a lower bound): the reads rows, the
    incoming carry and flags read once, the final carry and flags
    written once; each step's narrow_tab word of every live state and
    two occ rows (16 bytes dense, 32 the packed checkpoint and code
    vector) of each covered wide state; and ``log_bytes``. The live and
    wide states per step come from stepping the plain version."""
    from gramtools_tpu_torch.mapping.scan_steps import (build_narrow_step,
                                                        lock_pool,
                                                        resize_pool)
    from gramtools_tpu_torch.mapping.search_log_host import LogConfig
    from gramtools_tpu_torch.ops import rank

    di, reads, carry, log_base, _, _, G, W, blocks, lock, narrow = args
    reads, reads_bytes = rows_and_bytes(reads)
    S, R = reads.shape
    B = di.n_outcomes
    row = 16 if blocks is None else 32
    occ_rows = (None if blocks is None
                else rank.plain_packed_rows(blocks, di.size))
    n_narrow = 0 if narrow is None else narrow[0]
    live = wide = 0
    c, base = carry, log_base
    ranges = []
    if narrow is not None:
        c = resize_pool(c, narrow[1], R)
        ranges.append((reads[:n_narrow], narrow[2], narrow[3], build_narrow_step(
            di, LogConfig(pool=narrow[1], hits=narrow[2]), R, narrow[3],
            occ_rows=occ_rows), False))
    if S > n_narrow:
        ranges.append((reads[n_narrow:], G, W, build_narrow_step(
            di, LogConfig(pool=R, hits=G), R, W, occ_rows=occ_rows,
            locked=True), True))
    for rows, g, w, step, locked in ranges:
        if locked and lock:
            c = lock_pool(c, R, R)
        for r in rows:
            valid = c[0] >= 0
            bases = r if locked else r[c[0].clamp(0, R - 1)]
            live += int(valid.sum())
            wide += min(int((valid & (bases > 0) & (c[1] != c[2])).sum()), w)
            c, _ = step(c, r, base)
            base += g * B
    records = base - log_base
    return (reads_bytes + carry[0].shape[0] * 16 + 2 * (R + 1)
            + c[0].shape[0] * 16 + 4 * live + 2 * row * wide
            + log_bytes(di, le, log_base, records, row))


def _equal(got, want) -> int:
    """Raise unless every tensor of got equals want's; the largest
    absolute difference (0)."""
    import torch

    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    if not all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want)):
        raise AssertionError(f"max abs err {err}")
    return err


def trace_each(fns, trace_dir: Path):
    """Each fn once between markers in one torch.profiler trace, after
    an unmarked call of the first: [(device events, busy ms, span ms)],
    or Nones when the trace shows no window."""
    import torch

    def traced():
        fns[0]()
        torch.cuda.synchronize()
        for fn in fns:
            marked(fn)()

    busy, _, _, timeline = _profile_device(traced, trace_dir)
    windows = marked_windows(timeline) if busy is not None else []
    return windows if len(windows) == len(fns) else [None] * len(fns)


def check_wide(cfg: SmokeConfig, captured, work: Path, probe):
    """K2 on buffer 1's wide phases: equal bit for bit (carry, flags,
    every log record) to the path's own call and to the plain version
    there and with every phase's hit budget forced to FORCED_WIDE_HITS;
    timed by queued events beside the plain version, with its bound and
    share. Returns its entry of the kernels line."""
    import torch

    from gramtools_tpu_torch.ops import wide_step

    (args, kwargs), path_out = captured["wide"], captured["wide_out"]
    assert not kwargs
    di, reads, carry, phases, log_base, lp, le, blocks = args

    def run(fn, phases_):
        lp2, le2 = torch.full_like(lp, -7), torch.full_like(le, -7)
        out = fn(di, reads, carry, phases_, log_base, lp2, le2, blocks)
        return tuple(out) + (lp2, le2)

    def compare(what, phases_):
        got = run(wide_step.wide_steps_cuda, phases_)
        try:
            err = _equal(got, run(wide_step.wide_steps_torch, phases_))
        except AssertionError as e:
            raise AssertionError(f"K2 kernel != twin ({what}): {e}") from None
        return got, err

    got, err = compare("path inputs", phases)
    end = log_base + sum(n * g for n, _, g in phases) * di.n_outcomes
    try:                        # the path's log holds the other phases too
        _equal(got[:5] + (got[5][log_base:end], got[6][log_base:end]),
               tuple(path_out) + (lp[log_base:end], le[log_base:end]))
    except AssertionError as e:
        raise AssertionError(f"K2 kernel != the path's own call: {e}") from None
    forced_phases = [(n, pool, FORCED_WIDE_HITS) for n, pool, _ in phases]
    forced, err_f = compare("forced hits", forced_phases)
    ovf0 = int(carry[4].sum())
    raised = int(got[4].sum()) - ovf0
    raised_f = int(forced[4].sum()) - ovf0
    if raised_f <= raised:
        raise AssertionError("the forced hit budget raised no more flags")
    lp_t, le_t = torch.empty_like(lp), torch.empty_like(le)
    m = {"max_abs_err": max(err, err_f),
         "ms": time_ms(lambda: wide_step.wide_steps_cuda(
             di, reads, carry, phases, log_base, lp_t, le_t, blocks),
             cfg.timing_runs),
         "plain_ms": time_each_ms(lambda: wide_step.wide_steps_torch(
             di, reads, carry, phases, log_base, lp_t, le_t, blocks), 3),
         "library_ms": None}
    nbytes = wide_bytes(args, got[6])
    m["bound_ms"] = bound_ms(nbytes)
    trace = captured["trace_ms"]["wide_step"]
    S, R = reads.shape
    say(f"[phase 1f] K2 wide steps (csrc/wide_step.cu, one cooperative "
        f"launch) on buffer 1's wide phases {phases}: {S} steps, R={R}, "
        f"{carry[0].shape[0]} incoming states, B={di.n_outcomes}, rank "
        f"{'dense' if blocks is None else 'packed'}: kernel == the path's "
        f"call == twin (carry, flags, {end - log_base} log records), "
        f"{raised} rows flagged; forced hits {FORCED_WIDE_HITS}: equal, "
        f"{raised_f} flagged; queued events {m['ms']:.4f} ms kernel, "
        f"{m['plain_ms']:.4f} ms twin (one call); bound "
        f"{m['bound_ms']:.4f} ms ({nbytes} bytes), kernel at "
        f"{100 * m['bound_ms'] / m['ms']:.2f}% of it by events"
        + ("" if trace is None else
           f", {trace:.4f} ms in the trace "
           f"({100 * m['bound_ms'] / trace:.2f}%)")
        + f"; launches a buffer {[c['wide_step'] for c in captured['per_buffer']]}")
    attrs = wide_step.kernel_attrs()
    lib = probe_run(probe, "wide_stamps", "wide_step", wide_step,
                    lambda: run(wide_step.wide_steps_cuda, phases), got)
    syncs = read_syncs(lib.wide_steps_syncs)
    say(f"[phase 1f] K2 kernel: wide_steps_kernel (the path's instance: "
        f"packed reads) {attrs['registers']} "
        f"registers a thread, {attrs['local_bytes']} local (spill) bytes, "
        f"{attrs['shared_bytes']} static shared bytes a block; ptxas: "
        f"{ptxas_line(probe, 'wide_ptxas', 'wide_steps_kernel')}; grid "
        f"syncs (its -DK2_STAMPS build) {syncs[0]} in the launch, "
        f"{syncs[0] / S:.2f} a step over {S} steps; by step: "
        f"{tile_pairs(wide_cnts(args), di.n_outcomes)}")
    stamps = read_stamps(lib.wide_steps_stamps)
    say(f"[phase 1f] K2 by stage (its -DK2_STAMPS build, the same output; "
        f"ns a stage: " + "/".join(n for n, _, _ in TILE_STAGES) + "): "
        + step_stages(stamps, TILE_STAGES, S))
    tiles = [(pool + 255) // 256 for n, pool, _ in phases for _ in range(n)]
    say(f"[phase 1f] K2 tiles' publish times (ns from tile 0's start): "
        + pub_stages(read_pubs(lib.wide_steps_pubs), stamps, tiles, True))
    return kernel_entry("wide_step", "gramtools_tpu_torch/csrc/wide_step.cu",
                        "gramtools_tpu/mapping/search_jax_log.py:77", m,
                        captured["per_buffer"], captured["trace_ms"])


def check_narrow(cfg: SmokeConfig, captured, work: Path, probe):
    """K3 on buffer 1's narrow and locked phases (the path's one call):
    equal bit for bit to the path's own call and to the plain version
    there and at FORCED_TAIL in both ranges, and as two calls (the
    hole-allocated range alone, then the locked range from its carry);
    the hole-allocated range alone timed by queued events beside the
    plain version, with its bound and share; both ranges traced alone.
    Returns (K3 narrow's entry of the kernels line, the locked range's
    own arguments, for phase 1f's locked check)."""
    import torch

    from gramtools_tpu_torch.ops import locked_step

    (args, kwargs), path_out = captured["locked"], captured["locked_out"]
    assert not kwargs
    di, reads, carry, log_base, lp, le, G, W, blocks, lock, narrow = args
    assert narrow is not None and lock, "the path's tail has no narrow range"
    B = di.n_outcomes
    n, pool, g_n, w_n = narrow

    def run(fn, a):
        lp2, le2 = torch.full_like(lp, -7), torch.full_like(le, -7)
        out = fn(*a[:4], lp2, le2, *a[6:])
        return tuple(out) + (lp2, le2)

    def compare(what, a):
        got = run(locked_step.locked_tail_cuda, a)
        try:
            err = _equal(got, run(locked_step.locked_tail_torch, a))
        except AssertionError as e:
            raise AssertionError(f"K3 kernel != twin ({what}): {e}") from None
        return got, err

    got, err = compare("path inputs", args)
    end = log_base + (n * g_n + (reads.shape[0] - n) * G) * B
    try:                        # the path's log holds the wide phases too
        _equal(got[:5] + (got[5][log_base:end], got[6][log_base:end]),
               tuple(path_out) + (lp[log_base:end], le[log_base:end]))
    except AssertionError as e:
        raise AssertionError(f"K3 kernel != the path's own call: {e}") from None
    forced_args = args[:6] + FORCED_TAIL + (blocks, lock,
                                            (n, pool) + FORCED_TAIL)
    forced, err_f = compare("forced budgets", forced_args)
    ovf0 = int(carry[4].sum())
    raised = int(got[4].sum()) - ovf0
    raised_f = int(forced[4].sum()) - ovf0
    if raised_f <= raised:
        raise AssertionError("the forced budgets raised no more flags")
    # two calls: the hole-allocated range alone, then the locked range
    narrow_args = (di, reads[:n], carry, log_base, lp, le, G, W, blocks,
                   False, narrow)
    first = run(locked_step.locked_tail_cuda, narrow_args)
    err_n = _equal(first, run(locked_step.locked_tail_torch, narrow_args))
    locked_args = (di, reads[n:], first[:5], log_base + n * g_n * B, first[5],
                   first[6], G, W, blocks, True, None)
    second = locked_step.locked_tail_cuda(*locked_args)
    try:
        _equal(tuple(second) + (first[5], first[6]), got)
    except AssertionError as e:
        raise AssertionError(f"K3 in two calls != one call: {e}") from None

    lp_t, le_t = torch.empty_like(lp), torch.empty_like(le)
    timed = lambda fn, a: (lambda: fn(*a[:4], lp_t, le_t, *a[6:]))
    m = {"max_abs_err": max(err, err_f, err_n),
         "ms": time_ms(timed(locked_step.locked_tail_cuda, narrow_args),
                       cfg.timing_runs),
         "plain_ms": time_each_ms(timed(locked_step.locked_tail_torch,
                                        narrow_args), 3),
         "library_ms": None}
    whole_ms = time_ms(timed(locked_step.locked_tail_cuda, args),
                       cfg.timing_runs)
    nbytes = tail_bytes(narrow_args, first[6])
    m["bound_ms"] = bound_ms(nbytes)
    windows = trace_each([timed(locked_step.locked_tail_cuda, narrow_args),
                          timed(locked_step.locked_tail_cuda, locked_args),
                          timed(locked_step.locked_tail_cuda, args)],
                         work / "trace_k3")
    trace_ms = captured["trace_ms"]
    trace_ms["narrow_step"] = None if windows[0] is None else windows[0][1]
    trace_ms["locked_alone"] = None if windows[1] is None else windows[1][1]
    say(f"[phase 1f] K3 narrow tail (csrc/locked_step.cu, one cooperative "
        f"launch) on buffer 1's narrow phase {narrow} and locked phase "
        f"({reads.shape[0] - n} steps, G={G}, W={W}), R={reads.shape[1]}, "
        f"{carry[0].shape[0]} incoming states, B={B}: kernel == the path's "
        f"call == twin (carry, flags, {end - log_base} log records), "
        f"{raised} rows flagged; forced "
        f"hits {FORCED_TAIL[0]}, wide budget {FORCED_TAIL[1]} in both "
        f"ranges: equal, {raised_f} flagged; the hole-allocated range alone "
        f"then the locked range == one call. The hole-allocated range "
        f"alone: queued events {m['ms']:.4f} ms kernel, {m['plain_ms']:.4f}"
        f" ms twin (one call); bound {m['bound_ms']:.4f} ms ({nbytes} "
        f"bytes), kernel at {100 * m['bound_ms'] / m['ms']:.2f}% of it by "
        f"events; the whole tail {whole_ms:.4f} ms queued; traced alone "
        f"(device events, busy ms): hole-allocated "
        f"{windows[0] and windows[0][:2]}, locked {windows[1] and windows[1][:2]}"
        f", whole {windows[2] and windows[2][:2]}; launches a buffer "
        f"{[c['narrow_step'] for c in captured['per_buffer']]}")
    # (first's log halves now hold the locked range's records too)
    lib = probe_run(probe, "stamps", "locked_step", locked_step,
                    lambda: run(locked_step.locked_tail_cuda, narrow_args),
                    run(locked_step.locked_tail_cuda, narrow_args))
    syncs = read_syncs(lib.locked_tail_syncs)
    say(f"[phase 1f] K3 hole-allocated range: grid syncs (its -DK3_STAMPS "
        f"build) {syncs[0]} from the launch's start to the lock, "
        f"{syncs[0] / n:.2f} a step over {n} steps; by step: "
        f"{tile_pairs(narrow_cnts(narrow_args), B)}")
    say(f"[phase 1f] K3 hole-allocated range by stage (its -DK3_STAMPS "
        f"build, the same output; ns a stage: "
        + "/".join(k for k, _, _ in TILE_STAGES) + "): "
        + step_stages(read_stamps(lib.locked_tail_stamps, 1), TILE_STAGES,
                      n))
    say(f"[phase 1f] K3 hole-allocated tiles' publish times (ns from tile "
        f"0's start): " + pub_stages(read_pubs(lib.locked_tail_pubs),
                                     read_stamps(lib.locked_tail_stamps, 1),
                                     [(pool + 255) // 256] * n))
    entry = kernel_entry("narrow_step",
                         "gramtools_tpu_torch/csrc/locked_step.cu",
                         "gramtools_tpu/mapping/search_jax_log.py:419", m,
                         captured["per_buffer"], trace_ms)
    return entry, locked_args


def phase_locked(cfg: SmokeConfig, captured, args, probe):
    """Phase 1f, the locked range: K3 on buffer 1's locked phase (``args``,
    its inputs as the hole-allocated range leaves them): equal bit for
    bit to the plain version (carry, flags, every log record) there and
    at forced budgets (hits 8, wide budget 4: spills and conflicts), and
    in two ranges (the lock and the first half, then the rest on the
    locked carry); its time by queued CUDA events, its bound and share;
    the buffer's device events and busy time with the scan kernels and
    with the torch steps they replace (phase 1d's trace); its time a
    step, its latency floor (the steps times one dependent narrow-table
    load, timed by the chase probe) and the kernel's registers. Returns
    its entry of the kernels line."""
    import torch

    from gramtools_tpu_torch.ops import locked_step

    di, reads, carry, log_base, lp, _, G, W, blocks, lock, _ = args
    S, R = reads.shape
    B = di.n_outcomes

    def run(fn, G_, W_, a=args, lock_=lock, reads_=reads, base=log_base):
        lp2 = torch.full_like(lp, -7)
        le2 = torch.full_like(lp, -7)
        out = fn(di, reads_, a[2], base, lp2, le2, G_, W_, blocks, lock_)
        return tuple(out) + (lp2, le2)

    def compare(what, G_, W_):
        got = run(locked_step.locked_tail_cuda, G_, W_)
        want = run(locked_step.locked_tail_torch, G_, W_)
        try:
            err = _equal(got, want)
        except AssertionError as e:
            raise AssertionError(f"locked tail kernel != twin ({what}): "
                                 f"{e}") from None
        return got, err

    got, err = compare("locked range", G, W)
    forced, err_f = compare("forced budgets", *FORCED_TAIL)
    ovf0 = int(carry[4][:R].sum())
    raised = int(got[4][:R].sum()) - ovf0
    raised_f = int(forced[4][:R].sum()) - ovf0
    if raised_f <= raised:
        raise AssertionError("the forced budgets raised no more flags")
    # two ranges: the lock and [0, S/2), then [S/2, S) on the locked carry
    h = S // 2
    first = run(locked_step.locked_tail_cuda, G, W, reads_=reads[:h])
    lp2, le2 = first[5], first[6]
    second = locked_step.locked_tail_cuda(
        di, reads[h:], first[:5], log_base + h * G * B, lp2, le2, G, W,
        blocks, False)
    if not (all(torch.equal(a, b) for a, b in zip(second, got[:5]))
            and torch.equal(lp2, got[5]) and torch.equal(le2, got[6])):
        raise AssertionError("locked tail in two ranges != one call")

    lp_t, le_t = torch.empty_like(lp), torch.empty_like(lp)
    m = {"max_abs_err": max(err, err_f),
         "ms": time_ms(lambda: locked_step.locked_tail_cuda(
             di, reads, carry, log_base, lp_t, le_t, G, W, blocks, lock),
             cfg.timing_runs),
         "plain_ms": time_each_ms(lambda: locked_step.locked_tail_torch(
             di, reads, carry, log_base, lp_t, le_t, G, W, blocks, lock), 3),
         "library_ms": None}
    nbytes = tail_bytes(args, got[6])
    m["bound_ms"] = bound_ms(nbytes)
    trace_ms = captured["trace_ms"]
    trace = trace_ms["locked_alone"]
    windows = captured["tail_windows"]
    tail = ("not in a trace" if not windows else
            f"{windows[0][0]} device events, {windows[0][1]:.3f} ms busy "
            f"over a {windows[0][2]:.3f} ms span with the scan kernels (K2 "
            f"and K3, 2 launches); {windows[1][0]} events, "
            f"{windows[1][1]:.3f} ms busy over {windows[1][2]:.3f} ms with "
            f"the wide and hole-allocated phases as torch steps and K1 and "
            f"the locked phase one K3 launch (the path before K2 and K3 "
            f"narrow)")
    say(f"[phase 1f] K3 locked range on buffer 1's locked phase: {S} steps, "
        f"R={R} slots, {carry[0].shape[0]} incoming states, G={G}, W={W}, "
        f"B={B}, rank {'dense' if blocks is None else 'packed'}: kernel == "
        f"twin (carry, flags, {S * G * B} log records), {raised} rows "
        f"flagged; forced hits {FORCED_TAIL[0]}, wide budget "
        f"{FORCED_TAIL[1]}: equal, {raised_f} flagged; two ranges [0, {h}) "
        f"+ [{h}, {S}) == one call; queued events {m['ms']:.4f} ms kernel, "
        f"{m['plain_ms']:.4f} ms twin (one call, host-bound); bound "
        f"{m['bound_ms']:.4f} ms ({nbytes} bytes), kernel at "
        f"{100 * m['bound_ms'] / m['ms']:.2f}% of it by events"
        + ("" if trace is None else
           f", {trace:.4f} ms traced alone "
           f"({100 * m['bound_ms'] / trace:.2f}%)")
        + (f"; the whole K3 launch (narrow and locked) "
           f"{trace_ms['locked_step']:.4f} ms a buffer in phase 1d's trace"
           if trace_ms["locked_step"] is not None else "")
        + f"; one buffer's scan_submit in one trace: {tail}")
    # the latency floor: S dependent steps, each at least one narrow-table
    # load after its carry (from a live state's row of the locked range)
    live = torch.nonzero(carry[0] >= 0)
    start = int(carry[1][live[0, 0]]) if live.numel() else 0
    load_us = narrow_load_us(cfg, probe, di.narrow_tab, start)
    floor_ms = S * load_us / 1000.0
    attrs = locked_step.kernel_attrs()
    step_us = None if trace is None else 1000.0 * trace / S

    def stamped():
        lp_s, le_s = torch.full_like(lp, -7), torch.full_like(lp, -7)
        return tuple(locked_step.locked_tail_cuda(
            di, reads, carry, log_base, lp_s, le_s, G, W, blocks,
            lock)) + (lp_s, le_s)

    lib = probe_run(probe, "stamps", "locked_step", locked_step, stamped, got)
    stages = median_stages(read_stamps(lib.locked_tail_stamps, 0), STAGES, S)
    say(f"[phase 1f] K3 locked range a step: "
        + ("not traced" if trace is None else
           f"{step_us:.3f} us traced alone ({trace:.4f} ms / {S} steps)")
        + f", {1000.0 * m['ms'] / S:.3f} us by queued events; latency floor "
        f"{floor_ms:.4f} ms = {S} dependent steps x {load_us:.4f} us, one "
        f"narrow-table load each (a one-thread chase of {CHASE_STEPS} "
        f"dependent loads through the narrow table, warm in L2), the "
        f"kernel at "
        + ("-" if trace is None else f"{100 * floor_ms / trace:.2f}%")
        + f" of it traced; byte bound {m['bound_ms']:.4f} ms; "
        f"locked_tail_kernel (the path's instance: packed reads) {attrs['registers']} registers a thread, "
        f"{attrs['local_bytes']} local (spill) bytes, "
        f"{attrs['shared_bytes']} static shared bytes a block; ptxas: "
        f"{ptxas_line(probe, 'tail_ptxas', 'locked_tail_kernel')}")
    say(f"[phase 1f] K3 locked range by stage (its -DK3_STAMPS build, the "
        f"same output; median ns a step): {stages}")
    trace_ms = dict(trace_ms, locked_step=trace)
    entry = kernel_entry("locked_step",
                         "gramtools_tpu_torch/csrc/locked_step.cu",
                         "gramtools_tpu/mapping/search_jax_log.py:232", m,
                         captured["per_buffer"], trace_ms)
    entry.update(step_us=step_us, latency_floor_ms=floor_ms,
                 registers=attrs["registers"])
    return entry


def phase_scan_kernels(cfg: SmokeConfig, captured, work: Path, probe):
    """Phase 1f: the scan kernels on buffer 1's own inputs, K2 (the wide
    phases, csrc/wide_step.cu) and K3 (the narrow and locked phases,
    csrc/locked_step.cu), each held to the path's own call and to its
    plain version, at the path's and at forced budgets (check_wide,
    check_narrow, phase_locked). Returns their entries of the kernels
    line (K2, K3 narrow, K3 locked, and K6: check_k6)."""
    if any(c["packed_rank"] for c in captured["per_buffer"]):
        raise AssertionError("a phase 1d buffer launched the standalone K1")
    wide = check_wide(cfg, captured, work, probe)
    narrow, locked_args = check_narrow(cfg, captured, work, probe)
    locked = phase_locked(cfg, captured, locked_args, probe)
    k6 = check_k6(cfg, captured, work, sum(e["bound_ms"] for e in (
        wide, narrow, locked)))
    return [wide, narrow, locked, k6]


REPLAY_STAGES = (1, 2, 99)       # the chase; + the seed gather; + the apply
SELECT_STAGES = (0, 1, 2, 3, 4, 5, 6, 99)
SELECT_BLOCKS = {0: "floor (inputs, chain flags)",
                 1: "encapsulated split + state table",
                 2: "duplicate-site check", 3: "loci + ancestors + dedup sort",
                 4: "key rows + class sort + pick",
                 5: "preliminary triple check", 6: "per-base coverage (K9)",
                 99: "triples sort"}


# phase 1e's forced budgets of the selection on buffer 1's inputs, each
# with the fallback bit it should set (search_log_host.FB_*)
FORCED_SELECT = {
    "ecap 64": dict(caps=dict(ecap=64), bit=2),
    "trcap 64": dict(caps=dict(trcap=64), bit=8),
    "lcap 4096": dict(caps=dict(lcap=4096), bit=1024),
    "wcap 2048": dict(caps=dict(wcap=2048), bit=256),
    "emitcap 4096": dict(caps=dict(emitcap=4096), bit=512),
    "KCAP 1": dict(kcap=1, bit=16),
    "trip_cap 1024": dict(trip_cap=1024, bit=128),
    "first draws 2^32-1": dict(rng=True, bit=64)}


def select_bytes(select_args, per_base_args) -> int:
    """K8's bytes for these inputs (a lower bound): each pool state's
    rid, lo, hi, path lengths and bad flag, the path slots its live
    states use, each row's ok flag, first draw and length; for the
    encapsulated split, each SA row of the no-path live states'
    intervals with its node, site and allele; the outputs (fallback,
    mapped, the three trip arrays) written once; and the per-base
    recorder's own bytes (``per_base_bytes``). Reads of the ancestor and
    base-site tables and of the traversing expansion are left out."""
    import torch

    (_, _, f_rid, f_lo, f_hi, _, n_trav, _, n_ing, _, row_ok, _,
     row_len) = select_args[:13]
    N, R = f_rid.shape[0], row_ok.shape[0]
    live = f_rid >= 0
    slots = int((n_trav.clamp(max=16) + n_ing.clamp(max=16))[live].sum())
    no_path = live & (n_trav == 0) & (n_ing == 0)
    occ = int((f_hi - f_lo + 1)[no_path].clamp(min=0).sum())
    trip_cap = 4 * R
    return (N * 21 + 8 * slots + R * 13 + 16 * occ
            + R * 5 + 12 * trip_cap + per_base_bytes(per_base_args)[0])


# csrc/select.cu's kSmallRow: stage 4 ranks a row of more live states
# than this with a warp (its O(k^2) path), a thread a row otherwise
K8_SMALL_ROW = 4


def stage4_counts(sargs, trip_cap: int) -> dict:
    """Stage 4's sizes on the selection's inputs ``sargs``, from the
    first launch's scratch (csrc/select.cu ``select_scratch_offset``): the
    most live states in a row, the rows with one and with more, the rows
    that take the warp path (more than K8_SMALL_ROW states), and the
    longest and the mean run of one state's sorted lanes."""
    import ctypes

    import torch

    from gramtools_tpu_torch.mapping import record
    from gramtools_tpu_torch.ops import select

    (di, rt, f_rid, f_lo, f_hi, trav, n_trav, ing, n_ing, state_bad, row_ok,
     row_first_raw) = sargs[:12]
    N, R = f_rid.shape[0], row_ok.shape[0]
    ecap, trcap, _, _, lcap = record.buffer_caps(R)
    A = max(rt.max_anc, 0)
    sel = select.select_cuda(
        di.sa[:di.size], rt.ra_node, rt.nt_site, rt.nt_allele, rt.anc_len,
        rt.anc_site, rt.anc_allele, rt.base_site, A, f_rid, f_lo, f_hi,
        trav, n_trav, ing, n_ing, state_bad, row_ok,
        row_first_raw.to(torch.int64), ecap, lcap, trcap, record.KCAP,
        trip_cap, 99)
    NS = N + ecap
    wide = select.wide_keys(select.key_bits(NS, R, rt.anc_len.shape[0],
                                            rt.nt_site.shape[0]))
    fn = select._kernel_lib().select_scratch_offset
    fn.argtypes = [ctypes.c_int] * 10
    fn.restype = ctypes.c_longlong
    torch.cuda.synchronize()

    def field(f, n):
        at = fn(f, N, R, ecap, lcap, trcap, A, record.KCAP, sel.args[0],
                int(wide))
        return sel.scratch[at:at + 4 * n].view(torch.int32)

    row_cnt = field(0, R)
    run = field(2, NS) - field(1, NS)
    return {"max_states": int(row_cnt.max()),
            "rows_one": int((row_cnt == 1).sum()),
            "rows_more": int((row_cnt > 1).sum()),
            "rows_warp": int((row_cnt > K8_SMALL_ROW).sum()),
            "max_run": int(run.max()),
            "mean_run": float(run[run > 0].double().mean())}


def phase_stages(cfg: SmokeConfig, captured, work: Path, probe):
    """Phase 1e: the profiling stages on buffer 1's own inputs. K7 at
    stages 1, 2 and 99, each equal bit for bit to the twin at the same
    stage and timed by queued CUDA events; then the selection
    (``select_and_record_device``, K8: csrc/select.cu's two launches with
    K9 between them) at stages 0-6 and 99, each equal bit for bit to the
    plain version (``record.select_torch`` on the same tensors) at that
    stage, stage 99 also to the path's own call; at forced budgets
    (``FORCED_SELECT``) likewise; each stage timed by queued events and
    traced once between markers in one torch.profiler session (device
    events and busy time by stage, each block's share as the difference
    of two prefixes), the plain version timed (single calls) and traced
    at stage 99. Returns K8's entry of the kernels line."""
    import torch

    import ctypes

    from gramtools_tpu_torch.mapping import record
    from gramtools_tpu_torch.ops import replay, select

    args = captured["replay"][0][:8]
    ms, lines = {}, []
    for stage in REPLAY_STAGES:
        got = replay.replay_cuda(*args, stage=stage)
        want = replay.replay_torch(*args, stage=stage)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"replay kernel != twin at stage {stage}")
        ms[stage] = time_ms(lambda: replay.replay_cuda(*args, stage=stage),
                            cfg.timing_runs)
    say(f"[phase 1e] K7 by stage on buffer 1's inputs (kernel == twin at "
        f"each), queued events: stage 1 (chase) {ms[1]:.4f} ms, stage 2 "
        f"(+ seed gather) {ms[2]:.4f} ms, stage 99 (+ ops apply) "
        f"{ms[99]:.4f} ms; so chase {ms[1]:.4f} ms, seed "
        f"gather {ms[2] - ms[1]:.4f} ms, ops apply {ms[99] - ms[2]:.4f} ms")

    (sargs, skw), want = captured["select"], captured["select_out"]
    assert skw.get("stage", 99) == 99, "the path's selection ran a stage"
    # cov_diff (argument 13): a scratch copy, added into by every call
    sargs = list(sargs[:13]) + [torch.zeros_like(sargs[13])]
    trip_cap = skw["trip_cap"]
    R = sargs[10].shape[0]

    def call(stage, a=sargs, cap=trip_cap):
        return record.select_and_record_device(*a, trip_cap=cap, stage=stage)

    def both(stage, a=sargs, cap=trip_cap):
        """(kernels' outputs + cov_diff, the plain version's), each on a
        zeroed cov_diff."""
        outs = []
        for plain in (False, True):
            b = list(a[:13]) + [torch.zeros_like(a[13])]
            out = (record.select_torch(*b, cap, stage) if plain
                   else record.select_and_record_device(*b, trip_cap=cap,
                                                        stage=stage))
            outs.append(list(out) + [b[13]])
        return outs

    def compare(what, got, want):
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  if g.numel() else 0 for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"selection kernels != plain version "
                                 f"({what}; max abs err {err})")
        return err

    got = call(99)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("selection at stage 99 != the path's own call")
    err = max(compare(f"stage {st}", *both(st)) for st in SELECT_STAGES)
    # the 128-bit key instance, forced, at every stage
    select.WIDE_KEYS = True
    try:
        err = max(err, max(compare(f"128-bit keys, stage {st}", *both(st))
                           for st in SELECT_STAGES))
        torch.cuda.synchronize()
        wide_ms = time_ms(lambda: call(99), cfg.timing_runs)
    finally:
        select.WIDE_KEYS = None
    # the grid syncs and sort passes of each launch (a -DK8_SYNCS build,
    # its outputs the path's own)
    lib = probe_run(probe, "select_syncs", "select", select,
                    lambda: call(99), want)
    counts = (ctypes.c_longlong * (4 + 2 * K8_STAMPS + 2 * K8_PASSES * 8))()
    if lib.select_syncs(counts) != 0:
        raise RuntimeError("select_syncs failed")
    syncs, passes = (counts[0], counts[1]), (counts[2], counts[3])
    spans = k8_spans(counts, syncs, passes)
    if syncs[0] + syncs[1] > 25 or any(
            syncs[k] > passes[k] + (7 if k == 0 else 1) for k in (0, 1)):
        raise AssertionError(f"K8's grid syncs {syncs} (sort passes "
                             f"{passes}): past the design's count")
    grid = select._kernel_lib().select_grid(0)
    one_sync = grid_sync_ms(probe, grid, cfg.timing_runs)
    floor = (syncs[0] + syncs[1]) * one_sync
    st4 = stage4_counts(sargs, trip_cap)
    forced = []
    caps0, kcap0 = record.buffer_caps, record.KCAP
    for name, spec in FORCED_SELECT.items():
        a, cap = sargs, spec.get("trip_cap", trip_cap)
        if "caps" in spec:
            over = spec["caps"]
            record.buffer_caps = lambda n, over=over: tuple(
                over.get(k, v) for k, v in zip(
                    ("ecap", "trcap", "wcap", "emitcap", "lcap"), caps0(n)))
        record.KCAP = spec.get("kcap", kcap0)
        if spec.get("rng"):
            a = list(sargs)
            a[11] = a[11].clone()
            a[11][::3] = (1 << 32) - 1
        try:
            got, plain = both(99, a, cap)
        finally:
            record.buffer_caps, record.KCAP = caps0, kcap0
        err = max(err, compare(name, got, plain))
        bit = spec["bit"]
        forced.append(f"{name} {int(((got[0] & bit) != 0).sum())} rows "
                      f"flagged")
    torch.cuda.synchronize()
    sel_ms = {st: time_ms(lambda: call(st), cfg.timing_runs)
              for st in SELECT_STAGES}
    plain_ms = time_each_ms(lambda: record.select_torch(
        *sargs, trip_cap, 99), 5)

    def traced():
        call(99)            # unmarked: the session's first events
        torch.cuda.synchronize()
        for st in SELECT_STAGES:
            marked(call)(st)
        marked(record.select_torch)(*sargs, trip_cap, 99)

    busy, _, _, timeline = _profile_device(traced, work / "trace_k8")
    windows = marked_windows(timeline) if busy is not None else []
    n_win = len(SELECT_STAGES) + 1
    if len(windows) != n_win:
        say(f"[phase 1e] trace: {len(windows)} marked windows, not {n_win} "
            f"({sum(MARK in n for _, _, n in timeline)} markers in "
            f"{len(timeline)} device events)")
        windows = [None] * n_win
    nbytes = select_bytes(sargs, captured["per_base"][0])
    bound = bound_ms(nbytes)
    prev_ms, prev_w = 0.0, (0, 0.0, 0.0)
    for st, w in zip(SELECT_STAGES, windows):
        trace = ("not in the trace" if w is None else
                 f"{w[0]} device events ({w[0] - prev_w[0]:+d}), "
                 f"{w[1]:.4f} ms busy ({w[1] - prev_w[1]:+.4f}) over a "
                 f"{w[2]:.4f} ms span")
        lines.append(f"stage {st} [{SELECT_BLOCKS[st]}] {sel_ms[st]:.4f} ms "
                     f"({sel_ms[st] - prev_ms:+.4f}), {trace}")
        prev_ms, prev_w = sel_ms[st], (w or prev_w)
    attrs = {(w, k): select.kernel_attrs(w, k) for w in (0, 1)
             for k in (False, True)}
    k8, pl = windows[-2], windows[-1]
    say(f"[phase 1e] K8, select_and_record_device on buffer 1's inputs "
        f"(R={R}, trip_cap={trip_cap}): the kernels (csrc/select.cu, K9 "
        f"between its two launches) == the plain version at every stage "
        f"and at forced budgets ({'; '.join(forced)}), stage 99 == the "
        f"path's call; by stage, queued events ({cfg.timing_runs} calls) "
        f"and one call a stage in one torch.profiler trace (change on the "
        f"stage before): " + "; ".join(lines)
        + f"; the plain version {plain_ms:.4f} ms (median of 5 single "
        f"calls)" + ("" if pl is None else
                     f", {pl[0]} device events, {pl[1]:.4f} ms busy traced")
        + f"; bound {bound:.4f} ms ({nbytes} bytes), the kernels at "
        f"{100 * bound / sel_ms[99]:.2f}% of it by events"
        + ("" if k8 is None else f", {100 * bound / k8[1]:.2f}% by trace")
        + "; " + "; ".join(
            f"{('select_kernel', 'triples_kernel')[w]} "
            f"{'128' if k else '64'}-bit keys {a['registers']} registers, "
            f"{a['local_bytes']} bytes of stack, {a['shared_bytes']} bytes "
            f"of shared memory" for (w, k), a in attrs.items())
        + f" (ptxas: {select_ptxas(probe)})")
    say(f"[phase 1e] K8's design: the 128-bit key instance == the plain "
        f"version at every stage, {wide_ms:.4f} ms at stage 99 by events "
        f"(64-bit: {sel_ms[99]:.4f}); grid syncs {syncs[0]} in the first "
        f"launch and {syncs[1]} in the second ({syncs[0] + syncs[1]} a "
        f"buffer), sort passes {passes[0]} and {passes[1]} (8-bit digits); "
        f"one empty grid sync {1000 * one_sync:.3f} us on the {grid}-block "
        f"grid (a launch of 200 less one of none), so a sync floor of "
        f"{floor:.4f} ms, {100 * floor / sel_ms[99]:.1f}% of the function "
        f"by events" + ("" if k8 is None else
                        f", {100 * floor / k8[1]:.1f}% of its trace")
        + f"; stage 4 (key rows, classes, pick) {sel_ms[4] - sel_ms[3]:.4f} "
        f"ms by events over {st4['rows_one']} rows of one live state and "
        f"{st4['rows_more']} of more, at most {st4['max_states']} a row; "
        f"a state's run of sorted lanes at most {st4['max_run']}, "
        f"{st4['mean_run']:.2f} on average; block 0's time between its "
        f"grid syncs (us, the -DK8_SYNCS build, one call): {spans}; "
        f"each sort pass's tiles 0 and T-1 (us: the tile's start after "
        f"tile 0's, then ranking, look-back, scatter): "
        f"{k8_pass_spans(counts)}")
    m = {"max_abs_err": err, "ms": sel_ms[99], "plain_ms": plain_ms,
         "bound_ms": bound, "library_ms": None}
    entry = kernel_entry("select", "gramtools_tpu_torch/csrc/select.cu",
                         "gramtools_tpu/mapping/record_jax.py:438", m,
                         captured["per_buffer"], captured["trace_ms"])
    entry.update(syncs=list(syncs), sort_passes=list(passes),
                 one_sync_ms=one_sync, sync_floor_ms=floor)
    return entry


def fresh_cov(args, **over):
    """A copy of per-base arguments ``args`` with a zeroed cov_diff and
    the named ones replaced (fallback, wcap, emitcap)."""
    import torch

    a = list(args)
    a[10] = torch.zeros_like(args[10])
    for k, v in over.items():
        a[{"fallback": 9, "wcap": 11, "emitcap": 12}[k]] = v
    return a


def sort_design(cursor_walk):
    """The sort design of the per-base recorder: the plain version with
    the cursor walk kernel (``probe_cursor_walk``) in place of the
    plain walk."""
    from gramtools_tpu_torch.mapping import record
    from gramtools_tpu_torch.ops import walk

    def run(*a):
        record.walk_torch = cursor_walk
        try:
            return record._record_per_base_torch(*a)
        finally:
            record.walk_torch = walk.walk_torch
    return run


def per_base_lanes(args):
    """The plain version's walk inputs for per-base arguments ``args``:
    (walk_torch's positional arguments, the lanes' SA rows and PRG
    positions)."""
    import torch

    from gramtools_tpu_torch.mapping import record

    (di, rt, ps_row, ps_lo, ps_hi, ps_trav, ps_ntrav, st_selected, row_len,
     _fallback, _cov, wcap, emitcap) = args
    lanes, _ = record._walk_lanes(di, rt, ps_row, ps_lo, ps_hi, ps_ntrav,
                                  st_selected, row_len, wcap)
    w = torch.where(st_selected, ps_hi - ps_lo + 1, 0)
    item, off, _, _ = record._expand_budget(w, wcap)
    occ_sa = (ps_lo[item] + off).clamp(0, di.size - 1)
    prg = di.sa[occ_sa].clamp(0, rt.ra_node.shape[0] - 1)
    return ((rt.nt_walk, rt.nt_edges) + lanes
            + (ps_trav, emitcap, rt.n_nodes + 2)), occ_sa, prg


def per_base_bytes(args):
    """The whole per-base recorder's bytes for these inputs: the
    selection flag of every state, lo, hi and row of each selected one;
    for the walk lanes, each SA entry, PRG position (node and offset),
    row length and path count they read; each node row (16 bytes), edge
    word and ps_trav allele word the walks read (the plain walk's
    ``visits``); each emitted node's coverage offset; the fallback row
    bits read and written; each cov_diff slot the envelopes touch, read
    and written. Returns (bytes, emissions)."""
    import torch

    from gramtools_tpu_torch.ops import walk

    rt, st_selected, row_len = args[1], args[7], args[8]
    R = row_len.shape[0]
    uniq = lambda t: torch.unique(t).numel()
    wargs, occ_sa, prg = per_base_lanes(args)
    valid, item, read_of = wargs[2], wargs[7], wargs[8]
    visits = []
    emits, _ = walk.walk_torch(*wargs, visits=visits)
    nodes, edges, trav = [torch.unique(torch.cat(v)).numel()
                          for v in zip(*visits)] or [0, 0, 0]
    e = emits[emits[:, 0] < walk.BIG].to(torch.int64)
    key, inv = torch.unique(e[:, 0] * rt.n_nodes + e[:, 1],
                            return_inverse=True)
    lo = torch.full((key.numel(),), 1 << 30, dtype=torch.int64,
                    device=e.device).scatter_reduce_(0, inv, e[:, 2], "amin")
    hi = torch.full((key.numel(),), -1, dtype=torch.int64,
                    device=e.device).scatter_reduce_(0, inv, e[:, 3], "amax")
    covs = rt.nt_cov_start[key % rt.n_nodes].to(torch.int64)
    slots = uniq(torch.cat([covs + lo, covs + hi + 1])[
        torch.cat([covs, covs]) >= 0])
    n_sel = int(st_selected.sum())
    nbytes = (st_selected.numel() + 12 * n_sel
              + 4 * uniq(occ_sa[valid]) + 8 * uniq(prg[valid])
              + 4 * uniq(read_of[valid]) + 4 * uniq(item[valid])
              + 16 * nodes + 4 * edges + 4 * trav
              + 4 * uniq(e[:, 1]) + 8 * R + 8 * slots)
    return nbytes, e.shape[0]


def check_per_base(cfg: SmokeConfig, call, windows, sort_fn):
    """K9, the whole per-base recorder (csrc/walk.cu's four kernels), on
    buffer 1's inputs: equal to the plain version (fallback bits and
    cov_diff) there and on forced cases (emitcap half the emissions,
    wcap half the lanes, preset fallback rows, max_iter 2); its time by
    queued CUDA events beside the sort design of the same function
    (``sort_fn``: the plain version with the cursor walk kernel); its
    bound; and the device events and time in buffer 2's trace
    (``windows``: the path's marked call, then the kernels and the sort
    design on these inputs)."""
    import torch

    from gramtools_tpu_torch.mapping import record
    from gramtools_tpu_torch.ops import walk

    args, kwargs = call
    assert not kwargs
    di, rt = args[0], args[1]
    R = args[8].shape[0]

    fresh = lambda **over: fresh_cov(args, **over)

    def compare(what, a):
        before = walk.per_base_cuda.launches
        got = record._record_per_base_device(*a)
        if walk.per_base_cuda.launches != before + 1:
            raise AssertionError("the per-base call launched no kernel")
        b = list(a)
        b[10] = torch.zeros_like(a[10])
        want = record._record_per_base_torch(*b)
        if not (torch.equal(got, want) and torch.equal(a[10], b[10])):
            raise AssertionError(f"per-base kernels != plain version ({what}:"
                                 f" fallback {torch.equal(got, want)}, "
                                 f"cov_diff {torch.equal(a[10], b[10])})")
        return got, b[10]

    nbytes, n_emit = per_base_bytes(args)
    fb, cov = compare("path inputs", fresh())
    if (fb & (256 | 512)).any():
        raise AssertionError("the path's per-base call spilled")
    lanes = int(per_base_lanes(args)[0][2].sum())
    fb_w, _ = compare("wcap half the lanes", fresh(wcap=max(1, lanes // 2)))
    fb_e, cov_e = compare("emitcap half the emissions",
                          fresh(emitcap=max(1, n_emit // 2)))
    preset = torch.where(torch.arange(R, device=fb.device) % 3 == 0, 4, 0
                         ).to(torch.int32)
    fb_p, cov_p = compare("preset fallback rows", fresh(fallback=preset))
    if not ((fb_w & 256).any() and (fb_e & 512).any() and not cov_e.any()
            and (cov_p != 0).sum() < (cov != 0).sum()):
        raise AssertionError("a forced per-base case did not take effect")
    a = fresh()
    c = dict(sa=di.sa[:di.size], ra_node=rt.ra_node, ra_offset=rt.ra_offset,
             nt_step=rt.nt_step, nt_edges=rt.nt_edges,
             nt_cov_start=rt.nt_cov_start, ps_row=a[2], ps_lo=a[3],
             ps_hi=a[4], ps_trav=a[5], ps_ntrav=a[6], st_selected=a[7],
             row_len=a[8], fallback=a[9], cov_diff=a[10])
    fb_i = walk.per_base_cuda(**c, wcap=a[11], emitcap=a[12], max_iter=2)
    sel_rows = record._flag_rows(R, a[7], a[2])
    if not (torch.equal(fb_i, a[9] | torch.where(sel_rows, 512, 0).to(
            torch.int32)) and not a[10].any()):
        raise AssertionError("per-base kernels at max_iter 2: not a spill")

    a_k, a_s, a_t = fresh(), fresh(), fresh()
    fb_s = sort_fn(*a_s)
    if not (torch.equal(fb_s, fb) and torch.equal(a_s[10], cov)):
        raise AssertionError("the sort design != the kernels")
    m = {"max_abs_err": 0,
         "ms": time_ms(lambda: record._record_per_base_device(*a_k),
                       cfg.timing_runs),
         "plain_ms": time_ms(lambda: record._record_per_base_torch(*a_t), 3),
         "library_ms": None, "bound_ms": bound_ms(nbytes)}
    sort_ms = time_ms(lambda: sort_fn(*a_s), cfg.timing_runs)
    trace = lambda w: ("not in the trace" if w is None else
                       f"{w[0]} device events, {w[1]:.4f} ms busy over a "
                       f"{w[2]:.4f} ms span")
    share_trace = ("" if windows[1] is None else
                   f", {100 * m['bound_ms'] / windows[1][1]:.1f}% by trace")
    say(f"[phase 1d] K9, the whole per-base recorder (csrc/walk.cu, 4 "
        f"kernels), on buffer 1's inputs ({lanes} lanes, {n_emit} "
        f"emissions): kernels == plain version (fallback bits and cov_diff,"
        f" {cov.numel()} int32, {int((cov != 0).sum())} non-zero), and on "
        f"wcap {max(1, lanes // 2)} (FB_WALK on {int((fb_w != 0).sum())} "
        f"rows), emitcap {max(1, n_emit // 2)} (FB_EMIT, nothing added), "
        f"preset fallback rows, max_iter 2 (spill); queued events "
        f"{m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, the sort design "
        f"{sort_ms:.4f} ms; buffer 2's trace: the path's call "
        f"{trace(windows[0])}; on these inputs the kernels "
        f"{trace(windows[1])}, the sort design {trace(windows[2])}; bound "
        f"{m['bound_ms']:.4f} ms ({nbytes} bytes): kernels at "
        f"{100 * m['bound_ms'] / m['ms']:.1f}% of it by events"
        + share_trace)
    return m


# The earlier walk kernel (one thread a lane, one global atomic cursor,
# the emissions sorted after it), kept here as a probe only: UNIQUE
# gives every lane its own cursor word (emissions land in a spread of
# rows, not a compact prefix), which separates the same-address atomics'
# share of the time from the dependent loads'. Never on the path.
CURSOR_WALK_SRC = r"""
#include <cuda_runtime.h>
template <bool UNIQUE>
__global__ void cursor_walk_kernel(
    int lanes, const unsigned char* __restrict__ valid,
    const int* __restrict__ cur0, const int* __restrict__ start0,
    const int* __restrict__ remaining0, const int* __restrict__ trav_idx0,
    const int* __restrict__ w_item, const int* __restrict__ read_of,
    const unsigned char* __restrict__ full,
    const int2* __restrict__ ps_trav, int tcap,
    const int4* __restrict__ nt_walk, const int* __restrict__ nt_edges,
    int n_edges, int max_iter, int emitcap, int4* __restrict__ emits,
    int* __restrict__ cursor, int* __restrict__ overrun) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes || !valid[i]) return;
  int cur = cur0[i], start = start0[i], remaining = remaining0[i];
  int trav_idx = trav_idx0[i];
  const int row = read_of[i];
  const bool is_full = full[i] != 0;
  const int2* trav = ps_trav + (size_t)w_item[i] * tcap;
  int4 wrow = nt_walk[cur];
  bool first = true;
  for (int it = 0;; ++it) {
    if (it >= max_iter) { atomicExch(overrun, 1); return; }
    bool entry = false;
    if (!first) {
      if (remaining <= 0 || wrow.x == 0) return;
      entry = wrow.x > 1;
      int choice = 0;
      if (entry) {
        --trav_idx;
        choice = trav[min(max(trav_idx, 0), tcap - 1)].y;
      }
      cur = nt_edges[min(max(wrow.w + choice, 0), n_edges - 1)];
      start = 0;
      wrow = nt_walk[cur];
    }
    const int seq_len = wrow.y;
    const bool in_bubble = wrow.z > 0;
    const bool has_seq = seq_len > 0;
    const int end = has_seq ? min(seq_len - 1, start + remaining - 1) : 0;
    if (has_seq) remaining -= end - start + 1;
    if (has_seq && in_bubble) {
      int slot;
      if (UNIQUE) {
        slot = atomicAdd(cursor + 1 + i, 1);
        slot = (int)(((long long)i * 3 + slot) % emitcap);
      } else {
        slot = atomicAdd(cursor, 1);
      }
      if (slot < emitcap) emits[slot] = make_int4(row, cur, start, end);
    }
    const bool returned = first ? in_bubble : (in_bubble || entry);
    first = false;
    if (!is_full && returned) return;
  }
}
extern "C" int cursor_walk(int unique, int lanes, const void* valid,
                           const void* cur0, const void* start0,
                           const void* remaining0, const void* trav_idx0,
                           const void* w_item, const void* read_of,
                           const void* full, const void* ps_trav, int tcap,
                           const void* nt_walk, const void* nt_edges,
                           int n_edges, int max_iter, int emitcap,
                           void* emits, void* cursor, void* overrun,
                           void* stream) {
  if (lanes <= 0) return 0;
  const int grid = (lanes + 127) / 128;
  auto kernel = unique ? cursor_walk_kernel<true> : cursor_walk_kernel<false>;
  kernel<<<grid, 128, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      lanes, (const unsigned char*)valid, (const int*)cur0,
      (const int*)start0, (const int*)remaining0, (const int*)trav_idx0,
      (const int*)w_item, (const int*)read_of, (const unsigned char*)full,
      (const int2*)ps_trav, tcap, (const int4*)nt_walk,
      (const int*)nt_edges, n_edges, max_iter, emitcap, (int4*)emits,
      (int*)cursor, (int*)overrun);
  return (int)cudaGetLastError();
}
"""


# One thread chasing dependent loads through the narrow table, as a
# single state's slot-locked steps chain them (a word's LF destination
# for a DNA symbol, else a hashed row): the latency of one narrow-table
# load after the carry, which floors K3's locked range. A probe only.
NARROW_CHASE_SRC = r"""
__global__ void narrow_chase_kernel(const int* __restrict__ tab, int n,
                                    int start, int steps, int* out) {
  int r = start;
  for (int s = 0; s < steps; ++s) {
    const int t = __ldg(tab + r);
    const int sym = t >> 24;
    const unsigned next = (sym >= 1 && sym <= 4)
        ? (unsigned)(t & 0xFFFFFF) : (unsigned)r * 2654435761u + 1u;
    r = (int)(next % (unsigned)n);
  }
  *out = r;
}
extern "C" int narrow_chase(const void* tab, int n, int start, int steps,
                            void* out, void* stream) {
  narrow_chase_kernel<<<1, 1, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int*)tab, n, start, steps, (int*)out);
  return (int)cudaGetLastError();
}
"""


# An empty cooperative grid: ``syncs`` grid syncs and nothing else, on
# the blocks and threads of K8's grid, so that the time a sync costs
# there floors K8's launches (its syncs times one). A probe only.
GRID_SYNC_SRC = r"""
#include <cooperative_groups.h>
__global__ void __launch_bounds__(256) grid_sync_kernel(int syncs, int* out) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int s = 0; s < syncs; ++s) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = syncs;
}
extern "C" int grid_sync_probe(int blocks, int syncs, void* out,
                               void* stream) {
  void* args[] = {&syncs, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)grid_sync_kernel, dim3(blocks), dim3(256), args, 0,
      reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
"""


def start_probe_build():
    """Start nvcc on the probes (into the package's git-ignored build
    directory), all together: CURSOR_WALK_SRC, NARROW_CHASE_SRC and
    GRID_SYNC_SRC in one file; csrc/wide_step.cu with -DK2_STAMPS and
    csrc/locked_step.cu with -DK3_STAMPS (the scan kernels' stage stamps
    and grid-sync counts); csrc/select.cu with -DK8_SYNCS (K8's grid
    syncs and sort passes a launch, and their time stamps); and the path
    builds of the two scan
    kernels and of K8 with -Xptxas -v (their registers, spills and
    shared memory as ptxas reports them). Returns {name: (process,
    library path)}."""
    from gramtools_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "smoke_probes.cu"
    src.write_text(CURSOR_WALK_SRC + NARROW_CHASE_SRC + GRID_SYNC_SRC)
    jobs = {}
    cu = lambda name: _build.CSRC_DIR / f"{name}.cu"
    for name, source, flags in (
            ("probes", src, []),
            ("wide_stamps", cu("wide_step"), ["-DK2_STAMPS"]),
            ("stamps", cu("locked_step"), ["-DK3_STAMPS"]),
            ("wide_ptxas", cu("wide_step"), ["-Xptxas", "-v"]),
            ("tail_ptxas", cu("locked_step"), ["-Xptxas", "-v"]),
            ("select_syncs", cu("select"), ["-DK8_SYNCS"]),
            ("select_ptxas", cu("select"), ["-Xptxas", "-v"])):
        lib = _build.BUILD_DIR / f"libsmoke_{name}.so"
        jobs[name] = (subprocess.Popen(
            [_build._nvcc()] + _build.NVCC_FLAGS + flags
            + ["-o", str(lib), str(source)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), lib)
    return jobs


_PROBES = {}


def probe_wait(probe, name: str) -> str:
    """Wait for a probe's build once; its compiler output."""
    if name not in _PROBES:
        proc, path = probe[name]
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} probe:\n{err}")
        _PROBES[name] = (None, out + err)
    return _PROBES[name][1]


def probe_lib(probe, name: str = "probes"):
    """A probe library, its build waited for once."""
    import ctypes

    text = probe_wait(probe, name)
    if _PROBES[name][0] is None:
        lib = ctypes.CDLL(str(probe[name][1]))
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "probes":
            lib.narrow_chase.argtypes = [p, i, i, i, p, p]
            lib.narrow_chase.restype = ctypes.c_int
            lib.grid_sync_probe.argtypes = [i, i, p, p]
            lib.grid_sync_probe.restype = ctypes.c_int
        elif name == "select_syncs":
            lib.select_syncs.argtypes = [p]
            lib.select_syncs.restype = ctypes.c_int
        elif name == "stamps":
            lib.locked_tail_stamps.argtypes = [p, i]
            lib.locked_tail_stamps.restype = ctypes.c_int
            for fn in (lib.locked_tail_syncs, lib.locked_tail_pubs):
                fn.argtypes = [p]
                fn.restype = ctypes.c_int
        else:
            for fn in (lib.wide_steps_stamps, lib.wide_steps_syncs,
                       lib.wide_steps_pubs):
                fn.argtypes = [p]
                fn.restype = ctypes.c_int
        _PROBES[name] = (lib, text)
    return _PROBES[name][0]


PATH_LAYOUT = "LayoutILb1EE"
"""The mangled template arguments of the scan kernels' path instance,
Layout<true> (csrc/scan_common.cuh: packed reads)."""


def ptxas_line(probe, name: str, kernel: str) -> str:
    """The ptxas report of ``kernel``'s path instance (PATH_LAYOUT) in
    the -Xptxas -v build ``name``: registers, spill stores and loads,
    static shared bytes."""
    text = probe_wait(probe, name)
    lines = text.splitlines()
    at = [k for k, line in enumerate(lines)
          if "Compiling entry function" in line and kernel in line
          and PATH_LAYOUT in line]
    if not at:
        return f"no ptxas report for {kernel}"
    rep = " ".join(line.split("ptxas info    :")[-1].strip()
                   for line in lines[at[0] + 1:at[0] + 4]
                   if "ptxas info" in line and "Compiling" not in line)
    return re.sub(r"\s+", " ", rep)


# the mangled instance of K8's kernels: unsigned long (64-bit keys), or
# unsigned __int128
K8_INSTANCES = {"64-bit": "ImE", "128-bit": "IoE"}


K8_STAMPS = 32                    # csrc/select.cu kK8Stamps
K8_PASSES = 12                    # csrc/select.cu kMaxPasses


def k8_pass_spans(counts) -> str:
    """Each sort pass's stamps (``select_syncs``, after the sync stamps):
    for tiles 0 and T - 1, the tile's start after tile 0's, then its
    ranking, its digits' look-back and its scatter, in microseconds."""
    at = 4 + 2 * K8_STAMPS
    out = []
    for launch, sort in ((0, "dedup"), (1, "triple")):
        for pass_ in range(K8_PASSES):
            base = at + (launch * K8_PASSES + pass_) * 8
            t0, t1 = counts[base:base + 4], counts[base + 4:base + 8]
            if not all(t0) or not all(t1):
                continue
            span = lambda t: "/".join(f"{(b - a) / 1000:.2f}"
                                      for a, b in zip(t, t[1:]))
            out.append(f"{sort} pass {pass_ + 1} tile 0 {span(t0)}, tile "
                       f"T-1 +{(t1[0] - t0[0]) / 1000:.2f} {span(t1)}")
    return "; ".join(out)


def k8_spans(counts, syncs, passes) -> str:
    """Block 0's microseconds from one stamp to the next in each of K8's
    launches (``select_syncs``: its start, the end of each grid sync, its
    end), named by the phase they hold."""
    names = (["zeroing", "stage 0 + the encapsulated widths' scan",
              "stage 1 (lanes, run starts)",
              "stage 2 + the loci, traversing and row-count scans",
              "the loci lanes + buckets", "keys + histogram"]
             + [f"dedup pass {k + 1}" for k in range(passes[0])]
             + ["kept lanes, conflicts, runs", "stages 4-5 (block 0)"],
             ["row keys + histogram"]
             + [f"triple pass {k + 1}" for k in range(passes[1])]
             + ["the triples out (block 0)"])
    out = []
    for launch in (0, 1):
        t = counts[4 + launch * K8_STAMPS:][:syncs[launch] + 2]
        us = [(b - a) / 1000 for a, b in zip(t, t[1:])]
        named = names[launch] if len(names[launch]) == len(us) else [
            f"span {k}" for k in range(len(us))]
        out.append(f"launch {launch + 1} " + ", ".join(
            f"{n} {u:.2f}" for n, u in zip(named, us)))
    return "; ".join(out)


def select_ptxas(probe) -> str:
    """The ptxas report of K8's two kernels in both key instances
    (the -Xptxas -v build of csrc/select.cu): registers, stack and
    static shared bytes."""
    lines = probe_wait(probe, "select_ptxas").splitlines()
    out = []
    for kernel in ("select_kernel", "triples_kernel"):
        for inst, tag in K8_INSTANCES.items():
            at = [k for k, line in enumerate(lines)
                  if "Compiling entry function" in line
                  and f"{kernel}{tag}" in line]
            near = lines[at[0]:at[0] + 4] if at else []
            used = [line for line in near if "Used" in line]
            spill = [line.strip() for line in near if "spill" in line]
            rep = (re.sub(r".*Used ", "", used[0]).strip()
                   + (f" ({spill[0]})" if spill else "") if used
                   else "no ptxas report")
            out.append(f"{kernel} {inst}: {rep}")
    return "; ".join(out)


def grid_sync_ms(probe, blocks: int, runs: int) -> float:
    """One empty grid sync's time on a cooperative grid of ``blocks``
    blocks of 256 threads (GRID_SYNC_SRC): a launch of 200 syncs less a
    launch of none, by queued CUDA events, over 200."""
    import torch

    lib = probe_lib(probe)
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(syncs):
        err = lib.grid_sync_probe(blocks, syncs, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"grid sync probe: CUDA error {err}")

    t0 = time_ms(lambda: launch(0), runs)
    t1 = time_ms(lambda: launch(200), runs)
    torch.cuda.synchronize()
    if int(out.item()) != 200:
        raise AssertionError("the grid sync probe did not run its syncs")
    return (t1 - t0) / 200


def probe_run(probe, name: str, lib_name: str, module, call, want):
    """``call`` once with the probe build ``name`` in place of the path's
    csrc/<lib_name>.cu, its output equal to ``want``. Returns the probe
    library (its stamps and sync counts are the last launch's)."""
    import torch

    from gramtools_tpu_torch.ops import _build

    lib = probe_lib(probe, name)
    path_lib = _build._LIBS[lib_name]
    _build._LIBS[lib_name] = lib
    try:
        module._kernel_lib()
        got = call()
        torch.cuda.synchronize()
    finally:
        _build._LIBS[lib_name] = path_lib
    _equal(got, want)
    return lib


STAMP_STEPS, STAMP_PTS = 256, 10  # csrc/scan_common.cuh kStampSteps, Pts
PUB_TILES, PUB_PTS = 1024, 6      # csrc/scan_common.cuh kPubTiles, Pts
# The stamp points of a step (csrc/*.cu, STAMP / NSTAMP / WSTAMP), as
# (stage, from point, to point). K3's locked range: the step's start, its
# base and narrow loads in, its cnt scan done, the last warp's look-back
# done, the block at its pairs, the pairs done, the step done; and thread
# 0's first pair done.
STAGES = (("loads", 0, 1), ("wide rank + cnt scan", 1, 2),
          ("look-back (last warp)", 2, 3), ("first pairs (thread 0)", 2, 7),
          ("until the pairs' barrier", 2, 4), ("records + empty records", 4, 5),
          ("placement", 5, 6))
# K2's and K3's hole-allocated steps, by tile (0, T / 2, T - 1): the
# tile's start, its carry and base loaded, its LF done, its scans done
# (the wide rank's look-back first, in K3), its last warp's look-back
# done, the block past the look-back's barrier, the survivors or own rows
# and the pairs done, the candidates' look-back done, the tile done, and
# its block's grid sync at the step's end done
TILE_STAGES = (("carry + base", 0, 9), ("LF", 9, 1), ("scans", 1, 2),
               ("look-back (last warp)", 2, 3), ("until its barrier", 2, 4),
               ("rows + pairs", 4, 5), ("candidate look-back", 5, 6),
               ("stage + empty records", 6, 7), ("to the grid sync's end", 7, 8))
STAMP_ROWS = ("tile 0", "tile T/2", "tile T-1")


def read_stamps(fn, *args):
    """The probe's stamps of its last launch: (STAMP_STEPS, 3,
    STAMP_PTS) int64 nanoseconds."""
    import ctypes

    import numpy as np

    buf = (ctypes.c_ulonglong * (STAMP_STEPS * 3 * STAMP_PTS))()
    err = fn(buf, *args)
    if err:
        raise RuntimeError(f"reading the stamps failed: CUDA error {err}")
    return np.frombuffer(buf, dtype=np.uint64).reshape(
        STAMP_STEPS, 3, STAMP_PTS).astype(np.int64)


def read_syncs(fn):
    """The probe's grid syncs of its last launch: [in the steps' range,
    after it]."""
    import ctypes

    buf = (ctypes.c_ulonglong * 2)()
    err = fn(buf)
    if err:
        raise RuntimeError(f"reading the sync count failed: CUDA error {err}")
    return [int(buf[0]), int(buf[1])]


def read_pubs(fn):
    """Every tile's publish times of the probe's last launch:
    (STAMP_STEPS, PUB_TILES, 2) int64 nanoseconds (its payload, its
    candidate count)."""
    import ctypes

    import numpy as np

    buf = (ctypes.c_ulonglong * (STAMP_STEPS * PUB_TILES * PUB_PTS))()
    err = fn(buf)
    if err:
        raise RuntimeError(f"reading the publish times failed: CUDA error "
                           f"{err}")
    return np.frombuffer(buf, dtype=np.uint64).reshape(
        STAMP_STEPS, PUB_TILES, PUB_PTS).astype(np.int64)


def pub_stages(pubs, stamps, tiles, starts: bool = False) -> str:
    """Per step (``tiles`` its tile count): when, from tile 0's start,
    the median and the last tile published its payload and its candidate
    count, and which tile was last; with ``starts`` (K2), each tile's carry
    and base and its LF time, median and most."""
    import numpy as np

    parts = []
    for t, T in enumerate(tiles[:STAMP_STEPS]):
        ran = pubs[t, :min(T, PUB_TILES), 0] > 0      # the tiles that ran
        x = pubs[t, :ran.size][ran] - stamps[t, 0, 0]
        line = (f"step {t} ({int(ran.sum())} tiles ran): payload median "
                f"{np.median(x[:, 0]):.0f}, "
                f"last {x[:, 0].max()} (tile {int(x[:, 0].argmax())}); "
                f"candidates median {np.median(x[:, 1]):.0f}, last "
                f"{x[:, 1].max()} (tile {int(x[:, 1].argmax())})")
        if starts:
            cb, lf = x[:, 3] - x[:, 2], x[:, 4] - x[:, 3]
            sm = pubs[t, :ran.size, 5][ran]
            busy = lf > 1000            # tiles whose LF does real work
            share = [int((sm[busy] == sm[k]).sum()) for k in
                     np.flatnonzero(busy)]
            slow = int(lf.argmax())
            line += (f"; carry + base median {np.median(cb):.0f}, most "
                     f"{cb.max()} (tile {int(cb.argmax())}); LF median "
                     f"{np.median(lf):.0f}, most {lf.max()} (tile {slow}, "
                     f"SM {sm[slow]}, {int((sm[busy] == sm[slow]).sum())} "
                     f"busy tiles there); {int(busy.sum())} busy tiles on "
                     f"{len(set(sm[busy].tolist()))} SMs, at most "
                     f"{max(share, default=0)} an SM; start median "
                     f"{np.median(x[:, 2]):.0f}, last {x[:, 2].max()}")
        parts.append(line)
    return "; ".join(parts)


def median_stages(a, stages, S: int) -> str:
    """Each stage's median nanoseconds a step over S steps, by stamp row,
    and the median step."""
    import numpy as np

    a = a[:min(S, STAMP_STEPS)]
    parts = []
    for sel, label in enumerate(("tile 0", "tile T/2", "tile T-1")):
        x = a[:, sel, :]
        parts.append(f"{label}: " + ", ".join(
            f"{name} {np.median(x[:, j] - x[:, i]):.0f}"
            for name, i, j in stages)
            + f"; step {np.median(np.diff(x[:, 0])):.0f}")
    return "; ".join(parts)


def step_stages(a, stages, S: int, rows=STAMP_ROWS) -> str:
    """Each step's stage nanoseconds by stamp row, and the step's span
    from the first row's start to the latest row's end."""
    a = a[:min(S, STAMP_STEPS)]
    last = stages[-1][2]
    parts = []
    for t in range(a.shape[0]):
        rows_t = [f"{label} " + "/".join(
            f"{a[t, sel, j] - a[t, sel, i]}" for _, i, j in stages)
            for sel, label in enumerate(rows)]
        span = int(a[t, :, last].max() - a[t, :, 0].min())
        parts.append(f"step {t} ({span} ns): " + ", ".join(rows_t))
    return "; ".join(parts)


def tile_pairs(cnts, B: int) -> str:
    """Per step: total hits, the hit pairs within the budget G of the
    tile that holds the most (tiles of 256 slots) and the tiles holding
    any, from each step's per-slot hit counts ``cnts``."""
    import torch

    parts = []
    for cnt, g in cnts:
        cnt = cnt.to(torch.int64).cpu()
        start = torch.cumsum(cnt, 0) - cnt
        ok = (torch.clamp(start + cnt, max=g) - start).clamp(min=0)
        pad = (-ok.shape[0]) % 256
        tiles = torch.cat([ok, ok.new_zeros(pad)]).view(-1, 256).sum(1)
        parts.append(f"{int(cnt.sum())} hits, max {int(tiles.max()) * B} "
                     f"pairs a tile, {int((tiles > 0).sum())}/"
                     f"{tiles.shape[0]} tiles with pairs")
    return "; ".join(parts)


def narrow_load_us(cfg: SmokeConfig, probe, narrow_tab, start: int) -> float:
    """Microseconds of one dependent narrow-table load on the card: one
    thread's chase of CHASE_STEPS loads from row ``start``, timed by
    queued events after a warm-up call (the table's lines then sit in L2,
    as the scan leaves them), over the loads."""
    import torch

    lib = probe_lib(probe)
    out = torch.empty(1, dtype=torch.int32, device=narrow_tab.device)

    def chase():
        err = lib.narrow_chase(narrow_tab.data_ptr(), narrow_tab.shape[0],
                               start, CHASE_STEPS, out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"narrow chase probe launch failed: {err}")

    return 1000.0 * time_ms(chase, 3) / CHASE_STEPS


CHASE_STEPS = 8192


def probe_cursor_walk(cfg: SmokeConfig, probe, walk_args):
    """The cursor walk kernel on the path's walk inputs, with its one
    global cursor and with a cursor word per lane: emissions equal to
    the plain walk's (shared cursor), and both times by queued CUDA
    events.
    Returns the shared-cursor kernel as a stand-in for ``walk_torch``
    (the sort design of the per-base recorder)."""
    import ctypes

    import torch

    from gramtools_tpu_torch.ops import walk

    lib = probe_lib(probe)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cursor_walk.argtypes = ([i, i] + [p] * 8
                                + [p, i, p, p, i, i, i, p, p, p, p])
    lib.cursor_walk.restype = ctypes.c_int

    def run(unique, nt_walk, nt_edges, valid, cur0, start0, remaining0,
            trav_idx0, w_item, read_of, full, ps_trav, emitcap, max_iter):
        lanes = cur0.shape[0]
        emits = torch.full((emitcap, 4), walk.BIG, dtype=torch.int32,
                           device=cur0.device)
        counters = torch.zeros(lanes + 2, dtype=torch.int32,
                               device=cur0.device)
        err = lib.cursor_walk(
            unique, lanes, valid.data_ptr(), cur0.data_ptr(),
            start0.data_ptr(), remaining0.data_ptr(), trav_idx0.data_ptr(),
            w_item.data_ptr(), read_of.data_ptr(), full.data_ptr(),
            ps_trav.data_ptr(), ps_trav.shape[1], nt_walk.data_ptr(),
            nt_edges.data_ptr(), nt_edges.shape[0], max_iter, emitcap,
            emits.data_ptr(), counters.data_ptr(),
            counters[lanes + 1:].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cursor walk probe launch failed: {err}")
        return emits, (counters[0] > emitcap) | (counters[lanes + 1] > 0)

    got, _ = run(0, *walk_args)
    want, _ = walk.walk_torch(*walk_args)
    rows = lambda e: sorted(map(tuple, e[e[:, 0] < walk.BIG].cpu().tolist()))
    if rows(got) != rows(want):
        raise AssertionError("cursor walk probe != the plain walk")
    ms = {u: time_ms(lambda: run(u, *walk_args), cfg.timing_runs)
          for u in (0, 1)}
    emitcap, lanes = walk_args[11], walk_args[3].shape[0]
    fill = time_ms(lambda: (torch.full((emitcap, 4), walk.BIG,
                                       dtype=torch.int32, device=got.device),
                            torch.zeros(lanes + 2, dtype=torch.int32,
                                        device=got.device)), cfg.timing_runs)
    say(f"[phase 1d] probe, the cursor walk kernel on buffer 1's walk inputs "
        f"({len(rows(want))} emissions, equal to the plain walk's): one "
        f"global cursor {ms[0]:.4f} ms, a cursor word per lane "
        f"{ms[1]:.4f} ms, queued events, each with its {fill:.4f} ms of "
        f"buffer fills")
    return lambda *a: run(0, *a)


def phase_fused_parity(cfg: SmokeConfig, idx, kmer_index, reads, device):
    """Phase 2b: one 4,096-read buffer's fused program on CUDA and on
    the CPU (plain torch: the kernels' twins)."""
    import numpy as np
    import torch

    from gramtools_tpu_torch.mapping.quasimap import QuasimapStats, ReadBatch
    from gramtools_tpu_torch.mapping import engine as engine_mod
    from gramtools_tpu_torch.mapping.device_index import DeviceIndex
    from gramtools_tpu_torch.mapping.record import RecordTables, SeedTables
    from gramtools_tpu_torch.mapping.search_log import log_search_record

    os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    engine = engine_mod.LogBatchedEngine(idx, cfg.kmer_size, device=device)
    captured = {}

    def capture(*args, **kwargs):
        captured["call"] = (args, kwargs)
        return log_search_record(*args, **kwargs)

    batch = ReadBatch(np.ascontiguousarray(reads[:cfg.scan_reads]))
    _, firsts = _first_draws(cfg, cfg.scan_reads, 7)
    launches = {name: fn.launches for name, fn in _counted().items()}
    engine_mod.log_search_record = capture
    try:
        t0 = time.perf_counter()
        token = engine.scan_submit(batch, kmer_index, cfg.kmer_size,
                                   QuasimapStats(), first_raws=firsts)
        flat_cuda = token[2][1].get()
        cuda_s = time.perf_counter() - t0
    finally:
        engine_mod.log_search_record = log_search_record
    cov_cuda = engine.cov_diff[0].cpu()
    for name in PATH_KERNELS:
        if _counted()[name].launches <= launches[name]:
            raise AssertionError(f"the fused program launched no {name}")
    (di, rt, st, *rest), kwargs = captured["call"]
    cov_cpu = torch.zeros(rt.cov_size + 1, dtype=torch.int32)
    t0 = time.perf_counter()
    flat_cpu = log_search_record(
        DeviceIndex.build(idx, engine.jt, "cpu"), RecordTables.build(idx, "cpu"),
        SeedTables.build(kmer_index, "cpu"), *(a.cpu() for a in rest[:6]),
        cov_cpu, *rest[7:], blocks=kwargs["blocks"].cpu(),
        rank=kwargs["rank"]).numpy()
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(flat_cuda, flat_cpu):
        raise AssertionError(f"fused flat result: cuda != cpu "
                             f"({int((flat_cuda != flat_cpu).sum())} words)")
    if not torch.equal(cov_cuda, cov_cpu):
        raise AssertionError("cov_diff: cuda != cpu")
    R, trip_cap = rest[8], rest[9]
    fb = flat_cuda[R:2 * R]
    say(f"[phase 2b] fused program on {len(token[1])} rows (R={R}, "
        f"trip_cap={trip_cap}): flat result ({flat_cuda.size} int32) and "
        f"cov_diff ({cov_cpu.numel()} int32, {int((cov_cpu != 0).sum())} "
        f"non-zero) equal on cuda (K2, K3, K7, K8 and K9 launched) "
        f"and cpu; {int(flat_cuda[2 * R:3 * R].sum())}"
        f" rows mapped, {int((fb != 0).sum())} flagged, "
        f"{int((flat_cuda[3 * R:3 * R + trip_cap] < R).sum())} loci triples;"
        f" {cuda_s:.3f} s cuda submit+wait, {cpu_s:.3f} s cpu")


def genotype_args(gram: Path, out: Path, reads: Path, engine: str,
                  ploidy: str = "haploid"):
    return ["genotype", "--gram_dir", str(gram), "--genotype_dir", str(out),
            "--reads", str(reads), "--sample_id", "smoke", "--seed", "7",
            "--engine", engine, "--force"] + (
                ["--ploidy", ploidy] if ploidy != "haploid" else [])


class _Count:
    """A launch count kept under another attribute of a wrapper, or
    the sum of that attribute over several wrappers."""

    def __init__(self, fns, attr: str):
        self.fns = fns if isinstance(fns, tuple) else (fns,)
        self.attr = attr

    @property
    def launches(self) -> int:
        return sum(getattr(fn, self.attr) for fn in self.fns)

    @launches.setter
    def launches(self, value: int):
        for fn in self.fns:
            setattr(fn, self.attr, value)


def _counted():
    """The kernels' launch counts, by name: each wrapper's ``launches``;
    K3 narrow's is the narrow-tail launches that ran hole-allocated
    steps; K6's the K2 and K3 launches that decoded packed reads, K10's
    the sharded scan's launches on every card."""
    from gramtools_tpu_torch.ops import (locked_step, rank, replay, select,
                                         sharded, walk, wide_step)

    return {"packed_rank": rank.packed_rank, "replay": replay.replay,
            "per_base": walk.per_base_cuda,
            "wide_step": wide_step.wide_steps,
            "narrow_step": _Count(locked_step.locked_tail, "narrow_launches"),
            "locked_step": locked_step.locked_tail,
            "select": select.select_cuda,
            "unpack": _Count((wide_step.wide_steps, locked_step.locked_tail),
                             "packed_launches"),
            "sharded_index": sharded.sharded_scan}


class TimerLines(logging.Handler):
    """Keeps the phase seconds of the last "Timer report" that the
    "gramtools_tpu" logger emits (common/timers.py::TimerReport.report:
    one line a phase, "  <name> <seconds>s[  peak <MB>MB]")."""

    LINE = re.compile(r"^\s+(\S.*?)\s+([0-9.]+)s(\s+peak\s.*)?$")

    def __init__(self):
        super().__init__(logging.INFO)
        self.phases = {}

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Timer report"):
            self.phases = {}
        elif (m := self.LINE.match(msg)) and m.group(1) != "TOTAL":
            self.phases[m.group(1)] = float(m.group(2))


def phase_e2e(cfg: SmokeConfig, work: Path):
    """Phase 3: the main path (fused recorder, the default). Returns the
    kernels' launch counts. The phase seconds come from the run's
    "Timer report" log lines."""
    from gramtools_tpu_torch.cli import run as torch_cli

    os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    os.environ.pop("GRAMTOOLS_TPU_DEVICE_RECORD", None)
    for knob in STAGE_KNOBS:
        if knob in os.environ:
            raise AssertionError(f"{knob} is set before the main path")
    for fn in _counted().values():
        fn.launches = 0
    timer_lines = TimerLines()
    logger = logging.getLogger("gramtools_tpu")
    logger.addHandler(timer_lines)
    t0 = time.perf_counter()
    try:
        if torch_cli(genotype_args(work / "gram", work / "e2e",
                                   work / "reads.fq", "device")) != 0:
            raise RuntimeError("genotype failed")
    finally:
        logger.removeHandler(timer_lines)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in _counted().items()}
    rep = json.loads((work / "e2e" / "genotype_report.json").read_text())
    proc = rep["processes"]["genotype"]
    eng = proc["engine"]
    phases = timer_lines.phases
    quasimap_s = phases["Quasimap"]
    rows = proc["mapping_stats"]["all_reads_count"]
    fallback_share = eng["host_fallbacks"] / max(
        eng["device_mapped"] + eng["host_fallbacks"], 1)
    say(f"[phase 3] genotype --engine device, {cfg.e2e_reads} reads: "
        f"{wall:.1f} s wall, quasimap {quasimap_s:.2f} s = "
        f"{cfg.e2e_reads / quasimap_s:.0f} reads/s ({rows} oriented rows); "
        f"phases (the run's timer report) {json.dumps(phases)}; "
        f"device_mapped {eng['device_mapped']}, host_fallbacks "
        f"{eng['host_fallbacks']} ({100 * fallback_share:.2f}%), "
        f"device_retried {eng['device_retried']}; launches {launches}")
    for name in PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"the main path launched no {name} kernel")
    if launches["packed_rank"]:
        raise AssertionError("the main path launched the standalone K1")
    if eng["device_mapped"] <= 0:
        raise AssertionError("no row was mapped on the device")
    if fallback_share >= 0.05:
        raise AssertionError(f"host fallbacks {100 * fallback_share:.2f}% "
                             ">= 5%")
    return launches


PARITY_FILES = ("genotype/genotyped.vcf.gz", "genotype/genotyped.json",
                "coverage/allele_sum_coverage",
                "coverage/grouped_allele_counts_coverage.json",
                "coverage/allele_base_coverage.json",
                "genotype/personalised_reference.fasta")


def _read_output(path: Path) -> bytes:
    """An output file's bytes (a gzipped VCF without ##fileDate)."""
    if path.suffix == ".gz":
        with gzip.open(path, "rb") as fh:
            return b"".join(l for l in fh if not l.startswith(b"##fileDate"))
    return path.read_bytes()


def phase_parity(work: Path):
    """Phase 4: the port's device engine (CUDA), with each recorder,
    against the port's own host engine (the scalar oracle,
    mapping/search.py). The chain back to the JAX package is held on the
    CPU: tests/test_torch_standalone.py holds the port's host engine and
    build byte-equal to the reference's."""
    from gramtools_tpu_torch.cli import run as torch_cli

    runs = {}
    for name, engine, record in (("par_dev1", "device", "1"),
                                 ("par_dev0", "device", "0"),
                                 ("par_host", "host", None)):
        if record is not None:
            os.environ["GRAMTOOLS_TPU_DEVICE_RECORD"] = record
        t0 = time.perf_counter()
        try:
            if torch_cli(genotype_args(work / "gram", work / name,
                                       work / "reads_parity.fq",
                                       engine)) != 0:
                raise RuntimeError(f"genotype --engine {engine} failed")
        finally:
            os.environ.pop("GRAMTOOLS_TPU_DEVICE_RECORD", None)
        runs[name] = time.perf_counter() - t0

    for name in ("par_dev1", "par_dev0"):
        for rel in PARITY_FILES:
            if _read_output(work / name / rel) != _read_output(
                    work / "par_host" / rel):
                raise AssertionError(f"{rel}: device ({name}) != host")
    say(f"[phase 4] {len(PARITY_FILES)} output files byte-equal, the port's "
        f"device engine (fused recorder: {runs['par_dev1']:.1f} s run; host "
        f"recorder, GRAMTOOLS_TPU_DEVICE_RECORD=0: {runs['par_dev0']:.1f} s "
        f"run) vs the port's host engine ({runs['par_host']:.1f} s run)")


def _timed(times: list, fn):
    """fn, with the host seconds of each call appended to times."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            times.append(time.perf_counter() - t0)
    return wrapper


def phase_mesh(cfg: SmokeConfig, idx, kmer_index, work: Path, device):
    """Phase 5a: the e2e reads through the port's quasimap_reads with a
    MeshLogEngine of 2 shards on one card (the device listed twice),
    against a 1-shard run of the same reads and seed. Returns the 2-shard
    run's launch counts."""
    import numpy as np
    import torch

    from gramtools_tpu_torch.mapping.quasimap import DEVICE_BUFFER_SIZE
    from gramtools_tpu_torch.mapping.quasimap import quasimap_reads
    from gramtools_tpu_torch.parallel.mesh import MeshLogEngine, make_mesh

    os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    os.environ.pop("GRAMTOOLS_TPU_DEVICE_RECORD", None)
    runs, lines = {}, []
    for S in (1, 2):
        idx.graph.coverage[:] = 0
        engine = MeshLogEngine(idx, cfg.kmer_size,
                               mesh=make_mesh(devices=[device] * S))
        submit_s, complete_s = [], []
        engine.scan_submit = _timed(submit_s, engine.scan_submit)
        engine.record_complete = _timed(complete_s, engine.record_complete)
        if S == 2:
            for fn in _counted().values():
                fn.launches = 0
        t0 = time.perf_counter()
        stats, cov = quasimap_reads([str(work / "reads.fq")], kmer_index,
                                    idx, cfg.kmer_size, seed=cfg.seed,
                                    engine=engine,
                                    buffer_size=DEVICE_BUFFER_SIZE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if S == 2:
            launches = {name: fn.launches for name, fn in _counted().items()}
        share = engine.host_fallbacks / max(
            engine.device_mapped + engine.host_fallbacks, 1)
        runs[S] = (stats.as_dict(), cov.allele_sum, cov.grouped_counts,
                   idx.graph.coverage.copy())
        lines.append(
            f"{S} shard{'s' if S > 1 else ''}: {wall:.2f} s quasimap = "
            f"{cfg.e2e_reads / wall:.0f} reads/s, scan_submit s "
            f"{[round(t, 3) for t in submit_s]}, record_complete s "
            f"{[round(t, 3) for t in complete_s]}, device_mapped "
            f"{engine.device_mapped}, host_fallbacks {engine.host_fallbacks}"
            f" ({100 * share:.3f}%), device_retried {engine.device_retried}")
        if engine.device_mapped <= 0:
            raise AssertionError(f"{S}-shard run mapped no row on the device")
        if share >= 0.05:
            raise AssertionError(f"{S}-shard host fallbacks "
                                 f"{100 * share:.2f}% >= 5%")
        del engine
    one, two = runs[1], runs[2]
    for i, what in enumerate(("stats", "allele-sum", "grouped counts")):
        if one[i] != two[i]:
            raise AssertionError(f"2-shard {what} != 1-shard {what}")
    if not np.array_equal(one[3], two[3]):
        raise AssertionError("2-shard per-base coverage != 1-shard")
    say(f"[phase 5a] mesh of 2 shards on {device} (one card listed twice), "
        f"{cfg.e2e_reads} reads in {DEVICE_BUFFER_SIZE}-read buffers: stats, "
        f"allele-sum, grouped counts and per-base coverage equal to 1 shard; "
        + "; ".join(lines) + f"; 2-shard launches {launches}")
    for name in PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"the 2-shard run launched no {name} kernel")
    return launches


def phase_index_sharded(cfg: SmokeConfig, idx, kmer_index, reads, device,
                        work: Path):
    """Phase 5b, the index-sharded path (K10): one whole buffer's scan
    (DEVICE_BUFFER_SIZE reads, the engine's own phases, dense rank) with
    the index split over 4 and over 3 SA-range shards on the card, held
    and timed by ``check_index_sharded``, and traced. Returns K10's entry
    of the kernels line."""
    import numpy as np

    from gramtools_tpu_torch.mapping.quasimap import (DEVICE_BUFFER_SIZE,
                                                      ReadBatch)
    from gramtools_tpu_torch.mapping.engine import LogBatchedEngine

    os.environ["GRAMTOOLS_TPU_RANK"] = "dense"
    try:
        engine = LogBatchedEngine(idx, cfg.kmer_size, device=device)
    finally:
        os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    batch = ReadBatch(np.ascontiguousarray(reads[:DEVICE_BUFFER_SIZE]))
    k10 = check_index_sharded("5b", engine, batch, kmer_index,
                              cfg.kmer_size, device, work, cfg.timing_runs,
                              trace=True)
    entry = kernel_entry(
        "sharded_index", "gramtools_tpu_torch/csrc/sharded_step.cu",
        "gramtools_tpu/parallel/sharded_index.py:98", k10["m"],
        [{"sharded_index": k10["launches"]}],
        {"sharded_index": k10["trace_ms"]})
    entry.update(launches=k10["launches"], path="index-sharded (5b)",
                 collectives=k10["collectives"],
                 replicated_ms=k10["replicated_ms"],
                 three_shards_ms=k10["three_shards_ms"],
                 enqueue_ms=k10["enqueue_ms"])
    return entry


def narrow_np(di):
    """The index's narrow table on the host, or None where it is the
    stub of an index of 2**24 rows or more (no narrow tail)."""
    nt = di.narrow_tab.cpu().numpy()
    return nt if nt.shape[0] == di.size else None


def check_index_sharded(tag: str, engine, batch, kmer_index, kmer_size: int,
                        device, work: Path, timing_runs: int, trace: bool):
    """The index-sharded path (K10) on one buffer of a dense-rank engine
    (``engine``, its phases): the buffer's scan with the index split over
    4 and over 3 SA-range shards on the card, the scan in gather rounds
    (csrc/sharded_step.cu: two launches a step, the card's masked gathers
    summing its own shards, no collective on one card); its flat result
    equal to the replicated scan's, the engine's and the plain version's
    (the torch steps over the masked gathers of build_tables' shards: one
    run counts its gathers' calls and bytes, one uncounted run is timed),
    and the same over 20 repeated 4-shard scans; K10's launches and
    collectives (the counts set to 0 just before one sharded scan and
    read just after: 2 a step and 1); its time by events, each scan
    queued alone behind a sleep of the card, beside the replicated
    dense-rank scan (K2, and K3 where the index has a narrow table),
    and, with ``trace``, traced (trace_k10_apart; the phase fails without
    both marked windows); its bound (the replicated launches' bytes: one
    card moves nothing over NVLink). Returns its numbers: ``m`` (the
    kernels line's), the launches and collectives of a 4-shard scan, the
    times and, traced, its device time."""
    import numpy as np
    import torch

    from gramtools_tpu_torch.mapping.quasimap import QuasimapStats
    from gramtools_tpu_torch.mapping.search_log import log_search_phases
    from gramtools_tpu_torch.ops import locked_step, sharded, wide_step
    from gramtools_tpu_torch.parallel import sharded_index
    from gramtools_tpu_torch.parallel.mesh import Mesh

    if engine.rank != "dense":
        raise AssertionError("the index-sharded scan is held to a dense-rank "
                             "engine's")
    token = engine.scan_submit(batch, kmer_index, kmer_size, QuasimapStats())
    (pending, phases, R), carry, reads_T = token[2], token[5], token[6]
    engine_flat = pending.get()
    args = lambda: (torch.from_numpy(reads_T).to(device),
                    tuple(torch.from_numpy(a).to(device) for a in carry))
    counted = _counted()["sharded_index"]
    calls = {}
    path = (wide_step.wide_steps_cuda, locked_step.locked_tail_cuda)

    def keep(name, fn):
        def wrapper(*a):
            calls[name] = a
            return fn(*a)
        return wrapper

    def flat(out):
        (rid, lo, hi, pref, ovf), (lp, le) = out
        return torch.cat([rid, lo, hi, pref, ovf.to(torch.int32), lp,
                          le]).cpu().numpy()

    flats, secs, launched, collectives = {}, {}, {}, {}
    runs = {"replicated": lambda rt, c: log_search_phases(
        engine.di, rt, c, phases, R)}
    for n_idx in (4, 3):
        runs[f"{n_idx} shards"] = sharded_index.make_index_sharded_log_search(
            Mesh([device] * n_idx, ("idx",)), engine.di, engine.cfg, R,
            phases=phases)
    for name, run in runs.items():
        a = args()
        calls.clear()
        wide_step.wide_steps_cuda = keep("wide", path[0])
        locked_step.locked_tail_cuda = keep("tail", path[1])
        counted.launches = 0
        sharded.sharded_scan.collectives = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = run(*a)
            torch.cuda.synchronize()
        finally:
            wide_step.wide_steps_cuda, locked_step.locked_tail_cuda = path
        secs[name] = time.perf_counter() - t0
        launched[name] = counted.launches
        collectives[name] = sharded.sharded_scan.collectives
        flats[name] = flat(out)
        if name == "replicated":
            rep_w, rep_t = calls["wide"], calls.get("tail")
        elif calls:
            raise AssertionError(f"the {name} scan ran K2 or K3")
    steps = sum(e[0] for e in phases)
    if launched["replicated"] or any(
            launched[f"{n} shards"] != 2 * steps + 1
            or collectives[f"{n} shards"] for n in (4, 3)):
        raise AssertionError(f"K10 launches {launched}, collectives "
                             f"{collectives}: {2 * steps + 1} launches and "
                             f"no collective a sharded scan on one card, "
                             f"none in the replicated one")
    a = args()
    repeated = [flat(runs["4 shards"](*a)) for _ in range(20)]
    if any(not np.array_equal(r, repeated[0]) for r in repeated[1:]):
        raise AssertionError("20 repeated 4-shard scans differ")
    flats["4 shards, repeated"] = repeated[-1]
    # the plain version: the torch steps over the shards' masked gathers,
    # once counting its gathers (torch.unique synchronises: not timed),
    # then once timed, uncounted
    di = engine.di
    tables = sharded.build_tables(di.occ.cpu().numpy(), narrow_np(di),
                                  di.size, [device] * 4, device)
    plain = lambda rt, c: log_search_phases(
        di, rt, c, phases, R, occ_rows=tables.occ_rows(),
        narrow_rows=tables.narrow_rows())
    k10 = {"calls": 0, "bytes": 0}
    factory = sharded._sharded_gather

    def watched(parts, rows_per_shard, lo, hi, home):
        gather = factory(parts, rows_per_shard, lo, hi, home)
        row_bytes = parts[0][0][0].numel() * parts[0][0].element_size()

        def run(rows):
            k10["calls"] += 1
            k10["bytes"] += rows.numel() * (rows.element_size()
                                            + row_bytes) + row_bytes * \
                torch.unique(rows.clamp(lo, hi)).numel()
            return gather(rows)
        return run

    sharded._sharded_gather = watched
    try:
        flats["plain, counted"] = flat(plain(*args()))
    finally:
        sharded._sharded_gather = factory
    a = args()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = plain(*a)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    flats["plain"] = flat(out)
    for name, got in flats.items():
        if not np.array_equal(got, engine_flat):
            raise AssertionError(f"{name} scan != the engine's flat result "
                                 f"({int((got != engine_flat).sum())} words)")
    # by events (each sharded scan alone behind a sleep: its launches would
    # fill the card's queue), and traced in a process of its own
    a = args()
    ms = {"replicated": time_ms(lambda: runs["replicated"](*a),
                                timing_runs)}
    for name in ("4 shards", "3 shards", "4 shards again"):
        ms[name] = time_each_ms(lambda: runs[name[:8]](*a), timing_runs)
    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs["4 shards"](*a)
        enqueue.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    windows = (trace_k10_apart({"di": di, "reads": a[0], "carry": a[1],
                                "phases": phases, "R": R}, work)
               if trace else None)
    nbytes = wide_bytes(rep_w[:8], rep_w[6]) + (
        0 if rep_t is None else tail_bytes(rep_t[:11], rep_t[5]))
    attrs = [sharded.kernel_attrs(w) for w in (0, 1)]
    shown = lambda w: f"{w[1]:.4f} ms busy over {w[0]} device events"
    say(f"[phase {tag}] index of {engine.di.size} rows in 4 and in 3 "
        f"SA-range shards on {device} (rows a shard "
        f"{-(-(engine.di.size + 1) // 4)} and "
        f"{-(-(engine.di.size + 1) // 3)}), dense rank, phases "
        f"{phases}: flat result of {len(token[1])} reads (R={R}, "
        f"{engine_flat.size} int32) equal to the replicated scan's, the "
        f"engine's, the plain version's (the torch steps over the "
        f"masked gathers: {k10['calls']} gather calls, {k10['bytes']} "
        f"bytes, bound {bound_ms(k10['bytes']):.4f} ms, in a counting "
        f"run; {plain_s:.3f} s host clock, one uncounted run) and over 20 "
        f"repeated 4-shard scans; K10 launches (sharded_open_kernel and "
        f"sharded_mid_kernel, {steps} steps) {launched}, collectives "
        f"{collectives}; open kernel {attrs[0]['registers']} registers, "
        f"{attrs[0]['local_bytes']} local bytes, {attrs[0]['shared_bytes']}"
        f" shared bytes; mid kernel {attrs[1]['registers']}, "
        f"{attrs[1]['local_bytes']}, {attrs[1]['shared_bytes']}; scan + "
        f"fetch, host clock, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + "; by events, ms (a sharded scan alone behind a sleep, the "
        f"median of {timing_runs}; the replicated "
        f"{'K2' if rep_t is None else 'K2 + K3'} queued): "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
        + f"; the 4-shard scan's enqueue on the host "
        f"{1000 * min(enqueue):.3f} ms (the least of 5); "
        + ("" if windows is None else
           f"traced: 4 shards {shown(windows[0])}, replicated dense "
           f"{shown(windows[1])}; ")
        + f"bound {bound_ms(nbytes):.4f} ms ({nbytes} bytes, the replicated "
        f"launches', none over NVLink on one card), the 4-shard scan at "
        f"{100 * bound_ms(nbytes) / ms['4 shards']:.2f}% of it by events")
    m = {"max_abs_err": 0, "ms": ms["4 shards"], "plain_ms": 1000 * plain_s,
         "bound_ms": bound_ms(nbytes), "library_ms": None}
    return {"m": m, "launches": launched["4 shards"],
            "collectives": collectives["4 shards"],
            "replicated_ms": ms["replicated"],
            "three_shards_ms": ms["3 shards"],
            "enqueue_ms": 1000 * min(enqueue), "steps": steps,
            "trace_ms": None if windows is None else windows[0][1]}


def k10_scans(saved):
    """{tag: a phase 5b scan of the inputs ``saved`` (the index, reads,
    carry, phases, R)}: its 4-shard scan and the replicated one."""
    from gramtools_tpu_torch.mapping.search_log import log_search_phases
    from gramtools_tpu_torch.ops import sharded

    di, R, phases = saved["di"], saved["R"], saved["phases"]
    dev = saved["reads"].device
    tables = sharded.build_tables(di.occ.cpu().numpy(), narrow_np(di),
                                  di.size, [dev] * 4, dev)
    args = (saved["reads"], saved["carry"])
    return {"4 shards": lambda: log_search_phases(di, *args, phases, R,
                                                  occ_rows=tables),
            "replicated": lambda: log_search_phases(di, *args, phases, R)}


def trace_k10_apart(saved, work: Path):
    """Phase 5b's trace, in a process of its own (``--trace-k10``): the
    4-shard scan and the replicated scan, each between markers, on the
    inputs phase 5b saved (``saved``, written to a file). Late in a long
    run, a short trace in this process loses most of the card's kernel
    records (PERF.md §7), while the first traces of a process keep
    them all. Returns the two windows; raises unless the trace shows
    both."""
    import torch

    path = work / "k10_scans.pt"
    torch.save(saved, path)
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                           "--trace-k10", str(path)], capture_output=True,
                          text=True, timeout=600)
    path.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"phase 5b's trace process failed (exit "
                           f"{proc.returncode}):\n{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if len(got["windows"]) != 2:
        raise AssertionError(
            f"phase 5b's trace shows {len(got['windows'])} marked windows, "
            f"not 2 ({got['events']} device events, {got['markers']} "
            f"markers)")
    return got["windows"]


def trace_k10(saved: Path) -> dict:
    """The body of ``--trace-k10``: trace_k10_apart's trace of the scans
    of the inputs saved in ``saved``. Returns its marked windows and its
    device events and markers."""
    import torch

    scans = k10_scans(torch.load(saved, weights_only=False))

    def traced():
        scans["4 shards"]()
        torch.cuda.synchronize()
        marked(scans["4 shards"])()
        marked(scans["replicated"])()

    busy, _, _, timeline = _profile_device(traced, saved.parent / "trace_k10")
    return {"windows": marked_windows(timeline) if busy is not None else [],
            "events": len(timeline),
            "markers": sum(MARK in n for _, _, n in timeline)}


def k8_turns(cfg: SmokeConfig, captured, work: Path, others) -> list:
    """``--k8-turns``: K8 of other checkouts (``others``, e.g. the parent
    commit unpacked with ``git archive``) and of this one on buffer 1's
    selection inputs, in turns (the others, this, this, the others in
    reverse), each turn a process of its own (``--time-k8``) that builds
    its checkout's kernels and times ``select_and_record_device`` (K9
    inside) by queued events and its two kernels in one traced call.
    Returns the turns' results."""
    import torch

    (sargs, skw) = captured["select"]
    path = work / "k8_args.pt"
    torch.save({"args": list(sargs[:13]) + [torch.zeros_like(sargs[13])],
                "trip_cap": skw["trip_cap"]}, path)
    turns = []
    for checkout in (list(others) + [str(REPO), str(REPO)]
                     + list(others)[::-1]):
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                               "--time-k8", str(path), checkout],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"--time-k8 on {checkout} failed (exit "
                               f"{proc.returncode}):\n{proc.stderr[-3000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append(got)
        say(f"[k8 turns] {checkout}: K8 {got['ms']:.4f} ms by events "
            f"({cfg.timing_runs} queued calls, K9 inside), traced "
            f"select_kernel {got['select_ms']:.4f} ms + triples_kernel "
            f"{got['triples_ms']:.4f} ms = "
            f"{got['select_ms'] + got['triples_ms']:.4f} ms")
    path.unlink()
    return turns


def time_k8(saved: Path, checkout: str) -> dict:
    """The body of ``--time-k8``: the checkout's selection on the saved
    inputs, by queued CUDA events (20 calls, K9 inside) and traced once
    (its select and triples kernels' device time)."""
    import torch

    sys.path.insert(0, checkout)
    from gramtools_tpu_torch.mapping import record
    from gramtools_tpu_torch.ops import _build

    if not Path(record.__file__).resolve().is_relative_to(
            Path(checkout).resolve()):
        raise AssertionError(f"{record.__file__} is not {checkout}'s")
    _build.build_all(["select", "walk"])
    got = torch.load(saved, weights_only=False)
    args, cap = got["args"], got["trip_cap"]

    def call():
        return record.select_and_record_device(*args, trip_cap=cap)

    ms = time_ms(call, 20)
    call()
    torch.cuda.synchronize()
    kern = {"select": 0.0, "triples": 0.0}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    for ev in prof.events():
        t = getattr(ev, "device_time", None)
        if t is None:
            t = getattr(ev, "cuda_time", 0.0)
        for g in kern:
            if is_kernel(ev.name, g):
                kern[g] += t / 1000.0
    return {"checkout": checkout, "ms": ms, "select_ms": kern["select"],
            "triples_ms": kern["triples"]}


def phase_pool(work: Path):
    """Phase 5c: genotype --engine device --max_threads 2 on the parity
    reads, byte-equal to phase 4's host engine run."""
    import torch

    from gramtools_tpu_torch.cli import run as torch_cli
    from gramtools_tpu_torch.mapping.quasimap import _pool_start_method

    os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    method = _pool_start_method()
    if method != "spawn" or not torch.cuda.is_initialized():
        raise AssertionError(f"pool start method {method} beside CUDA")
    launches_before = {k: _counted()[k].launches
                       for k in ("wide_step", "locked_step")}
    t0 = time.perf_counter()
    if torch_cli(genotype_args(work / "gram", work / "par_pool",
                               work / "reads_parity.fq", "device")
                 + ["--max_threads", "2"]) != 0:
        raise RuntimeError("genotype --max_threads 2 failed")
    wall = time.perf_counter() - t0
    rep = json.loads((work / "par_pool" / "genotype_report.json").read_text())
    eng = rep["processes"]["genotype"]["engine"]
    for rel in PARITY_FILES:
        if _read_output(work / "par_pool" / rel) != _read_output(
                work / "par_host" / rel):
            raise AssertionError(f"{rel}: device with a pool != host")
    if eng["device_mapped"] <= 0:
        raise AssertionError("the pool run mapped no row on the device")
    say(f"[phase 5c] genotype --engine device --max_threads 2 ({method} "
        f"workers): {len(PARITY_FILES)} output files byte-equal to the host "
        f"engine's; {wall:.1f} s run, device_mapped {eng['device_mapped']}, "
        f"host_fallbacks {eng['host_fallbacks']}, launches in this "
        f"process (the workers' own are not counted): " + ", ".join(
            f"{k} {_counted()[k].launches - n}"
            for k, n in launches_before.items()))


# the index rows from which both packages' narrow table is a one-element
# stub (mapping/device_index.py::_build_narrow_tab) and the plan runs wide
STUB_ROWS = 2 ** 24


@dataclass
class LargeConfig:
    """Phase 6's workload: a P. falciparum-scale graph (the 3D7 nuclear
    genome, 23.3 Mb in 14 chromosomes, which gramtools' own paper
    genotypes) at the smoke's site density, one biallelic SNP per ~44
    bp; its FM index is past 2**24 rows, so its narrow table is the stub
    and every scan step runs wide."""
    genome_len: int = 23_300_000
    num_sites: int = 530_000
    read_len: int = 150
    kmer_size: int = 10
    reads: int = 60_000           # three 20,000-read device buffers
    packed_reads: int = 40_000    # the packed-rank run's: two buffers
    parity_reads: int = 4_000
    seed: int = 42


def build_large(out: Path) -> dict:
    """The body of ``--build-large OUT``: phase 6's workload written and
    built into ``out`` (common/workload.py, as phase 3's) with its parity
    reads, a line with its summary and seconds once that is done, then
    the port's host engine's genotype run on the parity reads (phase
    6b's oracle), all on the host. Returns that run's seconds."""
    from gramtools_tpu_torch.cli import run as torch_cli
    from gramtools_tpu_torch.common.workload import make_workload as make
    from gramtools_tpu_torch.common.workload import write_fastq

    lc = LargeConfig()
    t0 = time.perf_counter()
    _, _, reads, summary = make(out, lc.genome_len, lc.num_sites, lc.reads,
                                lc.read_len, lc.kmer_size, lc.seed,
                                load=False)
    write_fastq(out / "reads_parity.fq", reads[:lc.parity_reads])
    write_fastq(out / "reads_packed.fq", reads[:lc.packed_reads])
    print(json.dumps({"summary": summary,
                      "made_s": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    if torch_cli(genotype_args(out / "gram", out / "par_host",
                               out / "reads_parity.fq", "host")) != 0:
        raise RuntimeError("genotype --engine host failed")
    return {"host_s": time.perf_counter() - t0}


class LargeBuild:
    """Phase 6's workload, built by ``--build-large`` in a process of its
    own (the card hidden from it, two threads for its libraries) while
    phases 0-5b run, so that the host's build of a 25M-row index overlaps
    them; its host-engine oracle run overlaps phase 6a's first run.
    Phase 7's two graphs are built the same way by ``--build-mixed``
    (``name`` "mixed")."""

    def __init__(self, work: Path, name: str = "large"):
        self.out = work / name
        self.out.mkdir()
        self.what = {"large": "phase 6", "mixed": "phase 7"}[name]
        self.log_path = work / f"{name}_build.log"
        self.log = open(self.log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), f"--build-{name}",
             str(self.out)], stdout=self.log, stderr=subprocess.STDOUT,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                     GRAMTOOLS_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2"))

    def wait_built(self) -> dict:
        """The workload's summary line, once its index is written (the
        host engine's run goes on); raises with the log's end if the
        process failed first."""
        waited = time.perf_counter()
        while True:
            for line in self.log_path.read_text().splitlines():
                if line.startswith('{"summary"'):
                    got = json.loads(line)
                    got["wait_s"] = time.perf_counter() - waited
                    got["wall_s"] = time.perf_counter() - self.t0
                    return got
            if self.proc.poll() is not None:
                self.wait()
                raise RuntimeError(f"{self.what}'s build process ended "
                                   f"without its summary line")
            if time.perf_counter() - waited > 900:
                raise TimeoutError(f"{self.what}'s build: no summary in "
                                   f"900 s")
            time.sleep(0.5)

    def wait(self) -> dict:
        """The process's last line (the host engine run's seconds);
        raises with its log's end if it failed."""
        rc = self.proc.wait(timeout=900)
        self.log.close()
        text = self.log_path.read_text()
        if rc != 0:
            raise RuntimeError(f"{self.what}'s build process failed (exit "
                               f"{rc}):\n{text[-3000:]}")
        got = json.loads(text.strip().splitlines()[-1])
        got["wall_s"] = time.perf_counter() - self.t0
        return got

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


class CardChild:
    """``chip_smoke.py MODE PATH`` in a process of its own on the card,
    its output into ``log``: the output-parity runs (phases 4, 5c, 6b,
    7b and 7d's device runs), whose host work (index loads, outputs)
    then overlaps one of phase 6a's or 7a's runs. Their launches are not
    counted here."""

    def __init__(self, what: str, mode: str, path: Path, log: Path,
                 **env):
        self.what, self.log_path = what, log
        self.log = open(log, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), mode, str(path)],
            stdout=self.log, stderr=subprocess.STDOUT,
            env=dict(os.environ, **env))

    def wait(self) -> float:
        """The seconds of its work, from the line it prints last;
        raises with its log's end if it failed."""
        rc = self.proc.wait(timeout=900)
        self.log.close()
        text = self.log_path.read_text()
        if rc != 0:
            raise RuntimeError(f"{self.what} failed (exit {rc}):"
                               f"\n{text[-3000:]}")
        return json.loads(self.lines('{"seconds"')[-1])["seconds"]

    def lines(self, *prefixes: str) -> list:
        """The lines of its log that start with one of ``prefixes``."""
        return [l for l in self.log_path.read_text().splitlines()
                if l.startswith(prefixes)]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


def parity_phases(work: Path) -> int:
    """The body of ``--parity-phases WORK``: phases 4 and 5c on the
    M. tuberculosis-scale workload in ``WORK`` (its gram dir and parity
    reads)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.init()
    phase_parity(work)
    phase_pool(work)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return 0


def genotype_parity(out: Path) -> int:
    """The body of ``--genotype-parity OUT``: the device engine's
    genotype run of phase 6's parity reads, into ``OUT/par_dev``."""
    from gramtools_tpu_torch.cli import run as torch_cli

    os.environ.pop("GRAMTOOLS_TPU_DEVICE_RECORD", None)
    t0 = time.perf_counter()
    rc = torch_cli(genotype_args(out / "gram", out / "par_dev",
                                 out / "reads_parity.fq", "device"))
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return rc


def check_k2_large(args, path_out, timing_runs: int) -> dict:
    """K2 on a warm buffer of phase 6 (``args``, the path's own call, all
    four phases of the wide-only plan in one launch): equal bit for bit
    (carry, flags, every log record) to the path's call and to the plain
    version, over 20 repeated launches; timed by queued events beside
    the plain version (one call), with its bound and share."""
    import torch

    from gramtools_tpu_torch.ops import wide_step

    di, reads, carry, phases, log_base, lp, le, blocks = args

    def run(fn):
        lp2, le2 = torch.full_like(lp, -7), torch.full_like(le, -7)
        out = fn(di, reads, carry, phases, log_base, lp2, le2, blocks)
        return tuple(out) + (lp2, le2)

    want = run(wide_step.wide_steps_torch)
    end = log_base + sum(n * g for n, _, g in phases) * di.n_outcomes
    err = 0
    for i in range(20):
        got = run(wide_step.wide_steps_cuda)
        try:
            err = max(err, _equal(got, want))
        except AssertionError as e:
            raise AssertionError(f"K2 kernel != plain version (launch {i} "
                                 f"of 20): {e}") from None
    try:
        _equal(got[:5] + (got[5][log_base:end], got[6][log_base:end]),
               tuple(path_out) + (lp[log_base:end], le[log_base:end]))
    except AssertionError as e:
        raise AssertionError(f"K2 kernel != the path's own call: {e}") from None
    lp_t, le_t = torch.empty_like(lp), torch.empty_like(le)
    m = {"max_abs_err": err,
         "ms": time_ms(lambda: wide_step.wide_steps_cuda(
             di, reads, carry, phases, log_base, lp_t, le_t, blocks),
             timing_runs),
         "plain_ms": time_each_ms(lambda: wide_step.wide_steps_torch(
             di, reads, carry, phases, log_base, lp_t, le_t, blocks), 1),
         "library_ms": None}
    m["bytes"] = wide_bytes(args, got[6])
    m["bound_ms"] = bound_ms(m["bytes"])
    m["steps"] = sum(e[0] for e in phases)
    m["records"] = end - log_base
    m["flagged"] = int(got[4].sum()) - int(carry[4].sum())
    return m


def phase_large(large: LargeBuild, device, work: Path,
                timing_runs: int) -> dict:
    """Phase 6: the main path on a P. falciparum-scale graph past 2**24
    index rows (LargeConfig), built beside phases 0-5 (LargeBuild): its
    FM index has n >= 2**24 rows and a stub narrow table, so the
    engine's narrow plan runs every step in K2 and K3 never runs.
    (a) ``genotype --engine device`` of its 60,000 reads (three
    20,000-read buffers) with the dense rank (the default), phases 4 and
    5c beside it, and of its first 40,000 (two buffers) with
    ``GRAMTOOLS_TPU_RANK=packed``, (b)'s device run beside it
    (counted_genotype: the Timer report's phases, the host-fallback
    share and its reasons, the launches, K8's key instance; K2 one a
    scan program, the buffers' and the retry passes', each of the plan's
    four phases; K3 none; K6, K7, K8 and K9 each above 0; the standalone
    K1 none); (b) output parity: the device run (dense rank) on the
    first 4,000 reads writes files byte-equal to the port's host
    engine's; (c) between the two runs, with the card to itself, K2 on
    the dense run's warm buffer against its plain version over 20
    repeated launches, timed (check_k2_large), with the dense table and
    with the packed records in its place; (d) the index-sharded scan
    (K10) of the dense run's first buffer over 4 and 3 shards, on a fresh
    dense-rank engine of the run's index (check_index_sharded,
    untraced). Returns what the kernels line takes of it."""
    import torch

    from gramtools_tpu_torch.mapping.engine import LogBatchedEngine

    lc = LargeConfig()
    built = large.wait_built()
    out = large.out
    say(f"[phase 6] P. falciparum-scale workload, built in a process of "
        f"its own beside phases 0-5b ({built['wall_s']:.1f} s from its "
        f"start; waited {built['wait_s']:.1f} s for it here): "
        f"{built['summary']}; written in {built['made_s']:.1f} s")
    runs, k2, seconds = {}, {}, {}
    beside = [CardChild("phases 4 and 5c", "--parity-phases", work,
                        work / "parity_phases.log",
                        GRAMTOOLS_TPU_RANK="packed")]
    try:
        for rank, reads, n in (("dense", "reads.fq", lc.reads),
                               ("packed", "reads_packed.fq",
                                lc.packed_reads)):
            if rank == "packed":
                beside.append(CardChild(
                    "phase 6b's device run", "--genotype-parity", out,
                    work / "large_parity.log", GRAMTOOLS_TPU_RANK="dense"))
            runs[rank] = r = counted_genotype(
                out / "gram", out / f"e2e_{rank}", out / reads, rank,
                "haploid")
            args, _, path_out = r["kept"]["wide_steps_cuda"]
            di, phases = args[0], args[3]
            run_line("6a", f"the P. falciparum-scale graph, rank {rank}", n,
                     r, f"; FM index n = fm.size = {di.size} (2**24 = "
                     f"{STUB_ROWS}), narrow table "
                     f"{tuple(di.narrow_tab.shape)}; the warm buffer's K2 "
                     f"launch: phases {phases}, "
                     f"{sum(e[0] for e in phases)} steps",
                     need=("wide_step", "replay", "per_base", "select",
                           "unpack"))
            launches = r["launches"]
            if di.size < STUB_ROWS or di.narrow_tab.shape[0] != 1:
                raise AssertionError(f"index n={di.size}, narrow table "
                                     f"{tuple(di.narrow_tab.shape)}: not the "
                                     f"wide-only regime")
            if set(r["plans"]) != {4} or len(r["plans"]) != launches[
                    "wide_step"]:
                raise AssertionError(f"K2 calls of {r['plans']} phases: not "
                                     f"one call of the plan's 4 a scan "
                                     f"program")
            if launches["wide_step"] != r["programs"] or any(
                    launches[k] for k in ("narrow_step", "locked_step",
                                          "packed_rank", "sharded_index")):
                raise AssertionError(
                    f"launches {launches} over {r['programs']} scan "
                    f"programs: K2 one a program, K3 and the standalone K1 "
                    f"none")
            seconds[rank] = beside[-1].wait()    # the card is ours again
            if rank == "packed":
                del r["kept"], r["idx"], r["first_submit"], args, path_out
                continue
            for line in beside[0].lines("[phase 4]", "[phase 5c]"):
                say(line)
            # the packed rank on the same buffer: the same inputs, with the
            # packed records in place of the dense table
            for kind, a in (("dense", args), ("packed", args[:7] + (
                    rank_blocks(r["idx"], device),))):
                k2[kind] = m = check_k2_large(a, path_out, timing_runs)
                say(f"[phase 6c] K2 on the dense-rank run's warm buffer "
                    f"(buffer 1), rank {kind}: {m['steps']} steps in one "
                    f"launch, R={a[1].shape[1]}, {m['records']} log "
                    f"records, {m['flagged']} rows flagged: kernel == plain "
                    f"version == the path's call over 20 launches (carry, "
                    f"flags, every record); queued events {m['ms']:.4f} ms "
                    f"kernel, {m['plain_ms']:.2f} ms plain version (one "
                    f"call); bound {m['bound_ms']:.4f} ms ({m['bytes']} "
                    f"bytes), kernel at {100 * m['bound_ms'] / m['ms']:.2f}%"
                    f" of it")
            del r["kept"], args, path_out, a
    finally:
        for child in beside:
            child.stop()

    # (b) output parity on the parity reads, dense rank
    host_s = large.wait()["host_s"]
    for rel in PARITY_FILES:
        if _read_output(out / "par_dev" / rel) != _read_output(
                out / "par_host" / rel):
            raise AssertionError(f"{rel}: device != host on the large graph")
    say(f"[phase 6b] {len(PARITY_FILES)} output files byte-equal on "
        f"{lc.parity_reads} reads: the port's device engine (dense rank, "
        f"{seconds['packed']:.1f} s run, in a process of its own beside "
        f"the packed run) vs its host engine ({host_s:.1f} s run, in the "
        f"build's process, beside the dense run)")

    # (d) the index-sharded scan of the dense run's first buffer, on a
    # fresh dense-rank engine (its first buffer's plan, as 5b's)
    batch, kmer_index, k = runs["dense"].pop("first_submit")[:3]
    idx = runs["dense"].pop("idx")
    os.environ["GRAMTOOLS_TPU_RANK"] = "dense"
    engine = LogBatchedEngine(idx, k, device=device)
    k10 = check_index_sharded("6d", engine, batch, kmer_index, k, device,
                              work, timing_runs, trace=False)
    del engine
    os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    torch.cuda.synchronize()
    return {"runs": runs, "k2": k2, "k10": k10,
            "parity_phases_s": seconds["dense"]}


def rank_blocks(idx, device):
    """The packed rank's records of ``idx``'s FM index on ``device``."""
    from gramtools_tpu_torch.ops import rank

    return rank.blocks_tensor(rank.build_packed_occ(idx.fm), device)


@dataclass
class MixedConfig:
    """Phase 7's two workloads. The mixed graph: bench.py's ``mixed``
    profile at its sizes (a 4.4 Mb genome with 100,000 sites, 70% SNPs,
    10% direct deletions, 10% insertions, 5% four-allele and 5% nested
    sites; 150 bp reads from 8 haplotypes, k = 10, seed 42). The nested
    MSA graph: ``build --prgs_bed`` of 40 regions of 1-4 kb on a 2 Mb
    reference, 24 rows an MSA (common/workload.make_msa_workload),
    20,000 reads. Both genotyped diploid."""
    genome_len: int = 4_400_000
    num_sites: int = 100_000
    read_len: int = 150
    kmer_size: int = 10
    reads: int = 40_000           # two 20,000-read device buffers
    msa_ref_len: int = 2_000_000
    msa_regions: int = 40
    msa_reads: int = 20_000
    parity_reads: int = 4_000
    seed: int = 42


MIXED_GRAPHS = ("mixed", "msa")


def build_mixed(out: Path) -> dict:
    """The body of ``--build-mixed OUT``: phase 7's two graphs written and
    built into ``OUT/mixed`` and ``OUT/msa`` with their parity reads, a
    line with their summaries once both are built, then the port's host
    engine's diploid genotype run of each graph's parity reads (7b's and
    7d's oracle), all on the host. Returns those runs' seconds."""
    from gramtools_tpu_torch.cli import run as torch_cli
    from gramtools_tpu_torch.common.workload import (make_msa_workload,
                                                     make_workload,
                                                     write_fastq)

    mc = MixedConfig()
    t0 = time.perf_counter()
    summary = {}
    for name in MIXED_GRAPHS:
        (out / name).mkdir()
    _, _, reads, summary["mixed"] = make_workload(
        out / "mixed", mc.genome_len, mc.num_sites, mc.reads, mc.read_len,
        mc.kmer_size, mc.seed, load=False, profile="mixed")
    write_fastq(out / "mixed" / "reads_parity.fq", reads[:mc.parity_reads])
    _, _, reads, summary["msa"] = make_msa_workload(
        out / "msa", mc.msa_ref_len, mc.msa_regions, mc.msa_reads,
        mc.kmer_size, mc.seed, load=False)
    write_fastq(out / "msa" / "reads_parity.fq", reads[:mc.parity_reads])
    print(json.dumps({"summary": summary,
                      "made_s": time.perf_counter() - t0}), flush=True)
    host_s = {}
    for name in MIXED_GRAPHS:
        t0 = time.perf_counter()
        if torch_cli(genotype_args(out / name / "gram", out / name /
                                   "par_host", out / name / "reads_parity.fq",
                                   "host", "diploid")) != 0:
            raise RuntimeError(f"genotype --engine host failed ({name})")
        host_s[name] = time.perf_counter() - t0
    return {"host_s": host_s}


def mixed_parity(out: Path) -> int:
    """The body of ``--mixed-parity OUT``: the device engine's diploid
    genotype run of each of phase 7's graphs' parity reads, into
    ``OUT/<graph>/par_dev``."""
    from gramtools_tpu_torch.cli import run as torch_cli

    os.environ.pop("GRAMTOOLS_TPU_DEVICE_RECORD", None)
    t0 = time.perf_counter()
    for name in MIXED_GRAPHS:
        if torch_cli(genotype_args(out / name / "gram", out / name /
                                   "par_dev", out / name / "reads_parity.fq",
                                   "device", "diploid")) != 0:
            raise RuntimeError(f"genotype --engine device failed ({name})")
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)
    return 0


# run reports: what differs between two runs of the same inputs (timings,
# memory, paths) and the device engine's counters, which the host run lacks
REPORT_VOLATILE = {"run_time", "seconds", "peak_mem_mb", "total_runtime",
                   "current_working_directory", "paths", "path_hashes",
                   "engine"}


def _report(path: Path):
    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items()
                    if k not in REPORT_VOLATILE}
        if isinstance(obj, list):
            return [strip(v) for v in obj]
        return obj
    return strip(json.loads(path.read_text()))


def assert_same_outputs(dev: Path, host: Path, what: str) -> int:
    """PARITY_FILES and the genotype report (without timings, paths and
    engine counters) of two runs equal; the number of files compared."""
    for rel in PARITY_FILES:
        if _read_output(dev / rel) != _read_output(host / rel):
            raise AssertionError(f"{rel}: device != host ({what})")
    if _report(dev / "genotype_report.json") != _report(
            host / "genotype_report.json"):
        raise AssertionError(f"genotype_report.json: device != host ({what})")
    return len(PARITY_FILES) + 1


def crossings(gram: Path, run: Path) -> dict:
    """Mapped reads at the graph's kinds of site, from a run's coverage
    files: at sites of 3 or more alleles, each read counted once a site
    (the grouped counts); on direct-deletion alleles (the allele sums)."""
    import numpy as np

    from gramtools_tpu_torch.common.workload import site_table
    from gramtools_tpu_torch.prg.linearise import PrgString

    table = site_table(np.asarray(PrgString.from_file(gram / "prg").ints))
    sums = [[int(c) for c in line.split()] for line in
            (run / "coverage" / "allele_sum_coverage").read_text()
            .splitlines()]
    grouped = json.loads((run / "coverage" /
                          "grouped_allele_counts_coverage.json").read_text())
    counts = grouped["grouped_allele_counts"]["site_counts"]
    multi = np.flatnonzero(table["alleles"] >= 3)
    return {"multi_allelic": sum(sum(counts[s].values()) for s in multi),
            "deletion": sum(sums[s][a] for s, a in table["empty"])}


def counted_genotype(gram: Path, out: Path, reads: Path, rank: str,
                     ploidy: str = "diploid", buffer: int = 1) -> dict:
    """``genotype --engine device --ploidy ploidy`` with ``rank``: the
    kernels' launches (set to 0 just before, read just after), the scan
    programs dispatched (buffers and retry passes) and the wide phases
    of each K2 call, the Timer report's phases, the engine's counters and
    fallback reasons, K8's key instance, the engine's first
    ``scan_submit`` arguments, and the kernels' calls of buffer
    ``buffer`` (1, the second call of each, a warm buffer; 0 for a run
    of one buffer: K2, K3, K7, K8 and K9), kept for the kernel checks
    and stage 4's counts."""
    from gramtools_tpu_torch.cli import run as torch_cli
    from gramtools_tpu_torch.mapping import record, search_log
    from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
    from gramtools_tpu_torch.ops import locked_step, select, wide_step

    os.environ["GRAMTOOLS_TPU_RANK"] = rank
    os.environ.pop("GRAMTOOLS_TPU_DEVICE_RECORD", None)
    for knob in STAGE_KNOBS:
        if knob in os.environ:
            raise AssertionError(f"{knob} is set before the main path")
    kept, calls, engines, bits, plans, programs = {}, {}, [], [], [], [0]
    patched = [(wide_step, "wide_steps_cuda"),
               (locked_step, "locked_tail_cuda"), (record, "replay"),
               (search_log, "select_and_record_device"),
               (record, "_record_per_base_device")]
    saved = [getattr(mod, name) for mod, name in patched]
    submit, key_bits = LogBatchedEngine.scan_submit, select.key_bits
    dispatch = LogBatchedEngine._dispatch_record

    def keep(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            out_ = fn(*args, **kwargs)
            if name == "wide_steps_cuda":
                plans.append(len(args[3]))
            if calls[name] == buffer + 1:
                kept[name] = (args, kwargs, out_)
            return out_
        return wrapper

    def keep_engine(self, *args, **kwargs):
        if not engines:
            engines.append((self, args))
        return submit(self, *args, **kwargs)

    def keep_bits(*args):
        bits.append(key_bits(*args))
        return bits[-1]

    def counted_dispatch(self, *args, **kwargs):
        programs[0] += 1
        return dispatch(self, *args, **kwargs)

    for fn in _counted().values():
        fn.launches = 0
    timer_lines = TimerLines()
    logger = logging.getLogger("gramtools_tpu")
    logger.addHandler(timer_lines)
    for (mod, name), fn in zip(patched, saved):
        setattr(mod, name, keep(name, fn))
    LogBatchedEngine.scan_submit, select.key_bits = keep_engine, keep_bits
    LogBatchedEngine._dispatch_record = counted_dispatch
    t0 = time.perf_counter()
    try:
        if torch_cli(genotype_args(gram, out, reads, "device",
                                   ploidy)) != 0:
            raise RuntimeError(f"genotype ({rank} rank) failed")
    finally:
        logger.removeHandler(timer_lines)
        for (mod, name), fn in zip(patched, saved):
            setattr(mod, name, fn)
        LogBatchedEngine.scan_submit, select.key_bits = submit, key_bits
        LogBatchedEngine._dispatch_record = dispatch
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in _counted().items()}
    eng = json.loads((out / "genotype_report.json").read_text())[
        "processes"]["genotype"]["engine"]
    share = eng["host_fallbacks"] / max(
        eng["device_mapped"] + eng["host_fallbacks"], 1)
    sargs, skw, _ = kept["select_and_record_device"]
    engine, first_submit = engines[0]
    return {"wall_s": wall, "ploidy": ploidy, "phases": timer_lines.phases,
            "engine": eng, "fallback_share": share,
            "fallback_reasons": dict(engine.fallback_reasons),
            "launches": launches, "programs": programs[0], "plans": plans,
            "key_bits": sorted(set(bits)),
            "stage4": stage4_counts(sargs, skw["trip_cap"]), "kept": kept,
            "idx": engine.idx, "first_submit": first_submit}


PATH_KERNELS = ("wide_step", "narrow_step", "locked_step", "replay",
                "select", "per_base")
"""The kernels of the narrow plan's path, each launched by every run of
an index below 2**24 rows."""


def run_line(tag: str, what: str, reads: int, r: dict, extra: str = "",
             buffer: int = 1, need=PATH_KERNELS):
    """Prints a counted_genotype run; fails unless each kernel of
    ``need`` launched and a row was mapped on the device."""
    import gramtools_tpu_torch.ops.select as select

    wide = any(select.wide_keys(b) for b in r["key_bits"])
    st = r["stage4"]
    say(f"[phase {tag}] genotype --engine device --ploidy {r['ploidy']}, "
        f"{what}, {reads} reads: {r['wall_s']:.1f} s wall, quasimap "
        f"{r['phases']['Quasimap']:.2f} s = "
        f"{reads / r['phases']['Quasimap']:.0f} reads/s; phases (the run's "
        f"timer report) {json.dumps(r['phases'])}; device_mapped "
        f"{r['engine']['device_mapped']}, host_fallbacks "
        f"{r['engine']['host_fallbacks']} ({100 * r['fallback_share']:.2f}%;"
        f" by reason {r['fallback_reasons']}), device_retried "
        f"{r['engine']['device_retried']}; {r['programs']} scan programs "
        f"(buffers and retry passes); K8 key bits {r['key_bits']} "
        f"({'128' if wide else '64'}-bit instance); buffer {buffer}'s "
        f"stage 4: "
        f"at most {st['max_states']} live states a row, {st['rows_warp']} "
        f"rows on the warp path (> {K8_SMALL_ROW} states), {st['rows_more']}"
        f" rows with more than one; launches {r['launches']}{extra}")
    for name in need:
        if r["launches"][name] <= 0:
            raise AssertionError(f"phase {tag} launched no {name} kernel")
    if r["engine"]["device_mapped"] <= 0:
        raise AssertionError(f"phase {tag}: no row was mapped on the device")


def repeated(name: str, fn, want, runs: int = 20) -> int:
    """``fn()`` ``runs`` times, each equal to ``want``; the largest
    difference (0)."""
    err = 0
    for i in range(runs):
        try:
            err = max(err, _equal(fn(), want))
        except AssertionError as e:
            raise AssertionError(f"{name} kernel != plain version (launch "
                                 f"{i} of {runs}): {e}") from None
    return err


def check_mixed_kernels(kept: dict, blocks, timing_runs: int) -> dict:
    """Phase 7c: on buffer 1 of the mixed graph's dense-rank run, each
    kernel of the path against its plain version, bit for bit: K2 (every
    wide phase, one launch) and K3 (the hole-allocated and the locked
    range, one launch) under the dense rank and, with the packed records
    ``blocks`` in place of the dense table, the packed rank; K8 (its two
    launches, K9 between them); each over 20 repeated launches; K7 and
    K9 once. Each timed by queued events, with its bound. Returns
    {kernel: numbers}."""
    import torch

    from gramtools_tpu_torch.mapping import record
    from gramtools_tpu_torch.ops import locked_step, replay, wide_step

    out = {}
    wargs, _, wout = kept["wide_steps_cuda"]
    assert wargs[7] is None, "phase 7c's buffer is not the dense run's"
    for kind, a in (("dense", wargs), ("packed", wargs[:7] + (blocks,))):
        m = check_k2_large(a, wout, timing_runs)
        out[f"wide_step_{kind}"] = m
    largs = kept["locked_tail_cuda"][0]
    reads, carry, lp, le, lock, narrow = (largs[i] for i in (1, 2, 4, 5, 9,
                                                          10))
    assert narrow is not None and lock, "the path's tail has no narrow range"

    def tail(fn, a):
        lp2, le2 = torch.full_like(lp, -7), torch.full_like(le, -7)
        return tuple(fn(*a[:4], lp2, le2, *a[6:])) + (lp2, le2)

    for kind, a in (("dense", largs), ("packed", largs[:8] + (blocks,)
                                       + largs[9:])):
        want = tail(locked_step.locked_tail_torch, a)
        err = repeated(f"K3 ({kind} rank)",
                       lambda: tail(locked_step.locked_tail_cuda, a), want)
        lp_t, le_t = torch.empty_like(lp), torch.empty_like(le)
        ms = time_ms(lambda: locked_step.locked_tail_cuda(
            *a[:4], lp_t, le_t, *a[6:]), timing_runs)
        nbytes = tail_bytes(a, want[6])
        out[f"narrow_locked_{kind}"] = {
            "max_abs_err": err, "ms": ms, "bound_ms": bound_ms(nbytes),
            "bytes": nbytes, "steps": reads.shape[0],
            "flagged": int(want[4].sum()) - int(carry[4].sum())}
    rargs = kept["replay"][0]
    rargs = rargs[:8]
    want = replay.replay_torch(*rargs)
    err = _equal(replay.replay_cuda(*rargs), want)
    out["replay"] = {"max_abs_err": err,
                     "ms": time_ms(lambda: replay.replay_cuda(*rargs),
                                   timing_runs),
                     "bound_ms": bound_ms(replay_bytes(*rargs)),
                     # log records whose parent is a record: chains of
                     # two events or more
                     "chained_records": int((rargs[2] >= 0).sum())}
    sargs, skw, _ = kept["select_and_record_device"]
    trip_cap = skw["trip_cap"]

    def sel(plain):
        b = list(sargs[:13]) + [torch.zeros_like(sargs[13])]
        got = (record.select_torch(*b, trip_cap, 99) if plain else
               record.select_and_record_device(*b, trip_cap=trip_cap,
                                               stage=99))
        return tuple(got) + (b[13],)

    err = repeated("K8", lambda: sel(False), sel(True))
    pargs = kept["_record_per_base_device"][0]
    out["select"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: sel(False), timing_runs),
        "bound_ms": bound_ms(select_bytes(sargs, pargs))}

    def walk(fn):
        b = list(pargs)
        b[9], b[10] = pargs[9].clone(), torch.zeros_like(pargs[10])
        return (fn(*b), b[10])

    err = _equal(walk(record._record_per_base_device),
                 walk(record._record_per_base_torch))
    out["per_base"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: walk(record._record_per_base_device),
                      timing_runs),
        "bound_ms": bound_ms(per_base_bytes(pargs)[0]),
        "states_allele_2": int((pargs[5][..., 1] >= 2).sum())}
    return out


def phase_mixed(mixed: LargeBuild, timing_runs: int, device) -> dict:
    """Phase 7: the main path, diploid, on the graphs gramtools is for
    (MixedConfig), built beside phases 0-6 (``--build-mixed``). (a)
    ``genotype --engine device --ploidy diploid`` of the mixed graph's
    40,000 reads with the dense rank and with the packed rank (counted_
    genotype: launches, phases, fallbacks, K8's key instance, stage 4's
    live states), and the reads mapped at its four-allele sites and on
    its direct deletions; (b) its parity reads' device run (in a process
    of its own beside (a), ``--mixed-parity``) byte-equal to the host
    engine's; (d) the nested MSA graph's 20,000 reads, likewise, and its
    parity; (c) with the card to itself, K2, K3, K7, K8 and K9 on the
    dense run's buffer 1 against their plain versions
    (check_mixed_kernels). Returns what the kernels line takes of it."""
    import torch

    mc = MixedConfig()
    built = mixed.wait_built()
    out = mixed.out
    say(f"[phase 7] the mixed graph and the nested MSA graph, built in a "
        f"process of their own beside phases 0-6 ({built['wall_s']:.1f} s "
        f"from its start; waited {built['wait_s']:.1f} s for it here; "
        f"written in {built['made_s']:.1f} s): mixed: "
        f"{built['summary']['mixed']}; msa: {built['summary']['msa']}")
    parity = CardChild("phase 7b and 7d's device runs", "--mixed-parity",
                       out, out / "mixed_parity.log",
                       GRAMTOOLS_TPU_RANK="dense")
    runs = {}
    try:
        for rank in ("dense", "packed"):
            r = counted_genotype(out / "mixed" / "gram",
                                 out / "mixed" / f"e2e_{rank}",
                                 out / "mixed" / "reads.fq", rank)
            r["crossings"] = crossings(out / "mixed" / "gram",
                                       out / "mixed" / f"e2e_{rank}")
            run_line("7a", f"the mixed graph, rank {rank}", mc.reads, r,
                     f"; mapped reads at sites of 3 or more alleles "
                     f"{r['crossings']['multi_allelic']} (a read once a "
                     f"site), on direct-deletion alleles "
                     f"{r['crossings']['deletion']}")
            if min(r["crossings"].values()) <= 0:
                raise AssertionError(f"no mapped read crosses a kind of site:"
                                     f" {r['crossings']}")
            runs[rank] = r
            del r["first_submit"]
            if rank == "packed":
                del r["kept"], r["idx"]
        runs["msa"] = r = counted_genotype(out / "msa" / "gram",
                                           out / "msa" / "e2e",
                                           out / "msa" / "reads.fq", "dense",
                                           buffer=0)
        del r["kept"], r["idx"], r["first_submit"]
        run_line("7d", "the nested MSA graph, rank dense", mc.msa_reads, r,
                 buffer=0)
        dev_s = parity.wait()
    finally:
        parity.stop()
    host_s = mixed.wait()["host_s"]
    for tag, name in (("7b", "mixed"), ("7d", "msa")):
        n = assert_same_outputs(out / name / "par_dev", out / name /
                                "par_host", f"the {name} graph")
        say(f"[phase {tag}] {n} output files byte-equal on "
            f"{mc.parity_reads} reads of the {name} graph, diploid: the "
            f"port's device engine (dense rank; both graphs' runs "
            f"{dev_s:.1f} s, in a process of their own beside 7a) vs its "
            f"host engine ({host_s[name]:.1f} s run, in the build's "
            f"process)")
    torch.cuda.synchronize()
    dense = runs["dense"]
    k = check_mixed_kernels(dense.pop("kept"),
                            rank_blocks(dense.pop("idx"), device),
                            timing_runs)
    st = dense["stage4"]
    for name, m in k.items():
        repeats = (" over 20 launches" if name.startswith(
            ("wide", "narrow", "select")) else "")
        rest = {a: b for a, b in m.items()
                if a not in ("ms", "bound_ms", "max_abs_err")}
        say(f"[phase 7c] {name} on the mixed graph's buffer 1 (dense run): "
            f"kernel == plain version{repeats}; queued events "
            f"{m['ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
            f"({100 * m['bound_ms'] / m['ms']:.2f}%); {json.dumps(rest)}")
    if st["max_states"] <= K8_SMALL_ROW:
        say(f"[phase 7c] no row of buffer 1 has more than {K8_SMALL_ROW} "
            f"live states (at most {st['max_states']}): stage 4's warp "
            f"path did not run there")
    return {"runs": runs, "kernels": k}


def add_mixed(entries, mixed: dict):
    """Phase 7 into the kernels line: every kernel's launches in its
    runs, K8's warp-path rows, and the times of phase 7c."""
    runs, k = mixed["runs"], mixed["kernels"]
    prefix = {"wide_step": "wide_step_", "narrow_step": "narrow_locked_",
              "locked_step": "narrow_locked_", "replay": "replay",
              "select": "select", "per_base": "per_base"}
    for entry in entries:
        name = entry["name"]
        entry["launches_mixed"] = {rank: runs[rank]["launches"][name]
                                   for rank in ("dense", "packed")}
        entry["launches_msa"] = runs["msa"]["launches"][name]
        if name == "select":
            entry["warp_rows_mixed"] = {
                rank: runs[rank]["stage4"]["rows_warp"]
                for rank in ("dense", "packed")}
            entry["warp_rows_msa"] = runs["msa"]["stage4"]["rows_warp"]
        if name in prefix:
            entry["mixed"] = {kind: {a: m[a] for a in ("ms", "bound_ms",
                                                        "max_abs_err")}
                              for kind, m in k.items()
                              if kind.startswith(prefix[name])}
            entry["max_abs_err"] = max([entry["max_abs_err"]] + [
                v["max_abs_err"] for v in entry["mixed"].values()])


def add_large(entries, big: dict):
    """Phase 6 into the kernels line: every kernel's launches in its two
    genotype runs, K2's and K10's numbers on the large graph."""
    for entry in entries:
        name = entry["name"]
        entry["launches_large"] = {rank: r["launches"][name]
                                   for rank, r in big["runs"].items()}
        if name == "wide_step":
            entry["large"] = {rank: {k: m[k] for k in (
                "ms", "plain_ms", "bound_ms", "max_abs_err", "steps")}
                for rank, m in big["k2"].items()}
            entry["max_abs_err"] = max(
                [entry["max_abs_err"]]
                + [m["max_abs_err"] for m in big["k2"].values()])
        elif name == "sharded_index":
            k10 = big["k10"]
            entry["large"] = dict(k10["m"], launches=k10["launches"],
                                  three_shards_ms=k10["three_shards_ms"],
                                  replicated_ms=k10["replicated_ms"],
                                  enqueue_ms=k10["enqueue_ms"])


def run(cfg: SmokeConfig, device, scan_only: bool = False,
        turns=()) -> dict:
    import torch

    from gramtools_tpu_torch.ops import (_build, locked_step, rank, replay,
                                         select, walk, wide_step)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        # phases 6's and 7's host-side builds start first: they are the
        # longest chains
        large = None if scan_only or turns else LargeBuild(work)
        mixed = None if scan_only or turns else LargeBuild(work, "mixed")
        try:
            probe = start_probe_build()
            _build.build_all(LIBS)
            for mod in (rank, replay, walk, wide_step, locked_step, select):
                mod._kernel_lib()
            say(f"[phase 0] csrc/{{{','.join(LIBS)}}}.cu built together "
                f"in {_build.build_seconds[LIBS[0]]:.2f} s "
                f"({time.perf_counter() - t0:.2f} s with loading)")
            LAPS[:] = [("start", t0)]
            lap("0")
            os.environ["GRAMTOOLS_TORCH_DEVICE"] = str(device)
            entries = run_main_phases(cfg, device, work, probe, scan_only,
                                      turns)
            if scan_only or turns:
                return entries
            big = phase_large(large, device, work, cfg.timing_runs)
            add_large(entries, big)
            lap("6")
            add_mixed(entries, phase_mixed(mixed, cfg.timing_runs, device))
            lap("7")
            say("[timing] host seconds by phase (phase 6's build ran "
                "beside phases 0-5b, phases 4 and 5c in a process of their "
                "own beside phase 6a's dense run, "
                f"{big['parity_phases_s']:.1f} s): " + ", ".join(
                    f"{name} {t - t_prev:.1f}" for (_, t_prev), (name, t)
                    in zip(LAPS, LAPS[1:])))
        finally:
            for child in (large, mixed):
                if child is not None:
                    child.stop()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "gramtools_tpu"))
    if loaded:
        raise AssertionError(f"the reference or jax was imported: {loaded}")
    torch.cuda.synchronize()
    return {"kernels": entries}


LAPS = []
"""(phase, host clock at its end) of this run, for the timing line."""


def lap(name: str):
    LAPS.append((name, time.perf_counter()))


def run_main_phases(cfg: SmokeConfig, device, work: Path, probe,
                    scan_only: bool, turns):
    """Phases 1-5b on the M. tuberculosis-scale workload (phases 4 and
    5c run beside phase 6a, phase_large). Returns the kernels line's
    entries (with ``scan_only`` or ``turns``, the result of that mode
    instead)."""
    idx, kmer_index, reads = make_workload(cfg, work)
    from gramtools_tpu_torch.mapping.jump_table import build_jump_table

    lap("workload")
    b_outcomes = build_jump_table(idx).max_outcomes
    err, dense, k1_b = phase_kernel(
        cfg, idx, device, b_outcomes,
        warm_hit_budget(cfg, kmer_index, reads))
    lap("1")
    entries, captured = phase_path(cfg, idx, kmer_index, reads, device,
                                   work, dense, k1_b, probe)
    lap("1d")
    if not scan_only:
        entries.append(phase_stages(cfg, captured, work, probe))
        lap("1e")
    if turns:
        return {"kernels": entries,
                "k8_turns": k8_turns(cfg, captured, work, turns)}
    entries += phase_scan_kernels(cfg, captured, work, probe)
    lap("1f")
    del captured
    if scan_only:
        return {"kernels": entries}
    entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"], err)
    del dense
    phase_scan(cfg, idx, kmer_index, reads, device)
    phase_fused_parity(cfg, idx, kmer_index, reads, device)
    lap("2, 2b")
    launches = phase_e2e(cfg, work)
    lap("3")
    mesh_launches = phase_mesh(cfg, idx, kmer_index, work, device)
    lap("5a")
    k10 = phase_index_sharded(cfg, idx, kmer_index, reads, device, work)
    lap("5b")
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
        entry["launches_mesh"] = mesh_launches[entry["name"]]
    k10["launches_mesh"] = mesh_launches["sharded_index"]
    entries.append(k10)
    return entries


def main() -> int:
    import torch

    if not (REPO / "gramtools_tpu_torch").is_dir():
        print(f"chip_smoke: {REPO} is not a gramtools-tpu checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--build-large"] and len(sys.argv) == 3:
        # phase 6's host-side build, in a process the card is hidden from
        print(json.dumps(build_large(Path(sys.argv[2]))), flush=True)
        return 0
    if sys.argv[1:2] == ["--build-mixed"] and len(sys.argv) == 3:
        # phase 7's, likewise
        print(json.dumps(build_mixed(Path(sys.argv[2]))), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    say(smi)
    kind = torch.cuda.get_device_name(0)
    say(f"[phase 0] torch {torch.__version__} (CUDA {torch.version.cuda}) "
        f"on {kind}")
    t0 = time.perf_counter()
    if sys.argv[1:] == ["--scan-only"]:
        result = run(SmokeConfig(), torch.device("cuda"), scan_only=True)
        say(f"[done] phases 0, 1, 1d and 1f (--scan-only) passed in "
            f"{time.perf_counter() - t0:.1f} s; the other phases not run")
        print(json.dumps(result), flush=True)
        return 0
    if sys.argv[1:2] == ["--genotype-parity"] and len(sys.argv) == 3:
        return genotype_parity(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--mixed-parity"] and len(sys.argv) == 3:
        return mixed_parity(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--parity-phases"] and len(sys.argv) == 3:
        return parity_phases(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--trace-k10"] and len(sys.argv) == 3:
        print(json.dumps(trace_k10(Path(sys.argv[2]))), flush=True)
        return 0
    if sys.argv[1:2] == ["--time-k8"] and len(sys.argv) == 4:
        sys.path.remove(str(REPO))
        print(json.dumps(time_k8(Path(sys.argv[2]), sys.argv[3])),
              flush=True)
        return 0
    if sys.argv[1:2] == ["--k8-turns"] and len(sys.argv) >= 3:
        result = run(SmokeConfig(), torch.device("cuda"),
                     turns=[str(Path(a).resolve()) for a in sys.argv[2:]])
        say(f"[done] phases 0, 1, 1d, 1e and K8's turns (--k8-turns) "
            f"passed in {time.perf_counter() - t0:.1f} s; the other phases "
            f"not run")
        print(json.dumps(result), flush=True)
        return 0
    if sys.argv[1:]:
        print(f"usage: {sys.argv[0]} [--scan-only | --k8-turns CHECKOUT "
              f"...]", file=sys.stderr)
        return 2
    result = run(SmokeConfig(), torch.device("cuda"))
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
