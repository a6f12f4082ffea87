#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gramtools_tpu_torch) on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port's main path, ``gramtools-tpu-torch genotype --engine
device`` with the packed rank (``GRAMTOOLS_TPU_RANK=packed``) and the
fused device recorder (the default), at the repository's
M. tuberculosis-scale workload: a 4.4 Mb genome with 100,000 biallelic
SNP sites, 150 bp reads, k = 10 (the graph and read generators of
bench.py, seeded; gramtools_tpu_torch/common/workload.py). Phases, in
this order, each printing one line or a few:

  0. the card (nvidia-smi name and power limit), the build of the three
     kernels (one nvcc each, all started together);
  1. the packed-rank kernel (K1) against its plain torch twin, on a
     small FM index (every prefix length) and on the 4.4 Mb graph's
     records (524,288 random rows plus edge rows, also against the
     dense occ table), with CUDA-event timings;
  1d. the path's own shapes: three 20,000-read buffers (R = 30,720
     rows) through the fused engine on CUDA, timed per buffer on the
     host clock; the second buffer's ``scan_submit`` runs under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host
     synchronisation allowed) and its genealogy-replay (K7) and
     per-base walk (K9) inputs are kept; the third runs inside
     ``gramtools_tpu_torch.common.timers.device_trace`` (a
     ``torch.profiler`` Chrome trace: device busy time, device event
     count, and the device time split by kernel name). K7 and K9 are
     then held against their plain twins on those inputs, with
     CUDA-event timings;
  2. scan parity on one 4,096-read buffer: the flat result of the scan
     on CUDA with the packed rank, on CUDA with the dense rank and on
     the CPU in plain torch must be equal;
  2b. fused parity on one 4,096-read buffer: the fused program's flat
     result and ``cov_diff`` on CUDA and on the CPU (plain torch, the
     kernels' twins) must be equal;
  3. end to end: build the graph, then genotype 40,000 reads (two
     20,000-read buffers, so submit and complete overlap); the three
     kernels' launch counts are reset just before and read just after,
     and each must be above 0;
  4. output parity: on the first 4,000 reads, the port's device run
     on CUDA, with the fused recorder and with
     ``GRAMTOOLS_TPU_DEVICE_RECORD=0``, and the JAX package's host
     engine must write byte-equal VCF (without ##fileDate), jVCF,
     coverage dumps and personalised reference;
  5a. the mesh on the card: the 40,000 reads through the port's
     ``quasimap_reads`` with a ``MeshLogEngine`` of two shards on the
     one card (``make_mesh(devices=[cuda, cuda])``), rank packed, fused
     recorder; stats, allele-sum, grouped counts and per-base coverage
     must equal a 1-shard run's, and the counts of the 2-shard run
     (reset just before it) must show K1, K7 and K9 launched; per-buffer
     host seconds of ``scan_submit`` and ``record_complete`` and the
     fallback share are printed (this one card cannot show copies
     between cards);
  5b. the SA-range-sharded index: one 4,096-read buffer's scan with the
     whole index split over 4 "idx" shards on the card (dense rank)
     must equal the replicated scan and the engine's flat result; both
     timed in turns;
  5c. ``genotype --engine device --max_threads 2`` on the 4,000 parity
     reads (spawned workers, since CUDA is initialised) must write files
     byte-equal to phase 4's host engine run.

The second-to-last line is a JSON object with one entry per kernel of
the path; the last is ``{"ok": true, "device": {...}}``. Any failed
check raises, and the script exits non-zero; it also exits non-zero,
printing no result, when no CUDA device is available. It imports no
JAX.
"""
from __future__ import annotations

import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

REPO = Path(__file__).resolve().parent
KERNELS = ("packed_rank", "replay", "walk")


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


def time_ms(fn, runs: int) -> float:
    """Median milliseconds of ``fn`` on the card over ``runs`` calls,
    after one warm-up call, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def make_workload(cfg: SmokeConfig, work: Path):
    """Graph, reference, reads and the built index
    (gramtools_tpu_torch.common.workload), plus the parity reads.
    Returns (idx, kmer_index, reads)."""
    import bench
    from gramtools_tpu_torch.common.workload import make_workload as make

    idx, kmer_index, reads, summary = make(
        work, cfg.genome_len, cfg.num_sites, cfg.e2e_reads, cfg.read_len,
        cfg.kmer_size, cfg.seed)
    bench.write_fastq(work / "reads_parity.fq", reads[:cfg.parity_reads])
    say(f"[workload] {summary}")
    return idx, kmer_index, reads


def warm_hit_budget(cfg: SmokeConfig, kmer_index, reads):
    """(G, R): the warm steps' hit budget and the row capacity of the
    first device buffer, as the engine sets them (cfg.hits per 4096
    rows that pass the kmer screen)."""
    import numpy as np

    from gramtools_tpu.mapping.quasimap import (DEVICE_BUFFER_SIZE,
                                                QuasimapStats, ReadBatch)
    from gramtools_tpu_torch.mapping.search_log_host import (
        LogConfig, _filter_buffer_rows, _row_capacity)

    batch = ReadBatch(np.ascontiguousarray(reads[:DEVICE_BUFFER_SIZE]))
    _, rows, _ = _filter_buffer_rows(batch, kmer_index, cfg.kmer_size,
                                     QuasimapStats())
    R = _row_capacity(len(rows))
    return LogConfig.hits * max(1, R // 4096), R


def phase_kernel(cfg: SmokeConfig, idx, device, b_outcomes: int,
                 warm_hits):
    """Phase 1: the CUDA kernel against its plain twin. Returns the
    kernel's entry for the JSON line (without the launch count)."""
    import numpy as np
    import torch

    from gramtools_tpu.index.fm import FMIndex
    from gramtools_tpu.prg.linearise import prg_string_to_ints
    from gramtools_tpu_torch.ops import rank

    def check(blocks_np, size, rows_np, dense=None):
        blocks = rank.blocks_tensor(blocks_np, device)
        rows = torch.from_numpy(rows_np.astype(np.int32)).to(device)
        got = rank.packed_rank(blocks, rows, size)
        plain = rank.packed_occ_rows_torch(blocks, rows, size)
        err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max())
        if not torch.equal(got, plain):
            raise AssertionError(f"kernel != twin (max abs err {err})")
        if dense is not None and not torch.equal(
                got, dense[rows.to(torch.int64).clamp(0, size)]):
            raise AssertionError("kernel != dense occ table")
        kernel_ms = time_ms(lambda: rank.packed_rank(blocks, rows, size),
                            cfg.timing_runs)
        plain_ms = time_ms(
            lambda: rank.packed_occ_rows_torch(blocks, rows, size),
            cfg.timing_runs)
        return err, kernel_ms, plain_ms

    # (a) every prefix length of a small FM index
    rng = np.random.RandomState(cfg.seed)
    small = "".join("".join(rng.choice(list("ACGT"), size=50))
                    + "[" + ",".join("".join(rng.choice(list("ACGT"), size=3))
                                     for _ in range(3)) + "]"
                    for _ in range(20))
    fm = FMIndex.build(prg_string_to_ints(small + "ACGTACGT"))
    dense_small = torch.from_numpy(np.ascontiguousarray(fm.occ.T)).to(device)
    err_a, ms_a, plain_a = check(
        rank.build_packed_occ(fm), fm.size,
        np.arange(-1, fm.size + 8), dense_small)
    say(f"[phase 1a] small FM index (n={fm.size}), every prefix length: "
        f"kernel == twin == dense, {ms_a:.4f} ms kernel, {plain_a:.4f} ms "
        f"twin (median of {cfg.timing_runs})")

    # (b) the 4.4 Mb graph's records, random rows plus the edges
    n = idx.fm.size
    blocks_np = rank.build_packed_occ(idx.fm)
    edges = np.array([-1, 0, 127, 128, 129, n, n + 7])
    rows_b = np.concatenate([rng.randint(0, n + 1, size=cfg.kernel_rows
                                         - edges.size), edges])
    dense = torch.from_numpy(np.ascontiguousarray(idx.fm.occ.T)).to(device)
    err_b, ms_b, plain_b = check(blocks_np, n, rows_b, dense)
    say(f"[phase 1b] graph records (n={n}), M={rows_b.size} rows: kernel == "
        f"twin == dense, {ms_b:.4f} ms kernel, {plain_b:.4f} ms twin "
        f"(median of {cfg.timing_runs})")

    # (c) the warm steps' newborn query count 2*G*B of the first buffer
    G, R = warm_hits
    m_c = 2 * G * b_outcomes
    rows_c = rng.randint(-1, n + 1, size=m_c)
    err_c, ms_c, plain_c = check(blocks_np, n, rows_c)
    say(f"[phase 1c] M=2*G*B={m_c} rows (G={G} at R={R}, B={b_outcomes}): "
        f"kernel == "
        f"twin, {ms_c:.4f} ms kernel, {plain_c:.4f} ms twin "
        f"(median of {cfg.timing_runs})")
    return {"name": "packed_rank", "route": "cuda",
            "source": "gramtools_tpu_torch/csrc/packed_rank.cu",
            "replaces": "gramtools_tpu/ops/rank.py:136",
            "max_abs_err": max(err_a, err_b, err_c),
            "ms": ms_b, "plain_ms": plain_b}


def phase_scan(cfg: SmokeConfig, idx, kmer_index, reads, device):
    """Phase 2: one buffer's flat scan result, three ways."""
    import numpy as np
    import torch

    from gramtools_tpu.mapping.quasimap import QuasimapStats, ReadBatch
    from gramtools_tpu_torch.mapping.device_index import DeviceIndex
    from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
    from gramtools_tpu_torch.mapping.search_log import log_search_packed

    os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    engine = LogBatchedEngine(idx, cfg.kmer_size, device=device)
    batch = ReadBatch(np.ascontiguousarray(reads[:cfg.scan_reads]))
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
        f"packed, {device.type} dense and cpu; {live} live states, {ovf} "
        f"rows overflowed; {packed_s:.3f} s submit+scan packed, "
        f"{dense_s:.3f} s dense, {cpu_s:.3f} s cpu")


def _first_draws(cfg: SmokeConfig, n: int, salt: int):
    """Selection seeds and mt19937 first draws of one buffer."""
    import numpy as np

    from gramtools_tpu.common.rng import RandomInclusiveInt, first_raw_draws

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
    busy_us, kernels = 0.0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "device_time", None)
        if t is None:
            t = getattr(ev, "cuda_time", 0.0)
        busy_us += t
        kernels += 1
        by_name[ev.name][0] += t
        by_name[ev.name][1] += 1
    top = sorted(((name, us / 1000.0, n) for name, (us, n)
                  in by_name.items()), key=lambda e: -e[1])
    if busy_us <= 0:
        return None, None, []
    return busy_us / 1000.0, kernels, top


def phase_path(cfg: SmokeConfig, idx, kmer_index, reads, device,
               work: Path):
    """Phase 1d: the fused engine at the path's shapes; K7 and K9 held
    against their twins on the second buffer's own inputs; the third
    buffer inside device_trace, its device time split by kernel name.
    Returns the kernels' JSON entries (without the launch counts)."""
    import traceback

    import numpy as np
    import torch

    from gramtools_tpu.mapping.coverage import Coverage
    from gramtools_tpu.mapping.quasimap import (DEVICE_BUFFER_SIZE,
                                                QuasimapStats, ReadBatch)
    from gramtools_tpu_torch.mapping import record
    from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
    from gramtools_tpu_torch.ops import replay, walk

    os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    B = DEVICE_BUFFER_SIZE
    engine = LogBatchedEngine(idx, cfg.kmer_size, device=device)
    assert engine.device_record
    stats = QuasimapStats()
    coverage = Coverage.empty(idx)
    starts = [0, B, 0]          # the third buffer repeats the first's reads
    captured = {}

    def keep(name, fn):
        def wrapper(*args, **kwargs):
            captured[name] = (args, kwargs)
            return fn(*args, **kwargs)
        return wrapper

    lines = []
    for b, start in enumerate(starts):
        batch = ReadBatch(np.ascontiguousarray(reads[start:start + B]))
        sel_seeds, firsts = _first_draws(cfg, B, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if b == 1:
            record.replay, record.walk = (keep("replay", replay.replay),
                                          keep("walk", walk.walk))
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
                record.replay, record.walk = replay.replay, walk.walk
            busy_ms = kernels = None
        elif b == 2:
            box = {}
            busy_ms, kernels, top = _profile_device(
                lambda: box.setdefault("token", engine.scan_submit(
                    batch, kmer_index, cfg.kmer_size, stats,
                    first_raws=firsts)), work / "trace")
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
        lines.append(
            f"buffer {b}: scan_submit {submit_s:.3f} s host, then waited "
            f"{wait_s:.3f} s for the result, record_complete {complete_s:.3f}"
            f" s host" + ("" if busy_ms is None else
                          f"; profiled: device busy {busy_ms:.1f} ms over "
                          f"{kernels} device events")
            + (" [sync debug mode 'error': no synchronisation]"
               if b == 1 else ""))
    engine.flush_device_coverage()
    say(f"[phase 1d] fused engine, R={R} rows a buffer, phases "
        f"{sorted({s[1] for s in engine.dispatch_shapes})}: "
        + "; ".join(lines) + f"; device_mapped {engine.device_mapped}, "
        f"host_fallbacks {engine.host_fallbacks}, device_retried "
        f"{engine.device_retried}, fallback_reasons "
        f"{dict(engine.fallback_reasons)}")
    if busy_ms is None:
        say("[phase 1d] trace: the profiler showed no device time")
    else:
        # names read "(anonymous namespace)::packed_rank_kernel(...)"
        ours = {k: sum(ms for name, ms, _ in top if f"::{k}(" in name)
                for k in ("packed_rank_kernel", "replay_kernel",
                          "walk_kernel")}
        say(f"[phase 1d] trace of buffer 2 (device_trace, Chrome trace): "
            f"{busy_ms:.2f} ms device busy over {kernels} device events "
            f"({len(top)} kernel names); "
            f"K1 {ours['packed_rank_kernel']:.3f} ms, K7 "
            f"{ours['replay_kernel']:.3f} ms, K9 {ours['walk_kernel']:.3f} "
            f"ms; top kernels by device time: " + "; ".join(
                f"{name[:60]} {ms:.3f} ms x{n}" for name, ms, n in top[:12]))
        if not all(ours.values()):
            say("[phase 1d] trace: names outside at::native: " + "; ".join(
                f"{name[:80]} {ms:.3f} ms x{n}" for name, ms, n in top
                if "at::native" not in name)[:2000])

    entries = []
    # K7: exact equality of every output
    args, kwargs = captured["replay"]
    got = replay.replay_cuda(*args, **kwargs)
    want = replay.replay_torch(*args, **kwargs)
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"replay kernel != twin (max abs err {err})")
    ms = time_ms(lambda: replay.replay_cuda(*args, **kwargs), cfg.timing_runs)
    plain = time_ms(lambda: replay.replay_torch(*args, **kwargs),
                    cfg.timing_runs)
    N = args[0].shape[0]
    say(f"[phase 1d] K7 replay at N={N} pool states, log of "
        f"{args[2].shape[0]} records: kernel == twin, {ms:.4f} ms kernel, "
        f"{plain:.4f} ms twin (median of {cfg.timing_runs}); "
        f"{int(args[1].sum())} live states, {int(got[4].sum())} bad")
    entries.append({"name": "replay", "route": "cuda",
                    "source": "gramtools_tpu_torch/csrc/replay.cu",
                    "replaces": "gramtools_tpu/mapping/record_jax.py:251",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain})
    # K9: the emission multiset and the spill flag (order is the atomics')
    args, kwargs = captured["walk"]
    got, spill = walk.walk_cuda(*args, **kwargs)
    want, want_spill = walk.walk_torch(*args, **kwargs)

    def rows(e):
        """The emissions in lexicographic row order."""
        perm = torch.arange(e.shape[0], device=e.device)
        for c in (3, 2, 1, 0):
            perm = perm[torch.sort(e[perm, c], stable=True).indices]
        return e[perm].to(torch.int64)

    if bool(spill) != bool(want_spill):
        raise AssertionError("walk kernel spill != twin spill")
    err = 0 if bool(want_spill) else int(
        (rows(got) - rows(want)).abs().max())
    if err:
        raise AssertionError(f"walk kernel != twin (max abs err {err})")
    ms = time_ms(lambda: walk.walk_cuda(*args, **kwargs), cfg.timing_runs)
    plain = time_ms(lambda: walk.walk_torch(*args, **kwargs),
                    cfg.timing_runs)
    n_emit = int((want[:, 0] < walk.BIG).sum())
    valid, emitcap = args[2], args[11]
    say(f"[phase 1d] K9 walk at {valid.shape[0]} lanes ({int(valid.sum())} "
        f"live), emitcap {emitcap}: kernel == twin ({n_emit} emissions, spill {bool(spill)}), "
        f"{ms:.4f} ms kernel, {plain:.4f} ms twin (median of "
        f"{cfg.timing_runs})")
    entries.append({"name": "walk", "route": "cuda",
                    "source": "gramtools_tpu_torch/csrc/walk.cu",
                    "replaces": "gramtools_tpu/mapping/record_jax.py:841",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain})
    return entries


def phase_fused_parity(cfg: SmokeConfig, idx, kmer_index, reads, device):
    """Phase 2b: one 4,096-read buffer's fused program on CUDA and on
    the CPU (plain torch: the kernels' twins)."""
    import numpy as np
    import torch

    from gramtools_tpu.mapping.quasimap import QuasimapStats, ReadBatch
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
        f"non-zero) equal on cuda and cpu; {int(flat_cuda[2 * R:3 * R].sum())}"
        f" rows mapped, {int((fb != 0).sum())} flagged, "
        f"{int((flat_cuda[3 * R:3 * R + trip_cap] < R).sum())} loci triples;"
        f" {cuda_s:.3f} s cuda submit+wait, {cpu_s:.3f} s cpu")


def genotype_args(gram: Path, out: Path, reads: Path, engine: str):
    return ["genotype", "--gram_dir", str(gram), "--genotype_dir", str(out),
            "--reads", str(reads), "--sample_id", "smoke", "--seed", "7",
            "--engine", engine, "--force"]


def _counted():
    """The three kernels' launch-counting wrappers, by name."""
    from gramtools_tpu_torch.ops import rank, replay, walk

    return {"packed_rank": rank.packed_rank, "replay": replay.replay,
            "walk": walk.walk}


def phase_e2e(cfg: SmokeConfig, work: Path):
    """Phase 3: the main path (fused recorder, the default). Returns the
    kernels' launch counts."""
    from gramtools_tpu_torch.cli import run as torch_cli

    os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    os.environ.pop("GRAMTOOLS_TPU_DEVICE_RECORD", None)
    for fn in _counted().values():
        fn.launches = 0
    t0 = time.perf_counter()
    if torch_cli(genotype_args(work / "gram", work / "e2e",
                               work / "reads.fq", "device")) != 0:
        raise RuntimeError("genotype failed")
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in _counted().items()}
    rep = json.loads((work / "e2e" / "genotype_report.json").read_text())
    proc = rep["processes"]["genotype"]
    eng = proc["engine"]
    quasimap_s = proc["phases"]["Quasimap"]["seconds"]
    rows = proc["mapping_stats"]["all_reads_count"]
    fallback_share = eng["host_fallbacks"] / max(
        eng["device_mapped"] + eng["host_fallbacks"], 1)
    say(f"[phase 3] genotype --engine device, {cfg.e2e_reads} reads: "
        f"{wall:.1f} s wall, quasimap {quasimap_s:.2f} s = "
        f"{cfg.e2e_reads / quasimap_s:.0f} reads/s ({rows} oriented rows); "
        f"phases {json.dumps({k: v['seconds'] for k, v in proc['phases'].items()})}; "
        f"device_mapped {eng['device_mapped']}, host_fallbacks "
        f"{eng['host_fallbacks']} ({100 * fallback_share:.2f}%), "
        f"device_retried {eng['device_retried']}; launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path launched no {name} kernel")
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
    """Phase 4: device (CUDA), with each recorder, against the JAX
    package's host engine."""
    from gramtools_tpu.cli import run as tpu_cli
    from gramtools_tpu_torch.cli import run as torch_cli

    dev_s = {}
    for record in ("1", "0"):
        os.environ["GRAMTOOLS_TPU_DEVICE_RECORD"] = record
        t0 = time.perf_counter()
        try:
            if torch_cli(genotype_args(work / "gram", work / f"par_dev{record}",
                                       work / "reads_parity.fq",
                                       "device")) != 0:
                raise RuntimeError("port genotype failed")
        finally:
            os.environ.pop("GRAMTOOLS_TPU_DEVICE_RECORD", None)
        dev_s[record] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if tpu_cli(genotype_args(work / "gram", work / "par_host",
                             work / "reads_parity.fq", "host")) != 0:
        raise RuntimeError("host genotype failed")
    host_s = time.perf_counter() - t0

    for record in dev_s:
        for rel in PARITY_FILES:
            if _read_output(work / f"par_dev{record}" / rel) != _read_output(
                    work / "par_host" / rel):
                raise AssertionError(f"{rel}: device (DEVICE_RECORD="
                                     f"{record}) != host")
    say(f"[phase 4] {len(PARITY_FILES)} output files byte-equal, port device "
        f"(fused recorder: {dev_s['1']:.1f} s run; host recorder, "
        f"GRAMTOOLS_TPU_DEVICE_RECORD=0: {dev_s['0']:.1f} s run) vs host "
        f"engine ({host_s:.1f} s run)")


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

    from gramtools_tpu.mapping.quasimap import DEVICE_BUFFER_SIZE
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the 2-shard run launched no {name} kernel")
    return launches


def phase_index_sharded(cfg: SmokeConfig, idx, kmer_index, reads, device):
    """Phase 5b: one buffer's scan with the whole index split over 4
    SA-range shards on the card (dense rank), against the replicated
    scan's flat result."""
    import numpy as np
    import torch

    from gramtools_tpu.mapping.quasimap import QuasimapStats, ReadBatch
    from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
    from gramtools_tpu_torch.mapping.search_log import log_search_phases
    from gramtools_tpu_torch.parallel.mesh import Mesh
    from gramtools_tpu_torch.parallel.sharded_index import \
        make_index_sharded_log_search

    os.environ["GRAMTOOLS_TPU_RANK"] = "dense"
    try:
        engine = LogBatchedEngine(idx, cfg.kmer_size, device=device)
    finally:
        os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    batch = ReadBatch(np.ascontiguousarray(reads[:cfg.scan_reads]))
    token = engine.scan_submit(batch, kmer_index, cfg.kmer_size,
                               QuasimapStats())
    (pending, phases, R), carry, reads_T = token[2], token[5], token[6]
    engine_flat = pending.get()
    n_idx = 4
    sharded = make_index_sharded_log_search(
        Mesh([device] * n_idx, ("idx",)), engine.di, engine.cfg, R,
        phases=phases)
    replicated = lambda rt, c: log_search_phases(engine.di, rt, c, phases, R)
    flats, secs = {}, {}
    for name, run in (("replicated", replicated), ("sharded", sharded),
                      ("sharded again", sharded),
                      ("replicated again", replicated)):
        args = (torch.from_numpy(reads_T).to(device),
                tuple(torch.from_numpy(a).to(device) for a in carry))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (rid, lo, hi, pref, ovf), (lp, le) = run(*args)
        flats[name] = torch.cat([rid, lo, hi, pref, ovf.to(torch.int32), lp,
                                 le]).cpu().numpy()
        secs[name] = time.perf_counter() - t0
    for name, flat in flats.items():
        if not np.array_equal(flat, engine_flat):
            raise AssertionError(f"{name} scan != the engine's flat result "
                                 f"({int((flat != engine_flat).sum())} words)")
    say(f"[phase 5b] index of {engine.di.size} rows in {n_idx} SA-range "
        f"shards on {device}, dense rank: flat result of {len(token[1])} rows"
        f" (R={R}, {engine_flat.size} int32) equal to the replicated scan's "
        f"and the engine's; scan + fetch, host clock, s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))


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
    launches_before = _counted()["packed_rank"].launches
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
        f"host_fallbacks {eng['host_fallbacks']}, K1 launches "
        f"{_counted()['packed_rank'].launches - launches_before}")


def run(cfg: SmokeConfig, device) -> dict:
    import torch

    from gramtools_tpu_torch.ops import _build, rank, replay, walk

    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    for mod in (rank, replay, walk):
        mod._kernel_lib()
    say(f"[phase 0] kernels {', '.join(KERNELS)} built together in "
        f"{_build.build_seconds[KERNELS[0]]:.2f} s "
        f"({time.perf_counter() - t0:.2f} s with loading)")
    os.environ["GRAMTOOLS_TORCH_DEVICE"] = str(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        idx, kmer_index, reads = make_workload(cfg, work)
        from gramtools_tpu.mapping.jump_table import build_jump_table

        b_outcomes = build_jump_table(idx).max_outcomes
        entries = [phase_kernel(cfg, idx, device, b_outcomes,
                                warm_hit_budget(cfg, kmer_index, reads))]
        entries += phase_path(cfg, idx, kmer_index, reads, device, work)
        phase_scan(cfg, idx, kmer_index, reads, device)
        phase_fused_parity(cfg, idx, kmer_index, reads, device)
        launches = phase_e2e(cfg, work)
        phase_parity(work)
        mesh_launches = phase_mesh(cfg, idx, kmer_index, work, device)
        phase_index_sharded(cfg, idx, kmer_index, reads, device)
        for entry in entries:
            entry["launches"] = launches[entry["name"]]
            entry["launches_mesh"] = mesh_launches[entry["name"]]
        phase_pool(work)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    torch.cuda.synchronize()
    return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (REPO / "gramtools_tpu_torch").is_dir():
        print(f"chip_smoke: {REPO} is not a gramtools-tpu checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    say(smi)
    kind = torch.cuda.get_device_name(0)
    say(f"[phase 0] torch {torch.__version__} (CUDA {torch.version.cuda}) "
        f"on {kind}")
    t0 = time.perf_counter()
    result = run(SmokeConfig(), torch.device("cuda"))
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
