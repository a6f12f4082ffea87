"""Times the port's mapping over a mesh of CUDA devices, in turns.

Run from the root of a checkout, on a machine with the cards asked for:

    python3 -m gramtools_tpu_torch.parallel.measure_mesh \\
        [--reads 80000] [--runs 1 2 4 4x1 1] [--checkout DIR ...] \\
        [--rounds 2] [--repeats 4] [--index 1 2 4 4x1]

It builds the workload of ``chip_smoke.py`` (common/workload.py: 4.4 Mb
genome, 100,000 SNP sites, 150 bp reads, k = 10, seed 42), then:

  * with ``--checkout``, maps those reads with each given checkout's
    single-device engine (rank packed, the fused recorder) through its
    own ``quasimap_reads``, in a process of its own, ``--repeats``
    times (the first dropped), for ``--rounds`` rounds, every other
    round in reverse order: the one-device path of two trees compared
    on one card (give the parent's checkout and ".");
  * for each of ``--runs``, in the order given, maps the reads with this
    checkout's ``quasimap_reads`` and a ``MeshLogEngine`` ("n": the
    first n cards; "nx1": n shards on the first card) in 20,000-read
    buffers, and prints the quasimap seconds and rate and the host
    seconds of each buffer's ``scan_submit`` and ``record_complete``.
    Every run's stats, allele-sum, grouped counts and per-base coverage
    must equal the first run's;
  * with ``--index``, the SA-range-sharded index's scan (K10) of one
    whole 20,000-read buffer (the engine's own phases, dense rank): for
    each spec, the index split into that many shards ("n": shard i on
    card i; "nx1": n shards on the first card), every card of the row
    running the scan in gather rounds on its own shards, an NCCL
    all-reduce between two launches; its flat result must equal the
    replicated scan's; its launches and collectives a scan; each scan
    timed by CUDA events on the first card, the median of 5 x
    ``--repeats`` scans each run alone (the cards synchronised before
    and after), beside the replicated dense scan's, and the host's
    enqueue of one scan (the host clock from its call to its return, no
    synchronisation), the median of as many; and, on more than one
    card, the bytes its all-reduces must move over each card's NVLink
    (2 (n - 1) / n of the bytes reduced, as a ring moves them) and
    their time at 450 GB/s, the bound a scan adds to the device's.

Each line starts with the card's name and power limit. Raises on any
failed check.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

KERNELS = ("packed_rank", "replay", "walk", "wide_step", "locked_step",
           "select", "sharded_step")

# Run in each checkout (one whose port carries its own index loader and
# quasimap driver): its single-device engine through its quasimap_reads,
# a fresh engine per repeat; prints the seconds of each repeat as JSON.
ONE_DEVICE = """
import json, sys, time
import torch
from gramtools_tpu_torch.index.build import load_all
from gramtools_tpu_torch.mapping.quasimap import (DEVICE_BUFFER_SIZE,
                                                  quasimap_reads)
from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
gram, reads, k, repeats = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
    int(sys.argv[4])
idx, kidx = load_all(gram)
secs = []
for _ in range(repeats):
    idx.graph.coverage[:] = 0
    engine = LogBatchedEngine(idx, k)
    t0 = time.perf_counter()
    quasimap_reads([reads], kidx, idx, k, seed=42, engine=engine,
                   buffer_size=DEVICE_BUFFER_SIZE)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
print(json.dumps(secs))
"""


def _timed(times: list, fn):
    """fn, with the host seconds of each call appended to times."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            times.append(time.perf_counter() - t0)
    return wrapper


def mesh_devices(spec: str, kind: str = "cuda") -> list:
    """"n": cuda:0..n-1; "nx1": cuda:0 listed n times."""
    if spec.endswith("x1"):
        return [torch.device(kind, 0)] * int(spec[:-2])
    return [torch.device(kind, i) for i in range(int(spec))]


def _sync(devices):
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def one_device_turns(checkouts, work: Path, k: int, rounds: int,
                     repeats: int, say, device: str = "cuda"):
    """Each checkout's single-device engine on work/reads.fq, in a
    process of its own, ``rounds`` times, every other round in reverse
    order (A B, B A, ...); each process maps the reads ``repeats`` times
    and its first repeat (kernel build, first shapes) is dropped.
    Returns {checkout: [quasimap seconds, ...]}."""
    env = dict(os.environ, GRAMTOOLS_TPU_RANK="packed",
               GRAMTOOLS_TORCH_DEVICE=device)
    env.pop("GRAMTOOLS_TPU_DEVICE_RECORD", None)
    secs = {c: [] for c in checkouts}
    for r in range(rounds):
        for c in (checkouts if r % 2 == 0 else checkouts[::-1]):
            res = subprocess.run(
                [sys.executable, "-c", ONE_DEVICE, str(work / "gram"),
                 str(work / "reads.fq"), str(k), str(repeats)], cwd=c,
                env=dict(env, PYTHONPATH=str(Path(c).resolve())),
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"the run in {c} failed:\n"
                                   f"{res.stderr[-3000:]}")
            got = json.loads(res.stdout.strip().splitlines()[-1])
            secs[c] += got[1:]
            say(f"[one device] round {r}, checkout {c}: quasimap s "
                f"{[round(t, 3) for t in got]} (the first dropped)")
    return secs


def mesh_runs(specs, idx, kmer_index, k: int, n_reads: int, work: Path,
              say, kind: str = "cuda"):
    """quasimap_reads with a MeshLogEngine for each spec, in turns
    (``kind="cpu"`` runs the same specs on CPU devices)."""
    from ..mapping.quasimap import DEVICE_BUFFER_SIZE

    from ..mapping.quasimap import quasimap_reads
    from .mesh import MeshLogEngine, make_mesh

    os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    os.environ.pop("GRAMTOOLS_TPU_DEVICE_RECORD", None)
    first = None
    for spec in specs:
        devices = mesh_devices(spec, kind)
        idx.graph.coverage[:] = 0
        t0 = time.perf_counter()
        engine = MeshLogEngine(idx, k, mesh=make_mesh(devices=devices))
        tables_s = time.perf_counter() - t0
        submit_s, complete_s = [], []
        engine.scan_submit = _timed(submit_s, engine.scan_submit)
        engine.record_complete = _timed(complete_s, engine.record_complete)
        _sync(devices)
        t0 = time.perf_counter()
        stats, cov = quasimap_reads([str(work / "reads.fq")], kmer_index, idx,
                                    k, seed=42, engine=engine,
                                    buffer_size=DEVICE_BUFFER_SIZE)
        _sync(devices)
        wall = time.perf_counter() - t0
        got = (stats.as_dict(), cov.allele_sum, cov.grouped_counts,
               idx.graph.coverage.copy())
        if first is None:
            first = got
        same = (got[:3] == first[:3]) and np.array_equal(got[3], first[3])
        say(f"[mesh] {spec} {[d.index for d in devices]}: equal to the first "
            f"run {same}; tables {tables_s:.2f} s; quasimap {wall:.3f} s = "
            f"{n_reads / wall:.0f} reads/s; scan_submit "
            f"{[round(t, 3) for t in submit_s]}; record_complete "
            f"{[round(t, 3) for t in complete_s]}; device_mapped "
            f"{engine.device_mapped}, host_fallbacks {engine.host_fallbacks}")
        if not same:
            raise AssertionError(f"mesh {spec}: results differ from the "
                                 f"first run")
        del engine


NVLINK_BYTES_PER_S = 450e9
"""An H100's NVLink, each way (NVIDIA's data sheet: 900 GB/s in all)."""


def _reduced_bytes(phases, R: int, n_in: int, B: int) -> int:
    """The bytes the index-sharded scan's all-reduces sum a scan, from
    its step table (ops/sharded.py): each step's round-1 answers (4
    ints a slot of a wide step; a word a slot and 4 ints a wide state
    of the budget of a narrow one) and round-2 answers (2 ints a hit
    pair)."""
    from ..mapping.search_log_host import _phase4
    from ..ops.sharded import step_table

    rows = step_table([_phase4(e) for e in phases], R, n_in, B, True)[0]
    ints = sum((4 * N if k == 0 else -(-N // 4) * 4 + 4 * W) + 2 * G * B
               for k, N, G, W, *_ in rows)
    return 4 * ints


def index_runs(specs, idx, kmer_index, reads, k: int, repeats: int, say):
    """The index-sharded scan of one buffer for each spec, against the
    replicated scan (see the module doc)."""
    from ..mapping.engine import LogBatchedEngine
    from ..mapping.quasimap import (DEVICE_BUFFER_SIZE, QuasimapStats,
                                    ReadBatch)
    import statistics

    from ..mapping.search_log import log_search_phases
    from ..ops import sharded
    from .mesh import Mesh
    from .sharded_index import make_index_sharded_log_search

    home = torch.device("cuda", 0)
    os.environ["GRAMTOOLS_TPU_RANK"] = "dense"
    try:
        engine = LogBatchedEngine(idx, k, device=home)
    finally:
        os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    token = engine.scan_submit(ReadBatch(np.ascontiguousarray(
        reads[:DEVICE_BUFFER_SIZE])), kmer_index, k, QuasimapStats())
    (pending, phases, R), carry, reads_T = token[2], token[5], token[6]
    want = pending.get()
    args = (torch.from_numpy(reads_T).to(home),
            tuple(torch.from_numpy(a).to(home) for a in carry))
    runs = [("replicated", lambda rt, c: log_search_phases(
        engine.di, rt, c, phases, R), [home])]
    for spec in specs:
        devices = mesh_devices(spec)
        t0 = time.perf_counter()
        run = make_index_sharded_log_search(Mesh(devices, ("idx",)),
                                            engine.di, engine.cfg, R,
                                            phases=phases)
        runs.append((spec, run, devices))
        say(f"[index] {spec}: tables built in {time.perf_counter() - t0:.2f}"
            f" s")
    for name, run, devices in runs:
        before = (sharded.sharded_scan.launches,
                  sharded.sharded_scan.collectives)
        (rid, lo, hi, pref, ovf), (lp, le) = run(*args)
        got = torch.cat([rid, lo, hi, pref, ovf.to(torch.int32), lp,
                         le]).cpu().numpy()
        launches = sharded.sharded_scan.launches - before[0]
        collectives = sharded.sharded_scan.collectives - before[1]
        if not np.array_equal(got, want):
            raise AssertionError(f"index {name}: the flat result differs "
                                 f"from the engine's")
        ms, enqueue = [], []
        for _ in range(repeats):
            _sync(devices)
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            t0 = time.perf_counter()
            run(*args)
            enqueue.append(time.perf_counter() - t0)
            end.record()
            _sync(devices)
            ms.append(start.elapsed_time(end))
        n_cards = len(set(devices))
        reduced = _reduced_bytes(phases, R, carry[0].shape[0],
                                 engine.di.n_outcomes)
        link = (2 * (n_cards - 1) / n_cards * reduced) if n_cards > 1 else 0
        say(f"[index] {name} {[d.index for d in devices]}: R={R}, phases "
            f"{phases}, flat result equal to the engine's; K10 launches a "
            f"scan {launches}, collectives {collectives}; "
            f"{statistics.median(ms):.4f} ms a scan by CUDA events on "
            f"cuda:0 (the median of {repeats}, each run alone; min "
            f"{min(ms):.4f}, max {max(ms):.4f}), the host's enqueue "
            f"{1000 * statistics.median(enqueue):.3f} ms a scan (median); "
            f"NVLink bytes a card {link:.0f} ({reduced} bytes all-reduced "
            f"a scan), {1000 * link / NVLINK_BYTES_PER_S:.4f} ms at 450 GB/s")


def main(argv=None) -> int:
    from ..common.workload import make_workload
    from ..ops import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=80_000)
    ap.add_argument("--runs", nargs="*", default=["1", "2", "4", "4x1", "1"])
    ap.add_argument("--checkout", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--index", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_mesh: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say = lambda msg: print(f"{card[0]} | {msg}", flush=True)
    say(f"{len(card)} cards, torch {torch.__version__}")
    # the kernels are built before any run, so no run's time holds nvcc
    _build.build_all(KERNELS)
    with tempfile.TemporaryDirectory(prefix="measure_mesh_") as tmp:
        work = Path(tmp)
        idx, kmer_index, reads, summary = make_workload(work,
                                                        n_reads=args.reads)
        say(f"[workload] {summary}")
        if args.checkout:
            secs = one_device_turns(args.checkout, work, 10, args.rounds,
                                    args.repeats, say)
            say("[one device] quasimap s by checkout: " + "; ".join(
                f"{c} {[round(t, 3) for t in v]}" for c, v in secs.items()))
        mesh_runs(args.runs, idx, kmer_index, 10, args.reads, work, say)
        if args.index:
            index_runs(args.index, idx, kmer_index, reads, 10,
                       5 * args.repeats, say)
    return 0


if __name__ == "__main__":
    sys.exit(main())
