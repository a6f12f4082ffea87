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
    card i; "nx1": n shards on the first card), the scan run on the first
    card, its K2 and K3 reading the other cards' shards over NVLink; its
    flat result must equal the replicated scan's; each scan timed by
    CUDA events on the first card over ``--repeats`` queued scans, beside
    the replicated dense scan's, and on the host clock.

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
           "select")

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


def index_runs(specs, idx, kmer_index, reads, k: int, repeats: int, say):
    """The index-sharded scan of one buffer for each spec, against the
    replicated scan (see the module doc)."""
    from ..mapping.engine import LogBatchedEngine
    from ..mapping.quasimap import (DEVICE_BUFFER_SIZE, QuasimapStats,
                                    ReadBatch)
    from ..mapping.search_log import log_search_phases
    from ..ops import locked_step, wide_step
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
        launches = (wide_step.wide_steps.sharded_launches
                    + locked_step.locked_tail.sharded_launches)
        (rid, lo, hi, pref, ovf), (lp, le) = run(*args)
        got = torch.cat([rid, lo, hi, pref, ovf.to(torch.int32), lp,
                         le]).cpu().numpy()
        launches = (wide_step.wide_steps.sharded_launches
                    + locked_step.locked_tail.sharded_launches) - launches
        if not np.array_equal(got, want):
            raise AssertionError(f"index {name}: the flat result differs "
                                 f"from the engine's")
        _sync(devices)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        start.record()
        for _ in range(repeats):
            run(*args)
        end.record()
        _sync(devices)
        host_s = (time.perf_counter() - t0) / repeats
        say(f"[index] {name} {[d.index for d in devices]}: R={R}, phases "
            f"{phases}, flat result equal to the engine's; K10 launches a "
            f"scan {launches}; {start.elapsed_time(end) / repeats:.4f} ms a "
            f"scan by CUDA events on cuda:0 ({repeats} queued scans), "
            f"{1000 * host_s:.3f} ms a scan on the host clock")


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
