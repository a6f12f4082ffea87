"""Device time of the fused record program's pieces, stage by stage.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 -m gramtools_tpu_torch.mapping.profile_record_device [R] \\
        [--genome_len 4400000] [--num_sites 100000] [--runs 5] \\
        [--device cpu]

The port of tools/profile_record_device.py. It builds the M.
tuberculosis-scale graph of common/workload.py (4.4 Mb, 100,000 SNP
sites, k = 10, seed 42) and the engine's resident tables, then makes the
JAX tool's synthetic inputs at R rows a buffer (default 40,960): a pool
of N states (the last phase's of ``auto_phases(140, R, ...)``), ~85%
of them live, each with a genealogy chain of depth 1-6 through a
consistent log, ~1% with an SA interval wider than one row
(``RandomState(0)``). It times

  * ``record.replay_device`` (K7) at each replay stage of
    ``PROF_RSTAGES`` (default ``1,2,99``: the chase, + the seed gather,
    + the ops apply);
  * ``record.select_and_record_device`` (K8, csrc/select.cu's kernels
    on CUDA, with K9 inside from stage 6 on) at each select stage of ``PROF_STAGES`` (default
    ``0,1,2,3,4,5,6,99``), on the full replay's outputs,

each as the median of ``--runs`` single calls between two CUDA events,
each queued behind a sleep of the card (``time_ms``), and prints one
JSON line: R, N, the milliseconds by stage, the card's name
and power limit (``nvidia-smi``). A stage's own time is the difference
of two prefixes.
Without a card it exits non-zero; ``--device cpu`` (for tests) runs the
plain versions and times them on the host clock, which is no device
time.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..common.workload import make_workload
from .engine import LogBatchedEngine
from .record import replay_device, select_and_record_device
from .search_log_host import LogConfig, auto_phases


def synthetic_inputs(di, st, R: int):
    """The JAX tool's inputs (numpy): (phases, f_rid, f_pref, log_parent,
    log_event, f_lo, f_hi, alive, the RandomState for the row inputs)."""
    rng = np.random.RandomState(0)
    cfg = LogConfig(hits=2048 * max(1, R // 4096))
    phases = auto_phases(140, R, cfg, n_seed_states=3 * R)
    N = phases[-1][1]
    Lg = sum(e[0] * e[2] for e in phases) * di.n_outcomes
    f_rid = np.where(rng.rand(N) < 0.85, np.arange(N) % R,
                     -1).astype(np.int32)
    depth = rng.randint(1, 7, size=N)
    log_parent = np.full(Lg, -1, np.int32)
    log_event = rng.randint(0, max(di.out_lo.shape[0] * di.n_outcomes, 1),
                            size=Lg).astype(np.int32)
    f_pref = np.empty(N, np.int32)
    cursor = 0
    nst = max(st.n_states, 1)
    for i in range(N):
        prev = -(rng.randint(0, nst) + 1)
        for _ in range(depth[i]):
            if cursor >= Lg:
                break
            log_parent[cursor] = prev
            prev = cursor
            cursor += 1
        f_pref[i] = prev
    sa_pos = rng.randint(0, di.size - 2, size=N).astype(np.int32)
    width = np.where(rng.rand(N) < 0.99, 1, rng.randint(1, 4, size=N))
    f_hi = (sa_pos + width - 1).astype(np.int32)
    return (phases, f_rid, f_pref, log_parent, log_event, sa_pos, f_hi,
            f_rid >= 0, rng)


def time_ms(fn, runs: int, device: torch.device) -> float:
    """Milliseconds of one call of fn, after one warm-up call: the median
    of ``runs`` single calls, each between two CUDA events and queued
    behind a ~50 ms sleep of the card, so that the host's enqueue does
    not show (a selection call is hundreds of launches: several behind
    one sleep would fill the card's queue of pending launches, about a
    thousand, and the host would wait); on the CPU, the host clock."""
    fn()
    times = []
    for _ in range(runs):
        if device.type == "cpu":
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)      # cycles at the H100's ~2 GHz
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _stages(name: str, default: str):
    return [int(s) for s in os.environ.get(name, default).split(",")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("R", type=int, nargs="?", default=40960)
    ap.add_argument("--genome_len", type=int, default=4_400_000)
    ap.add_argument("--num_sites", type=int, default=100_000)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    card = None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("profile_record_device: no CUDA device (pass --device cpu "
                  "for the plain versions)", file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    R = args.R
    with tempfile.TemporaryDirectory(prefix="profile_record_") as tmp:
        # the index may read its files lazily: keep them while it runs
        idx, kmer_index, _, summary = make_workload(
            Path(tmp), args.genome_len, args.num_sites, n_reads=8)
        print(f"# {summary}", file=sys.stderr, flush=True)
        engine = LogBatchedEngine(idx, 10, device=device)
        engine._ensure_record_tables()
        engine._ensure_seed_tables(kmer_index)
        di, rt, st = engine.di, engine.rt, engine.st
        (phases, f_rid, f_pref, lp, le, f_lo, f_hi, alive,
         rng) = synthetic_inputs(di, st, R)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        f_rid, f_pref, lp, le, f_lo, f_hi, alive = map(
            put, (f_rid, f_pref, lp, le, f_lo, f_hi, alive))
        N = f_rid.shape[0]
        print(f"# R={R} N={N} log={lp.shape[0]} phases={phases}",
              file=sys.stderr, flush=True)

        result = {"R": R, "N": N, "device": str(device),
                  "clock": "host" if device.type == "cpu" else "cuda events",
                  "card": card, "runs": args.runs, "replay_ms": {},
                  "select_ms": {}}
        for rs in _stages("PROF_RSTAGES", "1,2,99"):
            result["replay_ms"][str(rs)] = time_ms(
                lambda: replay_device(di, f_pref, lp, le, st, alive,
                                      stage=rs), args.runs, device)

        trav, n_trav, ing, n_ing, bad = replay_device(di, f_pref, lp, le, st,
                                                      alive)
        trip_cap = 4 * R
        row_ok = torch.ones(R, dtype=torch.bool, device=device)
        row_first = put(rng.randint(0, 2 ** 31, size=R).astype(np.int64))
        row_len = torch.full((R,), 150, dtype=torch.int32, device=device)
        for stage in _stages("PROF_STAGES", "0,1,2,3,4,5,6,99"):
            cov = torch.zeros(rt.cov_size + 1, dtype=torch.int32,
                              device=device)
            result["select_ms"][str(stage)] = time_ms(
                lambda: select_and_record_device(
                    di, rt, f_rid, f_lo, f_hi, trav, n_trav, ing, n_ing, bad,
                    row_ok, row_first, row_len, cov, trip_cap=trip_cap,
                    stage=stage), args.runs, device)
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
