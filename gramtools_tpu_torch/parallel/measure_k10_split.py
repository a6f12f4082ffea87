"""Splits the in-place index-sharded scan of a checkout by kernel and by
the share of its rows that lie on another card.

The in-place design of K10 (the port before the round-split design of
``ops/sharded.py``): the scan of a data shard runs as two launches on
its home card, K2 (``wide_steps``) and K3 (``locked_tail``), which read
every occ and narrow row from its owner shard, a peer card's over
NVLink. Run it on a machine with the cards asked for, against a
checkout that holds that design (the parent commit, unpacked with ``git
archive`` into a git-ignored directory):

    python3 gramtools_tpu_torch/parallel/measure_k10_split.py \\
        --checkout DIR [--reads 20000] [--specs 4x1 2 4] [--repeats 20]

It imports the port from ``DIR`` alone, builds the workload of
``chip_smoke.py`` there (common/workload.py), takes one 20,000-read
buffer's scan inputs from that checkout's engine (dense rank), and for
each spec ("n": shard i on card i; "nx1": n shards on card 0):

  * runs the index-sharded scan once, capturing the arguments of its K2
    and K3 launches, and holds its flat result to the engine's;
  * times K2 alone, K3 alone and the two together by CUDA events on
    card 0 over ``--repeats`` queued calls each;
  * runs each kernel's plain twin on the same arguments with the shard
    gathers counted: the rows each gathers (rows 0 and 1, which the
    pool's empty slots gather, left out) and the share of them whose
    owner shard lies on another card than card 0.

Each line starts with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkout", required=True)
    ap.add_argument("--reads", type=int, default=20_000)
    ap.add_argument("--specs", nargs="*", default=["4x1", "2", "4"])
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.checkout).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("measure_k10_split: no CUDA device", file=sys.stderr)
        return 2
    from gramtools_tpu_torch.common.workload import make_workload
    from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
    from gramtools_tpu_torch.mapping.quasimap import (DEVICE_BUFFER_SIZE,
                                                      QuasimapStats,
                                                      ReadBatch)
    from gramtools_tpu_torch.ops import _build, locked_step, sharded
    from gramtools_tpu_torch.ops import wide_step
    from gramtools_tpu_torch.parallel.mesh import Mesh
    from gramtools_tpu_torch.parallel.sharded_index import \
        make_index_sharded_log_search

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say = lambda msg: print(f"{card[0]} | {msg}", flush=True)
    say(f"{len(card)} cards, torch {torch.__version__}, checkout "
        f"{args.checkout}")
    _build.build_all(("wide_step", "locked_step"))
    home = torch.device("cuda", 0)

    def devices_of(spec):
        if spec.endswith("x1"):
            return [home] * int(spec[:-2])
        return [torch.device("cuda", i) for i in range(int(spec))]

    def sync(devices):
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)

    def events_ms(fn, devices):
        fn()
        sync(devices)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(args.repeats):
            fn()
        end.record()
        sync(devices)
        return start.elapsed_time(end) / args.repeats

    tmp = tempfile.TemporaryDirectory(prefix="k10_split_")
    idx, kmer_index, reads, summary = make_workload(Path(tmp.name),
                                                    n_reads=args.reads)
    say(f"[workload] {summary}")
    os.environ["GRAMTOOLS_TPU_RANK"] = "dense"
    engine = LogBatchedEngine(idx, 10, device=home)
    token = engine.scan_submit(ReadBatch(np.ascontiguousarray(
        reads[:DEVICE_BUFFER_SIZE])), kmer_index, 10, QuasimapStats())
    (pending, phases, R), carry, reads_T = token[2], token[5], token[6]
    want = pending.get()
    inputs = (torch.from_numpy(reads_T).to(home),
              tuple(torch.from_numpy(a).to(home) for a in carry))
    path = (wide_step.wide_steps_cuda, locked_step.locked_tail_cuda)
    for spec in args.specs:
        devices = devices_of(spec)
        run = make_index_sharded_log_search(Mesh(devices, ("idx",)),
                                            engine.di, engine.cfg, R,
                                            phases=phases)
        calls = {}

        def keep(name, fn):
            def wrapper(*a):
                calls[name] = a
                return fn(*a)
            return wrapper
        wide_step.wide_steps_cuda = keep("K2", path[0])
        locked_step.locked_tail_cuda = keep("K3", path[1])
        try:
            (rid, lo, hi, pref, ovf), (lp, le) = run(*inputs)
        finally:
            wide_step.wide_steps_cuda, locked_step.locked_tail_cuda = path
        got = torch.cat([rid, lo, hi, pref, ovf.to(torch.int32), lp,
                         le]).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"{spec}: the flat result differs from the "
                                 f"engine's")
        w, t = calls["K2"], calls["K3"]
        ms = {"K2": events_ms(lambda: path[0](*w), devices),
              "K3": events_ms(lambda: path[1](*t), devices),
              "K2 + K3": events_ms(lambda: (path[0](*w), path[1](*t)),
                                   devices)}
        # the plain twins on the same arguments, their gathers counted
        factory = sharded._sharded_gather
        counts = {}

        def counted(kernel):
            def make(parts, rps, lo_, hi_, home_):
                gather = factory(parts, rps, lo_, hi_, home_)
                devs = [d for _, d in parts]

                def run_(rows):
                    r = rows.clamp(lo_, hi_).reshape(-1)
                    r = r[r > 1]
                    owner = torch.div(r, rps, rounding_mode="floor")
                    remote = torch.zeros_like(owner, dtype=torch.bool)
                    for s, d in enumerate(devs):
                        if d != home:
                            remote |= owner == s
                    c = counts.setdefault(kernel, [0, 0])
                    c[0] += int(r.numel())
                    c[1] += int(remote.sum())
                    return gather(rows)
                return run_
            return make
        try:
            sharded._sharded_gather = counted("K2")
            wide_step.wide_steps_torch(*w[:7], blocks=None, tables=w[8])
            sharded._sharded_gather = counted("K3")
            locked_step.locked_tail_torch(*t[:8], blocks=None, lock=t[9],
                                          narrow=t[10], tables=t[11])
        finally:
            sharded._sharded_gather = factory
        share = {k: f"{c[1]} of {c[0]} rows ({100 * c[1] / max(c[0], 1):.1f}"
                    f"%)" for k, c in counts.items()}
        say(f"[split] {spec} {[d.index for d in devices]}: R={R}, phases "
            f"{phases}, flat result equal to the engine's; by CUDA events on "
            f"cuda:0 ({args.repeats} queued calls each), ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
            + "; rows on another card than cuda:0 (the twins' gathers, rows "
            "0-1 left out): " + ", ".join(f"{k} {v}" for k, v in
                                          share.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
