"""Runs of a cell on the card with the control or a fault planted
(``faults.py``), for the readings that set each check's limit.

    python3 -m gpubench.control --workload <cell> --seconds <s> --fault <name> --seeds <n> [<n> ...]

One JSON line a seed: the fault, the seed and each compared number.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import faults, run, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gpubench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", choices=faults.FAULTS, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        run.log("no CUDA device")
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        with faults.planted(args.fault):
            result = run.run_cell(cell, seed, args.seconds, False, "cuda", t0,
                                  workers=min(os.cpu_count() or 1, 8))
        print(json.dumps({"fault": args.fault, "seed": seed,
                          "correct": result["correct"],
                          "checks": {k: v["value"] for k, v in
                                     result["checks"].items()},
                          "metrics": {k: v["value"] for k, v in
                                      result["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
