"""One run of one benchmark cell of ``gramtools_tpu_torch``.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up loads the configuration's graph and the program's index (built
into ``gpubench/cache/`` on a cell's first run in a checkout), constructs the
device engine as ``genotype --engine device`` does, writes the run's
reads under ``TMPDIR`` and maps one warm buffer. The window then calls
``quasimap_reads`` on the reads files, one file a call, cycling through
them until ``--seconds`` have passed and finishing the file in flight.
Where the traffic genotypes, the window's coverage is then genotyped as
``genotype`` does it. One file of the window, drawn from the seed, is
mapped again by the plain reference (``gpubench/reference``), and the
calls are held to the sample's haplotype (``check.py``). The reference's
own index is built, where missing, after the window and outside
``setup_s``.

With ``--trace 0`` the result line carries the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, from the engine's
stage timers, its counters, the benchmark's spans and a profiler trace
of a stretch of warm buffers early in the window.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

from . import check, generate, spec
from .graphs import Graph
from .reference.quasimap import per_base_by_position
from .trace import Stretch

BANNED = ("jax", "jaxlib", "flax", "gramtools_tpu", "bench")
# the traced stretch: scan_submit number TRACE_FIRST (0 is the window's
# first buffer) through record_complete number TRACE_LAST
TRACE_FIRST, TRACE_LAST = 1, 3
WARM_READS = 20000


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m gpubench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str):
    print(f"gpubench: {msg}", file=sys.stderr, flush=True)


def program_env(device: str, trace: bool):
    """The program's defaults: no knob of the engine set, timers on in a
    traced run only."""
    for key in [k for k in os.environ if k.startswith("GRAMTOOLS_TPU_")]:
        del os.environ[key]
    os.environ["GRAMTOOLS_TORCH_DEVICE"] = device
    if trace:
        os.environ["GRAMTOOLS_TPU_TIMERS"] = "1"


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def write_reads(cell: spec.Cell, path: np.ndarray, seed: int, tmp: Path):
    t = cell.traffic
    files = []
    for f in range(t["files"]):
        rng = np.random.default_rng([seed, f])
        reads = generate.sample_reads(rng, path, t["reads_per_file"],
                                      t["read_len"], t["revcomp_share"],
                                      t["error_rate"])
        files.append(tmp / f"reads_{f}.fq")
        generate.write_fastq(files[-1], reads)
    rng = np.random.default_rng([seed, t["files"]])
    warm = tmp / "warm.fq"
    generate.write_fastq(warm, generate.sample_reads(
        rng, path, WARM_READS, t["read_len"], t["revcomp_share"],
        t["error_rate"]))
    return files, warm


class Spans:
    """Host-clock spans around the engine's two pipeline calls, and the
    traced stretch."""

    def __init__(self, engine, stretch):
        self.spans = []
        self.count = {"scan_submit": 0, "record_complete": 0}
        self.stretch = stretch
        for name in self.count:
            setattr(engine, name, self._wrap(name, getattr(engine, name)))

    def _wrap(self, name, fn):
        def call(*a, **kw):
            n = self.count[name]
            self.count[name] += 1
            st = self.stretch
            if st is not None and name == "scan_submit" and n == TRACE_FIRST:
                st.start()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.spans.append((name, n, t0, time.perf_counter()))
            if (st is not None and st.prof is not None
                    and name == "record_complete" and n == TRACE_LAST):
                st.stop(self.count["scan_submit"] - TRACE_FIRST, self.spans)
            return out
        return call


def genotype(cell, idx, coverage, reads_file, gram: Path, out: Path) -> dict:
    """The port's genotyping of the window's coverage, in the order of
    ``genotype_command._execute_genotype``; seconds by part."""
    from gramtools_tpu_torch.infer.json_prg import make_json_prg, write_json_prg
    from gramtools_tpu_torch.infer.personalised_ref import (
        get_personalised_ref, write_personalised_ref)
    from gramtools_tpu_torch.infer.runner import LevelGenotyper
    from gramtools_tpu_torch.infer.segment_tracker import SegmentTracker
    from gramtools_tpu_torch.infer.vcf_write import write_vcf
    from gramtools_tpu_torch.mapping.coverage import dump_all
    from gramtools_tpu_torch.mapping.read_stats import ReadStats

    ploidy = {"haploid": 1, "diploid": 2}[cell.traffic["genotype"]]
    out.mkdir()
    t0 = time.perf_counter()
    read_stats = ReadStats()
    read_stats.compute_base_error_rate(str(reads_file))
    read_stats.compute_coverage_depth(coverage, idx)
    read_stats.serialise(out / "read_stats.json")
    t1 = time.perf_counter()
    dump_all(coverage, idx, out / "allele_sum_cov", out / "allele_base_cov.json",
             out / "grouped_allele_counts_cov.json")
    t2 = time.perf_counter()
    sites = LevelGenotyper(idx, coverage, read_stats, ploidy,
                           get_gcp=True).genotyped_records
    t3 = time.perf_counter()
    tracker = SegmentTracker.from_file(gram / "prg_coords.tsv")
    write_json_prg(make_json_prg(idx, sites, tracker, "gpubench",
                                 "made by gramtools genotype"),
                   out / "genotyped.json")
    tracker.reset()
    write_personalised_ref(get_personalised_ref(idx, sites, tracker),
                           "gpubench personalised reference made by gramtools "
                           "genotype", out / "personalised_reference.fasta")
    tracker.reset()
    write_vcf(idx, sites, tracker, "gpubench", out / "genotyped.vcf.gz")
    t4 = time.perf_counter()
    return {"genotype_s": t4 - t0, "infer_s": t3 - t2,
            "outputs_s": (t2 - t1) + (t4 - t3),
            "vcf": out / "genotyped.vcf.gz"}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, workers: int) -> dict:
    """One run; the result line's fields, ``checks`` last."""
    program_env(device, trace)
    import torch

    from gramtools_tpu_torch.index.build import load_all
    from gramtools_tpu_torch.mapping.coverage import Coverage
    from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
    from gramtools_tpu_torch.mapping.quasimap import (DEVICE_BUFFER_SIZE,
                                                      quasimap_reads)
    from .reference import quasimap as ref_quasimap

    cuda = device == "cuda"
    c, t = cell.config, cell.traffic
    k = c["kmer_size"]
    graph = Graph(c, cell.config_path)
    if graph.ensure():
        log(f"built {graph.dir.name}")
    paths, _, spans = graph.paths()
    hap = int(np.random.default_rng([seed, 1 << 20]).integers(len(paths)))
    tmp = Path(tempfile.mkdtemp(prefix="gpubench-"))
    try:
        marks = [("start", t_start), ("graph", time.perf_counter())]
        files, warm = write_reads(cell, paths[hap], seed, tmp)
        marks.append(("reads", time.perf_counter()))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        idx, kmer_index = load_all(graph.gram)
        marks.append(("load_all", time.perf_counter()))
        engine = LogBatchedEngine(idx, k)
        marks.append(("engine", time.perf_counter()))
        quasimap_reads([str(warm)], kmer_index, idx, k, seed=seed,
                       engine=engine, buffer_size=DEVICE_BUFFER_SIZE)
        if cuda:
            torch.cuda.synchronize()
        marks.append(("warm_buffer", time.perf_counter()))
        log("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                                   in zip(marks, marks[1:])))
        idx.graph.coverage[:] = 0
        engine.timers.clear()
        base = {"device_mapped": engine.device_mapped,
                "host_fallbacks": engine.host_fallbacks,
                "device_retried": engine.device_retried}
        stretch = Stretch() if trace else None
        spans_rec = Spans(engine, stretch)
        setup_s = time.perf_counter() - t_start

        calls = []
        t_win = time.perf_counter()
        while True:
            f = files[len(calls) % len(files)]
            before = idx.graph.coverage.astype(np.int32)
            stats, cov = quasimap_reads([str(f)], kmer_index, idx, k,
                                        seed=seed, engine=engine,
                                        buffer_size=DEVICE_BUFFER_SIZE)
            calls.append((f, stats, cov, idx.graph.coverage.astype(np.int32)
                          - before))
            if time.perf_counter() - t_win >= seconds:
                break
        window_s = time.perf_counter() - t_win
        n_reads = len(calls) * t["reads_per_file"]
        log(f"window: {len(calls)} files, {n_reads} reads in {window_s:.3f} s"
            f" (haplotype {hap})")
        counters = {key: getattr(engine, key) - val
                    for key, val in base.items()}
        timers = dict(engine.timers)
        if trace:
            n_buf = max(spans_rec.count["scan_submit"], 1)
            log("engine timers, ms a buffer: " + ", ".join(
                f"{key} {v / n_buf * 1e3:.1f}" for key, v in
                sorted(timers.items(), key=lambda kv: -kv[1])))
            log(f"engine counters over the window: {counters}; fallback "
                f"reasons since construction: {dict(engine.fallback_reasons)}")
        if stretch is not None and stretch.prof is not None:
            stretch.stop(spans_rec.count["scan_submit"] - TRACE_FIRST,
                         spans_rec.spans)

        geno = None
        if t["genotype"]:
            total = Coverage.empty(idx)
            for _, _, cov, _ in calls:
                total.merge(cov)
            log(f"genotyping the coverage of {n_reads} reads")
            geno = genotype(cell, idx, total, files[0], graph.gram,
                            tmp / "genotype")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        banned = banned_modules()
        if banned:
            raise SystemExit(f"gpubench: loaded {', '.join(banned)}")

        # the check: one file of the window, drawn from the seed
        j = int(np.random.default_rng([seed, 1 << 21]).integers(len(calls)))
        f, stats, cov, delta = calls[j]
        g = idx.graph
        added = types.SimpleNamespace(nodes=g.nodes, ra_node=g.ra_node,
                                      ra_offset=g.ra_offset, coverage=delta)
        program = {"stats": stats.as_dict(), "allele_sum": cov.allele_sum,
                   "grouped": cov.grouped_counts,
                   "per_base": per_base_by_position(added, idx.prg)}
        numbers = {}
        if geno is not None:
            numbers["call_errors"] = check.call_errors(
                geno["vcf"], generate.level1_sites(idx.prg), paths[hap],
                spans[hap])
        kind = torch.cuda.get_device_name(0) if cuda else "cpu"
        del engine, kmer_index, calls, cov
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        if graph.ensure_reference():
            log(f"built {graph.ref_index.name} in "
                f"{time.perf_counter() - t_ref:.1f} s, after the window")
            t_ref = time.perf_counter()
        ref = ref_quasimap.map_file(f, graph.prg, graph.ref_index, k, seed,
                                    DEVICE_BUFFER_SIZE, workers)
        log(f"reference: {f.name} in {time.perf_counter() - t_ref:.1f} s")
        numbers = {**check.mapping_numbers(program, ref), **numbers}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    limits = {**check.LIMITS, **c.get("limits", {})}
    correct = all(v <= limits[key] for key, v in numbers.items())
    values = {"quasimap_reads_per_s": n_reads / window_s, "setup_s": setup_s,
              "peak_device_mem_gib": peak / 2 ** 30}
    if geno is not None:
        values["genotype_s"] = geno["genotype_s"]
    result = {"correct": correct, "attempted": n_reads, "failed": 0}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if not trace:
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in values}
    else:
        summary = stretch.summary if stretch is not None else None
        run = {"spans": spans_rec.spans, "timers": timers,
               "counters": counters, "buffers": spans_rec.count["scan_submit"],
               "trace": summary, "genotype": geno}
        result["metrics"] = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(run)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if summary is not None and summary["busy_s"] is not None:
            device_info["busy_s"] = summary["busy_s"]
            device_info["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
    result["device"] = device_info
    result["checks"] = {key: {"value": v, "limit": limits[key]}
                        for key, v in numbers.items()}
    return result


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse(argv)
    import torch

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start, workers=min(os.cpu_count() or 1, 8))
    for key, v in result["checks"].items():
        log(f"check {key} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
