"""`genotype` with the torch mapping engine.

Port of gramtools_tpu/commands/genotype_command.py: the same pipeline
(quasimap, coverage dumps, level genotyping, jVCF, personalised
reference, VCF, rebasing map) and report, with the engine choice made
for torch. ``--engine auto`` means the device engine when
``torch.cuda.is_available()``, the host engine otherwise.
``GRAMTOOLS_TPU_MESH_DEVICES=n`` (n > 1) runs the device engine over a
mesh of the first n CUDA devices, and raises where fewer exist. The
mesh is slower than one card for now: one host thread enqueues every
shard's launches (some 30,000 a buffer each), so the host's enqueue
grows with n while each card idles (PERF.md; ROADMAP Queue 1 item 8
tracks one host thread per card or a captured step loop).
``--max_threads N`` records with N worker processes beside any engine
(mapping/quasimap.py: spawned once CUDA is initialised).
"""
from __future__ import annotations

import collections
import logging
import os

from gramtools_tpu.commands import report
from gramtools_tpu.commands.genotype_command import (
    PLOIDY, _check_read_stats, _load_build_report, _make_rebasing_map)
from gramtools_tpu.commands.paths import GenotypePaths
from gramtools_tpu.index.build import load_all
from gramtools_tpu.infer.json_prg import make_json_prg, write_json_prg
from gramtools_tpu.infer.personalised_ref import (get_personalised_ref,
                                                  write_personalised_ref)
from gramtools_tpu.infer.runner import LevelGenotyper
from gramtools_tpu.infer.segment_tracker import SegmentTracker
from gramtools_tpu.infer.vcf_write import write_vcf
from gramtools_tpu.mapping.coverage import dump_all
from gramtools_tpu.mapping.quasimap import DEVICE_BUFFER_SIZE
from gramtools_tpu.mapping.read_stats import ReadStats

from ..mapping.quasimap import quasimap_reads

log = logging.getLogger("gramtools_tpu")


def run(args):
    geno_paths = GenotypePaths(args.genotype_dir, args.force)
    geno_paths.setup(args.gram_dir, args.reads)

    log.info("Start process: genotype")
    geno_report = report.new_report()

    build_report = _load_build_report(geno_paths)
    kmer_size = build_report["kmer_size"]

    _execute_genotype(geno_report, "genotype", geno_paths, args, kmer_size)
    geno_report["ploidy"] = args.ploidy

    _check_read_stats(geno_report, "check_read_stats", geno_paths)
    _make_rebasing_map(geno_paths)

    command_hash_paths = report.hash_command_paths(dict(geno_paths.items()))
    report.save_report(geno_report, geno_paths, command_hash_paths)
    log.info("Success! Genotyping process report in %s", geno_paths.report)


def resolve_engine(choice: str) -> str:
    if choice == "auto":
        import torch

        choice = "device" if torch.cuda.is_available() else "host"
        log.info("Engine auto-selected: %s", choice)
    return choice


@report.with_report
def _execute_genotype(geno_report, action, geno_paths, args, kmer_size):
    """The backend pipeline, with phase timing."""
    from gramtools_tpu.common.timers import TimerReport

    timer = TimerReport()
    read_files = [str(p) for p in geno_paths.reads_files]
    read_stats = ReadStats()
    read_stats.compute_base_error_rate(read_files[0])

    engine = None
    engine_choice = resolve_engine(getattr(args, "engine", "auto"))

    log.info("Loading PRG and kmer index data")
    with timer.phase("Load data"):
        idx, kmer_index = load_all(geno_paths.gram_dir)

    if engine_choice == "device":
        from ..mapping.engine import LogBatchedEngine

        mesh = None
        n_mesh = int(os.environ.get("GRAMTOOLS_TPU_MESH_DEVICES", "0"))
        if n_mesh > 1:
            from ..parallel.mesh import make_mesh

            # the first n_mesh CUDA devices; raises where fewer exist
            mesh = make_mesh(n_mesh)
            log.info("Using the torch mesh mapping engine (%d shards)",
                     n_mesh)
        engine = LogBatchedEngine(idx, kmer_size, mesh=mesh)
        log.info("Using the torch mapping engine on %s",
                 ", ".join(map(str, engine.shard_devices)))

    log.info("Running quasimap")
    # device engines run throughput-mode buffers; the host engine keeps
    # the reference's 5,000-read buffer so the selection-RNG stream is
    # bit-identical to the reference binary's
    buffer_size = DEVICE_BUFFER_SIZE if engine is not None else None
    with timer.phase("Quasimap"):
        stats, coverage = quasimap_reads(read_files, kmer_index, idx, kmer_size,
                                         seed=args.seed, engine=engine,
                                         max_threads=getattr(args, "max_threads", 1),
                                         buffer_size=buffer_size)
        read_stats.compute_coverage_depth(coverage, idx)
    read_stats.serialise(geno_paths.read_stats)
    log.info("Mapping stats: %s", stats.as_dict())
    process_report = collections.OrderedDict(
        [("mapping_stats", stats.as_dict())])
    if engine is not None:
        process_report["engine"] = {
            "device_mapped": engine.device_mapped,
            "host_fallbacks": engine.host_fallbacks,
            "device_retried": engine.device_retried,
        }
        log.info("Engine: %d device-mapped, %d host fallbacks, %d retried",
                 engine.device_mapped, engine.host_fallbacks,
                 engine.device_retried)
    geno_report["processes"][action] = process_report

    with timer.phase("Coverage dumps"):
        dump_all(coverage, idx, geno_paths.allele_sum_cov, geno_paths.pb_cov,
                 geno_paths.gped_cov)

    log.info("Running genotyping model")
    ploidy = PLOIDY[args.ploidy]
    debug_fpath = str(geno_paths.debug_info) if args.debug else None
    with timer.phase("Genotyping"):
        genotyper = LevelGenotyper(idx, coverage, read_stats, ploidy,
                                   get_gcp=True, debug_fpath=debug_fpath)
        sites = genotyper.genotyped_records

    tracker = SegmentTracker.from_file(geno_paths.gram_dir / "prg_coords.tsv")

    with timer.phase("Outputs"):
        log.info("Producing json vcf")
        prg_json = make_json_prg(idx, sites, tracker, args.sample_id,
                                 "made by gramtools genotype")
        write_json_prg(prg_json, geno_paths.geno_json)

        log.info("Producing personalised reference")
        tracker.reset()
        p_refs = get_personalised_ref(idx, sites, tracker)
        write_personalised_ref(
            p_refs,
            f"{args.sample_id} personalised reference made by gramtools genotype",
            geno_paths.pers_ref)

        log.info("Producing vcf")
        tracker.reset()
        write_vcf(idx, sites, tracker, args.sample_id, geno_paths.geno_vcf)
    timer.report()
    # per-phase seconds in the report: what chip_smoke.py reads the
    # quasimap rate from
    process_report["phases"] = timer.as_dict()
