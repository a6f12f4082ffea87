"""`genotype` with the torch mapping engine.

Port of gramtools_tpu/commands/genotype_command.py: the same pipeline
(quasimap, coverage dumps, level genotyping, jVCF, personalised
reference, VCF, rebasing map) and report, with the engine choice made
for torch. ``--engine auto`` means the device engine when
``torch.cuda.is_available()``, the host engine otherwise.
``GRAMTOOLS_TPU_MESH_DEVICES=n`` (n > 1) runs the device engine over a
mesh of the first n CUDA devices, and raises where fewer exist. The
mesh is slower than one card for now: one host thread enqueues every
shard's launches (about 70 a 20,000-read buffer each), so the host's enqueue
grows with n while each card idles (PERF.md; ROADMAP Queue 1 item 8
tracks one host thread per card or a captured step loop).
``--max_threads N`` records with N worker processes beside any engine
(mapping/quasimap.py: spawned once CUDA is initialised).
"""
from __future__ import annotations

import collections
import json
import logging
import os

from ..common.seq import load_fasta
from ..common.timers import TimerReport
from ..common.vcf import parse_vcf
from ..index.build import load_all
from ..infer.json_prg import make_json_prg, write_json_prg
from ..infer.personalised_ref import (get_personalised_ref,
                                      write_personalised_ref)
from ..infer.runner import LevelGenotyper
from ..infer.segment_tracker import SegmentTracker
from ..infer.vcf_write import write_vcf
from ..mapping.coverage import dump_all
from ..mapping.quasimap import DEVICE_BUFFER_SIZE, quasimap_reads
from ..mapping.read_stats import ReadStats
from . import report
from .paths import GenotypePaths
from .seq_region_map import SearchableSeqRegionsMap, SeqRegionMapper

log = logging.getLogger("gramtools_tpu")

PLOIDY = {"haploid": 1, "diploid": 2}


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


def _load_build_report(geno_paths):
    build_path = geno_paths.gram_dir / "build_report.json"
    if not build_path.exists():
        raise SystemExit(
            f"Build report not found: {build_path}. Try re-running build?")
    with open(build_path) as fh:
        build_report = json.load(fh)
    if not build_report["success"]:
        raise SystemExit(f"Build was not completed successfully: see {build_path}")
    return build_report


def resolve_engine(choice: str) -> str:
    if choice == "auto":
        import torch

        choice = "device" if torch.cuda.is_available() else "host"
        log.info("Engine auto-selected: %s", choice)
    return choice


@report.with_report
def _execute_genotype(geno_report, action, geno_paths, args, kmer_size):
    """The backend pipeline (genotype.cpp:24-122), with phase timing
    (TimerReport parity: genotype.cpp:26-121)."""
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


@report.with_report
def _check_read_stats(geno_report, action, geno_paths):
    with open(geno_paths.read_stats) as f:
        read_stats = json.load(f)
    no_cov = read_stats["Read_depth"]["num_sites_noCov"]
    total = read_stats["Read_depth"]["num_sites_total"]
    if total and no_cov / total > 0.5:
        log.warning(
            "More than 50%% of all variant sites have no coverage (%s out of %s)."
            " Possible reasons include: reads not quality-trimmed; low "
            "sequencing depth.", no_cov, total)


def _make_rebasing_map(geno_paths):
    """genotype.py:131-145. For diploid runs the personalised-reference
    records are ploidy-qualified ("chrom_1", "chrom_2"); sizes are mapped
    back to the base chrom names (first haplotype's length)."""
    chrom_sizes = {}
    for name, seq in load_fasta(geno_paths.pers_ref).items():
        chrom_sizes.setdefault(name, len(seq))
    _, base_records = parse_vcf(geno_paths.geno_vcf)
    record_chroms = {r.chrom for r in base_records}
    if record_chroms - set(chrom_sizes):
        stripped = {}
        for name, size in chrom_sizes.items():
            base = name.rsplit("_", 1)[0] if "_" in name else name
            stripped.setdefault(base, size)
        chrom_sizes = stripped
    region_map = SeqRegionMapper(base_records, chrom_sizes).get_map()
    SearchableSeqRegionsMap(region_map).dump_to(
        geno_paths.rebasing_map, dump_sequences=False)
