"""`build` command: construct the PRG and its index artifacts.

Parity: gramtools/commands/build/build.py + command_setup.py, with the
index build running in-process (no subprocess boundary: the native/TPU
backend is this package).
"""
from __future__ import annotations

import collections
import logging
import shutil
from pathlib import Path

from ..common.seq import load_fasta
from ..common.vcf import parse_vcf, write_vcf_file, MINIMAL_HEADER
from ..index.build import build_all
from ..prg.linearise import PrgString
from ..prg.vcf_to_prg import VcfToPrg, cluster_vcf_records
from . import report
from .paths import BuildPaths

log = logging.getLogger("gramtools_tpu")

MAX_KMER_SIZE = 14  # command_setup.py:97-99


def setup_files(args) -> BuildPaths:
    build_paths = BuildPaths(args.gram_dir, args.force)
    build_paths.setup()
    if args.kmer_size > MAX_KMER_SIZE:
        build_paths.raise_error(
            "--kmer-size must be 14 or less, because indexing currently "
            "produces all kmers of given size.")
    if args.vcf is not None:
        build_paths.ready_ref_and_vcf(args.reference, args.vcf)
    return build_paths


def run(args):
    build_paths = setup_files(args)
    log.info("Start process: build")
    build_report = report.new_report()

    construct_prg(build_report, build_paths, args)
    execute_index_build(build_report, "index_build", build_paths, args)

    command_hash_paths = report.hash_command_paths(dict(build_paths.items()))
    build_report.update(collections.OrderedDict({"kmer_size": args.kmer_size}))
    report.save_report(build_report, build_paths, command_hash_paths)
    log.info("Success! Build process report in %s", build_paths.report)


def construct_prg(build_report, build_paths, args):
    chrom_seqs = load_fasta(args.reference)
    with open(build_paths.coords_file, "w") as fh:
        for name, seq in chrom_seqs.items():
            fh.write(f"{name}\t{len(seq)}\n")

    if args.prg is not None:
        skip_prg_construction(build_report, "copy_existing_PRG_string",
                              build_paths, args)
    elif args.vcf is not None:
        build_from_vcfs(build_report, "build_prg_from_vcfs", build_paths, args)
    else:
        from .from_msas import build_from_msas
        build_from_msas(build_report, "build_prg_from_msas", build_paths, args)


@report.with_report
def skip_prg_construction(build_report, action, build_paths, args):
    shutil.copyfile(args.prg, build_paths.prg)


@report.with_report
def build_from_vcfs(build_report, action, build_paths, args):
    if getattr(args, "no_vcf_clustering", False):
        if len(build_paths.input_vcfs) > 1:
            raise ValueError(
                "If you ask for no clustering, provide a single vcf file")
        shutil.copy(build_paths.input_vcfs[0], build_paths.built_vcf)
    else:
        all_records = []
        for vcf_path in build_paths.input_vcfs:
            _, records = parse_vcf(vcf_path)
            all_records.extend(records)
        clustered = cluster_vcf_records(all_records)
        write_vcf_file(build_paths.built_vcf, MINIMAL_HEADER, clustered)

    converter = VcfToPrg(build_paths.built_vcf, build_paths.ref, mode="normal")
    PrgString(converter.prg_ints()).write(build_paths.prg)


@report.with_report
def execute_index_build(build_report, action, build_paths, args):
    """Backend build phase (libgramtools src/build/build.cpp:8-72):
    cov graph -> ref check -> FM-index + kmer index, with phase timing."""
    from ..common.timers import TimerReport
    from ..prg.check_ref import check_ref_against_graph
    from ..prg.graph import build_cov_graph

    timer = TimerReport()
    prg = PrgString.from_file(build_paths.prg)
    with timer.phase("Coverage graph"):
        graph = build_cov_graph(prg)
    with timer.phase("Reference check"):
        check_ref_against_graph(args.reference, graph)
    with timer.phase("Index build"):
        build_all(prg, args.kmer_size, build_paths.gram_dir, graph)
    timer.report()
    # per-phase wall + peak-RSS into the build report (the reference
    # wraps FM construction in sdsl's memory monitor,
    # make_data_structures.cpp:12-29)
    build_report["index_build_phases"] = timer.as_dict()
