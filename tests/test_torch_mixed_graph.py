"""The port on the graphs gramtools is for, held to the JAX package on
the CPU at small sizes: the mixed graph (bench.py's ``mixed`` profile:
SNPs, direct deletions, insertions, four-allele and nested sites) and a
nested MSA graph built by ``build --prgs_bed``, both genotyped diploid.

  * ``common/workload.build_mixed_graph`` equals bench.py's, seed for
    seed;
  * on a small mixed graph, under the dense and the packed rank (JAX's
    packed rank through its plain reference on the CPU): the scan's
    final carry and genealogy log, the replay (trav, ing), the fused
    program (flags, loci triples, ``cov_diff``) and the engine's
    counters and coverage equal the JAX package's bit for bit;
  * ``genotype --engine device --ploidy diploid`` of the port and of the
    JAX package write equal files, equal to each package's host engine;
  * a small ``make_msa_workload``: both packages' ``build --prgs_bed``
    give equal build directories, and their diploid device genotype
    files are equal; the graph has sites nested two deep, a site of 3 or
    more alleles and a direct-deletion allele.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench
from gramtools_tpu.cli import run as run_jax_cli
from gramtools_tpu.mapping import record_jax as rj
from gramtools_tpu.mapping import search_jax_log as jsl
from gramtools_tpu.mapping.device_index import DeviceIndex as JaxDeviceIndex
from gramtools_tpu.mapping.jump_table import build_jump_table
from gramtools_tpu.mapping.quasimap import quasimap_reads as jax_quasimap
from gramtools_tpu.ops.rank import build_packed_occ as jax_packed_occ
from gramtools_tpu_torch.cli import run as run_torch_cli
from gramtools_tpu_torch.common.rng import RandomInclusiveInt, first_raw_draws
from gramtools_tpu_torch.common.workload import (build_mixed_graph,
                                                 graph_shape,
                                                 make_msa_workload,
                                                 reference_sequence,
                                                 sample_haplotypes,
                                                 sample_reads, write_fastq)
from gramtools_tpu_torch.mapping import engine as engine_mod
from gramtools_tpu_torch.mapping import record as tr
from gramtools_tpu_torch.mapping import search_log as tsl
from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
from gramtools_tpu_torch.mapping.quasimap import QuasimapStats
from gramtools_tpu_torch.mapping.search_log_host import LogConfig
from gramtools_tpu_torch.prg.linearise import PrgString

from test_torch_mesh import _assert_same, _run
from test_torch_standalone import _content, _files
from test_torch_twins import assert_same, twin_index, twin_kmer_index

K = 7


@pytest.mark.parametrize("seed,genome_len,num_sites", [
    (0, 5_000, 50), (3, 100_000, 800), (42, 30_000, 2_000)])
def test_build_mixed_graph_equals_bench(seed, genome_len, num_sites):
    ours = build_mixed_graph(np.random.RandomState(seed), genome_len,
                             num_sites)
    theirs = bench.build_mixed_graph(np.random.RandomState(seed), genome_len,
                                     num_sites)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    shape = graph_shape(ours)
    assert shape["max_depth"] == 2 and shape["sites"] > num_sites
    assert shape["multi_allelic_sites"] and shape["deletion_alleles"]


def _mixed(n_reads, seed=5):
    """(PRG ints, reads): a 20 kb mixed graph of 160 sites, 150 bp reads
    from 4 sampled haplotypes."""
    rng = np.random.RandomState(seed)
    ints = build_mixed_graph(rng, 20_000, 160)
    paths = sample_haplotypes(ints, dict(PrgString(ints).end_positions),
                              rng, 4)
    return ints, list(sample_reads(rng, paths, n_reads, 150))


class Case:
    """One fused dispatch of the port's engine on the mixed graph under
    one rank, with both packages' tables (each built by its own
    package)."""

    def __init__(self, rank):
        ints, reads = _mixed(120)
        self.rank, self.k = rank, K
        j_idx, idx = twin_index(ints)
        j_kmers, kmer_index = twin_kmer_index(j_idx, idx, K)
        mp = pytest.MonkeyPatch()
        captured = {}
        try:
            mp.setenv("GRAMTOOLS_TPU_RANK", rank)
            eng = LogBatchedEngine(idx, K, LogConfig(pool=4096, hits=64),
                                   device="cpu")
            j_jt = build_jump_table(j_idx)
            assert_same(j_jt, eng.jt, "jump table")
            self.jdi = JaxDeviceIndex.build(j_idx, j_jt)

            def capture(*args, **kwargs):
                captured["args"], captured["kwargs"] = args, kwargs
                return tsl.log_search_record(*args, **kwargs)

            mp.setattr(engine_mod, "log_search_record", capture)
            seeds = RandomInclusiveInt(5).raw_block(len(reads))
            first = first_raw_draws(np.asarray(seeds, dtype=np.uint32))
            eng.scan_submit(reads, kmer_index, K, QuasimapStats(),
                            first_raws=first)
        finally:
            mp.undo()
        (di, rt, st, reads_p, slot_sidx, slot_row, row_ok, row_first,
         row_len, _cov, phases, R, trip_cap, _k) = captured["args"]
        kw = captured["kwargs"]
        assert kw["rank"] == rank
        self.blocks = kw["blocks"]
        self.j_blocks = None
        if rank == "packed":
            assert self.blocks is not None
            self.j_blocks = jnp.asarray(jax_packed_occ(j_idx.fm))
            np.testing.assert_array_equal(self.blocks.numpy(),
                                          np.asarray(self.j_blocks))
        self.tdi, self.trt, self.tst = di, rt, st
        self.jrt = rj.RecordTables.build(j_idx)
        self.jst = rj.SeedTables.build(j_kmers)
        self.np = dict(reads_p=reads_p.numpy(), slot_sidx=slot_sidx.numpy(),
                       slot_row=slot_row.numpy(), row_ok=row_ok.numpy(),
                       row_first=row_first.numpy(), row_len=row_len.numpy())
        self.phases, self.R, self.trip_cap = phases, R, trip_cap
        self.cov_size = rt.cov_size
        steps = sum(e[0] for e in phases)
        self.reads_t = tsl.unpack_reads2(reads_p, row_len, steps, K)
        ok = slot_sidx >= 0
        sidc = slot_sidx.clamp(0, st.n_states - 1)
        self.carry = (torch.where(ok, slot_row, -1),
                      torch.where(ok, st.k_lo[sidc], 0),
                      torch.where(ok, st.k_hi[sidc], 0),
                      torch.where(ok, -(slot_sidx + 1), 0),
                      torch.zeros(R, dtype=torch.bool))
        self._scan = None

    def scan(self):
        """(the port's scan, JAX's): each its final carry, then its log."""
        if self._scan is None:
            got = tsl.log_search_phases(
                self.tdi, self.reads_t, self.carry, self.phases, self.R,
                occ_rows=tsl.occ_rows_for(self.tdi, self.blocks, self.rank))
            want = jax.jit(
                lambda di, reads, carry, blocks: jsl._log_search_phases(
                    di, reads, carry, self.phases, self.R,
                    occ_rows=jsl._occ_rows_for(di, blocks, self.rank)))(
                self.jdi, jnp.asarray(self.reads_t.numpy()),
                tuple(jnp.asarray(a.numpy()) for a in self.carry),
                self.j_blocks)
            self._scan = ([t.numpy() for t in got[0] + got[1]],
                          [np.asarray(w) for w in want[0] + want[1]])
        return self._scan


@pytest.fixture(scope="module", params=["dense", "packed"])
def case(request):
    return Case(request.param)


def test_scan_carry_and_log_equal_jax(case):
    got, want = case.scan()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[5] >= 0).any() and (got[0] >= 0).any()  # records, states
    assert any(len(e) == 5 for e in case.phases)        # a locked phase


def test_replay_equal_jax(case):
    rid, lo, hi, pref, ovf, lp, le = case.scan()[0]
    alive = rid >= 0
    j = rj.replay_device(case.jdi, jnp.asarray(pref), jnp.asarray(lp),
                         jnp.asarray(le), case.jst, jnp.asarray(alive))
    t = tr.replay_device(case.tdi, torch.from_numpy(pref),
                         torch.from_numpy(lp), torch.from_numpy(le),
                         case.tst, torch.from_numpy(alive))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (t[1] > 0).any() and (t[3] > 0).any()   # traversed, traversing


def test_fused_program_equals_record_body(case):
    a = case.np
    cov0 = np.zeros(case.cov_size + 1, np.int32)
    j_flat, j_cov = jsl._log_search_record(     # _record_body, jitted
        case.jdi, case.jrt, case.jst, jnp.asarray(a["reads_p"]),
        jnp.asarray(a["slot_sidx"]), jnp.asarray(a["slot_row"]),
        jnp.asarray(a["row_ok"]),
        jnp.asarray(a["row_first"].astype(np.uint32)),
        jnp.asarray(a["row_len"]), jnp.asarray(cov0), case.phases, case.R,
        case.trip_cap, case.k, blocks=case.j_blocks, rank=case.rank)
    cov_t = torch.from_numpy(cov0.copy())
    t_flat = tsl.log_search_record(
        case.tdi, case.trt, case.tst,
        *(torch.from_numpy(a[n]) for n in ("reads_p", "slot_sidx",
                                           "slot_row", "row_ok",
                                           "row_first", "row_len")),
        cov_t, case.phases, case.R, case.trip_cap, case.k,
        blocks=case.blocks, rank=case.rank)
    np.testing.assert_array_equal(t_flat.numpy(), np.asarray(j_flat))
    np.testing.assert_array_equal(cov_t.numpy(), np.asarray(j_cov))
    R = case.R
    assert t_flat[2 * R:3 * R].any() and cov_t.any()   # rows mapped


@pytest.mark.parametrize("rank", ["dense", "packed"])
def test_engine_counters_and_coverage_equal_jax(rank, monkeypatch):
    """Whole quasimap runs of 200 reads of the mixed graph in 100-read
    buffers, retries and host fallbacks included: the port's engine and
    the JAX engine give equal stats, coverage and counters."""
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", rank)
    monkeypatch.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
    ints, reads = _mixed(200, seed=6)
    port = _run(ints, reads, K, 42, lambda idx, k: LogBatchedEngine(
        idx, k, LogConfig(pool=4096, hits=64)), buffer_size=100)
    ref = _run(ints, reads, K, 42, lambda idx, k: jsl.LogBatchedEngine(
        idx, k, jsl.LogConfig(pool=4096, hits=64)),
        run_quasimap=jax_quasimap, buffer_size=100)
    _assert_same(port, ref)
    for name in ("device_mapped", "host_fallbacks", "device_retried",
                 "hits_boost", "fallback_reasons"):
        assert getattr(port[3], name) == getattr(ref[3], name), name
    assert port[3].device_mapped > 0 and port[3].host_fallbacks > 0
    assert port[3].rank == ref[3].rank == rank


# ---------------------------------------------------------------------------
# genotype --ploidy diploid, end to end
# ---------------------------------------------------------------------------

def _genotype(cli, gram, out, reads, engine):
    assert cli(["genotype", "--gram_dir", str(gram), "--genotype_dir",
                str(out), "--reads", str(reads), "--sample_id", "s",
                "--seed", "42", "--ploidy", "diploid", "--engine", engine,
                "--force"]) == 0


def _assert_runs_equal(want, *runs):
    """Every file of each run equal to ``want``'s (VCF without
    ##fileDate, reports without timings, paths and, for the device
    engine, its counters)."""
    files = [f for f in _files(want) if f != "genotype_report.json"]
    assert "genotype/genotyped.json" in files
    for run in runs:
        assert [f for f in _files(run) if f != "genotype_report.json"] \
            == files
        for rel in files + ["genotype_report.json"]:
            a, b = _content(run / rel), _content(want / rel)
            if rel == "genotype_report.json":
                for r in (a, b):
                    r["processes"]["genotype"].pop("engine", None)
            assert a == b, (run, rel)


def _device_runs(monkeypatch, tmp_path, grams, reads):
    """The port's device engine under each rank, the JAX package's under
    the dense rank (its default; the seams above hold the packed rank to
    JAX), each on its own build, and both host engines; every run's
    files equal the port's host run's. Returns the port's device
    runs."""
    monkeypatch.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("GRAMTOOLS_TPU_DEVICE_RECORD", raising=False)
    runs = []
    for tag, cli, rank in (("torch", run_torch_cli, "dense"),
                           ("torch", run_torch_cli, "packed"),
                           ("jax", run_jax_cli, "dense")):
        monkeypatch.setenv("GRAMTOOLS_TPU_RANK", rank)
        runs.append(tmp_path / f"{tag}_device_{rank}")
        _genotype(cli, grams[tag], runs[-1], reads, "device")
    for tag, cli in (("torch", run_torch_cli), ("jax", run_jax_cli)):
        _genotype(cli, grams[tag], tmp_path / f"{tag}_host", reads, "host")
    _assert_runs_equal(tmp_path / "torch_host", tmp_path / "jax_host", *runs)
    return runs[:2]


def _device_mapped(run: Path) -> int:
    import json

    report = json.loads((run / "genotype_report.json").read_text())
    return report["processes"]["genotype"]["engine"]["device_mapped"]


def test_genotype_diploid_mixed_graph_equal_jax_and_host(tmp_path,
                                                         monkeypatch):
    """Each package builds the mixed graph (build --prg) and genotypes
    300 reads diploid with its device engine and its host engine: every
    run writes the port's host run's files."""
    ints, reads = _mixed(300, seed=8)
    PrgString(ints).write(tmp_path / "prg.bin")
    (tmp_path / "ref.fa").write_text(">ref\n" + reference_sequence(ints)
                                     + "\n")
    write_fastq(tmp_path / "reads.fq", np.asarray(reads))
    grams = {}
    for tag, cli in (("torch", run_torch_cli), ("jax", run_jax_cli)):
        grams[tag] = tmp_path / f"gram_{tag}"
        assert cli(["build", "--gram_dir", str(grams[tag]), "--prg",
                    str(tmp_path / "prg.bin"), "--ref",
                    str(tmp_path / "ref.fa"), "--kmer_size", str(K),
                    "--force"]) == 0
    for run in _device_runs(monkeypatch, tmp_path, grams,
                            tmp_path / "reads.fq"):
        assert _device_mapped(run) > 0


def test_msa_graph_build_and_diploid_genotype_equal_jax(tmp_path,
                                                        monkeypatch):
    """A small make_msa_workload (3 regions on 24 kb): the JAX package's
    build --prgs_bed of the same inputs gives the port's build directory
    file for file, and the diploid device and host genotype runs of both
    packages write equal files."""
    work = tmp_path / "msa"
    work.mkdir()
    make_msa_workload(work, ref_len=24_000, n_regions=3, n_reads=300,
                      kmer_size=K, seed=3, load=False)
    shape = graph_shape(PrgString.from_file(work / "gram" / "prg").ints)
    assert shape["max_depth"] >= 2 and shape["multi_allelic_sites"] > 0
    assert shape["deletion_alleles"] > 0
    grams = {"torch": work / "gram", "jax": tmp_path / "gram_jax"}
    assert run_jax_cli(["build", "--gram_dir", str(grams["jax"]),
                        "--prgs_bed", str(work / "regions.bed"), "--ref",
                        str(work / "ref.fa"), "--kmer_size", str(K),
                        "--force"]) == 0
    files = _files(grams["jax"])
    assert "prg" in files and files == _files(grams["torch"])
    for rel in files:
        got, want = (_content(grams[tag] / rel) for tag in ("torch", "jax"))
        if rel.endswith(".bed"):        # the region files by their paths
            got, want = (c.replace(str(grams[tag]).encode(), b"GRAM")
                         for c, tag in ((got, "torch"), (want, "jax")))
        assert got == want, rel
    for run in _device_runs(monkeypatch, tmp_path, grams,
                            work / "reads.fq"):
        assert _device_mapped(run) > 0
