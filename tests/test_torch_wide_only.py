"""The wide-only plan of an index of 2**24 rows or more, held to the JAX
package on the CPU at small sizes.

At n >= 2**24 both packages' narrow-step table is a one-element stub
(``mapping/device_index.py::_build_narrow_tab`` in each), the engine
still asks ``auto_phases`` for the narrow plan (warm, mid, narrow and
slot-locked entries), and every phase runs the wide step: JAX through
``_resize_pool`` and ``_build_log_step``, the port as one ``wide_steps``
call (K2, one launch on CUDA) over all four phases. Stubbing the table in
both packages' indexes of a small graph runs that exact plan and code
path here. Each seam is held bit for bit, on a nested graph and on a
biallelic one (the smoke's and a P. falciparum-scale graph's kind):

  * the scan's final carry, flags and genealogy log
    (``search_log.log_search_phases`` against ``_log_search_phases``),
    on the engine's own buffer, the plan turned wide;
  * the replay (trav, ing) and the whole fused program (flags, triples,
    ``cov_diff``: ``log_search_record`` against ``_record_body``);
  * ``genotype --engine device`` output files against the JAX package's
    device engine and the port's host engine;
  * K10's round mirror (tests/test_torch_sharded_rounds.py) with no
    narrow table, and the port's index-sharded scan, against JAX's
    ``make_index_sharded_log_search`` on 2 and 4 shards.

The index-sharded kernels' argument rule takes n >= 2**24 when the plan
reads no narrow table, and refuses a narrow table at that size.
"""
import dataclasses
import gzip
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from gramtools_tpu.cli import run as run_jax_cli
from gramtools_tpu.mapping import device_index as j_device_index
from gramtools_tpu.mapping import record_jax as rj
from gramtools_tpu.mapping import search_jax_log as jsl
from gramtools_tpu.mapping.device_index import DeviceIndex as JaxDeviceIndex
from gramtools_tpu.mapping.jump_table import build_jump_table
from gramtools_tpu.parallel.sharded_index import \
    make_index_sharded_log_search as jax_index_sharded
from gramtools_tpu.prg.linearise import prg_string_to_ints
from gramtools_tpu_torch.cli import run as run_torch_cli
from gramtools_tpu_torch.common.rng import RandomInclusiveInt, first_raw_draws
from gramtools_tpu_torch.common.workload import (build_synthetic_mtb_graph,
                                                 reference_sequence,
                                                 sample_haplotypes,
                                                 sample_reads, write_fastq)
from gramtools_tpu_torch.mapping import device_index as t_device_index
from gramtools_tpu_torch.mapping import engine as engine_mod
from gramtools_tpu_torch.mapping import record as tr
from gramtools_tpu_torch.mapping import search_log as tsl
from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
from gramtools_tpu_torch.mapping.quasimap import QuasimapStats
from gramtools_tpu_torch.mapping.search_log_host import (LogConfig, _phase4,
                                                         auto_phases)
from gramtools_tpu_torch.ops import sharded
from gramtools_tpu_torch.parallel.mesh import Mesh
from gramtools_tpu_torch.parallel.sharded_index import \
    make_index_sharded_log_search
from gramtools_tpu_torch.prg.linearise import PrgString

from test_search_jax import HARD_NESTED_PRGS, random_prg
from test_sharded_index import seeded_batch
from test_torch_sharded_index import _torch, setup  # noqa: F401
from test_torch_sharded_rounds import _Mirror
from test_torch_twins import assert_same, twin_index, twin_kmer_index

I32 = torch.int32


def _stub(*_args):
    return np.zeros(1, dtype=np.int32)


def _stub_both(mp, calls=None):
    """Both packages build the one-element narrow table of an index of
    2**24 rows or more; ``calls`` counts the builds."""
    def stub(*args):
        if calls is not None:
            calls.append(1)
        return _stub(*args)
    mp.setattr(j_device_index, "_build_narrow_tab", stub)
    mp.setattr(t_device_index, "_build_narrow_tab", stub)


def _graph(kind):
    """(PRG ints, reads, k): "nested" is tests/test_search_jax.py's
    nested PRGs (random_prg's and HARD_NESTED_PRGS) with 24 bp reads,
    "biallelic" the SNP graph of common/workload.py with 40 bp reads,
    each from 4 sampled haplotypes."""
    rng = np.random.RandomState(3)
    if kind == "biallelic":
        ints, n, k = build_synthetic_mtb_graph(rng, 2000, 40), 40, 5
    else:
        ints, n, k = prg_string_to_ints(
            random_prg(np.random.RandomState(4), num_sites=24, nested=True)
            + HARD_NESTED_PRGS[1] + "ACGTTGCA" + HARD_NESTED_PRGS[0]), 24, 3
    paths = sample_haplotypes(ints, dict(PrgString(ints).end_positions),
                              rng, 4)
    return ints, list(sample_reads(rng, paths, 60, n)), k


class Case:
    """One fused dispatch of the port's engine on a stub-narrow index,
    with both packages' tables (each built by its own package)."""

    def __init__(self, kind):
        ints, reads, self.k = _graph(kind)
        j_idx, idx = twin_index(ints)
        j_kmers, kmer_index = twin_kmer_index(j_idx, idx, self.k)
        mp = pytest.MonkeyPatch()
        captured, wide_calls = {}, []
        try:
            _stub_both(mp)
            eng = LogBatchedEngine(idx, self.k,
                                   LogConfig(pool=4096, hits=1024),
                                   device="cpu")
            j_jt = build_jump_table(j_idx)
            assert_same(j_jt, eng.jt, "jump table")
            self.jdi = JaxDeviceIndex.build(j_idx, j_jt)

            def capture(*args, **kwargs):
                captured["args"] = args
                return tsl.log_search_record(*args, **kwargs)

            def wide_steps(*args, **kwargs):
                wide_calls.append(args[3])
                return tsl_wide_steps(*args, **kwargs)

            def no_tail(*args, **kwargs):
                raise AssertionError("the wide-only plan ran the narrow tail")

            tsl_wide_steps = tsl.wide_steps
            mp.setattr(engine_mod, "log_search_record", capture)
            mp.setattr(tsl, "wide_steps", wide_steps)
            mp.setattr(tsl, "locked_tail", no_tail)
            seeds = RandomInclusiveInt(5).raw_block(len(reads))
            first = first_raw_draws(np.asarray(seeds, dtype=np.uint32))
            eng.scan_submit(reads, kmer_index, self.k, QuasimapStats(),
                            first_raws=first)
        finally:
            mp.undo()
        (di, rt, st, reads_p, slot_sidx, slot_row, row_ok, row_first,
         row_len, _cov, phases, R, trip_cap, _k) = captured["args"]
        self.wide_calls = wide_calls
        self.tdi, self.trt, self.tst = di, rt, st
        self.jrt = rj.RecordTables.build(j_idx)
        self.jst = rj.SeedTables.build(j_kmers)
        self.np = dict(reads_p=reads_p.numpy(), slot_sidx=slot_sidx.numpy(),
                       slot_row=slot_row.numpy(), row_ok=row_ok.numpy(),
                       row_first=row_first.numpy(), row_len=row_len.numpy())
        self.phases, self.R, self.trip_cap = phases, R, trip_cap
        self.cov_size = rt.cov_size
        # the scan's inputs, as the fused program builds them
        steps = sum(e[0] for e in phases)
        self.reads_t = tsl.unpack_reads2(reads_p, row_len, steps, self.k)
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
            got = tsl.log_search_phases(self.tdi, self.reads_t, self.carry,
                                        self.phases, self.R)
            want = jax.jit(jsl._log_search_phases,
                           static_argnames=("phases", "num_reads"))(
                self.jdi, jnp.asarray(self.reads_t.numpy()),
                tuple(jnp.asarray(a.numpy()) for a in self.carry),
                phases=self.phases, num_reads=self.R)
            self._scan = ([t.numpy() for t in got[0] + got[1]],
                          [np.asarray(w) for w in want[0] + want[1]])
        return self._scan


@pytest.fixture(scope="module", params=["nested", "biallelic"])
def case(request):
    return Case(request.param)


def test_stub_index_runs_the_narrow_plan_as_one_wide_call(case):
    """Both indexes hold the stub; the engine's plan is the narrow plan
    (warm, mid, narrow, locked), and the port ran it as one wide_steps
    call of its four phases (one K2 launch on CUDA), no narrow tail."""
    assert case.tdi.narrow_tab.shape == (1,) != (case.tdi.size,)
    assert np.asarray(case.jdi.narrow_tab).shape == (1,)
    kinds = [(_phase4(e)[3] > 0, _phase4(e)[4]) for e in case.phases]
    assert kinds == [(False, ""), (False, ""), (True, ""), (True, "locked")]
    assert case.wide_calls == [[tuple(e[:3]) for e in case.phases]]
    # the last phase's pool is R, below the narrow phase's 1.25 R
    assert case.phases[-1][1] == case.R < case.phases[-2][1]


def test_scan_carry_and_log_equal_jax(case):
    got, want = case.scan()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[5] >= 0).any() and (got[0] >= 0).any()  # records, states


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
    assert (t[1] > 0).any() or (t[3] > 0).any()


def test_fused_program_equals_record_body(case):
    a = case.np
    cov0 = np.zeros(case.cov_size + 1, np.int32)
    j_flat, j_cov = jsl._log_search_record(     # _record_body, jitted
        case.jdi, case.jrt, case.jst, jnp.asarray(a["reads_p"]),
        jnp.asarray(a["slot_sidx"]), jnp.asarray(a["slot_row"]),
        jnp.asarray(a["row_ok"]),
        jnp.asarray(a["row_first"].astype(np.uint32)),
        jnp.asarray(a["row_len"]), jnp.asarray(cov0), case.phases, case.R,
        case.trip_cap, case.k)
    cov_t = torch.from_numpy(cov0.copy())
    t_flat = tsl.log_search_record(
        case.tdi, case.trt, case.tst,
        *(torch.from_numpy(a[n]) for n in ("reads_p", "slot_sidx",
                                           "slot_row", "row_ok",
                                           "row_first", "row_len")),
        cov_t, case.phases, case.R, case.trip_cap, case.k)
    np.testing.assert_array_equal(t_flat.numpy(), np.asarray(j_flat))
    np.testing.assert_array_equal(cov_t.numpy(), np.asarray(j_cov))
    R = case.R
    assert t_flat[2 * R:3 * R].any() and cov_t.any()   # rows mapped


# ---------------------------------------------------------------------------
# genotype --engine device, end to end
# ---------------------------------------------------------------------------

OUTPUT_FILES = ("genotype/genotyped.vcf.gz", "genotype/genotyped.json",
                "coverage/allele_sum_coverage",
                "coverage/grouped_allele_counts_coverage.json",
                "coverage/allele_base_coverage.json",
                "genotype/personalised_reference.fasta")


def _output(path):
    if path.suffix == ".gz":
        with gzip.open(path, "rb") as fh:
            return b"".join(l for l in fh if not l.startswith(b"##fileDate"))
    return path.read_bytes()


def test_genotype_device_files_equal_jax_and_host(tmp_path, monkeypatch):
    """Each package builds the SNP graph and genotypes 300 reads of 60 bp
    with its device engine (fused recorder, dense rank) on a stub-narrow
    index; the files equal each other's and the port's host engine's."""
    rng = np.random.RandomState(8)
    ints = build_synthetic_mtb_graph(rng, 3000, 60)
    prg = PrgString(ints)
    prg.write(tmp_path / "prg.bin")
    (tmp_path / "ref.fa").write_text(">ref\n" + reference_sequence(ints)
                                     + "\n")
    paths = sample_haplotypes(ints, dict(prg.end_positions), rng, 4)
    write_fastq(tmp_path / "reads.fq", sample_reads(rng, paths, 300, 60))
    calls = []
    _stub_both(monkeypatch, calls)
    monkeypatch.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", "dense")
    monkeypatch.delenv("GRAMTOOLS_TPU_DEVICE_RECORD", raising=False)
    for cli, gram in ((run_torch_cli, "gram_torch"), (run_jax_cli, "gram")):
        assert cli(["build", "--gram_dir", str(tmp_path / gram),
                    "--prg", str(tmp_path / "prg.bin"),
                    "--ref", str(tmp_path / "ref.fa"),
                    "--kmer_size", "7", "--force"]) == 0
    for cli, gram, name, engine in (
            (run_torch_cli, "gram_torch", "torch_device", "device"),
            (run_jax_cli, "gram", "jax_device", "device"),
            (run_torch_cli, "gram_torch", "torch_host", "host")):
        assert cli(["genotype", "--gram_dir", str(tmp_path / gram),
                    "--genotype_dir", str(tmp_path / name),
                    "--reads", str(tmp_path / "reads.fq"),
                    "--sample_id", "s", "--seed", "42",
                    "--engine", engine, "--force"]) == 0
    assert len(calls) >= 2             # both device engines built the stub
    for rel in OUTPUT_FILES:
        want = _output(tmp_path / "torch_host" / rel)
        assert _output(tmp_path / "torch_device" / rel) == want, rel
        assert _output(tmp_path / "jax_device" / rel) == want, rel
    for name in ("torch_device", "jax_device"):
        report = json.loads((tmp_path / name / "genotype_report.json")
                            .read_text())
        assert report["processes"]["genotype"]["engine"]["device_mapped"] > 0


# ---------------------------------------------------------------------------
# the index-sharded scan (K10) with no narrow table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [[[0], [1]], [[0, 1], [2], [3]]])
def test_round_mirror_without_narrow_table_equals_jax(setup, groups):
    """The index in 2 and 4 shards with no narrow table (stub indexes in
    both packages), the engine's narrow plan: the round kernels' mirror
    on every simulated card, the port's index-sharded scan and its
    replicated scan all equal JAX's make_index_sharded_log_search."""
    idx, jdi, tdi = setup
    tdi = dataclasses.replace(tdi, narrow_tab=torch.zeros(1, dtype=I32))
    jdi = dataclasses.replace(jdi, narrow_tab=jnp.zeros(1, jnp.int32))
    S = sum(len(g) for g in groups)
    R = 6
    cfg = LogConfig(pool=64, hits=16)
    reads_T, carry = seeded_batch(idx, np.random.RandomState(2), R, 16,
                                  jsl.LogConfig(pool=64, hits=16))
    phases = auto_phases(16, R, cfg, narrow=True)
    assert any(len(e) == 5 for e in phases)          # a locked entry
    want = jax_index_sharded(
        JaxMesh(np.array(jax.devices()[:S]), axis_names=("idx",)), jdi,
        jsl.LogConfig(pool=64, hits=16), R, phases=phases)(
            reads_T, jax.device_put(carry))
    want = [np.asarray(w).reshape(-1) for w in want[0] + want[1]]
    reads, tcarry = _torch(reads_T, carry)
    reads = reads.to(I32)
    mirror_carry = tuple(a.contiguous() for a in tcarry[:4]) + (torch.cat(
        [tcarry[4].to(torch.bool), torch.zeros(1, dtype=torch.bool)]),)
    tables = sharded.build_tables(tdi.occ.numpy(), None, tdi.size,
                                  ["cpu"] * S, "cpu")
    assert not tables.has_narrow
    plan = [_phase4(e) for e in phases]
    for (c_out, logs) in _Mirror(tdi, reads, mirror_carry, plan, R, tables,
                                 groups).run():
        got = list(c_out[:4]) + [c_out[4][:R]] + list(logs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    for got in (make_index_sharded_log_search(
            Mesh(["cpu"] * S, ("idx",)), tdi, cfg, R, phases=phases)(
                reads, tcarry),
            tsl.log_search_phases(tdi, reads, tcarry, phases, R)):
        for g, w in zip(got[0] + got[1], want):
            np.testing.assert_array_equal(g.numpy(), w)
    assert (want[5] >= 0).any()


def test_index_rule_takes_n_past_2_24_without_narrow_table():
    """The kernels' argument rule (ops/sharded.check_index) on stand-in
    indexes of 2**24 and 25,400,000 rows: a wide-only plan passes, a
    plan that reads the narrow table is refused; the tables' rule takes
    the stub narrow shards of such an index (shape-only tensors, so no
    17M-row table is built; only the device rule, last, refuses them
    here); the engine's narrow plan over such tables is wide in every
    step of the kernels' step table."""
    for n in (2 ** 24, 25_400_000):
        di = SimpleNamespace(size=n, sym_start=torch.zeros(5, dtype=I32),
                             out_lo=torch.zeros((3, 2), dtype=I32),
                             out_hi=torch.zeros((3, 2), dtype=I32))
        sharded.check_index("f", di, narrow=False)
        with pytest.raises(ValueError, match="narrow table needs n < 2"):
            sharded.check_index("f", di, narrow=True)
        for S in (3, 4):
            rps = -(-(n + 1) // S)
            tables = sharded.ShardedTables(
                tuple(torch.empty((rps, 4), dtype=I32, device="meta")
                      for _ in range(S)),
                tuple(torch.empty(1, dtype=I32, device="meta")
                      for _ in range(S)),
                rps, 1, False, n, torch.device("meta"))
            with pytest.raises(ValueError, match="must be on a CUDA card"):
                sharded.check_tables("f", tables, n)
            with pytest.raises(ValueError, match="do not cover"):
                sharded.check_tables("f", dataclasses.replace(
                    tables, has_narrow=True), n)
    plan = auto_phases(144, 30720, LogConfig(pool=1 << 20, hits=448),
                       n_seed_states=60000, narrow=True)
    rows = sharded.step_table([_phase4(e) for e in plan], 30720, plan[0][1],
                              4, False)[0]
    assert len(rows) == 144 and {r[0] for r in rows} == {0}
    assert len(plan) == 4 and [r[1] for r in rows][-1] == 30720
