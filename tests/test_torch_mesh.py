"""The port's mesh engine (gramtools_tpu_torch/parallel/mesh.py) on the
CPU, against the JAX package's MeshLogEngine and the scalar oracle.

S CPU shards run as a mesh of one device repeated S times
(``make_mesh(devices=["cpu"] * S)``); the JAX package runs on its 8
virtual CPU devices (tests/conftest.py). Mirrors
tests/test_mesh_engine.py and tests/test_parallel_mesh.py: stats,
allele-sum, grouped counts and per-base coverage equal to the oracle
and to JAX at S = 2 and 8, one fused S = 2 dispatch byte-equal to JAX's
(flat result and the per-shard ``cov_diff``), search_buffer states at
S = 1, 2 and 8, the retry pass invariant to S, and the dict-index
TypeError. Also the data-parallel scan, the torch dry run, the device
trace and the genotype mesh switch. Exact equality throughout.
"""
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from gramtools_tpu.common.rng import RandomInclusiveInt, first_raw_draws
from gramtools_tpu.common.seq import encode_dna
from gramtools_tpu.index.build import build_prg_index
from gramtools_tpu.index.kmer_index import build_kmer_index
from gramtools_tpu.index.kmer_index_vec import build_kmer_index_vectorised
from gramtools_tpu.mapping import search_jax_log as jsl
from gramtools_tpu.mapping.quasimap import QuasimapStats
from gramtools_tpu.mapping.quasimap import quasimap_reads as jax_quasimap
from gramtools_tpu.parallel import mesh as jax_mesh
from gramtools_tpu.prg.linearise import PrgString, prg_string_to_ints
from gramtools_tpu_torch.mapping.quasimap import quasimap_reads
from gramtools_tpu_torch.mapping.search_log_host import LogConfig
from gramtools_tpu_torch.parallel.mesh import (Mesh, MeshLogEngine,
                                               make_mesh,
                                               make_sharded_log_search)

from test_parallel_mesh import PRG as SMALL_PRG
from test_parallel_mesh import _expected, _states_key


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _write_fastq(td, reads):
    fq = str(Path(td) / "reads.fastq")
    with open(fq, "w") as fh:
        for i, r in enumerate(reads):
            s = "".join("ACGT"[b - 1] for b in r)
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    return fq


def _run(prg_ints, reads, k, seed, engine_factory,
         run_quasimap=quasimap_reads, buffer_size=None):
    idx = build_prg_index(PrgString(np.asarray(prg_ints, dtype=np.uint32)))
    kidx = build_kmer_index_vectorised(idx, k)
    engine = engine_factory(idx, k) if engine_factory else None
    with tempfile.TemporaryDirectory() as td:
        stats, cov = run_quasimap([_write_fastq(td, reads)], kidx, idx, k,
                            seed=seed, engine=engine, buffer_size=buffer_size)
    return stats, cov, idx.graph.coverage.copy(), engine


def _haplotype_workload(n_reads):
    """bench.py's M. tuberculosis-density graph (6 kb, 130 sites) and 80
    bp reads from 4 sampled haplotypes: (PrgString, reads)."""
    from bench import build_synthetic_mtb_graph, sample_haplotypes, \
        sample_reads

    rng = np.random.RandomState(9)
    prg_ints = build_synthetic_mtb_graph(rng, 6000, 130)
    prg = PrgString(prg_ints)
    paths = sample_haplotypes(prg_ints, dict(prg.end_positions), rng, 4)
    return prg, list(sample_reads(rng, paths, n_reads, 80))


def _assert_same(a, b):
    assert a[0].as_dict() == b[0].as_dict()
    assert a[1].allele_sum == b[1].allele_sum
    assert a[1].grouped_counts == b[1].grouped_counts
    np.testing.assert_array_equal(a[2], b[2])


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

def test_make_mesh_raises_with_fewer_gpus(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="2 CUDA devices"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="4 CUDA devices was asked for; 1"):
        make_mesh(4)
    assert make_mesh(1).devices.tolist() == [torch.device("cuda", 0)]


def test_mesh_of_repeated_devices():
    mesh = cpu_mesh(3)
    assert mesh.devices.shape == (3,)
    assert mesh.shape == {"data": 3}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    grid = Mesh([["cpu"] * 4] * 2, ("data", "idx"))
    assert grid.shape == {"data": 2, "idx": 4}
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 2, ("data", "idx"))
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"] * 2)


# --------------------------------------------------------------------------
# the fused engine against JAX and the scalar oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [2, 8])
def test_mesh_engine_matches_jax_and_scalar(n_dev):
    """Small nested multimapping PRG (test_mesh_engine.py): the port's
    mesh engine == the JAX mesh engine == the scalar oracle."""
    from test_coverage_fast import repeat_prg

    rng = np.random.RandomState(5)
    prg_ints = prg_string_to_ints(repeat_prg(rng, num_sites=5, nested=True))
    reads = [rng.randint(1, 5, size=rng.randint(4, 14)).astype(np.uint8)
             for _ in range(60)]
    oracle = _run(prg_ints, reads, 3, 17, None,
                  run_quasimap=jax_quasimap)
    port = _run(prg_ints, reads, 3, 17,
                lambda idx, k: MeshLogEngine(idx, k, mesh=cpu_mesh(n_dev)))
    ref = _run(prg_ints, reads, 3, 17,
               lambda idx, k: jax_mesh.MeshLogEngine(
                   idx, k, mesh=jax_mesh.make_mesh(n_dev)),
               run_quasimap=jax_quasimap)
    _assert_same(port, oracle)
    _assert_same(port, ref)
    eng, jeng = port[3], ref[3]
    assert eng.S == n_dev and eng.device_mapped > 0
    for name in ("device_mapped", "host_fallbacks", "device_retried",
                 "fallback_reasons"):
        assert getattr(eng, name) == getattr(jeng, name), name


def test_mesh_engine_on_distinct_devices(monkeypatch):
    """Shards on distinct devices ("cpu:0" and "cpu:1" stand in for two
    cards): the tables are copied once to each other device, each shard
    keeps its own cov_diff row on its device, and every result equals
    the same shards on one device."""
    from gramtools_tpu.mapping.coverage import Coverage

    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", "packed")
    prg, reads = _haplotype_workload(200)
    seeds = RandomInclusiveInt(17).raw_block(len(reads))
    first = first_raw_draws(np.asarray(seeds, dtype=np.uint32))
    rows = {}
    for name, devices in (("distinct", ["cpu:0", "cpu:1", "cpu:1"]),
                          ("one", ["cpu"] * 3)):
        idx = build_prg_index(prg)
        kidx = build_kmer_index_vectorised(idx, 7)
        eng = MeshLogEngine(idx, 7, mesh=make_mesh(devices=devices))
        cov = Coverage.empty(idx)
        stats = QuasimapStats()
        eng.record_buffer(reads, kidx, 7, stats, cov, seeds, first)
        rows[name] = ([r.clone() for r in eng.cov_diff], eng, stats, cov)
        eng.flush_device_coverage()
        rows[name] += (idx.graph.coverage.copy(),)
    d_rows, d_eng, d_stats, d_cov, d_pb = rows["distinct"]
    o_rows, o_eng, o_stats, o_cov, o_pb = rows["one"]
    assert isinstance(d_eng._replicas, dict) and {
        (name, str(dev)) for name, dev in d_eng._replicas} == {
        (name, "cpu:1") for name in ("di", "blocks", "rt", "st")}
    assert not o_eng._replicas
    for a, b in zip(d_rows, o_rows):
        assert torch.equal(a, b)
    assert sum(int(r.abs().sum()) for r in d_rows) > 0
    assert d_stats.as_dict() == o_stats.as_dict()
    assert d_cov.allele_sum == o_cov.allele_sum
    assert d_cov.grouped_counts == o_cov.grouped_counts
    np.testing.assert_array_equal(d_pb, o_pb)
    assert d_eng.device_mapped == o_eng.device_mapped > 0


def _leaves(obj):
    """Every tensor inside a table: dataclass fields, named tuples."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))
    elif isinstance(obj, tuple):
        for v in obj:
            yield from _leaves(v)


def test_tables_copy_whole_to_another_device(monkeypatch):
    """A shard's copy of each resident table has every tensor on its
    device, the seed paths' named tuple included ("meta" stands in for
    a second card: on the CPU, "cpu:1" tensors stay "cpu" ones)."""
    from gramtools_tpu_torch.mapping.engine import _to_device
    from gramtools_tpu_torch.mapping.record import RecordTables, SeedTables

    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", "packed")
    prg, _ = _haplotype_workload(1)
    idx = build_prg_index(prg)
    eng = MeshLogEngine(idx, 7, mesh=cpu_mesh(2))
    meta = torch.device("meta")
    tables = {"di": eng.di, "blocks": eng.blocks,
              "rt": RecordTables.build(idx, "cpu"),
              "st": SeedTables.build(build_kmer_index_vectorised(idx, 7),
                                     "cpu")}
    for name, table in tables.items():
        leaves = list(_leaves(_to_device(table, meta)))
        assert len(leaves) == len(list(_leaves(table))) > 0, name
        assert all(t.device == meta for t in leaves), name


def test_mesh_engine_shard_invariance_mixed_graph():
    """1,000 150 bp reads on a mixed indel/nested graph: identical
    coverage and selections on 1 and 8 shards, carried by the device."""
    from bench import build_mixed_graph, sample_haplotypes, sample_reads

    rng = np.random.RandomState(3)
    prg_ints = build_mixed_graph(rng, 100_000, 800)
    prg = PrgString(prg_ints.astype(np.uint32))
    paths = sample_haplotypes(prg_ints, dict(prg.end_positions), rng, 4)
    reads = list(sample_reads(rng, paths, 1000, 150))
    one = _run(prg_ints, reads, 8, 42,
               lambda idx, k: MeshLogEngine(idx, k, mesh=cpu_mesh(1)))
    eight = _run(prg_ints, reads, 8, 42,
                 lambda idx, k: MeshLogEngine(idx, k, mesh=cpu_mesh(8)))
    _assert_same(eight, one)
    assert eight[3].S == 8 and eight[3].device_mapped > 900, (
        eight[3].device_mapped, eight[3].host_fallbacks)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_pipelined_mesh_buffers_with_retries_match_jax(n_dev, monkeypatch):
    """Several buffers, submit of N+1 before completion of N, starved
    budgets so every shard overflows and the fused retry pass records on
    the device: equal to the JAX mesh engine, counters included."""
    from test_locked_phase import _random_site_prg

    monkeypatch.setenv("GRAMTOOLS_TPU_RETRY_MIN", "1")
    rng = np.random.RandomState(9)
    prg_str = _random_site_prg(rng, 2000, 50)
    prg_ints = prg_string_to_ints(prg_str)
    dna = build_prg_index(PrgString(prg_ints)).prg
    dna = dna[(dna >= 1) & (dna <= 4)].astype(np.uint8)
    reads = [dna[s:s + 50].copy()
             for s in rng.randint(0, dna.size - 50, size=240)]
    port = _run(prg_ints, reads, 5, 3, lambda idx, k: MeshLogEngine(
        idx, k, mesh=cpu_mesh(n_dev), cfg=LogConfig(pool=4096, hits=2)),
        buffer_size=80)
    ref = _run(prg_ints, reads, 5, 3, lambda idx, k: jax_mesh.MeshLogEngine(
        idx, k, mesh=jax_mesh.make_mesh(n_dev),
        cfg=jsl.LogConfig(pool=4096, hits=2)), run_quasimap=jax_quasimap,
        buffer_size=80)
    _assert_same(port, ref)
    for name in ("device_mapped", "host_fallbacks", "device_retried",
                 "hits_boost", "fallback_reasons"):
        assert getattr(port[3], name) == getattr(ref[3], name), name
    assert port[3].device_retried > 0 and port[3].device_mapped > 0
    assert {s[:4] for s in port[3].dispatch_shapes} == {
        s[:4] for s in ref[3].dispatch_shapes}


def test_fused_dispatch_bytes_equal_jax_run_record(monkeypatch):
    """One S = 2 fused dispatch: the flat result (both shards' blocks in
    shard order) and the per-shard cov_diff (2, cov_size + 1) equal the
    JAX engine's _run_record output byte for byte."""
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", "packed")
    prg, reads = _haplotype_workload(300)
    k = 7
    idx = build_prg_index(prg)
    kidx = build_kmer_index_vectorised(idx, k)
    first = first_raw_draws(np.asarray(RandomInclusiveInt(3).raw_block(
        len(reads)), dtype=np.uint32))
    port = MeshLogEngine(idx, k, mesh=cpu_mesh(2))
    ref = jax_mesh.MeshLogEngine(idx, k, mesh=jax_mesh.make_mesh(2))
    t_tok = port.scan_submit(reads, kidx, k, QuasimapStats(),
                             first_raws=first)
    j_tok = ref.scan_submit(reads, kidx, k, QuasimapStats(),
                            first_raws=first)
    assert t_tok[2][0] == j_tok[2][0] == "record"
    assert t_tok[2][2:] == j_tok[2][2:]           # R, trip_cap, phases
    got = t_tok[2][1].get()
    want = np.asarray(jsl._fetch(j_tok[2][1]))
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()
    got_cov = torch.stack(port.cov_diff)
    assert tuple(got_cov.shape) == (2, port.rt.cov_size + 1)
    want_cov = np.asarray(ref.cov_diff)
    assert got_cov.numpy().tobytes() == want_cov.tobytes()
    R = t_tok[2][2]
    assert got[2 * R:3 * R].any() and want_cov[0].any() and want_cov[1].any()


# --------------------------------------------------------------------------
# search_buffer, retry and the dict index (test_parallel_mesh.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_mesh_search_buffer_matches_host(n_devices):
    """Non-fused path: per-read SearchStates equal the scalar oracle at
    every shard count."""
    idx = build_prg_index(PrgString(prg_string_to_ints(SMALL_PRG)))
    k = 3
    rng = np.random.RandomState(3)
    reads = [rng.randint(1, 5, size=rng.randint(4, 12)).astype(np.uint8)
             for _ in range(24)]
    engine = MeshLogEngine(idx, k, mesh=cpu_mesh(n_devices))
    results = engine.search_buffer(reads, build_kmer_index_vectorised(idx, k),
                                   k, QuasimapStats())
    expected = _expected(reads, build_kmer_index(idx, k), idx, k)
    for got, exp in zip(results, expected):
        assert len(got) == len(exp)
        for (g_states, g_len), (e_states, e_len) in zip(got, exp):
            assert g_len == e_len
            assert _states_key(g_states) == _states_key(e_states)
    assert engine.device_mapped > 0


def test_mesh_retry_pass_shard_count_invariant():
    """A hit-budget-starved config overflows on every shard; the retry
    pass recovers the reads identically on 1 and 8 shards."""
    rng = np.random.RandomState(7)
    tail = "".join(rng.choice(list("ACGT"), size=60))
    idx = build_prg_index(PrgString(prg_string_to_ints(
        "GT" + "[A,C]" * 10 + tail)))
    k = 3
    kmer_index = build_kmer_index_vectorised(idx, k)
    reads = [encode_dna("GT" + "A" * 10 + tail) for _ in range(20)]
    expected = _expected(reads, build_kmer_index(idx, k), idx, k)
    for n_dev in (1, 8):
        engine = MeshLogEngine(idx, k, mesh=cpu_mesh(n_dev),
                               cfg=LogConfig(pool=512,
                                             hits=max(64 // n_dev, 8)))
        engine.retry_min = 1
        results = engine.search_buffer(reads, kmer_index, k, QuasimapStats())
        assert engine.device_retried > 0, "retry path not exercised"
        for got, exp in zip(results, expected):
            assert len(got) == len(exp)
            for (g_states, g_len), (e_states, e_len) in zip(got, exp):
                assert g_len == e_len
                assert _states_key(g_states) == _states_key(e_states)


def test_mesh_rejects_dict_kmer_index():
    idx = build_prg_index(PrgString(prg_string_to_ints(SMALL_PRG)))
    engine = MeshLogEngine(idx, 3, mesh=cpu_mesh(2))
    with pytest.raises(TypeError, match="seed_batch"):
        engine.search_buffer([encode_dna("ACGTAC")],
                             build_kmer_index(idx, 3), 3, QuasimapStats())


def _layout_engine(n_shards):
    idx = build_prg_index(PrgString(prg_string_to_ints(SMALL_PRG)))
    return MeshLogEngine(idx, 3, mesh=cpu_mesh(n_shards))


def _unpacked_cols(n_shards, R):
    """Column of each global row as the record unpacker reads it back:
    every column's flag words carry its own column number."""
    from gramtools_tpu_torch.mapping.search_log_host import \
        _unpack_record_result

    flat = np.concatenate([np.concatenate([np.zeros(R, np.int32), c, c])
                           for c in np.arange(n_shards * R, dtype=np.int32)
                           .reshape(n_shards, R)])
    return _unpack_record_result(flat, R, 0, n_shards=n_shards)[1]


def test_shard_layout_maps():
    engine = _layout_engine(4)
    R = 8
    cols = engine._cols_of(np.arange(4 * R), R)
    np.testing.assert_array_equal(cols, _unpacked_cols(4, R))
    slot, keep, spilled = engine._place_states(np.array([0, 4, 8, 1, 5]), 2)
    np.testing.assert_array_equal(slot, [0, 1, 1, 2, 3])
    np.testing.assert_array_equal(keep, [True, True, False, True, True])
    np.testing.assert_array_equal(spilled, [8])
    np.testing.assert_array_equal(
        engine._globalise_init_rid(np.array([0, -1, 1, 0, 2, -1, 0, 0])),
        [0, -1, 5, 1, 10, -1, 3, 3])


def test_shard_layout_is_identity_at_one_shard():
    """S = 1 runs the same shard loop: every layout map is the identity
    and the states fill the pool in order."""
    engine = _layout_engine(1)
    R = 8
    np.testing.assert_array_equal(engine._cols_of(np.arange(R), R),
                                  np.arange(R))
    np.testing.assert_array_equal(_unpacked_cols(1, R), np.arange(R))
    slot, keep, spilled = engine._place_states(np.array([0, 0, 3, 1, 5]), 4)
    np.testing.assert_array_equal(slot, [0, 1, 2, 3, 3])
    np.testing.assert_array_equal(keep, [True, True, True, True, False])
    np.testing.assert_array_equal(spilled, [5])
    rid = np.array([0, -1, 1, 4])
    np.testing.assert_array_equal(engine._globalise_init_rid(rid), rid)


# --------------------------------------------------------------------------
# the data-parallel scan, the dry run, the trace, the genotype switch
# --------------------------------------------------------------------------

def test_data_parallel_log_search_matches_jax():
    """make_sharded_log_search over 4 CPU shards: each shard's carry and
    log equal the JAX package's sharded scan (4 virtual devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from gramtools_tpu.mapping.device_index import DeviceIndex as JaxDI
    from test_sharded_index import PHASES, PRG, seeded_batch
    from test_torch_sharded_index import _to_torch_di

    idx = build_prg_index(PrgString(prg_string_to_ints(PRG)))
    jdi = JaxDI.build(idx)
    cfg = jsl.LogConfig(pool=64, hits=16)
    R_shard, n_dev = 4, 4
    rng = np.random.RandomState(2)
    parts = [seeded_batch(idx, rng, R_shard, 16, cfg) for _ in range(n_dev)]
    reads_T = np.concatenate([np.asarray(rt) for rt, _ in parts], axis=1)
    carry = tuple(np.concatenate(cs) for cs in zip(*[c for _, c in parts]))
    want = jax_mesh.make_sharded_log_search(
        JaxMesh(np.array(jax.devices()[:n_dev]), ("data",)), jdi, cfg,
        R_shard, phases=PHASES)(jnp.asarray(reads_T), jax.device_put(carry))
    got = make_sharded_log_search(
        cpu_mesh(n_dev), _to_torch_di(jdi), LogConfig(pool=64, hits=16),
        R_shard, phases=PHASES)(torch.from_numpy(reads_T),
                                tuple(torch.from_numpy(a) for a in carry))
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).reshape(-1))


def test_dryrun_multichip_on_cpu_devices():
    from gramtools_tpu_torch.parallel.dryrun import dryrun_multichip, entry

    fn, args = entry("cpu")
    (rid, *_), (lp, le) = fn(*args)
    assert (rid >= 0).any() and lp.numel() == le.numel() > 0
    out = dryrun_multichip(["cpu"] * 8)
    assert out["device_mapped"] > 0 and out["mesh_shape"] == {"data": 2,
                                                              "idx": 4}


def test_measure_mesh_runs_in_turns_on_cpu(tmp_path):
    """The mesh timing script's runs on a small cut of its workload, with
    CPU devices standing in for cards: every run equals the first."""
    from gramtools_tpu_torch.common.workload import make_workload
    from gramtools_tpu_torch.parallel.measure_mesh import (mesh_devices,
                                                           mesh_runs)

    assert mesh_devices("3x1") == [torch.device("cuda", 0)] * 3
    assert mesh_devices("2") == [torch.device("cuda", 0),
                                 torch.device("cuda", 1)]
    idx, kidx, reads, _ = make_workload(tmp_path, genome_len=20_000,
                                        num_sites=200, n_reads=300)
    assert len(reads) == 300 and (tmp_path / "gram").is_dir()
    lines = []
    mesh_runs(["1", "2x1", "2"], idx, kidx, 10, 300, tmp_path,
              lines.append, kind="cpu")
    assert len(lines) == 3
    assert all("equal to the first run True" in l for l in lines)


def test_measure_mesh_one_device_turns_on_cpu(tmp_path):
    """The script's checkout mode: this checkout's single-device engine
    in a process of its own, on the CPU, twice; the first repeat of
    each process is dropped."""
    from gramtools_tpu_torch.common.workload import make_workload
    from gramtools_tpu_torch.parallel.measure_mesh import one_device_turns

    make_workload(tmp_path, genome_len=5_000, num_sites=40, n_reads=100)
    lines = []
    repo = str(Path(__file__).resolve().parent.parent)
    secs = one_device_turns([repo], tmp_path, 10, 1, 2, lines.append,
                            device="cpu")
    assert list(secs) == [repo] and len(secs[repo]) == 1
    assert secs[repo][0] > 0 and len(lines) == 1


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from gramtools_tpu_torch.common.timers import device_trace

    with device_trace(tmp_path / "trace") as prof:
        torch.arange(1000).cumsum(0)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert prof.key_averages()


def test_genotype_mesh_devices_without_gpus_raises(tmp_path, monkeypatch):
    from gramtools_tpu.cli import run as jax_cli
    from gramtools_tpu_torch.cli import run as torch_cli

    (tmp_path / "ref.fa").write_text(">r\nACGTACGTTTACGACACGTTCGT\n")
    (tmp_path / "v.vcf").write_text(
        "##fileformat=VCFv4.2\n##contig=<ID=r>\n#CHROM\tPOS\tID\tREF\tALT"
        "\tQUAL\tFILTER\tINFO\nr\t6\t.\tC\tG\t.\tPASS\t.\n")
    (tmp_path / "r.fq").write_text("@a\nACGTACGTTTACG\n+\nIIIIIIIIIIIII\n")
    assert jax_cli(["build", "--gram_dir", str(tmp_path / "gram"),
                    "--vcf", str(tmp_path / "v.vcf"), "--ref",
                    str(tmp_path / "ref.fa"), "--kmer_size", "3",
                    "--force"]) == 0
    monkeypatch.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GRAMTOOLS_TPU_MESH_DEVICES", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        torch_cli(["genotype", "--gram_dir", str(tmp_path / "gram"),
                   "--genotype_dir", str(tmp_path / "g"), "--reads",
                   str(tmp_path / "r.fq"), "--sample_id", "s",
                   "--engine", "device", "--force"])
    rep = json.loads((tmp_path / "g" / "genotype_report.json").read_text())
    assert not rep["success"]
    assert "2 CUDA devices" in "\n".join(
        rep["processes"]["genotype"]["traceback"])
