"""The port's engine in its fused mode (the default) on the CPU, against
the scalar host engine and the JAX engine's fused mode.

Mirrors tests/test_record_jax.py (retry pass, heavy host fallback, seed
sweep) and the fallback-rate gate of tests/test_record_budgets.py:
coverage, stats, counters and ``fallback_reasons`` must be equal, the
rates under their limits. Exact equality throughout.
"""
import numpy as np
import pytest

from gramtools_tpu.common.rng import RandomInclusiveInt, first_raw_draws
from gramtools_tpu.index.build import build_prg_index
from gramtools_tpu.index.kmer_index_vec import build_kmer_index_vectorised
from gramtools_tpu.mapping import search_jax_log as jsl
from gramtools_tpu.mapping.coverage import Coverage
from gramtools_tpu.mapping.quasimap import QuasimapStats, quasimap_reads
from gramtools_tpu.prg.linearise import PrgString, prg_string_to_ints
from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
from gramtools_tpu_torch.mapping.search_log_host import LogConfig

from test_locked_phase import _random_site_prg
from test_record_jax import PRG, _run_scalar, _sampled_reads, _write_reads


def _run(make_engine, prg_str, reads, k, seed, tmp_path, buffer_size=None):
    idx = build_prg_index(PrgString(prg_string_to_ints(prg_str)))
    fq = _write_reads(str(tmp_path), reads)
    engine = make_engine(idx)
    stats, cov = quasimap_reads([fq], build_kmer_index_vectorised(idx, k),
                                idx, k, seed=seed, engine=engine,
                                buffer_size=buffer_size)
    assert engine.cov_diff is None          # flushed exactly once
    assert any(s[0] == "record" for s in engine.dispatch_shapes)
    return stats, cov, idx.graph.coverage.copy(), engine


def _torch(cfg):
    def make(idx):
        engine = LogBatchedEngine(idx, 3, cfg, device="cpu")
        assert engine.device_record
        return engine
    return make


def _assert_same_coverage(a, b):
    st_a, cov_a, pb_a = a[:3]
    st_b, cov_b, pb_b = b[:3]
    assert st_a.as_dict() == st_b.as_dict()
    assert cov_a.allele_sum == cov_b.allele_sum
    assert cov_a.grouped_counts == cov_b.grouped_counts
    np.testing.assert_array_equal(pb_a, pb_b)


def test_fused_record_with_retry_matches_scalar(tmp_path, monkeypatch):
    """Tiny pool/hits: the scan overflows, and the fused retry pass
    records the overflowed rows on the device, identically."""
    monkeypatch.setenv("GRAMTOOLS_TPU_RETRY_MIN", "1")
    reads = _sampled_reads(np.random.RandomState(3), 40)
    got = _run(_torch(LogConfig(pool=64, hits=4)), PRG, reads, 3, 17,
               tmp_path)
    assert got[3].device_retried > 0
    _assert_same_coverage(got, _run_scalar(PRG, reads, 3, 17))


def test_fused_record_heavy_fallback_matches_scalar(tmp_path, monkeypatch):
    """Retry off: overflowed rows go straight to the exact host path;
    device and host contributions stay disjoint."""
    monkeypatch.setenv("GRAMTOOLS_TPU_RETRY_MIN", "100000")
    reads = _sampled_reads(np.random.RandomState(11), 40)
    got = _run(_torch(LogConfig(pool=48, hits=4)), PRG, reads, 3, 23,
               tmp_path)
    assert got[3].host_fallbacks > 0
    _assert_same_coverage(got, _run_scalar(PRG, reads, 3, 23))


@pytest.mark.parametrize("seed", range(6))
def test_fused_record_seed_sweep(seed, tmp_path):
    """The selection pick on the device equals the scalar engine's for
    every seed."""
    reads = _sampled_reads(np.random.RandomState(7), 25)
    got = _run(_torch(LogConfig(pool=256, hits=64)), PRG, reads, 3, seed,
               tmp_path)
    _assert_same_coverage(got, _run_scalar(PRG, reads, 3, seed))


@pytest.mark.parametrize("pool,hits", [(64, 4), (4096, 16)])
def test_pipelined_fused_buffers_match_jax_engine(pool, hits, tmp_path,
                                                  monkeypatch):
    """Several buffers, scan_submit of buffer N+1 before record_complete
    of buffer N, retries recorded on the device into the same cov_diff:
    coverage, stats, counters and fallback_reasons equal the JAX
    engine's fused mode."""
    monkeypatch.setenv("GRAMTOOLS_TPU_RETRY_MIN", "1")
    rng = np.random.RandomState(9)
    prg_str = _random_site_prg(rng, 2000, 50)
    dna = build_prg_index(PrgString(prg_string_to_ints(prg_str))).prg
    dna = dna[(dna >= 1) & (dna <= 4)].astype(np.uint8)
    reads = [dna[s:s + 50].copy()
             for s in rng.randint(0, dna.size - 50, size=300)]
    runs = {}
    for name, make in (
            ("torch", lambda idx: LogBatchedEngine(
                idx, 5, LogConfig(pool=pool, hits=hits), device="cpu")),
            ("jax", lambda idx: jsl.LogBatchedEngine(
                idx, 5, jsl.LogConfig(pool=pool, hits=hits)))):
        (tmp_path / name).mkdir()
        runs[name] = _run(make, prg_str, reads, 5, 3, tmp_path / name,
                          buffer_size=100)
    t, j = runs["torch"], runs["jax"]
    _assert_same_coverage(t, j)
    for name in ("device_mapped", "host_fallbacks", "device_retried",
                 "hits_boost", "fallback_reasons"):
        assert getattr(t[3], name) == getattr(j[3], name), name
    assert {s[:4] for s in t[3].dispatch_shapes} == {
        s[:4] for s in j[3].dispatch_shapes}
    assert t[3].device_mapped > 0


def test_fallback_rate_at_production_density():
    """The port's fused engine at the production site density (1 site /
    44 bp, 150 bp reads): budget spills < 2%, host fallbacks < 5%,
    device-mapped > 95% of the mappable rows, and the same
    fallback_reasons as the JAX engine."""
    from bench import build_synthetic_mtb_graph, sample_haplotypes, \
        sample_reads

    rng = np.random.RandomState(5)
    prg_ints = build_synthetic_mtb_graph(rng, 120_000, 2700)
    prg = PrgString(prg_ints.astype(np.uint32))
    k = 10
    paths = sample_haplotypes(prg_ints, dict(prg.end_positions), rng, 4)
    n_reads = 768
    reads = sample_reads(rng, paths, n_reads, 150)
    seeds = RandomInclusiveInt(42).raw_block(n_reads)
    frs = first_raw_draws(np.asarray(seeds, dtype=np.uint32))
    engines = {}
    for name, make in (("torch", lambda idx: LogBatchedEngine(
            idx, k, device="cpu")), ("jax", lambda idx: jsl.LogBatchedEngine(
                idx, k))):
        idx = build_prg_index(prg)
        kmer_index = build_kmer_index_vectorised(idx, k)
        engine = make(idx)
        stats = QuasimapStats()
        tok = engine.scan_submit([reads[i] for i in range(n_reads)],
                                 kmer_index, k, stats, first_raws=frs)
        engine.record_complete(tok, seeds, frs, stats, Coverage.empty(idx))
        engines[name] = engine
    engine = engines["torch"]
    mappable = engine.device_mapped + engine.host_fallbacks
    assert mappable >= n_reads
    budget_spills = sum(v for r, v in engine.fallback_reasons.items()
                        if r.startswith("record:"))
    assert budget_spills < 0.02 * mappable, dict(engine.fallback_reasons)
    assert engine.host_fallbacks < 0.05 * mappable, \
        dict(engine.fallback_reasons)
    assert engine.device_mapped > 0.95 * mappable
    assert engine.fallback_reasons == engines["jax"].fallback_reasons
    assert engine.device_mapped == engines["jax"].device_mapped
