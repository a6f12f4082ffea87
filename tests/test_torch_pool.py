"""``--engine device --max_threads N`` in the port: the worker pool of
gramtools_tpu_torch/mapping/quasimap.py.

The pool spawns once CUDA is initialised (a forked child of a process
that holds a CUDA context cannot use it) and otherwise follows the
shared module's rule. With a pool the device engine takes the
non-pipelined path (search_buffer, then recording in the workers), as
in the JAX package. Its coverage must equal the host engine's with
either start method, and ``genotype --engine device --max_threads 2``
must write the same files, byte for byte, as the JAX package's device
engine with the same pool and as ``--engine host``. Exact equality.
"""
import numpy as np
import pytest
import torch

from gramtools_tpu.cli import run as run_jax_cli
from gramtools_tpu.index.build import build_prg_index
from gramtools_tpu.index.kmer_index_vec import build_kmer_index_vectorised
from gramtools_tpu.mapping import quasimap as shared
from gramtools_tpu.prg.linearise import PrgString, prg_string_to_ints
from gramtools_tpu_torch.cli import run as run_torch_cli
from gramtools_tpu_torch.mapping import quasimap as port_quasimap
from gramtools_tpu_torch.mapping.engine import LogBatchedEngine

from test_torch_genotype_e2e import (KMER, OUTPUT_FILES, SEED, _read,
                                     _vcf_body, _write_workload)


def test_pool_spawns_once_cuda_is_initialised(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(shared, "_pool_start_method", lambda: "fork")
    assert port_quasimap._pool_start_method() == "spawn"


@pytest.mark.parametrize("shared_rule", ["fork", "spawn"])
def test_pool_follows_shared_rule_without_cuda(shared_rule, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(shared, "_pool_start_method", lambda: shared_rule)
    assert port_quasimap._pool_start_method() == shared_rule


@pytest.mark.parametrize("method", ["fork", "spawn"])
def test_device_engine_with_pool_matches_host(method, tmp_path, monkeypatch):
    """quasimap_reads with the device engine (CPU) and two workers of
    each start method: the host engine's stats and coverage."""
    from test_locked_phase import _random_site_prg

    monkeypatch.setattr(port_quasimap, "_pool_start_method", lambda: method)
    rng = np.random.RandomState(4)
    prg_ints = prg_string_to_ints(_random_site_prg(rng, 2000, 40))
    dna = build_prg_index(PrgString(prg_ints)).prg
    dna = dna[(dna >= 1) & (dna <= 4)]
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as fh:
        for i, s in enumerate(rng.randint(0, dna.size - 60, size=300)):
            read = "".join("NACGT"[b] for b in dna[s:s + 60])
            fh.write(f"@r{i}\n{read}\n+\n{'I' * 60}\n")
    runs = []
    for engine in ("device", "host"):
        idx = build_prg_index(PrgString(prg_ints))
        kidx = build_kmer_index_vectorised(idx, 5)
        eng = (LogBatchedEngine(idx, 5, device="cpu") if engine == "device"
               else None)
        stats, cov = port_quasimap.quasimap_reads(
            [str(fq)], kidx, idx, 5, seed=7, engine=eng,
            max_threads=2 if engine == "device" else 1, buffer_size=100)
        runs.append((stats.as_dict(), cov.allele_sum, cov.grouped_counts,
                     idx.graph.coverage.copy(), eng))
    (d_stats, d_as, d_gc, d_pb, eng), (h_stats, h_as, h_gc, h_pb, _) = runs
    assert d_stats == h_stats and d_as == h_as and d_gc == h_gc
    np.testing.assert_array_equal(d_pb, h_pb)
    assert eng.device_mapped > 0
    # the pool takes the non-pipelined scan: no fused record program
    assert {s[0] for s in eng.dispatch_shapes} == {"packed"}


def _genotype(root, cli, name, engine, max_threads):
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
        mp.setenv("GRAMTOOLS_TPU_RANK", "packed")
        assert cli(["genotype", "--gram_dir", str(root / "gram"),
                    "--genotype_dir", str(root / name),
                    "--reads", str(root / "reads.fastq"),
                    "--sample_id", "s", "--seed", SEED,
                    "--engine", engine, "--max_threads", str(max_threads),
                    "--force"]) == 0
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def pool_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pool")
    _write_workload(root)
    assert run_jax_cli(["build", "--gram_dir", str(root / "gram"),
                        "--vcf", str(root / "vars.vcf"),
                        "--ref", str(root / "ref.fa"),
                        "--kmer_size", str(KMER), "--force"]) == 0
    _genotype(root, run_jax_cli, "host", "host", 1)
    _genotype(root, run_torch_cli, "torch_device", "device", 2)
    _genotype(root, run_jax_cli, "jax_device", "device", 2)
    return root


@pytest.mark.parametrize("other", ["jax_device", "host"])
@pytest.mark.parametrize("rel", OUTPUT_FILES)
def test_pool_output_files_equal(pool_runs, other, rel):
    assert _read(pool_runs / "torch_device" / rel) == _read(
        pool_runs / other / rel)


@pytest.mark.parametrize("other", ["jax_device", "host"])
def test_pool_vcf_equal(pool_runs, other):
    rel = "genotype/genotyped.vcf.gz"
    assert _vcf_body(pool_runs / "torch_device" / rel) == _vcf_body(
        pool_runs / other / rel)
