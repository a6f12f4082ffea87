"""The torch port imports no JAX and nothing of the JAX package, builds
no kernel and no native library when imported, and asks for its device
explicitly."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gramtools_tpu_torch
from gramtools_tpu_torch.common.device import get_device

REPO = Path(__file__).resolve().parent.parent


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        gramtools_tpu_torch.__path__, prefix="gramtools_tpu_torch."))


def test_port_modules_listed():
    mods = _port_modules()
    for name in ("gramtools_tpu_torch.cli",
                 "gramtools_tpu_torch.ops.rank",
                 "gramtools_tpu_torch.ops.replay",
                 "gramtools_tpu_torch.ops.walk",
                 "gramtools_tpu_torch.ops.wide_step",
                 "gramtools_tpu_torch.ops.locked_step",
                 "gramtools_tpu_torch.mapping.record",
                 "gramtools_tpu_torch.mapping.search_log",
                 "gramtools_tpu_torch.mapping.engine",
                 "gramtools_tpu_torch.mapping.quasimap",
                 "gramtools_tpu_torch.parallel.mesh",
                 "gramtools_tpu_torch.parallel.sharded_index",
                 "gramtools_tpu_torch.parallel.distributed",
                 "gramtools_tpu_torch.parallel.dryrun",
                 "gramtools_tpu_torch.parallel.measure_mesh",
                 "gramtools_tpu_torch.common.timers",
                 "gramtools_tpu_torch.common.workload",
                 "gramtools_tpu_torch.commands.genotype_command",
                 # the port's copies of the reference's host modules
                 "gramtools_tpu_torch.tools",
                 "gramtools_tpu_torch.commands.build_command",
                 "gramtools_tpu_torch.commands.discover_command",
                 "gramtools_tpu_torch.commands.simulate_command",
                 "gramtools_tpu_torch.commands.from_msas",
                 "gramtools_tpu_torch.commands.paths",
                 "gramtools_tpu_torch.commands.report",
                 "gramtools_tpu_torch.commands.seq_region_map",
                 "gramtools_tpu_torch.common.bgzf",
                 "gramtools_tpu_torch.common.cram",
                 "gramtools_tpu_torch.common.rng",
                 "gramtools_tpu_torch.common.sam",
                 "gramtools_tpu_torch.common.seq",
                 "gramtools_tpu_torch.common.vcf",
                 "gramtools_tpu_torch.discover.pileup",
                 "gramtools_tpu_torch.index.build",
                 "gramtools_tpu_torch.index.fm",
                 "gramtools_tpu_torch.index.kmer_index",
                 "gramtools_tpu_torch.index.kmer_index_vec",
                 "gramtools_tpu_torch.index.native",
                 "gramtools_tpu_torch.index.suffix_array",
                 "gramtools_tpu_torch.infer.allele_extracter",
                 "gramtools_tpu_torch.infer.gcp",
                 "gramtools_tpu_torch.infer.json_prg",
                 "gramtools_tpu_torch.infer.model",
                 "gramtools_tpu_torch.infer.personalised_ref",
                 "gramtools_tpu_torch.infer.probs",
                 "gramtools_tpu_torch.infer.runner",
                 "gramtools_tpu_torch.infer.segment_tracker",
                 "gramtools_tpu_torch.infer.types",
                 "gramtools_tpu_torch.infer.vcf_write",
                 "gramtools_tpu_torch.infer.vector_model",
                 "gramtools_tpu_torch.mapping.coverage",
                 "gramtools_tpu_torch.mapping.coverage_fast",
                 "gramtools_tpu_torch.mapping.jump_table",
                 "gramtools_tpu_torch.mapping.read_stats",
                 "gramtools_tpu_torch.mapping.search",
                 "gramtools_tpu_torch.prg.check_ref",
                 "gramtools_tpu_torch.prg.graph",
                 "gramtools_tpu_torch.prg.linearise",
                 "gramtools_tpu_torch.prg.markers",
                 "gramtools_tpu_torch.prg.msa",
                 "gramtools_tpu_torch.prg.vcf_to_prg"):
        assert name in mods


def test_importing_every_module_leaves_jax_out():
    """No jax, and no kernel built or loaded (nvcc runs at first launch
    only)."""
    code = ("import importlib, sys\n"
            f"for m in {['gramtools_tpu_torch'] + _port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m.split('.')[0] == 'gramtools_tpu')\n"
            "from gramtools_tpu_torch.ops import _build\n"
            "from gramtools_tpu_torch.index import native\n"
            "built = sorted(_build._LIBS) + sorted(_build.build_seconds)\n"
            "built += ['native'] if native._lib_tried else []\n"
            "print(bad, built)\n"
            "sys.exit(1 if bad or built else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_from_environment(monkeypatch):
    monkeypatch.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
    assert get_device() == torch.device("cpu")
    assert get_device("cpu").type == "cpu"


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.delenv("GRAMTOOLS_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        get_device()
    with pytest.raises(RuntimeError, match="cuda"):
        get_device("cuda:0")
