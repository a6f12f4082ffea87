"""The torch port imports no JAX, builds no kernel when imported, and
asks for its device explicitly."""
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
                 "gramtools_tpu_torch.commands.genotype_command"):
        assert name in mods


def test_importing_every_module_leaves_jax_out():
    """No jax, and no kernel built or loaded (nvcc runs at first launch
    only)."""
    code = ("import importlib, sys\n"
            f"for m in {['gramtools_tpu_torch'] + _port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
            "from gramtools_tpu_torch.ops import _build\n"
            "built = sorted(_build._LIBS) + sorted(_build.build_seconds)\n"
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
