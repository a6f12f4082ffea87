"""The port's multi-process initialisation
(gramtools_tpu_torch/parallel/distributed.py). Mirrors
tests/test_distributed_init.py: ``init_distributed`` with the gloo
backend comes up with an explicit 1-process topology in a subprocess
(the process group is process-global state) and leaves the mesh
machinery working; without a cluster environment it logs a warning and
the single-process run goes on.
"""
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gramtools_tpu_torch.parallel import distributed

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import os, sys
os.environ["GRAMTOOLS_TORCH_DEVICE"] = "cpu"
import torch
import torch.distributed as dist
from gramtools_tpu_torch.parallel.distributed import (init_distributed,
                                                      is_coordinator)
init_distributed("tcp://localhost:{port}", num_processes=1, process_id=0)
assert dist.is_initialized() and dist.get_backend() == "gloo"
assert dist.get_world_size() == 1 and is_coordinator()
t = torch.arange(4, dtype=torch.int32)
dist.all_reduce(t)
assert t.tolist() == [0, 1, 2, 3]
from gramtools_tpu_torch.parallel.mesh import make_mesh
assert make_mesh(devices=["cpu"] * 4).devices.size == 4
dist.destroy_process_group()
print("DISTRIBUTED-OK", "jax" in sys.modules)
"""


RANK_SCRIPT = """
import os, sys
rank, world, device, port = sys.argv[1:5]
rank, world = int(rank), int(world)
os.environ["GRAMTOOLS_TORCH_DEVICE"] = device
import torch
import torch.distributed as dist
from gramtools_tpu_torch.parallel.distributed import (init_distributed,
                                                      is_coordinator)
init_distributed(f"tcp://localhost:{port}", num_processes=world,
                 process_id=rank)
t = torch.full((4,), rank + 1, dtype=torch.int32, device=device)
dist.all_reduce(t)
assert t.tolist() == [world * (world + 1) // 2] * 4, t.tolist()
assert is_coordinator() == (rank == 0)
print("RANK-OK", rank, dist.get_backend(), t.device)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(devices, timeout=120):
    """One process per device, each init_distributed with rank r of
    len(devices) and an all-reduce on its device. Returns each rank's
    (return code, stdout, stderr)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(len(devices)),
         str(d), str(port)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r, d in enumerate(devices)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_all_reduce_across_processes(world):
    """world processes on the CPU (gloo) come up together and
    all-reduce."""
    for rank, (rc, out, err) in enumerate(run_ranks(["cpu"] * world)):
        assert rc == 0, (rank, out, err)
        assert f"RANK-OK {rank} gloo cpu" in out


def test_init_distributed_single_process():
    port = _free_port()
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(port=port)],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "DISTRIBUTED-OK False" in out.stdout


def test_missing_cluster_environment_warns_and_goes_on(monkeypatch, caplog):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
    with caplog.at_level("WARNING", logger="gramtools_tpu"):
        distributed.init_distributed()
    assert not torch.distributed.is_initialized()
    assert "init_process_group failed/skipped" in caplog.text
    assert distributed.is_coordinator()


def test_backend_follows_the_engine_device(monkeypatch):
    monkeypatch.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
    assert distributed.backend_for_device() == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("GRAMTOOLS_TORCH_DEVICE", "cuda")
    assert distributed.backend_for_device() == "nccl"
