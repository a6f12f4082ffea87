"""The port stands alone, and its copies equal the reference.

1. No module of ``gramtools_tpu_torch`` and not ``chip_smoke.py``
   imports ``gramtools_tpu`` or ``jax`` (nor the repository's
   ``bench.py``): an AST scan of every file.
2. A fresh process whose import system refuses ``gramtools_tpu`` and
   ``jax`` imports every module of the port, then runs the port's CLI
   ``build``, ``genotype --engine host``, ``genotype --engine device``
   (on the CPU) and ``simulate`` on a small graph that the port's own
   generators make.
3. On the same inputs, the port's ``build``, ``genotype`` (host engine;
   device engine with the dense rank and each recorder), ``simulate``
   and ``discover`` write the files that the JAX package's commands
   write: byte for byte, but for the VCF's ``##fileDate``, the arrays
   of the ``.npz`` indexes (compared array by array: a zip member
   carries its write time) and the run reports' timings and paths.
   The device runs are held to the reference's host engine;
   tests/test_torch_genotype_e2e.py holds them to its device engine.
"""
import ast
import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gramtools_tpu.cli import run as run_jax_cli
from gramtools_tpu_torch.cli import run as run_torch_cli

from test_torch_genotype_e2e import KMER, SEED, _write_workload

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "gramtools_tpu_torch"
PY_FILES = sorted(p.relative_to(REPO).as_posix()
                  for p in PORT.rglob("*.py") if "build" not in p.parts)
PY_FILES.append("chip_smoke.py")
REFUSED = ("gramtools_tpu", "jax", "jaxlib", "bench")


def _imported(tree):
    """Absolute module names imported anywhere in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", PY_FILES)
def test_no_reference_or_jax_import(rel):
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    bad = sorted(m for m in _imported(tree) if m.split(".")[0] in REFUSED)
    assert not bad, f"{rel} imports {bad}"


# --------------------------------------------------------------------------
# the port's CLI with the reference and JAX refused
# --------------------------------------------------------------------------

BLOCKED = r"""
import importlib, json, os, pkgutil, sys
from pathlib import Path

REFUSED = {refused!r}


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused: {{name}}")
        return None


sys.meta_path.insert(0, Refuse())
import numpy as np
import gramtools_tpu_torch

out = {{}}
names = [m.name for m in pkgutil.walk_packages(gramtools_tpu_torch.__path__,
                                               "gramtools_tpu_torch.")]
for name in names:
    importlib.import_module(name)
out["import"] = len(names)

from gramtools_tpu_torch.cli import run
from gramtools_tpu_torch.common.workload import (
    build_synthetic_mtb_graph, reference_sequence, sample_haplotypes,
    sample_reads, write_fastq)
from gramtools_tpu_torch.prg.linearise import PrgString

work = Path(sys.argv[1])
rng = np.random.RandomState(3)
ints = build_synthetic_mtb_graph(rng, 3000, 60)
prg = PrgString(ints)
prg.write(work / "prg.bin")
(work / "ref.fa").write_text(">ref\n" + reference_sequence(ints) + "\n")
paths = sample_haplotypes(ints, dict(prg.end_positions), rng, 4)
write_fastq(work / "reads.fq", sample_reads(rng, paths, 300, 60))
geno = ["genotype", "--gram_dir", str(work / "gram"), "--reads",
        str(work / "reads.fq"), "--sample_id", "s", "--seed", "5", "--force"]
os.environ["GRAMTOOLS_TORCH_DEVICE"] = "cpu"
steps = {{
    "build": ["build", "--gram_dir", str(work / "gram"), "--prg",
              str(work / "prg.bin"), "--ref", str(work / "ref.fa"),
              "--kmer_size", "7", "--force"],
    "genotype_host": geno + ["--genotype_dir", str(work / "host"),
                             "--engine", "host"],
    "genotype_device": geno + ["--genotype_dir", str(work / "device"),
                               "--engine", "device"],
    "simulate": ["simulate", "--prg", str(work / "gram" / "prg"), "-o",
                 str(work / "sim"), "-n", "3", "--seed", "2", "--force"],
}}
for step, argv in steps.items():
    out[step] = run(argv)
report = json.loads((work / "device" / "genotype_report.json").read_text())
out["device_mapped"] = report["processes"]["genotype"]["engine"][
    "device_mapped"]
out["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def blocked(tmp_path_factory):
    work = tmp_path_factory.mktemp("standalone")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("GRAMTOOLS_TPU_RANK", None)
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED.format(refused=REFUSED), str(work)],
        cwd=work, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), work


def test_blocked_process_loads_neither_reference_nor_jax(blocked):
    out, _ = blocked
    assert out["loaded"] == []
    assert out["import"] > 60          # every module of the port imported


@pytest.mark.parametrize("step", ["build", "genotype_host",
                                  "genotype_device", "simulate"])
def test_port_cli_runs_with_reference_and_jax_refused(blocked, step):
    out, work = blocked
    assert out[step] == 0
    produced = {"build": "gram/fm_index.npz",
                "genotype_host": "host/genotype/genotyped.json",
                "genotype_device": "device/genotype/genotyped.json",
                "simulate": "sim/sim.fasta"}[step]
    assert (work / produced).stat().st_size > 0
    if step == "genotype_device":
        assert out["device_mapped"] > 0


def test_blocked_process_device_and_host_files_equal(blocked):
    _, work = blocked
    for rel in ("genotype/genotyped.json", "coverage/allele_sum_coverage",
                "coverage/allele_base_coverage.json",
                "genotype/personalised_reference.fasta"):
        assert (work / "device" / rel).read_bytes() == (
            work / "host" / rel).read_bytes(), rel


# --------------------------------------------------------------------------
# the port's commands against the reference's, file by file
# --------------------------------------------------------------------------

# run reports: what differs between any two runs (timings, memory, the
# output paths)
_VOLATILE = {"run_time", "seconds", "peak_mem_mb", "total_runtime",
             "current_working_directory", "paths", "path_hashes"}


def _normalised(obj):
    if isinstance(obj, dict):
        return {k: _normalised(v) for k, v in obj.items()
                if k not in _VOLATILE}
    if isinstance(obj, list):
        return [_normalised(v) for v in obj]
    return obj


def _content(path: Path):
    """What of an output file must equal: bytes, VCF lines without
    ##fileDate, .npz arrays by name, reports without timings and
    paths."""
    if path.suffix == ".npz":
        with np.load(path) as z:
            return {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                    for k in z.files}
    if path.name.endswith("_report.json"):
        return _normalised(json.loads(path.read_text()))
    raw = (gzip.open(path, "rb").read() if path.suffix == ".gz"
           else path.read_bytes())
    if ".vcf" in path.name:
        return [l for l in raw.splitlines() if not l.startswith(b"##fileDate")]
    return raw


def _files(root: Path):
    """Relative paths of the regular files under root, not following the
    links a genotype directory keeps to its inputs."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if not os.path.islink(os.path.join(dirpath, d))]
        out += [os.path.relpath(os.path.join(dirpath, f), root)
                for f in filenames
                if not os.path.islink(os.path.join(dirpath, f))]
    return sorted(out)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """{command: (reference output dir, port output dir)} on one
    workload; the port's runs read the port's build, the reference's
    runs the reference's."""
    root = tmp_path_factory.mktemp("standalone_pairs")
    _write_workload(root)
    out = {}
    for tag, cli in (("jax", run_jax_cli), ("torch", run_torch_cli)):
        assert cli(["build", "--gram_dir", str(root / f"gram_{tag}"),
                    "--vcf", str(root / "vars.vcf"),
                    "--ref", str(root / "ref.fa"),
                    "--kmer_size", str(KMER), "--force"]) == 0
        assert cli(["genotype", "--gram_dir", str(root / f"gram_{tag}"),
                    "--genotype_dir", str(root / f"geno_{tag}"),
                    "--reads", str(root / "reads.fastq"),
                    "--sample_id", "s", "--seed", SEED, "--engine", "host",
                    "--force"]) == 0
        assert cli(["simulate", "--prg", str(root / f"gram_{tag}" / "prg"),
                    "-o", str(root / f"sim_{tag}"), "-n", "5",
                    "--seed", "3", "--force"]) == 0
        assert cli(["discover", "--genotype_dir", str(root / f"geno_{tag}"),
                    "--discovery_dir", str(root / f"disc_{tag}"),
                    "--force"]) == 0
    for cmd, name in (("build", "gram"), ("genotype", "geno"),
                      ("simulate", "sim"), ("discover", "disc")):
        out[cmd] = (root / f"{name}_jax", root / f"{name}_torch")
    for record in ("1", "0"):
        mp = pytest.MonkeyPatch()
        mp.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
        mp.setenv("GRAMTOOLS_TPU_RANK", "dense")
        mp.setenv("GRAMTOOLS_TPU_DEVICE_RECORD", record)
        try:
            assert run_torch_cli([
                "genotype", "--gram_dir", str(root / "gram_torch"),
                "--genotype_dir", str(root / f"device_dense_{record}"),
                "--reads", str(root / "reads.fastq"), "--sample_id", "s",
                "--seed", SEED, "--engine", "device", "--force"]) == 0
        finally:
            mp.undo()
        out[f"genotype_device_dense_record{record}"] = (
            root / "geno_jax", root / f"device_dense_{record}")
    return out


@pytest.mark.parametrize("command", [
    "build", "genotype", "simulate", "discover",
    "genotype_device_dense_record1", "genotype_device_dense_record0"])
def test_port_output_files_equal_reference(pairs, command):
    ref, port = pairs[command]
    files, port_files = _files(ref), _files(port)
    if command.startswith("genotype_device"):
        # the device engine's report carries its counters
        files.remove("genotype_report.json")
        port_files.remove("genotype_report.json")
    assert files and files == port_files
    for rel in files:
        assert _content(port / rel) == _content(ref / rel), rel
