"""`genotype --engine device` of the torch port, end to end on the CPU.

On a generated reference + VCF + 2,000 reads, the port's genotype run
(``GRAMTOOLS_TORCH_DEVICE=cpu``, packed rank) must write the same
files, byte for byte, as the JAX package's device engine in the same
configuration (packed rank, the jnp rank twin on the CPU) and as the
scalar host engine; and its engine counters must equal the JAX
engine's. Both engine configurations are held so: the fused device
recorder (the default, ``GRAMTOOLS_TPU_DEVICE_RECORD=1``; the ``_fused``
tests) and the host recorder (``GRAMTOOLS_TPU_DEVICE_RECORD=0``). Exact
equality throughout. The port's runs read the port's own build of the
inputs, the JAX package's runs the JAX package's
(tests/test_torch_standalone.py holds the two builds equal).
"""
import gzip
import json

import numpy as np
import pytest

from gramtools_tpu.cli import run as run_jax_cli
from gramtools_tpu_torch.cli import run as run_torch_cli

GENOME_LEN = 4000
N_READS = 2000
READ_LEN = 80
KMER = 7
SEED = "13"

OUTPUT_FILES = ("genotype/genotyped.json",
                "coverage/allele_sum_coverage",
                "coverage/grouped_allele_counts_coverage.json",
                "coverage/allele_base_coverage.json",
                "genotype/personalised_reference.fasta")


def _write_workload(root):
    """Random reference, a VCF of SNPs and short indels, and reads
    sampled from the reference and from an all-alt haplotype."""
    rng = np.random.RandomState(5)
    acgt = np.array(list("ACGT"))
    ref = acgt[rng.randint(0, 4, size=GENOME_LEN)]
    positions = np.arange(60, GENOME_LEN - 60, 45)
    records = []
    alt_hap = []
    prev = 0
    for i, p in enumerate(positions):
        kind = i % 5
        r = "".join(ref[p:p + 3]) if kind == 3 else ref[p]
        if kind == 3:          # deletion of two bases
            a = ref[p]
        elif kind == 4:        # insertion of three bases
            a = ref[p] + "".join(acgt[rng.randint(0, 4, size=3)])
        else:                  # SNP
            a = "ACGT"[("ACGT".index(ref[p]) + 1 + kind) % 4]
        records.append(f"chr1\t{p + 1}\t.\t{r}\t{a}\t.\tPASS\t.\n")
        alt_hap.append("".join(ref[prev:p]) + a)
        prev = p + len(r)
    alt_hap.append("".join(ref[prev:]))
    haps = ["".join(ref), "".join(alt_hap)]
    (root / "ref.fa").write_text(
        ">chr1\n" + "".join("".join(ref[i:i + 60]) + "\n"
                            for i in range(0, GENOME_LEN, 60)))
    (root / "vars.vcf").write_text(
        "##fileformat=VCFv4.2\n##contig=<ID=chr1>\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n" + "".join(records))
    with open(root / "reads.fastq", "w") as fh:
        for i in range(N_READS):
            h = haps[i % 2] if i % 3 else haps[0]
            s = rng.randint(0, len(h) - READ_LEN)
            fh.write(f"@r{i}\n{h[s:s + READ_LEN]}\n+\n{'I' * READ_LEN}\n")


def _gram(cli):
    """Each package's build of the workload."""
    return "gram_torch" if cli is run_torch_cli else "gram"


def _build(root, cli):
    assert cli(["build", "--gram_dir", str(root / _gram(cli)),
                "--vcf", str(root / "vars.vcf"),
                "--ref", str(root / "ref.fa"),
                "--kmer_size", str(KMER), "--force"]) == 0


def _genotype(root, cli, name, engine, device_record):
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
        mp.setenv("GRAMTOOLS_TPU_RANK", "packed")
        mp.setenv("GRAMTOOLS_TPU_DEVICE_RECORD", device_record)
        assert cli(["genotype", "--gram_dir", str(root / _gram(cli)),
                    "--genotype_dir", str(root / name),
                    "--reads", str(root / "reads.fastq"),
                    "--sample_id", "s", "--seed", SEED,
                    "--engine", engine, "--force"]) == 0
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """The built graph and the host engine's run (the oracle)."""
    root = tmp_path_factory.mktemp("torch_e2e")
    _write_workload(root)
    _build(root, run_jax_cli)
    _build(root, run_torch_cli)
    _genotype(root, run_jax_cli, "host", "host", "0")
    return root


@pytest.fixture(scope="module")
def runs(workload):
    """Both device engines with the host recorder."""
    _genotype(workload, run_torch_cli, "torch_device", "device", "0")
    _genotype(workload, run_jax_cli, "jax_device", "device", "0")
    return workload


@pytest.fixture(scope="module")
def runs_fused(workload):
    """Both device engines with the fused device recorder (the
    default); their directories are named like ``runs``' under
    ``fused/``, beside a link to the host run."""
    root = workload / "fused"
    root.mkdir()
    (root / "gram").symlink_to(workload / "gram")
    (root / "gram_torch").symlink_to(workload / "gram_torch")
    (root / "host").symlink_to(workload / "host")
    (root / "reads.fastq").symlink_to(workload / "reads.fastq")
    _genotype(root, run_torch_cli, "torch_device", "device", "1")
    _genotype(root, run_jax_cli, "jax_device", "device", "1")
    return root


def _read(path):
    if path.suffix == ".gz":
        with gzip.open(path, "rt") as fh:
            return fh.read()
    return path.read_text()


def _vcf_body(path):
    return [l for l in _read(path).splitlines()
            if not l.startswith("##fileDate")]


def _engine_report(root, name):
    rep = json.loads((root / name / "genotype_report.json").read_text())
    return rep["processes"]["genotype"]["engine"]


@pytest.mark.parametrize("other", ["jax_device", "host"])
@pytest.mark.parametrize("rel", OUTPUT_FILES)
def test_output_files_equal(runs, other, rel):
    assert _read(runs / "torch_device" / rel) == _read(runs / other / rel)


@pytest.mark.parametrize("other", ["jax_device", "host"])
def test_vcf_equal(runs, other):
    rel = "genotype/genotyped.vcf.gz"
    assert _vcf_body(runs / "torch_device" / rel) == _vcf_body(
        runs / other / rel)


def test_engine_counters_equal_jax(runs):
    got = _engine_report(runs, "torch_device")
    assert got == _engine_report(runs, "jax_device")
    assert got["device_mapped"] > 0


@pytest.mark.parametrize("other", ["jax_device", "host"])
@pytest.mark.parametrize("rel", OUTPUT_FILES)
def test_output_files_equal_fused(runs_fused, other, rel):
    assert _read(runs_fused / "torch_device" / rel) == _read(
        runs_fused / other / rel)


@pytest.mark.parametrize("other", ["jax_device", "host"])
def test_vcf_equal_fused(runs_fused, other):
    rel = "genotype/genotyped.vcf.gz"
    assert _vcf_body(runs_fused / "torch_device" / rel) == _vcf_body(
        runs_fused / other / rel)


def test_engine_counters_equal_jax_fused(runs_fused):
    got = _engine_report(runs_fused, "torch_device")
    assert got == _engine_report(runs_fused, "jax_device")
    assert got["device_mapped"] > 0


def _keys(obj):
    """The key tree of a JSON value: a dict's keys, each with its
    value's key tree; a list's items' key trees."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return None


@pytest.mark.parametrize("fused", [False, True])
def test_report_keys_equal_jax(runs, runs_fused, fused):
    """The port's genotype_report.json has the reference's keys at every
    level, and no more."""
    root = runs_fused if fused else runs
    got, want = (json.loads((root / name / "genotype_report.json")
                            .read_text())
                 for name in ("torch_device", "jax_device"))
    assert _keys(got) == _keys(want)
    assert "engine" in got["processes"]["genotype"]


def test_fused_and_host_recorder_outputs_equal(runs, runs_fused):
    """The two recorders of the port write the same files."""
    for rel in OUTPUT_FILES:
        assert _read(runs / "torch_device" / rel) == _read(
            runs_fused / "torch_device" / rel), rel


def test_device_engine_refuses_worker_pool(runs, monkeypatch):
    """The device engine no longer refuses a worker pool: with
    ``--max_threads 2`` it runs (mapping/quasimap.py) and writes the
    host engine's files (tests/test_torch_pool.py holds it to the JAX
    package as well). The pool spawns, since a JAX backend is live in
    this process."""
    from gramtools_tpu_torch.mapping import quasimap as port_quasimap

    monkeypatch.setattr(port_quasimap, "_pool_start_method", lambda: "spawn")
    monkeypatch.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
    assert run_torch_cli(["genotype", "--gram_dir",
                          str(runs / "gram_torch"),
                          "--genotype_dir", str(runs / "pool"),
                          "--reads", str(runs / "reads.fastq"),
                          "--sample_id", "s", "--seed", SEED,
                          "--engine", "device", "--max_threads", "2",
                          "--force"]) == 0
    rep = json.loads((runs / "pool" / "genotype_report.json").read_text())
    assert rep["success"]
    assert rep["processes"]["genotype"]["engine"]["device_mapped"] > 0
    for rel in OUTPUT_FILES:
        assert _read(runs / "pool" / rel) == _read(runs / "host" / rel), rel


def test_auto_engine_follows_cuda(monkeypatch):
    import torch

    from gramtools_tpu_torch.commands.genotype_command import resolve_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_engine("auto") == "host"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_engine("auto") == "device"
    assert resolve_engine("host") == "host"
