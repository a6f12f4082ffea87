"""The harness finds cells, mixes and metrics by name from files alone."""
import json
import shutil
from pathlib import Path

from gpubench import spec

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent


def test_every_cell_of_the_benchmark_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.chips == w["chips"]
        assert {m["name"] for m in cell.end_to_end} >= {
            "setup_s", "quasimap_reads_per_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))


def test_config_files_state_their_cuts():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        # each cut is a key of the file, or is said in its `assumed`
        assert all(key in data or key in data["assumed"]
                   for key in c["reduced"])


def test_every_key_of_a_config_and_a_mix_is_read():
    """Configurations and mixes carry no knob that nothing reads: their
    keys are those the harness reads, or words for a reader."""
    read = {"name", "profile", "genome_len", "num_sites", "gc_share",
            "graph_seed", "haplotypes", "kmer_size", "limits"}
    words = {"source", "deployment", "reduced", "assumed", "guarantees"}
    for f in (ROOT / "gpubench" / "configs").glob("*.json"):
        assert set(json.loads(f.read_text())) <= read | words, f.name
    mix = {"read_len", "error_rate", "revcomp_share", "reads_per_file",
           "files", "genotype"}
    for f in (ROOT / "gpubench" / "traffic").glob("*.json"):
        assert set(json.loads(f.read_text())) == mix, f.name


def test_a_dropped_in_cell_mix_and_metric_are_found(tmp_path):
    base = tmp_path / "gpubench"
    shutil.copytree(HERE / "data", base)
    shutil.copytree(ROOT / "gpubench" / "metrics", base / "metrics")
    cfg = json.loads((base / "configs" / "tiny_mixed.json").read_text())
    cfg["name"] = "tiny_other"
    (base / "configs" / "tiny_other.json").write_text(json.dumps(cfg))
    (base / "traffic" / "burst.json").write_text(json.dumps(
        {"read_len": 100, "error_rate": 0.01, "revcomp_share": 0.5,
         "reads_per_file": 10, "files": 1, "genotype": None}))
    (base / "metrics" / "reads_seen.py").write_text(
        "def read(run):\n    return float(run['buffers'])\n")
    bench = json.loads((base / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny_other.burst",
                               "config": "tiny_other", "traffic": "burst",
                               "chips": 1, "why": "added by files alone"})
    bench["per_layer"].append({"name": "reads_seen", "unit": "buffers",
                               "better": "higher", "source": "host_clock",
                               "layer": "driver", "moves": "quasimap_reads_per_s",
                               "workloads": ["tiny_other.burst"]})
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("tiny_other.burst", base / "BENCHMARK.json", base)
    assert cell.config["name"] == "tiny_other"
    assert cell.traffic["read_len"] == 100
    names = [m["name"] for m in cell.per_layer]
    assert "reads_seen" in names
    assert spec.metric_reader("reads_seen", base)({"buffers": 3}) == 3.0
    # the metric lists its cell: the rehearsal cell does not get it
    other = spec.load_cell("tiny_mixed.tiny", base / "BENCHMARK.json", base)
    assert "reads_seen" not in [m["name"] for m in other.per_layer]
    # genotype_s lists its cells; the new cell reports no genotyping
    assert "genotype_s" not in [m["name"] for m in cell.end_to_end]
