"""What ``BENCHMARK.json`` and the files beside it say about a cell.

A cell ``<config>.<mix>`` is an entry of ``workloads``; its
configuration is ``configs/<config>.json``, its traffic mix
``traffic/<mix>.json``, and each per-layer metric that lists it (or
lists no cells) is read by ``metrics/<metric>.py``. Nothing here names
a cell, a mix or a metric: new ones are new files and entries.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    config_path: Path
    traffic: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json",
              base: Path = HERE) -> Cell:
    bench = json.loads(Path(bench_path).read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in {bench_path}")
    config_path = base / "configs" / f"{entry['config']}.json"
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=json.loads(config_path.read_text()),
        config_path=config_path,
        traffic=json.loads((base / "traffic" / f"{entry['traffic']}.json")
                           .read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str, base: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
