"""What the benchmark imports: never JAX or the JAX package, and the
reference nothing of the measured program. Top-level names are
compared whole (``gramtools_tpu_torch`` is not ``gramtools_tpu``)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "gramtools_tpu", "bench"}


def _top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(base: Path):
    return sorted(p for p in base.rglob("*.py") if "cache" not in p.parts)


@pytest.mark.parametrize("path", _sources(BENCH),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not _top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", _sources(BENCH / "reference"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert "gramtools_tpu_torch" not in names
    assert names <= {"__future__", "dataclasses", "typing", "numpy",
                     "multiprocessing", "pathlib", "json"}


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import gramtools_tpu_torch.cli\nfrom jax import numpy\n"
                 "import benchmarks\n")
    assert _top_level_imports(f) & BANNED == {"jax"}
