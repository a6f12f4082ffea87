"""The graph cache's key follows everything the builds read."""
import json
from pathlib import Path

from gpubench import graphs

HERE = Path(__file__).resolve().parent


def test_key_changes_with_a_build_source_and_the_config(tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"name": "c", "graph_seed": 1}))
    src = tmp_path / "prg" / "graph.py"
    src.parent.mkdir()
    src.write_text("A = 1\n")
    key = graphs.cache_key(cfg, [src])
    assert graphs.cache_key(cfg, [src]) == key
    src.write_text("A = 2\n")
    assert graphs.cache_key(cfg, [src]) != key
    src.write_text("A = 1\n")
    cfg.write_text(json.dumps({"name": "c", "graph_seed": 2}))
    assert graphs.cache_key(cfg, [src]) != key


def test_program_key_covers_the_port_build_sources():
    files = graphs._files(graphs.ROOT / graphs.PROGRAM,
                          graphs.PROGRAM_BUILD_SOURCES)
    rel = {str(f.relative_to(graphs.ROOT / graphs.PROGRAM)) for f in files}
    assert "commands/build_command.py" in rel
    assert "index/fm.py" in rel and "prg/graph.py" in rel
    assert any(r.startswith("native/") for r in rel)
    cfg = HERE / "data" / "configs" / "tiny_mixed.json"
    g = graphs.Graph(json.loads(cfg.read_text()), cfg)
    assert g.dir.name.startswith("tiny_mixed-")
    assert g.ref_index.name.startswith("tiny_mixed-reference-")
