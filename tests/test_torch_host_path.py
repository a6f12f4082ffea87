"""The port's host-side builders and index files against the JAX
package's: the coverage graph (every node, edge, map and random-access
table, in order), the index's ``.npz`` files (read back array for array)
and the kmer index's lookups (each against a scan of its code table).
"""
import numpy as np
import pytest

from gramtools_tpu.prg.graph import build_cov_graph as j_build_cov_graph
from gramtools_tpu.prg.linearise import PrgString as JPrgString
from gramtools_tpu.prg.linearise import prg_string_to_ints
from gramtools_tpu_torch.common.workload import build_synthetic_mtb_graph
from gramtools_tpu_torch.index.build import build_prg_index
from gramtools_tpu_torch.index.fm import save_npz
from gramtools_tpu_torch.index.kmer_index_vec import (
    ArrayKmerIndex, build_kmer_index_vectorised)
from gramtools_tpu_torch.prg.graph import build_cov_graph
from gramtools_tpu_torch.prg.linearise import PrgString

from test_search_jax import HARD_NESTED_PRGS, random_prg

PRGS = {
    "biallelic": lambda: build_synthetic_mtb_graph(
        np.random.RandomState(3), 2000, 40),
    "nested": lambda: prg_string_to_ints(
        random_prg(np.random.RandomState(4), num_sites=24, nested=True)),
    "hard": lambda: prg_string_to_ints(
        "ACG" + "TT".join(HARD_NESTED_PRGS) + "CA"),
}


def _graph_key(g):
    nodes = [(n.idx, n.pos, n.site_id, n.allele_id, n.is_boundary,
              n.seq.dtype.str, n.seq.tobytes(), list(n.edges), n.cov_start)
             for n in g.nodes]
    tables = [(a.dtype.str, a.tobytes()) for a in (
        g.ra_node, g.ra_offset, g.ra_target_site, g.ra_target_allele,
        g.coverage)]
    return (nodes, tables, g.root, g.sink, g.bubbles, list(g.par_map.items()),
            list(g.target_map.items()), g.is_nested)


@pytest.mark.parametrize("name", sorted(PRGS))
def test_cov_graph_equals_reference(name):
    ints = np.asarray(PRGS[name]())
    got = build_cov_graph(PrgString(ints))
    want = j_build_cov_graph(JPrgString(ints))
    assert _graph_key(got) == _graph_key(want)


def test_index_files_read_back_array_for_array(tmp_path):
    arrays = {"codes": np.arange(7, dtype=np.uint32) * 3,
              "trav": np.arange(24, dtype=np.int32).reshape(3, 4, 2),
              "kmer_size": np.int32(5)}
    save_npz(tmp_path / "index", **arrays)
    with np.load(tmp_path / "index.npz") as z:
        assert sorted(z.files) == sorted(arrays)
        for name, a in arrays.items():
            assert z[name].dtype == np.asarray(a).dtype
            np.testing.assert_array_equal(z[name], a)


@pytest.mark.parametrize("name", sorted(PRGS))
def test_kmer_lookup_equals_scan(name, tmp_path):
    idx = build_prg_index(PrgString(np.asarray(PRGS[name]())))
    built = build_kmer_index_vectorised(idx, 4)
    built.save(tmp_path / "kmer_index.npz")
    ki = ArrayKmerIndex.load(tmp_path / "kmer_index.npz")
    for name_ in ("codes", "offsets", "lo", "hi", "trav", "ing"):
        np.testing.assert_array_equal(getattr(ki, name_),
                                      getattr(built, name_))
    codes = ki.codes.astype(np.int64)
    for code in range(4 ** 4):
        want = np.flatnonzero(codes == code)
        assert ki._find(code) == (int(want[0]) if want.size else -1)
    kmer = np.array([1, 2, 3, 4], dtype=np.uint8)
    states = ki.get(kmer.tobytes(), [])
    pos = ki._find(ki.encode_kmer(kmer))
    assert len(states) == (0 if pos < 0 else
                           int(ki.offsets[pos + 1] - ki.offsets[pos]))
