"""The plain reference agrees with the port's host engine (the scalar
path of ``quasimap_reads``, no device engine) on a tiny mixed graph on
the CPU: the kmer set, the stats and every coverage count."""
import os
from pathlib import Path

import numpy as np
import pytest

from gpubench import generate
from gpubench.reference import quasimap as ref_quasimap
from gpubench.reference.kmer_states import states_at
from gpubench.tests.kmer_paths import kmer_table
from gpubench.reference.search import search_pattern


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    os.environ["GRAMTOOLS_TORCH_DEVICE"] = "cpu"
    from gramtools_tpu_torch.cli import run as cli
    from gramtools_tpu_torch.index.build import load_all
    from gramtools_tpu_torch.prg.linearise import PrgString

    w = tmp_path_factory.mktemp("tiny")
    ints, rng = generate.make_graph("mixed", 30000, 800, 3, 0.194)
    paths, _, _ = generate.sample_haplotypes(ints, rng, 4)
    PrgString(ints).write(w / "prg.bin")
    (w / "ref.fa").write_text(">ref\n" + generate.reference_sequence(ints)
                              + "\n")
    assert cli(["build", "--gram_dir", str(w / "gram"), "--prg",
                str(w / "prg.bin"), "--ref", str(w / "ref.fa"),
                "--kmer_size", "10", "--force"]) == 0
    reads = generate.sample_reads(np.random.default_rng(2 ** 31 + 3),
                                  paths[1], 1500, 150, 0.5, 0.003)
    generate.write_fastq(w / "reads.fq", reads)
    ref_quasimap.build_index(w / "prg.bin", 10, w / "refidx")
    idx, kmer_index = load_all(w / "gram")
    return w, ints, idx, kmer_index


def test_kmer_set_equals_the_ports_kmer_index(tiny):
    _, ints, _, kmer_index = tiny
    table = kmer_table(ints, 10)
    assert np.array_equal(np.flatnonzero(table),
                          np.sort(kmer_index.codes.astype(np.int64)))


def test_kmer_states_equal_the_plain_backward_search(tiny):
    """The frozen numpy builder's states of each kmer are the scalar
    search's (``search.search_pattern``) on the reference's own index."""
    w, ints, _, _ = tiny
    idx, table, states = ref_quasimap.load_index(w / "prg.bin", w / "refidx",
                                                 10)
    codes = states["codes"].astype(np.int64)
    assert np.array_equal(codes, np.flatnonzero(kmer_table(ints, 10)))
    assert np.array_equal(np.flatnonzero(table), codes)
    rng = np.random.default_rng(4)
    for pos in rng.choice(codes.size, size=300, replace=False):
        code = int(codes[pos])
        kmer = np.array([(code >> (2 * (9 - i))) & 3 for i in range(10)],
                        dtype=np.uint8) + 1
        want = search_pattern(kmer, idx)
        assert sorted(map(_key, states_at(states, pos))) == \
            sorted(map(_key, want))


def _key(s):
    return (s.lo, s.hi, s.traversed, s.traversing)


@pytest.mark.parametrize("buffer_size", [20000, 400])
def test_reference_equals_the_ports_host_path(tiny, buffer_size):
    from gramtools_tpu_torch.mapping.quasimap import quasimap_reads

    w, _, idx, kmer_index = tiny
    seed = 2 ** 31 + 17
    idx.graph.coverage[:] = 0
    stats, cov = quasimap_reads([str(w / "reads.fq")], kmer_index, idx, 10,
                                seed=seed, buffer_size=buffer_size)
    ref = ref_quasimap.map_file(w / "reads.fq", w / "prg.bin", w / "refidx",
                                10, seed, buffer_size, workers=2)
    assert stats.as_dict() == ref.stats
    assert ref.stats["exact_mapped_reads_count"] > 700
    assert ref.stats["missing_kmer_reads_count"] > 0
    assert cov.allele_sum == ref.allele_sum
    assert cov.grouped_counts == ref.grouped
    pb = ref_quasimap.per_base_by_position(idx.graph, idx.prg)
    assert pb.sum() > 0 and np.array_equal(pb, ref.per_base)
