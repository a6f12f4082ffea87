"""The generators are deterministic per seed, and their truth matches
the paths they walk."""
import numpy as np
import pytest

from gpubench import generate

LUT = np.frombuffer(b"NACGT", np.uint8)


@pytest.mark.parametrize("profile", ["snp", "mixed"])
def test_graph_and_paths_repeat_for_a_seed(profile):
    a, ra = generate.make_graph(profile, 20000, 300, 11, 0.656)
    b, rb = generate.make_graph(profile, 20000, 300, 11, 0.656)
    assert np.array_equal(a, b)
    pa, ta, sa = generate.sample_haplotypes(a, ra, 3)
    pb, tb, sb = generate.sample_haplotypes(b, rb, 3)
    assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
    assert np.array_equal(ta, tb) and np.array_equal(sa, sb)
    c, _ = generate.make_graph(profile, 20000, 300, 12, 0.656)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("profile", ["snp", "mixed"])
@pytest.mark.parametrize("gc_share", [0.194, 0.5, 0.656])
def test_bases_follow_the_configured_gc_share(profile, gc_share):
    ints, _ = generate.make_graph(profile, 200000, 3000, 4, gc_share)
    ref = generate.reference_sequence(ints)
    counts = {b: ref.count(b) for b in "ACGT"}
    assert abs((counts["C"] + counts["G"]) / len(ref) - gc_share) < 0.005
    # strand-symmetric: A as often as T, C as often as G
    assert abs(counts["A"] - counts["T"]) < 0.01 * len(ref)
    assert abs(counts["C"] - counts["G"]) < 0.01 * len(ref)


@pytest.mark.parametrize("profile", ["snp", "mixed"])
def test_truth_spells_each_site_on_its_path(profile):
    ints, rng = generate.make_graph(profile, 20000, 300, 5, 0.194)
    paths, truth, spans = generate.sample_haplotypes(ints, rng, 4)
    allele_seqs = _allele_sequences(ints)
    level1 = generate.level1_sites(ints)
    for h, path in enumerate(paths):
        assert set(np.unique(path)) <= {1, 2, 3, 4}
        for s in level1:
            assert truth[h, s] >= 0
            a, b = spans[h, s]
            seq = LUT[path[a:b]].tobytes().decode()
            # a site's sequence starts with its allele's own bases
            assert seq.startswith(allele_seqs[s][truth[h, s]])


def _allele_sequences(ints):
    """The bases of each allele up to its first nested marker."""
    spans, _ = generate.site_spans(np.asarray(ints, dtype=np.int64))
    out = {}
    for m, sp in spans.items():
        seqs = []
        for lo, hi in sp:
            seg = ints[lo:hi]
            cut = np.flatnonzero(seg > 4)
            seg = seg[:cut[0]] if cut.size else seg
            seqs.append(LUT[seg].tobytes().decode())
        out[(m - 5) // 2] = seqs
    return out


def test_reads_repeat_for_a_seed_and_differ_across_seeds():
    path = np.random.RandomState(0).randint(1, 5, size=5000).astype(np.uint8)
    kw = dict(n_reads=500, read_len=150, revcomp_share=0.5, error_rate=0.01)
    a = generate.sample_reads(np.random.default_rng([2 ** 31 + 5, 0]), path, **kw)
    b = generate.sample_reads(np.random.default_rng([2 ** 31 + 5, 0]), path, **kw)
    c = generate.sample_reads(np.random.default_rng([2 ** 31 + 6, 0]), path, **kw)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.shape == (500, 150) and set(np.unique(a)) <= {1, 2, 3, 4}


def test_reads_are_the_path_or_its_reverse_complement_without_errors():
    path = np.random.RandomState(1).randint(1, 5, size=3000).astype(np.uint8)
    reads = generate.sample_reads(np.random.default_rng(3), path, 200, 50,
                                  0.5, 0.0)
    text = LUT[path].tobytes()
    flipped = 0
    for r in reads:
        fwd = LUT[r].tobytes()
        rev = LUT[(5 - r)[::-1]].tobytes()
        assert fwd in text or rev in text
        flipped += fwd not in text
    assert 60 < flipped < 140


def test_error_rate_substitutes_about_its_share():
    path = np.random.RandomState(2).randint(1, 5, size=3000).astype(np.uint8)
    clean = generate.sample_reads(np.random.default_rng(9), path, 2000, 150,
                                  0.0, 0.0)
    noisy = generate.sample_reads(np.random.default_rng(9), path, 2000, 150,
                                  0.0, 0.01)
    share = (clean != noisy).mean()
    assert 0.007 < share < 0.013
