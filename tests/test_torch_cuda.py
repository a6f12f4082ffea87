"""The port on a CUDA device: the packed-rank (K1), genealogy-replay
(K7), wide-step (K2) and narrow-tail (K3: hole-allocated and locked
steps) kernels and the per-base recorder's kernels (K9) against their
plain torch versions (K3's barrier-free locked range also on the cases
its chained scans must get right, and over repeated launches; K2 and K3
decoding packed reads, K6; the index-sharded scan's round kernels, K10),
the scan and the fused record program on CUDA against the CPU, the
engine against the host oracle, the mesh engine and the index-sharded
scan on one card and, where the machine has two cards or more, across
cards (with an NCCL all-reduce between processes). Every test is
marked ``cuda`` and skips without a GPU (the across-card ones also
with one card).

This file imports no JAX (the GPU machine has none), so it also runs
there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gramtools_tpu_torch.common.rng import RandomInclusiveInt, first_raw_draws
from gramtools_tpu_torch.common.seq import revcomp
from gramtools_tpu_torch.index.build import build_prg_index
from gramtools_tpu_torch.index.fm import FMIndex
from gramtools_tpu_torch.index.kmer_index import build_kmer_index
from gramtools_tpu_torch.index.kmer_index_vec import build_kmer_index_vectorised
from gramtools_tpu_torch.mapping.quasimap import (QuasimapStats,
                                                  all_read_kmers_in_index,
                                                  quasimap_reads)
from gramtools_tpu_torch.mapping.search import search_read_backwards
from gramtools_tpu_torch.prg.linearise import PrgString, prg_string_to_ints
from gramtools_tpu_torch.mapping import engine as engine_mod
from gramtools_tpu_torch.mapping.device_index import DeviceIndex
from gramtools_tpu_torch.mapping import record
from gramtools_tpu_torch.mapping.engine import LogBatchedEngine, _to_device
from gramtools_tpu_torch.mapping.record import RecordTables, SeedTables
from gramtools_tpu_torch.mapping.search_log import (log_search_packed,
                                                    log_search_record)
from gramtools_tpu_torch.mapping.search_log_host import (FB_EMIT, FB_WALK,
                                                         TCAP, LogConfig,
                                                         buffer_caps)
from gramtools_tpu_torch.ops import locked_step, rank, replay, walk, wide_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _site_prg(rng, genome_len, num_sites):
    seq = rng.choice(list("ACGT"), size=genome_len)
    pos = np.sort(rng.choice(np.arange(10, genome_len - 10), size=num_sites,
                             replace=False))
    parts, prev = [], 0
    for p in pos:
        parts.append("".join(seq[prev:p]))
        alt = "ACGT"[("ACGT".index(seq[p]) + 1) % 4]
        parts.append(f"[{seq[p]},{alt}]")
        prev = p + 1
    parts.append("".join(seq[prev:]))
    return "".join(parts)


def _idx(seed=7, genome_len=4000, num_sites=40):
    rng = np.random.RandomState(seed)
    return build_prg_index(PrgString(prg_string_to_ints(
        _site_prg(rng, genome_len, num_sites))))


@pytest.mark.parametrize("m", [1, 7, 129, 4096, 100_003])
def test_kernel_matches_twin_and_dense(cuda, m):
    fm = _idx().fm
    blocks = rank.blocks_tensor(rank.build_packed_occ(fm), cuda)
    rng = np.random.RandomState(m)
    rows_np = rng.randint(-3, fm.size + 9, size=m).astype(np.int32)
    rows_np[:min(m, 4)] = [-1, 0, fm.size, fm.size + 7][:min(m, 4)]
    rows = torch.from_numpy(rows_np).to(cuda)
    before = rank.packed_rank.launches
    got = rank.packed_rank(blocks, rows, fm.size)
    torch.cuda.synchronize()
    assert rank.packed_rank.launches == before + 1
    assert torch.equal(got, rank.packed_occ_rows_torch(blocks, rows, fm.size))
    dense = np.ascontiguousarray(fm.occ.T)[np.clip(rows_np, 0, fm.size)]
    np.testing.assert_array_equal(got.cpu().numpy(), dense)


def test_kernel_every_prefix_length(cuda):
    fm = FMIndex.build(prg_string_to_ints(
        _site_prg(np.random.RandomState(1), 700, 9)))
    blocks = rank.blocks_tensor(rank.build_packed_occ(fm), cuda)
    rows = torch.arange(fm.size + 1, dtype=torch.int32, device=cuda)
    got = rank.make_packed_occ_rows(blocks, fm.size)(rows.reshape(1, -1))
    assert got.shape == (1, fm.size + 1, 4)
    np.testing.assert_array_equal(got[0].cpu().numpy(),
                                  np.ascontiguousarray(fm.occ.T))


def test_kernel_wrapper_checks_inputs(cuda):
    fm = _idx().fm
    blocks = rank.blocks_tensor(rank.build_packed_occ(fm), cuda)
    with pytest.raises(TypeError):
        rank.packed_rank(blocks, torch.zeros(4, dtype=torch.int64,
                                             device=cuda), fm.size)
    with pytest.raises(ValueError):
        rank.packed_rank(blocks[:-1], torch.zeros(4, dtype=torch.int32,
                                                  device=cuda), fm.size)


def _reads(idx, n, length, seed):
    rng = np.random.RandomState(seed)
    dna = idx.prg[(idx.prg >= 1) & (idx.prg <= 4)].astype(np.uint8)
    return [dna[s:s + length].copy()
            for s in rng.randint(0, dna.size - length, size=n)]


@pytest.mark.parametrize("rank_kind", ["dense", "packed"])
def test_scan_flat_result_equal_on_cuda_and_cpu(cuda, rank_kind,
                                                monkeypatch):
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", rank_kind)
    idx = _idx()
    k = 5
    kmer_index = build_kmer_index(idx, k)
    engine = LogBatchedEngine(idx, k, LogConfig(pool=4096, hits=16),
                              device=cuda)
    before = (locked_step.locked_tail.launches,
              locked_step.locked_tail.narrow_launches,
              wide_step.wide_steps.launches)
    token = engine.scan_submit(_reads(idx, 200, 60, 3), kmer_index, k,
                               QuasimapStats())
    (pending, phases, R), carry, reads_T = token[2], token[5], token[6]
    got = pending.get()
    assert phases[-1][4] == "locked"
    # the whole scan in two launches: the wide phases, then the tail
    assert (locked_step.locked_tail.launches,
            locked_step.locked_tail.narrow_launches,
            wide_step.wide_steps.launches) == tuple(b + 1 for b in before)
    di_cpu = DeviceIndex.build(idx, engine.jt, "cpu")
    blocks = engine.blocks.cpu() if engine.blocks is not None else None
    want = log_search_packed(
        di_cpu, torch.from_numpy(reads_T),
        tuple(torch.from_numpy(a) for a in carry), phases, R,
        blocks=blocks, rank=rank_kind).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rank_kind", ["dense", "packed"])
def test_engine_on_cuda_matches_host_oracle(cuda, rank_kind, monkeypatch):
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", rank_kind)
    idx = _idx()
    k = 5
    kmer_index = build_kmer_index(idx, k)
    engine = LogBatchedEngine(idx, k, LogConfig(pool=4096, hits=16),
                              device=cuda)
    engine.retry_min = 1
    reads = _reads(idx, 200, 60, 5)
    before = (rank.packed_rank.launches, wide_step.wide_steps.launches,
              locked_step.locked_tail.launches)
    results = engine.search_buffer(reads, kmer_index, k, QuasimapStats())
    assert engine.device_mapped > 0 and engine.device_retried > 0
    # the scan kernels fold the packed rank in: no standalone K1 call
    after = (rank.packed_rank.launches, wide_step.wide_steps.launches,
             locked_step.locked_tail.launches)
    assert after[0] == before[0] and all(
        a > b for a, b in zip(after[1:], before[1:]))
    key = lambda st: sorted((s.lo, s.hi, s.traversed, s.traversing)
                            for s in st)
    for i, read in enumerate(reads):
        expected = []
        for o in (read, revcomp(read)):
            if not all_read_kmers_in_index(k, o, kmer_index):
                continue
            seeds = kmer_index.get(o[o.size - k:].astype(np.uint8).tobytes(),
                                   [])
            expected.append((key(search_read_backwards(o, seeds, k, idx)
                                 if seeds else []), int(o.size)))
        assert [(key(s), n) for s, n in results[i]] == expected


def _mixed_idx(seed=11, genome_len=20_000, num_sites=300):
    """The mixed graph of common/workload.py (SNPs, direct deletions,
    insertions, four-allele and nested sites) and 150 bp reads from 4
    sampled haplotypes: (idx, reads)."""
    from gramtools_tpu_torch.common.workload import (build_mixed_graph,
                                                     sample_haplotypes,
                                                     sample_reads)

    rng = np.random.RandomState(seed)
    prg_ints = build_mixed_graph(rng, genome_len, num_sites)
    prg = PrgString(prg_ints)
    paths = sample_haplotypes(prg_ints, dict(prg.end_positions), rng, 4)
    return build_prg_index(prg), list(sample_reads(rng, paths, 300, 150))


@pytest.mark.parametrize("rank_kind", ["dense", "packed"])
def test_engine_on_cuda_matches_host_oracle_mixed_graph(cuda, rank_kind,
                                                        monkeypatch):
    """test_engine_on_cuda_matches_host_oracle on the mixed graph: the
    scan kernels take its deletion jumps, adjacent markers and nested
    sites, and every read's states equal the host oracle's."""
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", rank_kind)
    idx, reads = _mixed_idx()
    k = 7
    kmer_index = build_kmer_index(idx, k)
    engine = LogBatchedEngine(idx, k, LogConfig(pool=4096, hits=16),
                              device=cuda)
    engine.retry_min = 1
    before = (wide_step.wide_steps.launches,
              locked_step.locked_tail.launches)
    results = engine.search_buffer(reads, kmer_index, k, QuasimapStats())
    assert engine.device_mapped > 0
    assert all(a > b for a, b in zip((wide_step.wide_steps.launches,
                                      locked_step.locked_tail.launches),
                                     before))
    key = lambda st: sorted((s.lo, s.hi, s.traversed, s.traversing)
                            for s in st)
    for i, read in enumerate(reads):
        expected = []
        for o in (read, revcomp(read)):
            if not all_read_kmers_in_index(k, o, kmer_index):
                continue
            seeds = kmer_index.get(o[o.size - k:].astype(np.uint8).tobytes(),
                                   [])
            expected.append((key(search_read_backwards(o, seeds, k, idx)
                                 if seeds else []), int(o.size)))
        assert [(key(s), n) for s, n in results[i]] == expected, i


def _mixed_per_base_inputs():
    """The per-base recorder's (K9's) arguments of one fused buffer of
    the mixed graph, taken on the CPU: (di, rt, the arguments)."""
    idx, reads = _mixed_idx(seed=12)
    k = 7
    captured = []
    per_base = record._record_per_base_device

    def capture(*args):
        captured.append(tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args))
        return per_base(*args)

    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("GRAMTOOLS_TPU_RANK", "dense")
        mp.setattr(record, "_record_per_base_device", capture)
        engine = LogBatchedEngine(idx, k, LogConfig(pool=4096, hits=64),
                                  device="cpu")
        first = first_raw_draws(np.asarray(RandomInclusiveInt(3).raw_block(
            len(reads)), dtype=np.uint32))
        token = engine.scan_submit(reads, build_kmer_index_vectorised(idx, k),
                                   k, QuasimapStats(), first_raws=first)
        token[2][1].get()
    finally:
        mp.undo()
    di, rt, *args = captured[0]
    return di, rt, args


def test_per_base_kernels_on_mixed_graph_repeated(cuda):
    """K9 on a buffer of the mixed graph (four-allele sites, whose walk
    follows nt_edges, and direct deletions, whose empty nodes it
    crosses) against its plain version, over 20 repeated launches:
    fallback bits and cov_diff bit for bit each time."""
    di, rt, args = _mixed_per_base_inputs()
    ps_trav, ps_ntrav, sel = args[3], args[4], args[5]
    used = torch.arange(ps_trav.shape[1])[None, :] < ps_ntrav[:, None]
    assert ((ps_trav[..., 1] >= 2) & used & sel[:, None]).any()
    want_cov = args[8].clone()
    want_fb = record._record_per_base_device(di, rt, *args[:8], want_cov,
                                             *args[9:])
    assert not torch.equal(want_cov, args[8])        # coverage was added
    di_c = SimpleNamespace(sa=di.sa.to(cuda), size=di.size)
    rt_c = _to_device(rt, cuda)
    on = [a.to(cuda) for a in args[:8]]
    before = walk.per_base_cuda.launches
    for i in range(20):
        cov = args[8].to(cuda)
        fb = record._record_per_base_device(di_c, rt_c, *on, cov, *args[9:])
        assert torch.equal(fb.cpu(), want_fb), i
        assert torch.equal(cov.cpu(), want_cov), i
    assert walk.per_base_cuda.launches == before + 20


def test_cuda_device_from_environment(cuda, monkeypatch):
    from gramtools_tpu_torch.common.device import get_device

    monkeypatch.delenv("GRAMTOOLS_TORCH_DEVICE", raising=False)
    assert get_device().type == "cuda"
    assert os.environ.get("GRAMTOOLS_TORCH_DEVICE") is None


# --------------------------------------------------------------------------
# K7 (replay) and K9 (the per-base recorder)
# --------------------------------------------------------------------------

def _replay_inputs(rng, N, L, n_states, n_ev, n_ops, max_path, device):
    """Random but well-formed replay inputs: every log parent points to
    an earlier record or to a seed state, so chains end; long chains
    (past max_chain) and long seed paths (past tcap) occur too."""
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32)).to(device)
    lp = np.where(rng.rand(L) < 0.3, -rng.randint(1, n_states + 1, L),
                  (rng.rand(L) * np.arange(L)).astype(np.int64))
    lp[0] = -1
    le = rng.randint(0, n_ev, L)
    f_pref = np.where(rng.rand(N) < 0.8, rng.randint(0, L, N),
                      -rng.randint(1, n_states + 1, N))
    alive = torch.from_numpy(rng.rand(N) < 0.9).to(device)
    k_nt = rng.randint(0, max_path + 1, n_states)
    k_ni = rng.randint(0, max_path + 1, n_states)
    t_flat = rng.randint(0, 50, (max(int(k_nt.sum()), 1), 2))
    i_flat = rng.randint(0, 50, (max(int(k_ni.sum()), 1), 2))
    off = lambda n: np.concatenate([[0], np.cumsum(n)[:-1]])
    seeds = replay.SeedPaths(i32(k_nt), i32(k_ni), i32(off(k_nt)),
                             i32(off(k_ni)), i32(t_flat), i32(i_flat),
                             max_path)
    ops = replay.JumpOps(i32(rng.choice([0, 0, 1, 2], (n_ev, n_ops))),
                         i32(rng.randint(5, 99, (n_ev, n_ops))),
                         i32(rng.randint(0, 4, (n_ev, n_ops))))
    return i32(f_pref), alive, i32(lp), i32(le), seeds, ops


def _on(device, args):
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a.to(device))
        elif isinstance(a, tuple):
            out.append(type(a)(*(x.to(device) if isinstance(x, torch.Tensor)
                                 else x for x in a)))
        else:
            out.append(a)
    return out


@pytest.mark.parametrize("N,L,max_chain,tcap", [
    (1, 1, 32, TCAP), (300, 2000, 32, TCAP), (30_720, 1_500_000, 32, TCAP),
    (4096, 50_000, 3, TCAP), (4097, 50_000, 5, 4), (999, 9000, 33, 20)])
def test_replay_kernel_matches_twin(cuda, N, L, max_chain, tcap):
    rng = np.random.RandomState(N)
    args = _replay_inputs(rng, N, L, 500, 64, 3, 20, "cpu")
    before = replay.replay.launches
    got = replay.replay(*_on(cuda, args), max_chain=max_chain, tcap=tcap)
    torch.cuda.synchronize()
    assert replay.replay.launches == before + 1
    want = replay.replay_torch(*args, max_chain=max_chain, tcap=tcap)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert want[4].any()                  # some chains or paths overran


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("N,L,max_chain,tcap", [
    (300, 2000, 32, TCAP), (4096, 50_000, 3, TCAP), (4097, 50_000, 5, 4),
    (999, 9000, 33, 20)])
def test_replay_kernel_stage_matches_twin(cuda, N, L, max_chain, tcap,
                                          stage):
    """The profiling stages: the chase only (1), + the seed gather (2),
    with chains past max_chain (3, 5) and seed paths past tcap (4)."""
    rng = np.random.RandomState(N + stage)
    args = _replay_inputs(rng, N, L, 500, 64, 3, 20, "cpu")
    before = replay.replay.launches
    got = replay.replay(*_on(cuda, args), max_chain=max_chain, tcap=tcap,
                        stage=stage)
    torch.cuda.synchronize()
    assert replay.replay.launches == before + 1
    want = replay.replay_torch(*args, max_chain=max_chain, tcap=tcap,
                               stage=stage)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert want[1].any() == (stage == 2)  # path lengths only from stage 2
    if max_chain < 32 or (stage == 2 and tcap < 20):
        assert want[4].any()              # chains or paths overran


def _per_base_case(seed, n_states, width, R, allele_max=1):
    """Random but well-formed per-base recorder inputs on the CPU, on a
    site graph: n_states states with SA intervals of 1..width rows, half
    of them selected, on random rows; paths of up to TCAP loci with
    alleles 0..allele_max (past 1 the walk reads nt_edges); reads of
    1..150 bases. Returns (di, rt, per-base arguments without the caps)."""
    idx = _idx(genome_len=20_000, num_sites=400)
    rt = RecordTables.build(idx, "cpu")
    rng = np.random.RandomState(seed)
    n = idx.fm.size
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32))
    lo = rng.randint(0, n, n_states)
    hi = np.minimum(lo + rng.randint(0, width, n_states), n - 1)
    di = SimpleNamespace(sa=i32(idx.fm.sa), size=n)
    args = [i32(rng.randint(0, R, n_states)), i32(lo), i32(hi),
            i32(rng.randint(0, allele_max + 1, (n_states, TCAP, 2))),
            i32(rng.randint(0, TCAP + 1, n_states)),
            torch.from_numpy(rng.rand(n_states) < 0.5),
            i32(rng.randint(1, 151, R)), i32(np.zeros(R)),
            i32(rng.randint(-3, 4, rt.cov_size + 1))]
    return di, rt, args


def _emissions(di, rt, args, wcap):
    """How many emissions the plain walk makes on these inputs."""
    ps_row, ps_lo, ps_hi, ps_trav, ps_ntrav, sel, row_len = args[:7]
    lanes, _ = record._walk_lanes(di, rt, ps_row, ps_lo, ps_hi, ps_ntrav, sel,
                                  row_len, wcap)
    emits, _ = walk.walk_torch(rt.nt_walk, rt.nt_edges, *lanes, ps_trav,
                               1 << 22, rt.n_nodes + 2)
    return int((emits[:, 0] < walk.BIG).sum())


@pytest.mark.parametrize("case", ["one_lane", "lanes500", "wcap_spill",
                                  "emit_spill", "fallback_preset",
                                  "allele2"])
def test_per_base_kernels_match_plain(cuda, case):
    """The whole per-base recorder on CUDA (csrc/walk.cu) against its
    plain version on the CPU: fallback and cov_diff bit for bit, from
    one lane to past wcap (24,576 lanes at R = 30,720), with emission
    spill, wcap spill and preset fallback rows."""
    n_states, width, R, allele_max = {
        "one_lane": (1, 1, 1, 1), "lanes500": (500, 2, 300, 1),
        "wcap_spill": (16_000, 6, 30_720, 1), "emit_spill": (2000, 3, 1000, 1),
        "fallback_preset": (2000, 3, 1000, 1), "allele2": (2000, 3, 1000, 2),
        }[case]
    di, rt, args = _per_base_case(len(case), n_states, width, R, allele_max)
    _, _, wcap, emitcap, _ = buffer_caps(R)
    if case == "one_lane":
        args[5][:] = True
    if case == "emit_spill":
        emitcap = max(1, _emissions(di, rt, args, wcap) // 2)
    if case == "fallback_preset":
        args[7][::3] = 4
    want_cov = args[8].clone()
    want_fb = record._record_per_base_device(di, rt, *args[:8], want_cov,
                                             wcap, emitcap)
    got_cov = args[8].to(cuda)
    before = walk.per_base_cuda.launches
    got_fb = record._record_per_base_device(
        SimpleNamespace(sa=di.sa.to(cuda), size=di.size),
        _to_device(rt, cuda), *(a.to(cuda) for a in args[:8]), got_cov,
        wcap, emitcap)
    torch.cuda.synchronize()
    assert walk.per_base_cuda.launches == before + 1
    assert torch.equal(got_fb.cpu(), want_fb)
    assert torch.equal(got_cov.cpu(), want_cov)
    bits = {"wcap_spill": FB_WALK, "emit_spill": FB_EMIT}.get(case)
    if bits:
        assert ((want_fb & bits) != 0).any()
    elif case != "one_lane":
        assert not torch.equal(want_cov, args[8])     # coverage was added


def test_per_base_kernel_max_iter_overrun(cuda):
    """A lane past max_iter spills: every row with a selected state
    takes FB_EMIT and cov_diff is left as it was."""
    di, rt, args = _per_base_case(5, 500, 3, 300)
    sel_rows = record._flag_rows(300, args[5], args[0])
    c = {k: v.to(cuda) for k, v in _per_base_tensors(di, rt, args).items()}
    cov = c["cov_diff"].clone()
    fb = walk.per_base_cuda(**c, wcap=8192, emitcap=32_768, max_iter=2)
    torch.cuda.synchronize()
    assert torch.equal(fb.cpu(), torch.where(sel_rows, FB_EMIT, 0).to(
        torch.int32))
    assert torch.equal(c["cov_diff"], cov)


def _per_base_tensors(di, rt, args):
    names = ("ps_row", "ps_lo", "ps_hi", "ps_trav", "ps_ntrav",
             "st_selected", "row_len", "fallback", "cov_diff")
    return dict(sa=di.sa, ra_node=rt.ra_node, ra_offset=rt.ra_offset,
                nt_step=rt.nt_step, nt_edges=rt.nt_edges,
                nt_cov_start=rt.nt_cov_start, **dict(zip(names, args)))


def test_per_base_wrapper_checks_inputs(cuda):
    di, rt, args = _per_base_case(6, 64, 2, 40)
    c = {k: v.to(cuda) for k, v in _per_base_tensors(di, rt, args).items()}
    caps = dict(wcap=8192, emitcap=64, max_iter=99)
    with pytest.raises(TypeError):
        walk.per_base_cuda(**dict(c, ps_lo=c["ps_lo"].long()), **caps)
    with pytest.raises(TypeError):
        walk.per_base_cuda(**dict(c, st_selected=c["st_selected"].int()),
                           **caps)
    with pytest.raises(ValueError):
        walk.per_base_cuda(**dict(c, ps_hi=c["ps_hi"][:-1]), **caps)
    with pytest.raises(ValueError):
        walk.per_base_cuda(**dict(c, nt_step=c["nt_step"][:, :4]), **caps)
    with pytest.raises(ValueError):          # mixed devices
        walk.per_base_cuda(**dict(c, fallback=c["fallback"].cpu()), **caps)
    with pytest.raises(ValueError):          # added into in place
        walk.per_base_cuda(**dict(c, cov_diff=c["cov_diff"][::2]), **caps)
    with pytest.raises(ValueError):
        walk.per_base_cuda(**c, wcap=8192, emitcap=0, max_iter=99)


def test_per_base_does_not_synchronise(cuda):
    """The per-base recorder on CUDA enqueues its kernels without a host
    synchronisation."""
    di, rt, args = _per_base_case(7, 2000, 3, 1000)
    di_c = SimpleNamespace(sa=di.sa.to(cuda), size=di.size)
    rt_c = _to_device(rt, cuda)
    a = [x.to(cuda) for x in args]
    record._record_per_base_device(di_c, rt_c, *a, 8192, 32_768)   # loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fb = record._record_per_base_device(di_c, rt_c, *a, 8192, 32_768)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert fb.shape == (1000,)


def test_replay_wrapper_checks_inputs(cuda):
    rng = np.random.RandomState(0)
    args = _on(cuda, _replay_inputs(rng, 64, 100, 10, 8, 2, 4, "cpu"))
    with pytest.raises(TypeError):
        replay.replay(args[0].long(), *args[1:], max_chain=32, tcap=TCAP)
    with pytest.raises(ValueError):
        replay.replay(args[0], args[1][:-1], *args[2:], max_chain=32,
                      tcap=TCAP)
    with pytest.raises(ValueError):          # mixed devices
        replay.replay_cuda(args[0], args[1].cpu(), *args[2:], max_chain=32,
                           tcap=TCAP)


# --------------------------------------------------------------------------
# the locked scan tail (K3 locked)
# --------------------------------------------------------------------------

def _locked_case(rank_kind, R, seed, steps):
    """(DeviceIndex, reads (steps, R), carry, blocks) on the CPU: an
    incoming pool of 1.25 R random states (so reads hold two at the
    lock), random bases with one all-zero step (no hit at all)."""
    idx = _idx()
    di = DeviceIndex.build(idx, device="cpu")
    n = di.size
    rng = np.random.RandomState(seed)
    n_in = R + R // 4
    rid = np.where(rng.rand(n_in) < 0.8, rng.randint(0, R, size=n_in), -1)
    lo = rng.randint(0, n, size=n_in)
    hi = np.minimum(lo + rng.choice([0, 0, 0, 0, 1, 2, 5, 40], size=n_in),
                    n - 1)
    pref = rng.randint(-60, 900, size=n_in)
    ovf = np.concatenate([rng.rand(R) < 0.05, [False]])
    carry = tuple(torch.from_numpy(a.astype(np.int32))
                  for a in (rid, lo, hi, pref)) + (torch.from_numpy(ovf),)
    reads = rng.randint(0, 5, size=(steps, R)).astype(np.int32)
    reads[min(1, steps - 1)] = 0
    blocks = (rank.blocks_tensor(rank.build_packed_occ(idx.fm), "cpu")
              if rank_kind == "packed" else None)
    return di, torch.from_numpy(reads), carry, blocks


def _locked_on(device, di, reads, carry, blocks):
    return (_to_device(di, device),
            reads.to(device), tuple(a.to(device) for a in carry),
            None if blocks is None else blocks.to(device))


def _log_pair(n, device):
    return (torch.full((n,), -7, dtype=torch.int32, device=device),
            torch.full((n,), -7, dtype=torch.int32, device=device))


@pytest.mark.parametrize("steps", [1, 6])
@pytest.mark.parametrize("G,W", [(512, 10_000), (2, 8)])
@pytest.mark.parametrize("R", [300, 5000])
@pytest.mark.parametrize("rank_kind", ["dense", "packed"])
def test_locked_tail_kernel_matches_twin(cuda, rank_kind, R, G, W, steps):
    di, reads, carry, blocks = _locked_case(rank_kind, R, R + G + steps,
                                            steps)
    W = min(W, R)
    B = di.n_outcomes
    base = 33
    n_log = base + steps * G * B + 5
    lp, le = _log_pair(n_log, "cpu")
    want = locked_step.locked_tail(di, reads, carry, base, lp, le, G, W,
                                   blocks=blocks)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)
    clp, cle = _log_pair(n_log, cuda)
    before = locked_step.locked_tail.launches
    got = locked_step.locked_tail(cdi, creads, ccarry, base, clp, cle, G, W,
                                  blocks=cblocks)
    torch.cuda.synchronize()
    assert locked_step.locked_tail.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(clp.cpu(), lp) and torch.equal(cle.cpu(), le)
    # the inputs are never written
    for a, b in zip(ccarry, carry):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("rank_kind", ["dense", "packed"])
def test_locked_tail_kernel_range_split(cuda, rank_kind):
    """Steps [0, 3) with the lock, then [3, 7) on the kernel's own
    locked carry: the one-call result, carry and log."""
    G, W = 64, 40
    di, reads, carry, blocks = _locked_case(rank_kind, 1200, 5, 7)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)
    n_log = 7 * G * di.n_outcomes
    lp, le = _log_pair(n_log, cuda)
    whole = locked_step.locked_tail(cdi, creads, ccarry, 0, lp, le, G, W,
                                    blocks=cblocks)
    lp2, le2 = _log_pair(n_log, cuda)
    part = locked_step.locked_tail(cdi, creads[:3], ccarry, 0, lp2, le2, G, W,
                                   blocks=cblocks)
    part = locked_step.locked_tail(cdi, creads[3:], part, 3 * G * di.n_outcomes,
                                   lp2, le2, G, W, blocks=cblocks, lock=False)
    for a, b in zip(whole, part):
        assert torch.equal(a, b)
    assert torch.equal(lp, lp2) and torch.equal(le, le2)


def test_locked_tail_wrapper_checks_inputs(cuda):
    di, reads, carry, blocks = _locked_case("packed", 300, 1, 2)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)
    lp, le = _log_pair(2 * 16 * di.n_outcomes, cuda)
    call = lambda **kw: locked_step.locked_tail_cuda(**{**dict(
        di=cdi, reads=creads, carry=ccarry, log_base=0, lp=lp, le=le,
        hits=16, wide_budget=8, blocks=cblocks), **kw})
    call()                                     # the good call launches
    with pytest.raises(TypeError):
        call(reads=creads.long())
    with pytest.raises(ValueError):            # overflow without its dump slot
        call(carry=ccarry[:4] + (ccarry[4][:-1],))
    with pytest.raises(ValueError):            # mixed devices
        call(carry=(ccarry[0].cpu(),) + ccarry[1:])
    with pytest.raises(ValueError):            # strided
        call(reads=torch.cat([creads, creads], dim=1)[:, ::2])
    with pytest.raises(ValueError):            # records past the log's end
        call(log_base=1)
    with pytest.raises(ValueError):            # a locked carry has R states
        call(lock=False)
    with pytest.raises(ValueError):            # not the packed records
        call(blocks=cblocks[:-1])
    with pytest.raises(ValueError):            # a CPU tensor
        locked_step.locked_tail_cuda(di, reads, carry, 0, lp.cpu(), le.cpu(),
                                     16, 8, blocks=blocks)


def test_locked_tail_does_not_synchronise(cuda):
    di, reads, carry, blocks = _locked_case("packed", 2000, 3, 8)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)
    lp, le = _log_pair(8 * 32 * di.n_outcomes, cuda)
    locked_step.locked_tail(cdi, creads, ccarry, 0, lp, le, 32, 16,
                            blocks=cblocks)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = locked_step.locked_tail(cdi, creads, ccarry, 0, lp, le, 32, 16,
                                      blocks=cblocks)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out[0].shape == (2000,)


# The locked range's design cases: the chained scans' look-back across
# tiles and blocks, the owning block's hit pairs, the closing tile's empty
# records. Each case says what it forces; the test checks that it did.
THREADS = 256          # slots a tile (csrc/scan_common.cuh kThreads)


def _step_hits(di, carry, row, W):
    """Each slot's marker hits in a locked step from its (locked) carry,
    in numpy from the dense tables: 1 for a single state at a marker, the
    markers of a covered wide state's interval, 0 otherwise."""
    rid, lo, hi = (a.numpy().astype(np.int64) for a in carry[:3])
    occ = di.occ.numpy().astype(np.int64)
    n = di.size
    sent = int(di.sentinel_row)
    active = (rid >= 0) & (row.numpy() > 0)
    single = lo == hi
    wide = active & ~single
    covered = single | (wide & (np.cumsum(wide) - wide < W))
    sym = di.narrow_tab.numpy()[np.clip(lo, 0, n - 1)] >> 24
    hi1 = hi + 1
    markers = ((hi1 - occ[np.clip(hi1, 0, n)].sum(1) - (hi1 > sent))
               - (lo - occ[np.clip(lo, 0, n)].sum(1) - (lo > sent)))
    return np.where(active & covered, np.where(single, sym == 5, markers), 0)


def _locked_design_case(name, rank_kind):
    """(DeviceIndex, reads, carry, blocks, G, W, lock) of one case, on the
    CPU, with the case's claim checked on its first step; every case's
    second step has no hit at all (an all-zero row)."""
    from gramtools_tpu_torch.mapping.scan_steps import lock_pool

    R = {"many_tiles": 262_144, "pairs_over_threads": 1024, "over_G": 5000,
         "w_mid_tile": 2048, "last_far": 2560}[name]
    S = 3 if name == "many_tiles" else 4
    di, reads, carry, blocks = _locked_case(rank_kind, R, len(name), S)
    G = 8 if name == "over_G" else 4096
    W, lock = R, True
    B = di.n_outcomes
    T = (R + THREADS - 1) // THREADS
    locked = lock_pool(carry, R, R)
    if name == "pairs_over_threads":
        # tile 0's first slots live and wide over thousands of rows
        rid, lo, hi, pref, ovf = (a.clone() for a in locked)
        for i in range(8):
            rid[i], lo[i] = i, 1 + 7 * i
            hi[i] = lo[i] + min(3000, di.size - 60)
        carry = locked = (rid, lo, hi, pref, ovf)
        lock = False
        reads[0, :8] = 1 + torch.arange(8, dtype=torch.int32) % 4
    elif name == "last_far":           # no active slot past tile 1
        reads[:, 2 * THREADS:] = 0
    elif name == "w_mid_tile":         # W binds in the middle of tile 1
        rid, lo, hi = (a.numpy() for a in locked[:3])
        w_slots = np.flatnonzero((rid >= 0) & (reads[0].numpy() > 0)
                                 & (lo != hi))
        W = int((w_slots < THREADS + THREADS // 2).sum())
        assert W < w_slots.size and w_slots[W] // THREADS == 1
        assert 0 < w_slots[W] % THREADS < THREADS - 1
    cnt = _step_hits(di, locked, reads[0], W)
    if name == "pairs_over_threads":
        assert int(cnt[:THREADS].sum()) * B > THREADS and cnt.sum() < G
    elif name == "over_G":
        assert int(cnt.sum()) > G
    elif name == "last_far":
        last = int(np.flatnonzero(cnt > 0)[-1])
        assert T - 1 - last // THREADS >= 2 and cnt.sum() < G
    elif name == "many_tiles":
        with torch.cuda.device(0):
            grid = locked_step._kernel_lib().locked_tail_grid(
                carry[0].shape[0], 0)         # int32 rows
        assert 0 < grid < T
    assert not bool((reads[1] > 0).any())
    return di, reads, carry, blocks, G, W, lock


LOCKED_DESIGN_CASES = ["many_tiles", "pairs_over_threads", "over_G",
                       "w_mid_tile", "last_far"]


@pytest.mark.parametrize("case", LOCKED_DESIGN_CASES)
@pytest.mark.parametrize("rank_kind", ["dense", "packed"])
def test_locked_range_design_cases_match_twin(cuda, rank_kind, case):
    """The locked range equal bit for bit (carry, flags, every log record)
    to the twin where each block owns several tiles, a tile holds more
    hit pairs than threads, a step has more hits than G (and one has
    none), W binds in the middle of a tile, and the last slot with hits
    lies several tiles before the tile that closes the step."""
    di, reads, carry, blocks, G, W, lock = _locked_design_case(case,
                                                                rank_kind)
    B = di.n_outcomes
    S = reads.shape[0]
    base = 9
    n_log = base + S * G * B + 3
    lp, le = _log_pair(n_log, "cpu")
    want = locked_step.locked_tail(di, reads, carry, base, lp, le, G, W,
                                   blocks=blocks, lock=lock)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)
    clp, cle = _log_pair(n_log, cuda)
    got = locked_step.locked_tail(cdi, creads, ccarry, base, clp, cle, G, W,
                                  blocks=cblocks, lock=lock)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.cpu(), w)
    assert torch.equal(clp.cpu(), lp) and torch.equal(cle.cpu(), le)


@pytest.mark.parametrize("R,S,G", [(30_720, 12, 1792), (262_144, 4, 4096)])
def test_locked_range_repeated_launches_identical(cuda, R, S, G):
    """20 launches on the same inputs give the same carry, flags and log
    (no race in the chained scans), equal to the twin's."""
    di, reads, carry, blocks = _locked_case("packed", R, 5, S)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)
    n_log = S * G * di.n_outcomes
    runs = []
    for _ in range(20):
        lp, le = _log_pair(n_log, cuda)
        out = locked_step.locked_tail(cdi, creads, ccarry, 0, lp, le, G, G,
                                      blocks=cblocks)
        runs.append(tuple(out) + (lp, le))
    torch.cuda.synchronize()
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)
    lp, le = _log_pair(n_log, "cpu")
    want = locked_step.locked_tail(di, reads, carry, 0, lp, le, G, G,
                                   blocks=blocks)
    for a, b in zip(runs[0], tuple(want) + (lp, le)):
        assert torch.equal(a.cpu(), b)


def test_locked_range_split_with_many_tiles(cuda):
    """Where each block owns several tiles: steps [0, 2) with the lock,
    then [2, 5) on the kernel's locked carry, equal to one call."""
    G, W = 2048, 1024
    di, reads, carry, blocks = _locked_case("packed", 262_144, 7, 5)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)
    B = di.n_outcomes
    n_log = 5 * G * B
    lp, le = _log_pair(n_log, cuda)
    whole = locked_step.locked_tail(cdi, creads, ccarry, 0, lp, le, G, W,
                                    blocks=cblocks)
    lp2, le2 = _log_pair(n_log, cuda)
    part = locked_step.locked_tail(cdi, creads[:2], ccarry, 0, lp2, le2, G, W,
                                   blocks=cblocks)
    part = locked_step.locked_tail(cdi, creads[2:], part, 2 * G * B, lp2, le2,
                                   G, W, blocks=cblocks, lock=False)
    for a, b in zip(whole, part):
        assert torch.equal(a, b)
    assert torch.equal(lp, lp2) and torch.equal(le, le2)


# --------------------------------------------------------------------------
# the wide steps (K2) and the hole-allocated narrow steps (K3 narrow)
# --------------------------------------------------------------------------

def _pool_case(rank_kind, R, n_in, seed, steps):
    """(DeviceIndex, reads (steps, R), carry of n_in random states, front
    packed (the live states first, as a wide step leaves them), blocks)
    on the CPU; one all-zero step (no hit at all)."""
    di, reads, carry, blocks = _locked_case(rank_kind, R, seed, steps)
    rng = np.random.RandomState(seed + 1)
    n = di.size
    live = min(n_in, int(0.8 * n_in) + 1)
    rid = np.full(n_in, -1)
    rid[:live] = rng.randint(0, R, size=live)
    lo = rng.randint(0, n, size=n_in)
    hi = np.minimum(lo + rng.choice([0, 0, 1, 2, 5, 40, 300], size=n_in),
                    n - 1)
    pref = rng.randint(-60, 900, size=n_in)
    carry = tuple(torch.from_numpy(a.astype(np.int32))
                  for a in (rid, lo, hi, pref)) + (carry[4],)
    return di, reads, carry, blocks


# (R, incoming states, phases ((steps, pool, hits), ...)): a shrink and
# a grow between phases, spilling budgets, a pool that survivors and
# newborns overfill (n_keep + n_cand > N), phases of no step, and pools at
# the path's sizes (several tiles a block: 1,024 tiles at N = 262,144)
WIDE_CASES = {
    "small": (300, 1000, ((2, 1024, 64), (3, 500, 8))),
    "grow": (300, 200, ((1, 256, 4), (2, 640, 300))),
    "tight": (1000, 4000, ((2, 1200, 2), (2, 900, 1))),
    "full": (1000, 2000, ((3, 2000, 4096),)),
    "empty_phases": (300, 900, ((0, 400, 8), (2, 1000, 64), (0, 700, 4))),
    "path": (8192, 30000, ((2, 32768, 4096), (4, 12288, 1024))),
    "warm": (30720, 262144, ((2, 262144, 14336), (2, 46080, 3584))),
}


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
@pytest.mark.parametrize("rank_kind", ["dense", "packed"])
def test_wide_steps_kernel_matches_twin(cuda, rank_kind, case):
    R, n_in, phases = WIDE_CASES[case]
    S = sum(p[0] for p in phases)
    di, reads, carry, blocks = _pool_case(rank_kind, R, n_in, R + n_in, S)
    B = di.n_outcomes
    base = 21
    n_log = base + sum(s * g for s, _, g in phases) * B + 5
    lp, le = _log_pair(n_log, "cpu")
    want = wide_step.wide_steps(di, reads, carry, phases, base, lp, le,
                                blocks=blocks)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)
    clp, cle = _log_pair(n_log, cuda)
    before = wide_step.wide_steps.launches
    got = wide_step.wide_steps(cdi, creads, ccarry, phases, base, clp, cle,
                               blocks=cblocks)
    torch.cuda.synchronize()
    assert wide_step.wide_steps.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.cpu(), w)
    assert torch.equal(clp.cpu(), lp) and torch.equal(cle.cpu(), le)
    for a, b in zip(ccarry, carry):                # inputs never written
        assert torch.equal(a.cpu(), b)


# (R, incoming states, narrow (steps, pool, hits, W), locked steps, G, W):
# more candidates than holes, and than HB = hits x B, W binding inside a
# tile, and the path's shapes
NARROW_CASES = {
    "small": (300, 500, (3, 384, 64, 64), 3, 64, 64),
    "tight": (1000, 1600, (3, 1250, 2, 4), 2, 2, 4),
    "grow": (500, 300, (2, 640, 16, 32), 2, 8, 16),
    "alone": (600, 900, (4, 768, 32, 32), 0, 32, 32),
    "few_holes": (1000, 1250, (3, 1250, 512, 1250), 2, 64, 64),
    "small_hb": (1000, 1250, (3, 1250, 3, 1250), 2, 2, 4),
    "w_mid": (1000, 1250, (3, 1250, 256, 37), 2, 64, 37),
    "path": (8192, 12288, (8, 10240, 512, 512), 6, 512, 512),
    "warm": (30720, 46080, (8, 38400, 1792, 1792), 0, 1792, 1792),
}


@pytest.mark.parametrize("case", sorted(NARROW_CASES))
@pytest.mark.parametrize("rank_kind", ["dense", "packed"])
def test_narrow_tail_kernel_matches_twin(cuda, rank_kind, case):
    R, n_in, narrow, n_locked, G, W = NARROW_CASES[case]
    lock = n_locked > 0
    di, reads, carry, blocks = _pool_case(rank_kind, R, n_in, R + n_in,
                                          narrow[0] + n_locked)
    B = di.n_outcomes
    base = 17
    n_log = base + (narrow[0] * narrow[2] + n_locked * G) * B + 5
    lp, le = _log_pair(n_log, "cpu")
    want = locked_step.locked_tail(di, reads, carry, base, lp, le, G, W,
                                   blocks=blocks, lock=lock, narrow=narrow)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)
    clp, cle = _log_pair(n_log, cuda)
    before = (locked_step.locked_tail.launches,
              locked_step.locked_tail.narrow_launches)
    got = locked_step.locked_tail(cdi, creads, ccarry, base, clp, cle, G, W,
                                  blocks=cblocks, lock=lock, narrow=narrow)
    torch.cuda.synchronize()
    assert (locked_step.locked_tail.launches,
            locked_step.locked_tail.narrow_launches) == (before[0] + 1,
                                                         before[1] + 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.cpu(), w)
    assert torch.equal(clp.cpu(), lp) and torch.equal(cle.cpu(), le)
    for a, b in zip(ccarry, carry):
        assert torch.equal(a.cpu(), b)
    assert got[0].shape == ((R,) if lock else (narrow[1],))


def _wide_run(cuda, case, seed, rank_kind="packed"):
    """K2 on case's inputs on the card: (carry, flags, log halves) and
    the twin's on the CPU."""
    R, n_in, phases = WIDE_CASES[case]
    S = sum(ph[0] for ph in phases)
    di, reads, carry, blocks = _pool_case(rank_kind, R, n_in, seed, S)
    n_log = 21 + sum(s * g for s, _, g in phases) * di.n_outcomes
    lp, le = _log_pair(n_log, "cpu")
    want = tuple(wide_step.wide_steps(di, reads, carry, phases, 21, lp, le,
                                      blocks=blocks)) + (lp, le)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)

    def run():
        clp, cle = _log_pair(n_log, cuda)
        return tuple(wide_step.wide_steps(cdi, creads, ccarry, phases, 21,
                                          clp, cle, blocks=cblocks)) + (
            clp, cle)
    return run, want


def _narrow_run(cuda, case, seed, rank_kind="packed"):
    """K3 with its hole-allocated range on case's inputs on the card:
    (carry, flags, log halves) and the twin's on the CPU."""
    R, n_in, narrow, n_locked, G, W = NARROW_CASES[case]
    lock = n_locked > 0
    di, reads, carry, blocks = _pool_case(rank_kind, R, n_in, seed,
                                          narrow[0] + n_locked)
    n_log = 17 + (narrow[0] * narrow[2] + n_locked * G) * di.n_outcomes
    lp, le = _log_pair(n_log, "cpu")
    want = tuple(locked_step.locked_tail(
        di, reads, carry, 17, lp, le, G, W, blocks=blocks, lock=lock,
        narrow=narrow)) + (lp, le)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)

    def run():
        clp, cle = _log_pair(n_log, cuda)
        return tuple(locked_step.locked_tail(
            cdi, creads, ccarry, 17, clp, cle, G, W, blocks=cblocks,
            lock=lock, narrow=narrow)) + (clp, cle)
    return run, want


@pytest.mark.parametrize("kernel,case", [("wide", "small"), ("wide", "full"),
                                         ("narrow", "small"),
                                         ("narrow", "few_holes")])
@pytest.mark.parametrize("rank_kind", ["dense", "packed"])
def test_scan_kernels_match_twin_on_a_small_grid(cuda, rank_kind, kernel,
                                                 case, monkeypatch):
    """K2 and K3's hole-allocated range with the grid forced to 2 blocks
    (each owning several tiles a step, and waiting on the other's):
    the twin's carry, flags and log."""
    run, want = (_wide_run if kernel == "wide" else _narrow_run)(
        cuda, case, 11, rank_kind)
    monkeypatch.setattr(wide_step if kernel == "wide" else locked_step,
                        "GRID_CAP", 2)
    got = run()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("kernel,case", [("wide", "path"), ("wide", "warm"),
                                         ("narrow", "path"),
                                         ("narrow", "warm")])
def test_scan_kernels_repeated_launches_identical(cuda, kernel, case):
    """20 launches of K2, or of K3 with its hole-allocated range, on the
    same inputs give the same carry, flags and log (no race in the chained
    scans or the staged newborns), equal to the twin's."""
    run, want = (_wide_run if kernel == "wide" else _narrow_run)(cuda, case,
                                                                 5)
    runs = [run() for _ in range(20)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, b in zip(other, runs[0]):
            assert torch.equal(a, b)
    for a, b in zip(runs[0], want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("rank_kind", ["dense", "packed"])
def test_scan_kernels_range_split(cuda, rank_kind):
    """The wide phases one call each, then the narrow range alone and the
    locked range alone: the carry and log of one call over each run."""
    R, n_in, phases = WIDE_CASES["small"]
    narrow, G, W = (3, 384, 32, 32), 16, 24
    S_w = sum(p[0] for p in phases)
    di, reads, carry, blocks = _pool_case(rank_kind, R, n_in, 3,
                                          S_w + narrow[0] + 4)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)
    B = di.n_outcomes
    n_w = sum(s * g for s, _, g in phases) * B
    n_log = n_w + (narrow[0] * narrow[2] + 4 * G) * B

    def run(split):
        lp, le = _log_pair(n_log, cuda)
        c, off, base = ccarry, 0, 0
        for ph in (phases if split else [phases]):
            ph = [ph] if split else ph
            s = sum(p[0] for p in ph)
            c = wide_step.wide_steps(cdi, creads[off:off + s], c, ph, base,
                                     lp, le, blocks=cblocks)
            off, base = off + s, base + sum(p[0] * p[2] for p in ph) * B
        if split:
            c = locked_step.locked_tail(
                cdi, creads[off:off + narrow[0]], c, base, lp, le, G, W,
                blocks=cblocks, lock=False, narrow=narrow)
            c = locked_step.locked_tail(
                cdi, creads[off + narrow[0]:], c,
                base + narrow[0] * narrow[2] * B, lp, le, G, W,
                blocks=cblocks)
        else:
            c = locked_step.locked_tail(cdi, creads[off:], c, base, lp, le,
                                        G, W, blocks=cblocks, narrow=narrow)
        return c, lp, le

    whole, split = run(False), run(True)
    for a, b in zip(whole[0] + whole[1:], split[0] + split[1:]):
        assert torch.equal(a, b)


def test_scan_kernel_wrappers_check_inputs(cuda):
    R, n_in, phases = WIDE_CASES["small"]
    di, reads, carry, blocks = _pool_case("packed", R, n_in, 5, 5)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)
    lp, le = _log_pair(152 * di.n_outcomes, cuda)     # the phases' records
    wide = lambda **kw: wide_step.wide_steps_cuda(**{**dict(
        di=cdi, reads=creads, carry=ccarry, phases=phases, log_base=0, lp=lp,
        le=le, blocks=cblocks), **kw})
    wide()                                     # the good call launches
    with pytest.raises(ValueError):            # steps != the reads' rows
        wide(phases=((2, 1024, 64),))
    with pytest.raises(ValueError):            # a zero hit budget
        wide(phases=((2, 1024, 0), (3, 500, 8)))
    with pytest.raises(ValueError):            # more phases than it takes
        wide(phases=((1, 64, 1),) * 17, reads=torch.zeros(
            (17, R), dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        wide(reads=creads.long())
    with pytest.raises(ValueError):            # records past the log's end
        wide(log_base=1)
    with pytest.raises(ValueError):            # a CPU tensor
        wide_step.wide_steps_cuda(di, reads, carry, phases, 0, lp.cpu(),
                                  le.cpu(), blocks=blocks)
    tail = lambda **kw: locked_step.locked_tail_cuda(**{**dict(
        di=cdi, reads=creads, carry=ccarry, log_base=0, lp=lp, le=le,
        hits=16, wide_budget=8, blocks=cblocks, narrow=(2, 384, 16, 8)),
        **kw})
    tail()
    with pytest.raises(ValueError):            # more narrow steps than rows
        tail(narrow=(6, 384, 16, 8))
    with pytest.raises(ValueError):            # a zero narrow hit budget
        tail(narrow=(2, 384, 0, 8))
    with pytest.raises(ValueError):            # locked steps need the lock
        tail(lock=False)                       # (pool 384 != R)


def test_scan_kernels_do_not_synchronise(cuda):
    R, n_in, phases = WIDE_CASES["small"]
    narrow = (3, 384, 32, 32)
    di, reads, carry, blocks = _pool_case("packed", R, n_in, 9, 10)
    cdi, creads, ccarry, cblocks = _locked_on(cuda, di, reads, carry, blocks)
    lp, le = _log_pair(10 * 64 * di.n_outcomes, cuda)

    def both():
        c = wide_step.wide_steps(cdi, creads[:5], ccarry, phases, 0, lp, le,
                                 blocks=cblocks)
        return locked_step.locked_tail(cdi, creads[5:], c,
                                       152 * di.n_outcomes, lp, le, 16, 16,
                                       blocks=cblocks, narrow=narrow)

    both()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = both()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out[0].shape == (R,)


# --------------------------------------------------------------------------
# K6 inside the scan kernels (packed reads decoded where a base is
# loaded); K10, the scan over SA-range-sharded tables in gather rounds
# --------------------------------------------------------------------------

def _packed_window(R, S, start, seed, k=5):
    """A PackedReads window of S steps from ``start`` of a random 2-bit
    matrix (R reads), on the CPU: row lengths below k, at k, past k +
    the matrix's steps, 0 and random."""
    from gramtools_tpu_torch.ops.packed_reads import PackedReads

    rng = np.random.RandomState(seed)
    total = start + S + 3
    packed = rng.randint(0, 256, size=(-(-total // 4), R)).astype(np.uint8)
    row_len = rng.randint(0, k + total + 4, size=R)
    row_len[:4] = [0, k - 1, k, k + total + 5]
    return PackedReads(torch.from_numpy(packed),
                       torch.from_numpy(row_len.astype(np.int32)), k, total,
                       start, start + S)


def _window_on(window, device):
    from gramtools_tpu_torch.ops.packed_reads import PackedReads

    return PackedReads(window.packed.to(device), window.row_len.to(device),
                       window.kmer_size, window.steps, window.start,
                       window.stop)


def _packed_run(cuda, kernel, case, start, seed, rank_kind="packed"):
    """K2 (``wide``) or K3 with its hole-allocated range (``narrow``) on
    case's inputs with a packed window from ``start``: a run on the card
    of the packed window, one of its unpacked rows, and the twin's
    (carry, flags, log halves) on the CPU from the packed window."""
    if kernel == "wide":
        R, n_in, phases = WIDE_CASES[case]
        S = sum(ph[0] for ph in phases)
        records = sum(s * g for s, _, g in phases)
        call = lambda di, reads, carry, lp, le, blocks: wide_step.wide_steps(
            di, reads, carry, phases, 21, lp, le, blocks=blocks)
    else:
        R, n_in, narrow, n_locked, G, W = NARROW_CASES[case]
        S = narrow[0] + n_locked
        records = narrow[0] * narrow[2] + n_locked * G
        call = lambda di, reads, carry, lp, le, blocks: (
            locked_step.locked_tail(di, reads, carry, 21, lp, le, G, W,
                                    blocks=blocks, lock=n_locked > 0,
                                    narrow=narrow))
    di, _, carry, blocks = _pool_case(rank_kind, R, n_in, seed, S)
    n_log = 21 + records * di.n_outcomes
    window = _packed_window(R, S, start, seed)
    lp, le = _log_pair(n_log, "cpu")
    want = tuple(call(di, window, carry, lp, le, blocks)) + (lp, le)
    cdi, crows, ccarry, cblocks = _locked_on(cuda, di, window.unpack(), carry,
                                             blocks)
    cwindow = _window_on(window, cuda)

    def run(reads=None):
        clp, cle = _log_pair(n_log, cuda)
        return tuple(call(cdi, cwindow if reads is None else reads, ccarry,
                          clp, cle, cblocks)) + (clp, cle)
    return run, lambda: run(crows), want


@pytest.mark.parametrize("start", [0, 3, 6])
@pytest.mark.parametrize("kernel,case", [("wide", "small"), ("wide", "tight"),
                                         ("narrow", "small"),
                                         ("narrow", "tight")])
@pytest.mark.parametrize("rank_kind", ["dense", "packed"])
def test_scan_kernels_on_packed_reads(cuda, rank_kind, kernel, case, start):
    """K2 and K3 decoding the packed bases (K6) at a window that starts
    at step 0, 3 or 6 (the tail's offset need not be a multiple of 4):
    equal to the kernels on unpack_reads2's rows and to the twins."""
    fn = wide_step.wide_steps if kernel == "wide" else locked_step.locked_tail
    run, run_rows, want = _packed_run(cuda, kernel, case, start, 40 + start,
                                      rank_kind)
    before = (fn.launches, fn.packed_launches)
    got, rows = run(), run_rows()
    torch.cuda.synchronize()
    assert (fn.launches, fn.packed_launches) == (before[0] + 2, before[1] + 1)
    for g, r, w in zip(got, rows, want):
        assert g.shape == w.shape and torch.equal(g, r)
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("kernel,case", [("wide", "path"),
                                         ("narrow", "path")])
def test_packed_scan_kernels_repeated_launches_identical(cuda, kernel, case):
    """20 launches of K2, or of K3 with its hole-allocated range, on one
    packed window from step 3: the same carry, flags and log, equal to
    the twin's."""
    run, _, want = _packed_run(cuda, kernel, case, 3, 8)
    runs = [run() for _ in range(20)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, b in zip(other, runs[0]):
            assert torch.equal(a, b)
    for a, b in zip(runs[0], want):
        assert torch.equal(a.cpu(), b)


def _index_sharded_case(cuda, R=64, steps=32):
    from gramtools_tpu_torch.parallel.dryrun import _seeded_scan_inputs

    idx = _idx()
    di = DeviceIndex.build(idx, device=cuda)
    cfg = LogConfig(pool=256, hits=64)
    reads_T, carry = _seeded_scan_inputs(idx, np.random.RandomState(0), R,
                                         steps, cfg.pool)
    return di, cfg, reads_T, carry


def _no_plain_gather(monkeypatch):
    """The plain shard gather raises if anything calls it."""
    from gramtools_tpu_torch.ops import sharded

    def refuse(*args, **kwargs):
        raise AssertionError("the plain shard gather ran on CUDA")
    monkeypatch.setattr(sharded, "_sharded_gather", refuse)


def _k10_counts():
    from gramtools_tpu_torch.ops import sharded

    return (sharded.sharded_scan.launches, sharded.sharded_scan.collectives,
            wide_step.wide_steps.launches, locked_step.locked_tail.launches)


@pytest.mark.parametrize("n_idx", [1, 3, 4, 8])
def test_index_sharded_scan_one_card_runs_the_kernels(cuda, monkeypatch,
                                                      n_idx):
    """The index split over 1, 3, 4 or 8 SA-range shards on the card: the
    scan is the round kernels' 2 launches a step and 1 (no collective,
    no K2 or K3, the plain gather never called), equal to the
    replicated scan over 20 repeated scans."""
    from gramtools_tpu_torch.mapping.search_log import log_search_phases
    from gramtools_tpu_torch.mapping.search_log_host import auto_phases
    from gramtools_tpu_torch.parallel.mesh import Mesh
    from gramtools_tpu_torch.parallel.sharded_index import \
        make_index_sharded_log_search

    R = 64
    di, cfg, reads_T, carry = _index_sharded_case(cuda, R)
    args = (torch.from_numpy(reads_T).to(cuda),
            tuple(torch.from_numpy(a).to(cuda) for a in carry))
    run = make_index_sharded_log_search(Mesh([cuda] * n_idx, ("idx",)), di,
                                        cfg, R)
    _no_plain_gather(monkeypatch)
    before = _k10_counts()
    got = run(*args)
    runs = [run(*args) for _ in range(19)]
    torch.cuda.synchronize()
    assert _k10_counts() == (before[0] + 20 * (2 * 32 + 1), before[1],
                             before[2], before[3])
    want = log_search_phases(di, *args, auto_phases(32, R, cfg, narrow=True),
                             R)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.device.type == "cuda" and torch.equal(g, w)
    for other in runs:                 # 20 launches of each, identical
        for a, b in zip(other[0] + other[1], got[0] + got[1]):
            assert torch.equal(a, b)
    assert (want[1][0] >= 0).any()


@pytest.mark.parametrize("n_idx", [1, 4])
def test_index_sharded_scan_without_narrow_table_equals_wide_only(
        cuda, monkeypatch, n_idx):
    """A stub narrow table, as an index of 2**24 rows or more has: the
    engine's narrow plan runs every step wide. The round scan over 1 or
    4 shards (the kernels' argument rule takes the stub) equals the
    replicated wide-only scan, one K2 launch and no K3, over 20 repeated
    scans."""
    import dataclasses

    from gramtools_tpu_torch.mapping.search_log import log_search_phases
    from gramtools_tpu_torch.mapping.search_log_host import auto_phases
    from gramtools_tpu_torch.parallel.mesh import Mesh
    from gramtools_tpu_torch.parallel.sharded_index import \
        make_index_sharded_log_search

    R = 64
    di, cfg, reads_T, carry = _index_sharded_case(cuda, R)
    di = dataclasses.replace(di, narrow_tab=torch.zeros(
        1, dtype=torch.int32, device=cuda))
    phases = auto_phases(32, R, cfg, narrow=True)
    assert len(phases) == 4 and phases[-1][4] == "locked"
    args = (torch.from_numpy(reads_T).to(cuda),
            tuple(torch.from_numpy(a).to(cuda) for a in carry))
    run = make_index_sharded_log_search(Mesh([cuda] * n_idx, ("idx",)), di,
                                        cfg, R, phases=phases)
    _no_plain_gather(monkeypatch)
    before = _k10_counts()
    got = run(*args)
    runs = [run(*args) for _ in range(19)]
    want = log_search_phases(di, *args, phases, R)
    torch.cuda.synchronize()
    assert _k10_counts() == (before[0] + 20 * (2 * 32 + 1), before[1],
                             before[2] + 1, before[3])
    for other in [got] + runs:
        for g, w in zip(other[0] + other[1], want[0] + want[1]):
            assert g.device.type == "cuda" and torch.equal(g, w)
    assert (want[1][0] >= 0).any()


# --------------------------------------------------------------------------
# the fused record program and engine
# --------------------------------------------------------------------------

def _haplotype_reads(rng, n_reads, genome_len=6000, num_sites=130):
    """The M. tuberculosis-density graph of common/workload.py (1 site /
    46 bp) and 80 bp reads from 4 sampled haplotypes: (idx, reads)."""
    from gramtools_tpu_torch.common.workload import (
        build_synthetic_mtb_graph, sample_haplotypes, sample_reads)

    prg_ints = build_synthetic_mtb_graph(rng, genome_len, num_sites)
    prg = PrgString(prg_ints)
    paths = sample_haplotypes(prg_ints, dict(prg.end_positions), rng, 4)
    return build_prg_index(prg), list(sample_reads(rng, paths, n_reads, 80))


def _fused_engine(device, monkeypatch):
    """(engine, token, captured log_search_record arguments, kmer index)
    after one fused scan_submit on ``device``."""
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", "packed")
    idx, reads = _haplotype_reads(np.random.RandomState(9), 300)
    k = 7
    kmer_index = build_kmer_index_vectorised(idx, k)
    engine = LogBatchedEngine(idx, k, device=device)
    captured = {}

    def capture(*args, **kwargs):
        captured["args"], captured["kwargs"] = args, kwargs
        return log_search_record(*args, **kwargs)

    monkeypatch.setattr(engine_mod, "log_search_record", capture)
    first = first_raw_draws(np.asarray(RandomInclusiveInt(3).raw_block(
        len(reads)), dtype=np.uint32))
    token = engine.scan_submit(reads, kmer_index, k, QuasimapStats(),
                               first_raws=first)
    monkeypatch.undo()
    return engine, token, captured, kmer_index


def test_fused_record_flat_result_equal_on_cuda_and_cpu(cuda, monkeypatch):
    engine, token, cap, kmer_index = _fused_engine(cuda, monkeypatch)
    got = token[2][1].get()
    got_cov = engine.cov_diff[0].cpu()
    (di, rt, st, *rest), kw = cap["args"], cap["kwargs"]
    idx = engine.idx
    cov = torch.zeros(rt.cov_size + 1, dtype=torch.int32)
    want = log_search_record(
        DeviceIndex.build(idx, engine.jt, "cpu"), RecordTables.build(idx, "cpu"),
        SeedTables.build(kmer_index, "cpu"),
        *(a.cpu() for a in rest[:6]), cov, *rest[7:],
        blocks=kw["blocks"].cpu(), rank=kw["rank"]).numpy()
    np.testing.assert_array_equal(got, want)
    assert torch.equal(got_cov, cov)
    R = rest[8]
    assert got[2 * R:3 * R].any() and cov.any()


def test_fused_engine_on_cuda_matches_host_engine(cuda, monkeypatch,
                                                  tmp_path):
    """Whole quasimap runs, retries recorded on the card included: the
    fused engine on CUDA gives the host engine's coverage, and K2, K3
    (its hole-allocated and locked steps), K7 and K9 all launched."""
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", "packed")
    monkeypatch.setenv("GRAMTOOLS_TPU_RETRY_MIN", "1")
    idx_d, reads = _haplotype_reads(np.random.RandomState(4), 400)
    k = 7
    lut = np.array(list("NACGT"))
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{''.join(lut[r])}\n+\n{'I' * r.size}\n")
    engine = LogBatchedEngine(idx_d, k, LogConfig(pool=4096, hits=16),
                              device=cuda)
    counted = lambda: (wide_step.wide_steps.launches,
                       locked_step.locked_tail.launches,
                       locked_step.locked_tail.narrow_launches,
                       replay.replay.launches, walk.per_base_cuda.launches)
    before = counted()
    stats_d, cov_d = quasimap_reads(
        [str(fq)], build_kmer_index_vectorised(idx_d, k), idx_d, k, seed=1,
        engine=engine, buffer_size=100)
    after = counted()
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert engine.device_mapped > 0 and engine.device_retried > 0
    idx_h = _haplotype_reads(np.random.RandomState(4), 400)[0]
    stats_h, cov_h = quasimap_reads(
        [str(fq)], build_kmer_index_vectorised(idx_h, k), idx_h, k, seed=1)
    assert stats_d.as_dict() == stats_h.as_dict()
    assert cov_d.allele_sum == cov_h.allele_sum
    assert cov_d.grouped_counts == cov_h.grouped_counts
    np.testing.assert_array_equal(idx_d.graph.coverage, idx_h.graph.coverage)


def test_fused_scan_submit_does_not_synchronise(cuda, monkeypatch):
    """With the tables resident, a fused buffer's scan_submit enqueues
    without one host synchronisation."""
    engine, token, cap, kmer_index = _fused_engine(cuda, monkeypatch)
    token[2][1].get()
    reads = _haplotype_reads(np.random.RandomState(9), 300)[1][::-1]
    first = first_raw_draws(np.asarray(RandomInclusiveInt(4).raw_block(
        len(reads)), dtype=np.uint32))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        token = engine.scan_submit(reads, kmer_index, engine.kmer_size,
                                   QuasimapStats(), first_raws=first)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert token[2][0] == "record"
    token[2][1].get()


def test_fused_buffer_decodes_packed_reads_in_the_scan_kernels(cuda,
                                                               monkeypatch):
    """A fused buffer's scan decodes its packed reads in K2 and K3 (K6):
    both launches read the packed matrix and the plain unpack never
    runs."""
    from gramtools_tpu_torch.ops import packed_reads

    engine, token, cap, kmer_index = _fused_engine(cuda, monkeypatch)
    token[2][1].get()

    def refuse(*args, **kwargs):
        raise AssertionError("unpack_reads2 ran on the fused path")
    monkeypatch.setattr(packed_reads, "unpack_reads2", refuse)
    reads = _haplotype_reads(np.random.RandomState(9), 300)[1][::-1]
    first = first_raw_draws(np.asarray(RandomInclusiveInt(4).raw_block(
        len(reads)), dtype=np.uint32))
    before = (wide_step.wide_steps.packed_launches,
              locked_step.locked_tail.packed_launches)
    token = engine.scan_submit(reads, kmer_index, engine.kmer_size,
                               QuasimapStats(), first_raws=first)
    token[2][1].get()
    after = (wide_step.wide_steps.packed_launches,
             locked_step.locked_tail.packed_launches)
    assert after[0] > before[0] and after[1] > before[1]


# --------------------------------------------------------------------------
# the selection (K8)
# --------------------------------------------------------------------------

NESTED_PRGS = ["A[[A[CCC,C],T],G]TA", "A[T[TT,T]T,A[AT,]A]G[C,G]",
               "T[A[C,G][C,G],]T"]


def _nested_prg(rng, n_blocks=12):
    """Nested and plain sites between random 6-12 bp stretches."""
    parts = []
    for b in range(n_blocks):
        parts.append("".join(rng.choice(list("ACGT"), rng.randint(6, 13))))
        parts.append(NESTED_PRGS[b % 3] if b % 2 == 0 else
                     "[" + ",".join(rng.choice(list("ACGT"), 2)) + "]")
    return "".join(parts)


def _select_captured(kind, cuda, monkeypatch):
    """The arguments of one fused buffer's select_and_record_device on
    the card ("sites": the M. tuberculosis-density graph, 80 bp reads;
    "nested": nested sites, short reads, wide steps to the end so rows
    keep several states), and the graph's index."""
    from gramtools_tpu_torch.mapping import search_log

    rng = np.random.RandomState(21)
    if kind == "sites":
        idx, reads = _haplotype_reads(rng, 300)
        k = 7
    else:
        idx = build_prg_index(PrgString(prg_string_to_ints(_nested_prg(rng))))
        dna = idx.prg[(idx.prg >= 1) & (idx.prg <= 4)].astype(np.uint8)
        reads = [dna[s:s + ln].copy() for s, ln in zip(
            rng.randint(0, dna.size - 16, 120), rng.randint(5, 15, 120))]
        k = 3
        monkeypatch.setenv("GRAMTOOLS_TPU_NARROW", "0")
    captured = {}
    select = search_log.select_and_record_device

    def capture(*args, **kwargs):
        captured["args"], captured["kwargs"] = args, kwargs
        return select(*args, **kwargs)

    monkeypatch.setattr(search_log, "select_and_record_device", capture)
    engine = LogBatchedEngine(idx, k, LogConfig(pool=4096, hits=1024),
                              device=cuda)
    first = first_raw_draws(np.asarray(RandomInclusiveInt(5).raw_block(
        len(reads)), dtype=np.uint32))
    engine.scan_submit(reads, build_kmer_index_vectorised(idx, k), k,
                       QuasimapStats(), first_raws=first)[2][1].get()
    monkeypatch.undo()
    args = captured["args"]
    return idx, list(args[2:13]), captured["kwargs"]["trip_cap"]


def _select_random(seed, cuda, N=3000, R=500):
    """Random well-formed selection inputs on a nested graph: states on
    random rows (some dead), SA intervals of 1-4 rows, paths of up to
    TCAP loci at the graph's sites with alleles 0..1, traversing paths of
    0-2 sites, a few bad states and rows not ok, random first draws,
    reads of 1-29 bases."""
    rng = np.random.RandomState(seed)
    idx = build_prg_index(PrgString(prg_string_to_ints(_nested_prg(rng))))
    n_sites = RecordTables.build(idx, "cpu").anc_len.shape[0]
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32))
    n = idx.fm.size
    lo = rng.randint(0, n, N)
    markers = lambda shape: 5 + 2 * rng.randint(0, n_sites, shape)
    trav = np.stack([markers((N, TCAP)), rng.randint(0, 2, (N, TCAP))], -1)
    ing = np.stack([markers((N, TCAP)), np.full((N, TCAP), -1)], -1)
    n_trav = np.where(rng.rand(N) < 0.3, 0, rng.randint(0, TCAP + 1, N))
    n_ing = np.where(rng.rand(N) < 0.6, 0, rng.randint(0, 3, N))
    args = [i32(rng.randint(-1, R, N)), i32(lo),
            i32(np.minimum(lo + rng.randint(0, 4, N), n - 1)), i32(trav),
            i32(n_trav), i32(ing), i32(n_ing),
            torch.from_numpy(rng.rand(N) < 0.05),
            torch.from_numpy(rng.rand(R) < 0.9),
            torch.from_numpy(rng.randint(0, 1 << 32, R, dtype=np.int64)),
            i32(rng.randint(1, 30, R))]
    return idx, [a.to(cuda) for a in args], 4 * R


def _select_both(idx, args, trip_cap, stage=99):
    """select_and_record_device on the card (K8's kernels) and on the CPU
    (the plain version): ([outputs..., cov_diff], [...]), on the CPU."""
    cuda = args[0].device
    outs = []
    for dev in (cuda, torch.device("cpu")):
        di = DeviceIndex.build(idx, device=dev)
        rt = RecordTables.build(idx, dev)
        cov = torch.zeros(rt.cov_size + 1, dtype=torch.int32, device=dev)
        out = record.select_and_record_device(
            di, rt, *(a.to(dev) for a in args), cov, trip_cap=trip_cap,
            stage=stage)
        outs.append([o.cpu() for o in out] + [cov.cpu()])
    return outs


SELECT_BUDGETS = {
    "default": {}, "ecap2": dict(caps=dict(ecap=2)),
    "trcap2": dict(caps=dict(trcap=2)), "lcap8": dict(caps=dict(lcap=8)),
    "wcap8": dict(caps=dict(wcap=8)), "emitcap4": dict(caps=dict(emitcap=4)),
    "kcap1": dict(kcap=1), "trip16": dict(trip_cap=16), "rng": dict(rng=True)}


def _select_budget(name, monkeypatch, args, trip_cap):
    """SELECT_BUDGETS[name] patched into the port (caps, KCAP), or the
    inputs' trip_cap and first draws replaced; returns (args, trip_cap)."""
    spec = SELECT_BUDGETS[name]
    if "caps" in spec:
        base = buffer_caps
        over = spec["caps"]
        keys = ("ecap", "trcap", "wcap", "emitcap", "lcap")
        monkeypatch.setattr(record, "buffer_caps", lambda R: tuple(
            over.get(k, v) for k, v in zip(keys, base(R))))
    if "kcap" in spec:
        monkeypatch.setattr(record, "KCAP", spec["kcap"])
    if spec.get("rng"):
        args = list(args)
        raw = args[9].clone()
        raw[::3] = (1 << 32) - 1
        args[9] = raw
    return args, spec.get("trip_cap", trip_cap)


@pytest.mark.parametrize("budget", sorted(SELECT_BUDGETS))
@pytest.mark.parametrize("kind", ["sites", "nested", "random"])
def test_select_kernels_match_plain(cuda, monkeypatch, kind, budget):
    """K8's kernels (csrc/select.cu, K9 between them) against the plain
    version on the CPU: fallback, mapped, the whole triple arrays and
    cov_diff bit for bit, on a fused buffer's own inputs and on random
    well-formed ones, at every forced budget."""
    if kind == "random":
        idx, args, trip_cap = _select_random(3, cuda)
    else:
        idx, args, trip_cap = _select_captured(kind, cuda, monkeypatch)
    args, trip_cap = _select_budget(budget, monkeypatch, args, trip_cap)
    from gramtools_tpu_torch.ops import select

    before = select.select_cuda.launches
    got, want = _select_both(idx, args, trip_cap)
    assert select.select_cuda.launches == before + 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"output {i}"
    assert want[1].any()                            # rows mapped
    if kind != "random" and budget == "default":    # triples, coverage
        assert (want[2] <= args[8].shape[0]).any() and want[-1].any()


@pytest.mark.parametrize("stage", [0, 1, 2, 3, 4, 5, 6, 99])
@pytest.mark.parametrize("kind", ["sites", "random"])
def test_select_kernels_each_stage(cuda, monkeypatch, kind, stage):
    """Each profiling stage on the card equals the plain version at that
    stage (a trip_cap below the lanes, so stage 5 checks)."""
    if kind == "random":
        idx, args, _ = _select_random(4, cuda)
    else:
        idx, args, _ = _select_captured(kind, cuda, monkeypatch)
    got, want = _select_both(idx, args, 64, stage=stage)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"stage {stage}, output {i}"


def test_select_kernels_on_a_small_grid(cuda, monkeypatch):
    """Three blocks: every chunked scan and sort runs many chunks and
    tiles a block."""
    from gramtools_tpu_torch.ops import select

    monkeypatch.setattr(select, "GRID_CAP", 3)
    idx, args, trip_cap = _select_random(5, cuda)
    got, want = _select_both(idx, args, trip_cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_select_repeated_launches_identical(cuda, monkeypatch):
    """20 launches on the same inputs (atomics, races): equal outputs."""
    idx, args, trip_cap = _select_captured("sites", cuda, monkeypatch)
    di = DeviceIndex.build(idx, device=cuda)
    rt = RecordTables.build(idx, cuda)
    runs = []
    for _ in range(20):
        cov = torch.zeros(rt.cov_size + 1, dtype=torch.int32, device=cuda)
        out = record.select_and_record_device(di, rt, *args, cov,
                                              trip_cap=trip_cap)
        runs.append([o.cpu() for o in out] + [cov.cpu()])
    for run in runs[1:]:
        for g, w in zip(run, runs[0]):
            assert torch.equal(g, w)


def test_select_does_not_synchronise(cuda, monkeypatch):
    """select_and_record_device on CUDA (both launches and K9) enqueues
    without a host synchronisation and never runs the plain version."""
    idx, args, trip_cap = _select_captured("sites", cuda, monkeypatch)
    di = DeviceIndex.build(idx, device=cuda)
    rt = RecordTables.build(idx, cuda)
    cov = torch.zeros(rt.cov_size + 1, dtype=torch.int32, device=cuda)
    record.select_and_record_device(di, rt, *args, cov, trip_cap=trip_cap)
    torch.cuda.synchronize()

    def plain(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(record, "select_torch", plain)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = record.select_and_record_device(di, rt, *args, cov,
                                              trip_cap=trip_cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out[2].shape == (trip_cap,)


def test_select_wrapper_checks_inputs(cuda):
    from gramtools_tpu_torch.ops import select

    idx, args, trip_cap = _select_random(6, cuda, N=200, R=50)
    rt = RecordTables.build(idx, cuda)
    sa = DeviceIndex.build(idx, device=cuda).sa
    tables = [sa, rt.ra_node, rt.nt_site, rt.nt_allele, rt.anc_len,
              rt.anc_site, rt.anc_allele, rt.base_site, rt.max_anc]
    raw = args[:10]
    ok = dict(ecap=64, lcap=64, trcap=64, kcap=12, trip_cap=trip_cap)
    select.select_cuda(*tables, *raw, **ok)              # takes these
    with pytest.raises(TypeError):
        select.select_cuda(*tables, *([raw[0].long()] + raw[1:]), **ok)
    with pytest.raises(TypeError):                       # first draws int64
        select.select_cuda(*tables, *(raw[:9] + [raw[9].int()]), **ok)
    with pytest.raises(ValueError):
        select.select_cuda(*tables, *(raw[:1] + [raw[1][:-1]] + raw[2:]),
                           **ok)
    with pytest.raises(ValueError):                      # mixed devices
        select.select_cuda(*tables, *(raw[:8] + [raw[8].cpu()] + raw[9:]),
                           **ok)
    with pytest.raises(ValueError):
        select.select_cuda(*tables, *raw, **dict(ok, kcap=13))
    with pytest.raises(ValueError):
        select.select_cuda(*tables, *raw, **dict(ok, ecap=0))
    with pytest.raises(ValueError):                      # CPU tensors
        select.select_cuda(*(t.cpu() if torch.is_tensor(t) else t
                             for t in tables), *(a.cpu() for a in raw), **ok)


def _select_on(idx, args, trip_cap, stage=99):
    """select_and_record_device on the card only: [outputs..., cov_diff]."""
    cuda = args[0].device
    di = DeviceIndex.build(idx, device=cuda)
    rt = RecordTables.build(idx, cuda)
    cov = torch.zeros(rt.cov_size + 1, dtype=torch.int32, device=cuda)
    out = record.select_and_record_device(di, rt, *args, cov,
                                          trip_cap=trip_cap, stage=stage)
    return [o.cpu() for o in out] + [cov.cpu()]


@pytest.mark.parametrize("stage", [3, 5, 99])
@pytest.mark.parametrize("kind", ["sites", "random"])
def test_select_wide_keys_match_64_bit_keys(cuda, monkeypatch, kind, stage):
    """The 128-bit key instance forced on the same buffer: equal to the
    64-bit instance (the path's, which ``key_bits`` picks here) and to
    the plain version."""
    from gramtools_tpu_torch.ops import select

    if kind == "random":
        idx, args, trip_cap = _select_random(7, cuda)
    else:
        idx, args, trip_cap = _select_captured(kind, cuda, monkeypatch)
    rt = RecordTables.build(idx, "cpu")
    assert not select.wide_keys(select.key_bits(
        args[0].shape[0] + buffer_caps(args[8].shape[0])[0],
        args[8].shape[0], rt.anc_len.shape[0], rt.nt_site.shape[0]))
    narrow = _select_on(idx, args, trip_cap, stage)
    monkeypatch.setattr(select, "WIDE_KEYS", True)
    got, want = _select_both(idx, args, trip_cap, stage)
    for i, (g, n, w) in enumerate(zip(got, narrow, want)):
        assert torch.equal(g, n), f"wide != 64-bit keys, output {i}"
        assert torch.equal(g, w), f"wide != plain, output {i}"


@pytest.mark.parametrize("wide", [False, True])
def test_select_each_instance_repeated_launches_identical(cuda, monkeypatch,
                                                          wide):
    """20 launches of each key instance on the same inputs (the sorts'
    and scans' look-backs can race): equal outputs, equal to the plain
    version."""
    from gramtools_tpu_torch.ops import select

    idx, args, trip_cap = _select_captured("nested", cuda, monkeypatch)
    monkeypatch.setattr(select, "WIDE_KEYS", wide)
    want = _select_both(idx, args, trip_cap)[1]
    for _ in range(20):
        for i, (g, w) in enumerate(zip(_select_on(idx, args, trip_cap),
                                       want)):
            assert torch.equal(g, w), f"output {i}"


def test_select_lanes_past_the_grid(cuda, monkeypatch):
    """Two blocks: the lanes span many more sort tiles (8 keys a thread)
    and scan tiles than the grid has blocks, so each block takes many
    tiles of every pass and scan in turn."""
    from gramtools_tpu_torch.ops import select

    monkeypatch.setattr(select, "GRID_CAP", 2)
    idx, args, trip_cap = _select_captured("sites", cuda, monkeypatch)
    ecap, trcap, _, _, lcap = buffer_caps(args[8].shape[0])
    assert lcap + trcap > 4 * 2 * 256 * 8
    got, want = _select_both(idx, args, trip_cap)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"output {i}"


def test_select_lanes_in_one_tile(cuda, monkeypatch):
    """Budgets so small that every scan (the states, the rows, the
    encapsulated lanes) and both sorts (lcap + trcap lanes and their
    ancestors, at most 256) fit in one tile, which alone publishes its
    inclusive prefix, with the spills they flag: equal to the plain
    version."""
    idx, args, trip_cap = _select_random(8, cuda, N=120, R=40)
    A = max(RecordTables.build(idx, "cpu").max_anc, 0)
    trcap = 16
    small = dict(ecap=64, trcap=trcap, lcap=256 // (A + 1) - trcap)
    keys = ("ecap", "trcap", "wcap", "emitcap", "lcap")
    monkeypatch.setattr(record, "buffer_caps", lambda R: tuple(
        small.get(k, v) for k, v in zip(keys, buffer_caps(R))))
    assert (small["lcap"] + trcap) * (A + 1) <= 256 and small["lcap"] > 0
    got, want = _select_both(idx, args, trip_cap)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"output {i}"
    assert want[1].any()


# --------------------------------------------------------------------------
# the mesh and the index-sharded scan on the card
# --------------------------------------------------------------------------

def _mesh_quasimap(devices, tmp_path, name):
    from gramtools_tpu_torch.mapping.quasimap import quasimap_reads as port_qm
    from gramtools_tpu_torch.parallel.mesh import MeshLogEngine, make_mesh

    idx, reads = _haplotype_reads(np.random.RandomState(4), 400)
    k = 7
    lut = np.array(list("NACGT"))
    fq = tmp_path / f"{name}.fastq"
    with open(fq, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{''.join(lut[r])}\n+\n{'I' * r.size}\n")
    engine = MeshLogEngine(idx, k, mesh=make_mesh(devices=devices),
                           cfg=LogConfig(pool=4096, hits=16))
    stats, cov = port_qm([str(fq)], build_kmer_index_vectorised(idx, k), idx,
                         k, seed=1, engine=engine, buffer_size=100)
    return stats, cov, idx.graph.coverage.copy(), engine


def test_mesh_engine_on_cuda_matches_cpu_mesh(cuda, monkeypatch, tmp_path):
    """Two shards on the card (one device listed twice) give the CPU
    2-shard engine's stats and coverage, retries included, and K2, K3,
    K7 and K9 launch (K1's rank runs inside K2 and K3)."""
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", "packed")
    monkeypatch.setenv("GRAMTOOLS_TPU_RETRY_MIN", "1")
    counted = lambda: (wide_step.wide_steps.launches,
                       locked_step.locked_tail.launches,
                       replay.replay.launches, walk.per_base_cuda.launches)
    before = counted()
    got = _mesh_quasimap([cuda, cuda], tmp_path, "cuda")
    after = counted()
    assert all(a > b for a, b in zip(after, before)), (before, after)
    want = _mesh_quasimap(["cpu", "cpu"], tmp_path, "cpu")
    assert got[0].as_dict() == want[0].as_dict()
    assert got[1].allele_sum == want[1].allele_sum
    assert got[1].grouped_counts == want[1].grouped_counts
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3].S == 2 and got[3].device_mapped > 0
    for name in ("device_mapped", "host_fallbacks", "device_retried",
                 "fallback_reasons"):
        assert getattr(got[3], name) == getattr(want[3], name), name


def test_index_sharded_scan_on_cuda_equals_replicated(cuda):
    from gramtools_tpu_torch.mapping.search_log import log_search_phases
    from gramtools_tpu_torch.mapping.search_log_host import auto_phases
    from gramtools_tpu_torch.parallel.dryrun import _seeded_scan_inputs
    from gramtools_tpu_torch.parallel.mesh import Mesh
    from gramtools_tpu_torch.parallel.sharded_index import \
        make_index_sharded_log_search

    idx = _idx()
    di = DeviceIndex.build(idx, device=cuda)
    cfg = LogConfig(pool=256, hits=64)
    R = 64
    reads_T, carry = _seeded_scan_inputs(idx, np.random.RandomState(0), R,
                                         32, cfg.pool)
    args = (torch.from_numpy(reads_T).to(cuda),
            tuple(torch.from_numpy(a).to(cuda) for a in carry))
    got = make_index_sharded_log_search(Mesh([cuda] * 4, ("idx",)), di, cfg,
                                        R)(*args)
    want = log_search_phases(di, *args, auto_phases(32, R, cfg, narrow=True),
                             R)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.device.type == "cuda" and torch.equal(g, w)
    assert (want[1][0] >= 0).any()


@pytest.mark.parametrize("spread", ["one_card", "across_cards"])
def test_index_sharded_scan_does_not_synchronise(cuda, spread):
    """A warm index-sharded scan (4 shards on the card, or the shards on
    the machine's cards with an all-reduce between launches) enqueues
    every launch without one host synchronisation."""
    from gramtools_tpu_torch.mapping.search_log_host import auto_phases
    from gramtools_tpu_torch.parallel.mesh import Mesh
    from gramtools_tpu_torch.parallel.sharded_index import \
        make_index_sharded_log_search

    devices = [cuda] * 4 if spread == "one_card" else _cards(2)
    R = 64
    di, cfg, reads_T, carry = _index_sharded_case(cuda, R)
    args = (torch.from_numpy(reads_T).to(cuda),
            tuple(torch.from_numpy(a).to(cuda) for a in carry))
    run = make_index_sharded_log_search(Mesh(devices, ("idx",)), di, cfg, R,
                                        phases=auto_phases(32, R, cfg,
                                                           narrow=True))
    want = run(*args)
    for d in set(devices):
        torch.cuda.synchronize(d)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)


def test_mesh_scan_submit_does_not_synchronise(cuda, monkeypatch):
    """A warm 2-shard fused scan_submit on the card enqueues both shards
    without one host synchronisation."""
    from gramtools_tpu_torch.parallel.mesh import MeshLogEngine, make_mesh

    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", "packed")
    idx, reads = _haplotype_reads(np.random.RandomState(9), 300)
    k = 7
    kmer_index = build_kmer_index_vectorised(idx, k)
    engine = MeshLogEngine(idx, k, mesh=make_mesh(devices=[cuda, cuda]))

    def submit(rs, seed):
        first = first_raw_draws(np.asarray(RandomInclusiveInt(seed).raw_block(
            len(rs)), dtype=np.uint32))
        return engine.scan_submit(rs, kmer_index, k, QuasimapStats(),
                                  first_raws=first)

    submit(reads, 3)[2][1].get()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        token = submit(reads[::-1], 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert token[2][0] == "record" and engine.S == 2
    token[2][1].get()
    assert [tuple(r.shape) for r in engine.cov_diff] == [
        (engine.rt.cov_size + 1,)] * 2


# --------------------------------------------------------------------------
# across cards: skipped on a machine with one
# --------------------------------------------------------------------------

def _cards(n_min: int):
    n = torch.cuda.device_count()
    if n < n_min:
        pytest.skip(f"needs {n_min} CUDA devices, {n} here")
    return [torch.device("cuda", i) for i in range(min(n, 4))]


def test_mesh_engine_across_cards_matches_one_card(cuda, monkeypatch,
                                                  tmp_path):
    """One shard per card: the 1-card engine's stats and coverage, the
    tables resident once on every other card, and the path's kernels
    launched on them (K2 and K3, with K1's packed rank inside them; K7,
    K8 and K9)."""
    from gramtools_tpu_torch.ops import select

    cards = _cards(2)
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", "packed")
    monkeypatch.setenv("GRAMTOOLS_TPU_RETRY_MIN", "1")
    counted = lambda: (wide_step.wide_steps.launches,
                       locked_step.locked_tail.launches,
                       replay.replay.launches, select.select_cuda.launches,
                       walk.per_base_cuda.launches)
    before = counted()
    got = _mesh_quasimap(cards, tmp_path, "cards")
    after = counted()
    assert all(a > b for a, b in zip(after, before)), (before, after)
    want = _mesh_quasimap([cuda], tmp_path, "one")
    assert got[0].as_dict() == want[0].as_dict()
    assert got[1].allele_sum == want[1].allele_sum
    assert got[1].grouped_counts == want[1].grouped_counts
    np.testing.assert_array_equal(got[2], want[2])
    engine = got[3]
    assert engine.S == len(cards) and engine.device_mapped > 0
    assert {dev for _, dev in engine._replicas} == set(cards[1:])
    assert {name for name, _ in engine._replicas} == {"di", "blocks", "rt",
                                                      "st"}


def test_index_sharded_scan_across_cards_equals_replicated(cuda,
                                                          monkeypatch):
    """The index split over 2 and 4 cards ("idx"), and over a 2 x 2
    ("data", "idx") mesh where the machine has 4: every card of a row
    runs the round kernels on its own shards, 2 launches a step and 1 a
    card and an all-reduce between two launches (the plain gather never
    called, no K2 or K3), equal to the replicated scan over 20 repeated
    scans, every card of a row ending with the same carry and log; a row
    whose cards NCCL cannot serve raises, naming them."""
    from gramtools_tpu_torch.mapping.search_log import log_search_phases
    from gramtools_tpu_torch.mapping.search_log_host import auto_phases
    from gramtools_tpu_torch.mapping.search_log_host import _phase4
    from gramtools_tpu_torch.ops import sharded
    from gramtools_tpu_torch.parallel.mesh import Mesh
    from gramtools_tpu_torch.parallel.sharded_index import \
        make_index_sharded_log_search

    cards = _cards(2)
    R = 64
    di, cfg, reads_T, carry = _index_sharded_case(cuda, R)
    args = (torch.from_numpy(reads_T).to(cuda),
            tuple(torch.from_numpy(a).to(cuda) for a in carry))
    plan = auto_phases(32, R, cfg, narrow=True)
    want = log_search_phases(di, *args, plan, R)
    for n in sorted({2, len(cards)}):
        run = make_index_sharded_log_search(Mesh(cards[:n], ("idx",)), di,
                                            cfg, R)
        with monkeypatch.context() as m:
            _no_plain_gather(m)
            before = _k10_counts()
            outs = [run(*args) for _ in range(20)]
            torch.cuda.synchronize()
            assert _k10_counts() == (before[0] + 20 * n * (2 * 32 + 1),
                                     before[1] + 20 * 2 * 32, before[2],
                                     before[3])
        for got in outs:
            for g, w in zip(got[0] + got[1], want[0] + want[1]):
                assert g.device == cards[0] and torch.equal(g, w)
        # every card of the row: the same carry, flags and log
        tables = sharded.build_tables(
            di.occ.cpu().numpy(), di.narrow_tab.cpu().numpy(), di.size,
            cards[:n], cards[0])
        L = want[1][0].numel()
        lp, le = (torch.empty(L, dtype=torch.int32, device=cuda)
                  for _ in range(2))
        c5 = args[1][:4] + (torch.cat([args[1][4].to(torch.bool),
                                       torch.zeros(1, dtype=torch.bool,
                                                   device=cuda)]),)
        per_card = sharded.sharded_rounds(
            di, args[0].to(torch.int32).contiguous(), c5,
            [_phase4(e) for e in plan], R, lp, le, tables)
        assert set(per_card) == set(cards[:n])
        home = per_card[cards[0]]
        for card, (c, log) in per_card.items():
            for a, b in zip(c + log, home[0] + home[1]):
                assert a.device == card and torch.equal(a.cpu(), b.cpu())
        for a, b in zip(home[0][:4] + home[1], want[0][:4] + want[1]):
            assert torch.equal(a, b)
    if len(cards) >= 4:
        # data shard d scans its half of the reads on card 2d and reads
        # the shards on cards 2d and 2d + 1
        half = R // 2
        halves = [_index_sharded_case(cuda, half)[2:] for _ in range(2)]
        rng = np.random.RandomState(5)
        halves = [(rt[:, rng.permutation(half)], c) for rt, c in halves]
        rt2 = np.concatenate([h[0] for h in halves], axis=1)
        c2 = tuple(np.concatenate(cs) for cs in zip(*[h[1] for h in halves]))
        mesh = Mesh(np.array(cards[:4], dtype=object).reshape(2, 2),
                    ("data", "idx"))
        run2 = make_index_sharded_log_search(mesh, di, cfg, half)
        with monkeypatch.context() as m:
            _no_plain_gather(m)
            got2 = run2(torch.from_numpy(rt2).to(cuda),
                        tuple(torch.from_numpy(a).to(cuda) for a in c2))
        for d, (rt, c) in enumerate(halves):
            ref = log_search_phases(
                di, torch.from_numpy(rt).to(cuda),
                tuple(torch.from_numpy(a).to(cuda) for a in c),
                auto_phases(32, half, cfg, narrow=True), half)
            for g, w in zip(got2[0] + got2[1], ref[0] + ref[1]):
                m_ = w.numel()
                assert torch.equal(g[d * m_:(d + 1) * m_], w)
    # a row whose cards NCCL cannot serve raises, naming them
    from torch.cuda import nccl

    run = make_index_sharded_log_search(Mesh(cards[:2], ("idx",)), di, cfg,
                                        R)
    monkeypatch.setattr(nccl, "is_available", lambda tensors: False)
    with pytest.raises(RuntimeError, match=f"cuda:{cards[0].index}, "
                                           f"cuda:{cards[1].index}"):
        run(*args)


def test_nccl_all_reduce_across_cards():
    """One process per card: init_distributed picks nccl for a CUDA
    engine device, and the ranks all-reduce on their cards."""
    from test_torch_distributed import run_ranks

    cards = _cards(2)
    for r, (rc, out, err) in enumerate(run_ranks([str(c) for c in cards])):
        assert rc == 0, (r, out, err)
        assert f"RANK-OK {r} nccl cuda:{r}" in out
