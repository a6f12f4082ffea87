"""The port on a CUDA device: the packed-rank (K1), genealogy-replay
(K7) and per-base walk (K9) kernels against their plain torch twins,
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

import numpy as np
import pytest
import torch

from gramtools_tpu.common.rng import RandomInclusiveInt, first_raw_draws
from gramtools_tpu.common.seq import revcomp
from gramtools_tpu.index.build import build_prg_index
from gramtools_tpu.index.fm import FMIndex
from gramtools_tpu.index.kmer_index import build_kmer_index
from gramtools_tpu.index.kmer_index_vec import build_kmer_index_vectorised
from gramtools_tpu.mapping.quasimap import (QuasimapStats,
                                            all_read_kmers_in_index,
                                            quasimap_reads)
from gramtools_tpu.mapping.search import search_read_backwards
from gramtools_tpu.prg.linearise import PrgString, prg_string_to_ints
from gramtools_tpu_torch.mapping import engine as engine_mod
from gramtools_tpu_torch.mapping.device_index import DeviceIndex
from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
from gramtools_tpu_torch.mapping.record import RecordTables, SeedTables
from gramtools_tpu_torch.mapping.search_log import (log_search_packed,
                                                    log_search_record)
from gramtools_tpu_torch.mapping.search_log_host import TCAP, LogConfig
from gramtools_tpu_torch.ops import rank, replay, walk

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
    token = engine.scan_submit(_reads(idx, 200, 60, 3), kmer_index, k,
                               QuasimapStats())
    (pending, phases, R), carry, reads_T = token[2], token[5], token[6]
    got = pending.get()
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
    before = rank.packed_rank.launches
    results = engine.search_buffer(reads, kmer_index, k, QuasimapStats())
    assert engine.device_mapped > 0 and engine.device_retried > 0
    assert (rank.packed_rank.launches > before) == (rank_kind == "packed")
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


def test_cuda_device_from_environment(cuda, monkeypatch):
    from gramtools_tpu_torch.common.device import get_device

    monkeypatch.delenv("GRAMTOOLS_TORCH_DEVICE", raising=False)
    assert get_device().type == "cuda"
    assert os.environ.get("GRAMTOOLS_TORCH_DEVICE") is None


# --------------------------------------------------------------------------
# K7 (replay) and K9 (walk)
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


@pytest.mark.parametrize("N,L,max_chain", [(1, 1, 32), (300, 2000, 32),
                                           (30_720, 1_500_000, 32),
                                           (4096, 50_000, 3)])
def test_replay_kernel_matches_twin(cuda, N, L, max_chain):
    rng = np.random.RandomState(N)
    args = _replay_inputs(rng, N, L, 500, 64, 3, 20, "cpu")
    before = replay.replay.launches
    got = replay.replay(*_on(cuda, args), max_chain=max_chain, tcap=TCAP)
    torch.cuda.synchronize()
    assert replay.replay.launches == before + 1
    want = replay.replay_torch(*args, max_chain=max_chain, tcap=TCAP)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert want[4].any()                  # some chains or paths overran


def _walk_inputs(rng, rt, lanes, n_items, device):
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32)).to(device)
    return dict(
        nt_walk=rt.nt_walk.to(device), nt_edges=rt.nt_edges.to(device),
        valid=torch.from_numpy(rng.rand(lanes) < 0.9).to(device),
        cur0=i32(rng.randint(0, rt.n_nodes, lanes)),
        start0=i32(np.zeros(lanes)),
        remaining0=i32(rng.randint(1, 150, lanes)),
        trav_idx0=i32(rng.randint(0, 6, lanes)),
        w_item=i32(rng.randint(0, n_items, lanes)),
        read_of=i32(rng.randint(0, 1000, lanes)),
        full=torch.from_numpy(rng.rand(lanes) < 0.7).to(device),
        ps_trav=i32(rng.randint(0, 2, (n_items, TCAP, 2))))


@pytest.mark.parametrize("lanes,emitcap", [(1, 16), (500, 8192),
                                           (24_576, 98_304), (2000, 64)])
def test_walk_kernel_matches_twin(cuda, lanes, emitcap):
    rt = RecordTables.build(_idx(genome_len=20_000, num_sites=400), "cpu")
    rng = np.random.RandomState(lanes)
    args = _walk_inputs(rng, rt, lanes, 64, "cpu")
    before = walk.walk.launches
    got, spill = walk.walk(**{k: v.to(cuda) for k, v in args.items()},
                           emitcap=emitcap, max_iter=rt.n_nodes + 2)
    torch.cuda.synchronize()
    assert walk.walk.launches == before + 1
    want, want_spill = walk.walk_torch(**args, emitcap=emitcap,
                                       max_iter=rt.n_nodes + 2)
    assert bool(spill) == bool(want_spill)
    if not bool(want_spill):
        # emission order is the atomics'; the multiset is the contract
        key = lambda e: sorted(map(tuple, e.cpu().numpy().tolist()))
        assert key(got) == key(want)
    else:
        assert int((got[:, 0] < walk.BIG).sum()) == emitcap


def test_replay_and_walk_wrappers_check_inputs(cuda):
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
    rt = RecordTables.build(_idx(), "cpu")
    w = {k: v.to(cuda) for k, v in _walk_inputs(rng, rt, 32, 4, "cpu").items()}
    with pytest.raises(TypeError):
        walk.walk(**dict(w, cur0=w["cur0"].long()), emitcap=64, max_iter=99)
    with pytest.raises(ValueError):
        walk.walk(**dict(w, start0=w["start0"][:-1]), emitcap=64,
                  max_iter=99)
    with pytest.raises(ValueError):
        walk.walk_cuda(**dict(w, ps_trav=w["ps_trav"].cpu()), emitcap=64,
                       max_iter=99)


# --------------------------------------------------------------------------
# the fused record program and engine
# --------------------------------------------------------------------------

def _haplotype_reads(rng, n_reads, genome_len=6000, num_sites=130):
    """bench.py's M. tuberculosis-density graph (1 site / 46 bp) and 80
    bp reads from 4 sampled haplotypes: (idx, reads)."""
    from bench import (build_synthetic_mtb_graph, sample_haplotypes,
                       sample_reads)

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
    fused engine on CUDA gives the host engine's coverage, and K1, K7
    and K9 all launched."""
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
    before = (rank.packed_rank.launches, replay.replay.launches,
              walk.walk.launches)
    stats_d, cov_d = quasimap_reads(
        [str(fq)], build_kmer_index_vectorised(idx_d, k), idx_d, k, seed=1,
        engine=engine, buffer_size=100)
    after = (rank.packed_rank.launches, replay.replay.launches,
             walk.walk.launches)
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
    2-shard engine's stats and coverage, retries included, and K1, K7
    and K9 launch."""
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", "packed")
    monkeypatch.setenv("GRAMTOOLS_TPU_RETRY_MIN", "1")
    before = (rank.packed_rank.launches, replay.replay.launches,
              walk.walk.launches)
    got = _mesh_quasimap([cuda, cuda], tmp_path, "cuda")
    after = (rank.packed_rank.launches, replay.replay.launches,
             walk.walk.launches)
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
    tables resident once on every other card, and K1, K7 and K9 launched
    on them."""
    cards = _cards(2)
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", "packed")
    monkeypatch.setenv("GRAMTOOLS_TPU_RETRY_MIN", "1")
    before = (rank.packed_rank.launches, replay.replay.launches,
              walk.walk.launches)
    got = _mesh_quasimap(cards, tmp_path, "cards")
    after = (rank.packed_rank.launches, replay.replay.launches,
             walk.walk.launches)
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


def test_index_sharded_scan_across_cards_equals_replicated(cuda):
    from gramtools_tpu_torch.mapping.search_log import log_search_phases
    from gramtools_tpu_torch.mapping.search_log_host import auto_phases
    from gramtools_tpu_torch.parallel.dryrun import _seeded_scan_inputs
    from gramtools_tpu_torch.parallel.mesh import Mesh
    from gramtools_tpu_torch.parallel.sharded_index import \
        make_index_sharded_log_search

    cards = _cards(2)
    idx = _idx()
    di = DeviceIndex.build(idx, device=cuda)
    cfg = LogConfig(pool=256, hits=64)
    R = 64
    reads_T, carry = _seeded_scan_inputs(idx, np.random.RandomState(0), R,
                                         32, cfg.pool)
    args = (torch.from_numpy(reads_T).to(cuda),
            tuple(torch.from_numpy(a).to(cuda) for a in carry))
    got = make_index_sharded_log_search(Mesh(cards, ("idx",)), di, cfg,
                                        R)(*args)
    want = log_search_phases(di, *args, auto_phases(32, R, cfg, narrow=True),
                             R)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.device == cards[0] and torch.equal(g, w)


def test_nccl_all_reduce_across_cards():
    """One process per card: init_distributed picks nccl for a CUDA
    engine device, and the ranks all-reduce on their cards."""
    from test_torch_distributed import run_ranks

    cards = _cards(2)
    for r, (rc, out, err) in enumerate(run_ranks([str(c) for c in cards])):
        assert rc == 0, (r, out, err)
        assert f"RANK-OK {r} nccl cuda:{r}" in out
