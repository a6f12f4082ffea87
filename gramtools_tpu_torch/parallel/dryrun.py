"""Entry points for a quick run of the port's scan and of its
multi-device paths on explicit devices.

Torch twins of the repository's ``__graft_entry__.entry`` and
``dryrun_multichip``: ``entry`` returns the flagship scan and its
arguments on a small nested PRG; ``dryrun_multichip`` drives the mesh
engine's fused pipeline and the SA-range-sharded index scan over the
devices it is given (one device may be listed more than once, so the
CPU or one card can stand in for several), and checks results, not
only that something ran: the S-shard coverage must equal the 1-shard
coverage of the same buffer, and the index-sharded scan must equal the
replicated scan.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

TOY_PRG = ("ACGTACGT[AC,GT]TTACG[A,C,GG]ACACG"
           "[T[A,C]G,AA]CGTACGTTTT[AAA,]GGGCACGT")


def _toy_index():
    from gramtools_tpu.index.build import build_prg_index
    from gramtools_tpu.prg.linearise import PrgString, prg_string_to_ints

    return build_prg_index(PrgString(prg_string_to_ints(TOY_PRG)))


def _check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def _seeded_scan_inputs(idx, rng, n_reads: int, length: int, pool: int):
    """reads_T (length, n_reads) and a carry with one full-interval seed
    state per read, as numpy arrays."""
    ref_path = idx.prg[idx.prg <= 4].astype(np.int32)
    starts = rng.randint(0, ref_path.size - length, size=n_reads)
    reads = np.stack([ref_path[s:s + length][::-1] for s in starts])
    carry = (np.full(pool, -1, np.int32), np.zeros(pool, np.int32),
             np.zeros(pool, np.int32), np.zeros(pool, np.int32),
             np.zeros(n_reads, bool))
    carry[0][:n_reads] = np.arange(n_reads)
    carry[2][:n_reads] = idx.fm.size - 1
    carry[3][:n_reads] = -(np.arange(n_reads) + 1)
    return reads.T.astype(np.uint8), carry


def entry(device="cpu"):
    """The genealogy-log scan on a small nested PRG: returns (fn, args)
    with ``fn(*args)`` -> (final carry, (log_parent, log_event))."""
    from ..mapping.device_index import DeviceIndex
    from ..mapping.search_log import log_search_phases

    idx = _toy_index()
    dev = torch.device(device)
    di = DeviceIndex.build(idx, device=dev)
    R, steps = 8, 16
    reads_T, carry = _seeded_scan_inputs(idx, np.random.RandomState(0), R,
                                         steps, 32)
    fn = functools.partial(log_search_phases, di, phases=((steps, 32, 16),),
                           num_reads=R)
    return fn, (torch.from_numpy(reads_T).to(dev),
                tuple(torch.from_numpy(a).to(dev) for a in carry))


def dryrun_multichip(devices: Sequence) -> dict:
    """The production multi-device paths over ``devices``:

    1. MeshLogEngine's fused pipeline (kmer screen, vectorised seeding,
       per-shard scan + device-side selection + coverage recording, per
       shard diff rows, overflow retry) on one buffer, held equal to a
       1-shard run of the same buffer, plus the non-fused search_buffer;
    2. the SA-range-sharded index on a ("data", "idx") mesh (("idx",)
       for an odd or small count), held equal to the replicated scan.

    Raises on any failed check; returns a summary."""
    from gramtools_tpu.common.rng import RandomInclusiveInt, first_raw_draws
    from gramtools_tpu.index.kmer_index_vec import build_kmer_index_vectorised
    from gramtools_tpu.mapping.coverage import Coverage
    from gramtools_tpu.mapping.quasimap import QuasimapStats

    from ..mapping.device_index import DeviceIndex
    from ..mapping.search_log import log_search_phases
    from ..mapping.search_log_host import LogConfig, auto_phases
    from .mesh import Mesh, MeshLogEngine, make_mesh
    from .sharded_index import make_index_sharded_log_search

    devices = [torch.device(d) for d in devices]
    n = len(devices)
    k = 4

    # ---- 1. the fused pipeline over the mesh, against 1 shard ----------
    def record(mesh):
        idx = _toy_index()
        kidx = build_kmer_index_vectorised(idx, k)
        eng = MeshLogEngine(idx, k, mesh=mesh,
                            cfg=LogConfig(pool=64, hits=16))
        ref_path = idx.prg[idx.prg <= 4].astype(np.uint8)
        rng = np.random.RandomState(0)
        buffer = [ref_path[s:s + 12].copy()
                  for s in rng.randint(0, ref_path.size - 12, size=4 * n)]
        stats = QuasimapStats()
        coverage = Coverage.empty(idx)
        seeds = RandomInclusiveInt(42).raw_block(len(buffer))
        first_raws = first_raw_draws(np.asarray(seeds, dtype=np.uint32))
        eng.record_buffer(buffer, kidx, k, stats, coverage, seeds,
                          first_raws)
        eng.flush_device_coverage()
        results = eng.search_buffer(buffer, kidx, k, QuasimapStats())
        _check(len(results) == len(buffer), "search_buffer lost reads")
        return eng, stats, coverage, idx.graph.coverage.copy()

    mesh = make_mesh(devices=devices)
    eng, stats, cov, pb = record(mesh)
    _check(eng.device_mapped > 0, "the mesh engine mapped nothing")
    _check(stats.exact_mapped_reads_count > 0, "no read mapped")
    _, stats1, cov1, pb1 = record(make_mesh(devices=devices[:1]))
    _check(stats.as_dict() == stats1.as_dict(), "stats differ from 1 shard")
    _check(cov.allele_sum == cov1.allele_sum
           and cov.grouped_counts == cov1.grouped_counts
           and np.array_equal(pb, pb1),
           f"{n}-shard coverage differs from 1-shard coverage")

    # ---- 2. SA-range index sharding, against the replicated scan -------
    if n % 2 == 0 and n >= 4:
        mesh2 = Mesh(np.array(devices, dtype=object).reshape(2, n // 2),
                     ("data", "idx"))
    else:
        mesh2 = Mesh(devices, ("idx",))
    n_data = mesh2.shape.get("data", 1)
    idx = _toy_index()
    di = DeviceIndex.build(idx, device=devices[0])
    R_shard, length, cfg = 4, 16, LogConfig(pool=32, hits=8)
    rng = np.random.RandomState(1)
    parts = [_seeded_scan_inputs(idx, rng, R_shard, length, cfg.pool)
             for _ in range(n_data)]
    reads_T = torch.from_numpy(np.concatenate([p[0] for p in parts], axis=1))
    carry = tuple(torch.from_numpy(np.concatenate(cs))
                  for cs in zip(*[p[1] for p in parts]))
    got = make_index_sharded_log_search(mesh2, di, cfg, R_shard)(reads_T,
                                                                 carry)
    phases = auto_phases(length, R_shard, cfg,
                         narrow=di.narrow_tab.shape[0] == di.size)
    for d, (rt, c) in enumerate(parts):
        want = log_search_phases(
            di, torch.from_numpy(rt).to(di.device),
            tuple(torch.from_numpy(a).to(di.device) for a in c), phases,
            R_shard)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            m = w.numel()
            _check(torch.equal(g[d * m:(d + 1) * m].cpu(), w.cpu()),
                   "index-sharded scan differs from the replicated scan")
    return {"shards": n, "device_mapped": eng.device_mapped,
            "host_fallbacks": eng.host_fallbacks,
            "mesh_shape": mesh2.shape, "phases": phases}
