"""Data parallelism over devices: reads sharded over a mesh, coverage
merged per shard with no locks.

Port of gramtools_tpu/parallel/mesh.py. The index is resident on every
device of the mesh, each buffer's (read, orientation) rows round-robin
over the shards, every shard runs the identical phased genealogy-log
scan + fused device-side selection/recording on its row slice
(mapping/engine.py), and each shard's coverage diff row stays apart
until one end-of-run sum. The per-read seeded selection RNG makes the
results independent of the shard count.

A ``Mesh`` is a numpy object array of ``torch.device`` with axis names.
A device may appear more than once: S shards on one device run one
after the other on it, which is how one card (or the CPU) runs S
shards. ``MeshLogEngine`` is a thin configuration of the production
``LogBatchedEngine``, so every single-device feature (fused record,
overflow retry, sticky shapes, adaptive hit budget) is the mesh's too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.device import get_device
from ..mapping.engine import LogBatchedEngine, _to_device
from ..mapping.search_log import log_search_phases
from ..mapping.search_log_host import auto_phases


@dataclass
class Mesh:
    """Devices laid out over named axes (the fields of jax's Mesh that
    the engines read)."""

    devices: np.ndarray               # object array of torch.device
    axis_names: Tuple[str, ...] = ("data",)

    def __post_init__(self):
        arr = np.asarray(self.devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.flat]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(self.axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as jax's Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("data",) mesh: the first ``n_devices`` CUDA devices (all of
    them when None), or the explicit ``devices`` list, which may repeat
    one device. Raises when fewer CUDA devices exist than asked for:
    the mesh never silently shrinks."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = have if n_devices is None else n_devices
        if want < 1 or have < want:
            raise RuntimeError(f"a mesh of {want} CUDA devices was asked "
                               f"for; {have} exist")
        devices = [torch.device("cuda", i) for i in range(want)]
    elif n_devices is not None and n_devices != len(devices):
        raise ValueError(f"n_devices={n_devices} but {len(devices)} devices "
                         "given")
    devices = [get_device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, ("data",))


def scan_data_shards(shards, reads_T, carry, phases, num_reads: int):
    """The phased scan of each data shard on its columns of reads_T and
    its slice of the carry; shards: [(di, occ_rows, narrow_rows)], each
    scanned on its di's device. Returns (final carry, (log_parent,
    log_event)), each the shards' results concatenated in shard order on
    the first shard's device."""
    n = len(shards)

    def part(t, d, dev):
        w = t.shape[-1] // n
        return t[..., d * w:(d + 1) * w].to(dev)

    outs = []
    for d, (di, occ_rows, narrow_rows) in enumerate(shards):
        dev = di.device
        outs.append(log_search_phases(
            di, part(reads_T, d, dev), tuple(part(a, d, dev) for a in carry),
            phases, num_reads, occ_rows=occ_rows, narrow_rows=narrow_rows))
    home = shards[0][0].device
    cat = lambda parts: torch.cat([x.to(home) for x in parts])
    final = tuple(cat([o[0][i] for o in outs]) for i in range(5))
    return final, (cat([o[1][0] for o in outs]),
                   cat([o[1][1] for o in outs]))


def make_sharded_log_search(mesh: Mesh, di, cfg, reads_per_shard: int,
                            phases=None):
    """Data-parallel scan-only runner (genealogy-log engine): reads_T
    columns and the carry shard over "data", the index is resident on
    every device, and each shard runs the identical phased scan.
    Returns run(reads_T, carry) -> (final carry, (log_parent,
    log_event)), each the shards' results concatenated in shard order
    on the mesh's first device. The full production pipeline (seeding,
    fused record, retry) over a mesh is ``MeshLogEngine``; combine with
    parallel/sharded_index.py for a ("data", "idx") mesh when the occ
    table itself must shard."""
    devices = list(mesh.devices.flat)
    resident = {d: di if d == di.device else _to_device(di, d)
                for d in dict.fromkeys(devices)}
    shards = [(resident[d], None, None) for d in devices]

    def run(reads_T, carry):
        p = phases
        if p is None:
            p = auto_phases(reads_T.shape[0], reads_per_shard, cfg)
        return scan_data_shards(shards, reads_T, carry, tuple(p),
                                reads_per_shard)

    return run


class MeshLogEngine(LogBatchedEngine):
    """Data-parallel production mapping engine over a device mesh.

    Drop-in for ``quasimap_reads(engine=...)``: the single-device
    engine configured with a mesh (vectorised seeding, fused device-side
    selection + coverage recording, full-budget overflow retry, host
    fallback for the hard residue). Requires the array-backed kmer index
    (index.kmer_index_vec.build_kmer_index_vectorised); the dict-based
    oracle index has no ``seed_batch`` and is rejected with a TypeError
    at first use."""

    def __init__(self, idx, kmer_size: int, mesh: Optional[Mesh] = None,
                 cfg=None):
        super().__init__(idx, kmer_size, cfg=cfg,
                         mesh=mesh if mesh is not None else make_mesh())
