"""SA-range-sharded FM index: graphs larger than one device's memory.

Port of gramtools_tpu/parallel/sharded_index.py (K10). The occ table is
the index's dominant device array, 16 bytes per BWT position; the
narrow-step table adds 4. Both shard by SA range over the mesh axis
"idx": idx shard i holds rows [i*rows_per_shard, (i+1)*rows_per_shard)
on its device. Every gather of the scan becomes

    the masked local gather of each idx shard, copied to the querying
    shard's device, summed

-- each row is owned by exactly one shard, so the sum is the full
gather (the ``psum`` over "idx" of the JAX module; plain torch here,
as it is XLA there). With a ("data", "idx") mesh, reads shard over
"data" as well: data shard d scans its columns on devices[d, 0] and
queries the index shards devices[d, :].

The step itself is the production genealogy-log scan
(search_log.log_search_phases) with the gathers injected -- no second
search implementation to keep in sync. Because its gathers are
injected, its slot-locked phase runs the torch locked step
(scan_steps.build_narrow_step), not the locked-tail kernel
(ops/locked_step.py), which reads the index's own dense or packed
tables: ``_scan_phases`` chooses by the ``occ_rows``/``narrow_rows``
it is given. That is this configuration's path, not a fallback.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mapping.engine import _to_device
from ..mapping.search_log_host import LogConfig, auto_phases
from .mesh import Mesh, scan_data_shards


def shard_occ(occ: np.ndarray, n_shards: int):
    """Pad occ rows to a multiple of n_shards. Returns (padded,
    rows_per_shard)."""
    rows = occ.shape[0]
    rows_per_shard = -(-rows // n_shards)
    padded = np.zeros((rows_per_shard * n_shards, occ.shape[1]), occ.dtype)
    padded[:rows] = occ
    return padded, rows_per_shard


def _sharded_gather(parts, rows_per_shard: int, lo: int, hi: int, home):
    """rows -> the sum over index shards of each one's masked local
    gather of ``parts`` [(table slice, device)], on ``home``."""
    def gather(rows: torch.Tensor) -> torch.Tensor:
        r = rows.clamp(lo, hi)
        total = None
        for i, (table, dev) in enumerate(parts):
            local = r.to(dev) - i * rows_per_shard
            ok = (local >= 0) & (local < rows_per_shard)
            v = table[local.clamp(0, rows_per_shard - 1)]
            if v.dim() > ok.dim():
                ok = ok[..., None]
            v = torch.where(ok, v, 0).to(home)
            total = v if total is None else total + v
        return total

    return gather


def make_index_sharded_log_search(mesh: Mesh, di, cfg: LogConfig,
                                  num_reads: int, phases=None):
    """Index-sharded (and optionally data-parallel) log-engine search.

    mesh must have an "idx" axis (occ SA-range shards); if it also has a
    "data" axis, reads_T columns and the carry are sharded over it and
    ``num_reads`` is the per-data-shard read count. Returns
    run(reads_T, carry) -> (final_carry, (log_parent, log_event)); with
    a "data" axis each is the per-shard results concatenated in shard
    order (each of the static per-shard length)."""
    if "idx" not in mesh.axis_names:
        raise ValueError("mesh needs an 'idx' axis")
    n_idx = mesh.shape["idx"]
    grid = mesh.devices
    if "data" not in mesh.axis_names:
        grid = grid.reshape(1, n_idx)
    elif mesh.axis_names.index("data") != 0:
        grid = grid.T

    occ_pad, rows_per_shard = shard_occ(di.occ.cpu().numpy(), n_idx)
    # the narrow-step table shards by the same SA ranges
    nt_np = di.narrow_tab.cpu().numpy()
    has_narrow = nt_np.shape[0] == di.size
    nt_pad, nt_rows_per_shard = shard_occ(
        nt_np[:, None] if has_narrow else np.zeros((n_idx, 1), np.int32),
        n_idx)
    occ_slices = [torch.from_numpy(occ_pad[i * rows_per_shard:
                                           (i + 1) * rows_per_shard])
                  for i in range(n_idx)]
    nt_slices = [torch.from_numpy(nt_pad[i * nt_rows_per_shard:
                                         (i + 1) * nt_rows_per_shard, 0])
                 for i in range(n_idx)]
    # each slice resident once per distinct device that holds it
    resident: dict = {}

    def on(kind, i, dev):
        key = (kind, i, dev)
        if key not in resident:
            src = occ_slices if kind == "occ" else nt_slices
            resident[key] = src[i].to(dev)
        return resident[key]

    shards = []
    for row in grid:
        home = row[0]
        # di travels with a stub occ and narrow_tab: the real tables are
        # the shards'
        small = _to_device(dataclasses.replace(
            di, occ=torch.zeros((1, 4), dtype=torch.int32),
            narrow_tab=torch.zeros(1, dtype=torch.int32)), home)
        occ_rows = _sharded_gather(
            [(on("occ", i, d), d) for i, d in enumerate(row)],
            rows_per_shard, 0, di.size, home)
        narrow_rows = None
        if has_narrow:
            narrow_rows = _sharded_gather(
                [(on("nt", i, d), d) for i, d in enumerate(row)],
                nt_rows_per_shard, 0, di.size - 1, home)
        shards.append((small, occ_rows, narrow_rows))

    def run(reads_T, carry):
        p = phases
        if p is None:
            p = auto_phases(reads_T.shape[0], num_reads, cfg,
                            narrow=has_narrow)
        return scan_data_shards(shards, reads_T, carry, tuple(p), num_reads)

    return run
