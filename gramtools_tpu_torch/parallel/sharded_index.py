"""SA-range-sharded FM index: graphs larger than one device's memory.

Port of gramtools_tpu/parallel/sharded_index.py (K10). The occ table is
the index's dominant device array, 16 bytes per BWT position; the
narrow-step table adds 4. Both shard by SA range over the mesh axis
"idx": idx shard i holds rows [i*rows_per_shard, (i+1)*rows_per_shard)
on its device. In the JAX module every device of the axis runs the same
scan on the same pool, each gather a masked local gather of its shard
and a ``psum`` over "idx". Here the shards of a mesh row are one
``ops/sharded.ShardedTables``, and the scan of a data shard is
``ops/sharded.sharded_scan``: on CUDA every distinct card of the row
steps the same pool in gather rounds, gathers only from the shards it
holds, and the row's cards all-reduce their answers by NCCL between two
launches (a row on one card needs none); the scan's outputs are taken
on the row's first device, devices[d, 0]. The torch steps over the
shards' masked gathers summed (``ops/sharded._sharded_gather``) are the
plain version, which CPU tensors take. With a ("data", "idx") mesh,
reads shard over "data" as well: data shard d scans its columns on
every card of row d, each row with its own communicator.

The step itself is the production genealogy-log scan
(search_log.log_search_phases) given the sharded tables -- no second
search implementation to keep in sync.
"""
from __future__ import annotations

import dataclasses

import torch

from ..mapping.engine import _to_device
from ..mapping.search_log_host import LogConfig, auto_phases
from ..ops.sharded import build_tables
from ..ops.sharded import shard_occ  # noqa: F401 (re-exported)
from .mesh import Mesh, scan_data_shards


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

    occ_np = di.occ.cpu().numpy()
    nt_np = di.narrow_tab.cpu().numpy()
    has_narrow = nt_np.shape[0] == di.size
    resident: dict = {}     # each shard resident once a device holding it
    shards = []
    for row in grid:
        home = row[0]
        tables = build_tables(occ_np, nt_np if has_narrow else None, di.size,
                              list(row), home, resident)
        # di travels with a stub occ and narrow_tab: the real tables are
        # the shards'
        small = _to_device(dataclasses.replace(
            di, occ=torch.zeros((1, 4), dtype=torch.int32),
            narrow_tab=torch.zeros(1, dtype=torch.int32)), home)
        shards.append((small, tables, None))

    def run(reads_T, carry):
        p = phases
        if p is None:
            p = auto_phases(reads_T.shape[0], num_reads, cfg,
                            narrow=has_narrow)
        return scan_data_shards(shards, reads_T, carry, tuple(p), num_reads)

    return run
