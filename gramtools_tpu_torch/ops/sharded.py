"""SA-range-sharded index tables (K10) that the scan kernels read in place.

Port of the gathers of gramtools_tpu/parallel/sharded_index.py
(``shard_fn``'s ``occ_rows`` and ``narrow_rows``: a masked local gather
on each "idx" shard, then a ``psum`` over the axis; XLA on the TPU). The
dense occ table (n + 1, 4) and the narrow-step table (n,) shard by SA
range: shard i holds rows [i * rows_per_shard, (i + 1) * rows_per_shard),
the last one padded with zero rows, each on its device of the mesh row.

A ``ShardedTables`` is what ``search_log._scan_phases`` takes in place of
the two gathers. On CUDA the scan kernels (K2, K3) read each row from its
owner shard (``csrc/scan_common.cuh``: ``occ_row``, ``narrow_at``; shard
``r // rows_per_shard``, local row ``r - shard * rows_per_shard``, after
the gather's clamp), a peer card's shard directly over NVLink: every row
is owned by exactly one shard and the padding rows are never addressed,
so one load equals the masked gathers and their sum. ``_sharded_gather``
is the plain version, which the twins take on CPU tensors; nothing on
CUDA calls it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

MAX_SHARDS = 8
"""The most shards of a table the kernels read (``kMaxShards``)."""


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


@dataclass(eq=False)
class ShardedTables:
    """The index's occ and narrow tables in S SA-range shards: ``occ``
    S (rows_per_shard, 4) int32 and ``narrow`` S (nt_rows_per_shard,)
    int32, shard i on its device; ``size`` the index's n; ``home`` the
    device the scan runs on; ``has_narrow``: the narrow tail runs (the
    index has a narrow table of n rows)."""

    occ: Tuple[torch.Tensor, ...]
    narrow: Tuple[torch.Tensor, ...]
    rows_per_shard: int
    nt_rows_per_shard: int
    has_narrow: bool
    size: int
    home: torch.device

    @property
    def n_shards(self) -> int:
        return len(self.occ)

    def occ_rows(self):
        """The plain occ gather: the shards' masked gathers, summed."""
        return _sharded_gather([(t, t.device) for t in self.occ],
                               self.rows_per_shard, 0, self.size, self.home)

    def narrow_rows(self):
        """The plain narrow-table gather, or None without the narrow
        tail."""
        if not self.has_narrow:
            return None
        return _sharded_gather([(t, t.device) for t in self.narrow],
                               self.nt_rows_per_shard, 0, self.size - 1,
                               self.home)


def build_tables(occ_np: np.ndarray, nt_np: Optional[np.ndarray], size: int,
                 devices, home, resident: Optional[dict] = None
                 ) -> ShardedTables:
    """The tables of one mesh row: shard i of each on ``devices[i]``.
    ``nt_np`` None: no narrow tail (a one-row stub a shard). Each
    upload runs on its device's current stream; each CUDA device is
    synchronised once, here. ``resident`` ((kind, i, device) -> tensor)
    shares one upload between the rows that place a shard on one
    device. Any number of shards; the kernels take up to MAX_SHARDS
    (``locked_step.check_tables``)."""
    n_idx = len(devices)
    if n_idx < 1:
        raise ValueError("an index splits into at least one shard")
    occ_pad, rps = shard_occ(occ_np, n_idx)
    has_narrow = nt_np is not None
    nt_pad, nt_rps = shard_occ(
        nt_np[:, None] if has_narrow else np.zeros((n_idx, 1), np.int32),
        n_idx)
    resident = {} if resident is None else resident
    synced = set()

    def on(kind, i, dev):
        key = (kind, i, dev)
        if key not in resident:
            src = (occ_pad[i * rps:(i + 1) * rps] if kind == "occ"
                   else nt_pad[i * nt_rps:(i + 1) * nt_rps, 0])
            t = torch.from_numpy(np.ascontiguousarray(src))
            if dev.type == "cuda":
                with torch.cuda.device(dev):       # on dev's current stream
                    t = t.to(dev, non_blocking=True)
                synced.add(dev)
            resident[key] = t.to(dev)
        return resident[key]

    devices = [torch.device(d) for d in devices]
    tables = ShardedTables(
        tuple(on("occ", i, d) for i, d in enumerate(devices)),
        tuple(on("nt", i, d) for i, d in enumerate(devices)),
        rps, nt_rps, has_narrow, size, torch.device(home))
    for dev in synced:
        torch.cuda.synchronize(dev)
    return tables


# ---------------------------------------------------------------------------
# the kernels' side
# ---------------------------------------------------------------------------

_PEERS = set()


def enable_peers(tables: ShardedTables, home: torch.device) -> None:
    """Let ``home`` read every shard on another card (once a pair, by
    ``cudaDeviceEnablePeerAccess`` through the scan kernels' library).
    Raises a RuntimeError naming the pair where the cards cannot."""
    for t in tables.occ + tables.narrow:
        dev = t.device
        if dev.type != "cuda" or dev.index == home.index:
            continue
        pair = (home.index, dev.index)
        if pair in _PEERS:
            continue
        if not torch.cuda.can_device_access_peer(home.index, dev.index):
            raise RuntimeError(f"cuda:{home.index} cannot read the index "
                               f"shard on cuda:{dev.index}: no peer access "
                               f"between the two cards")
        from .wide_step import _kernel_lib

        lib = _kernel_lib()
        err = lib.scan_enable_peer(home.index, dev.index)
        if err != 0:
            raise RuntimeError(f"enabling peer access from cuda:{home.index}"
                               f" to cuda:{dev.index} failed: CUDA error "
                               f"{err}")
        _PEERS.add(pair)


def shard_pointers(shards) -> "ctypes.Array":
    """The kernels' (MAX_SHARDS,) pointer array of ``shards`` (nulls
    past them)."""
    arr = (ctypes.c_void_p * MAX_SHARDS)()
    for i, t in enumerate(shards):
        arr[i] = t.data_ptr()
    return arr
