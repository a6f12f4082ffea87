"""Bit-packed BWT rank: the CUDA kernel, its plain torch twin, and the
numpy table construction and oracle.

Port of gramtools_tpu/ops/rank.py. Layout -- one uint32[24] record
(96 bytes) per 128 BWT symbols:

  words[0:4]   Occ checkpoint: #A,#C,#G,#T in bwt[0 : 128*blk]
  word[4]      marker checkpoint: #markers in bwt[0 : 128*blk]
  words[5:8]   reserved (0)
  words[8:24]  128 4-bit symbol codes, nibble j of word 8+w = code of
               bwt[128*blk + 8*w + j]; code 0 = sentinel/pad, 1-4 = DNA,
               5 = marker

rank(c, i) = ckpt[c] + popcount(nibble_eq(codes, c) & prefix_mask(i%128))

Torch holds the records as int32 (the uint32 bit patterns); the kernel
reads them as unsigned and the twin widens them to int64 first.

``packed_rank`` routes by the tensor's device: a CPU tensor goes to the
plain twin, a CUDA tensor to the kernel (csrc/packed_rank.cu), which
launches or raises. ``packed_rank.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

BLOCK = 128            # symbols per block
WORDS = 24             # uint32 words per record
CODE_WORDS = 16        # words[8:24] hold the 4-bit codes
MARKER_CODE = 5

_REP = np.uint32(0x11111111)   # one bit per nibble
_U32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# construction and numpy oracle (copied from gramtools_tpu/ops/rank.py)
# --------------------------------------------------------------------------

def build_packed_occ(fm) -> np.ndarray:
    """Packs an index.fm.FMIndex's BWT into (nblocks, 24) uint32 records.

    nblocks = floor(n / 128) + 1 so a query at i = n (prefix of the whole
    BWT) still has a record; pad symbols get code 0 and count as nothing.
    """
    bwt = np.asarray(fm.bwt, dtype=np.int64)
    n = bwt.size
    nblocks = n // BLOCK + 1
    codes = np.zeros(nblocks * BLOCK, dtype=np.uint32)
    codes[:n] = np.where(bwt == 0, 0, np.where(bwt <= 4, bwt, MARKER_CODE))

    blocks = np.zeros((nblocks, WORDS), dtype=np.uint32)
    # checkpoints: counts before each block start
    for c in range(1, 5):
        hits = np.zeros(nblocks, dtype=np.uint32)
        np.add.at(hits, np.flatnonzero(bwt == c) // BLOCK, 1)
        blocks[1:, c - 1] = np.cumsum(hits)[:-1]
    mhits = np.zeros(nblocks, dtype=np.uint32)
    np.add.at(mhits, np.flatnonzero(bwt > 4) // BLOCK, 1)
    blocks[1:, 4] = np.cumsum(mhits)[:-1]
    # 4-bit code words
    nib = codes.reshape(nblocks, CODE_WORDS, 8)
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, None, :]
    blocks[:, 8:] = (nib << shifts).sum(axis=2, dtype=np.uint32)
    return blocks


def _count_channels_np(rec: np.ndarray, off: np.ndarray) -> np.ndarray:
    """(N, 24) records + (N,) in-block offsets -> (N, 4) DNA ranks."""
    words = rec[:, 8:]                                   # (N, 16)
    j = np.arange(CODE_WORDS, dtype=np.int64)
    t = np.clip(off[:, None] - 8 * j, 0, 8)              # nibbles in prefix
    pmask = np.where(t >= 8, np.uint32(0xFFFFFFFF),
                     (np.uint32(1) << (4 * np.minimum(t, 7)).astype(np.uint32))
                     - 1)
    out = np.empty((rec.shape[0], 4), dtype=np.int32)
    for c in range(1, 5):
        x = words ^ (np.uint32(c) * _REP)
        y = ~x
        m = y & (y >> 1) & (y >> 2) & (y >> 3) & _REP
        cnt = _popcount_np(m & pmask).sum(axis=1)
        out[:, c - 1] = rec[:, c - 1].astype(np.int32) + cnt.astype(np.int32)
    return out


def _popcount_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return (x * np.uint32(0x01010101)) >> 24


def packed_occ_rows_np(blocks: np.ndarray, rows: np.ndarray,
                       size: int) -> np.ndarray:
    """Numpy oracle: rank of the four DNA bases at each row (prefix
    length), bit-equal to fm.occ.T[rows]."""
    rows = np.clip(np.asarray(rows, dtype=np.int64), 0, size)
    rec = blocks[rows // BLOCK]
    return _count_channels_np(rec, rows % BLOCK)


def blocks_tensor(blocks: np.ndarray, device) -> torch.Tensor:
    """(nblocks, 24) uint32 records -> int32 tensor of the same bits."""
    arr = np.ascontiguousarray(np.asarray(blocks, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


# --------------------------------------------------------------------------
# plain torch twin
# --------------------------------------------------------------------------

def _popcount_i64(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of values in [0, 2**32) held in int64 (torch has
    no popcount op)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


def count_channels_torch(rec: torch.Tensor, off: torch.Tensor
                         ) -> torch.Tensor:
    """(..., 24) int32 records + (...,) in-block offsets -> (..., 4)
    int32 DNA ranks. The records are widened to int64 and masked to 32
    bits first: int32 >> fills sign bits and int32 products wrap."""
    words = rec[..., 8:].to(torch.int64) & _U32            # (..., 16)
    j = torch.arange(CODE_WORDS, dtype=torch.int64, device=rec.device)
    t = (off[..., None].to(torch.int64) - 8 * j).clamp(0, 8)
    pmask = torch.where(t >= 8, _U32, (1 << (4 * t.clamp(max=7))) - 1)
    rep = 0x11111111
    outs = []
    for c in range(1, 5):
        y = ~(words ^ (c * rep)) & _U32
        m = y & (y >> 1) & (y >> 2) & (y >> 3) & rep
        cnt = _popcount_i64(m & pmask).sum(dim=-1)
        outs.append(rec[..., c - 1].to(torch.int64) + cnt)
    return torch.stack(outs, dim=-1).to(torch.int32)


def packed_occ_rows_torch(blocks: torch.Tensor, rows: torch.Tensor,
                          size: int) -> torch.Tensor:
    """Plain torch rank at each row (any shape) -> (..., 4) int32."""
    r = rows.to(torch.int64).clamp(0, size)
    return count_channels_torch(blocks[r // BLOCK], r % BLOCK)


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("packed_rank")
    if lib.packed_rank.argtypes is None:
        lib.packed_rank.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p]
        lib.packed_rank.restype = ctypes.c_int
    return lib


def packed_rank_cuda(blocks: torch.Tensor, rows: torch.Tensor,
                     size: int) -> torch.Tensor:
    """Launch csrc/packed_rank.cu on PyTorch's current stream: (M,)
    int32 rows -> (M, 4) int32 ranks. Raises on what the kernel does
    not take; does not synchronise."""
    if blocks.device.type != "cuda" or rows.device != blocks.device:
        raise ValueError("packed_rank_cuda: blocks and rows must be on "
                         f"one CUDA device, got {blocks.device} and "
                         f"{rows.device}")
    if blocks.dtype != torch.int32 or rows.dtype != torch.int32:
        raise TypeError("packed_rank_cuda: blocks and rows must be int32, "
                        f"got {blocks.dtype} and {rows.dtype}")
    if (blocks.dim() != 2 or blocks.shape[1] != WORDS
            or blocks.shape[0] != size // BLOCK + 1
            or not blocks.is_contiguous()):
        raise ValueError("packed_rank_cuda: blocks must be a contiguous "
                         f"({size // BLOCK + 1}, {WORDS}) table, got "
                         f"{tuple(blocks.shape)}")
    if rows.dim() != 1:
        raise ValueError("packed_rank_cuda: rows must be 1-D")
    if size >= 2 ** 31:
        raise ValueError("packed_rank_cuda: size must fit in int32")
    rows = rows.contiguous()
    out = torch.empty((rows.shape[0], 4), dtype=torch.int32,
                      device=rows.device)
    if rows.shape[0] == 0:
        return out
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.packed_rank(blocks.data_ptr(), rows.data_ptr(),
                          rows.shape[0], size, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"packed_rank kernel launch failed: CUDA error "
                           f"{err}")
    packed_rank.launches += 1
    return out


def packed_rank(blocks: torch.Tensor, rows: torch.Tensor,
                size: int) -> torch.Tensor:
    """(M,) rows -> (M, 4) int32 ranks. CPU tensors take the plain
    twin; CUDA tensors launch the kernel or raise."""
    if rows.device.type == "cpu":
        return packed_occ_rows_torch(blocks, rows, size)
    if rows.device.type == "cuda":
        return packed_rank_cuda(blocks, rows, size)
    raise ValueError(f"packed_rank: unsupported device {rows.device}")


packed_rank.launches = 0


class PackedOccRows:
    """occ_rows(rows) -> (..., 4) int32 for any query shape, such as
    (2N,) or (2G, B), through ``packed_rank``: a drop-in for the dense
    di.occ gather in the scan steps. It carries its ``blocks`` and
    ``size``, so a caller can hand the records themselves to a kernel
    that folds the rank in (ops/wide_step.py, ops/locked_step.py)."""

    def __init__(self, blocks: torch.Tensor, size: int):
        self.blocks = blocks
        self.size = size

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        shape = tuple(rows.shape)
        out = packed_rank(self.blocks, rows.reshape(-1), self.size)
        return out.reshape(shape + (4,))


def make_packed_occ_rows(blocks: torch.Tensor, size: int) -> PackedOccRows:
    """The packed-rank occ gather over ``blocks`` (PackedOccRows)."""
    return PackedOccRows(blocks, size)


def plain_packed_rows(blocks: torch.Tensor, size: int):
    """The packed-rank occ gather through the plain twin on any device:
    the occ source of the scan kernels' twins."""
    def occ_rows(rows: torch.Tensor) -> torch.Tensor:
        shape = tuple(rows.shape)
        return packed_occ_rows_torch(blocks, rows.reshape(-1),
                                     size).reshape(shape + (4,))
    return occ_rows
