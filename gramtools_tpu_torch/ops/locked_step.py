"""The scan's narrow tail (K3): the CUDA kernel and its plain torch twin.

Port of gramtools_tpu/mapping/search_jax_log.py::_resize_pool and
``_build_narrow_step(locked=False)`` scanned over the hole-allocated
narrow phase, then ``_lock_pool`` and ``_build_narrow_step(locked=True)``
scanned over the slot-locked phase (XLA-lowered jnp on the TPU, not
Pallas). ``locked_tail`` takes

  * ``reads`` (S, R) int32: the base row of each of the S steps, the
    hole-allocated ones first (R reads; in the locked steps pool slot i
    is read i); or a ``PackedReads`` window of S steps of the 2-bit packed
    matrix (ops/packed_reads.py, K6), which the kernel decodes where it
    loads a base;
  * ``carry`` (read_id, lo, hi, pref) int32 of the incoming pool and
    ``overflow`` (R + 1,) bool (the last entry is the scan's dump slot,
    see mapping/scan_steps.py);
  * ``log_base``, the log offset of the first step, and the log halves
    ``lp``, ``le`` (int32, 1-D), whose records from log_base on the steps
    write in place;
  * ``narrow``: None, or (steps, pool, hits, wide budget) of the leading
    hole-allocated steps, run after resizing the pool to ``pool``;
  * the slot-locked steps' hit budget ``hits`` (G) and wide-state budget
    ``wide_budget`` (W), and the occ source: ``blocks`` (the packed rank
    records) or None for the dense ``di.occ``; the narrow steps read
    ``di.narrow_tab``;
  * ``lock``: True locks the pool before the slot-locked steps
    (``lock_pool``), False takes a carry that is locked already (a later
    range of steps) or, after the hole-allocated steps, leaves the pool
    unlocked when no slot-locked step follows;

and returns the final carry with its (R + 1,) overflow. The inputs are
never written.

``locked_tail`` routes by device: CPU tensors take the twin,
``locked_tail_torch`` (``scan_steps.resize_pool`` and the torch
hole-allocated step, then ``lock_pool`` and the torch locked step, each
stepped over its range, with the plain packed rank, packed reads
unpacked by ``unpack_reads2``); CUDA tensors launch
``csrc/locked_step.cu``, one cooperative launch for the whole range,
which needs no host synchronisation (its slot-locked steps take no grid
barrier: the wide rank and the hit prefix come from chained scans with
decoupled look-back, each tile's hits and newborns from its own block;
the kernel's source note). ``locked_tail.launches`` counts
kernel launches, ``locked_tail.narrow_launches`` those that ran
hole-allocated steps and ``packed_launches`` those that decoded packed
reads (K6).
"""
from __future__ import annotations

import ctypes

import torch

from ..mapping.scan_steps import (build_narrow_step, lock_pool, resize_pool,
                                  run_steps)
from ..mapping.search_log_host import LogConfig
from . import rank
from .packed_reads import PackedReads, as_rows
from .rank import BLOCK, WORDS

I32 = torch.int32
GRID_CAP = None
"""A cap on the kernel's grid (tests set it to run several tiles a block
at small shapes); None: the blocks co-resident on the card."""


# --------------------------------------------------------------------------
# plain torch twin
# --------------------------------------------------------------------------

def twin_gathers(di, blocks=None):
    """(occ_rows, narrow_rows) of the twins' torch steps: the plain
    packed rank, or the dense tables (None)."""
    if blocks is not None:
        return rank.plain_packed_rows(blocks, di.size), None
    return None, None


def locked_tail_torch(di, reads, carry, log_base: int, lp, le, hits: int,
                      wide_budget: int, blocks=None, lock: bool = True,
                      narrow=None):
    """``resize_pool`` and the torch hole-allocated step over the first
    ``narrow[0]`` rows of ``reads``, then ``lock_pool`` and the torch
    slot-locked step over the rest, each step's log records written into
    lp/le in place."""
    reads = as_rows(reads)
    R = reads.shape[1]
    B = di.n_outcomes
    occ_rows, narrow_rows = twin_gathers(di, blocks)
    n_narrow = 0
    if narrow is not None:
        n_narrow, pool, g_n, w_n = narrow
        carry = resize_pool(carry, pool, R)
        step = build_narrow_step(di, LogConfig(pool=pool, hits=g_n), R, w_n,
                                 occ_rows=occ_rows, narrow_rows=narrow_rows)
        carry, log_base = run_steps(step, carry, reads[:n_narrow], log_base,
                                    lp, le, g_n * B)
    if lock:
        carry = lock_pool(carry, R, R)
    if reads.shape[0] > n_narrow:
        step = build_narrow_step(di, LogConfig(pool=R, hits=hits), R,
                                 wide_budget, occ_rows=occ_rows, locked=True,
                                 narrow_rows=narrow_rows)
        carry, _ = run_steps(step, carry, reads[n_narrow:], log_base, lp, le,
                             hits * B)
    return carry


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("locked_step")
    if lib.locked_tail.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.locked_tail.argtypes = (
            [p, p, p, p, p, i]                   # carry in, n_in
            + [p, p, p, i, i, i]                 # reads: rows, packed,
                                                 # row_len, k, total, step0
            + [i, i, i, i, i, i]                 # R, narrow range, lock
            + [i, i, i]                          # locked steps, G, W
            + [p, i, p, p, p, p]                 # narrow_tab, n, occ,
                                                 # blocks, sym_start,
                                                 # sentinel_row
            + [p, i, p, p, i, i]                 # mrl, outcomes
            + [i, p, p]                          # log_base, lp, le
            + [p, i, p, p, i, p])                # carry, C, ovf, scratch,
                                                 # grid, stream
        lib.locked_tail.restype = ctypes.c_int
        lib.locked_tail_scratch.argtypes = [i, i, i, i, i, i]
        lib.locked_tail_scratch.restype = ctypes.c_longlong
        lib.locked_tail_grid.argtypes = [i, i]
        lib.locked_tail_grid.restype = ctypes.c_int
    return lib


def kernel_attrs(packed_reads: bool = True) -> dict:
    """The registers a thread, local (spill) bytes a thread and static
    shared bytes a block of the built kernel's instance for packed or
    int32 reads (default: the fused path's, packed reads)."""
    from . import _build

    return _build.kernel_attrs(_kernel_lib().locked_tail_attrs, packed_reads)


def check_tensor(fn: str, name: str, t, dtype, shape):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``."""
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def check_scan_args(fn: str, di, reads, carry, lp, le, end: int,
                    blocks=None):
    """The checks the scan kernels' wrappers share: every tensor on one
    CUDA device, reads (S, R) int32 or a ``PackedReads`` window of S
    steps, the carry's four (n_in,) int32 fields and (R + 1,) overflow,
    the log halves 1-D int32 holding records up to ``end``, and the index
    tables the kernels read (the dense occ table or the packed records).
    Returns (S, R, n_in)."""
    rid, lo, hi, pref, overflow = carry
    B = di.n_outcomes
    n = di.size
    packed = isinstance(reads, PackedReads)
    occ = [di.occ if blocks is None else blocks]
    index = occ + [di.sym_start, di.sentinel_row, di.marker_rank_locus,
                   di.out_lo, di.out_hi]
    rows = [reads.packed, reads.row_len] if packed else [reads]
    tensors = rows + [rid, lo, hi, pref, overflow, lp, le] + index
    dev = reads.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{fn}: every input must be on one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if reads.dim() != 2:
        raise ValueError(f"{fn}: reads must be (steps, R)")
    S, R = reads.shape
    n_in = rid.shape[0]
    if R < 1:
        raise ValueError(f"{fn}: needs R >= 1")
    if packed:
        check_tensor(fn, "packed reads", reads.packed, torch.uint8,
                     (-(-reads.steps // 4), R))
        check_tensor(fn, "row_len", reads.row_len, I32, (R,))
    else:
        check_tensor(fn, "reads", reads, I32, (S, R))
    for name, t in (("read_id", rid), ("lo", lo), ("hi", hi), ("pref", pref)):
        check_tensor(fn, name, t, I32, (n_in,))
    check_tensor(fn, "overflow", overflow, torch.bool, (R + 1,))
    for name, t in (("lp", lp), ("le", le)):
        if t.dim() != 1:
            raise ValueError(f"{fn}: {name} must be 1-D")
        check_tensor(fn, name, t, I32, t.shape)
    if end > min(lp.shape[0], le.shape[0]) or end >= 2 ** 31:
        raise ValueError(f"{fn}: log records up to {end} outside the log "
                         f"({lp.shape[0]}, {le.shape[0]})")
    if n >= 2 ** 31 - 1:
        raise ValueError(f"{fn}: the index needs n < 2**31 - 1")
    if blocks is None:
        check_tensor(fn, "occ", occ[0], I32, (n + 1, 4))
    else:
        check_tensor(fn, "blocks", occ[0], I32, (n // BLOCK + 1, WORDS))
    if di.sym_start.shape[0] < 5:
        raise ValueError(f"{fn}: sym_start needs 5 entries")
    check_tensor(fn, "sym_start", di.sym_start, I32, (di.sym_start.shape[0],))
    if di.sentinel_row.numel() != 1:
        raise ValueError(f"{fn}: sentinel_row must be one int")
    check_tensor(fn, "sentinel_row", di.sentinel_row, I32,
                 di.sentinel_row.shape)
    n_mrl = di.marker_rank_locus.shape[0]
    if n_mrl < 1:
        raise ValueError(f"{fn}: marker_rank_locus is empty")
    check_tensor(fn, "marker_rank_locus", di.marker_rank_locus, I32, (n_mrl,))
    L = di.out_lo.shape[0]
    check_tensor(fn, "out_lo", di.out_lo, I32, (L, B))
    check_tensor(fn, "out_hi", di.out_hi, I32, (L, B))
    if L < 1:
        raise ValueError(f"{fn}: the jump table has no locus")
    return S, R, n_in


def reads_args(reads):
    """The kernels' read-matrix arguments: rows, packed, row_len, k,
    total steps, the first step."""
    if isinstance(reads, PackedReads):
        return [None, reads.packed.data_ptr(), reads.row_len.data_ptr(),
                reads.kmer_size, reads.steps, reads.start]
    return [reads.data_ptr(), None, None, 0, reads.shape[0], 0]


def index_args(di, blocks=None):
    """The index tables' kernel arguments after the narrow table: (occ,
    blocks) and (sym_start, sentinel_row, mrl, n_mrl, out_lo, out_hi, L,
    B)."""
    occ = ([di.occ.data_ptr(), None] if blocks is None
           else [None, blocks.data_ptr()])
    return occ, [di.sym_start.data_ptr(), di.sentinel_row.data_ptr(),
                 di.marker_rank_locus.data_ptr(),
                 di.marker_rank_locus.shape[0], di.out_lo.data_ptr(),
                 di.out_hi.data_ptr(), di.out_lo.shape[0], di.n_outcomes]


def narrow_args(fn: str, di):
    """The narrow table's kernel argument."""
    n = di.size
    if n >= 2 ** 24:
        raise ValueError(f"{fn}: the narrow table needs n < 2**24")
    check_tensor(fn, "narrow_tab", di.narrow_tab, I32, (n,))
    return [di.narrow_tab.data_ptr()]


def launched(fn, reads) -> None:
    """One kernel launch counted on the wrapper ``fn``: in ``launches``,
    and in ``packed_launches`` (K6) where it decoded packed reads."""
    fn.launches += 1
    fn.packed_launches += isinstance(reads, PackedReads)


def locked_tail_cuda(di, reads, carry, log_base: int, lp, le, hits: int,
                     wide_budget: int, blocks=None, lock: bool = True,
                     narrow=None):
    """Launch csrc/locked_step.cu on PyTorch's current stream. Raises on
    what the kernel does not take and on a failed build or launch; does
    not synchronise."""
    fn = "locked_tail_cuda"
    B = di.n_outcomes
    n_narrow, pool, g_n, w_n = (0, 0, 0, 0) if narrow is None else narrow
    n_locked = reads.shape[0] - n_narrow if reads.dim() == 2 else 0
    end = log_base + n_narrow * g_n * B + n_locked * hits * B
    S, R, n_in = check_scan_args(fn, di, reads, carry, lp, le, end, blocks)
    if log_base < 0 or hits < 1 or wide_budget < 0:
        raise ValueError(f"{fn}: needs log_base >= 0, hits >= 1 and "
                         f"wide_budget >= 0, got {log_base}, {hits}, "
                         f"{wide_budget}")
    if narrow is not None and not (0 <= n_narrow <= S and pool >= 1
                                   and g_n >= 1 and w_n >= 0):
        raise ValueError(f"{fn}: narrow must be (steps <= {S}, pool >= 1, "
                         f"hits >= 1, wide budget >= 0), got {narrow}")
    n_pool = pool if narrow is not None else n_in
    if n_locked and not lock and n_pool != R:
        raise ValueError(f"{fn}: a locked carry has R states")
    nt = narrow_args(fn, di)
    occ, rest = index_args(di, blocks)

    lib = _kernel_lib()
    C = max(n_in, pool, R)
    out = torch.empty((2, 4, C), dtype=I32, device=reads.device)
    ovf = torch.empty(R + 1, dtype=torch.bool, device=reads.device)
    scratch = torch.empty(lib.locked_tail_scratch(C, g_n * B, n_narrow, pool,
                                                  n_locked, R),
                          dtype=I32, device=reads.device)
    rid, lo, hi, pref, overflow = carry
    with torch.cuda.device(reads.device):
        grid = lib.locked_tail_grid(C, isinstance(reads, PackedReads))
        if GRID_CAP:
            grid = min(grid, GRID_CAP)
        if grid < 1:
            raise RuntimeError(f"locked_tail: no cooperative grid on "
                               f"{reads.device}: CUDA error {-grid}")
        err = lib.locked_tail(
            rid.data_ptr(), lo.data_ptr(), hi.data_ptr(), pref.data_ptr(),
            overflow.data_ptr(), n_in, *reads_args(reads),
            R, n_narrow, pool, g_n, w_n, int(lock), n_locked, hits,
            wide_budget, *nt, di.size, *occ, *rest,
            log_base, lp.data_ptr(), le.data_ptr(), out.data_ptr(), C,
            ovf.data_ptr(), scratch.data_ptr(), grid,
            torch.cuda.current_stream(reads.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"locked_tail kernel launch failed: CUDA error "
                           f"{err}")
    launched(locked_tail, reads)
    locked_tail.narrow_launches += n_narrow > 0
    last = out[(n_narrow + int(lock) + n_locked) % 2]
    n_out = R if lock or n_locked else n_pool
    return (last[0, :n_out], last[1, :n_out], last[2, :n_out],
            last[3, :n_out], ovf)


def locked_tail(di, reads, carry, log_base: int, lp, le, hits: int,
                wide_budget: int, blocks=None, lock: bool = True,
                narrow=None):
    """CPU tensors take the plain twin; CUDA tensors launch the kernel
    or raise."""
    if reads.device.type == "cpu":
        return locked_tail_torch(di, reads, carry, log_base, lp, le, hits,
                                 wide_budget, blocks, lock, narrow)
    if reads.device.type == "cuda":
        return locked_tail_cuda(di, reads, carry, log_base, lp, le, hits,
                                wide_budget, blocks, lock, narrow)
    raise ValueError(f"locked_tail: unsupported device {reads.device}")


locked_tail.launches = 0
locked_tail.narrow_launches = 0
locked_tail.packed_launches = 0
