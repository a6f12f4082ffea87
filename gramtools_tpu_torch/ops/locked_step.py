"""The slot-locked scan tail (K3 locked): the CUDA kernel and its plain
torch twin.

Port of gramtools_tpu/mapping/search_jax_log.py::_lock_pool followed by
``_build_narrow_step(locked=True)`` scanned over a range of steps
(XLA-lowered jnp on the TPU, not Pallas). ``locked_tail`` takes

  * ``reads`` (S, R) int32: the base row of each of the S steps (R
    reads = R pool slots, slot i is read i);
  * ``carry`` (read_id, lo, hi, pref) int32 of the incoming pool and
    ``overflow`` (R + 1,) bool (the last entry is the scan's dump slot,
    see mapping/scan_steps.py);
  * ``log_base``, the log offset of the first step, and the log halves
    ``lp``, ``le`` (int32, 1-D), whose records [log_base, log_base +
    S·G·B) the steps write in place;
  * the hit budget ``hits`` (G), the wide-state budget ``wide_budget``
    (W), and the occ source: ``blocks`` (the packed rank records) or
    None for the dense ``di.occ`` table;
  * ``lock``: True locks the pool first (``lock_pool``), False takes a
    carry that is locked already (a later range of steps);

and returns the final carry with its (R + 1,) overflow. The inputs are
never written.

``locked_tail`` routes by device: CPU tensors take the twin,
``locked_tail_torch`` (``scan_steps.lock_pool``, then the torch locked
step stepped over the range, with the plain packed rank); CUDA tensors
launch ``csrc/locked_step.cu``, one cooperative launch for the whole
range, which needs no host synchronisation. ``locked_tail.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..mapping.scan_steps import build_narrow_step, lock_pool
from ..mapping.search_log_host import LogConfig
from .rank import BLOCK, WORDS, packed_occ_rows_torch

I32 = torch.int32


# --------------------------------------------------------------------------
# plain torch twin
# --------------------------------------------------------------------------

def _plain_packed_rows(blocks: torch.Tensor, size: int):
    def occ_rows(rows: torch.Tensor) -> torch.Tensor:
        shape = tuple(rows.shape)
        return packed_occ_rows_torch(blocks, rows.reshape(-1),
                                     size).reshape(shape + (4,))
    return occ_rows


def locked_tail_torch(di, reads, carry, log_base: int, lp, le, hits: int,
                      wide_budget: int, blocks=None, lock: bool = True):
    """``lock_pool``, then the torch slot-locked step over the rows of
    ``reads``, each step's log records written into lp/le in place."""
    R = reads.shape[1]
    if lock:
        carry = lock_pool(carry, R, R)
    occ_rows = None if blocks is None else _plain_packed_rows(blocks, di.size)
    step = build_narrow_step(di, LogConfig(pool=R, hits=hits), R, wide_budget,
                             occ_rows=occ_rows, locked=True)
    GB = hits * di.n_outcomes
    for i in range(reads.shape[0]):
        carry, (rec_parent, rec_event) = step(carry, reads[i], log_base)
        lp[log_base:log_base + GB] = rec_parent.reshape(-1)
        le[log_base:log_base + GB] = rec_event.reshape(-1)
        log_base += GB
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
            [p, p, p, p, p, i, i]                # carry in, n_in, lock
            + [p, i, i]                          # reads, steps, R
            + [p, i, p, p, p, p]                 # narrow_tab, n, occ, blocks,
                                                 # sym_start, sentinel_row
            + [p, i, p, p, i, i]                 # mrl, outcomes
            + [i, i, i, p, p]                    # G, W, log_base, lp, le
            + [p, p, p, i, p])                   # carry, ovf, scratch, grid,
                                                 # stream
        lib.locked_tail.restype = ctypes.c_int
        lib.locked_tail_scratch.argtypes = [i, i]
        lib.locked_tail_scratch.restype = ctypes.c_longlong
        lib.locked_tail_grid.argtypes = [i, i, i]
        lib.locked_tail_grid.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"locked_tail_cuda: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"locked_tail_cuda: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"locked_tail_cuda: {name} must be contiguous")


def locked_tail_cuda(di, reads, carry, log_base: int, lp, le, hits: int,
                     wide_budget: int, blocks=None, lock: bool = True):
    """Launch csrc/locked_step.cu on PyTorch's current stream. Raises on
    what the kernel does not take and on a failed build or launch; does
    not synchronise."""
    rid, lo, hi, pref, overflow = carry
    B = di.n_outcomes
    n = di.size
    occ = di.occ if blocks is None else blocks
    tables = [di.narrow_tab, occ, di.sym_start, di.sentinel_row,
              di.marker_rank_locus, di.out_lo, di.out_hi]
    tensors = [reads, rid, lo, hi, pref, overflow, lp, le] + tables
    dev = reads.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("locked_tail_cuda: every input must be on one CUDA "
                         f"device, got {sorted({str(t.device) for t in tensors})}")
    if reads.dim() != 2:
        raise ValueError("locked_tail_cuda: reads must be (steps, R)")
    S, R = reads.shape
    n_in = rid.shape[0]
    if R < 1 or hits < 1 or wide_budget < 0:
        raise ValueError(f"locked_tail_cuda: needs R >= 1, hits >= 1 and "
                         f"wide_budget >= 0, got {R}, {hits}, {wide_budget}")
    if not lock and n_in != R:
        raise ValueError("locked_tail_cuda: a locked carry has R states")
    _check("reads", reads, I32, (S, R))
    for name, t in (("read_id", rid), ("lo", lo), ("hi", hi), ("pref", pref)):
        _check(name, t, I32, (n_in,))
    _check("overflow", overflow, torch.bool, (R + 1,))
    for name, t in (("lp", lp), ("le", le)):
        if t.dim() != 1:
            raise ValueError(f"locked_tail_cuda: {name} must be 1-D")
        _check(name, t, I32, t.shape)
    end = log_base + S * hits * B
    if log_base < 0 or end > min(lp.shape[0], le.shape[0]) or end >= 2 ** 31:
        raise ValueError(f"locked_tail_cuda: log records [{log_base}, {end}) "
                         f"outside the log ({lp.shape[0]}, {le.shape[0]})")
    if n >= 2 ** 24:
        raise ValueError("locked_tail_cuda: the narrow table needs n < 2**24")
    _check("narrow_tab", di.narrow_tab, I32, (n,))
    if blocks is None:
        _check("occ", occ, I32, (n + 1, 4))
    else:
        _check("blocks", occ, I32, (n // BLOCK + 1, WORDS))
    if di.sym_start.shape[0] < 5:
        raise ValueError("locked_tail_cuda: sym_start needs 5 entries")
    _check("sym_start", di.sym_start, I32, (di.sym_start.shape[0],))
    if di.sentinel_row.numel() != 1:
        raise ValueError("locked_tail_cuda: sentinel_row must be one int")
    _check("sentinel_row", di.sentinel_row, I32, di.sentinel_row.shape)
    n_mrl = di.marker_rank_locus.shape[0]
    if n_mrl < 1:
        raise ValueError("locked_tail_cuda: marker_rank_locus is empty")
    _check("marker_rank_locus", di.marker_rank_locus, I32, (n_mrl,))
    L = di.out_lo.shape[0]
    _check("out_lo", di.out_lo, I32, (L, B))
    _check("out_hi", di.out_hi, I32, (L, B))
    if L < 1:
        raise ValueError("locked_tail_cuda: the jump table has no locus")

    lib = _kernel_lib()
    out = torch.empty((2, 4, R), dtype=I32, device=dev)
    ovf = torch.empty(R + 1, dtype=torch.bool, device=dev)
    scratch = torch.empty(lib.locked_tail_scratch(R, hits), dtype=I32,
                          device=dev)
    with torch.cuda.device(dev):
        grid = lib.locked_tail_grid(R, n_in, hits * B)
        if grid < 1:
            raise RuntimeError(f"locked_tail: no cooperative grid on {dev}: "
                               f"CUDA error {-grid}")
        err = lib.locked_tail(
            rid.data_ptr(), lo.data_ptr(), hi.data_ptr(), pref.data_ptr(),
            overflow.data_ptr(), n_in, int(lock),
            reads.data_ptr(), S, R,
            di.narrow_tab.data_ptr(), n,
            occ.data_ptr() if blocks is None else None,
            occ.data_ptr() if blocks is not None else None,
            di.sym_start.data_ptr(), di.sentinel_row.data_ptr(),
            di.marker_rank_locus.data_ptr(), n_mrl, di.out_lo.data_ptr(),
            di.out_hi.data_ptr(), L, B, hits, wide_budget, log_base,
            lp.data_ptr(), le.data_ptr(), out.data_ptr(), ovf.data_ptr(),
            scratch.data_ptr(), grid,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"locked_tail kernel launch failed: CUDA error "
                           f"{err}")
    locked_tail.launches += 1
    last = out[S % 2]
    return last[0], last[1], last[2], last[3], ovf


def locked_tail(di, reads, carry, log_base: int, lp, le, hits: int,
                wide_budget: int, blocks=None, lock: bool = True):
    """CPU tensors take the plain twin; CUDA tensors launch the kernel
    or raise."""
    if reads.device.type == "cpu":
        return locked_tail_torch(di, reads, carry, log_base, lp, le, hits,
                                 wide_budget, blocks, lock)
    if reads.device.type == "cuda":
        return locked_tail_cuda(di, reads, carry, log_base, lp, le, hits,
                                wide_budget, blocks, lock)
    raise ValueError(f"locked_tail: unsupported device {reads.device}")


locked_tail.launches = 0
