"""The scan's wide steps (K2): the CUDA kernel and its plain torch twin.

Port of gramtools_tpu/mapping/search_jax_log.py::_resize_pool and
``_build_log_step`` scanned over each wide phase of a plan (XLA-lowered
jnp on the TPU, not Pallas). ``wide_steps`` takes

  * ``reads`` (S, R) int32: the base row of each of the S steps of the
    phases, in order (R reads); or a ``PackedReads`` window of S steps of
    the 2-bit packed matrix (ops/packed_reads.py, K6), which the kernel
    decodes where it loads a base;
  * ``carry`` (read_id, lo, hi, pref) int32 of the incoming pool and
    ``overflow`` (R + 1,) bool (the last entry is the scan's dump slot,
    see mapping/scan_steps.py);
  * ``phases``: ((steps, pool, hits), ...), the wide phases; the pool is
    resized to each phase's size before its steps;
  * ``log_base``, the log offset of the first step, and the log halves
    ``lp``, ``le`` (int32, 1-D), whose records from log_base on the steps
    write in place;
  * the occ source: ``blocks`` (the packed rank records) or None for the
    dense ``di.occ`` table;

and returns the final carry (the last phase's pool) with its (R + 1,)
overflow. The inputs are never written.

``wide_steps`` routes by device: CPU tensors take the twin,
``wide_steps_torch`` (``scan_steps.resize_pool`` and the torch wide step
stepped over each phase, with the plain packed rank, packed reads
unpacked by ``unpack_reads2``); CUDA tensors launch
``csrc/wide_step.cu``, one cooperative launch for every phase, which
needs no host synchronisation. ``wide_steps.launches`` counts kernel
launches and ``packed_launches`` those that decoded packed reads (K6).
"""
from __future__ import annotations

import ctypes

import torch

from ..mapping.scan_steps import build_log_step, resize_pool, run_steps
from ..mapping.search_log_host import LogConfig
from .locked_step import (check_scan_args, index_args, launched, reads_args,
                          twin_gathers)
from .packed_reads import PackedReads, as_rows

I32 = torch.int32
GRID_CAP = None
"""A cap on the kernel's grid (tests set it to run several tiles a block
at small shapes); None: the blocks co-resident on the card."""


def wide_steps_torch(di, reads, carry, phases, log_base: int, lp, le,
                     blocks=None):
    """``resize_pool`` and the torch wide step over each phase's rows of
    ``reads``, each step's log records written into lp/le in place."""
    reads = as_rows(reads)
    R = reads.shape[1]
    occ_rows = twin_gathers(di, blocks)[0]
    offset = 0
    for n_steps, pool, hits in phases:
        carry = resize_pool(carry, pool, R)
        step = build_log_step(di, LogConfig(pool=pool, hits=hits), R,
                              occ_rows=occ_rows)
        carry, log_base = run_steps(step, carry,
                                    reads[offset:offset + n_steps], log_base,
                                    lp, le, hits * di.n_outcomes)
        offset += n_steps
    return carry


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("wide_step")
    if lib.wide_steps.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ints = ctypes.POINTER(ctypes.c_int)
        lib.wide_steps.argtypes = (
            [p, p, p, p, p, i]                   # carry in, n_in
            + [p, p, p, i, i, i]                 # reads: rows, packed,
                                                 # row_len, k, total, step0
            + [i, i, ints, ints, ints]           # R, the phases
            + [p, p, i, p, p]                    # occ, blocks, n,
                                                 # sym_start, sentinel_row
            + [p, i, p, p, i, i]                 # mrl, outcomes
            + [i, p, p]                          # log_base, lp, le
            + [p, i, p, p, i, p])                # carry, C, ovf, scratch,
                                                 # grid, stream
        lib.wide_steps.restype = ctypes.c_int
        lib.wide_steps_scratch.argtypes = [i, ints, ints, i]
        lib.wide_steps_scratch.restype = ctypes.c_longlong
        lib.wide_steps_grid.argtypes = [i, i]
        lib.wide_steps_grid.restype = ctypes.c_int
        lib.wide_steps_max_phases.argtypes = []
        lib.wide_steps_max_phases.restype = ctypes.c_int
    return lib


def kernel_attrs(packed_reads: bool = True) -> dict:
    """The registers a thread, local (spill) bytes a thread and static
    shared bytes a block of the built kernel's instance for packed or
    int32 reads (default: the fused path's, packed reads)."""
    from . import _build

    return _build.kernel_attrs(_kernel_lib().wide_steps_attrs, packed_reads)


def wide_steps_cuda(di, reads, carry, phases, log_base: int, lp, le,
                    blocks=None):
    """Launch csrc/wide_step.cu on PyTorch's current stream. Raises on
    what the kernel does not take and on a failed build or launch; does
    not synchronise."""
    fn = "wide_steps_cuda"
    B = di.n_outcomes
    phases = [tuple(int(v) for v in ph) for ph in phases]
    end = log_base + sum(s * g * B for s, _, g in phases)
    S, R, n_in = check_scan_args(fn, di, reads, carry, lp, le, end, blocks)
    if log_base < 0 or not phases or any(
            s < 0 or pool < 1 or g < 1 for s, pool, g in phases):
        raise ValueError(f"{fn}: needs log_base >= 0 and phases of (steps "
                         f">= 0, pool >= 1, hits >= 1), got {log_base}, "
                         f"{phases}")
    if sum(s for s, _, _ in phases) != S:
        raise ValueError(f"{fn}: the phases' steps must add up to the {S} "
                         f"rows of reads")
    lib = _kernel_lib()
    if len(phases) > lib.wide_steps_max_phases():
        raise ValueError(f"{fn}: at most {lib.wide_steps_max_phases()} "
                         f"phases, got {len(phases)}")
    C = max([n_in] + [pool for _, pool, _ in phases])
    g_max = max(g for _, _, g in phases)
    K = g_max * B
    table = (ctypes.c_int * len(phases))
    steps, pools, hits = (table(*col) for col in zip(*phases))
    out = torch.empty((2, 4, C), dtype=I32, device=reads.device)
    ovf = torch.empty(R + 1, dtype=torch.bool, device=reads.device)
    scratch = torch.empty(lib.wide_steps_scratch(len(phases), steps, pools,
                                                 K),
                          dtype=I32, device=reads.device)
    rid, lo, hi, pref, overflow = carry
    occ, rest = index_args(di, blocks)
    with torch.cuda.device(reads.device):
        grid = lib.wide_steps_grid(C, isinstance(reads, PackedReads))
        if GRID_CAP:
            grid = min(grid, GRID_CAP)
        if grid < 1:
            raise RuntimeError(f"wide_steps: no cooperative grid on "
                               f"{reads.device}: CUDA error {-grid}")
        err = lib.wide_steps(
            rid.data_ptr(), lo.data_ptr(), hi.data_ptr(), pref.data_ptr(),
            overflow.data_ptr(), n_in, *reads_args(reads),
            R, len(phases), steps, pools, hits, *occ, di.size, *rest,
            log_base, lp.data_ptr(), le.data_ptr(), out.data_ptr(), C,
            ovf.data_ptr(), scratch.data_ptr(), grid,
            torch.cuda.current_stream(reads.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wide_steps kernel launch failed: CUDA error "
                           f"{err}")
    launched(wide_steps, reads)
    last = out[S % 2]
    N = phases[-1][1]
    return last[0, :N], last[1, :N], last[2, :N], last[3, :N], ovf



def wide_steps(di, reads, carry, phases, log_base: int, lp, le,
               blocks=None):
    """CPU tensors take the plain twin; CUDA tensors launch the kernel
    or raise."""
    if reads.device.type == "cpu":
        return wide_steps_torch(di, reads, carry, phases, log_base, lp, le,
                                blocks)
    if reads.device.type == "cuda":
        return wide_steps_cuda(di, reads, carry, phases, log_base, lp, le,
                               blocks)
    raise ValueError(f"wide_steps: unsupported device {reads.device}")


wide_steps.launches = 0
wide_steps.packed_launches = 0
