"""The selection (K8): the CUDA kernels' wrapper.

Port of gramtools_tpu/mapping/record_jax.py::select_and_record_device
(XLA-lowered jnp on the TPU, not Pallas), everything in it but the
per-base recorder (K9, ops/walk.py), which runs between the two
launches of ``csrc/select.cu``:

  * ``select_cuda`` launches ``select_kernel``, the function's stages
    0-5 (FB_CHAIN and ``mapped``; the encapsulated split and the state
    table; the duplicate-site check; the loci and their dedup sort; the
    key rows, the classes and the pick, a thread a row or a warp for a
    row of more than 4 live states; the preliminary triple check). It
    returns a ``Selection``: the fallback bits so far, ``mapped``, the
    state table (``ps_row``, ``ps_lo``, ``ps_hi``, ``ps_trav``,
    ``ps_ntrav``) and ``st_selected``, which K9 takes as they are, and
    the scratch that the second launch reads;
  * ``triples_cuda`` launches ``triples_kernel`` on a Selection and the
    fallback bits after K9: the (trip_cap,) triple arrays, sorted by
    (row, site, allele), unselected lanes after the selected ones.

Every scan of the two launches is a chained scan with decoupled
look-back, and both sorts are one-sweep LSD radix sorts of 8-bit
digits (one histogram sweep, then one grid sync a pass); the triple
sort starts from the dedup sort's (site, allele) order and runs the
row key's passes only: 7 grid syncs and the dedup sort's passes in the
first launch, 1 and the row key's passes in the second
(csrc/select.cu). The sorts' keys are 64-bit where ``key_bits`` (a
bound from the shapes: the states, the rows, the site markers and the
graph's nodes) is at most 64, 128-bit otherwise; ``WIDE_KEYS`` forces
one instance. The kernels fix the exact packing from the lanes
themselves, so the outputs do not depend on the instance; a 64-bit
launch given sites or alleles outside the graph's tables, past its
bound, traps (a launch error).

The plain version is mapping/record.py::select_torch; CPU tensors take
it there (record.select_and_record_device routes by device). Both
wrappers raise on what the kernels do not take and on a failed build or
launch, never fall back to the plain version and never synchronise the
host: every size comes from shapes and the budgets passed in. Each
launch adds one to ``select_cuda.launches`` (two a buffer on the path).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..mapping.search_log_host import TCAP

I32 = torch.int32
MAX_KCAP = 12        # the kernels' widest key row (csrc/select.cu)
GRID_CAP = None
"""A cap on the kernels' grid (tests set it to run many tiles a block at
small shapes); None: the co-resident blocks, at most two an SM."""
WIDE_KEYS = None
"""True or False forces the 128-bit or the 64-bit key instance; None:
the one ``key_bits`` asks for."""


def key_bits(NS: int, R: int, n_sites: int, n_nodes: int) -> int:
    """An upper bound on the width of both sorts' packed keys: the bits
    of the larger primary key (a state, at most NS + 1, or a row key, at
    most R + 1) over those of the lanes' site range (site markers 5 +
    2 * site below 5 + 2 * n_sites, or 0) and allele range (-1 to below
    the graph's node count), the two together rounded up to whole 8-bit
    digits. The kernels pack by the exact ranges, which lie inside these
    for lanes of the graph's own loci."""
    fields = (3 + 2 * n_sites).bit_length() + (n_nodes + 1).bit_length()
    return max(NS + 1, R + 1).bit_length() + (fields + 7) // 8 * 8


def wide_keys(bits: int) -> bool:
    """Whether keys of ``bits`` (``key_bits``) take the 128-bit instance,
    unless ``WIDE_KEYS`` forces one."""
    return bits > 64 if WIDE_KEYS is None else bool(WIDE_KEYS)


class Selection(NamedTuple):
    """What ``select_cuda`` leaves for K9 and ``triples_cuda``."""

    fallback: torch.Tensor      # (R,) int32, the bits of stages 0-5
    mapped: torch.Tensor        # (R,) bool
    ps_row: torch.Tensor        # (NS,) int32, NS = N + ecap
    ps_lo: torch.Tensor
    ps_hi: torch.Tensor
    ps_trav: torch.Tensor       # (NS, TCAP, 2) int32
    ps_ntrav: torch.Tensor
    st_selected: torch.Tensor   # (NS,) bool
    scratch: torch.Tensor       # the second launch's inputs
    args: tuple                 # the launch's arguments, for the second


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("select")
    if lib.select_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.select_launch.argtypes = (
            [i, i, p, p, p, p, p, p, p, p]       # which, the pool states
            + [i, p, p]                          # rows
            + [p, i, p, i, p, p]                 # sa, ra_node, nt_*
            + [p, p, p, p, i, i, i]              # anc_*, base_site
            + [i, i, i, i, i, i, i]              # budgets, stage, wide
            + [p] * 8                            # the selection's outputs
            + [p, p, p, p]                       # fb_final, the triples
            + [p, i, p])                         # scratch, grid, stream
        lib.select_launch.restype = ctypes.c_int
        lib.select_scratch_bytes.argtypes = [i] * 9
        lib.select_scratch_bytes.restype = ctypes.c_longlong
        lib.select_grid.argtypes = [i]
        lib.select_grid.restype = ctypes.c_int
    return lib


def kernel_attrs(which: int = 0, wide: bool = False) -> dict:
    """A selection kernel's registers a thread, local (spill) bytes a
    thread and static shared bytes a block: ``which`` 0 the first launch's
    (select_kernel), 1 the second's (triples_kernel), of the 64-bit or
    (``wide``) the 128-bit key instance."""
    from . import _build

    return _build.kernel_attrs(_kernel_lib().select_attrs, which, int(wide))


def _check(fn: str, named: dict, dtypes: dict, dev):
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{fn}: every input must be on one CUDA device,"
                             f" {name} is on {t.device}, not {dev}")
        want = dtypes.get(name, I32)
        if t.dtype != want:
            raise TypeError(f"{fn}: {name} must be {want}, got {t.dtype}")


def select_cuda(sa, ra_node, nt_site, nt_allele, anc_len, anc_site,
                anc_allele, base_site, max_anc: int, f_rid, f_lo, f_hi,
                trav, n_trav, ing, n_ing, state_bad, row_ok, row_first_raw,
                ecap: int, lcap: int, trcap: int, kcap: int, trip_cap: int,
                stage: int = 99) -> Selection:
    """Stages 0-5 of the selection on PyTorch's current stream (module
    doc). ``sa``: the FM index's (size,) suffix array; the graph and
    site tables are RecordTables' (``anc_site``, ``anc_allele``: (n_sites,
    >= max_anc), of which the first ``max_anc`` columns are ancestors);
    pool states (N,) and their paths (N, TCAP, 2); rows (R,),
    ``row_first_raw`` int64. ``stage`` < 5 stops after that block, as
    the plain version does."""
    fn = "select_cuda"
    dev = f_rid.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: needs CUDA tensors, got {dev}")
    named = dict(sa=sa, ra_node=ra_node, nt_site=nt_site,
                 nt_allele=nt_allele, anc_len=anc_len, anc_site=anc_site,
                 anc_allele=anc_allele, base_site=base_site, f_rid=f_rid,
                 f_lo=f_lo, f_hi=f_hi, trav=trav, n_trav=n_trav, ing=ing,
                 n_ing=n_ing, state_bad=state_bad, row_ok=row_ok,
                 row_first_raw=row_first_raw)
    _check(fn, named, {"state_bad": torch.bool, "row_ok": torch.bool,
                       "row_first_raw": torch.int64}, dev)
    N, R = f_rid.shape[0], row_ok.shape[0]
    n_sites = anc_len.shape[0]
    cols = anc_site.shape[1] if anc_site.dim() == 2 else -1
    shapes = {"f_lo": (f_lo, (N,)), "f_hi": (f_hi, (N,)),
              "n_trav": (n_trav, (N,)), "n_ing": (n_ing, (N,)),
              "state_bad": (state_bad, (N,)), "trav": (trav, (N, TCAP, 2)),
              "ing": (ing, (N, TCAP, 2)), "row_first_raw": (row_first_raw,
                                                            (R,)),
              "anc_site": (anc_site, (n_sites, cols)),
              "anc_allele": (anc_allele, (n_sites, cols)),
              "base_site": (base_site, (n_sites,)),
              "nt_allele": (nt_allele, tuple(nt_site.shape))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    for name in ("sa", "ra_node", "nt_site", "anc_len", "f_rid", "row_ok"):
        if named[name].dim() != 1 or named[name].shape[0] < 1:
            raise ValueError(f"{fn}: {name} must be 1-D and non-empty")
    if min(N, R, n_sites, cols) < 1 or not 0 <= max_anc <= cols:
        raise ValueError(f"{fn}: needs a state, a row, a site and "
                         f"0 <= max_anc <= the ancestor columns, got N={N}, "
                         f"R={R}, n_sites={n_sites}, max_anc={max_anc}, "
                         f"columns={cols}")
    if min(ecap, lcap, trcap, trip_cap) < 1 or not 1 <= kcap <= MAX_KCAP:
        raise ValueError(f"{fn}: needs budgets >= 1 and 1 <= kcap <= "
                         f"{MAX_KCAP}, got ecap={ecap}, lcap={lcap}, "
                         f"trcap={trcap}, kcap={kcap}, trip_cap={trip_cap}")
    NS = N + ecap
    LT = (lcap + trcap) * (max_anc + 1)
    if NS * TCAP >= 1 << 31 or LT >= 1 << 30 or NS * kcap >= 1 << 31:
        raise ValueError(f"{fn}: {NS} states or {LT} loci lanes are past "
                         "the kernels' int32 indexing")
    wide = wide_keys(key_bits(NS, R, n_sites, nt_site.shape[0]))
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        grid = lib.select_grid(int(wide))
    if grid < 1:
        raise RuntimeError(f"{fn}: no cooperative grid on {dev}: CUDA error "
                           f"{-grid}")
    if GRID_CAP:
        grid = min(grid, GRID_CAP)
    tensors = [t.contiguous() for t in named.values()]
    (sa, ra_node, nt_site, nt_allele, anc_len, anc_site, anc_allele,
     base_site, f_rid, f_lo, f_hi, trav, n_trav, ing, n_ing, state_bad,
     row_ok, row_first_raw) = tensors
    fallback = torch.empty(R, dtype=I32, device=dev)
    mapped = torch.empty(R, dtype=torch.bool, device=dev)
    ps = [torch.empty(NS, dtype=I32, device=dev) for _ in range(3)]
    ps_trav = torch.empty((NS, TCAP, 2), dtype=I32, device=dev)
    ps_ntrav = torch.empty(NS, dtype=I32, device=dev)
    st_selected = torch.empty(NS, dtype=torch.bool, device=dev)
    scratch = torch.empty(lib.select_scratch_bytes(
        N, R, ecap, lcap, trcap, max_anc, kcap, grid, int(wide)),
        dtype=torch.uint8, device=dev)
    args = ([N] + [t.data_ptr() for t in (f_rid, f_lo, f_hi, trav, n_trav,
                                          ing, n_ing, state_bad)]
            + [R, row_ok.data_ptr(), row_first_raw.data_ptr(),
               sa.data_ptr(), sa.shape[0], ra_node.data_ptr(),
               ra_node.shape[0], nt_site.data_ptr(), nt_allele.data_ptr(),
               anc_len.data_ptr(), anc_site.data_ptr(),
               anc_allele.data_ptr(), base_site.data_ptr(), n_sites,
               anc_site.shape[1], max_anc, ecap, lcap, trcap, kcap, trip_cap,
               int(stage), int(wide)]
            + [t.data_ptr() for t in [fallback, mapped] + ps
               + [ps_trav, ps_ntrav, st_selected]])
    with torch.cuda.device(dev):             # the stream's own device
        err = lib.select_launch(0, *args, None, None, None, None,
                                scratch.data_ptr(), grid,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"selection kernel launch failed: CUDA error {err}")
    select_cuda.launches += 1
    # the inputs stay referenced until the second launch is enqueued
    return Selection(fallback, mapped, *ps, ps_trav, ps_ntrav, st_selected,
                     scratch, (grid, args, tensors, trip_cap))


def triples_cuda(sel: Selection, fallback, trip_cap: int):
    """The triple arrays of a Selection (``select_cuda`` at stage 99)
    given the fallback bits after K9: (trip_row, trip_site, trip_allele),
    (trip_cap,) int32 each, as the plain version's."""
    fn = "triples_cuda"
    grid, args, _, sel_cap = sel.args
    dev = sel.fallback.device
    if (fallback.device != dev or fallback.dtype != I32
            or tuple(fallback.shape) != tuple(sel.fallback.shape)):
        raise ValueError(f"{fn}: fallback must be the selection's (R,) "
                         f"int32 on {dev}")
    if trip_cap != sel_cap:
        raise ValueError(f"{fn}: trip_cap {trip_cap} is not the "
                         f"selection's {sel_cap}")
    fallback = fallback.contiguous()
    out = [torch.empty(trip_cap, dtype=I32, device=dev) for _ in range(3)]
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        err = lib.select_launch(1, *args, fallback.data_ptr(),
                                *(t.data_ptr() for t in out),
                                sel.scratch.data_ptr(), grid,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"triples kernel launch failed: CUDA error {err}")
    select_cuda.launches += 1
    return tuple(out)


select_cuda.launches = 0
