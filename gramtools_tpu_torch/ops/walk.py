"""Per-base coverage recorder (K9): the CUDA kernels' wrapper and the
plain walk.

Port of gramtools_tpu/mapping/record_jax.py::_record_per_base_device
(XLA-lowered jnp on the TPU, not Pallas): each selected state's SA
occurrences become walk lanes; a lane starts at (node cur0, offset
start0) with ``remaining0`` read bases left and walks the coverage
graph, taking the edge its traversed allele names at each bubble entry
(``trav_idx`` counts down the state's path ``ps_trav[w_item]``), until
the read is used up, the graph ends, or a partial occurrence (``full``
false) leaves the bubble it started in. Every in-bubble node it covers
emits ``(row, node, start, end)``; one envelope per (row, node) goes
into ``cov_diff`` as +1/-1 boundaries.

``walk_torch`` is the plain walk loop; with the expansion and the
sorted envelope around it (mapping/record.py::_record_per_base_torch)
it is the plain version of the whole function, which CPU tensors take.
``per_base_cuda`` runs the whole function on CUDA tensors in the four
kernels of ``csrc/walk.cu`` (expansion, walk, hash-table envelope and
adds; no sort), with no host synchronisation, and counts its calls in
``per_base_cuda.launches``.

``walk_torch`` returns ``(emits (emitcap, 4) int32, spill () bool)``.
Unfilled rows hold ``(2**30, 0, 0, 0)``. ``spill`` is set when the lanes
emitted more than ``emitcap`` rows (the rows past it are dropped) or a
lane outran ``max_iter`` iterations, which a walk over the acyclic
coverage graph cannot do (it moves one node an iteration); the caller
then flags every selected row.
"""
from __future__ import annotations

import ctypes

import torch

I32 = torch.int32
BIG = 2 ** 30          # row of an unfilled emission (sorts after any row)


def _empty_emits(emitcap: int, dev) -> torch.Tensor:
    emits = torch.zeros((emitcap, 4), dtype=I32, device=dev)
    emits[:, 0].fill_(BIG)
    return emits


# --------------------------------------------------------------------------
# plain torch twin
# --------------------------------------------------------------------------

def walk_torch(nt_walk, nt_edges, valid, cur0, start0, remaining0,
               trav_idx0, w_item, read_of, full, ps_trav, emitcap: int,
               max_iter: int, visits: list = None):
    """Straight port of the jnp walk loop (see module doc). A ``visits``
    list receives, each iteration, the nodes consumed, the ``nt_edges``
    slots followed and the flat ``ps_trav`` slots read: the inputs that
    the walk needs, from which a byte count is made."""
    dev = cur0.device
    lanes = cur0.shape[0]
    tcap = ps_trav.shape[1]
    n_edges_all = nt_edges.shape[0]
    ar = torch.arange(lanes, device=dev)
    trav_l = ps_trav[w_item]                         # (lanes, tcap, 2)
    active, first_iter = valid.clone(), torch.ones(lanes, dtype=torch.bool,
                                                   device=dev)
    cur, start, remaining, trav_idx = cur0, start0, remaining0, trav_idx0
    emits = _empty_emits(emitcap, dev)
    cursor = 0
    spill = False
    it = 0
    while bool(active.any()):
        if it >= max_iter:
            spill = True
            break
        it += 1
        wrows = nt_walk[cur]
        n_edges = wrows[:, 0]
        move = active & ~first_iter
        dead = move & ((remaining <= 0) | (n_edges == 0))
        active = active & ~dead
        move = move & ~dead

        is_bubble_entry = move & (n_edges > 1)
        trav_idx = torch.where(is_bubble_entry, trav_idx - 1, trav_idx)
        choice = torch.where(is_bubble_entry,
                             trav_l[ar, trav_idx.clamp(0, tcap - 1), 1], 0)
        edge = (wrows[:, 3] + choice).clamp(0, n_edges_all - 1)
        nxt = nt_edges[edge]
        cur = torch.where(move, nxt, cur)
        start = torch.where(move, 0, start)
        wrows = torch.where(move[:, None], nt_walk[cur], wrows)

        consume = active & (first_iter | move)
        if visits is not None:
            visits.append((cur[consume], edge[move], (
                w_item * tcap + trav_idx.clamp(0, tcap - 1))[is_bubble_entry]))
        seq_len = wrows[:, 1]
        in_bubble = wrows[:, 2] > 0
        has_seq = seq_len > 0
        end = torch.where(has_seq,
                          torch.minimum(seq_len - 1, start + remaining - 1), 0)
        used = torch.where(consume & has_seq, end - start + 1, 0)
        remaining = remaining - used

        emit = consume & has_seq & in_bubble
        pos_in = torch.cumsum(emit.to(I32), 0, dtype=I32) - 1
        n_emit = int(emit.sum())
        dest = torch.where(emit, cursor + pos_in, emitcap)
        spill = spill or cursor + n_emit > emitcap
        keep = emit & (dest < emitcap)               # JAX drops the rest
        erows = torch.stack([read_of, cur, start, end], dim=1)
        emits[dest[keep]] = erows[keep]
        cursor = min(cursor + n_emit, emitcap)

        returned_now = torch.where(first_iter, consume & in_bubble,
                                   move & (in_bubble | is_bubble_entry))
        active = active & ~(~full & returned_now)
        first_iter = torch.zeros_like(first_iter)
    return emits, torch.tensor(spill, device=dev)


# --------------------------------------------------------------------------
# the kernels' wrapper
# --------------------------------------------------------------------------

def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("walk")
    if lib.per_base.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.per_base.argtypes = ([i, p, p, p, p, p, p, i]   # states
                                 + [p, i, p, p, i]          # sa, ra_*
                                 + [p, i, p]                # rows
                                 + [p, p, i, p, i, p]       # graph, cov
                                 + [i, i, i]                # wcap ..
                                 + [p, p, p, p, i, p, p])   # scratch
        lib.per_base.restype = ctypes.c_int
    return lib


def per_base_cuda(sa, ra_node, ra_offset, nt_step, nt_edges, nt_cov_start,
                  ps_row, ps_lo, ps_hi, ps_trav, ps_ntrav, st_selected,
                  row_len, fallback, cov_diff, wcap: int, emitcap: int,
                  max_iter: int):
    """The whole per-base recorder on PyTorch's current stream
    (csrc/walk.cu): states (NS,) and their paths ps_trav (NS, tcap, 2),
    rows (R,), the graph tables (``nt_step``: RecordTables.nt_step).
    Adds into ``cov_diff`` in place and returns the new fallback (R,)
    int32; the input fallback is left as it is. Raises on what the
    kernels do not take or a failed launch; does not synchronise."""
    tensors = (sa, ra_node, ra_offset, nt_step, nt_edges, nt_cov_start,
               ps_row, ps_lo, ps_hi, ps_trav, ps_ntrav, st_selected,
               row_len, fallback, cov_diff)
    dev = ps_row.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("per_base_cuda: every input must be on one CUDA "
                         f"device, got {sorted({str(t.device) for t in tensors})}")
    if st_selected.dtype != torch.bool:
        raise TypeError("per_base_cuda: st_selected must be torch.bool, "
                        f"got {st_selected.dtype}")
    for name, t in zip(("sa", "ra_node", "ra_offset", "nt_step", "nt_edges",
                        "nt_cov_start", "ps_row", "ps_lo", "ps_hi", "ps_trav",
                        "ps_ntrav", "row_len", "fallback", "cov_diff"),
                       tensors[:11] + tensors[12:]):
        if t.dtype != I32:
            raise TypeError(f"per_base_cuda: {name} must be {I32}, got "
                            f"{t.dtype}")
    NS, R = ps_row.shape[0], row_len.shape[0]
    n_nodes = nt_step.shape[0]
    shapes = {"ps_row": (ps_row, (NS,)), "ps_lo": (ps_lo, (NS,)),
              "ps_hi": (ps_hi, (NS,)), "ps_ntrav": (ps_ntrav, (NS,)),
              "st_selected": (st_selected, (NS,)),
              "ps_trav": (ps_trav, (NS, ps_trav.shape[1] if ps_trav.dim() == 3
                                    else -1, 2)),
              "row_len": (row_len, (R,)), "fallback": (fallback, (R,)),
              "nt_step": (nt_step, (n_nodes, 8)),
              "nt_cov_start": (nt_cov_start, (n_nodes,)),
              "ra_offset": (ra_offset, tuple(ra_node.shape))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"per_base_cuda: {name} must have shape {shape},"
                             f" got {tuple(t.shape)}")
    for name, t in (("sa", sa), ("ra_node", ra_node), ("nt_edges", nt_edges),
                    ("cov_diff", cov_diff)):
        if t.dim() != 1 or t.shape[0] < 1:
            raise ValueError(f"per_base_cuda: {name} must be 1-D and "
                             "non-empty")
    if min(NS, R, n_nodes, ps_trav.shape[1]) < 1:
        raise ValueError("per_base_cuda: needs a state, a row, a node and "
                         "a path slot")
    if min(wcap, emitcap, max_iter) < 1 or emitcap >= 1 << 29:
        raise ValueError("per_base_cuda: wcap, emitcap and max_iter must "
                         "be >= 1, emitcap < 2**29")
    if not cov_diff.is_contiguous():
        raise ValueError("per_base_cuda: cov_diff is added into in place "
                         "and must be contiguous")
    (sa, ra_node, ra_offset, nt_step, nt_edges, nt_cov_start, ps_row, ps_lo,
     ps_hi, ps_trav, ps_ntrav, st_selected, row_len, fallback) = (
        t.contiguous() for t in tensors[:14])
    lib = _kernel_lib()
    # the (row, node) envelope table: the power of two at or above
    # 2 * emitcap (at most emitcap emissions go in, so a probe always
    # finds room and the table is at most half full)
    slots = 1 << max(1, (2 * emitcap - 1).bit_length())
    fb_out = torch.empty(R, dtype=I32, device=dev)
    cum = torch.empty(NS, dtype=I32, device=dev)
    tile_sum = torch.empty(-(-NS // 1024), dtype=I32, device=dev)
    table = torch.empty((slots, 4), dtype=I32, device=dev)
    counters = torch.empty(2, dtype=I32, device=dev)
    err = lib.per_base(
        NS, st_selected.data_ptr(), ps_lo.data_ptr(), ps_hi.data_ptr(),
        ps_row.data_ptr(), ps_ntrav.data_ptr(), ps_trav.data_ptr(),
        ps_trav.shape[1], sa.data_ptr(), sa.shape[0], ra_node.data_ptr(),
        ra_offset.data_ptr(), ra_node.shape[0], row_len.data_ptr(), R,
        fallback.data_ptr(), nt_step.data_ptr(), nt_edges.data_ptr(),
        nt_edges.shape[0], nt_cov_start.data_ptr(), cov_diff.shape[0],
        cov_diff.data_ptr(), wcap, emitcap, max_iter, fb_out.data_ptr(),
        cum.data_ptr(), tile_sum.data_ptr(), table.data_ptr(), slots,
        counters.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"per-base kernel launch failed: CUDA error {err}")
    per_base_cuda.launches += 1
    return fb_out


per_base_cuda.launches = 0
