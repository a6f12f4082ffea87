"""Per-base walk (K9): the CUDA kernel and its plain torch twin.

Port of the walk loop of gramtools_tpu/mapping/record_jax.py::
_record_per_base_device (``make_body`` under ``lax.while_loop``; on the
TPU it is XLA-lowered jnp, not Pallas). Each walk lane is one selected
state's SA occurrence: it starts at (node cur0, offset start0) with
``remaining0`` read bases left and walks the coverage graph, taking the
edge its traversed allele names at each bubble entry (``trav_idx``
counts down the state's path ``ps_trav[w_item]``), until the read is
used up, the graph ends, or a partial occurrence (``full`` false) leaves
the bubble it started in. Every in-bubble node it covers emits
``(row, node, start, end)``.

Returns ``(emits (emitcap, 4) int32, spill () bool)``. Unfilled rows
hold ``(2**30, 0, 0, 0)``. ``spill`` is set when the lanes emitted more
than ``emitcap`` rows (the rows past it are dropped) or a lane outran
``max_iter`` iterations, which a walk over the acyclic coverage graph
cannot do (it moves one node an iteration); the caller then flags
every selected row. The emission ORDER is not part of the contract: the
twin emits in the jnp code's order, the kernel in atomic-cursor order,
and the caller's stable (row, node) sort and segment min/max envelope
do not depend on it.

``walk`` routes by device: CPU tensors take the twin (a Python
``while any(active)`` loop), CUDA tensors launch ``csrc/walk.cu``, one
thread per lane, with no host synchronisation. ``walk.launches`` counts
kernel launches.
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
               max_iter: int):
    """Straight port of the jnp walk loop (see module doc)."""
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
        nxt = nt_edges[(wrows[:, 3] + choice).clamp(0, n_edges_all - 1)]
        cur = torch.where(move, nxt, cur)
        start = torch.where(move, 0, start)
        wrows = torch.where(move[:, None], nt_walk[cur], wrows)

        consume = active & (first_iter | move)
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
# the kernel's wrapper
# --------------------------------------------------------------------------

def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("walk")
    if lib.walk.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.walk.argtypes = ([i, p, p, p, p, p, p, p, p]   # lanes
                             + [p, i]                      # ps_trav
                             + [p, p, i, i]                # graph, max_iter
                             + [i, p, p, p, p])            # outputs, stream
        lib.walk.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"walk_cuda: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"walk_cuda: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def walk_cuda(nt_walk, nt_edges, valid, cur0, start0, remaining0,
              trav_idx0, w_item, read_of, full, ps_trav, emitcap: int,
              max_iter: int):
    """Launch csrc/walk.cu on PyTorch's current stream. Raises on what
    the kernel does not take; does not synchronise. Strided inputs are
    made contiguous first."""
    (nt_walk, nt_edges, valid, cur0, start0, remaining0, trav_idx0, w_item,
     read_of, full, ps_trav) = tensors = tuple(
        t.contiguous() for t in (nt_walk, nt_edges, valid, cur0, start0,
                                 remaining0, trav_idx0, w_item, read_of,
                                 full, ps_trav))
    dev = cur0.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("walk_cuda: every input must be on one CUDA "
                         f"device, got {sorted({str(t.device) for t in tensors})}")
    lanes = cur0.shape[0]
    for name, t in (("cur0", cur0), ("start0", start0),
                    ("remaining0", remaining0), ("trav_idx0", trav_idx0),
                    ("w_item", w_item), ("read_of", read_of)):
        _check(name, t, I32, (lanes,))
    _check("valid", valid, torch.bool, (lanes,))
    _check("full", full, torch.bool, (lanes,))
    if nt_walk.dim() != 2 or nt_walk.shape[1] != 4:
        raise ValueError("walk_cuda: nt_walk must be (n_nodes, 4)")
    _check("nt_walk", nt_walk, I32, tuple(nt_walk.shape))
    if nt_edges.dim() != 1 or nt_edges.shape[0] < 1:
        raise ValueError("walk_cuda: nt_edges must be 1-D and non-empty")
    _check("nt_edges", nt_edges, I32, tuple(nt_edges.shape))
    if ps_trav.dim() != 3 or ps_trav.shape[2] != 2 or ps_trav.shape[0] < 1:
        raise ValueError("walk_cuda: ps_trav must be (n_states >= 1, tcap, 2)")
    _check("ps_trav", ps_trav, I32, tuple(ps_trav.shape))
    if emitcap < 1:
        raise ValueError("walk_cuda: emitcap must be >= 1")
    emits = _empty_emits(emitcap, dev)
    counters = torch.zeros(2, dtype=I32, device=dev)   # cursor, overrun
    if lanes:
        lib = _kernel_lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.walk(
            lanes, valid.data_ptr(), cur0.data_ptr(), start0.data_ptr(),
            remaining0.data_ptr(), trav_idx0.data_ptr(), w_item.data_ptr(),
            read_of.data_ptr(), full.data_ptr(),
            ps_trav.data_ptr(), ps_trav.shape[1],
            nt_walk.data_ptr(), nt_edges.data_ptr(), nt_edges.shape[0],
            max_iter, emitcap, emits.data_ptr(), counters.data_ptr(),
            counters[1:].data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"walk kernel launch failed: CUDA error {err}")
        walk.launches += 1
    spill = (counters[0] > emitcap) | (counters[1] > 0)
    return emits, spill


def walk(nt_walk, nt_edges, valid, cur0, start0, remaining0, trav_idx0,
         w_item, read_of, full, ps_trav, emitcap: int, max_iter: int):
    """CPU tensors take the plain twin; CUDA tensors launch the kernel
    or raise."""
    args = (nt_walk, nt_edges, valid, cur0, start0, remaining0, trav_idx0,
            w_item, read_of, full, ps_trav, emitcap, max_iter)
    if cur0.device.type == "cpu":
        return walk_torch(*args)
    if cur0.device.type == "cuda":
        return walk_cuda(*args)
    raise ValueError(f"walk: unsupported device {cur0.device}")


walk.launches = 0
