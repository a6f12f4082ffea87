"""Genealogy replay (K7): the CUDA kernel and its plain torch twin.

Port of gramtools_tpu/mapping/record_jax.py::replay_device (XLA-lowered
jnp on the TPU, not Pallas). For every pool state, chase the genealogy
log from its final ``pref`` back to its seed state (at most
``max_chain`` events), gather the seed's traversed/traversing paths from
the resident CSR seed tables, then apply the jump-table ops of the
chased events root to leaf: an exit pops ``ing`` and appends (site,
allele) to ``trav``; an enter pushes (site, ALLELE_UNKNOWN) on ``ing``.

Returns ``(trav (N, tcap, 2), n_trav (N,), ing (N, tcap, 2), n_ing
(N,), bad (N,) bool)`` exactly as the JAX function does, including its
clamped gathers and dropped writes: a dead state replays seed 0's paths
with no events, and ``bad`` marks live states whose chain outran
``max_chain`` or whose paths outran ``tcap``.

``replay`` routes by device: CPU tensors take the twin (the jnp code's
two ``while_loop``s become Python loops; their ``any()`` tests cost
nothing on the CPU), CUDA tensors launch ``csrc/replay.cu``, one thread
per state, which needs no host synchronisation. ``replay.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gramtools_tpu.mapping.jump_table import OP_ENTER, OP_EXIT
from gramtools_tpu.prg.markers import ALLELE_UNKNOWN

I32 = torch.int32


class SeedPaths(NamedTuple):
    """The resident seed-state tables the replay reads (the CSR part of
    mapping/record.SeedTables)."""

    k_nt: torch.Tensor      # (Ns,) traversed-path lengths
    k_ni: torch.Tensor      # (Ns,) traversing-path lengths
    k_toff: torch.Tensor    # (Ns,) CSR offsets into t_flat
    k_ioff: torch.Tensor    # (Ns,) CSR offsets into i_flat
    t_flat: torch.Tensor    # (sum n_trav | 1, 2)
    i_flat: torch.Tensor    # (sum n_ing | 1, 2)
    max_path: int


class JumpOps(NamedTuple):
    """Per-event jump-table ops, (events, n_ops) int32 each."""

    kind: torch.Tensor
    site: torch.Tensor
    allele: torch.Tensor


# --------------------------------------------------------------------------
# plain torch twin
# --------------------------------------------------------------------------

def replay_torch(f_pref, alive, log_parent, log_event, seeds: SeedPaths,
                 ops: JumpOps, max_chain: int, tcap: int):
    """Straight port of replay_device's jnp code (see module doc)."""
    dev = f_pref.device
    N = f_pref.shape[0]
    n_states = seeds.k_nt.shape[0]
    Lg = max(log_event.shape[0], 1)
    le = log_event if log_event.shape[0] else torch.zeros(1, dtype=I32,
                                                          device=dev)
    lp = log_parent if log_parent.shape[0] else torch.zeros(1, dtype=I32,
                                                            device=dev)
    p = torch.where(alive, f_pref, -1)
    events = torch.full((max_chain, N), -1, dtype=I32, device=dev)
    depth = 0
    while depth < max_chain and bool((p >= 0).any()):
        live = p >= 0
        pc = p.clamp(0, Lg - 1)
        events[depth] = torch.where(live, le[pc], -1)
        p = torch.where(live, lp[pc], p)
        depth += 1
    bad = alive & (p >= 0)
    seed_idx = (-p - 1).clamp(0, max(n_states - 1, 0))

    P0c = min(seeds.max_path, tcap)
    trav = torch.zeros((N, tcap, 2), dtype=I32, device=dev)
    ing = torch.zeros((N, tcap, 2), dtype=I32, device=dev)
    n_trav = seeds.k_nt[seed_idx].to(I32)
    n_ing = seeds.k_ni[seed_idx].to(I32)
    if P0c:
        sl = torch.arange(P0c, dtype=I32, device=dev)
        tg = (seeds.k_toff[seed_idx][:, None] + sl[None, :]).clamp(
            0, seeds.t_flat.shape[0] - 1)
        ig = (seeds.k_ioff[seed_idx][:, None] + sl[None, :]).clamp(
            0, seeds.i_flat.shape[0] - 1)
        tmask = (sl[None, :] < n_trav[:, None])[:, :, None]
        imask = (sl[None, :] < n_ing[:, None])[:, :, None]
        trav[:, :P0c] = torch.where(tmask, seeds.t_flat[tg], 0)
        ing[:, :P0c] = torch.where(imask, seeds.i_flat[ig], 0)
    bad = bad | (alive & ((n_trav > tcap) | (n_ing > tcap)))

    n_ev = ops.kind.shape[0]
    n_ops = ops.kind.shape[1]
    ar = torch.arange(N, device=dev)
    # one dump column past the last slot stands in for JAX's dropped
    # writes at wpos == tcap
    trav = torch.cat([trav, torch.zeros((N, 1, 2), dtype=I32, device=dev)],
                     dim=1)
    ing = torch.cat([ing, torch.zeros((N, 1, 2), dtype=I32, device=dev)],
                    dim=1)
    for d in range(depth - 1, -1, -1):
        ev = events[d]
        valid = ev >= 0
        evc = ev.clamp(0, n_ev - 1)
        kind_rows, site_rows, allele_rows = (ops.kind[evc], ops.site[evc],
                                             ops.allele[evc])
        for o in range(n_ops):
            kind = torch.where(valid, kind_rows[:, o], 0)
            site = site_rows[:, o]
            allele = allele_rows[:, o]
            is_exit = kind == OP_EXIT
            is_enter = kind == OP_ENTER
            n_ing = torch.where(is_exit & (n_ing > 0), n_ing - 1, n_ing)
            wpos = torch.where(is_exit, n_trav.clamp(max=tcap), tcap)
            trav[ar, wpos] = torch.stack([site, allele], dim=1)
            bad = bad | (is_exit & (n_trav >= tcap))
            n_trav = torch.where(is_exit, (n_trav + 1).clamp(max=tcap), n_trav)
            wpos = torch.where(is_enter, n_ing.clamp(max=tcap), tcap)
            ing[ar, wpos] = torch.stack(
                [site, torch.full_like(site, ALLELE_UNKNOWN)], dim=1)
            bad = bad | (is_enter & (n_ing >= tcap))
            n_ing = torch.where(is_enter, (n_ing + 1).clamp(max=tcap), n_ing)
    return (trav[:, :tcap].contiguous(), n_trav, ing[:, :tcap].contiguous(),
            n_ing, bad)


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("replay")
    if lib.replay.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.replay.argtypes = ([p, p, i, p, p, i]        # states, log
                               + [p, p, p, p, p, i, p, i, i, i]  # seeds
                               + [p, p, p, i, i]         # jump ops
                               + [i, i, p]               # caps, scratch
                               + [p, p, p, p, p, p])     # outputs, stream
        lib.replay.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"replay_cuda: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"replay_cuda: {name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def replay_cuda(f_pref, alive, log_parent, log_event, seeds: SeedPaths,
                ops: JumpOps, max_chain: int, tcap: int):
    """Launch csrc/replay.cu on PyTorch's current stream. Raises on what
    the kernel does not take; does not synchronise. Strided inputs (such
    as a column of the scan's carry) are made contiguous first."""
    f_pref, alive, log_parent, log_event = (
        t.contiguous() for t in (f_pref, alive, log_parent, log_event))
    seeds = seeds._replace(**{f: getattr(seeds, f).contiguous()
                              for f in seeds._fields[:6]})
    ops = JumpOps(*(t.contiguous() for t in ops))
    tensors = [f_pref, alive, log_parent, log_event, ops.kind, ops.site,
               ops.allele] + list(seeds[:6])
    dev = f_pref.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("replay_cuda: every input must be on one CUDA "
                         f"device, got {sorted({str(t.device) for t in tensors})}")
    N = f_pref.shape[0]
    _check("f_pref", f_pref, I32, (N,))
    _check("alive", alive, torch.bool, (N,))
    L = log_parent.shape[0]
    _check("log_parent", log_parent, I32, (L,))
    _check("log_event", log_event, I32, (L,))
    n_states = seeds.k_nt.shape[0]
    for name in ("k_nt", "k_ni", "k_toff", "k_ioff"):
        _check(name, getattr(seeds, name), I32, (n_states,))
    _check("t_flat", seeds.t_flat, I32)
    _check("i_flat", seeds.i_flat, I32)
    if (seeds.t_flat.dim() != 2 or seeds.t_flat.shape[1] != 2
            or seeds.i_flat.dim() != 2 or seeds.i_flat.shape[1] != 2
            or seeds.t_flat.shape[0] < 1 or seeds.i_flat.shape[0] < 1):
        raise ValueError("replay_cuda: t_flat and i_flat must be (n >= 1, 2)")
    if n_states < 1:
        raise ValueError("replay_cuda: the seed tables hold no state")
    n_ev, n_ops = ops.kind.shape[0], ops.kind.shape[1]
    for name in ("kind", "site", "allele"):
        _check(name, getattr(ops, name), I32, (n_ev, n_ops))
    if max_chain < 1 or tcap < 1:
        raise ValueError("replay_cuda: max_chain and tcap must be >= 1")
    if L == 0:
        log_parent = log_event = torch.zeros(1, dtype=I32, device=dev)
    trav = torch.empty((N, tcap, 2), dtype=I32, device=dev)
    ing = torch.empty((N, tcap, 2), dtype=I32, device=dev)
    n_trav = torch.empty(N, dtype=I32, device=dev)
    n_ing = torch.empty(N, dtype=I32, device=dev)
    bad = torch.empty(N, dtype=torch.bool, device=dev)
    if N == 0:
        return trav, n_trav, ing, n_ing, bad
    scratch = torch.empty((N, max_chain), dtype=I32, device=dev)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.replay(
        f_pref.data_ptr(), alive.data_ptr(), N,
        log_parent.data_ptr(), log_event.data_ptr(), max(L, 1),
        seeds.k_nt.data_ptr(), seeds.k_ni.data_ptr(), seeds.k_toff.data_ptr(),
        seeds.k_ioff.data_ptr(), seeds.t_flat.data_ptr(),
        seeds.t_flat.shape[0], seeds.i_flat.data_ptr(), seeds.i_flat.shape[0],
        n_states, min(seeds.max_path, tcap),
        ops.kind.data_ptr(), ops.site.data_ptr(), ops.allele.data_ptr(),
        n_ev, n_ops,
        max_chain, tcap, scratch.data_ptr(),
        trav.data_ptr(), n_trav.data_ptr(), ing.data_ptr(), n_ing.data_ptr(),
        bad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"replay kernel launch failed: CUDA error {err}")
    replay.launches += 1
    return trav, n_trav, ing, n_ing, bad


def replay(f_pref, alive, log_parent, log_event, seeds: SeedPaths,
           ops: JumpOps, max_chain: int, tcap: int):
    """CPU tensors take the plain twin; CUDA tensors launch the kernel
    or raise."""
    if f_pref.device.type == "cpu":
        return replay_torch(f_pref, alive, log_parent, log_event, seeds, ops,
                            max_chain, tcap)
    if f_pref.device.type == "cuda":
        return replay_cuda(f_pref, alive, log_parent, log_event, seeds, ops,
                           max_chain, tcap)
    raise ValueError(f"replay: unsupported device {f_pref.device}")


replay.launches = 0
