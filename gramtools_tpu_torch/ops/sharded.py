"""The SA-range-sharded index (K10): its tables, the plain version of its
gathers, and its scan in gather rounds on the cards of a mesh row.

Port of gramtools_tpu/parallel/sharded_index.py's ``shard_fn``: every
device of the "idx" axis runs the same scan on the same pool, each of
its gathers (``occ_rows``, ``narrow_rows``) a masked local gather on
each shard and a ``psum`` over the axis (XLA on the TPU). The dense occ
table (n + 1, 4) and the narrow-step table (n,) shard by SA range: shard
i holds rows [i * rows_per_shard, (i + 1) * rows_per_shard), the last
one padded with zero rows, each on its device of the mesh row (a device
may hold several).

``sharded_scan`` runs a plan's steps over a ``ShardedTables``. CPU
tensors take its plain version, ``sharded_scan_torch``: the torch steps
(mapping/scan_steps.py) with ``_sharded_gather``, the sum over the
shards of each one's masked gather. CUDA tensors take
``sharded_rounds``: ``csrc/sharded_step.cu``, two launches a step on
every distinct card of the row, each card gathering from its own shards
alone (each row's owner value, zero where it holds no owner), and
between two launches ``torch.cuda.nccl.all_reduce`` of the cards'
answers on their current streams, one process, no host synchronisation
(the plan fixes every shape). A row on one card makes no collective; a
row whose cards NCCL cannot serve raises, naming them. No kernel reads
another card's memory: the row's cards are ordered by their streams and
the collectives. ``sharded_scan.launches`` counts kernel launches (on
every card) and ``sharded_scan.collectives`` the all-reduces; nothing
on CUDA calls ``_sharded_gather``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

I32 = torch.int32
MAX_SHARDS = 8
"""The most shards of a table on one card (``kMaxShards``)."""

_WIDE, _NARROW, _LOCKED = 0, 1, 2


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
    device the scan's outputs are taken on; ``has_narrow``: the narrow
    tail runs (the index has a narrow table of n rows). ``stubs`` keeps
    the scan's small index tables on each other card of the row."""

    occ: Tuple[torch.Tensor, ...]
    narrow: Tuple[torch.Tensor, ...]
    rows_per_shard: int
    nt_rows_per_shard: int
    has_narrow: bool
    size: int
    home: torch.device
    stubs: dict = field(default_factory=dict, repr=False)

    @property
    def n_shards(self) -> int:
        return len(self.occ)

    @property
    def cards(self) -> Tuple[torch.device, ...]:
        """The distinct devices that hold the row's shards, in shard
        order (a tensor's device always names its index)."""
        return tuple(dict.fromkeys(t.device for t in self.occ))

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
    device. Any number of shards; the kernels take up to MAX_SHARDS on
    one card (``check_tables``)."""
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
# the scan over the tables
# ---------------------------------------------------------------------------

def sharded_scan_torch(di, reads, carry, plan, num_reads: int, lp, le,
                       tables: ShardedTables):
    """The plain version: the torch steps over every phase of ``plan``
    with the shards' plain gathers (``_sharded_gather``), each step's log
    records written into lp/le in place. Returns the final carry."""
    from ..mapping.scan_steps import run_phases
    from .packed_reads import as_rows

    carry, _ = run_phases(di, as_rows(reads), carry, plan, num_reads, lp, le,
                          occ_rows=tables.occ_rows(),
                          narrow_rows=tables.narrow_rows())
    return carry


def check_tables(fn: str, tables: ShardedTables, n: int) -> None:
    """Raise unless ``tables`` shard the (n + 1, 4) occ table and the
    (n,) narrow table as the kernels read them: every shard on a CUDA
    card, at most MAX_SHARDS of a table on one card."""
    S = tables.n_shards
    rps, nt_rps = tables.rows_per_shard, tables.nt_rows_per_shard
    if S < 1 or len(tables.narrow) != S:
        raise ValueError(f"{fn}: as many narrow shards as occ shards, and "
                         f"at least one")
    on_card = {}
    for t in tables.occ:
        on_card[t.device] = on_card.get(t.device, 0) + 1
    for dev, k in on_card.items():
        if k > MAX_SHARDS:
            raise ValueError(f"{fn}: at most {MAX_SHARDS} shards of a table "
                             f"on one card, {k} on {dev}")
    if tables.size != n or rps * S < n + 1:
        raise ValueError(f"{fn}: {S} occ shards of {rps} rows do not cover "
                         f"the {n + 1} rows")
    if tables.has_narrow and nt_rps * S < n:
        raise ValueError(f"{fn}: {S} narrow shards of {nt_rps} rows do not "
                         f"cover the {n} rows")
    if rps * S >= 2 ** 31 or nt_rps * S >= 2 ** 31:
        raise ValueError(f"{fn}: shard rows need int32 indices")
    for name, ts, shape in (("occ", tables.occ, (rps, 4)),
                            ("narrow", tables.narrow, (nt_rps,))):
        for t in ts:
            if t.dtype != I32 or tuple(t.shape) != shape or \
                    not t.is_contiguous():
                raise ValueError(f"{fn}: a {name} shard must be a contiguous "
                                 f"int32 {shape} tensor")
    if any(t.device.type != "cuda" for t in tables.occ + tables.narrow):
        raise ValueError(f"{fn}: every index shard must be on a CUDA card")


def step_table(plan, R: int, n_in: int, B: int, has_narrow: bool):
    """The kernels' step table of ``plan`` ((n_steps, pool, hits,
    narrow_w, kind), ...): a row a step, (kind, pool, hits, wide
    budget, log base, read row, carry buffer read, lock before it).
    Returns (rows, C slots, K pairs, round-1 answer ints)."""
    rows = []
    log_base = 0
    C, K, a1 = max(n_in, R), 1, 4
    for n_steps, pool, hits, narrow_w, kind in plan:
        if n_steps < 1 or pool < 1 or hits < 1:
            raise ValueError(f"sharded_rounds: a phase needs steps, pool "
                             f"and hits >= 1, got {(n_steps, pool, hits)}")
        narrow = narrow_w > 0 and has_narrow
        k = (_LOCKED if narrow and kind == "locked"
             else _NARROW if narrow else _WIDE)
        if k == _LOCKED and pool != R:
            raise ValueError(f"sharded_rounds: a locked phase needs pool "
                             f"== R, got {pool} and {R}")
        W = narrow_w if narrow else 0
        C, K = max(C, pool), max(K, hits * B)
        a1 = max(a1, 4 * pool if k == _WIDE else
                 -(-pool // 4) * 4 + 4 * W)
        for j in range(n_steps):
            lock = int(k == _LOCKED and j == 0)
            cur = (rows[-1][6] ^ 1 if rows else 0) ^ lock
            rows.append((k, pool, hits, W, log_base, len(rows), cur, lock))
            log_base += hits * B
    return rows, C, K, a1


def _kernel_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("sharded_step")
    if lib.sharded_setup.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        lib.sharded_setup.argtypes = (
            [p, i, ptrs, ptrs, ints, i, i, i, i]     # ctx, card, shards
            + [p, p, p, i, p, p, i, i]               # sym_start .. B
            + [p, i, i, p, p, p, p, p, i]            # reads, carry in
            + [p, i, p, p, p, p, i, i, ints, i])     # buffers, step table
        lib.sharded_setup.restype = ctypes.c_int
        lib.sharded_launch.argtypes = [p, i, p]
        lib.sharded_launch.restype = ctypes.c_int
        lib.sharded_scratch_ints.argtypes = [i, i, i]
        lib.sharded_scratch_ints.restype = ctypes.c_longlong
        lib.sharded_context_bytes.argtypes = []
        lib.sharded_context_bytes.restype = ctypes.c_int
    return lib


def kernel_attrs(which: int = 0) -> dict:
    """The registers a thread, local (spill) bytes a thread and static
    shared bytes a block of the open (0) or mid (1) kernel."""
    from . import _build

    return _build.kernel_attrs(_kernel_lib().sharded_attrs, which)


def _stub(di, tables: ShardedTables, card):
    """The scan's small index tables (sym_start, sentinel_row,
    marker_rank_locus, out_lo, out_hi) on ``card``, uploaded once a card
    and kept in ``tables.stubs``."""
    names = ("sym_start", "sentinel_row", "marker_rank_locus", "out_lo",
             "out_hi")
    if card == di.sym_start.device:
        return [getattr(di, f) for f in names]
    kept = tables.stubs.get(card)
    if kept is None or kept[0] is not di:
        kept = (di, [getattr(di, f).to(card) for f in names])
        tables.stubs[card] = kept
    return kept[1]


def check_index(fn: str, di, narrow: bool) -> None:
    """Raise unless the index has its jump and symbol tables and, where
    the plan reads the narrow table (``narrow``), n < 2**24, the rows its
    24-bit words address. A wide-only plan takes any n: its rounds read
    occ rows alone (the narrow table of an index of 2**24 rows or more is
    a stub, mapping/device_index.py)."""
    if narrow and di.size >= 2 ** 24:
        raise ValueError(f"{fn}: the narrow table needs n < 2**24")
    if di.sym_start.shape[0] < 5 or di.out_lo.shape != di.out_hi.shape or \
            di.out_lo.shape[0] < 1:
        raise ValueError(f"{fn}: needs the index's jump and symbol tables")


def _check_args(fn: str, di, reads, carry, lp, le, end: int, narrow: bool):
    """reads (S, R) int32, the carry's four (n_in,) int32 fields and
    (R + 1,) bool flags, the log halves and the index's small tables,
    all contiguous on the scan's card, and the index as ``check_index``
    takes it. Returns (S, R, n_in)."""
    if not isinstance(reads, torch.Tensor) or reads.dim() != 2 or \
            reads.dtype != I32:
        raise ValueError(f"{fn}: reads must be an int32 (steps, R) tensor")
    S, R = reads.shape
    rid, lo, hi, pref, ovf = carry
    n_in = rid.shape[0]
    small = [di.sym_start, di.sentinel_row, di.marker_rank_locus, di.out_lo,
             di.out_hi]
    tensors = [reads, rid, lo, hi, pref, ovf, lp, le] + small
    dev = reads.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{fn}: every input must be on one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn}: every input must be contiguous")
    if R < 1 or n_in < 1:
        raise ValueError(f"{fn}: needs R >= 1 and a carry")
    for t in (rid, lo, hi, pref):
        if t.dtype != I32 or tuple(t.shape) != (n_in,):
            raise ValueError(f"{fn}: the carry's fields must be int32 "
                             f"({n_in},)")
    if ovf.dtype != torch.bool or tuple(ovf.shape) != (R + 1,):
        raise ValueError(f"{fn}: overflow must be bool ({R + 1},)")
    for t in (lp, le):
        if t.dtype != I32 or t.dim() != 1 or t.shape[0] < end:
            raise ValueError(f"{fn}: the log halves must be int32 holding "
                             f"{end} records")
    check_index(fn, di, narrow)
    return S, R, n_in


def _nccl_check(fn: str, cards, probes) -> None:
    """Raise, naming the cards, unless NCCL can all-reduce over them."""
    names = ", ".join(str(c) for c in cards)
    try:
        from torch.cuda import nccl
        ok = nccl.is_available(probes)
    except (ImportError, RuntimeError, TypeError):
        ok = False
    if not ok:
        raise RuntimeError(f"{fn}: NCCL cannot all-reduce over the cards "
                           f"{names} of the mesh row")


def sharded_rounds(di, reads, carry, plan, num_reads: int, lp, le,
                   tables: ShardedTables) -> dict:
    """The scan on every distinct card of the row: {card: (final carry
    with its (R + 1,) flags, (lp, le))}, the scan's card (reads.device,
    which must hold a shard or be ``tables.home``) writing into lp/le,
    each other card into a log of its own. Launches on the cards'
    current streams; does not synchronise."""
    fn = "sharded_rounds"
    plan = [tuple(e) for e in plan]
    B = di.n_outcomes
    rows, C, K, a1 = step_table(plan, num_reads, carry[0].shape[0], B,
                                tables.has_narrow)
    end = rows[-1][4] + rows[-1][2] * B
    S, R, n_in = _check_args(fn, di, reads, carry, lp, le, end,
                             any(r[0] != _WIDE for r in rows))
    if R != num_reads or S != len(rows):
        raise ValueError(f"{fn}: reads must be ({len(rows)}, {num_reads}), "
                         f"got {(S, R)}")
    check_tables(fn, tables, di.size)
    home = reads.device
    cards = (home,) + tuple(c for c in tables.cards if c != home)
    lib = _kernel_lib()
    table = (ctypes.c_int * (8 * len(rows)))(*[v for r in rows for v in r])
    ints = lib.sharded_scratch_ints(C, K, a1)
    state = []
    for card in cards:
        if card == home:
            rd, cin, logs = reads, carry, (lp, le)
        else:
            rd = reads.to(card)
            cin = tuple(a.to(card) for a in carry)
            logs = (torch.empty_like(lp, device=card),
                    torch.empty_like(le, device=card))
        local = [i for i, t in enumerate(tables.occ) if t.device == card]
        occ = (ctypes.c_void_p * MAX_SHARDS)(
            *[tables.occ[i].data_ptr() for i in local])
        nt = (ctypes.c_void_p * MAX_SHARDS)(
            *[tables.narrow[i].data_ptr() for i in local])
        ids = (ctypes.c_int * MAX_SHARDS)(*local)
        buf = torch.empty((2, 4, C), dtype=I32, device=card)
        ovf = torch.empty(R + 1, dtype=torch.bool, device=card)
        scratch = torch.empty(ints, dtype=I32, device=card)
        sym, sent, mrl, out_lo, out_hi = _stub(di, tables, card)
        ctx = ctypes.create_string_buffer(lib.sharded_context_bytes())
        err = lib.sharded_setup(
            ctypes.addressof(ctx), card.index, occ, nt, ids, len(local), tables.rows_per_shard,
            tables.nt_rows_per_shard, di.size, sym.data_ptr(),
            sent.data_ptr(), mrl.data_ptr(), mrl.shape[0], out_lo.data_ptr(),
            out_hi.data_ptr(), out_lo.shape[0], B, rd.data_ptr(), S, R,
            *[a.data_ptr() for a in cin], n_in, buf.data_ptr(), C,
            ovf.data_ptr(), logs[0].data_ptr(), logs[1].data_ptr(),
            scratch.data_ptr(), K, a1, table, len(rows))
        if err != 0:
            raise ValueError(f"{fn}: the kernels refuse the scan on {card} "
                             f"(CUDA error {err})")
        stream = torch.cuda.current_stream(card).cuda_stream
        state.append((card, ctypes.addressof(ctx), stream, buf, ovf, scratch,
                      logs, rd, cin, ctx))
    # round 1 of step s is ans[:n1], round 2 ans[a1:a1 + 2 hits B]
    regions = []
    if len(cards) > 1:
        _nccl_check(fn, cards, [st[5] for st in state])
        for k, N, G, W, *_ in rows:
            n1 = 4 * N if k == _WIDE else -(-N // 4) * 4 + 4 * W
            regions.append([st[5][:n1] for st in state])
            regions.append([st[5][a1:a1 + 2 * G * B] for st in state])
        from torch.cuda import nccl
    for i in range(2 * len(rows) + 1):
        for card, ctx, stream, *_ in state:
            err = lib.sharded_launch(ctx, i, stream)
            if err != 0:
                raise RuntimeError(f"sharded_step kernel launch {i} on "
                                   f"{card} failed: CUDA error {err}")
        sharded_scan.launches += len(state)
        if regions and i < len(regions):
            nccl.all_reduce(regions[i])
            sharded_scan.collectives += 1
    last = rows[-1]
    n_out = last[1]
    out = {}
    for card, ctx, stream, buf, ovf, scratch, logs, *_ in state:
        b = buf[last[6] ^ 1]
        out[card] = ((b[0, :n_out], b[1, :n_out], b[2, :n_out],
                      b[3, :n_out], ovf), logs)
    return out


def sharded_scan(di, reads, carry, plan, num_reads: int, lp, le,
                 tables: ShardedTables):
    """The plan's steps over the sharded tables: ``plan`` the phases
    (n_steps, pool, hits, narrow_w, kind), reads (steps, R), carry
    (read_id, lo, hi, pref, overflow (R + 1,)), the log halves lp/le
    written in place. CPU tensors take the plain version; CUDA tensors
    launch the kernels or raise."""
    if reads.device.type == "cpu":
        return sharded_scan_torch(di, reads, carry, plan, num_reads, lp, le,
                                  tables)
    if reads.device.type == "cuda":
        return sharded_rounds(di, reads, carry, plan, num_reads, lp, le,
                              tables)[reads.device][0]
    raise ValueError(f"sharded_scan: unsupported device {reads.device}")


sharded_scan.launches = 0
sharded_scan.collectives = 0
