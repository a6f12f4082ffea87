"""What the redesigned scan kernels rest on, held on the CPU.

csrc/wide_step.cu (K2) and the hole-allocated range of csrc/locked_step.cu
(K3) run a scan step with one grid sync: each tile ranks its slots by
chained scans with decoupled look-back, works its own hit pairs (each
pair's owner by a binary search over the tile's prefix of hits), stages
its newborn candidates at their rank in tile order, and the next step
reads the staged newborns (K2: slot n_keep + c; K3: the hole of rank c,
over the hole's own row). A CUDA kernel cannot run here, so a numpy
mirror of that pass structure, tile by tile with small tiles and short
look-back windows (each earlier tile seen as its aggregate or, where
published, its inclusive prefix, drawn at random), is held bit for bit
(carry, every flag with the dump slot, every log record) to the JAX
package's ``_resize_pool`` + ``_build_log_step`` and ``_resize_pool`` +
``_build_narrow_step(locked=False)`` under ``lax.scan``, and to the torch
twins, on numpy-seeded carries and reads. The cases force what the design
must get right, and each test checks that its case did: several tiles
(and, in K2, tiles past the pool's live front that do not run), a
tile with more hit pairs than threads, a step with no hit and one with
more hits than G, survivors and newborns overfilling the pool, more
candidates than holes, more holes than G·B, W binding inside a tile. Then, on
JAX's steps themselves, the two facts the candidate rank in tile order
rests on: the newborns are in the slot order of their owners, and an empty
hit slot (g >= min(total, G)) is never one. All integers: exact equality.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gramtools_tpu.mapping import search_jax_log as jsl
from gramtools_tpu_torch.ops import locked_step, wide_step

from test_torch_scan import _to_jax, _to_torch
from test_torch_scan_kernels import (LOG_BASE, R, WIDE, _case,
                                     _jax_narrow, _jax_wide, _log)

THREADS = 8        # slots a tile in the mirror (the kernels: 256)
WINDOW = 4         # tiles a look-back window (the kernels: a warp, 32)
NO_HOLE = 2 ** 31 - 1


class Tables:
    """The index tables a step reads, as numpy (the dense occ rows)."""

    def __init__(self, jdi):
        self.occ = np.asarray(jdi.occ).astype(np.int64)
        self.n = int(jdi.size)
        self.sym_start = np.asarray(jdi.sym_start).astype(np.int64)
        self.sent = int(np.asarray(jdi.sentinel_row))
        self.mrl = np.asarray(jdi.marker_rank_locus).astype(np.int64)
        self.out_lo = np.asarray(jdi.out_lo).astype(np.int64)
        self.out_hi = np.asarray(jdi.out_hi).astype(np.int64)
        self.narrow_tab = np.asarray(jdi.narrow_tab).astype(np.int64)
        self.B = int(jdi.n_outcomes)
        self.L = self.out_lo.shape[0]

    def row(self, r):
        return self.occ[min(max(r, 0), self.n)]

    def lf(self, lo, hi, base):
        """(nlo, nhi, mlo, mhi) of [lo, hi] extended by base."""
        rl, rh = self.row(lo), self.row(hi + 1)
        first = self.sym_start[min(max(base, 0), 4)]
        ch = lambda v: v[base - 1] if 1 <= base <= 4 else 0
        return (first + ch(rl), first + ch(rh) - 1,
                lo - rl.sum() - (lo > self.sent),
                hi + 1 - rh.sum() - (hi + 1 > self.sent))


# ---- the chained scans ------------------------------------------------------

def combine(a, b):
    """Payloads (n, sum, last, pref), a then b: right-biased in last/pref."""
    return ((a[0] + b[0], a[1] + b[1]) + (b[2:] if b[2] >= 0 else a[2:]))


NO_PAYLOAD = (0, 0, -1, 0)


class Chain:
    """One step's descriptors: each tile's aggregate and, once published,
    its inclusive prefix. ``lookback`` reads them as the kernels' look-back
    warp does, a window of WINDOW tiles at a time from the nearest back to
    the nearest inclusive prefix, each earlier tile's inclusive prefix seen
    where published and the draw says so, else its aggregate."""

    def __init__(self, T, rng, payload):
        self.agg, self.inc = [None] * T, [None] * T
        self.rng, self.payload = rng, payload

    def lookback(self, t):
        excl = NO_PAYLOAD if self.payload else 0
        for end in range(t - 1, -WINDOW, -WINDOW):
            lanes = []
            for j in range(end, end - WINDOW, -1):
                if j < 0:
                    lanes.append((True, NO_PAYLOAD if self.payload else 0))
                elif self.inc[j] is not None and (j == 0 or self.rng.rand()
                                                  < 0.5):
                    lanes.append((True, self.inc[j]))
                else:
                    assert self.agg[j] is not None   # published before
                    lanes.append((False, self.agg[j]))
            inc = [k for k, (is_inc, _) in enumerate(lanes) if is_inc]
            stop = inc[0] if inc else WINDOW - 1
            taken = [v for _, v in lanes[:stop + 1]]
            if self.payload:
                # the nearest tile with a last slot, else the farthest one
                has = [k for k, v in enumerate(taken) if v[2] >= 0]
                src = taken[has[0] if has else stop]
                win = (sum(v[0] for v in taken), sum(v[1] for v in taken),
                       src[2], src[3])
                excl = combine(win, excl)
            else:
                excl += sum(taken)
            if inc:
                return excl
        raise AssertionError("the look-back passed tile 0")

    def scan(self, t, agg):
        """Tile t's aggregate published (tile 0's as its inclusive
        prefix), its exclusive prefix looked back for, its inclusive
        published: the exclusive prefix."""
        self.agg[t] = agg
        if t == 0:
            self.inc[0] = agg
            return NO_PAYLOAD if self.payload else 0
        e = self.lookback(t)
        self.inc[t] = combine(e, agg) if self.payload else e + agg
        return e


# ---- a tile's hit pairs -----------------------------------------------------

def tile_pairs(tb, incl, hit, single, base, pref, rid, n_ok, first, lp, le,
               stats):
    """The tile's pairs q < n_ok, log records first + q: each owner by
    the kernels' binary search over the tile's inclusive prefix of hits;
    returns its newborn candidates in pair order, (rid, lo, hi, pref)."""
    B = tb.B
    cand = []
    for q in range(n_ok):
        h, b = divmod(q, B)
        s, half = 0, THREADS // 2
        while half > 0:                           # incl[s] > h
            if incl[s + half - 1] <= h:
                s += half
            half //= 2
        own = h - (incl[s - 1] if s > 0 else 0)
        loc = (hit[s] if single[s] else
               tb.mrl[min(max(hit[s] + own, 0), tb.mrl.shape[0] - 1)])
        li = min(max(loc, 0), tb.L - 1)
        lp[first + q], le[first + q] = pref[s], li * B + b
        if loc < 0 or tb.out_lo[li, b] < 0:
            continue
        rl, rh = tb.row(tb.out_lo[li, b]), tb.row(tb.out_hi[li, b] + 1)
        jb = base[s]
        f = tb.sym_start[min(max(jb, 0), 4)]
        ch = lambda v: v[jb - 1] if 1 <= jb <= 4 else 0
        lo, hi = f + ch(rl), f + ch(rh) - 1
        if lo <= hi:
            cand.append((rid[s], lo, hi, first + q))
    stats["max_tile_pairs"] = max(stats.get("max_tile_pairs", 0), n_ok)
    return cand


def _tile_hits(cnt):
    """The tile's inclusive prefix of hits, and its last slot with hits."""
    nz = np.flatnonzero(cnt > 0)
    return np.cumsum(cnt), (nz[-1] if nz.size else -1)


# ---- K2 ------------------------------------------------------------------

def mirror_wide(tb, carry, reads, phases, log_base, lp, le, rng, stats):
    """K2's launch over ``phases``, tile by tile: returns the final carry
    (4 arrays) and the (R + 1,) flags."""
    *c_in, ovf_in = carry
    Rr = reads.shape[1]
    B = tb.B
    ovf = np.concatenate([ovf_in, [False]])
    # the carry a step reads: survivors, staged newborns, empty slots
    live = np.flatnonzero(c_in[0] >= 0)
    v = dict(src=np.stack(c_in).astype(np.int64), nk=len(c_in[0]),
             stage=np.zeros((0, 4), np.int64), nc=0, lim=len(c_in[0]),
             front=int(live[-1]) + 1 if live.size else 0)

    def vread(i):
        if i >= v["lim"]:
            return (-1, 0, 0, 0)
        if i < v["nk"]:
            return tuple(v["src"][:, i])
        if i - v["nk"] < v["nc"]:
            return tuple(v["stage"][i - v["nk"]])
        return (-1, 0, 0, 0)

    n_cur, step, prev = len(c_in[0]), 0, None

    def last_step_flags():
        n_prev, gb = prev
        room = max(n_prev - v["nk"], 0)
        for c in range(room, v["nc"]):
            ovf[v["stage"][c][0]] = True
        if v["nc"] > room:
            stats["overfilled"] = True
        if gb > max(v["nc"] - room, 0):
            ovf[Rr] = True

    for n_steps, N, G in phases:
        for i in range(N, n_cur):                 # the resize's cut slots
            r = vread(i)[0]
            ovf[Rr if r < 0 else r] = True
        v["lim"], n_cur = min(v["lim"], N), N
        for _ in range(n_steps):
            if step:
                last_step_flags()
            row = reads[step]
            # only the tiles below the live front run; the slots past it,
            # with no read, send their flags to the dump slot
            T = max(1, -(-min(v["lim"], N, v["front"]) // THREADS))
            if T * THREADS < N:
                ovf[Rr] = True
                stats["skipped_tiles"] = True
            nxt = np.zeros((4, N), np.int64)
            written = np.zeros(N, bool)            # every survivor slot
            stage = np.zeros((G * B, 4), np.int64)
            pchain, cchain = Chain(T, rng, True), Chain(T, rng, False)
            total = 0
            for t in range(T):
                sl = range(t * THREADS, min((t + 1) * THREADS, N))
                rows = [vread(i) for i in sl] + [(-1, 0, 0, 0)] * (
                    THREADS - len(sl))
                rid, lo, hi, pref = (np.array(a, np.int64) for a in zip(*rows))
                valid = rid >= 0
                rc = np.clip(rid, 0, Rr - 1)
                base = np.where(valid, row[rc], 0)
                active = valid & (base > 0)
                cnt = np.zeros(THREADS, np.int64)
                klo, khi, mlo = lo.copy(), hi.copy(), np.zeros(THREADS, np.int64)
                alive = np.zeros(THREADS, bool)
                for k in np.flatnonzero(active):
                    nlo, nhi, ml, mh = tb.lf(lo[k], hi[k], base[k])
                    klo[k], khi[k], mlo[k], cnt[k] = nlo, nhi, ml, mh - ml
                    alive[k] = nlo <= nhi
                keep = (active & alive) | (valid & ~active)
                incl, last = _tile_hits(cnt)
                agg = (int(keep.sum()), int(cnt.sum()),
                       t * THREADS + last if last >= 0 else -1,
                       pref[last] if last >= 0 else (pref[0] if t == 0 else 0))
                e = pchain.scan(t, agg)
                kr = e[0] + np.cumsum(keep) - keep
                for k in np.flatnonzero(keep):        # survivors at their rank
                    nxt[:, kr[k]] = (rid[k], klo[k], khi[k], pref[k])
                    written[kr[k]] = True
                excl = incl - cnt
                spilled = active & (e[1] + excl + cnt > G) & (cnt > 0)
                ovf[rc[spilled]] = True
                if (~spilled[:len(sl)]).any():
                    ovf[Rr] = True
                n_ok = max(min(int(cnt.sum()), G - e[1]), 0) * B
                first = log_base + e[1] * B
                cand = tile_pairs(tb, incl, mlo, np.zeros(THREADS, bool),
                                  base, pref, rc, n_ok, first, lp, le, stats)
                ce = cchain.scan(t, len(cand))
                for j, nb in enumerate(cand):          # staged at their rank
                    stage[ce + j] = nb
                if t == T - 1:
                    inc = pchain.inc[t]
                    total = inc[1]
                    for k in range(min(total, G) * B, G * B):
                        lp[log_base + k], le[log_base + k] = inc[3], k % B
            stats["tiles"] = max(stats.get("tiles", 0), T)
            stats["totals"] = stats.get("totals", set()) | {
                "none" if total == 0 else "over G" if total > G else "some"}
            n_keep, n_cand = pchain.inc[T - 1][0], cchain.inc[T - 1]
            assert written[:n_keep].all() and not written[n_keep:].any()
            v.update(src=nxt, nk=n_keep, stage=stage, nc=n_cand, lim=N,
                     front=min(N, n_keep + n_cand))
            prev = (N, G * B)
            log_base += G * B
            step += 1
    if step:
        last_step_flags()
    out = np.array([vread(i) for i in range(n_cur)], np.int64).T.reshape(
        4, n_cur)
    return out, ovf


# ---- K3's hole-allocated range ---------------------------------------------

def mirror_narrow(tb, carry, reads, narrow, log_base, lp, le, rng, stats):
    """K3's hole-allocated range (the resize folded into the first step),
    tile by tile: returns the carry (4 arrays) and the (R + 1,) flags."""
    n_steps, N, G, W = narrow
    *c_in, ovf_in = carry
    Rr = reads.shape[1]
    B, HB = tb.B, G * tb.B
    ovf = np.concatenate([ovf_in, [False]])
    buf = np.stack(c_in).astype(np.int64)
    for i in range(N, buf.shape[1]):              # the resize's cut slots
        ovf[Rr if buf[0, i] < 0 else buf[0, i]] = True
    lim = min(buf.shape[1], N)
    hrank = np.full(N, -7, np.int64)
    n_place, room, n_cand, stage_in = 0, 0, 0, None

    def last_step_flags():
        for c in range(room, n_cand):
            ovf[stage_in[c][0]] = True
        if HB > max(n_cand - room, 0):
            ovf[Rr] = True

    for step in range(n_steps):
        if step:
            last_step_flags()
        row = reads[step]
        T = -(-N // THREADS)
        nxt = np.zeros((4, N), np.int64)
        stage = np.zeros((HB, 4), np.int64)
        wchain, pchain = Chain(T, rng, False), Chain(T, rng, True)
        cchain = Chain(T, rng, False)
        for t in range(T):
            sl = np.arange(t * THREADS, min((t + 1) * THREADS, N))
            rows = []
            for i in sl:                   # the own row, or the newborn
                r = tuple(buf[:, i]) if i < lim else (-1, 0, 0, 0)
                if n_place and hrank[i] < n_place:
                    r = tuple(stage_in[hrank[i]])
                rows.append(r)
            rows += [(-1, 0, 0, 0)] * (THREADS - len(sl))
            rid, lo, hi, pref = (np.array(a, np.int64) for a in zip(*rows))
            inn = np.arange(THREADS) < len(sl)
            valid = rid >= 0
            rc = np.clip(rid, 0, Rr - 1)
            single = lo == hi
            base = np.where(valid, row[rc], 0)
            tw = np.where(valid & single,
                          tb.narrow_tab[np.clip(lo, 0, tb.n - 1)], 0)
            active = valid & (base > 0)
            wide = active & ~single
            we = wchain.scan(t, int(wide.sum()))
            w_rank = we + np.cumsum(wide) - wide
            cov = wide & (w_rank < W)
            if cov.any() and (wide & ~cov).any():
                stats["w_mid_tile"] = True
            spill_w = wide & ~cov
            sym, val = tw >> 24, tw & 0xFFFFFF
            keep = np.zeros(THREADS, bool)
            klo, khi = lo.copy(), hi.copy()
            cnt = np.zeros(THREADS, np.int64)
            hitf = np.where(single, val, 0)
            for k in range(THREADS):
                ac = active[k] and (single[k] or cov[k])
                if ac and single[k]:
                    ok, klo[k], khi[k], cnt[k] = (sym[k] == base[k], val[k],
                                                  val[k], sym[k] == 5)
                elif ac:
                    nlo, nhi, ml, mh = tb.lf(lo[k], hi[k], base[k])
                    ok, klo[k], khi[k], cnt[k] = nlo <= nhi, nlo, nhi, mh - ml
                    hitf[k] = ml
                keep[k] = (ac and ok) or (valid[k] and not active[k])
            hole = inn & ~keep
            incl, last = _tile_hits(cnt)
            agg = (int(hole.sum()), int(cnt.sum()),
                   t * THREADS + last if last >= 0 else -1,
                   pref[last] if last >= 0 else (pref[0] if t == 0 else 0))
            e = pchain.scan(t, agg)
            hr = e[0] + np.cumsum(hole) - hole
            for k, i in enumerate(sl):                # every slot's own row
                nxt[:, i] = (rid[k] if keep[k] else -1, klo[k], khi[k],
                             pref[k])
                hrank[i] = hr[k] if hole[k] else NO_HOLE
            excl = incl - cnt
            spilled = active & (e[1] + excl + cnt > G) & (cnt > 0)
            flagged = spilled | spill_w
            ovf[rc[flagged]] = True
            if (inn & ~flagged).any():
                ovf[Rr] = True
            n_ok = max(min(int(cnt.sum()), G - e[1]), 0) * B
            first = log_base + e[1] * B
            cand = tile_pairs(tb, incl, hitf, single, base, pref, rc, n_ok,
                              first, lp, le, stats)
            ce = cchain.scan(t, len(cand))
            for j, nb in enumerate(cand):
                stage[ce + j] = nb
            if t == T - 1:
                inc = pchain.inc[t]
                for k in range(min(inc[1], G) * B, HB):
                    lp[log_base + k], le[log_base + k] = inc[3], k % B
        n_holes, n_cand = pchain.inc[T - 1][0], cchain.inc[T - 1]
        if n_cand > n_holes:
            stats["cand_over_holes"] = True
        assert n_cand <= HB              # G hits' pairs at most
        if n_holes > HB:
            stats["holes_over_hb"] = True
        stats["tiles"] = max(stats.get("tiles", 0), T)
        room = min(n_holes, HB)
        n_place = min(n_cand, room)
        stage_in, buf, lim = stage, nxt, N
        log_base += HB
    if n_steps:
        last_step_flags()
    for i in range(N):                    # the last newborns into holes
        if n_place and hrank[i] < n_place:
            buf[:, i] = stage_in[hrank[i]]
    return buf, ovf


# ---- the tests -------------------------------------------------------------

def _assert_equal_run(m_carry, m_ovf, t_carry, lp_m, le_m, lp, le, j_carry,
                      j_logs, n_records):
    for m, t, j in zip(m_carry, t_carry[:4], j_carry[:4]):
        np.testing.assert_array_equal(m, t.numpy())
        np.testing.assert_array_equal(m, np.asarray(j))
    np.testing.assert_array_equal(m_ovf, t_carry[4].numpy())
    np.testing.assert_array_equal(m_ovf[:R], np.asarray(j_carry[4]))
    end = LOG_BASE + n_records
    np.testing.assert_array_equal(lp_m[:end], lp.numpy()[:end])
    np.testing.assert_array_equal(le_m[:end], le.numpy()[:end])
    j_par = np.concatenate([np.asarray(p).reshape(-1) for p, _ in j_logs])
    j_ev = np.concatenate([np.asarray(e).reshape(-1) for _, e in j_logs])
    np.testing.assert_array_equal(lp_m[LOG_BASE:end], j_par)
    np.testing.assert_array_equal(le_m[LOG_BASE:end], j_ev)


@pytest.mark.parametrize("budget", ["roomy", "tight"])
@pytest.mark.parametrize("kind", ["sites", "nested"])
def test_wide_mirror_matches_jax_and_twin(kind, budget):
    """K2's pass structure (tile ranks by look-back, survivors at their
    keep rank, each tile's pairs and staged candidates, the next step's
    reads of survivors then newborns, the resize folded into the reads)
    gives JAX's and the twin's carry, flags and log."""
    n_in, phases, zeros = WIDE[budget]
    S = sum(p[0] for p in phases)
    jdi, tdi, _, carry, reads, _ = _case(kind, "dense", 31 + len(budget),
                                         n_in, S, budget, zeros)
    B = jdi.n_outcomes
    n_records = sum(s * g for s, _, g in phases) * B
    j_carry, j_logs = _jax_wide(jdi, None, carry, reads, phases)
    lp, le = _log(n_records)
    t_carry = wide_step.wide_steps(tdi, torch.from_numpy(reads),
                                   _to_torch(carry), phases, LOG_BASE, lp, le)
    tb = Tables(jdi)
    for draw in (1, 2):             # the look-back's view does not matter
        lp_m = np.full(lp.shape[0], -7, np.int64)
        le_m = lp_m.copy()
        stats = {}
        m_carry, m_ovf = mirror_wide(tb, carry, reads, phases, LOG_BASE,
                                     lp_m, le_m, np.random.RandomState(draw),
                                     stats)
        _assert_equal_run(m_carry, m_ovf, t_carry, lp_m, le_m, lp, le,
                          j_carry, j_logs, n_records)
    assert stats["tiles"] >= 3 * WINDOW              # multi-window look-backs
    assert "none" in stats["totals"]                 # the all-zero step
    assert stats.get("skipped_tiles")                # tiles past the front
    if budget == "roomy":                            # pairs past the threads
        assert stats["max_tile_pairs"] > THREADS
    else:
        assert "over G" in stats["totals"] and stats.get("overfilled")


# incoming states, the range (steps, pool, hits, wide budget), each
# step's share of padding bases, the carry's shape (test_torch_scan_kernels
# SHAPES): "tight" binds W inside a tile and has more holes than G·B
# (the room for newborns is G·B); "holes" more candidates than holes
NARROW_MIRROR = {"roomy": (100, (3, 128, 256, 128), (0.0,), "roomy"),
                 "tight": (140, (3, 112, 4, 5), (0.0,), "tight"),
                 "holes": (140, (3, 112, 256, 60), (0.0,), "tight")}


@pytest.mark.parametrize("budget", sorted(NARROW_MIRROR))
@pytest.mark.parametrize("kind", ["sites", "nested"])
def test_narrow_mirror_matches_jax_and_twin(kind, budget):
    """K3's hole-allocated pass structure (the wide rank by look-back
    before the LF is kept, each slot's own row, the hole rank, each tile's
    pairs and staged candidates, a newborn read over its hole's own row,
    the resize folded into the first step) gives JAX's and the twin's
    carry, flags and log."""
    n_in, narrow, zeros, shape = NARROW_MIRROR[budget]
    jdi, tdi, _, carry, reads, _ = _case(kind, "dense", 7 + len(budget),
                                         n_in, narrow[0], shape, zeros)
    B = jdi.n_outcomes
    n_records = narrow[0] * narrow[2] * B
    j_carry, j_logs = _jax_narrow(jdi, None, carry, reads, narrow, 0, 1, 1,
                                  False)
    lp, le = _log(n_records)
    t_carry = locked_step.locked_tail(tdi, torch.from_numpy(reads),
                                      _to_torch(carry), LOG_BASE, lp, le, 1,
                                      1, lock=False, narrow=narrow)
    tb = Tables(jdi)
    for draw in (1, 2):
        lp_m = np.full(lp.shape[0], -7, np.int64)
        le_m = lp_m.copy()
        stats = {}
        m_carry, m_ovf = mirror_narrow(tb, carry, reads, narrow, LOG_BASE,
                                       lp_m, le_m,
                                       np.random.RandomState(draw), stats)
        _assert_equal_run(m_carry, m_ovf, t_carry, lp_m, le_m, lp, le,
                          j_carry, j_logs, n_records)
    assert stats["tiles"] >= 3 * WINDOW
    if budget == "tight":
        assert stats.get("w_mid_tile") and stats.get("holes_over_hb")
    if budget == "holes" and kind == "sites":
        assert stats.get("cand_over_holes")


def _owners(cnt, G):
    """Each hit slot g < min(total, G)'s owner, by start_of."""
    start = np.cumsum(cnt) - cnt
    return np.concatenate([np.full(min(c, max(G - s, 0)), k) for k, (s, c)
                           in enumerate(zip(start, cnt)) if c > 0] or
                          [np.zeros(0, int)])


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("kind", ["sites", "nested"])
def test_jax_newborns_in_owner_order_never_empty_hit_slots(kind, narrow):
    """On JAX's steps: a step's newborns, in slot order (the wide step's
    repack) or in hole-rank order (the hole-allocated step), come from
    hit slots g < min(total, G) in increasing (g, outcome) order, so
    their owners' slots are nondecreasing; the hit slots past min(total,
    G) make none. Each step's hits come from numpy (the mirror's LF)."""
    budget = "roomy"
    if narrow:
        n_in, cfg, zeros, _ = NARROW_MIRROR["holes"]
        steps = [cfg]
        budget = "tight"
    else:
        n_in, phases, zeros = WIDE[budget]
        steps = [(s, N, G, None) for s, N, G in phases]
    S = sum(s[0] for s in steps)
    jdi, _, _, carry, reads, _ = _case(kind, "dense", 3, n_in, S, budget,
                                       zeros)
    tb = Tables(jdi)
    B = jdi.n_outcomes
    c = _to_jax(carry)
    k, base, seen = 0, LOG_BASE, set()
    for n_steps, N, G, W in steps:
        c = jsl._resize_pool(c, N, R)
        step = (jsl._build_log_step(jdi, jsl.LogConfig(pool=N, hits=G), R)
                if W is None else
                jsl._build_narrow_step(jdi, jsl.LogConfig(pool=N, hits=G), R,
                                       W))
        for _ in range(n_steps):
            rid, lo, hi, pref = (np.asarray(a).astype(np.int64)
                                 for a in c[:4])
            row = reads[k]
            cnt = np.zeros(N, np.int64)
            w_seen = 0
            for i in range(N):
                if rid[i] < 0 or row[rid[i]] == 0:
                    continue
                if W is not None and lo[i] == hi[i]:
                    cnt[i] = (tb.narrow_tab[lo[i]] >> 24) == 5
                    continue
                if W is not None:
                    w_seen += 1
                    if w_seen > W:
                        continue
                _, _, ml, mh = tb.lf(lo[i], hi[i], row[rid[i]])
                cnt[i] = mh - ml
            total = int(cnt.sum())
            owners = _owners(cnt, G)
            c, _ = step(c, (jnp.asarray(row), jnp.int32(base)))
            nrid, npref = (np.asarray(a).astype(np.int64)
                           for a in (c[0], c[3]))
            born = np.flatnonzero((nrid >= 0) & (npref >= base))
            kk = npref[born] - base               # k = g·B + b, slot order
            g = kk // B
            assert (g < min(total, G)).all()      # never an empty hit slot
            assert (np.diff(kk) > 0).all()        # (g, b) order = slot order
            assert (np.diff(owners[g]) >= 0).all()
            if born.size:
                seen.add("newborns")
            if total < G:
                seen.add("empty hit slots")
            base += G * B
            k += 1
    assert seen == {"newborns", "empty hit slots"}
