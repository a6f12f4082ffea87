"""The design of K10's round-split kernels (csrc/sharded_step.cu), on
the CPU.

``_Mirror`` is a torch mirror of the two kernels, launch by launch over
the step table that ``ops/sharded.step_table`` builds: the open launch
(the last step's newborns from its round-2 answers, the next carry
materialised with _resize_pool or _lock_pool, the next step's round-1
gather with its wide rank) and the mid launch (a step from its round-1
answers to its round-2 gather), with the kernels' buffers (two carry
buffers, the answers, the pairs' heads, the stage, the hole and wide
ranks, the newborn counts, the totals) and every card's masked gathers
of its own shards, summed over the cards between launches as the
all-reduce sums them. A chained scan is a cumulative sum here (the
kernels' scans equal it). On a wide plan and on the auto plan (hole-
allocated and slot-locked narrow steps), with the index in 4 shards on
one card, a shard on each of 2 cards, and 2, 1 and 1 shards on 3
cards, every card's final carry, flags (the dump slot included) and
log must equal the torch steps' on the replicated index
(``scan_steps.run_phases``). Two deliberate mutations must not: one
card's round-2 answers left out of a sum, and the hole-allocated
newborns not pulled into their holes.
"""
import numpy as np
import pytest
import torch

from gramtools_tpu.mapping.search_jax_log import LogConfig as JaxLogConfig
from gramtools_tpu_torch.mapping.scan_steps import run_phases
from gramtools_tpu_torch.mapping.search_log_host import (LogConfig, _phase4,
                                                         auto_phases)
from gramtools_tpu_torch.ops.sharded import build_tables, step_table

from test_sharded_index import PHASES, seeded_batch
from test_torch_sharded_index import _torch, setup  # noqa: F401

I32 = torch.int32
WIDE, NARROW, LOCKED = 0, 1, 2
NO_HOLE = 0x7FFFFFFF


def _r4(v):
    return -(-v // 4) * 4


def _excl(flags):
    """Exclusive cumulative sum (a chained scan's ranks)."""
    v = flags.to(torch.int64)
    return (torch.cumsum(v, 0) - v).to(I32)


class _Card:
    """One card's buffers and shards (``held``: its shard indices)."""

    def __init__(self, tables, held, C, K, a1, R, L):
        self.t, self.held = tables, held
        self.buf = torch.zeros((2, 4, C), dtype=I32)
        self.ovf = torch.zeros(R + 1, dtype=torch.bool)
        self.ans1 = torch.zeros(a1, dtype=I32)
        self.ans2 = torch.zeros((K, 2), dtype=I32)
        self.meta = torch.zeros((K, 2), dtype=I32)
        self.stage = torch.zeros((K, 4), dtype=I32)
        self.nbv = torch.zeros((C, 4), dtype=I32)
        self.wrank = torch.zeros(C, dtype=I32)
        self.hrank = torch.zeros(C, dtype=I32)
        self.nb = torch.zeros(C, dtype=I32)
        self.totals = [0, 0]
        self.lp = torch.zeros(L, dtype=I32)
        self.le = torch.zeros(L, dtype=I32)

    def occ(self, r):
        """Masked occ rows: the owner's row where this card holds it."""
        t = self.t
        r = r.clamp(0, t.size)
        s = torch.div(r, t.rows_per_shard, rounding_mode="floor")
        out = torch.zeros((r.shape[0], 4), dtype=I32)
        for i in self.held:
            mine = s == i
            out[mine] = t.occ[i][(r - i * t.rows_per_shard)[mine]]
        return out

    def narrow(self, r):
        t = self.t
        r = r.clamp(0, t.size - 1)
        s = torch.div(r, t.nt_rows_per_shard, rounding_mode="floor")
        out = torch.zeros(r.shape[0], dtype=I32)
        for i in self.held:
            mine = s == i
            out[mine] = t.narrow[i][(r - i * t.nt_rows_per_shard)[mine]]
        return out


def _chan(rows, base):
    """Channel base (1-4) of each row; 0 for any other base."""
    b = base.to(torch.int64)
    ok = (b >= 1) & (b <= 4)
    return torch.where(ok, rows.gather(1, (b.clamp(1, 4) - 1)[:, None])[:, 0],
                       0)


class _Mirror:
    """The kernels' launches over a step table, on simulated cards."""

    def __init__(self, di, reads, carry, plan, R, tables, groups,
                 mutation=None):
        self.di, self.reads, self.R = di, reads, R
        self.carry_in = carry
        self.B = di.n_outcomes
        self.mutation = mutation
        self.rows, C, K, self.a1 = step_table(plan, R, carry[0].shape[0],
                                              self.B, tables.has_narrow)
        L = self.rows[-1][4] + self.rows[-1][2] * self.B
        self.cards = [_Card(tables, g, C, K, self.a1, R, L) for g in groups]
        self.first = di.sym_start[:5]
        self.sent = int(di.sentinel_row.reshape(-1)[0])

    def step(self, s):
        return None if s < 0 or s >= len(self.rows) else self.rows[s]

    def run(self):
        n = len(self.rows)
        for i in range(2 * n + 1):
            for c in self.cards:
                (self.mid if i % 2 else self.open)(c, i)
            if len(self.cards) > 1 and i < 2 * n:
                self.all_reduce(i)
        last = self.rows[-1]
        return [(tuple(c.buf[last[6] ^ 1, f, :last[1]].clone()
                       for f in range(4)) + (c.ovf,), (c.lp, c.le))
                for c in self.cards]

    def all_reduce(self, i):
        k, N, G, W = self.rows[i // 2][:4]
        if i % 2 == 0:
            n1 = 4 * N if k == WIDE else _r4(N) + 4 * W
            total = sum(c.ans1[:n1] for c in self.cards)
            for c in self.cards:
                c.ans1[:n1] = total
        else:
            cards = self.cards
            if self.mutation == "sum" and i == 1:
                cards = cards[:-1]            # one card's answers left out
            total = sum(c.ans2[:G * self.B] for c in cards)
            for c in self.cards:
                c.ans2[:G * self.B] = total

    def lf(self, a, lo, hi, base):
        first = self.first[base.clamp(0, 4).long()]
        hi1 = hi + 1
        return (first + a[:, 0], first + a[:, 2] - 1,
                lo - a[:, 1] - (lo > self.sent).to(I32),
                hi1 - a[:, 3] - (hi1 > self.sent).to(I32))

    def masked_lf(self, c, lo, hi, base):
        a, b = c.occ(lo), c.occ(hi + 1)
        return torch.stack([_chan(a, base), a.sum(1, dtype=I32),
                            _chan(b, base), b.sum(1, dtype=I32)], 1)

    # ---- the mid launch --------------------------------------------------
    def mid(self, c, i):
        k, N, G, W, log_base, rs, cur, _ = self.rows[(i - 1) // 2]
        R, B, di = self.R, self.B, self.di
        rid, lo, hi, pref = c.buf[cur, :, :N].clone()
        valid = rid >= 0
        ar = torch.arange(N, dtype=I32)
        rc = ar.clamp(max=R - 1) if k == LOCKED else rid.clamp(0, R - 1)
        base = torch.where(valid, self.reads[rs, rc.long()], 0)
        active = valid & (base > 0)
        single = torch.zeros(N, dtype=torch.bool)
        spill_w = torch.zeros(N, dtype=torch.bool)
        if k == WIDE:
            nlo, nhi, mlo, mhi = self.lf(c.ans1[:4 * N].view(N, 4), lo, hi,
                                         base)
            keep = (active & (nlo <= nhi)) | (valid & ~active)
            klo, khi = torch.where(active, nlo, lo), torch.where(active, nhi,
                                                                 hi)
            cnt = torch.where(active, mhi - mlo, 0)
            hit = torch.where(active, mlo, 0)
        else:
            single = lo == hi
            wide = active & ~single
            t = torch.where(valid & single, c.ans1[:N], 0)
            wr = torch.where(wide, c.wrank[:N], 0)
            cov = wide & (wr < W)
            spill_w = wide & ~cov
            wa = c.ans1[_r4(N):_r4(N) + 4 * W].view(W, 4)[
                wr.clamp(0, max(W - 1, 0)).long()] if W else torch.zeros(
                    (N, 4), dtype=I32)
            nlo, nhi, mlo, mhi = (torch.where(cov, v, 0)
                                  for v in self.lf(wa, lo, hi, base))
            sym, val = t >> 24, t & 0xFFFFFF
            ok = torch.where(single, sym == base, nlo <= nhi)
            ac = active & (single | cov)
            keep = (ac & ok) | (valid & ~active)
            klo = torch.where(ac, torch.where(single, val, nlo), lo)
            khi = torch.where(ac, torch.where(single, val, nhi), hi)
            cnt = torch.where(ac, torch.where(single, (sym == 5).to(I32),
                                              mhi - mlo), 0)
            hit = torch.where(single, val, mlo)
        hole = ~keep
        own = keep if k == WIDE else hole
        own_rank = _excl(own)
        excl = _excl(cnt)
        nxt = c.buf[cur ^ 1]
        if k == WIDE:
            dest = own_rank[keep].long()
            for f, v in enumerate((rid, klo, khi, pref)):
                nxt[f, dest] = v[keep]
        else:
            for f, v in enumerate((torch.where(keep, rid, -1), klo, khi,
                                   pref)):
                nxt[f, :N] = v
            if k == NARROW:
                c.hrank[:N] = torch.where(hole, own_rank, NO_HOLE)
            else:
                c.nb[:N] = 0
        spilled = active & (excl + cnt > G) & (cnt > 0)
        flagged = spilled | spill_w
        c.ovf[rc[flagged].long()] = True
        if k == WIDE or (k == NARROW and (~flagged).any()):
            c.ovf[R] = True
        # the pairs within the budget, then the empty records
        total = int(cnt.sum())
        n_hits = min(total, G)
        for g in range(n_hits):
            s = int(torch.nonzero((excl <= g) & (g < excl + cnt))[0, 0])
            hf, own_h = int(hit[s]), g - int(excl[s])
            if single[s]:
                loc = hf
            else:
                mrl = di.marker_rank_locus
                loc = int(mrl[min(max(hf + own_h, 0), mrl.shape[0] - 1)])
            li = min(max(loc, 0), di.out_lo.shape[0] - 1)
            for b in range(B):
                kk = g * B + b
                c.lp[log_base + kk] = pref[s]
                c.le[log_base + kk] = li * B + b
                j_lo = int(di.out_lo[li, b]) if loc >= 0 else -1
                j_hi1 = int(di.out_hi[li, b]) + 1 if loc >= 0 else 0
                jb = base[s:s + 1]
                c.meta[kk] = torch.tensor([int(rc[s]) if j_lo >= 0 else -1,
                                           int(base[s])])
                c.ans2[kk] = (torch.cat([
                    _chan(c.occ(torch.tensor([j_lo], dtype=I32)), jb),
                    _chan(c.occ(torch.tensor([j_hi1], dtype=I32)), jb)])
                    if j_lo >= 0 else 0)
        with_hits = torch.nonzero(cnt > 0)
        last_pref = int(pref[with_hits[-1, 0]]) if len(with_hits) else \
            int(pref[0])
        for kk in range(n_hits * B, G * B):
            c.lp[log_base + kk] = last_pref
            c.le[log_base + kk] = kk % B
            c.meta[kk] = torch.tensor([-1, 0])
            c.ans2[kk] = 0
        c.totals[0] = int(own.sum())

    # ---- the open launch -------------------------------------------------
    def open(self, c, i):
        prev, nx = self.step(i // 2 - 1), self.step(i // 2)
        R, B = self.R, self.B
        if i == 0:
            c.ovf[:] = self.carry_in[4]
        n_src = self.carry_in[0].shape[0]
        if prev is not None:
            self.finish(c, prev)
            n_src = prev[1]
        m = prev[6] ^ 1 if prev is not None else nx[6] ^ nx[7]
        n_to = nx[1] if nx is not None and not nx[7] else n_src
        v = self.carry_after(c, prev, n_src)
        dst = c.buf[m]
        n_keep = min(n_src, n_to)
        dst[:, :n_keep] = v[:, :n_keep]
        dst[:, n_keep:n_to] = torch.tensor([-1, 0, 0, 0], dtype=I32)[:, None]
        cut = v[0, n_to:n_src]
        if (cut < 0).any():
            c.ovf[R] = True
        c.ovf[cut[(cut >= 0) & (cut <= R)].long()] = True
        if nx is None:
            return
        if nx[7]:
            self.lock(c, dst, n_src, c.buf[nx[6]])
        self.gather1(c, nx)

    def finish(self, c, s):
        k, N, G = s[:3]
        K = G * self.B
        meta, a = c.meta[:K], c.ans2[:K]
        f = self.first[meta[:, 1].clamp(0, 4).long()]
        lo, hi = f + a[:, 0], f + a[:, 1] - 1
        ok = (meta[:, 0] >= 0) & (lo <= hi)
        born = torch.stack([meta[:, 0], lo, hi,
                            s[4] + torch.arange(K, dtype=I32)], 1)
        if k == LOCKED:
            for kk in torch.nonzero(ok)[:, 0].tolist():
                o = int(born[kk, 0])
                if c.nb[o] == 0:
                    c.nbv[o] = torch.cat([born[kk, 1:], torch.zeros(1, dtype=I32)])
                c.nb[o] += 1
            return
        n_own = c.totals[0]
        room = max(N - n_own, 0) if k == WIDE else min(n_own, K)
        rank = _excl(ok)
        placed = ok & (rank < room)
        c.ovf[born[ok & ~placed, 0].long()] = True
        if k == WIDE:
            nxt = c.buf[s[6] ^ 1]
            nxt[:, (n_own + rank[placed]).long()] = born[placed].T
        else:
            c.stage[rank[placed].long()] = born[placed]
            n_cand = int(ok.sum())
            if K > max(n_cand - min(n_own, K), 0):
                c.ovf[self.R] = True
        c.totals[1] = int(ok.sum())

    def carry_after(self, c, s, n_src):
        if s is None:
            return torch.stack([a.clone() for a in self.carry_in[:4]])
        k, N, G = s[:3]
        v = c.buf[s[6] ^ 1, :, :N].clone()
        n_own, n_cand = c.totals
        if k == WIDE:
            front = min(N, n_own + n_cand)
            v[:, front:] = torch.tensor([-1, 0, 0, 0], dtype=I32)[:, None]
        elif k == NARROW:
            if self.mutation != "holes":
                n_place = min(n_cand, n_own, G * self.B)
                h = c.hrank[:N]
                pull = h < n_place
                v[:, pull] = c.stage[h[pull].long()].T
        else:
            cnt = c.nb[:N]
            keep = v[0] >= 0
            conflict = (cnt > 1) | ((cnt == 1) & keep)
            born = (cnt == 1) & ~keep
            ar = torch.arange(N, dtype=I32)
            v[0, born] = ar[born]
            v[1:, born] = c.nbv[:N][born, :3].T
            v[0, conflict] = -1
            c.ovf[:N] |= conflict
        return v

    def lock(self, c, src, n_src, dst):
        R = self.R
        rid = src[0, :n_src]
        cnt = torch.zeros(R, dtype=I32)
        live = rid >= 0
        cnt.index_add_(0, rid[live].clamp(0, R - 1).long(),
                       torch.ones(int(live.sum()), dtype=I32))
        c.ovf[:R] |= cnt > 1
        dst[:, :R] = torch.tensor([-1, 0, 0, 0], dtype=I32)[:, None]
        rc = rid.clamp(0, R - 1).long()
        place = live & (cnt[rc] == 1)
        dst[0, rc[place]] = rc[place].to(I32)
        for f in (1, 2, 3):
            dst[f, rc[place]] = src[f, :n_src][place]

    def gather1(self, c, s):
        k, N, G, W, _, rs, cur, _ = s
        R = self.R
        rid, lo, hi, _ = c.buf[cur, :, :N]
        valid = rid >= 0
        rc = (torch.arange(N, dtype=I32).clamp(max=R - 1) if k == LOCKED
              else rid.clamp(0, R - 1))
        base = torch.where(valid, self.reads[rs, rc.long()], 0)
        active = valid & (base > 0)
        if k == WIDE:
            a = self.masked_lf(c, lo, hi, base)
            c.ans1[:4 * N] = torch.where(active[:, None], a, 0).reshape(-1)
            return
        single = lo == hi
        wide = active & ~single
        c.ans1[:N] = torch.where(valid & single, c.narrow(lo), 0)
        wr = _excl(wide)
        c.wrank[:N] = torch.where(wide, wr, -1)
        sel = wide & (wr < W)
        wa = c.ans1[_r4(N):_r4(N) + 4 * W].view(W, 4)
        wa[wr[sel].long()] = self.masked_lf(c, lo, hi, base)[sel]


def _plan(reads, R, plan):
    return [_phase4(e) for e in (plan or auto_phases(
        reads.shape[0], R, LogConfig(pool=64, hits=16), narrow=True))]


def _case(setup, seed, groups, plan, mutation=None):
    idx, _, tdi = setup
    R = 6
    reads_T, carry = seeded_batch(idx, np.random.RandomState(seed), R, 16,
                                  JaxLogConfig(pool=64, hits=16))
    reads, carry = _torch(reads_T, carry)
    reads = reads.to(I32)
    carry = tuple(a.contiguous() for a in carry[:4]) + (torch.cat(
        [carry[4].to(torch.bool), torch.zeros(1, dtype=torch.bool)]),)
    S = sum(len(g) for g in groups)
    tables = build_tables(tdi.occ.numpy(), tdi.narrow_tab.numpy(), tdi.size,
                          ["cpu"] * S, "cpu")
    p = _plan(reads, R, plan)
    got = _Mirror(tdi, reads, carry, p, R, tables, groups, mutation).run()
    L = sum(e[0] * e[2] for e in p) * tdi.n_outcomes
    lp, le = torch.zeros(L, dtype=I32), torch.zeros(L, dtype=I32)
    want, _ = run_phases(tdi, reads, carry, p, R, lp, le)
    return got, (want, (lp, le))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))


@pytest.mark.parametrize("plan", ["wide", "auto"])
@pytest.mark.parametrize("groups", [[[0, 1, 2, 3]], [[0], [1]],
                                    [[0, 1], [2], [3]]])
@pytest.mark.parametrize("seed", [0, 5])
def test_kernel_mirror_equals_torch_steps(setup, seed, groups, plan):
    got, want = _case(setup, seed, groups, PHASES if plan == "wide" else None)
    for card in got:
        assert _same(card, want)
    assert (want[1][0] >= 0).any()


@pytest.mark.parametrize("mutation", ["sum", "holes"])
def test_kernel_mirror_mutations_fail(setup, mutation):
    """One card's round-2 answers of the first step left out of their
    sum, or the hole-allocated steps' newborns never pulled into their
    holes: not the torch steps' scan."""
    got, want = _case(setup, 0, [[0], [1]], None, mutation)
    assert not _same(got[0], want)


def test_step_table_rows_and_buffers():
    """The step table of the smoke's plan shape: a row a step, locks at
    the locked phase's first step, each step reading the buffer the one
    before wrote (the lock moving to the other), log bases a step's
    records apart."""
    plan = [(2, 256, 64, 0, ""), (4, 96, 16, 0, ""), (8, 80, 8, 64, ""),
            (30, 64, 8, 64, "locked")]
    rows, C, K, a1 = step_table(plan, 64, 100, 3, True)
    assert len(rows) == 44 and C == 256 and K == 64 * 3
    assert a1 == max(4 * 256, 80 + 4 * 64)
    assert [r[0] for r in rows] == [0] * 6 + [1] * 8 + [2] * 30
    assert [r[7] for r in rows] == [0] * 14 + [1] + [0] * 29
    for a, b in zip(rows, rows[1:]):
        assert b[6] == a[6] ^ 1 ^ b[7]
        assert b[4] == a[4] + a[2] * 3 and b[5] == a[5] + 1
    assert rows[0][6] == 0
    locked_first = step_table([(3, 64, 8, 64, "locked")], 64, 70, 3,
                              True)[0]
    assert locked_first[0][6] == 1          # the lock fills buffer 1
    wide_only = step_table(plan, 64, 100, 3, False)[0]
    assert {r[0] for r in wide_only} == {0} and not any(r[7] for r in
                                                        wide_only)
    with pytest.raises(ValueError, match="pool == R"):
        step_table([(3, 60, 8, 64, "locked")], 64, 70, 3, True)
