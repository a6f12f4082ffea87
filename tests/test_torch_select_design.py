"""What the selection kernels (K8, csrc/select.cu) rest on, held on the CPU.

The kernels compute record_jax.select_and_record_device without its
three big sorts of states: the loci are deduplicated by one radix sort of
a packed (state, site, allele) key over every lane, each live state's key
row is read off its run of the sorted lanes, the live states are bucketed
by row (in any order) and each row's states' key rows are ranked, and the
triples come from a second radix sort of (row key, site, allele) over
every lane. A CUDA kernel cannot run here, so a numpy mirror of that
design, phase by phase, is held bit for bit (integers, tolerance 0) to
the JAX function, un-jitted, and to the port's plain version, on the
three graph kinds of tests/test_torch_record.py, at every forced budget
there and on its crafted dup_site and allele_conflict paths, and at every
profiling stage. The mirror follows the kernels: every scan a chained
scan over tiles of 256 items (each tile's own scan combined with the fold
of the tiles before it, as the look-back finds it: the _expand_budget
scans with int32 wrap, the marks' prefix max, the encapsulated runs'
starts, the selected-lane counts); the encapsulated split a tile at a
time, each tile working out the lanes just before and after it from its
own prefixes; the packing of the lanes' site and allele ranges rounded up
to whole 8-bit digits, in uint64 keys or Python integers as the host's
width bound (ops/select.py ``key_bits``) picks the 64-bit or the 128-bit
instance; each sort one histogram sweep of every digit, then 8-bit LSD
passes that place each key by its digit's first place, the tiles before
its own and its rank in its tile; the dedup sort's field passes, then its
state passes carrying each key's place in the field order; the kept
lanes, the conflicts and the state runs; the key rows by "the next
distinct base site above the last"; the row buckets, each row's first
occurrences and ranks; the pick; the triple sort from the field order,
each lane's row key in place of its state, by the row key's passes only,
cut or padded to trip_cap. The per-base recorder between the two
launches (K9) is the port's plain version here.

It also pins the facts the design needs: the outputs do not change when
a row's states sit in its bucket in another order, when the lanes (each
state's loci) come in another order, or when the sort tiles are spread
over another grid; the host's width bound covers the packed keys' exact
width on every graph kind, a bound past 64 bits takes the 128-bit
instance, the 64-bit one refuses keys past 64 bits and the 128-bit one
gives the same outputs; and four deliberate mutations of the mirror (a
spill test off by one, the triples' tail built from the valid lanes
only, every digit taken 8 bits too high, keys packed one bit short) make
it disagree with JAX.
"""
import numpy as np
import pytest
import torch

from gramtools_tpu.mapping import record_jax as rj
from gramtools_tpu_torch.mapping import record as tr
from gramtools_tpu_torch.mapping import search_log_host as host
from gramtools_tpu_torch.ops import select as select_ops

from test_torch_record import FORCED, Case

FB = {v: k for k, v in host.FB_NAMES.items()}
TCAP = host.TCAP
URNG = (1 << 32) - 1


def wrap32(x):
    """int32 wrap-around of int64 values, as the kernels' int adds."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def bits_of(x: int) -> int:
    return int(x).bit_length()


TILE = 256          # items a scan tile, threads a block (csrc/select.cu)
GRID = 264          # the H100's cooperative grid: 2 blocks an SM
MAX_ITEMS = 8       # keys a thread in a sort tile


def chained_scan(values, op, tile=TILE):
    """A chained scan as the kernels run it over tiles of ``tile`` items:
    each tile's own inclusive scan, combined with the fold of the tiles
    before it (what the tile's look-back finds: the aggregates of the
    earlier tiles back to the nearest inclusive prefix). ``op``: "sum"
    (int32 wrap) or "max"."""
    v = np.asarray(values, np.int64)
    out = np.empty(v.size, np.int64)
    excl = None
    for t0 in range(0, v.size, tile):
        part = v[t0:t0 + tile]
        if op == "sum":
            local = wrap32(np.cumsum(part))
            out[t0:t0 + tile] = local if excl is None else wrap32(excl + local)
        else:
            local = np.maximum.accumulate(part)
            out[t0:t0 + tile] = (local if excl is None
                                 else np.maximum(excl, local))
        excl = out[t0 + part.size - 1]
    return out


def sort_tile(n, grid=GRID):
    """Keys a sort tile: 256 threads of as many keys as spread n over
    the grid, 1 to MAX_ITEMS (csrc/select.cu sort_items)."""
    per = -(-n // (grid * TILE))
    return TILE * min(max(per, 1), MAX_ITEMS)


class Mirror:
    """The kernels' design in numpy. ``shuffle``: a RandomState that
    reorders each row's bucket and the lanes before the dedup sort;
    ``wide``: the key instance (None: the one ``select.key_bits`` asks
    for; True: Python integers, as the 128-bit instance; False: uint64,
    which refuses keys past 64 bits as the 64-bit instance traps);
    ``grid``: the cooperative grid the sort tiles spread over;
    ``mutation``: "spill" (an item spills when its inclusive prefix
    reaches the cap, not when it passes it), "tail" (the triple sort
    takes the valid lanes only), "shift" (every digit taken 8 bits
    above its own) or "width" (keys packed in one bit less than they
    need, the top bit dropped)."""

    def __init__(self, case, caps, kcap, shuffle=None, mutation=None,
                 wide=None, grid=GRID):
        rt, di = case.trt, case.tdi
        n = lambda t: t.numpy().astype(np.int64)
        self.sa = n(di.sa)[:di.size]
        self.ra_node, self.nt_site = n(rt.ra_node), n(rt.nt_site)
        self.nt_allele, self.anc_len = n(rt.nt_allele), n(rt.anc_len)
        self.anc_site, self.anc_allele = n(rt.anc_site), n(rt.anc_allele)
        self.base_site, self.A = n(rt.base_site), max(rt.max_anc, 0)
        self.caps, self.kcap = caps, kcap
        self.rng, self.mutation = shuffle, mutation
        self.wide, self.grid = wide, grid

    # ---- the scans ----------------------------------------------------------

    def expand(self, widths, cap, fallback, rows, bit):
        """_expand_budget as the kernels run it: the chained inclusive
        int32 scan of the widths, each non-empty item's start lane marked
        item + 1 (atomic max), the chained prefix max of the marks; the
        spilled items flag their rows. Also returns the marks and their
        prefix max."""
        w = wrap32(widths)
        M = w.size
        cum = chained_scan(w, "sum")
        start = wrap32(cum - w)
        nz = w > 0
        marks = np.zeros(cap, np.int64)
        ok = nz & (start < cap)
        np.maximum.at(marks, np.clip(start[ok], 0, cap - 1),
                      np.flatnonzero(ok) + 1)
        mark = chained_scan(marks, "max")
        item = np.clip(mark - 1, 0, max(M - 1, 0))
        g = np.arange(cap)
        valid = g < min(int(cum[-1]), cap)
        off = wrap32(g - start[item])
        spill = nz & ((cum >= cap) if self.mutation == "spill"
                      else (cum > cap))
        fallback[rows[spill]] |= bit
        return item, off, valid, cum, start, marks, mark

    def enc_lanes(self, g, mark, ctx):
        """Encapsulated lanes g given their marks' prefix max: (item,
        SA row, site, allele, valid)."""
        f_lo, cum, start, total, N = ctx
        item = np.clip(mark - 1, 0, N - 1)
        off = wrap32(g - start[item])
        valid = g < total
        occ = np.clip(wrap32(f_lo[item] + off), 0, self.sa.size - 1)
        node = self.ra_node[np.clip(self.sa[occ], 0, self.ra_node.size - 1)]
        return (item, occ, np.where(valid, self.nt_site[node], 0),
                self.nt_allele[node], valid)

    def encapsulated(self, marks, mark, ctx):
        """Stage 1's tiles: each tile's lanes, and the lanes just before
        and after it worked out from its exclusive and inclusive prefix
        max, give each lane's prev_same and next_same without another
        tile; then the run starts' chained prefix max."""
        ecap = marks.size
        item, occ, site, allele, valid = self.enc_lanes(np.arange(ecap),
                                                        mark, ctx)
        enc = valid & (site > 0)
        prev_same = np.zeros(ecap, bool)
        next_same = np.zeros(ecap, bool)
        for t0 in range(0, ecap, TILE):
            t1 = min(t0 + TILE, ecap)
            g = np.arange(max(t0 - 1, 0), min(t1 + 1, ecap))
            m = mark[g].copy()
            if t0 > 0:
                m[0] = mark[t0 - 1]          # the tile's exclusive prefix
            if t1 < ecap:                    # its inclusive one, the next mark
                m[-1] = max(mark[t1 - 1], marks[t1])
            li, lo, ls, la, lv = self.enc_lanes(g, m, ctx)
            le = lv & (ls > 0)
            same = ((li[1:] == li[:-1]) & (ls[1:] == ls[:-1])
                    & (la[1:] == la[:-1]) & le[1:] & le[:-1])
            same &= g[1:] > 0
            a = t0 - g[0]                    # the tile's first lane in g
            prev_same[t0:t1] = np.append(False, same)[a:a + t1 - t0]
            next_same[t0:t1] = np.append(same, False)[a:a + t1 - t0]
        start = enc & ~prev_same
        first = chained_scan(np.where(~enc | ~prev_same, np.arange(ecap), 0),
                             "max")
        ps_hi_e = np.zeros(ecap, np.int64)
        ends = enc & ~next_same
        ps_hi_e[first[ends]] = occ[ends]
        return item, occ, site, allele, valid, start, ps_hi_e

    # ---- stages 0-5 ---------------------------------------------------------

    def select(self, f_rid, f_lo, f_hi, trav, n_trav, ing, n_ing, bad,
               row_ok, row_first, trip_cap, stage=99):
        ecap, trcap, _, _, lcap = self.caps
        N, R = f_rid.size, row_ok.size
        NS = N + ecap
        self.NS, self.R = NS, R
        fb = np.zeros(R, np.int64)
        rc = np.clip(f_rid, 0, R - 1)
        alive = (f_rid >= 0) & row_ok[rc]
        fb[rc[bad & alive]] |= FB["chain_depth"]
        mapped = np.zeros(R, bool)
        mapped[rc[alive]] = True
        out = dict(fb=fb, mapped=mapped)
        if stage <= 0:
            return out
        has_path = (n_trav > 0) | (n_ing > 0)
        live = alive & has_path
        # the encapsulated split
        w = np.where(alive & ~has_path, wrap32(f_hi - f_lo + 1), 0)
        _, _, _, cum, estart, marks, mark = self.expand(
            w, ecap, fb, rc, FB["encapsulated_spill"])
        item, occ, site, allele, valid, start, ps_hi_e = self.encapsulated(
            marks, mark, (f_lo, cum, estart, min(int(cum[-1]), ecap), N))
        nonvar = np.zeros(R, np.int64)
        np.add.at(nonvar, rc[item][valid & (site == 0)], 1)
        ps_row = np.concatenate([rc, rc[item]])
        ps_lo = np.concatenate([f_lo, occ])
        ps_hi = np.concatenate([f_hi, ps_hi_e])
        ps_live = np.concatenate([live, start])
        ps_ntrav = np.concatenate([np.where(live, n_trav, 0), start])
        ps_ning = np.concatenate([np.where(live, n_ing, 0),
                                  np.zeros(ecap, np.int64)])
        ps_trav = np.zeros((NS, TCAP, 2), np.int64)
        ps_trav[:N] = trav
        ps_trav[N:, 0, 0] = np.where(start, site, 0)
        ps_trav[N:, 0, 1] = np.where(start, allele, 0)
        last = np.clip(n_ing - 1, 0, TCAP - 1)
        ing_parent = np.concatenate([
            np.where(n_ing > 0, ing[np.arange(N), last, 0], 0),
            np.zeros(ecap, np.int64)])
        out.update(ps_row=ps_row, ps_lo=ps_lo, ps_hi=ps_hi, ps_trav=ps_trav,
                   ps_ntrav=ps_ntrav, st_selected=np.zeros(NS, bool))
        if stage <= 1:
            return out
        # the duplicate-site check, against the unused slots' pads
        for s in np.flatnonzero(ps_live):
            nt, ni = int(ps_ntrav[s]), int(ps_ning[s])
            v = list(ps_trav[s, :nt, 0]) + (list(ing[s, :ni, 0])
                                            if s < N else [])
            pads = ({(1 << 28) + k for k in range(nt, TCAP)}
                    | {(1 << 28) + TCAP + k for k in range(ni, TCAP)})
            if len(set(v)) < len(v) or any(x in pads for x in v):
                fb[ps_row[s]] |= FB["dup_site"]
        if stage <= 2:
            return out
        # the lanes: traversed loci, traversing occurrences, ancestors
        li, loff, lvalid = self.expand(np.where(ps_live, ps_ntrav, 0), lcap,
                                       fb, ps_row, FB["loci_spill"])[:3]
        l1 = ps_trav[li, np.clip(loff, 0, TCAP - 1)]
        ti, toff, tvalid = self.expand(
            np.where(ps_live & (ps_ning > 0), wrap32(ps_hi - ps_lo + 1), 0),
            trcap, fb, ps_row, FB["traversing_spill"])[:3]
        tocc = np.clip(wrap32(ps_lo[ti] + toff), 0, self.sa.size - 1)
        tnode = self.ra_node[np.clip(self.sa[tocc], 0,
                                     self.ra_node.size - 1)]
        b_state = np.concatenate([li, ti])
        b_site = np.concatenate([l1[:, 0], np.where(tvalid, ing_parent[ti],
                                                    0)])
        b_allele = np.concatenate([l1[:, 1], self.nt_allele[tnode]])
        b_valid = np.concatenate([lvalid, tvalid]) & (b_site >= 5)
        sidx = np.clip((b_site - 5) >> 1, 0, self.anc_len.size - 1)
        keys, sites, alleles = [np.where(b_valid, b_state, NS + 1)], [b_site], [
            b_allele]
        for a in range(self.A):
            keys.append(np.where(b_valid & (a < self.anc_len[sidx]), b_state,
                                 NS + 1))
            sites.append(self.anc_site[sidx, a])
            alleles.append(self.anc_allele[sidx, a])
        lkey, lsite, lallele = (np.concatenate(x) for x in
                                (keys, sites, alleles))
        if self.rng is not None:
            perm = self.rng.permutation(lkey.size)
            lkey, lsite, lallele = lkey[perm], lsite[perm], lallele[perm]
        # the dedup sort: the fields' passes, then the state's, each key's
        # place in the field order beside it
        wide = self.wide
        if wide is None:
            wide = select_ops.wide_keys(select_ops.key_bits(
                NS, R, self.anc_len.size, self.nt_site.size))
        self.pk = pk = Packing(lsite, lallele, max(NS + 1, R + 1), wide,
                               self.mutation)
        keys = pk.pack(lkey, width=bits_of(NS + 1) + pk.low)
        F, P = pk.low // 8, -(-(bits_of(NS + 1) + pk.low) // 8)
        hist = self.histogram(keys, 0, P)
        mid = self.sort(keys, None, 0, F, hist)[0]
        keys, place = self.sort(mid, np.arange(mid.size), F, P, hist)
        skey, ssite, sallele = pk.unpack(keys)
        LT = skey.size
        same = np.zeros(LT, bool)
        same[1:] = keys[1:] == keys[:-1]
        keep = ~same & (skey <= NS)
        keep_mid = np.zeros(LT, bool)
        keep_mid[place] = keep
        sc = np.minimum(skey, NS - 1)
        conflict = np.zeros(LT, bool)
        conflict[1:] = (keep[1:] & keep[:-1] & (sc[1:] == sc[:-1])
                        & (ssite[1:] == ssite[:-1]))
        fb[ps_row[sc[conflict]]] |= FB["allele_conflict"]
        self.mid, self.keep_mid = mid, keep_mid
        if stage <= 3:
            return out
        # key rows: a live state's run, "the next distinct base above"
        runs = {}
        for q in np.flatnonzero(skey < NS):
            runs.setdefault(int(skey[q]), []).append(q)
        key_row = {}
        for s in np.flatnonzero(ps_live):
            bases = [int(self.base_site[np.clip((int(ssite[q]) - 5) >> 1, 0,
                                                self.base_site.size - 1)])
                     for q in runs.get(s, []) if keep[q]]
            row, prev = [], None
            while True:
                above = [b for b in bases if prev is None or b > prev]
                if not above:
                    break
                if len(row) == self.kcap:
                    fb[ps_row[s]] |= FB["kcap"]
                    break
                prev = min(above)
                row.append(prev)
            key_row[s] = tuple(row + [-1] * (self.kcap - len(row)))
        # the row buckets (any order), each row's classes and the pick
        buckets = {}
        for s in np.flatnonzero(ps_live):
            buckets.setdefault(int(ps_row[s]), []).append(int(s))
        sel = out["st_selected"]
        for r, st in buckets.items():
            if self.rng is not None:
                st = list(self.rng.permutation(st))
            keys_r = [key_row[s] for s in st]
            first = [all(keys_r[j] != keys_r[i] for j in range(i))
                     for i in range(len(st))]
            n_classes = sum(first)
            total = int(wrap32(nonvar[r] + n_classes))
            totals = max(total, 1)
            scaling = URNG // totals
            rdraw = int(row_first[r]) & URNG
            if n_classes > 0 and rdraw >= totals * scaling:
                fb[r] |= FB["rng_rejection"]
            selected = int(wrap32(1 + int(wrap32(rdraw // max(scaling, 1)))))
            chosen = int(wrap32(selected - nonvar[r] - 1))
            if n_classes > 0 and 0 <= chosen < n_classes:
                for i, s in enumerate(st):
                    ordr = sum(first[j] and keys_r[j] < keys_r[i]
                               for j in range(len(st)))
                    sel[s] = ordr == chosen
        if stage <= 4:
            return out
        # the preliminary triple check: a count a row, a chained scan
        if LT > trip_cap:
            ks = keep & sel[sc] & (fb[ps_row[sc]] == 0)
            n_sel = np.bincount(ps_row[sc[ks]], minlength=R)
            fb[(n_sel > 0) & (chained_scan(n_sel, "sum") > trip_cap)] |= FB[
                "trip_spill"]
        return out

    # ---- the one-sweep sort -------------------------------------------------

    def shift(self, p):
        return 8 * p + (8 if self.mutation == "shift" else 0)

    def histogram(self, keys, p0, p1):
        """Every pass's digit counts, in one sweep over the keys."""
        return {p: np.bincount(self.pk.digit(keys, self.shift(p)),
                               minlength=256) for p in range(p0, p1)}

    def sort(self, keys, vals, p0, p1, hist):
        """Passes [p0, p1) of the LSD sort of 8-bit digits, values (where
        given) going with their keys. A pass skips where one digit holds
        every key; else each key goes to its digit's first place over all
        tiles (the histogram's exclusive scan), plus the digit's keys in
        the tiles before its own (the look-back over per-tile, per-digit
        counts), plus the keys of its digit before it in its tile (the
        warp multisplit's rank)."""
        n = keys.size
        tile = sort_tile(n, self.grid)
        T = -(-n // tile)
        idx = np.arange(n)
        t = idx // tile
        for p in range(p0, p1):
            h = hist[p]
            if (h == n).any():
                continue
            d = self.pk.digit(keys, self.shift(p))
            td = t * 256 + d
            order = np.argsort(td, kind="stable")
            first = np.searchsorted(td[order], td[order], side="left")
            rank = np.empty(n, np.int64)
            rank[order] = np.arange(n) - first
            cnt = np.bincount(td, minlength=T * 256).reshape(T, 256)
            before = np.cumsum(cnt, axis=0) - cnt
            dest = (np.cumsum(h) - h)[d] + before[t, d] + rank
            assert np.array_equal(np.sort(dest), idx), "not a permutation"
            new = np.empty_like(keys)
            new[dest] = keys
            keys = new
            if vals is not None:
                nv = np.empty_like(vals)
                nv[dest] = vals
                vals = nv
        return keys, vals

    # ---- after K9: the triples ---------------------------------------------

    def triples(self, out, fb_final, trip_cap):
        """The triple sort: the dedup sort's field order, each lane's state
        replaced by its row key, sorted by the row key's passes only."""
        pk, mid, keep_mid = self.pk, self.mid, self.keep_mid
        R = fb_final.size
        NS = out["ps_row"].size
        skey = pk.unpack(mid)[0]
        sc = np.minimum(skey, NS - 1)
        row = out["ps_row"][sc]
        t_key = np.where(keep_mid & out["st_selected"][sc]
                         & (fb_final[row] == 0), row, R + 1)
        fields = pk.fields(mid)
        if self.mutation == "tail":
            valid = skey <= NS
            t_key, fields = t_key[valid], fields[valid]
        keys = pk.pack(t_key, fields, width=bits_of(R + 1) + pk.low)
        F, P = pk.low // 8, -(-(bits_of(R + 1) + pk.low) // 8)
        keys = self.sort(keys, None, F, P, self.histogram(keys, F, P))[0]
        k2, s2, a2 = pk.unpack(keys)
        n = min(trip_cap, k2.size)
        pad = trip_cap - n
        return (np.concatenate([k2[:n], np.full(pad, R + 1)]),
                np.concatenate([s2[:n], np.zeros(pad, np.int64)]),
                np.concatenate([a2[:n], np.zeros(pad, np.int64)]))


class Packing:
    """(primary << low) | (site - smin) << ab | (allele - amin), sb and
    ab the bits of the lanes' site and allele ranges and low their sum
    rounded up to whole 8-bit digits; the keys uint64 (the 64-bit
    instance, which refuses keys past 64 bits as its launch traps) or
    Python integers (the 128-bit instance). ``primary_max``: the largest
    primary key either sort packs. The "width" mutation packs each sort's
    keys in one bit less than their width, dropping the top bit."""

    def __init__(self, site, allele, primary_max, wide, mutation=None):
        self.smin, self.amin = int(site.min()), int(allele.min())
        self.sb = bits_of(int(site.max()) - self.smin)
        self.ab = bits_of(int(allele.max()) - self.amin)
        self.low = (self.sb + self.ab + 7) // 8 * 8
        self.bits = bits_of(primary_max) + self.low
        self.wide, self.mutation = wide, mutation
        if not wide and self.bits > 64:
            raise OverflowError(f"{self.bits}-bit keys: the 64-bit instance "
                                "traps")
        u = lambda a, m: self.ints(np.asarray(a, np.int64) - m)
        self.site_f = u(site, self.smin)
        self.allele_f = u(allele, self.amin)

    def ints(self, a):
        """Non-negative integers as the instance's keys."""
        a = np.asarray(a, np.int64)
        return (np.array([int(x) for x in a], dtype=object) if self.wide
                else a.astype(np.uint64))

    def c(self, x):
        return x if self.wide else np.uint64(x)

    def pack(self, primary, fields=None, width=None):
        """Each primary key over its lane's fields (by default the
        lanes' own); ``width``: the sort's key bits."""
        if fields is None:
            fields = (self.site_f << self.c(self.ab)) | self.allele_f
        k = (self.ints(primary) << self.c(self.low)) | fields
        if self.mutation == "width":
            k = k & self.c((1 << (width - 1)) - 1)
        return k

    def digit(self, keys, shift):
        return ((keys >> self.c(shift)) & self.c(255)).astype(np.int64)

    def fields(self, keys):
        return keys & self.c((1 << self.low) - 1)

    def unpack(self, keys):
        """(primary, site, allele) of packed keys."""
        as_int = lambda a: np.asarray(a).astype(np.int64)
        primary = as_int(keys >> self.c(self.low))
        site = as_int((keys >> self.c(self.ab))
                      & self.c((1 << self.sb) - 1))
        allele = as_int(keys & self.c((1 << self.ab) - 1))
        return primary, site + self.smin, allele + self.amin


# ---- the comparisons --------------------------------------------------------

def _inputs(case, replayed=None, row_first=None):
    rid, lo, hi = case.scan[:3]
    ovf = case.scan[4]
    if replayed is None:
        replayed = case.replay_pair()[0]
    trav, n_trav, ing, n_ing, bad = (np.asarray(x) for x in replayed)
    row_first = case.np["row_first"] if row_first is None else row_first
    return [np.asarray(x).astype(np.int64) for x in (
        rid, lo, hi, trav, n_trav, ing, n_ing)] + [
        np.asarray(bad, bool), case.np["row_ok"] & ~ovf,
        np.asarray(row_first, np.int64)]


def run_mirror(case, caps, kcap, trip_cap, ins, stage=99, **kw):
    """The mirror's outputs: (fallback, mapped, trip_row, trip_site,
    trip_allele, cov_diff), K9 the port's plain version."""
    m = Mirror(case, caps, kcap, **kw)
    out = m.select(*ins, trip_cap, stage=stage)
    R = ins[9].size
    cov = torch.zeros(case.cov_size + 1, dtype=torch.int32)
    none = (np.zeros(R, bool), np.full(trip_cap, R + 1),
            np.zeros(trip_cap, np.int64), np.zeros(trip_cap, np.int64))
    if stage <= 5:
        return [out["fb"]] + list(none) + [cov.numpy()]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
    fb = tr._record_per_base_device(
        case.tdi, case.trt, t(out["ps_row"]), t(out["ps_lo"]),
        t(out["ps_hi"]), t(out["ps_trav"]), t(out["ps_ntrav"]),
        torch.from_numpy(out["st_selected"]), t(case.np["row_len"]),
        t(out["fb"]), cov, caps[2], caps[3]).numpy()
    if stage <= 6:
        return [fb] + list(none) + [cov.numpy()]
    return [fb, out["mapped"]] + list(m.triples(out, fb, trip_cap)) + [
        cov.numpy()]


def torch_stage(case, ins, trip_cap, stage):
    """The port's plain version at ``stage``, cov_diff last."""
    cov = torch.zeros(case.cov_size + 1, dtype=torch.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    rid, lo, hi, trav, n_trav, ing, n_ing, bad, row_ok, row_first = ins
    i32 = lambda a: t(a.astype(np.int32))
    out = tr.select_and_record_device(
        case.tdi, case.trt, i32(rid), i32(lo), i32(hi), i32(trav),
        i32(n_trav), i32(ing), i32(n_ing), t(bad), t(row_ok), t(row_first),
        t(case.np["row_len"]), cov, trip_cap=trip_cap, stage=stage)
    return [x.numpy() for x in out] + [cov.numpy()]


def assert_equal(a, b, what):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x).astype(np.int64),
                                      np.asarray(y).astype(np.int64),
                                      err_msg=f"{what}: output {i}")


def patched(spec, monkeypatch):
    """FORCED's patch in both packages; (caps, kcap, trip_cap, rng)."""
    if "caps" in spec:
        monkeypatch.setattr(rj, "buffer_caps", spec["caps"])
        monkeypatch.setattr(tr, "buffer_caps", spec["caps"])
    if "max_chain" in spec:
        monkeypatch.setattr(rj, "MAX_CHAIN", spec["max_chain"])
        monkeypatch.setattr(tr, "MAX_CHAIN", spec["max_chain"])
    if "kcap" in spec:
        monkeypatch.setattr(rj, "KCAP", spec["kcap"])
        monkeypatch.setattr(tr, "KCAP", spec["kcap"])
    return spec.get("trip_cap"), spec.get("rng", False)


def three_ways(case, ins, trip_cap, jax_out, **kw):
    """The mirror against JAX's outputs and the port's plain version."""
    R = ins[9].size
    caps = tr.buffer_caps(R)
    got = run_mirror(case, caps, tr.KCAP, trip_cap, ins, **kw)
    assert_equal(got, jax_out, "mirror vs jax")
    assert_equal(got, torch_stage(case, ins, trip_cap, 99), "mirror vs torch")
    return got


@pytest.fixture(scope="module", params=["sites", "nested", "random"])
def case(request):
    mp = pytest.MonkeyPatch()
    try:
        return Case(request.param, mp)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def site_case():
    mp = pytest.MonkeyPatch()
    try:
        return Case("sites", mp)
    finally:
        mp.undo()


def test_mirror_matches_jax_and_plain(case):
    j, _ = case.select_pair()
    got = three_ways(case, _inputs(case), case.trip_cap, j)
    assert got[1].any() and (got[2] <= case.R).any() and got[-1].any()


@pytest.mark.parametrize("name", sorted(FORCED))
def test_mirror_at_forced_budget(site_case, name, monkeypatch):
    trip_cap, rng = patched(FORCED[name], monkeypatch)
    row_first = None
    if rng:
        row_first = site_case.np["row_first"].copy()
        row_first[::3] = (1 << 32) - 1
    replayed = site_case.replay_pair()[0]
    j, _ = site_case.select_pair(replayed=replayed, row_first=row_first,
                                 trip_cap=trip_cap)
    got = three_ways(site_case, _inputs(site_case, replayed, row_first),
                     trip_cap or site_case.trip_cap, j)
    assert (got[0] & FB[name]).any(), f"{name} did not fire"


@pytest.mark.parametrize("name", ["dup_site", "allele_conflict"])
def test_mirror_on_crafted_paths(site_case, name):
    trav, n_trav, ing, n_ing, bad = [np.array(x) for x in
                                     site_case.replay_pair()[0]]
    rid = site_case.scan[0]
    cand = np.flatnonzero((rid >= 0) & (n_trav >= 1) & (n_trav < TCAP))
    pick = cand[::2]
    dup = trav[pick, 0].copy()
    if name == "allele_conflict":
        dup[:, 1] += 1
    trav[pick, n_trav[pick]] = dup
    n_trav[pick] += 1
    replayed = (trav, n_trav, ing, n_ing, bad)
    j, _ = site_case.select_pair(replayed=replayed)
    got = three_ways(site_case, _inputs(site_case, replayed),
                     site_case.trip_cap, j)
    assert (got[0] & FB[name]).any(), f"{name} did not fire"


@pytest.mark.parametrize("stage", [0, 1, 2, 3, 4, 5, 6, 99])
def test_mirror_at_each_stage(site_case, stage):
    """Each profiling stage's early return, against the plain version
    at that stage (a trip_cap below the lanes, so stage 5 checks)."""
    ins = _inputs(site_case)
    trip_cap = 64
    caps = tr.buffer_caps(site_case.R)
    got = run_mirror(site_case, caps, tr.KCAP, trip_cap, ins, stage=stage)
    assert_equal(got, torch_stage(site_case, ins, trip_cap, stage),
                 f"stage {stage}")


@pytest.mark.parametrize("seed", [1, 2])
def test_outputs_do_not_depend_on_bucket_or_lane_order(case, seed):
    """A row's states in its bucket, and the lanes before the dedup
    sort, in another (random) order: every output equal."""
    ins = _inputs(case)
    caps = tr.buffer_caps(case.R)
    want = run_mirror(case, caps, tr.KCAP, case.trip_cap, ins)
    got = run_mirror(case, caps, tr.KCAP, case.trip_cap, ins,
                     shuffle=np.random.RandomState(seed))
    assert_equal(got, want, "shuffled")


def test_mutated_mirrors_disagree_with_jax(site_case, monkeypatch):
    """The comparisons above can fail: a spill test off by one (at the
    forced budgets) and a tail of valid lanes only each give another
    output than JAX's."""
    ins = _inputs(site_case)
    j, _ = site_case.select_pair()
    caps = tr.buffer_caps(site_case.R)
    tail = run_mirror(site_case, caps, tr.KCAP, site_case.trip_cap, ins,
                      mutation="tail")
    assert not all(np.array_equal(np.asarray(a).astype(np.int64),
                                  np.asarray(b).astype(np.int64))
                   for a, b in zip(tail, j))
    differs = []
    for name in ("encapsulated_spill", "traversing_spill", "loci_spill"):
        with monkeypatch.context() as mp:
            trip_cap, _ = patched(FORCED[name], mp)
            j, _ = site_case.select_pair(trip_cap=trip_cap)
            got = run_mirror(site_case, tr.buffer_caps(site_case.R),
                             tr.KCAP, site_case.trip_cap, ins,
                             mutation="spill")
            differs.append(not all(np.array_equal(
                np.asarray(a).astype(np.int64),
                np.asarray(b).astype(np.int64)) for a, b in zip(got, j)))
    assert any(differs), differs


def _differs(got, want):
    return not all(np.array_equal(np.asarray(a).astype(np.int64),
                                  np.asarray(b).astype(np.int64))
                   for a, b in zip(got, want))


@pytest.mark.parametrize("mutation", ["shift", "width"])
def test_digit_and_width_mutations_disagree_with_jax(site_case, mutation):
    """The comparisons above can fail on the sorts' design: every digit
    taken 8 bits above its own (the lowest digit never sorted), and each
    sort's keys packed in one bit less than their width (the top bit
    dropped: every invalid lane's state NS + 1 lands on a valid state,
    every unselected lane's row key R + 1 on a row) each give another
    output than JAX's."""
    ins = _inputs(site_case)
    j, _ = site_case.select_pair()
    caps = tr.buffer_caps(site_case.R)
    got = run_mirror(site_case, caps, tr.KCAP, site_case.trip_cap, ins,
                     mutation=mutation)
    assert _differs(got, j)


def test_host_width_bound_covers_the_exact_bits(case):
    """On every graph kind the host's bound on the keys' width (from the
    shapes alone) is at least the exact width the kernels pack (the
    lanes' site and allele ranges over the larger primary key), so the
    launch takes the 64-bit instance, whose keys hold them."""
    ins = _inputs(case)
    caps = tr.buffer_caps(case.R)
    m = Mirror(case, caps, tr.KCAP)
    m.select(*ins, case.trip_cap, stage=3)
    bound = select_ops.key_bits(m.NS, m.R, case.trt.anc_len.shape[0],
                                case.trt.nt_site.shape[0])
    assert m.pk.bits <= bound <= 64 and not m.pk.wide
    assert not select_ops.wide_keys(bound)


def test_wide_keys_past_64_bits(site_case, monkeypatch):
    """A packing past 64 bits takes the 128-bit instance: from the host's
    bound (a graph of 2^30 sites and nodes), or forced; on lanes whose
    sites and alleles span the int32 range (crafted paths, 77 bits with
    the state) the 64-bit instance refuses the keys, as its launch
    traps, and the 128-bit one gives JAX's outputs and the plain
    version's."""
    # the smoke's buffer on a 100,000-site graph: 16 + 18 + 19 bits
    assert select_ops.key_bits(43008, 30720, 100_000, 300_000) == 56
    assert select_ops.wide_keys(select_ops.key_bits(100, 100, 1 << 30,
                                                    1 << 30))
    monkeypatch.setattr(select_ops, "WIDE_KEYS", True)
    assert select_ops.wide_keys(40)
    monkeypatch.setattr(select_ops, "WIDE_KEYS", None)
    trav, n_trav, ing, n_ing, bad = [np.array(x) for x in
                                     site_case.replay_pair()[0]]
    rid = site_case.scan[0]
    cand = np.flatnonzero((rid >= 0) & (n_trav >= 1))
    trav[cand[0], 0] = (1 << 30, (1 << 31) - 1)
    trav[cand[1], 0] = (1 << 30, -(1 << 31))
    replayed = (trav, n_trav, ing, n_ing, bad)
    ins = _inputs(site_case, replayed)
    caps = tr.buffer_caps(site_case.R)
    with pytest.raises(OverflowError):
        run_mirror(site_case, caps, tr.KCAP, site_case.trip_cap, ins)
    j, _ = site_case.select_pair(replayed=replayed)
    got = three_ways(site_case, ins, site_case.trip_cap, j, wide=True)
    assert got[1].any()


def test_mirror_on_a_small_grid(site_case):
    """The sort tiles spread over a grid of 2 blocks (8 keys a thread,
    2,048 a tile) instead of 264 (256 a tile): the same outputs as JAX's."""
    ins = _inputs(site_case)
    j, _ = site_case.select_pair()
    caps = tr.buffer_caps(site_case.R)
    assert sort_tile(65536, 2) == 2048 and sort_tile(65536) == 256
    got = run_mirror(site_case, caps, tr.KCAP, site_case.trip_cap, ins,
                     grid=2)
    assert_equal(got, j, "grid 2")
