"""What the selection kernels (K8, csrc/select.cu) rest on, held on the CPU.

The kernels compute record_jax.select_and_record_device without its
three big sorts of states: the loci are deduplicated by one radix sort of
a packed (state, site, allele) key over every lane, each live state's key
row is read off its run of the sorted lanes, the live states are bucketed
by row (in any order) and a warp a row ranks its states' key rows, and
the triples come from a second radix sort of a packed (row key, site,
allele) key over every lane. A CUDA kernel cannot run here, so a numpy
mirror of that design, phase by phase (the _expand_budget scans with
int32 wrap, the marks and their prefix max; the encapsulated runs'
segment-first; the duplicate-site check against the unused slots' pads;
the lanes and their ancestors; the packing from the lanes' site and
allele ranges and the LSD passes of 4-bit digits; the kept lanes, the
conflicts and the state runs; the key rows by "the next distinct base
site above the last"; the row buckets, each row's first occurrences and
ranks; the pick; the triple check by a count a row and a scan; the
triples' sort, cut or padded to trip_cap), is held bit for bit
(integers, tolerance 0) to the JAX function, un-jitted, and to the port's
plain version, on the three graph kinds of tests/test_torch_record.py,
at every forced budget there and on its crafted dup_site and
allele_conflict paths, and at every profiling stage. The per-base
recorder between the two launches (K9) is the port's plain version here.

It also pins the facts the design needs: the outputs do not change when
a row's states sit in its bucket in another order, or when the lanes
(each state's loci) come in another order; and two deliberate mutations
of the mirror (a spill test off by one, the triples' tail built from the
valid lanes only) make it disagree with JAX.
"""
import numpy as np
import pytest
import torch

from gramtools_tpu.mapping import record_jax as rj
from gramtools_tpu_torch.mapping import record as tr
from gramtools_tpu_torch.mapping import search_log_host as host

from test_torch_record import FORCED, Case

FB = {v: k for k, v in host.FB_NAMES.items()}
TCAP = host.TCAP
URNG = (1 << 32) - 1


def wrap32(x):
    """int32 wrap-around of int64 values, as the kernels' int adds."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def bits_of(x: int) -> int:
    return int(x).bit_length()


class Mirror:
    """The kernels' design in numpy. ``shuffle``: a RandomState that
    reorders each row's bucket and the lanes before the dedup sort;
    ``mutation``: "spill" (an item spills when its inclusive prefix
    reaches the cap, not when it passes it) or "tail" (the triple sort
    takes the valid lanes only)."""

    def __init__(self, case, caps, kcap, shuffle=None, mutation=None):
        rt, di = case.trt, case.tdi
        n = lambda t: t.numpy().astype(np.int64)
        self.sa = n(di.sa)[:di.size]
        self.ra_node, self.nt_site = n(rt.ra_node), n(rt.nt_site)
        self.nt_allele, self.anc_len = n(rt.nt_allele), n(rt.anc_len)
        self.anc_site, self.anc_allele = n(rt.anc_site), n(rt.anc_allele)
        self.base_site, self.A = n(rt.base_site), max(rt.max_anc, 0)
        self.caps, self.kcap = caps, kcap
        self.rng, self.mutation = shuffle, mutation

    # ---- the scans ----------------------------------------------------------

    def expand(self, widths, cap, fallback, rows, bit):
        """_expand_budget as the kernels run it: the inclusive int32 scan,
        each non-empty item's start lane marked item + 1 (atomic max), the
        prefix max of the marks; the spilled items flag their rows."""
        w = wrap32(widths)
        M = w.size
        cum = wrap32(np.cumsum(w))
        start = wrap32(cum - w)
        nz = w > 0
        marks = np.zeros(cap, np.int64)
        ok = nz & (start < cap)
        np.maximum.at(marks, np.clip(start[ok], 0, cap - 1),
                      np.flatnonzero(ok) + 1)
        item = np.clip(np.maximum.accumulate(marks) - 1, 0, max(M - 1, 0))
        g = np.arange(cap)
        valid = g < min(int(cum[-1]), cap)
        off = wrap32(g - start[item])
        spill = nz & ((cum >= cap) if self.mutation == "spill"
                      else (cum > cap))
        fallback[rows[spill]] |= bit
        return item, off, valid

    # ---- stages 0-5 ---------------------------------------------------------

    def select(self, f_rid, f_lo, f_hi, trav, n_trav, ing, n_ing, bad,
               row_ok, row_first, trip_cap, stage=99):
        ecap, trcap, _, _, lcap = self.caps
        N, R = f_rid.size, row_ok.size
        NS = N + ecap
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
        item, off, valid = self.expand(
            np.where(alive & ~has_path, wrap32(f_hi - f_lo + 1), 0), ecap,
            fb, rc, FB["encapsulated_spill"])
        occ = np.clip(wrap32(f_lo[item] + off), 0, self.sa.size - 1)
        node = self.ra_node[np.clip(self.sa[occ], 0, self.ra_node.size - 1)]
        site = np.where(valid, self.nt_site[node], 0)
        allele = self.nt_allele[node]
        nonvar = np.zeros(R, np.int64)
        np.add.at(nonvar, rc[item][valid & (site == 0)], 1)
        enc = valid & (site > 0)
        prev_same = np.zeros(ecap, bool)
        prev_same[1:] = ((item[1:] == item[:-1]) & (site[1:] == site[:-1])
                         & (allele[1:] == allele[:-1]) & enc[1:] & enc[:-1])
        start = enc & ~prev_same
        first = np.maximum.accumulate(np.where(~enc | ~prev_same,
                                               np.arange(ecap), 0))
        ps_hi_e = np.zeros(ecap, np.int64)
        nxt = np.append(prev_same[1:], False)
        ends = enc & ~nxt
        ps_hi_e[first[ends]] = occ[ends]
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
                                       fb, ps_row, FB["loci_spill"])
        l1 = ps_trav[li, np.clip(loff, 0, TCAP - 1)]
        ti, toff, tvalid = self.expand(
            np.where(ps_live & (ps_ning > 0), wrap32(ps_hi - ps_lo + 1), 0),
            trcap, fb, ps_row, FB["traversing_spill"])
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
        self.pk = Packing(lsite, lallele)
        hi, lo = self.pk.pack(lkey)
        hi, lo = radix_sort(hi, lo, bits_of(NS + 1) + self.pk.low)
        skey, ssite, sallele = self.pk.unpack(hi, lo)
        LT = skey.size
        same = np.zeros(LT, bool)
        same[1:] = (hi[1:] == hi[:-1]) & (lo[1:] == lo[:-1])
        keep = ~same & (skey <= NS)
        sc = np.minimum(skey, NS - 1)
        conflict = np.zeros(LT, bool)
        conflict[1:] = (keep[1:] & keep[:-1] & (sc[1:] == sc[:-1])
                        & (ssite[1:] == ssite[:-1]))
        fb[ps_row[sc[conflict]]] |= FB["allele_conflict"]
        self.sorted = (skey, ssite, sallele, keep, hi, lo)
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
        # the preliminary triple check: a count a row, a scan
        if LT > trip_cap:
            ks = keep & sel[sc] & (fb[ps_row[sc]] == 0)
            n_sel = np.bincount(ps_row[sc[ks]], minlength=R)
            fb[(n_sel > 0) & (np.cumsum(n_sel) > trip_cap)] |= FB["trip_spill"]
        return out

    # ---- after K9: the triples ---------------------------------------------

    def triples(self, out, fb_final, trip_cap):
        skey, ssite, sallele, keep, hi, lo = self.sorted
        R = fb_final.size
        NS = out["ps_row"].size
        sc = np.minimum(skey, NS - 1)
        row = out["ps_row"][sc]
        t_key = np.where(keep & out["st_selected"][sc] & (fb_final[row] == 0),
                         row, R + 1)
        if self.mutation == "tail":
            valid = skey <= NS
            t_key, hi, lo = t_key[valid], hi[valid], lo[valid]
        hi2, lo2 = self.pk.pack(t_key, self.pk.low_fields(hi, lo))
        hi2, lo2 = radix_sort(hi2, lo2, bits_of(R + 1) + self.pk.low)
        k2, s2, a2 = self.pk.unpack(hi2, lo2)
        n = min(trip_cap, k2.size)
        pad = trip_cap - n
        return (np.concatenate([k2[:n], np.full(pad, R + 1)]),
                np.concatenate([s2[:n], np.zeros(pad, np.int64)]),
                np.concatenate([a2[:n], np.zeros(pad, np.int64)]))


class Packing:
    """(primary << (sb + ab)) | (site - smin) << ab | (allele - amin), the
    widths from the lanes' ranges; keys as (hi, lo) uint64 halves."""

    def __init__(self, site, allele):
        self.smin, self.amin = int(site.min()), int(allele.min())
        self.sb = bits_of(int(site.max()) - self.smin)
        self.ab = bits_of(int(allele.max()) - self.amin)
        self.low = self.sb + self.ab
        u = lambda a, m: (np.asarray(a, np.int64) - m).astype(np.uint64)
        self.fields = ((u(site, self.smin) << np.uint64(self.ab))
                       | u(allele, self.amin))

    def pack(self, primary, fields=None):
        """(hi, lo) of each primary key over its lane's fields."""
        f = self.fields if fields is None else fields
        p = np.asarray(primary, np.int64).astype(np.uint64)
        if self.low == 0:
            return np.zeros_like(p), p
        if self.low == 64:
            return p, f
        return (p >> np.uint64(64 - self.low),
                f | (p << np.uint64(self.low)))

    def low_fields(self, hi, lo):
        if self.low == 64:
            return lo
        return lo & np.uint64((1 << self.low) - 1)

    def unpack(self, hi, lo):
        """(primary, site, allele) of packed keys."""
        if self.low == 0:
            primary = lo
        elif self.low == 64:
            primary = hi
        else:
            primary = ((lo >> np.uint64(self.low))
                       | (hi << np.uint64(64 - self.low)))
        site = (lo >> np.uint64(self.ab)) & np.uint64((1 << self.sb) - 1)
        allele = lo & np.uint64((1 << self.ab) - 1)
        return (primary.astype(np.int64), site.astype(np.int64) + self.smin,
                allele.astype(np.int64) + self.amin)


def radix_sort(hi, lo, bits):
    """Stable LSD passes of 4-bit digits over the low ``bits`` bits."""
    for shift in range(0, bits, 4):
        d = ((lo >> np.uint64(shift)) if shift < 64
             else (hi >> np.uint64(shift - 64))) & np.uint64(15)
        perm = np.argsort(d, kind="stable")
        hi, lo = hi[perm], lo[perm]
    return hi, lo


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
