"""The port's fused recorder against the JAX package's, function by
function, on the CPU.

The inputs of one real fused dispatch (2-bit reads, placed seed slots,
row flags, first draws, phases) are taken from the port's engine on a
seeded buffer; the same numpy arrays then go through
gramtools_tpu/mapping/record_jax.py (un-jitted, so patched budgets take
effect) and mapping/record.py:

  * ``replay_device`` (K7's twin): trav, n_trav, ing, n_ing, bad;
  * ``select_and_record_device`` with ``_record_per_base_device`` (K9's
    twin): fallback bits, mapped flags, loci triples and ``cov_diff``;
  * the whole fused program (``_record_body`` against
    ``log_search_record``): the flat result and ``cov_diff``.

Graphs: random and hard nested PRGs (tests/test_search_jax.py) and
bench.py's mixed graph (SNPs, indels, multi-allelic and nested sites). Every fallback bit is forced once through a
budget patched in both packages (``buffer_caps``, ``MAX_CHAIN``,
``KCAP``, ``trip_cap``), crafted first draws (``FB_RNG``) or crafted
paths (``FB_DUP_SITE``, ``FB_CONFLICT``). Integers throughout:
tolerance 0.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gramtools_tpu.index.build import build_prg_index
from gramtools_tpu.index.kmer_index_vec import build_kmer_index_vectorised
from gramtools_tpu.mapping import record_jax as rj
from gramtools_tpu.mapping import search_jax_log as jsl
from gramtools_tpu.mapping.device_index import DeviceIndex as JaxDeviceIndex
from gramtools_tpu.mapping.quasimap import QuasimapStats
from gramtools_tpu.prg.linearise import PrgString, prg_string_to_ints
from gramtools_tpu.common.rng import RandomInclusiveInt, first_raw_draws
from gramtools_tpu_torch.mapping import engine as engine_mod
from gramtools_tpu_torch.mapping import record as tr
from gramtools_tpu_torch.mapping import search_log as tsl
from gramtools_tpu_torch.mapping import search_log_host as host
from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
from gramtools_tpu_torch.ops import walk as walk_ops

from bench import build_mixed_graph, sample_haplotypes, sample_reads
from test_search_jax import HARD_NESTED_PRGS, random_prg


def _graph(kind):
    """(idx, reads) of one graph kind: "sites" is bench.py's mixed graph
    (SNPs, indels, multi-allelic and nested sites) with 60 bp reads from
    sampled haplotypes; "nested" and "random" are the nested PRGs of
    tests/test_search_jax.py with short reads cut from the PRG's bases,
    plus random ones."""
    if kind == "sites":
        rng = np.random.RandomState(7)
        prg_ints = build_mixed_graph(rng, 3000, 120)
        prg = PrgString(prg_ints)
        paths = sample_haplotypes(prg_ints, dict(prg.end_positions), rng, 4)
        reads = list(sample_reads(rng, paths, 90, 60))
        return build_prg_index(prg), reads
    if kind == "nested":
        prg_str = HARD_NESTED_PRGS[1] + "ACGTTGCA" + HARD_NESTED_PRGS[0]
    else:
        prg_str = random_prg(np.random.RandomState(4), nested=True)
    idx = build_prg_index(PrgString(prg_string_to_ints(prg_str)))
    rng = np.random.RandomState(11)
    dna = idx.prg[(idx.prg >= 1) & (idx.prg <= 4)].astype(np.uint8)
    n, lens = 80, (5, 14)
    out = []
    for _ in range(n):
        ln = min(int(rng.randint(*lens)), dna.size)
        s = rng.randint(0, dna.size - ln + 1)
        out.append(dna[s:s + ln].copy())
    out += [rng.randint(1, 5, size=lens[0]).astype(np.uint8)
            for _ in range(n // 8)]
    return idx, out


class Case:
    """One captured fused dispatch, with both packages' tables."""

    def __init__(self, kind, monkeypatch):
        idx, reads = _graph(kind)
        self.k = k = 3 if kind != "sites" else 7
        kmer_index = build_kmer_index_vectorised(idx, k)
        eng = LogBatchedEngine(idx, k, host.LogConfig(pool=4096, hits=1024),
                               device="cpu")
        captured = {}

        def capture(*args, **kwargs):
            captured["args"] = args
            return tsl.log_search_record(*args, **kwargs)

        monkeypatch.setattr(engine_mod, "log_search_record", capture)
        if kind != "sites":
            # wide steps to the end: several states per row survive, so
            # classes, encapsulated splits and the pick all have work
            monkeypatch.setenv("GRAMTOOLS_TPU_NARROW", "0")
        seeds = RandomInclusiveInt(5).raw_block(len(reads))
        first = first_raw_draws(np.asarray(seeds, dtype=np.uint32))
        eng.scan_submit(reads, kmer_index, k, QuasimapStats(),
                        first_raws=first)
        monkeypatch.undo()
        (di, rt, st, reads_p, slot_sidx, slot_row, row_ok, row_first,
         row_len, _cov, phases, R, trip_cap, _k) = captured["args"]
        self.tdi, self.trt, self.tst = di, rt, st
        self.np = dict(reads_p=reads_p.numpy(), slot_sidx=slot_sidx.numpy(),
                       slot_row=slot_row.numpy(), row_ok=row_ok.numpy(),
                       row_first=row_first.numpy(), row_len=row_len.numpy())
        self.phases, self.R, self.trip_cap = phases, R, trip_cap
        self.jdi = JaxDeviceIndex.build(idx, eng.jt)
        self.jrt = rj.RecordTables.build(idx)
        self.jst = rj.SeedTables.build(kmer_index)
        self.cov_size = rt.cov_size
        # the scan's outputs (its parity with JAX is tests/test_torch_scan.py)
        a = self.np
        steps = sum(e[0] for e in phases)
        reads_t = tsl.unpack_reads2(torch.from_numpy(a["reads_p"]),
                                    torch.from_numpy(a["row_len"]), steps, k)
        ok = torch.from_numpy(a["slot_sidx"]) >= 0
        sidc = torch.from_numpy(a["slot_sidx"]).clamp(0, st.n_states - 1)
        carry = (torch.where(ok, torch.from_numpy(a["slot_row"]), -1),
                 torch.where(ok, st.k_lo[sidc], 0),
                 torch.where(ok, st.k_hi[sidc], 0),
                 torch.where(ok, -(torch.from_numpy(a["slot_sidx"]) + 1), 0),
                 torch.zeros(R, dtype=torch.bool))
        L = tsl._log_length(di, phases)
        lp = torch.empty(L, dtype=torch.int32)
        le = torch.empty(L, dtype=torch.int32)
        out = tsl._scan_phases(di, reads_t, carry, phases, R, None, lp, le)
        self.scan = [t.numpy() for t in out] + [lp.numpy(), le.numpy()]

    def replay_pair(self):
        rid, lo, hi, pref, ovf, lp, le = self.scan
        alive = rid >= 0
        j = rj.replay_device(self.jdi, jnp.asarray(pref), jnp.asarray(lp),
                             jnp.asarray(le), self.jst, jnp.asarray(alive))
        t = tr.replay_device(self.tdi, torch.from_numpy(pref),
                             torch.from_numpy(lp), torch.from_numpy(le),
                             self.tst, torch.from_numpy(alive))
        return [np.array(x) for x in j], [x.numpy() for x in t]

    def select_pair(self, replayed=None, row_first=None, trip_cap=None):
        """Both packages' select_and_record_device on the same inputs.
        Returns (jax outputs, torch outputs), cov_diff last in each."""
        rid, lo, hi, pref, ovf, lp, le = self.scan
        if replayed is None:
            replayed = self.replay_pair()[0]
        trav, n_trav, ing, n_ing, bad = replayed
        row_ok = self.np["row_ok"] & ~ovf
        if row_first is None:
            row_first = self.np["row_first"]
        trip_cap = self.trip_cap if trip_cap is None else trip_cap
        cov0 = np.zeros(self.cov_size + 1, np.int32)
        j = rj.select_and_record_device(
            self.jdi, self.jrt, *(jnp.asarray(x) for x in (
                rid, lo, hi, trav, n_trav, ing, n_ing, bad, row_ok,
                row_first.astype(np.uint32), self.np["row_len"], cov0)),
            trip_cap=trip_cap)
        cov_t = torch.from_numpy(cov0.copy())
        t = tr.select_and_record_device(
            self.tdi, self.trt, *(torch.from_numpy(np.ascontiguousarray(x))
                                  for x in (rid, lo, hi, trav, n_trav, ing,
                                            n_ing, bad, row_ok, row_first,
                                            self.np["row_len"])),
            cov_t, trip_cap=trip_cap)
        return ([np.asarray(x) for x in j],
                [x.numpy() for x in t] + [cov_t.numpy()])

    def fused_pair(self, trip_cap=None):
        trip_cap = self.trip_cap if trip_cap is None else trip_cap
        a = self.np
        cov0 = np.zeros(self.cov_size + 1, np.int32)
        j_flat, j_cov = jsl._record_body(
            self.jdi, self.jrt, self.jst, jnp.asarray(a["reads_p"]),
            jnp.asarray(a["slot_sidx"]), jnp.asarray(a["slot_row"]),
            jnp.asarray(a["row_ok"]),
            jnp.asarray(a["row_first"].astype(np.uint32)),
            jnp.asarray(a["row_len"]), jnp.asarray(cov0), self.phases,
            self.R, trip_cap, self.k)
        cov_t = torch.from_numpy(cov0.copy())
        t_flat = tsl.log_search_record(
            self.tdi, self.trt, self.tst,
            *(torch.from_numpy(a[n]) for n in ("reads_p", "slot_sidx",
                                               "slot_row", "row_ok",
                                               "row_first", "row_len")),
            cov_t, self.phases, self.R, trip_cap, self.k)
        return (np.asarray(j_flat), np.asarray(j_cov)), (t_flat.numpy(),
                                                         cov_t.numpy())


def _assert_all_equal(j, t):
    assert len(j) == len(t)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module", params=["sites", "nested", "random"])
def case(request):
    mp = pytest.MonkeyPatch()
    try:
        return Case(request.param, mp)
    finally:
        mp.undo()


def test_replay_equal(case):
    j, t = case.replay_pair()
    _assert_all_equal(j, t)
    assert (t[1] > 0).any() or (t[3] > 0).any()     # real paths replayed


def test_select_and_record_equal(case):
    j, t = case.select_pair()
    _assert_all_equal(j, t)
    assert t[1].any() and t[-1].any()         # rows mapped, coverage added


def test_fused_flat_result_equal(case):
    (j_flat, j_cov), (t_flat, t_cov) = case.fused_pair()
    np.testing.assert_array_equal(j_flat, t_flat)
    np.testing.assert_array_equal(j_cov, t_cov)
    R = case.R
    assert t_flat[2 * R:3 * R].any()          # mapped rows


def test_replay_max_chain_patched(case, monkeypatch):
    monkeypatch.setattr(rj, "MAX_CHAIN", 1)
    monkeypatch.setattr(tr, "MAX_CHAIN", 1)
    j, t = case.replay_pair()
    _assert_all_equal(j, t)


def _caps(ecap=None, trcap=None, wcap=None, emitcap=None, lcap=None):
    def caps(R):
        base = host.buffer_caps(R)
        return tuple(b if v is None else v for b, v in
                     zip(base, (ecap, trcap, wcap, emitcap, lcap)))
    return caps


# each fallback bit and the patch that forces it on the site graph
FORCED = {
    "chain_depth": dict(max_chain=1),
    "encapsulated_spill": dict(caps=_caps(ecap=2)),
    "traversing_spill": dict(caps=_caps(trcap=2)),
    "kcap": dict(kcap=1),
    "rng_rejection": dict(rng=True),
    "trip_spill": dict(trip_cap=16),
    "walk_spill": dict(caps=_caps(wcap=8)),
    "emit_spill": dict(caps=_caps(emitcap=4)),
    "loci_spill": dict(caps=_caps(lcap=8)),
}


@pytest.fixture(scope="module")
def site_case():
    mp = pytest.MonkeyPatch()
    try:
        return Case("sites", mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("name", sorted(FORCED))
def test_forced_fallback_bit(site_case, name, monkeypatch):
    """Every budget bit a small input can reach, forced through the same
    patch in both packages; outputs stay equal and the bit fires."""
    spec = FORCED[name]
    if "caps" in spec:
        monkeypatch.setattr(rj, "buffer_caps", spec["caps"])
        monkeypatch.setattr(tr, "buffer_caps", spec["caps"])
    if "max_chain" in spec:
        monkeypatch.setattr(rj, "MAX_CHAIN", spec["max_chain"])
        monkeypatch.setattr(tr, "MAX_CHAIN", spec["max_chain"])
    if "kcap" in spec:
        monkeypatch.setattr(rj, "KCAP", spec["kcap"])
        monkeypatch.setattr(tr, "KCAP", spec["kcap"])
    row_first = None
    if spec.get("rng"):
        # the top draw 2**32 - 1 lands in the rejection branch whenever
        # the row's choice count does not divide 2**32 - 1 (e.g. 2)
        row_first = site_case.np["row_first"].copy()
        row_first[::3] = (1 << 32) - 1
    replayed = [x for x in site_case.replay_pair()[0]]
    j, t = site_case.select_pair(replayed=replayed, row_first=row_first,
                                 trip_cap=spec.get("trip_cap"))
    _assert_all_equal(j, t)
    bit = {v: k for k, v in host.FB_NAMES.items()}[name]
    assert ((t[0] & bit) != 0).any(), f"{name} did not fire"
    if name not in ("rng_rejection",):
        (j_flat, j_cov), (t_flat, t_cov) = site_case.fused_pair(
            trip_cap=spec.get("trip_cap"))
        np.testing.assert_array_equal(j_flat, t_flat)
        np.testing.assert_array_equal(j_cov, t_cov)


@pytest.mark.parametrize("name", ["dup_site", "allele_conflict"])
def test_crafted_path_fallback_bit(site_case, name):
    """A state whose path repeats a site (dup_site) or names two alleles
    of one site (allele_conflict, with dup_site): crafted into real
    replay outputs, fed to both packages."""
    trav, n_trav, ing, n_ing, bad = [np.array(x) for x in
                                     site_case.replay_pair()[0]]
    rid = site_case.scan[0]
    cand = np.flatnonzero((rid >= 0) & (n_trav >= 1) & (n_trav < rj.TCAP))
    assert cand.size
    pick = cand[::2]
    dup = trav[pick, 0].copy()
    if name == "allele_conflict":
        dup[:, 1] += 1
    trav[pick, n_trav[pick]] = dup
    n_trav[pick] += 1
    j, t = site_case.select_pair(replayed=(trav, n_trav, ing, n_ing, bad))
    _assert_all_equal(j, t)
    bit = {v: k for k, v in host.FB_NAMES.items()}[name]
    assert ((t[0] & bit) != 0).any(), f"{name} did not fire"


@pytest.mark.parametrize("caps", [(None, None), (16, None), (None, 16)],
                         ids=["default", "wcap16", "emitcap16"])
def test_record_per_base_equal(site_case, caps):
    """_record_per_base_device alone: the replayed pool states of the
    site graph, every other live state selected, walked and enveloped
    into cov_diff by both packages (K9's twin in the port)."""
    rid, lo, hi = site_case.scan[:3]
    trav, n_trav = site_case.replay_pair()[1][:2]
    R = site_case.R
    wcap = caps[0] or host.buffer_caps(R)[2]
    emitcap = caps[1] or host.buffer_caps(R)[3]
    sel = (rid >= 0) & (np.arange(rid.size) % 2 == 0)
    ins = (np.clip(rid, 0, R - 1).astype(np.int32), lo, hi, trav, n_trav,
           sel, site_case.np["row_len"], np.zeros(R, np.int32))
    cov0 = np.zeros(site_case.cov_size + 1, np.int32)
    j_cov, j_fb = rj._record_per_base_device(
        site_case.jdi, site_case.jrt, *(jnp.asarray(x) for x in ins[:-1]),
        jnp.asarray(ins[-1]), jnp.asarray(cov0), wcap, emitcap)
    t_cov = torch.from_numpy(cov0.copy())
    t_fb = tr._record_per_base_device(
        site_case.tdi, site_case.trt, *(torch.from_numpy(x) for x in ins),
        t_cov, wcap, emitcap)
    np.testing.assert_array_equal(np.asarray(j_fb), t_fb.numpy())
    np.testing.assert_array_equal(np.asarray(j_cov), t_cov.numpy())
    if caps == (None, None):
        assert t_cov.numpy().any() and not t_fb.numpy().any()
    else:
        assert t_fb.numpy().any()


def test_walk_emissions_do_not_depend_on_lane_order(site_case):
    """K9's contract: the emitted (row, node, start, end) multiset does
    not depend on the lane order (the kernel emits in atomic order)."""
    rt = site_case.trt
    lanes = 96
    rng = np.random.RandomState(3)
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32))
    args = dict(
        valid=torch.from_numpy(rng.rand(lanes) < 0.9),
        cur0=i32(rng.randint(0, rt.n_nodes, lanes)),
        start0=i32(np.zeros(lanes)),
        remaining0=i32(rng.randint(1, 60, lanes)),
        trav_idx0=i32(rng.randint(0, 4, lanes)),
        w_item=i32(rng.randint(0, 4, lanes)),
        read_of=i32(np.arange(lanes)),
        full=torch.from_numpy(rng.rand(lanes) < 0.5))
    ps_trav = i32(rng.randint(0, 2, (4, rj.TCAP, 2)))
    perm = torch.from_numpy(rng.permutation(lanes))
    runs = []
    for order in (torch.arange(lanes), perm):
        emits, spill = walk_ops.walk(
            rt.nt_walk, rt.nt_edges, *(args[k][order] for k in (
                "valid", "cur0", "start0", "remaining0", "trav_idx0",
                "w_item", "read_of", "full")), ps_trav, emitcap=4096,
            max_iter=rt.n_nodes + 2)
        assert not bool(spill)
        runs.append(sorted(map(tuple, emits.numpy().tolist())))
    assert runs[0] == runs[1]
    assert sum(r[0] < walk_ops.BIG for r in runs[0]) > 0
