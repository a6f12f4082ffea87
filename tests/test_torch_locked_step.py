"""The slot-locked scan tail (ops/locked_step.py) against the JAX engine.

``locked_tail`` on CPU tensors (its plain twin) against the JAX
package's ``_lock_pool`` followed by ``jax.lax.scan`` over
``_build_narrow_step(locked=True)``, on the same numpy-seeded carry and
reads: the final carry, the overflow flags and every log record of the
range, the empty hit slots included, bit for bit (all integers:
tolerance 0). Dense and packed rank (JAX's packed rank runs the K1
Pallas kernel in interpret mode), a marker-site graph and a nested one,
and budgets tight enough that wide states and hits spill, newborns
conflict, reads hold two states at lock time and a step has no hit at
all. Then the phase loop: the narrow and locked phases go through one
``locked_tail`` call, and the flat result equals
``_log_search_packed``'s; injected gathers keep the torch locked step.
Last, what the CUDA kernel's barrier-free locked range rests on, held on
the JAX package's steps and on the twin alike: a dead slot stays dead;
with budgets that do not bind, a slot's read_id, lo, hi and overflow
flag do not depend on the other slots; the empty hit records carry the
pref of the last slot with hits (slot 0's when a step has none).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gramtools_tpu.mapping import search_jax_log as jsl
from gramtools_tpu.mapping.device_index import DeviceIndex as JaxDeviceIndex
from gramtools_tpu.mapping.jump_table import build_jump_table
from gramtools_tpu.ops.rank import build_packed_occ as jax_packed_occ
from gramtools_tpu_torch.mapping import scan_steps, search_log
from gramtools_tpu_torch.mapping.device_index import DeviceIndex
from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
from gramtools_tpu_torch.mapping.quasimap import QuasimapStats
from gramtools_tpu_torch.mapping.search_log import (log_search_packed,
                                                    log_search_phases)
from gramtools_tpu_torch.mapping.search_log_host import LogConfig
from gramtools_tpu_torch.ops import locked_step
from gramtools_tpu_torch.ops.rank import blocks_tensor

from test_torch_scan import (_graph, _indexes, _random_carry, _seeded_buffer,
                             _to_jax, _to_torch)
from test_torch_twins import twin_kmer_index

# (hits G, wide budget W): "roomy" never spills a wide state (W = R);
# "tight" spills wide states and hits every step
BUDGETS = {"roomy": (256, 96), "tight": (1, 8)}
R = 96          # reads = pool slots
N_IN = 120      # the incoming pool: more states than reads
STEPS = 5
EMPTY_STEP = 2  # every base 0: no active state, no hit
LOG_BASE = 40


def _case(kind, rank, budget):
    j_idx, idx = _graph(kind)
    jdi, tdi, j_rows, t_rows = _indexes(j_idx, idx, rank)
    rng = np.random.RandomState(len(kind) * 7 + len(rank) + len(budget))
    carry = _random_carry(rng, jdi.size, N_IN, R)
    reads = rng.randint(0, 5, size=(STEPS, R)).astype(np.int32)
    reads[EMPTY_STEP] = 0
    blocks = None
    if rank == "packed":
        blocks = blocks_tensor(jax_packed_occ(j_idx.fm), "cpu")
    return jdi, tdi, j_rows, carry, reads, blocks


def _jax_tail(jdi, j_rows, carry, reads, G, W, lock=True, log_base=LOG_BASE):
    """_lock_pool, then lax.scan over the JAX locked step: (carry,
    (log parents, log events) of shape (steps, G, B))."""
    step = jsl._build_narrow_step(jdi, jsl.LogConfig(pool=R, hits=G), R, W,
                                  occ_rows=j_rows, locked=True)
    bases = log_base + np.arange(reads.shape[0], dtype=np.int32) * (
        G * jdi.n_outcomes)

    @jax.jit
    def run(c, xs):
        if lock:
            c = jsl._lock_pool(c, R, R)
        return jax.lax.scan(step, c, xs)

    return run(_to_jax(carry), (jnp.asarray(reads), jnp.asarray(bases)))


def _log(G, B, steps=STEPS):
    """Fresh log halves with a sentinel, room around the range."""
    n = LOG_BASE + steps * G * B + 9
    return (torch.full((n,), -7, dtype=torch.int32),
            torch.full((n,), -7, dtype=torch.int32))


@pytest.mark.parametrize("budget", ["roomy", "tight"])
@pytest.mark.parametrize("rank", ["dense", "packed"])
@pytest.mark.parametrize("kind", ["sites", "nested"])
def test_locked_tail_matches_jax(kind, rank, budget, monkeypatch):
    G, W = BUDGETS[budget]
    jdi, tdi, j_rows, carry, reads, blocks = _case(kind, rank, budget)
    B = jdi.n_outcomes
    j_carry, (j_par, j_ev) = _jax_tail(jdi, j_rows, carry, reads, G, W)

    # the twin's hit stage, watched: newborns a read, spilled states
    seen = []
    hits_and_newborns = scan_steps._hits_and_newborns

    def watch(*args, **kwargs):
        out = hits_and_newborns(*args, **kwargs)
        spilled, cand_ok, c_rid = out[0], out[1], out[5]
        nb = torch.zeros(R + 1, dtype=torch.int64).index_add_(
            0, torch.where(cand_ok, c_rid, R).reshape(-1).long(),
            torch.ones(cand_ok.numel(), dtype=torch.int64))[:R]
        seen.append((int((nb > 1).sum()), int(spilled.sum())))
        return out

    monkeypatch.setattr(scan_steps, "_hits_and_newborns", watch)
    lp, le = _log(G, B)
    t_carry = locked_step.locked_tail(
        tdi, torch.from_numpy(reads), _to_torch(carry), LOG_BASE, lp, le, G,
        W, blocks=blocks)

    for t, j in zip(t_carry[:4], j_carry[:4]):
        assert t.dtype == torch.int32 and t.shape == (R,)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(t_carry[4][:R].numpy(),
                                  np.asarray(j_carry[4]))
    assert not bool(t_carry[4][R])            # the dump slot stays clear
    end = LOG_BASE + STEPS * G * B
    np.testing.assert_array_equal(lp[LOG_BASE:end].numpy(),
                                  np.asarray(j_par).reshape(-1))
    np.testing.assert_array_equal(le[LOG_BASE:end].numpy(),
                                  np.asarray(j_ev).reshape(-1))
    for half in (lp, le):                      # nothing written outside
        assert (half[:LOG_BASE] == -7).all() and (half[end:] == -7).all()

    # the cases the budgets force took place
    j_lock = jsl._lock_pool(_to_jax(carry), R, R)
    assert np.asarray(j_lock[4]).sum() > carry[4].sum()   # two states a read
    ev = np.asarray(j_ev)[EMPTY_STEP]                     # total == 0
    np.testing.assert_array_equal(ev, np.broadcast_to(np.arange(B), ev.shape))
    assert len(seen) == STEPS and seen[EMPTY_STEP] == (0, 0)
    if budget == "roomy":
        assert sum(c for c, _ in seen) > 0                # newborn conflicts
    else:
        lo, hi = np.asarray(j_lock[1]), np.asarray(j_lock[2])
        wide = (np.asarray(j_lock[0]) >= 0) & (reads[0] > 0) & (lo != hi)
        assert wide.sum() > W                             # spill_w
        assert sum(s for _, s in seen) > 0                # spilled
        assert np.asarray(j_carry[4]).sum() > np.asarray(j_lock[4]).sum()


@pytest.mark.parametrize("rank", ["dense", "packed"])
def test_locked_tail_range_split_equals_whole(rank):
    """Steps [0, 2) with the lock, then [2, STEPS) on the locked carry
    (lock=False): the carry and the log of one call over [0, STEPS)."""
    G, W = BUDGETS["roomy"]
    jdi, tdi, j_rows, carry, reads, blocks = _case("sites", rank, "split")
    B = jdi.n_outcomes
    lp, le = _log(G, B)
    whole = locked_step.locked_tail(tdi, torch.from_numpy(reads),
                                    _to_torch(carry), LOG_BASE, lp, le, G, W,
                                    blocks=blocks)
    lp2, le2 = _log(G, B)
    part = locked_step.locked_tail(tdi, torch.from_numpy(reads[:2]),
                                   _to_torch(carry), LOG_BASE, lp2, le2, G, W,
                                   blocks=blocks)
    part = locked_step.locked_tail(tdi, torch.from_numpy(reads[2:]), part,
                                   LOG_BASE + 2 * G * B, lp2, le2, G, W,
                                   blocks=blocks, lock=False)
    for a, b in zip(whole, part):
        assert torch.equal(a, b)
    assert torch.equal(lp, lp2) and torch.equal(le, le2)
    # and JAX's locked steps over [2, STEPS) from its carry after 2
    j_mid, _ = _jax_tail(jdi, j_rows, carry, reads[:2], G, W)
    j_end, (j_par, j_ev) = _jax_tail(
        jdi, j_rows, tuple(np.asarray(a) for a in j_mid), reads[2:], G, W,
        lock=False, log_base=LOG_BASE + 2 * G * B)
    for t, j in zip(part, j_end):
        np.testing.assert_array_equal(t[:R].numpy(), np.asarray(j))
    rng = slice(LOG_BASE + 2 * G * B, LOG_BASE + STEPS * G * B)
    np.testing.assert_array_equal(lp2[rng].numpy(),
                                  np.asarray(j_par).reshape(-1))
    np.testing.assert_array_equal(le2[rng].numpy(),
                                  np.asarray(j_ev).reshape(-1))


@pytest.mark.parametrize("budget", ["auto", "tight"])
@pytest.mark.parametrize("rank", ["dense", "packed"])
def test_scan_phases_runs_locked_phase_through_locked_tail(rank, budget,
                                                           monkeypatch):
    """log_search_packed on a buffer whose plan ends in a hole-allocated
    narrow phase and a locked phase (auto_phases' budgets, or hits 4 and
    wide budget 2 in the locked phase): one locked_tail call for both
    phases, and the flat result equal to JAX's _log_search_packed."""
    monkeypatch.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", rank)
    j_idx, idx = _graph("sites")
    k = 5
    kmer_index = twin_kmer_index(j_idx, idx, k)[1]
    engine = LogBatchedEngine(idx, k, LogConfig(pool=4096, hits=16))
    reads = _seeded_buffer(idx, k, 160, 50, seed=11)
    token = engine.scan_submit(reads, kmer_index, k, QuasimapStats())
    _, _, (_, phases, Rb), _, _, carry, reads_T = token
    assert jsl._phase4(phases[-1])[4] == "locked"
    if budget == "tight":
        n, pool = phases[-1][:2]
        phases = tuple(phases[:-1]) + ((n, pool, 4, 2, "locked"),)
    calls = []
    tail = search_log.locked_tail

    def counted(*args, **kwargs):
        calls.append((tuple(args[1].shape), kwargs["narrow"]))
        return tail(*args, **kwargs)

    monkeypatch.setattr(search_log, "locked_tail", counted)
    tdi = DeviceIndex.build(idx, engine.jt, "cpu")
    blocks = engine.blocks if rank == "packed" else None
    got = log_search_packed(tdi, torch.from_numpy(reads_T),
                            tuple(torch.from_numpy(a) for a in carry), phases,
                            Rb, blocks=blocks, rank=rank).numpy()
    narrow = jsl._phase4(phases[-2])
    assert narrow[3] > 0 and narrow[4] == ""
    assert calls == [((narrow[0] + phases[-1][0], Rb), narrow[:4])]
    jdi = JaxDeviceIndex.build(j_idx, build_jump_table(j_idx))
    j_blocks = (jnp.asarray(jax_packed_occ(j_idx.fm)) if rank == "packed"
                else None)
    want = np.asarray(jsl._log_search_packed(
        jdi, jnp.asarray(reads_T), _to_jax(carry), phases, Rb,
        blocks=j_blocks, rank=rank))
    np.testing.assert_array_equal(got, want)
    (rid, _, _, _, ovf), lp, _ = jsl._unpack_result(want, phases, Rb,
                                                    jdi.n_outcomes)
    assert ovf.any() and (rid >= 0).any() and (lp >= 0).any()


def test_injected_gathers_keep_the_torch_locked_step(monkeypatch):
    """An injected occ gather (as the SA-range-sharded index passes)
    runs the locked phase as torch steps, with the same result."""
    monkeypatch.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", "dense")
    j_idx, idx = _graph("sites")
    k = 5
    kmer_index = twin_kmer_index(j_idx, idx, k)[1]
    engine = LogBatchedEngine(idx, k, LogConfig(pool=4096, hits=16))
    token = engine.scan_submit(_seeded_buffer(idx, k, 120, 50, seed=4),
                               kmer_index, k, QuasimapStats())
    _, _, (_, phases, Rb), _, _, carry, reads_T = token
    tdi = DeviceIndex.build(idx, engine.jt, "cpu")
    calls = []
    tail = search_log.locked_tail
    monkeypatch.setattr(search_log, "locked_tail",
                        lambda *a, **kw: calls.append(1) or tail(*a, **kw))
    args = (tdi, torch.from_numpy(reads_T),
            tuple(torch.from_numpy(a) for a in carry), phases, Rb)
    own = log_search_phases(*args)
    assert len(calls) == 1
    injected = log_search_phases(*args, occ_rows=scan_steps.dense_occ_rows(tdi))
    assert len(calls) == 1
    for a, b in zip(own[0] + own[1], injected[0] + injected[1]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# what the CUDA kernel's locked range rests on: a locked step is
# slot-local but for the wide rank, the hit rank and the empty hit records
# --------------------------------------------------------------------------

IMPLS = ["jax", "twin"]


def _locked_steps(impl, jdi, tdi, j_rows, blocks, carry, reads, G, W,
                  kill=None):
    """The lock, then the locked steps one by one, on ``impl``: the JAX
    package's _lock_pool and locked step under lax.scan, or the twin
    (``locked_tail`` a step at a time). ``kill`` (R,) bool clears those
    slots' read_id right after the lock. Returns (the carry before each
    step and after the last, as numpy tuples; log parents and events,
    (steps, G·B) each)."""
    B = jdi.n_outcomes
    S = reads.shape[0]
    if impl == "jax":
        step = jsl._build_narrow_step(jdi, jsl.LogConfig(pool=R, hits=G), R,
                                      W, occ_rows=j_rows, locked=True)
        bases = LOG_BASE + np.arange(S, dtype=np.int32) * (G * B)

        @jax.jit
        def run(c, xs):
            c = jsl._lock_pool(c, R, R)
            if kill is not None:
                c = (jnp.where(jnp.asarray(kill), -1, c[0]),) + tuple(c[1:])

            def body(c, x):
                c2, recs = step(c, x)
                return c2, (c, recs)

            return jax.lax.scan(body, c, xs)

        last, (before, (par, ev)) = run(_to_jax(carry),
                                        (jnp.asarray(reads),
                                         jnp.asarray(bases)))
        carries = [tuple(np.asarray(a[t]) for a in before) for t in range(S)]
        carries.append(tuple(np.asarray(a) for a in last))
        return carries, (np.asarray(par).reshape(S, -1),
                         np.asarray(ev).reshape(S, -1))
    lp, le = _log(G, B, S)
    t_reads = torch.from_numpy(reads)
    c = locked_step.locked_tail(tdi, t_reads[:0], _to_torch(carry), LOG_BASE,
                                lp, le, G, W, blocks=blocks)
    if kill is not None:
        c = (torch.where(torch.from_numpy(kill), -1, c[0]),) + tuple(c[1:])
    carries = [c]
    for t in range(S):
        c = locked_step.locked_tail(tdi, t_reads[t:t + 1], c,
                                    LOG_BASE + t * G * B, lp, le, G, W,
                                    blocks=blocks, lock=False)
        carries.append(c)
    carries = [tuple(a.numpy()[:R] for a in c) for c in carries]
    end = LOG_BASE + S * G * B
    return carries, (lp[LOG_BASE:end].numpy().reshape(S, -1),
                     le[LOG_BASE:end].numpy().reshape(S, -1))


def _hit_counts(jdi, carry, row, W):
    """Each slot's marker hits in one locked step from the carry before
    it, computed in numpy from the dense tables: a single state at a
    marker has one, a covered wide state the markers of its interval."""
    rid, lo, hi = (np.asarray(a).astype(np.int64) for a in carry[:3])
    occ = np.asarray(jdi.occ).astype(np.int64)
    n = jdi.size
    sent = int(np.asarray(jdi.sentinel_row))
    active = (rid >= 0) & (row > 0)
    single = lo == hi
    wide = active & ~single
    covered = single | (wide & (np.cumsum(wide) - wide < W))
    sym = np.asarray(jdi.narrow_tab)[np.clip(lo, 0, n - 1)] >> 24
    hi1 = hi + 1
    markers = ((hi1 - occ[np.clip(hi1, 0, n)].sum(1) - (hi1 > sent))
               - (lo - occ[np.clip(lo, 0, n)].sum(1) - (lo > sent)))
    return np.where(active & covered,
                    np.where(single, sym == 5, markers), 0)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("rank", ["dense", "packed"])
@pytest.mark.parametrize("kind", ["sites", "nested"])
def test_locked_dead_slot_stays_dead(kind, rank, impl):
    """A slot dead after the lock, or after any locked step, keeps its
    row (read_id -1, lo, hi, pref) and its overflow flag to the end of
    the range: no newborn lands in it, since a newborn lands in its
    owner's slot and a dead slot owns no hit."""
    G, W = BUDGETS["roomy"]
    jdi, tdi, j_rows, carry, reads, blocks = _case(kind, rank, "roomy")
    carries, _ = _locked_steps(impl, jdi, tdi, j_rows, blocks, carry, reads,
                               G, W)
    died_later = 0
    for t in range(len(carries) - 1):
        dead = carries[t][0] < 0
        for c in carries[t + 1:]:
            for a, b in zip(carries[t], c):
                np.testing.assert_array_equal(np.asarray(b)[dead],
                                              np.asarray(a)[dead])
        if t > 0:
            died_later += int((dead & ~(carries[t - 1][0] < 0)).sum())
    assert (carries[0][0] < 0).any() and died_later > 0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("rank", ["dense", "packed"])
@pytest.mark.parametrize("kind", ["sites", "nested"])
def test_locked_slot_independent_of_other_slots(kind, rank, impl):
    """With budgets that do not bind (W = R, G above every step's hits),
    a slot's read_id, lo, hi and overflow flag after each step, the last
    included, are the same when every other slot is killed at the lock:
    only pref and the log positions depend on the other slots, through
    the hit rank."""
    G, W = 2048, R
    jdi, tdi, j_rows, carry, reads, blocks = _case(kind, rank, "free")
    kill = np.arange(R) % 2 == 1
    full, log = _locked_steps(impl, jdi, tdi, j_rows, blocks, carry, reads,
                              G, W)
    alone, log_alone = _locked_steps(impl, jdi, tdi, j_rows, blocks, carry,
                                     reads, G, W, kill=kill)
    for t, c in enumerate(full[:-1]):         # the budgets never bind
        assert _hit_counts(jdi, c, reads[t], W).sum() < G
    kept = ~kill
    for a, b in zip(alone[1:], full[1:]):     # after each step
        for f in (0, 1, 2, 4):                # read_id, lo, hi, overflow
            np.testing.assert_array_equal(np.asarray(a[f])[kept],
                                          np.asarray(b[f])[kept])
    assert (full[1][0][kept] >= 0).any()
    # the log does depend on the killed slots' hits
    assert not np.array_equal(log[0], log_alone[0])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("rank", ["dense", "packed"])
@pytest.mark.parametrize("kind", ["sites", "nested"])
def test_locked_empty_hit_records_carry_last_pref(kind, rank, impl):
    """The hit records g in [min(total, G), G) of each locked step carry
    the pref of the last slot with hits (of slot 0 when the step has no
    hit) and the event of locus 0: the broadcast the kernel's chained
    scan carries to the tile that closes the step."""
    G, W = BUDGETS["roomy"]
    jdi, tdi, j_rows, carry, reads, blocks = _case(kind, rank, "roomy")
    B = jdi.n_outcomes
    carries, (par, ev) = _locked_steps(impl, jdi, tdi, j_rows, blocks, carry,
                                       reads, G, W)
    seen = set()
    for t in range(reads.shape[0]):
        cnt = _hit_counts(jdi, carries[t], reads[t], W)
        total = int(cnt.sum())
        nz = np.flatnonzero(cnt > 0)
        last = nz[-1] if total else 0
        lo_k = min(total, G) * B
        np.testing.assert_array_equal(
            par[t][lo_k:], np.full(G * B - lo_k, carries[t][3][last]))
        np.testing.assert_array_equal(ev[t][lo_k:],
                                      np.arange(lo_k, G * B) % B)
        # the records before it are the hits', each owner a slot with hits
        assert np.isin(par[t][:lo_k], carries[t][3][nz]).all()
        seen.add("none" if total == 0 else
                 "last before the end" if last < R - 1 else "last at end")
    assert {"none", "last before the end"} <= seen
