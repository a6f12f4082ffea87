"""The scan kernels' twins (ops/wide_step.py, ops/locked_step.py) against
the JAX engine, and the phase loop that calls them.

``wide_steps`` on CPU tensors (its plain twin) against the JAX package's
``_resize_pool`` and ``jax.lax.scan`` over ``_build_log_step`` for a warm
and a mid phase; ``locked_tail`` with a leading narrow range against
``_resize_pool``, ``lax.scan`` over ``_build_narrow_step(locked=False)``,
``_lock_pool`` and ``lax.scan`` over the locked step; each on the same
numpy-seeded carry and reads: the final carry, the overflow flags and
every log record of the range, the empty hit slots included, bit for
bit (all integers: tolerance 0). Dense and packed rank (JAX's packed
rank runs the K1 Pallas kernel in interpret mode), a marker-site graph
and a nested one, roomy budgets and tight ones (the resize slices live
states off, wide states and hits spill, the repack or the holes run out
and newborns are dropped), and a step with no hit at all. Then the phase
loop: each run of a plan (the wide phases; the narrow and locked phases)
goes through its wrapper once, under ``GRAMTOOLS_TPU_NARROW=0`` too, and
the flat result equals ``_log_search_packed``'s; the live-state probe
equals ``_log_search_probe``'s; injected gathers keep the torch steps.
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
                                                    log_search_phases,
                                                    log_search_probe)
from gramtools_tpu_torch.mapping.search_log_host import LogConfig
from gramtools_tpu_torch.ops import locked_step, wide_step
from gramtools_tpu_torch.ops.rank import blocks_tensor

from test_torch_scan import (_graph, _indexes, _seeded_buffer, _to_jax,
                             _to_torch)
from test_torch_twins import twin_kmer_index

R = 96            # reads
LOG_BASE = 40
EMPTY_STEP = 1    # every base 0: no active state, no hit


def _carry(rng, n, n_in, live, width):
    """A random incoming pool of n_in states, live states spread over
    every slot (so a shrinking resize slices live states off), their
    prefs negative as the seed states' are."""
    read_id = np.where(rng.rand(n_in) < live, rng.randint(0, R, size=n_in),
                       -1)
    lo = rng.randint(0, n, size=n_in)
    hi = np.minimum(lo + rng.choice(width, size=n_in), n - 1)
    pref = rng.randint(-900, 0, size=n_in)
    overflow = rng.rand(R) < 0.05
    return tuple(a.astype(np.int32) for a in (read_id, lo, hi, pref)) + (
        overflow,)


# the carry's live share and interval widths by budget; the tight
# carries are full of wide intervals, and their reads mostly padding
# (``zeros``, each step's share of padding bases), so that most states
# persist while a few make many hits
SHAPES = {"roomy": (0.85, (0, 0, 0, 1, 2, 5, 40, 300)),
          "tight": (1.0, (0, 40, 300))}


def _case(kind, rank, salt, n_in, steps, budget, zeros):
    """(jax DeviceIndex, torch DeviceIndex, jax occ_rows, carry, reads
    (steps, R) with one all-zero step, blocks)."""
    j_idx, idx = _graph(kind)
    jdi, tdi, j_rows, _ = _indexes(j_idx, idx, rank)
    live, width = SHAPES[budget]
    rng = np.random.RandomState(salt)
    carry = _carry(rng, jdi.size, n_in, live, width)
    reads = rng.randint(1, 5, size=(steps, R)).astype(np.int32)
    for i in range(steps):
        reads[i][rng.rand(R) < zeros[min(i, len(zeros) - 1)]] = 0
    reads[EMPTY_STEP] = 0
    blocks = None
    if rank == "packed":
        blocks = blocks_tensor(jax_packed_occ(j_idx.fm), "cpu")
    return jdi, tdi, j_rows, carry, reads, blocks


def _log(n_records):
    """Fresh log halves with a sentinel, room around the range."""
    n = LOG_BASE + n_records + 9
    return (torch.full((n,), -7, dtype=torch.int32),
            torch.full((n,), -7, dtype=torch.int32))


def _assert_run_equal(t_carry, j_carry, lp, le, j_logs, n_records):
    for t, j in zip(t_carry[:4], j_carry[:4]):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(t_carry[4][:R].numpy(),
                                  np.asarray(j_carry[4]))
    end = LOG_BASE + n_records
    j_par = np.concatenate([np.asarray(p).reshape(-1) for p, _ in j_logs])
    j_ev = np.concatenate([np.asarray(e).reshape(-1) for _, e in j_logs])
    np.testing.assert_array_equal(lp[LOG_BASE:end].numpy(), j_par)
    np.testing.assert_array_equal(le[LOG_BASE:end].numpy(), j_ev)
    for half in (lp, le):                      # nothing written outside
        assert (half[:LOG_BASE] == -7).all() and (half[end:] == -7).all()


def _watch_steps(monkeypatch, module):
    """Record [carry in, base row, newborn candidates, spilled states,
    newborns placed] of every step the module's twin runs."""
    seen = []
    run_steps = module.run_steps
    hits_and_newborns = scan_steps._hits_and_newborns

    def watched_hits(*args, **kwargs):
        out = hits_and_newborns(*args, **kwargs)
        seen[-1][2:4] = [int(out[1].sum()), int(out[0].sum())]
        return out

    def watched(step, carry, reads, log_base, lp, le, GB):
        def watched_step(c, row, base):
            seen.append([c, row, 0, 0, 0])
            out = step(c, row, base)
            # a newborn's pref is its log index, past every earlier one
            seen[-1][4] = int(((out[0][0] >= 0) & (out[0][3] >= base)).sum())
            return out
        return run_steps(watched_step, carry, reads, log_base, lp, le, GB)

    monkeypatch.setattr(module, "run_steps", watched)
    monkeypatch.setattr(scan_steps, "_hits_and_newborns", watched_hits)
    return seen


def _dropped(seen):
    """Whether a step placed fewer newborns than it had: the repack or
    the holes ran out."""
    return any(placed < n_cand for _, _, n_cand, _, placed in seen)


# --------------------------------------------------------------------------
# the wide run (K2's twin)
# --------------------------------------------------------------------------

# incoming states, the (steps, pool, hits) of a warm and a mid phase and
# each step's share of padding bases: "roomy" pads the pool first and
# never drops a state; "tight" slices live states off at both resizes,
# spills hits and drops in the repack
WIDE = {"roomy": (200, ((2, 256, 256), (3, 192, 64)), (0.0,)),
        "tight": (200, ((2, 160, 4), (3, 48, 64)), (0.2, 1.0, 0.9))}


def _jax_wide(jdi, j_rows, carry, reads, phases):
    B = jdi.n_outcomes
    steps = [jsl._build_log_step(jdi, jsl.LogConfig(pool=pool, hits=g), R,
                                 occ_rows=j_rows) for _, pool, g in phases]

    @jax.jit
    def run(c, reads):
        logs, off, base = [], 0, LOG_BASE
        for (s, pool, g), step in zip(phases, steps):
            c = jsl._resize_pool(c, pool, R)
            bases = base + jnp.arange(s, dtype=jnp.int32) * (g * B)
            c, log = jax.lax.scan(step, c, (reads[off:off + s], bases))
            logs.append(log)
            off, base = off + s, base + s * g * B
        return c, logs

    return run(_to_jax(carry), jnp.asarray(reads))


@pytest.mark.parametrize("budget", ["roomy", "tight"])
@pytest.mark.parametrize("rank", ["dense", "packed"])
@pytest.mark.parametrize("kind", ["sites", "nested"])
def test_wide_steps_match_jax(kind, rank, budget, monkeypatch):
    n_in, phases, zeros = WIDE[budget]
    S = sum(p[0] for p in phases)
    jdi, tdi, j_rows, carry, reads, blocks = _case(
        kind, rank, len(kind) + 3 * len(rank) + len(budget), n_in, S, budget,
        zeros)
    B = jdi.n_outcomes
    n_records = sum(s * g for s, _, g in phases) * B
    j_carry, j_logs = _jax_wide(jdi, j_rows, carry, reads, phases)
    seen = _watch_steps(monkeypatch, wide_step)
    lp, le = _log(n_records)
    t_carry = wide_step.wide_steps(tdi, torch.from_numpy(reads),
                                   _to_torch(carry), phases, LOG_BASE, lp, le,
                                   blocks=blocks)
    _assert_run_equal(t_carry, j_carry, lp, le, j_logs, n_records)
    assert t_carry[0].shape == (phases[-1][1],)
    assert len(seen) == S
    # the step with no hit: every record of it is (pref of state 0, b)
    ev = le[LOG_BASE + phases[0][2] * B:LOG_BASE + 2 * phases[0][2] * B]
    np.testing.assert_array_equal(ev.numpy(), np.tile(np.arange(B),
                                                      phases[0][2]))
    if budget == "tight":
        # live states sliced off, hits spilled, newborns dropped by the
        # repack, and flags raised
        assert (carry[0][phases[0][1]:] >= 0).any()
        assert any(spilled for _, _, _, spilled, _ in seen)
        assert _dropped(seen)
        assert np.asarray(j_carry[4]).sum() > carry[4].sum()


# --------------------------------------------------------------------------
# the narrow run, hole-allocated then locked (K3's twin)
# --------------------------------------------------------------------------

# incoming states, the narrow range (steps, pool, hits, wide budget), the
# locked steps and their (hits, wide budget), each step's share of
# padding bases: "tight" slices live states off, runs out of holes, and
# spills wide states and hits
NARROW = {"roomy": (100, (3, 128, 256, 128), 3, 256, 96, (0.0,)),
          "tight": (140, (3, 112, 48, 2), 2, 2, 2, (0.9,))}


def _jax_narrow(jdi, j_rows, carry, reads, narrow, n_locked, G, W, lock):
    n_n, pool, g_n, w_n = narrow
    B = jdi.n_outcomes
    n_step = jsl._build_narrow_step(jdi, jsl.LogConfig(pool=pool, hits=g_n),
                                    R, w_n, occ_rows=j_rows)
    l_step = jsl._build_narrow_step(jdi, jsl.LogConfig(pool=R, hits=G), R, W,
                                    occ_rows=j_rows, locked=True)
    n_bases = LOG_BASE + np.arange(n_n, dtype=np.int32) * (g_n * B)
    l_bases = (LOG_BASE + n_n * g_n * B
               + np.arange(n_locked, dtype=np.int32) * (G * B))

    @jax.jit
    def run(c, reads):
        c = jsl._resize_pool(c, pool, R)
        c, log_n = jax.lax.scan(n_step, c, (reads[:n_n], n_bases))
        logs = [log_n]
        if lock:
            c = jsl._lock_pool(c, R, R)
        if n_locked:
            c, log_l = jax.lax.scan(l_step, c, (reads[n_n:], l_bases))
            logs.append(log_l)
        return c, logs

    return run(_to_jax(carry), jnp.asarray(reads))


@pytest.mark.parametrize("budget", ["roomy", "tight"])
@pytest.mark.parametrize("rank", ["dense", "packed"])
@pytest.mark.parametrize("kind", ["sites", "nested"])
def test_narrow_tail_matches_jax(kind, rank, budget, monkeypatch):
    n_in, narrow, n_locked, G, W, zeros = NARROW[budget]
    jdi, tdi, j_rows, carry, reads, blocks = _case(
        kind, rank, 5 * len(kind) + len(rank) + len(budget), n_in,
        narrow[0] + n_locked, budget, zeros)
    B = jdi.n_outcomes
    n_records = (narrow[0] * narrow[2] + n_locked * G) * B
    j_carry, j_logs = _jax_narrow(jdi, j_rows, carry, reads, narrow,
                                  n_locked, G, W, True)
    seen = _watch_steps(monkeypatch, locked_step)
    lp, le = _log(n_records)
    t_carry = locked_step.locked_tail(tdi, torch.from_numpy(reads),
                                      _to_torch(carry), LOG_BASE, lp, le, G,
                                      W, blocks=blocks, narrow=narrow)
    _assert_run_equal(t_carry, j_carry, lp, le, j_logs, n_records)
    assert len(seen) == narrow[0] + n_locked
    ev = le[LOG_BASE + narrow[2] * B:LOG_BASE + 2 * narrow[2] * B]
    np.testing.assert_array_equal(ev.numpy(), np.tile(np.arange(B),
                                                      narrow[2]))
    if budget == "tight":
        holes = seen[:narrow[0]]
        assert (carry[0][narrow[1]:] >= 0).any()           # sliced off
        if kind == "sites":
            # the nested graph (53 BWT rows) seldom makes enough newborns
            # with these reads to fill the holes
            assert _dropped(holes)
        wide = [int(((c[0] >= 0) & (row[c[0].clamp(0, R - 1)] > 0)
                     & (c[1] != c[2])).sum()) for c, row, *_ in holes]
        assert max(wide) > narrow[3]                        # spill_w
        assert any(spilled for _, _, _, spilled, _ in seen)
        assert np.asarray(j_carry[4]).sum() > carry[4].sum()


def test_narrow_tail_without_lock_matches_jax():
    """A plan whose narrow phase is the last (no locked phase): the
    pool stays hole-allocated, of the narrow pool's size."""
    n_in, narrow, _, G, W, zeros = NARROW["roomy"]
    jdi, tdi, j_rows, carry, reads, blocks = _case("sites", "dense", 4, n_in,
                                                   narrow[0], "roomy", zeros)
    n_records = narrow[0] * narrow[2] * jdi.n_outcomes
    j_carry, j_logs = _jax_narrow(jdi, j_rows, carry, reads, narrow, 0, G, W,
                                  False)
    lp, le = _log(n_records)
    t_carry = locked_step.locked_tail(tdi, torch.from_numpy(reads),
                                      _to_torch(carry), LOG_BASE, lp, le, G,
                                      W, blocks=blocks, lock=False,
                                      narrow=narrow)
    assert t_carry[0].shape == (narrow[1],)
    _assert_run_equal(t_carry, j_carry, lp, le, j_logs, n_records)


# --------------------------------------------------------------------------
# the phase loop
# --------------------------------------------------------------------------

def _engine_buffer(rank, seed, monkeypatch, narrow="1"):
    monkeypatch.setenv("GRAMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", rank)
    monkeypatch.setenv("GRAMTOOLS_TPU_NARROW", narrow)
    j_idx, idx = _graph("sites")
    k = 5
    kmer_index = twin_kmer_index(j_idx, idx, k)[1]
    engine = LogBatchedEngine(idx, k, LogConfig(pool=4096, hits=16))
    token = engine.scan_submit(_seeded_buffer(idx, k, 160, 50, seed=seed),
                               kmer_index, k, QuasimapStats())
    _, _, (_, phases, Rb), _, _, carry, reads_T = token
    tdi = DeviceIndex.build(idx, engine.jt, "cpu")
    jdi = JaxDeviceIndex.build(j_idx, build_jump_table(j_idx))
    blocks = engine.blocks if rank == "packed" else None
    j_blocks = (jnp.asarray(jax_packed_occ(j_idx.fm)) if rank == "packed"
                else None)
    return tdi, jdi, phases, Rb, carry, reads_T, blocks, j_blocks


def _count_calls(monkeypatch):
    calls = []
    for name in ("wide_steps", "locked_tail"):
        fn = getattr(search_log, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls.append((_name, args[1].shape[0]))
            return _fn(*args, **kwargs)
        monkeypatch.setattr(search_log, name, counted)
    return calls


@pytest.mark.parametrize("narrow", ["1", "0"])
@pytest.mark.parametrize("rank", ["dense", "packed"])
def test_scan_phases_one_call_a_run(rank, narrow, monkeypatch):
    """The plan's wide phases in one wide_steps call and its narrow and
    locked phases in one locked_tail call (with GRAMTOOLS_TPU_NARROW=0
    the whole plan is wide: one call); the flat result equals JAX's
    _log_search_packed."""
    tdi, jdi, phases, Rb, carry, reads_T, blocks, j_blocks = _engine_buffer(
        rank, 7, monkeypatch, narrow)
    calls = _count_calls(monkeypatch)
    got = log_search_packed(tdi, torch.from_numpy(reads_T),
                            tuple(torch.from_numpy(a) for a in carry),
                            phases, Rb, blocks=blocks, rank=rank).numpy()
    plan = [jsl._phase4(e) for e in phases]
    n_wide = sum(e[0] for e in plan if e[3] == 0)
    if narrow == "1":
        assert [e[3] > 0 for e in plan] == [False, False, True, True]
        assert calls == [("wide_steps", n_wide),
                         ("locked_tail", plan[2][0] + plan[3][0])]
    else:
        assert all(e[3] == 0 for e in plan) and len(plan) == 3
        assert calls == [("wide_steps", n_wide)]
    want = np.asarray(jsl._log_search_packed(
        jdi, jnp.asarray(reads_T), _to_jax(carry), phases, Rb,
        blocks=j_blocks, rank=rank))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rank", ["dense", "packed"])
def test_probe_live_counts_match_jax(rank, monkeypatch):
    """log_search_probe runs each phase as its own call (one live count a
    phase): the final carry, log and live counts equal JAX's."""
    tdi, jdi, phases, Rb, carry, reads_T, blocks, j_blocks = _engine_buffer(
        rank, 9, monkeypatch)
    calls = _count_calls(monkeypatch)
    (rid, lo, hi, pref, ovf), (lp, le), live = log_search_probe(
        tdi, torch.from_numpy(reads_T),
        tuple(torch.from_numpy(a) for a in carry), phases, Rb,
        blocks=blocks, rank=rank)
    assert [n for _, n in calls] == [jsl._phase4(e)[0] for e in phases]
    j_occ = jsl._occ_rows_for(jdi, j_blocks, rank)
    (j_rid, j_lo, j_hi, j_pref, j_ovf), (j_lp, j_le), j_live = \
        jsl._log_search_phases(jdi, jnp.asarray(reads_T), _to_jax(carry),
                               phases, Rb, occ_rows=j_occ, collect_live=True)
    for t, j in ((rid, j_rid), (lo, j_lo), (hi, j_hi), (pref, j_pref),
                 (ovf, j_ovf), (lp, j_lp), (le, j_le), (live, j_live)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_injected_gathers_keep_the_torch_steps(monkeypatch):
    """An injected occ gather (as the SA-range-sharded index passes)
    runs every phase as torch steps, with the same result."""
    tdi, _, phases, Rb, carry, reads_T, _, _ = _engine_buffer(
        "dense", 4, monkeypatch)
    calls = _count_calls(monkeypatch)
    args = (tdi, torch.from_numpy(reads_T),
            tuple(torch.from_numpy(a) for a in carry), phases, Rb)
    own = log_search_phases(*args)
    assert [name for name, _ in calls] == ["wide_steps", "locked_tail"]
    injected = log_search_phases(*args, occ_rows=scan_steps.dense_occ_rows(tdi))
    assert len(calls) == 2
    for a, b in zip(own[0] + own[1], injected[0] + injected[1]):
        assert torch.equal(a, b)
