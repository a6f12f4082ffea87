"""The port's engine observability against the JAX package's, on the CPU.

  * the stage timers (``GRAMTOOLS_TPU_TIMERS=1``): the port's engine and
    the JAX engine, over the same two buffers through each package's
    ``quasimap_reads``, fused and non-fused, with the default budgets
    and with ``GRAMTOOLS_TPU_POOL=32 GRAMTOOLS_TPU_HITS=8`` (seed states
    spill the pool, most rows go to the host), fill the same keys, each
    >= 0; without the
    variable ``timers`` stays empty;
  * the scan's live-state probe (``log_search_probe`` against
    ``_log_search_probe``: final carry, log and per-phase live counts),
    dense and packed rank; ``make_log_search`` and ``empty_log_carry``;
  * the profiling stages: ``replay_device`` at stages 1, 2 and 99 (also
    with ``MAX_CHAIN`` patched to 1, so chains overrun),
    ``select_and_record_device`` at stages 0-6 and 99 with ``cov_diff``,
    and the whole fused program under ``GRAMTOOLS_TPU_REPLAY_STAGE=1``
    and under ``GRAMTOOLS_TPU_RECORD_STAGE=3`` (the JAX side through
    the plain ``_record_body``, which reads the environment at each
    call);
  * ``python -m gramtools_tpu_torch.mapping.profile_record_device
    --device cpu`` at a tiny size prints its JSON line.

Each package builds its own inputs from one numpy-seeded PRG (checked
equal, tests/test_torch_twins.py). Integers throughout: exact equality.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gramtools_tpu.mapping import quasimap as jax_quasimap
from gramtools_tpu.mapping import record_jax as rj
from gramtools_tpu.mapping import search_jax_log as jsl
from gramtools_tpu.mapping.device_index import DeviceIndex as JaxDeviceIndex
from gramtools_tpu.mapping.jump_table import build_jump_table
from gramtools_tpu.ops.rank import build_packed_occ as jax_packed_occ
from gramtools_tpu.prg.linearise import prg_string_to_ints
from gramtools_tpu_torch.mapping import quasimap as port_quasimap
from gramtools_tpu_torch.mapping import record as tr
from gramtools_tpu_torch.mapping import search_log as tsl
from gramtools_tpu_torch.mapping import search_log_host as host
from gramtools_tpu_torch.mapping.device_index import DeviceIndex
from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
from gramtools_tpu_torch.mapping.quasimap import QuasimapStats
from gramtools_tpu_torch.ops.rank import blocks_tensor, build_packed_occ

from test_locked_phase import _random_site_prg
from test_record_jax import _write_reads
from test_torch_record import Case, _assert_all_equal
from test_torch_twins import twin_index, twin_kmer_index

REPO = Path(__file__).resolve().parent.parent

# the keys each path of the engine fills (search_jax_log.py:1367-1940)
SUBMIT_KEYS = {"submit_filter", "submit_seed", "submit_dispatch"}
FUSED_KEYS = SUBMIT_KEYS | {"submit_pack", "complete_get", "complete_fold",
                            "complete_retry", "complete_hostmap"}
SCAN_KEYS = SUBMIT_KEYS | {"submit_put", "complete_get", "complete_retry"}


# --------------------------------------------------------------------------
# stage timers
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_buffers(tmp_path_factory):
    """(the JAX package's index and kmer index, the port's, the reads'
    FASTQ): 200 reads of a random SNP graph, two 100-read buffers."""
    rng = np.random.RandomState(9)
    prg_str = _random_site_prg(rng, 2000, 50)
    j_idx, t_idx = twin_index(prg_string_to_ints(prg_str))
    dna = t_idx.prg[(t_idx.prg >= 1) & (t_idx.prg <= 4)].astype(np.uint8)
    reads = [dna[s:s + 50].copy()
             for s in rng.randint(0, dna.size - 50, size=200)]
    fq = _write_reads(str(tmp_path_factory.mktemp("timers")), reads)
    j_k, t_k = twin_kmer_index(j_idx, t_idx, 5)
    return (j_idx, j_k), (t_idx, t_k), fq


def _timers(package, pair, fq):
    idx, kmer_index = pair
    if package == "torch":
        engine = LogBatchedEngine(idx, 5, device="cpu")
        quasimap = port_quasimap.quasimap_reads
    else:
        engine = jsl.LogBatchedEngine(idx, 5)
        quasimap = jax_quasimap.quasimap_reads
    idx.graph.coverage[:] = 0
    quasimap([fq], kmer_index, idx, 5, seed=3, engine=engine,
             buffer_size=100)
    return engine


@pytest.mark.parametrize("budget", ["default", "pool32_hits8"])
@pytest.mark.parametrize("fused", ["1", "0"])
def test_timer_keys_equal_jax(two_buffers, fused, budget, monkeypatch):
    monkeypatch.setenv("GRAMTOOLS_TPU_TIMERS", "1")
    monkeypatch.setenv("GRAMTOOLS_TPU_DEVICE_RECORD", fused)
    monkeypatch.setenv("GRAMTOOLS_TPU_RETRY_MIN", "1")
    if budget != "default":
        monkeypatch.setenv("GRAMTOOLS_TPU_POOL", "32")
        monkeypatch.setenv("GRAMTOOLS_TPU_HITS", "8")
    j_pair, t_pair, fq = two_buffers
    t = _timers("torch", t_pair, fq)
    j = _timers("jax", j_pair, fq)
    assert set(t.timers) == set(j.timers)
    assert set(t.timers) == (FUSED_KEYS if fused == "1" else SCAN_KEYS)
    assert all(v >= 0 for v in t.timers.values())
    assert (t.device_retried, t.host_fallbacks) == (j.device_retried,
                                                    j.host_fallbacks)
    if budget != "default":                      # the host re-maps ran
        assert t.host_fallbacks > t.device_mapped


def test_timers_off_by_default(two_buffers, monkeypatch):
    monkeypatch.delenv("GRAMTOOLS_TPU_TIMERS", raising=False)
    _, t_pair, fq = two_buffers
    engine = _timers("torch", t_pair, fq)
    assert not engine.timers and engine.device_mapped > 0


# --------------------------------------------------------------------------
# the live-state probe and the scan's public helpers
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scan_case():
    """One seeded buffer's scan inputs (reads_T, carry, phases, R) from
    the port's engine, with both packages' device indexes."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("GRAMTOOLS_TPU_RANK", "dense")
        j_idx, idx = twin_index(prg_string_to_ints(
            _random_site_prg(np.random.RandomState(7), 3000, 60)))
        kmer_index = twin_kmer_index(j_idx, idx, 5)[1]
        engine = LogBatchedEngine(idx, 5, host.LogConfig(pool=4096, hits=16),
                                  device="cpu")
        rng = np.random.RandomState(3)
        dna = idx.prg[(idx.prg >= 1) & (idx.prg <= 4)].astype(np.uint8)
        reads = [dna[s:s + 50].copy()
                 for s in rng.randint(0, dna.size - 50, size=160)]
        token = engine.scan_submit(reads, kmer_index, 5, QuasimapStats())
    finally:
        mp.undo()
    _, _, (_, phases, R), _, _, carry, reads_T = token
    blocks = build_packed_occ(idx.fm)
    np.testing.assert_array_equal(blocks, jax_packed_occ(j_idx.fm))
    return dict(jdi=JaxDeviceIndex.build(j_idx, build_jump_table(j_idx)),
                tdi=DeviceIndex.build(idx, device="cpu"), blocks=blocks,
                phases=phases, R=R, carry=carry, reads_T=reads_T)


def _rank_args(case, rank):
    if rank == "dense":
        return dict(blocks=None, rank="dense"), dict(blocks=None,
                                                     rank="dense")
    return (dict(blocks=jnp.asarray(case["blocks"]), rank="packed"),
            dict(blocks=blocks_tensor(case["blocks"], "cpu"), rank="packed"))


def _scan_inputs(case):
    return ((jnp.asarray(case["reads_T"]),
             tuple(jnp.asarray(a) for a in case["carry"])),
            (torch.from_numpy(case["reads_T"]),
             tuple(torch.from_numpy(a.copy()) for a in case["carry"])))


def _assert_scan_equal(j, t):
    (j_carry, (j_lp, j_le)), (t_carry, (t_lp, t_le)) = j, t
    _assert_all_equal(j_carry, [x.numpy() for x in t_carry])
    np.testing.assert_array_equal(np.asarray(j_lp), t_lp.numpy())
    np.testing.assert_array_equal(np.asarray(j_le), t_le.numpy())


@pytest.mark.parametrize("rank", ["dense", "packed"])
def test_log_search_probe_equal_jax(scan_case, rank):
    c = scan_case
    j_rank, t_rank = _rank_args(c, rank)
    (j_reads, j_carry), (t_reads, t_carry) = _scan_inputs(c)
    j_final, j_logs, j_live = jsl._log_search_probe(
        c["jdi"], j_reads, j_carry, c["phases"], c["R"], **j_rank)
    t_final, t_logs, t_live = tsl.log_search_probe(
        c["tdi"], t_reads, t_carry, c["phases"], c["R"], **t_rank)
    _assert_scan_equal((j_final, j_logs), (t_final, t_logs))
    assert t_live.shape == (len(c["phases"]),)
    np.testing.assert_array_equal(np.asarray(j_live), t_live.numpy())
    assert (t_live > 0).all()


@pytest.mark.parametrize("phases", ["given", "auto"])
@pytest.mark.parametrize("rank", ["dense", "packed"])
def test_make_log_search_equal_jax(scan_case, rank, phases):
    c = scan_case
    j_rank, t_rank = _rank_args(c, rank)
    p = c["phases"] if phases == "given" else None
    cfg = dict(pool=4096, hits=16)
    j_run = jsl.make_log_search(c["jdi"], jsl.LogConfig(**cfg), c["R"],
                                phases=p, **j_rank)
    t_run = tsl.make_log_search(c["tdi"], host.LogConfig(**cfg), c["R"],
                                phases=p, **t_rank)
    (j_reads, j_carry), (t_reads, t_carry) = _scan_inputs(c)
    _assert_scan_equal(j_run(j_reads, j_carry), t_run(t_reads, t_carry))


@pytest.mark.parametrize("num_reads,pool", [(8, 64), (100, 4096)])
def test_empty_log_carry_equal_jax(num_reads, pool):
    j = jsl.empty_log_carry(num_reads, jsl.LogConfig(pool=pool, hits=8))
    t = host.empty_log_carry(num_reads, host.LogConfig(pool=pool, hits=8))
    assert len(j) == len(t) == 5
    for a, b in zip(j, t):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the profiling stages of the fused program
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["sites", "nested"])
def record_case(request):
    mp = pytest.MonkeyPatch()
    try:
        return Case(request.param, mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("max_chain", [None, 1])
@pytest.mark.parametrize("stage", [1, 2, 99])
def test_replay_stage_equal_jax(record_case, stage, max_chain, monkeypatch):
    if max_chain is not None:
        monkeypatch.setattr(rj, "MAX_CHAIN", max_chain)
        monkeypatch.setattr(tr, "MAX_CHAIN", max_chain)
    c = record_case
    rid, lo, hi, pref, ovf, lp, le = c.scan
    alive = rid >= 0
    j = rj.replay_device(c.jdi, jnp.asarray(pref), jnp.asarray(lp),
                         jnp.asarray(le), c.jst, jnp.asarray(alive),
                         stage=stage)
    t = tr.replay_device(c.tdi, torch.from_numpy(pref), torch.from_numpy(lp),
                         torch.from_numpy(le), c.tst, torch.from_numpy(alive),
                         stage=stage)
    _assert_all_equal([np.asarray(x) for x in j], [x.numpy() for x in t])
    if stage > 1:
        assert (t[1].numpy() > 0).any()            # seed paths gathered
    else:
        assert not t[1].numpy().any() and not t[0].numpy().any()
    if max_chain is not None:
        assert t[4].numpy().any()                  # chains overran


@pytest.mark.parametrize("record_case", ["sites"], indirect=True)
@pytest.mark.parametrize("stage", [0, 1, 2, 3, 4, 5, 6, 99])
def test_select_stage_equal_jax(record_case, stage):
    c = record_case
    rid, lo, hi, pref, ovf, lp, le = c.scan
    replayed = c.replay_pair()[1]
    row_ok = c.np["row_ok"] & ~ovf
    row_first = c.np["row_first"]
    cov0 = np.zeros(c.cov_size + 1, np.int32)
    ins = (rid, lo, hi) + tuple(replayed) + (row_ok,)
    j = rj.select_and_record_device(
        c.jdi, c.jrt, *(jnp.asarray(x) for x in ins),
        jnp.asarray(row_first.astype(np.uint32)), jnp.asarray(c.np["row_len"]),
        jnp.asarray(cov0), trip_cap=c.trip_cap, stage=stage)
    cov_t = torch.from_numpy(cov0.copy())
    t = tr.select_and_record_device(
        c.tdi, c.trt, *(torch.from_numpy(np.ascontiguousarray(x))
                        for x in ins + (row_first, c.np["row_len"])),
        cov_t, trip_cap=c.trip_cap, stage=stage)
    _assert_all_equal([np.asarray(x) for x in j],
                      [x.numpy() for x in t] + [cov_t.numpy()])
    assert cov_t.numpy().any() == (stage >= 6)
    assert t[1].numpy().any() == (stage == 99)


@pytest.mark.parametrize("record_case", ["sites"], indirect=True)
@pytest.mark.parametrize("knob,stage", [("GRAMTOOLS_TPU_REPLAY_STAGE", "1"),
                                        ("GRAMTOOLS_TPU_RECORD_STAGE", "3")])
def test_fused_program_under_stage_knob(record_case, knob, stage,
                                        monkeypatch):
    monkeypatch.setenv(knob, stage)
    (j_flat, j_cov), (t_flat, t_cov) = record_case.fused_pair()
    np.testing.assert_array_equal(j_flat, t_flat)
    np.testing.assert_array_equal(j_cov, t_cov)
    if knob == "GRAMTOOLS_TPU_RECORD_STAGE":
        assert not t_cov.any()               # stopped before recording
    # the knob took effect: the default program's result differs
    monkeypatch.delenv(knob)
    c, a = record_case, record_case.np
    default = tsl.log_search_record(
        c.tdi, c.trt, c.tst,
        *(torch.from_numpy(a[n]) for n in ("reads_p", "slot_sidx",
                                           "slot_row", "row_ok",
                                           "row_first", "row_len")),
        torch.zeros(c.cov_size + 1, dtype=torch.int32), c.phases, c.R,
        c.trip_cap, c.k).numpy()
    assert not np.array_equal(default, t_flat)


# --------------------------------------------------------------------------
# the profiler module
# --------------------------------------------------------------------------

def test_profile_record_device_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO), PROF_RSTAGES="1,99",
               PROF_STAGES="0,2")
    res = subprocess.run(
        [sys.executable, "-m",
         "gramtools_tpu_torch.mapping.profile_record_device", "64",
         "--genome_len", "3000", "--num_sites", "40", "--runs", "1",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert (out["R"], out["device"], out["clock"], out["card"]) == (
        64, "cpu", "host", None)
    assert out["N"] > 0
    assert set(out["replay_ms"]) == {"1", "99"}
    assert set(out["select_ms"]) == {"0", "2"}
    assert all(v > 0 for d in ("replay_ms", "select_ms")
               for v in out[d].values())


def test_profile_record_device_refuses_without_card(monkeypatch):
    from gramtools_tpu_torch.mapping import profile_record_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_record_device.main(["64"]) == 2
