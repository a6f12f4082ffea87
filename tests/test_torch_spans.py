"""The port's span store (``common/timers.SPANS``) on the CPU.

The torch engine maps two reads files of several small buffers through
``quasimap_reads`` under ``GRAMTOOLS_TPU_TIMERS=1``, fused and
non-fused, with budgets that send rows to the host
(``GRAMTOOLS_TPU_POOL=32``, ``_HITS=8``). The records must give every
buffer its driver iteration and its engine stages, each ``complete_*``
stage the id of the buffer it completes, every child inside its parent,
per-key sums equal to ``engine.timers`` and per-reason row counts equal
to the engine's counters; without the variable nothing is recorded.
Without an engine the call records only its own parts and each
buffer's parse and RNG draws.
"""
import collections
import os

import numpy as np
import pytest

from gramtools_tpu_torch.common import timers
from gramtools_tpu_torch.index.build import build_prg_index
from gramtools_tpu_torch.index.kmer_index_vec import (
    build_kmer_index_vectorised)
from gramtools_tpu_torch.mapping.engine import LogBatchedEngine
from gramtools_tpu_torch.mapping.quasimap import quasimap_reads
from gramtools_tpu_torch.prg.linearise import PrgString, prg_string_to_ints

from test_locked_phase import _random_site_prg
from test_record_jax import _write_reads

K = 5
FILES = (250, 170)           # reads a file: buffers of 100, 100, 50; 100, 70
SUBMIT = {"submit_filter", "submit_seed", "submit_dispatch"}
COMPLETE = {"fused": {"complete_get", "complete_fold", "complete_retry",
                      "complete_hostmap"},
            "scan": {"complete_get", "complete_retry"}}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.RandomState(11)
    idx = build_prg_index(PrgString(prg_string_to_ints(
        _random_site_prg(rng, 2000, 50))))
    kmer_index = build_kmer_index_vectorised(idx, K)
    dna = idx.prg[(idx.prg >= 1) & (idx.prg <= 4)].astype(np.uint8)
    files = [_write_reads(str(tmp_path_factory.mktemp("spans")),
                          [dna[s:s + 50].copy() for s in
                           rng.randint(0, dna.size - 50, size=n)])
             for n in FILES]
    return idx, kmer_index, files


COUNTERS = ("host_fallbacks", "device_mapped", "device_retried")


def _run(inputs, env: dict):
    """(records, engine, counter deltas, fallback_reasons delta) of one
    quasimap_reads call over both files, after a warm call on the first."""
    idx, kmer_index, files = inputs
    mp = pytest.MonkeyPatch()
    try:
        for key in [k for k in os.environ if k.startswith("GRAMTOOLS_TPU_")]:
            mp.delenv(key)
        for key, val in env.items():
            mp.setenv(key, val)
        engine = LogBatchedEngine(idx, K, device="cpu")
        idx.graph.coverage[:] = 0
        quasimap_reads(files[:1], kmer_index, idx, K, seed=5, engine=engine,
                       buffer_size=100)
        before = ({c: getattr(engine, c) for c in COUNTERS},
                  collections.Counter(engine.fallback_reasons))
        engine.timers.clear()
        timers.SPANS.clear()
        quasimap_reads(files, kmer_index, idx, K, seed=5, engine=engine,
                       buffer_size=100)
        records = list(timers.SPANS.records)
        timers.SPANS.clear()
    finally:
        mp.undo()
    deltas = {c: getattr(engine, c) - v for c, v in before[0].items()}
    reasons = collections.Counter(engine.fallback_reasons)
    reasons.subtract(before[1])
    return records, engine, deltas, +reasons


@pytest.fixture(scope="module", params=["fused", "scan"])
def mapped(request, inputs):
    env = {"GRAMTOOLS_TPU_TIMERS": "1", "GRAMTOOLS_TPU_POOL": "32",
           "GRAMTOOLS_TPU_HITS": "8", "GRAMTOOLS_TPU_RETRY_MIN": "1",
           "GRAMTOOLS_TPU_DEVICE_RECORD": "1" if request.param == "fused"
           else "0"}
    return (request.param,) + _run(inputs, env)


def _by_buffer(records, names):
    out = collections.defaultdict(set)
    for r in records:
        if r.name in names:
            out[r.buffer].add(r.name)
    return out


def test_every_buffer_has_its_iteration_and_stages(mapped):
    path, records, engine, _, _ = mapped
    iterations = [r.buffer for r in records if r.name == "iteration"]
    assert len(iterations) == 5 and len(set(iterations)) == 5
    assert all(b is not None for b in iterations)
    calls = [r for r in records if r.name == "quasimap_reads"]
    assert len(calls) == 1 and calls[0].parent is None
    stages = _by_buffer(records, SUBMIT | COMPLETE[path])
    for b in iterations:
        assert SUBMIT <= stages[b], (b, stages[b])
        assert COMPLETE[path] <= stages[b], (b, stages[b])
    driver = _by_buffer(records, {"read_parse", "rng_draws", "scan_submit",
                                  "record_complete"})
    assert all(driver[b] == {"read_parse", "rng_draws", "scan_submit",
                             "record_complete"} for b in iterations)
    assert {r.name for r in records if r.parent == 0} >= {
        "iteration", "record_complete", "coverage_finalise"}


def test_complete_stages_carry_the_buffer_they_complete(mapped):
    path, records, *_ = mapped
    submit = {r.buffer: r for r in records if r.name == "scan_submit"}
    seen = 0
    for r in records:
        if not r.name.startswith("complete_"):
            continue
        parent = records[r.parent]
        assert parent.name == "record_complete"
        assert r.buffer == parent.buffer
        nxt = submit.get(r.buffer + 1)
        if nxt is not None:     # the call's last buffer: after the loop
            assert r.start >= nxt.end
            seen += 1
    # every buffer but the call's last one completes after the next submit
    assert seen >= 4 * len(COMPLETE[path])


def test_children_lie_inside_their_parents(mapped):
    _, records, *_ = mapped
    assert all(r.end is not None and r.start <= r.end for r in records)
    for r in records:
        if r.parent is not None:
            p = records[r.parent]
            assert p.start <= r.start and r.end <= p.end, (p, r)


def test_span_sums_equal_engine_timers(mapped):
    _, records, engine, _, _ = mapped
    sums = collections.defaultdict(float)
    for r in records:
        if r.name in engine.timers:
            sums[r.name] += r.end - r.start
    assert set(sums) == set(engine.timers)
    for key, v in engine.timers.items():
        assert sums[key] == pytest.approx(v, abs=1e-9)


def test_reason_counts_sum_to_the_engine_counters(mapped):
    path, records, engine, deltas, reasons = mapped
    counted = collections.Counter()
    for r in records:
        if r.counts:
            assert r.name in ("complete_retry", "complete_hostmap")
            counted.update(r.counts)
    if path == "scan":                # the scan path counts no reasons
        assert not counted
        return
    hostmap = sum(sum(r.counts.values()) for r in records
                  if r.name == "complete_hostmap" and r.counts)
    assert hostmap == deltas["host_fallbacks"] > 0
    assert counted == reasons


def test_nothing_is_recorded_without_the_variable(inputs):
    timers.SPANS.clear()
    records, engine, deltas, _ = _run(inputs, {})
    assert records == [] and not timers.SPANS.records
    assert engine.spans is timers.OFF and not engine.timers
    assert deltas["device_mapped"] > 0


def test_host_path_records_the_call_and_its_buffers_parts(inputs,
                                                         monkeypatch):
    idx, kmer_index, files = inputs
    monkeypatch.setenv("GRAMTOOLS_TPU_TIMERS", "1")
    timers.SPANS.clear()
    quasimap_reads(files, kmer_index, idx, K, seed=5, buffer_size=100)
    records = list(timers.SPANS.records)
    timers.SPANS.clear()
    assert {r.name for r in records} == {
        "quasimap_reads", "coverage_empty", "read_parse", "rng_draws",
        "coverage_finalise"}
    assert all(r.parent == 0 for r in records[1:])
    parts = _by_buffer(records, {"read_parse", "rng_draws"})
    assert len(parts[None]) == 1          # the two files' ends
    del parts[None]
    assert len(parts) == 5
    assert all(p == {"read_parse", "rng_draws"} for p in parts.values())


def test_store_nests_inherits_and_numbers_buffers():
    store = timers.SpanStore()
    first = store.new_buffer()
    with store.span("call"):
        with store.span("iteration", first, start=store.now() - 1.0):
            t0 = store.now()
            store.add("stage", t0, counts={"overflow": 2})
            with store.span("record_complete", 99):
                store.add("inner", store.now())
    names = [(r.name, r.buffer, r.parent) for r in store.records]
    assert names == [("call", None, None), ("iteration", first, 0),
                     ("stage", first, 1), ("record_complete", 99, 1),
                     ("inner", 99, 3)]
    assert store.records[2].counts == {"overflow": 2}
    assert store.records[1].start < store.records[0].start
    store.clear()
    assert store.records == [] and store.new_buffer() == first + 1
    with pytest.raises(RuntimeError):
        with store.span("failing"):
            raise RuntimeError
    assert store.records[0].end is not None and not store._open
