"""The readers of the program's spans (``stages.py`` and the five
metrics on it) on hand-made spans, ``stages.reduce`` on a hand-made
trace, and a traced rehearsal on the CPU that prints the five."""
import json
import time
from pathlib import Path

import pytest

from gpubench import run, spec, stages, trace
from gramtools_tpu_torch.common.timers import Span

DATA = Path(__file__).resolve().parent / "data"
ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 91
NEW = ("hostmap_us_per_row", "screen_seed_ms_per_buffer",
       "host_wait_ms_per_buffer", "driver_self_ms_per_buffer",
       "first_buffer_s")


def _spans():
    """A warm call (0-3 s) and a window call (10-20 s) of two buffers:
    (name, buffer, start, end, parent, counts)."""
    rows = [
        ("quasimap_reads", None, 0.0, 3.0, None, None),          # 0
        ("quasimap_reads", None, 10.0, 20.0, None, None),        # 1
        ("iteration", 1, 10.0, 14.0, 1, None),                   # 2
        ("read_parse", 1, 10.0, 10.5, 2, None),                  # 3
        ("rng_draws", 1, 10.5, 10.6, 2, None),                   # 4
        ("scan_submit", 1, 10.6, 11.0, 2, None),                 # 5
        ("submit_filter", 1, 10.6, 10.7, 5, None),               # 6
        ("submit_seed", 1, 10.7, 10.8, 5, None),                 # 7
        ("iteration", 2, 14.0, 19.0, 1, None),                   # 8
        ("read_parse", 2, 14.0, 14.2, 8, None),                  # 9
        ("scan_submit", 2, 14.2, 15.0, 8, None),                 # 10
        ("submit_filter", 2, 14.2, 14.5, 10, None),              # 11
        ("submit_seed", 2, 14.5, 14.6, 10, None),                # 12
        ("record_complete", 1, 15.0, 18.0, 8, None),             # 13
        ("complete_get", 1, 15.0, 15.1, 13, None),               # 14
        ("complete_hostmap", 1, 15.1, 17.1, 13,
         {"overflow": 3, "unseeded": 1}),                        # 15
        ("record_complete", 2, 19.0, 19.8, 1, None),             # 16
        ("complete_get", 2, 19.0, 19.3, 16, None),               # 17
        ("complete_hostmap", 2, 19.3, 19.8, 16, {"overflow": 1}),  # 18
    ]
    return [Span(*r) for r in rows]


def _run(spans=None):
    return {"spans": [("scan_submit", 0, 10.6, 11.0),
                      ("scan_submit", 1, 14.2, 15.0),
                      ("record_complete", 0, 15.0, 18.0)],
            "program_spans": _spans() if spans is None else spans}


@pytest.mark.parametrize("name,expected", [
    ("hostmap_us_per_row", (2.0 + 0.5) / 5 * 1e6),
    ("screen_seed_ms_per_buffer", (0.2 + 0.4) / 2 * 1e3),
    ("host_wait_ms_per_buffer", (0.1 + 0.3) / 2 * 1e3),
    # iteration 1: 4.0 - 1.0 covered; iteration 2: 5.0 - 4.0 covered
    ("driver_self_ms_per_buffer", (3.0 + 1.0) / 2 * 1e3),
    ("first_buffer_s", 3.0)])
def test_reader_on_hand_made_spans(name, expected):
    assert spec.metric_reader(name)(_run()) == pytest.approx(expected)


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_without_program_spans(name):
    assert spec.metric_reader(name)(_run(spans=[])) is None


def test_window_takes_only_the_window_buffers():
    win = stages.window(_run())
    assert (win.calls, win.warm, win.buffers) == ([1], 0, [1, 2])
    # the window's first span after the warm call's end: no warm call
    late = stages.split(_spans(), 2.0)
    assert late.warm is None and late.calls == [0, 1]


def _events(anchor_us, drift_us):
    """Two device operations 10.2 and 12.0 s after the stretch's first
    synchronisation, the second 15 s after it and ``drift_us`` late
    (trace clock, us)."""
    x = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat,
                                    "ts": ts, "dur": dur}
    return [x("cudaDeviceSynchronize", "cuda_runtime", anchor_us, 5.0),
            x("k1", "kernel", anchor_us + 10.2e6, 100.0),
            x("k2", "kernel", anchor_us + 12.0e6, 100.0),
            x("cudaDeviceSynchronize", "cuda_runtime",
              anchor_us + 15e6 + drift_us, 5.0)]


def test_reduce_names_gaps_by_the_innermost_program_span():
    anchor = 5.0                      # host s; the trace runs 1,000 s ahead
    events = _events((anchor + 1000.0) * 1e6, 40.0)
    host = [(15.0, 18.0, "record_complete")]
    plain = trace.reduce(events, 15.0, 2, host, anchor)
    named = stages.reduce(events, 15.0, 2, host, anchor, _spans())
    assert named["busy_s"] == plain["busy_s"] == pytest.approx(200e-6)
    assert named["device_ops"] == plain["device_ops"]
    assert plain["idle_gaps"][0][0] == "record_complete"
    # the gap's midpoint, host time 16.1 s: buffer 1's complete_hostmap
    assert named["idle_gaps"][0][0] == "record_complete/complete_hostmap"
    assert named["idle_gaps"][0][1] == plain["idle_gaps"][0][1]
    assert named["gaps"][0][2] == 1
    assert named["skew_us"] == pytest.approx(40.0 + 5.0)


def test_traced_rehearsal_prints_the_five_metrics():
    cell = spec.load_cell("tiny_mixed.tiny", DATA / "BENCHMARK.json", DATA)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell.per_layer += [m for m in bench["per_layer"] if m["name"] in NEW]
    plain = trace.reduce
    with stages.capture():
        r = run.run_cell(cell, SEED, 1.0, True, "cpu", time.perf_counter(),
                         workers=2)
    assert trace.reduce is plain
    assert r["correct"], r["checks"]
    assert set(NEW) <= set(r["metrics"]), r["metrics"]
    assert all(r["metrics"][m]["value"] >= 0 for m in NEW)
    assert r["metrics"]["first_buffer_s"]["value"] > 0
