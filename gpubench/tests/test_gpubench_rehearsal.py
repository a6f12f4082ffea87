"""A run end to end on the CPU at a tiny size (the test-only cell in
``data/``), and ``correct`` coming out false under each planted fault
and the control. The command itself refuses to run without a card."""
import time
from pathlib import Path

import pytest

from gpubench import faults, run, spec

DATA = Path(__file__).resolve().parent / "data"
SEED = 2 ** 31 + 77


def _cell():
    return spec.load_cell("tiny_mixed.tiny", DATA / "BENCHMARK.json", DATA)


def _run(trace=False, seconds=1.0):
    return run.run_cell(_cell(), SEED, seconds, trace, "cpu",
                        time.perf_counter(), workers=2)


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_is_correct_and_reports_its_metrics(trace):
    r = _run(trace)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"stats_diff", "allele_sum_diff",
                                "grouped_diff", "per_base_diff",
                                "call_errors"}
    assert r["attempted"] >= 3000 and r["failed"] == 0
    if trace:
        # the CPU has no device trace: those readers return nothing
        assert {"engine_host_ms_per_buffer", "fallback_pct", "infer_s",
                "outputs_s"} <= set(r["metrics"])
        assert "device_busy_ms_per_buffer" not in r["metrics"]
    else:
        assert set(r["metrics"]) == {"quasimap_reads_per_s", "genotype_s",
                                     "peak_device_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_fault_makes_the_run_incorrect(fault):
    with faults.planted(fault):
        r = _run()
    assert not r["correct"], (fault, r["checks"])


def test_the_command_refuses_to_run_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "mtb_mixed.clean", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(needs_cuda):
    r = run.run_cell(_cell(), SEED, 1.0, True, "cuda", time.perf_counter(),
                     workers=2)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
