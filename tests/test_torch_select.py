"""How the selection (K8) routes by device, on the CPU.

``record.select_and_record_device`` takes the plain version
(``record.select_torch``) on CPU tensors and never the kernels' wrapper;
the wrapper (ops/select.py) refuses CPU tensors; any other device
raises. The kernels themselves are held to the plain version by the
``cuda`` tests (tests/test_torch_cuda.py) and, through a numpy mirror of
their design, to the JAX package (tests/test_torch_select_design.py).
"""
import numpy as np
import pytest
import torch

from gramtools_tpu_torch.index.build import build_prg_index
from gramtools_tpu_torch.mapping import record
from gramtools_tpu_torch.mapping.device_index import DeviceIndex
from gramtools_tpu_torch.mapping.record import RecordTables
from gramtools_tpu_torch.ops import select
from gramtools_tpu_torch.prg.linearise import PrgString, prg_string_to_ints

TCAP = 16


def _inputs(N=40, R=12, seed=0):
    """A small nested graph's tables and random selection inputs."""
    rng = np.random.RandomState(seed)
    idx = build_prg_index(PrgString(prg_string_to_ints(
        "ACGTA[[A[CCC,C],T],G]TAGGCT[C,G]TTACA[T[TT,T]T,A[AT,]A]GCA")))
    di = DeviceIndex.build(idx, device="cpu")
    rt = RecordTables.build(idx, "cpu")
    n_sites = rt.anc_len.shape[0]
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32))
    lo = rng.randint(0, di.size, N)
    trav = np.stack([5 + 2 * rng.randint(0, n_sites, (N, TCAP)),
                     rng.randint(-1, 2, (N, TCAP))], -1)
    args = [i32(rng.randint(-1, R, N)), i32(lo),
            i32(np.minimum(lo + rng.randint(0, 3, N), di.size - 1)),
            i32(trav), i32(rng.randint(0, 4, N)), i32(np.zeros_like(trav)),
            i32(np.zeros(N)), torch.zeros(N, dtype=torch.bool),
            torch.ones(R, dtype=torch.bool),
            torch.from_numpy(rng.randint(0, 1 << 32, R, dtype=np.int64)),
            i32(rng.randint(1, 100, R))]
    cov = torch.zeros(rt.cov_size + 1, dtype=torch.int32)
    return di, rt, args, cov


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    di, rt, args, cov = _inputs()
    calls = []
    plain = record.select_torch

    def counted(*a, **k):
        calls.append(a[-1])
        return plain(*a, **k)

    def kernels(*a, **k):
        raise AssertionError("the kernels' wrapper ran on CPU tensors")

    monkeypatch.setattr(record, "select_torch", counted)
    monkeypatch.setattr(record, "select_cuda", kernels)
    before = select.select_cuda.launches
    for stage in (2, 99):
        out = record.select_and_record_device(di, rt, *args, cov,
                                              trip_cap=64, stage=stage)
        assert [tuple(o.shape) for o in out] == [(12,), (12,), (64,), (64,),
                                                 (64,)]
    assert calls == [2, 99] and select.select_cuda.launches == before
    assert out[1].any()                       # rows mapped


def test_default_trip_cap_is_sixteen_a_row():
    di, rt, args, cov = _inputs()
    out = record.select_and_record_device(di, rt, *args, cov)
    assert out[2].shape == (16 * 12,)


def test_other_devices_raise():
    di, rt, args, cov = _inputs()
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        record.select_and_record_device(di, rt, *meta, cov.to("meta"))


def test_kernel_wrapper_refuses_cpu_tensors():
    di, rt, args, _ = _inputs()
    with pytest.raises(ValueError, match="CUDA"):
        select.select_cuda(di.sa, rt.ra_node, rt.nt_site, rt.nt_allele,
                           rt.anc_len, rt.anc_site, rt.anc_allele,
                           rt.base_site, rt.max_anc, *args[:10], ecap=64,
                           lcap=64, trcap=64, kcap=12, trip_cap=64)
