"""The port's SA-range-sharded index (K10,
gramtools_tpu_torch/parallel/sharded_index.py) on the CPU.

The occ and narrow_tab tables are split over an "idx" mesh axis of
repeated CPU devices and every gather is the sum of the shards' masked
local gathers. Mirrors tests/test_sharded_index.py: the index-sharded
scan with n_idx = 2, 4, 8 and on a (2, 4) ("data", "idx") mesh must
equal the port's replicated scan and the JAX package's
``make_index_sharded_log_search`` (8 virtual CPU devices), final carry
and genealogy log, with a fixed wide plan and with the auto plan (whose
narrow and slot-locked tail reads the sharded narrow_tab). Exact
equality.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from gramtools_tpu.index.build import build_prg_index
from gramtools_tpu.mapping.device_index import DeviceIndex as JaxDeviceIndex
from gramtools_tpu.mapping.search_jax_log import LogConfig as JaxLogConfig
from gramtools_tpu.parallel.sharded_index import \
    make_index_sharded_log_search as jax_index_sharded
from gramtools_tpu.prg.linearise import PrgString, prg_string_to_ints
from gramtools_tpu_torch.mapping.device_index import (TENSOR_FIELDS,
                                                      DeviceIndex)
from gramtools_tpu_torch.mapping.search_log import log_search_phases
from gramtools_tpu_torch.mapping.search_log_host import LogConfig
from gramtools_tpu_torch.parallel.mesh import Mesh
from gramtools_tpu_torch.parallel.sharded_index import (
    make_index_sharded_log_search, shard_occ)

from test_sharded_index import PHASES, PRG, seeded_batch

PLANS = {"wide": PHASES, "auto": None}


def _to_torch_di(jdi, device="cpu"):
    return DeviceIndex.from_numpy(
        {f: np.asarray(getattr(jdi, f)) for f in TENSOR_FIELDS}, device,
        size=jdi.size, n_outcomes=jdi.n_outcomes, n_ops=jdi.n_ops)


@pytest.fixture(scope="module")
def setup():
    idx = build_prg_index(PrgString(prg_string_to_ints(PRG)))
    jdi = JaxDeviceIndex.build(idx)
    tdi = _to_torch_di(jdi)
    assert tdi.narrow_tab.shape[0] == tdi.size     # the narrow tail runs
    return idx, jdi, tdi


def _torch(reads_T, carry):
    return (torch.from_numpy(np.array(reads_T)),
            tuple(torch.from_numpy(np.array(a)) for a in carry))


def _assert_equal(got, want):
    (g_carry, g_log), (w_carry, w_log) = got, want
    for g, w in zip(g_carry + g_log, w_carry + w_log):
        assert g.dtype in (torch.int32, torch.bool)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(-1))


def _replicated(tdi, reads_T, carry, R, plan):
    from gramtools_tpu_torch.mapping.search_log_host import auto_phases

    phases = plan or auto_phases(reads_T.shape[0], R,
                                 LogConfig(pool=64, hits=16), narrow=True)
    return log_search_phases(tdi, *_torch(reads_T, carry), phases, R)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("n_idx", [2, 4, 8])
def test_idx_sharded_equals_replicated_and_jax(setup, n_idx, plan):
    idx, jdi, tdi = setup
    phases = PLANS[plan]
    R = 6
    reads_T, carry = seeded_batch(idx, np.random.RandomState(0), R, 16,
                                  JaxLogConfig(pool=64, hits=16))
    got = make_index_sharded_log_search(
        Mesh(["cpu"] * n_idx, ("idx",)), tdi, LogConfig(pool=64, hits=16),
        R, phases=phases)(*_torch(reads_T, carry))
    _assert_equal(got, _replicated(tdi, reads_T, carry, R, phases))
    want = jax_index_sharded(
        JaxMesh(np.array(jax.devices()[:n_idx]), axis_names=("idx",)), jdi,
        JaxLogConfig(pool=64, hits=16), R, phases=phases)(
            reads_T, jax.device_put(carry))
    _assert_equal(got, want)
    assert (got[1][0] >= 0).any()           # the log holds records


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_data_and_idx_sharded(setup, plan):
    """(2, 4) mesh: reads split over "data", occ over "idx": equal to
    the JAX package's run and, per data shard, to the replicated scan
    of its half of the batch."""
    idx, jdi, tdi = setup
    phases = PLANS[plan]
    R_shard = 4
    rng = np.random.RandomState(1)
    cfg = JaxLogConfig(pool=64, hits=16)
    halves = [seeded_batch(idx, rng, R_shard, 16, cfg) for _ in range(2)]
    reads_T = jnp.concatenate([h[0] for h in halves], axis=1)
    carry = tuple(np.concatenate(cs) for cs in zip(*[h[1] for h in halves]))
    got = make_index_sharded_log_search(
        Mesh([["cpu"] * 4] * 2, ("data", "idx")), tdi,
        LogConfig(pool=64, hits=16), R_shard, phases=phases)(
            *_torch(reads_T, carry))
    want = jax_index_sharded(
        JaxMesh(np.array(jax.devices()[:8]).reshape(2, 4),
                axis_names=("data", "idx")), jdi, cfg, R_shard,
        phases=phases)(reads_T, jax.device_put(carry))
    _assert_equal(got, want)
    for d, (rt, c) in enumerate(halves):
        ref = _replicated(tdi, rt, c, R_shard, phases)
        for g, w in zip(got[0] + got[1], ref[0] + ref[1]):
            m = w.numel()
            assert torch.equal(g[d * m:(d + 1) * m], w)


def test_occ_shard_layout(setup):
    _, _, tdi = setup
    occ = tdi.occ.numpy()
    padded, rows_per_shard = shard_occ(occ, 8)
    assert rows_per_shard == -(-occ.shape[0] // 8)
    assert padded.shape[0] == rows_per_shard * 8
    np.testing.assert_array_equal(padded[:occ.shape[0]], occ)
    assert not padded[occ.shape[0]:].any()
