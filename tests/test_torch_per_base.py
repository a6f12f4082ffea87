"""The port's per-base coverage recorder (K9) on the CPU: its plain
version (mapping/record.py::_record_per_base_torch, which CPU tensors
take) against gramtools_tpu/mapping/record_jax.py::_record_per_base_device,
the derived node table the CUDA walk reads (``RecordTables.nt_step``)
against ``nt_walk`` and ``nt_edges``, and the order-free contract that
the CUDA kernels' atomics rely on.

Inputs: the replayed pool states of bench.py's mixed site graph (the
captured fused dispatch of tests/test_torch_record.py), every other
live state selected; integers throughout, tolerance 0.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gramtools_tpu.mapping import record_jax as rj
from gramtools_tpu.prg.linearise import prg_string_to_ints
from gramtools_tpu_torch.mapping import record as tr
from gramtools_tpu_torch.mapping import search_log_host as host
from gramtools_tpu_torch.ops import walk as walk_ops

from test_search_jax import HARD_NESTED_PRGS, random_prg
from test_torch_record import Case
from test_torch_twins import twin_index


@pytest.fixture(scope="module")
def site_case():
    mp = pytest.MonkeyPatch()
    try:
        return Case("sites", mp)
    finally:
        mp.undo()


def _inputs(case):
    """The per-base recorder's inputs (numpy): the site graph's replayed
    pool states, every other live one selected."""
    rid, lo, hi = case.scan[:3]
    trav, n_trav = case.replay_pair()[1][:2]
    R = case.R
    return dict(ps_row=np.clip(rid, 0, R - 1).astype(np.int32), ps_lo=lo,
                ps_hi=hi, ps_trav=trav, ps_ntrav=n_trav,
                st_selected=(rid >= 0) & (np.arange(rid.size) % 2 == 0),
                row_len=case.np["row_len"],
                fallback=np.zeros(R, np.int32))


def _last_base_state(case, ins):
    """Appends one selected state whose walk covers the node that ends
    the coverage array through its last base, so that its envelope's
    end boundary is slot cov_size."""
    rt = case.trt
    covs = rt.nt_cov_start.numpy()
    seq_len = rt.nt_walk.numpy()[:, 1]
    ends = np.where(covs >= 0, covs + seq_len, -1)
    node = int(np.argmax(ends))
    assert ends[node] == rt.cov_size
    first_base = np.flatnonzero((rt.ra_node.numpy() == node)
                                & (rt.ra_offset.numpy() == 0))
    sa = case.tdi.sa.numpy()[:case.tdi.size]
    s = int(np.flatnonzero(np.isin(sa, first_base))[0])
    row = int(np.argmax(ins["row_len"]))
    assert ins["row_len"][row] >= seq_len[node]
    out = dict(ins)
    for name, value in (("ps_row", row), ("ps_lo", s), ("ps_hi", s),
                        ("ps_ntrav", 0), ("st_selected", True)):
        out[name] = np.append(ins[name], np.asarray(value, ins[name].dtype))
    out["ps_trav"] = np.concatenate([ins["ps_trav"], np.zeros(
        (1,) + ins["ps_trav"].shape[1:], ins["ps_trav"].dtype)])
    return out


ORDER = ("ps_row", "ps_lo", "ps_hi", "ps_trav", "ps_ntrav", "st_selected",
         "row_len", "fallback")


@pytest.mark.parametrize("name", ["fallback_preset", "last_base"])
def test_per_base_plain_equals_jax(site_case, name):
    """The plain version (the CPU route of _record_per_base_device) and
    the JAX function: the same fallback bits and cov_diff, with groups
    dropped by preset fallback rows and with an envelope that ends at
    slot cov_size (the default, wcap16 and emitcap16 cases are
    tests/test_torch_record.py::test_record_per_base_equal)."""
    ins = _inputs(site_case)
    R = site_case.R
    _, _, wcap, emitcap, _ = host.buffer_caps(R)
    if name == "fallback_preset":
        ins["fallback"] = np.where(np.arange(R) % 3 == 0, host.FB_DUP_SITE,
                                   0).astype(np.int32)
    elif name == "last_base":
        ins = _last_base_state(site_case, ins)
    cov0 = np.zeros(site_case.cov_size + 1, np.int32)
    args = [ins[k] for k in ORDER]
    j_cov, j_fb = rj._record_per_base_device(
        site_case.jdi, site_case.jrt, *(jnp.asarray(x) for x in args),
        jnp.asarray(cov0), wcap, emitcap)
    t_cov = torch.from_numpy(cov0.copy())
    t_fb = tr._record_per_base_device(
        site_case.tdi, site_case.trt, *(torch.from_numpy(x) for x in args),
        t_cov, wcap, emitcap)
    np.testing.assert_array_equal(np.asarray(j_fb), t_fb.numpy())
    np.testing.assert_array_equal(np.asarray(j_cov), t_cov.numpy())
    cov = t_cov.numpy()
    assert cov.any()
    if name == "fallback_preset":
        # the preset rows' groups are dropped: fewer boundaries
        _, base = _run_plain(site_case, _inputs(site_case), wcap, emitcap)
        assert np.abs(cov).sum() < np.abs(base).sum()
    if name == "last_base":
        assert cov[site_case.cov_size] < 0


def _run_plain(case, ins, wcap, emitcap):
    cov = torch.zeros(case.cov_size + 1, dtype=torch.int32)
    fb = tr._record_per_base_torch(
        case.tdi, case.trt, *(torch.from_numpy(ins[k]) for k in ORDER), cov,
        wcap, emitcap)
    return fb.numpy(), cov.numpy()


@pytest.mark.parametrize("seed", [1, 2])
def test_per_base_does_not_depend_on_lane_order(site_case, seed):
    """The order-free contract the CUDA kernels' atomics rely on: the
    walk lanes in any order give the same spill flag (so the same
    fallback bits) and, through the (row, node) envelope, the same
    cov_diff."""
    ins = {k: torch.from_numpy(v) for k, v in _inputs(site_case).items()}
    case, rt = site_case, site_case.trt
    _, _, wcap, emitcap, _ = host.buffer_caps(case.R)
    lanes, _ = tr._walk_lanes(case.tdi, rt, ins["ps_row"], ins["ps_lo"],
                              ins["ps_hi"], ins["ps_ntrav"],
                              ins["st_selected"], ins["row_len"], wcap)
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(wcap))
    covs = []
    for order in (torch.arange(wcap), perm):
        emits, spill = walk_ops.walk_torch(
            rt.nt_walk, rt.nt_edges, *(x[order] for x in lanes),
            ins["ps_trav"], emitcap, rt.n_nodes + 2)
        assert not bool(spill)
        cov = torch.zeros(case.cov_size + 1, dtype=torch.int32)
        tr._add_envelopes(rt, emits, ins["fallback"], cov)
        covs.append(cov)
    assert torch.equal(covs[0], covs[1]) and covs[0].any()
    fb, cov = _run_plain(case, _inputs(case), wcap, emitcap)
    assert not fb.any() and np.array_equal(cov, covs[0].numpy())


@pytest.mark.parametrize("prg", [f"nested{i}" for i in
                                 range(len(HARD_NESTED_PRGS))]
                         + [f"random{s}" for s in (1, 4, 9)])
def test_step_table_agrees_with_walk_tables(prg):
    """nt_step (port only) carries each node's nt_walk row and the
    targets of its first two out-edges; checked against the JAX
    package's nt_walk and nt_edges on every node."""
    if prg.startswith("nested"):
        prg_str = HARD_NESTED_PRGS[int(prg[6:])]
    else:
        prg_str = random_prg(np.random.RandomState(int(prg[6:])), nested=True)
    j_idx, idx = twin_index(prg_string_to_ints(prg_str))
    jrt = rj.RecordTables.build(j_idx)
    step = tr.RecordTables.build(idx, "cpu").nt_step.numpy()
    walk_rows = np.asarray(jrt.nt_walk)
    edges = np.asarray(jrt.nt_edges)
    np.testing.assert_array_equal(step[:, :4], walk_rows)
    for node, (n_edges, _, _, off) in enumerate(walk_rows):
        for k in (0, 1):
            want = edges[off + k] if n_edges > k else -1
            assert step[node, 4 + k] == want, (node, k)
    assert not step[:, 6:].any()
    assert (walk_rows[:, 0] > 1).any()           # bubble entries exist
