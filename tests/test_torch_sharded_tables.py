"""K10 in the scan kernels: the SA-range-sharded tables read in place,
on the CPU.

The scan kernels (csrc/scan_common.cuh, ``occ_row`` and ``narrow_at``)
read row r of a table split into S shards of rps rows as: r clamped as
the gather clamps it, owner shard r // rps, local row r - owner · rps.
``owner_load_np`` mirrors that in numpy; it must equal the JAX package's
masked local gather of every "idx" shard plus the ``psum`` over the axis
(the expression of gramtools_tpu/parallel/sharded_index.py's
``occ_rows`` and ``narrow_rows``, run under ``shard_map`` on the 8
virtual CPU devices) for S = 1, 2, 3, 4 and 8, rows at every shard edge,
rows past n and below 0 (clamped), and a table whose last shards hold
only padding; two deliberate mutations of the mirror (the owner one
shard off, the local row one off) must not. The port's plain version
(``ops/sharded._sharded_gather``, the ``ShardedTables`` gathers) must
equal it too, also past the kernels' 8 shards (which only the kernels'
argument check refuses).

Then the ``ShardedTables`` route: ``make_index_sharded_log_search``
hands each data shard's tables to ``_scan_phases``, which runs the plan
through ``wide_steps`` and ``locked_tail`` with ``tables=`` (the kernels
on CUDA; their twins, over the plain gathers, here), on an "idx" mesh of
3 shards (rows a shard do not divide n + 1) and a ("data", "idx") mesh
of 2 x 3; its final carry and log must equal the JAX package's
``make_index_sharded_log_search`` and the replicated scan's; on 10
shards (more than the kernels take) the replicated scan's. Exact
equality.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:                                   # older jax
    from jax.experimental.shard_map import shard_map

from gramtools_tpu.mapping.search_jax_log import LogConfig as JaxLogConfig
from gramtools_tpu.parallel.sharded_index import \
    make_index_sharded_log_search as jax_index_sharded
from gramtools_tpu_torch.mapping import search_log
from gramtools_tpu_torch.mapping.search_log_host import LogConfig
from gramtools_tpu_torch.ops.locked_step import check_tables
from gramtools_tpu_torch.ops.sharded import (ShardedTables, build_tables,
                                             shard_occ)
from gramtools_tpu_torch.parallel.mesh import Mesh
from gramtools_tpu_torch.parallel.sharded_index import \
    make_index_sharded_log_search

from test_sharded_index import PHASES, seeded_batch
from test_torch_sharded_index import _assert_equal, _replicated, _torch, setup  # noqa: F401


def owner_load_np(padded, rps, rows, lo, hi, owner_off=0, local_off=0):
    """The kernels' load of ``rows`` from the shards of ``padded`` (S ·
    rps rows): clamp to [lo, hi], owner r // rps, local r - owner · rps.
    ``owner_off`` and ``local_off`` mutate it (0: the kernels' own)."""
    S = padded.shape[0] // rps
    r = np.clip(rows, lo, hi)
    s = np.clip(r // rps + owner_off, 0, S - 1)
    local = np.clip(r - s * rps + local_off, 0, rps - 1)
    shards = padded.reshape(S, rps, *padded.shape[1:])
    return shards[s, local]


def jax_gather_psum(padded, rps, rows, lo, hi, n_shards):
    """The JAX module's masked local gather of each "idx" shard and the
    psum over the axis, under shard_map on n_shards CPU devices."""
    mesh = JaxMesh(np.array(jax.devices()[:n_shards]), axis_names=("idx",))

    def fn(local_tab, r):
        off = jax.lax.axis_index("idx") * rps
        r = jnp.clip(r, lo, hi)
        local = r - off
        ok = (local >= 0) & (local < rps)
        v = local_tab[jnp.clip(local, 0, rps - 1)]
        if v.ndim > ok.ndim:
            ok = ok[..., None]
        return jax.lax.psum(jnp.where(ok, v, 0), "idx")

    spec = P("idx", None) if padded.ndim == 2 else P("idx")
    run = shard_map(fn, mesh=mesh, in_specs=(spec, P()), out_specs=P(),
                    check_vma=False)
    return np.asarray(jax.jit(run)(jnp.asarray(padded), jnp.asarray(rows)))


def _table(n_rows, width, seed):
    rng = np.random.RandomState(seed)
    shape = (n_rows, width) if width else (n_rows,)
    return rng.randint(1, 2 ** 30, size=shape).astype(np.int32)


def _edge_rows(n_rows, rps, S, seed):
    """Every shard edge (first and last row of each shard, one either
    side), rows past the table and below 0, and random rows."""
    edges = np.array([i * rps + d for i in range(S + 1) for d in (-1, 0, 1)])
    rng = np.random.RandomState(seed)
    return np.concatenate([edges, [-3, -1, n_rows - 1, n_rows, n_rows + 5,
                                   2 ** 30],
                           rng.randint(-2, n_rows + 3, size=200)]
                          ).astype(np.int32)


@pytest.mark.parametrize("width", [4, 0])       # occ (n + 1, 4), narrow (n,)
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_owner_load_mirror_equals_jax_gather_psum(n_shards, width):
    n = 37                                # occ: n + 1 rows, narrow: n rows
    rows_in = n + 1 if width else n
    hi = n if width else n - 1
    table = _table(rows_in, width, n_shards)
    padded, rps = shard_occ(table if width else table[:, None], n_shards)
    if not width:
        padded = padded[:, 0]
    rows = _edge_rows(rows_in, rps, n_shards, n_shards + width)
    want = jax_gather_psum(padded, rps, rows, 0, hi, n_shards)
    np.testing.assert_array_equal(owner_load_np(padded, rps, rows, 0, hi),
                                  want)
    np.testing.assert_array_equal(want, table[np.clip(rows, 0, hi)])


def test_owner_load_with_padding_only_shards():
    """10 rows in 8 shards of 2: shards 5-7 hold only padding and are
    never addressed; row n (clamped) is in shard 4."""
    table = _table(10, 4, 3)
    padded, rps = shard_occ(table, 8)
    assert rps == 2 and not padded[10:].any()
    rows = _edge_rows(10, rps, 8, 1)
    got = owner_load_np(padded, rps, rows, 0, 9)
    np.testing.assert_array_equal(got, jax_gather_psum(padded, rps, rows, 0,
                                                       9, 8))
    assert (np.clip(rows, 0, 9) // rps).max() == 4


@pytest.mark.parametrize("mutation", ["owner", "local"])
def test_owner_load_mirror_mutations_fail(mutation):
    """The check can fail: the owner one shard off, or the local row one
    off, differs from JAX's gathers."""
    table = _table(38, 4, 9)
    padded, rps = shard_occ(table, 3)
    rows = _edge_rows(38, rps, 3, 2)
    want = jax_gather_psum(padded, rps, rows, 0, 37, 3)
    kw = {"owner_off": 1} if mutation == "owner" else {"local_off": 1}
    assert not np.array_equal(owner_load_np(padded, rps, rows, 0, 37, **kw),
                              want)


@pytest.mark.parametrize("n_shards", [1, 3, 8, 10])
def test_plain_gathers_equal_mirror(n_shards):
    """ShardedTables' plain gathers (``_sharded_gather``) on the tables
    build_tables lays out: the mirror's loads."""
    n = 29
    occ = _table(n + 1, 4, 1)
    nt = _table(n, 0, 2)
    t = build_tables(occ, nt, n, ["cpu"] * n_shards, "cpu")
    assert t.n_shards == n_shards and t.has_narrow
    rows = _edge_rows(n + 1, t.rows_per_shard, n_shards, 4)
    occ_pad = torch.cat(t.occ).numpy()
    nt_pad = torch.cat(t.narrow).numpy()
    np.testing.assert_array_equal(
        t.occ_rows()(torch.from_numpy(rows)).numpy(),
        owner_load_np(occ_pad, t.rows_per_shard, rows, 0, n))
    np.testing.assert_array_equal(
        t.narrow_rows()(torch.from_numpy(rows)).numpy(),
        owner_load_np(nt_pad, t.nt_rows_per_shard, rows, 0, n - 1))
    no_narrow = build_tables(occ, None, n, ["cpu"] * n_shards, "cpu")
    assert no_narrow.narrow_rows() is None


def test_kernel_arguments_refuse_more_than_8_shards():
    """The kernels hold 8 shard pointers a table: their argument check
    refuses 9 shards before it looks at a device."""
    n = 29
    t = build_tables(_table(n + 1, 4, 1), _table(n, 0, 2), n, ["cpu"] * 9,
                     "cpu")
    with pytest.raises(ValueError, match="1 to 8 shards"):
        check_tables("wide_steps_cuda", t, n, torch.device("cpu"))


def _routed(monkeypatch):
    """Record the occ source each scan-kernel call gets."""
    seen = []
    for name in ("wide_steps", "locked_tail"):
        fn = getattr(search_log, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            seen.append((_name, type(kwargs.get("tables")).__name__))
            return _fn(*args, **kwargs)
        monkeypatch.setattr(search_log, name, wrapped)
    return seen


@pytest.mark.parametrize("plan", ["wide", "auto"])
def test_sharded_tables_route_equals_jax_idx_mesh(setup, monkeypatch, plan):
    idx, jdi, tdi = setup
    phases = PHASES if plan == "wide" else None
    R, n_idx = 6, 3
    cfg = JaxLogConfig(pool=64, hits=16)
    reads_T, carry = seeded_batch(idx, np.random.RandomState(2), R, 16, cfg)
    mesh = Mesh(["cpu"] * n_idx, ("idx",))
    assert (tdi.size + 1) % n_idx != 0           # the last shard is short
    seen = _routed(monkeypatch)
    got = make_index_sharded_log_search(mesh, tdi, LogConfig(64, 16), R,
                                        phases=phases)(*_torch(reads_T, carry))
    kinds = {name for name, _ in seen}
    assert {t for _, t in seen} == {"ShardedTables"}
    assert kinds == ({"wide_steps"} if plan == "wide"
                     else {"wide_steps", "locked_tail"})
    monkeypatch.undo()
    want = jax_index_sharded(
        JaxMesh(np.array(jax.devices()[:n_idx]), axis_names=("idx",)), jdi,
        cfg, R, phases=phases)(reads_T, jax.device_put(carry))
    _assert_equal(got, want)
    _assert_equal(got, _replicated(tdi, reads_T, carry, R, phases))


def test_sharded_tables_route_past_8_shards_equals_replicated(setup):
    """An "idx" mesh of 10 CPU shards runs the twins over the plain
    gathers (the kernels' 8-shard limit is theirs alone): equal to the
    replicated scan."""
    idx, _, tdi = setup
    R = 6
    reads_T, carry = seeded_batch(idx, np.random.RandomState(4), R, 16,
                                  JaxLogConfig(pool=64, hits=16))
    got = make_index_sharded_log_search(
        Mesh(["cpu"] * 10, ("idx",)), tdi, LogConfig(64, 16), R)(
        *_torch(reads_T, carry))
    _assert_equal(got, _replicated(tdi, reads_T, carry, R, None))


def test_sharded_tables_route_equals_jax_data_idx_mesh(setup, monkeypatch):
    """(2, 3) ("data", "idx") mesh, auto plan: each data shard's scan
    runs on its own ShardedTables, equal to the JAX package's run."""
    idx, jdi, tdi = setup
    R_shard = 4
    rng = np.random.RandomState(3)
    cfg = JaxLogConfig(pool=64, hits=16)
    halves = [seeded_batch(idx, rng, R_shard, 16, cfg) for _ in range(2)]
    reads_T = jnp.concatenate([h[0] for h in halves], axis=1)
    carry = tuple(np.concatenate(cs) for cs in zip(*[h[1] for h in halves]))
    seen = _routed(monkeypatch)
    got = make_index_sharded_log_search(
        Mesh([["cpu"] * 3] * 2, ("data", "idx")), tdi, LogConfig(64, 16),
        R_shard)(*_torch(reads_T, carry))
    assert {t for _, t in seen} == {"ShardedTables"}
    assert len(seen) == 4                    # K2 and K3 a data shard
    monkeypatch.undo()
    want = jax_index_sharded(
        JaxMesh(np.array(jax.devices()[:6]).reshape(2, 3),
                axis_names=("data", "idx")), jdi, cfg, R_shard)(
        reads_T, jax.device_put(carry))
    _assert_equal(got, want)


def test_sharded_tables_share_uploads_between_rows():
    """Two mesh rows placing shard i on one device share its upload."""
    occ, nt = _table(21, 4, 5), _table(20, 0, 6)
    resident = {}
    a = build_tables(occ, nt, 20, ["cpu"] * 2, "cpu", resident)
    b = build_tables(occ, nt, 20, ["cpu"] * 2, "cpu", resident)
    assert all(x is y for x, y in zip(a.occ + a.narrow, b.occ + b.narrow))
    assert isinstance(a, ShardedTables) and len(resident) == 4
