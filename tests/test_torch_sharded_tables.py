"""K10, the SA-range-sharded index, on the CPU: the gathers of the
round-split scan and the scan itself.

The sharded scan's kernels (csrc/sharded_step.cu) gather row r of a
table split into S shards of rps rows as: r clamped as the gather
clamps it, owner shard r // rps, local row r - owner · rps; each card
loads the row where it holds the owner shard and gives 0 where it does
not (its masked gathers, summed over the shards it holds), and the
cards' answers are summed (an all-reduce between launches).
``owner_load_np`` mirrors that in numpy, the shards grouped by card; it
must equal the JAX package's masked local gather of every "idx" shard
plus the ``psum`` over the axis (the expression of
gramtools_tpu/parallel/sharded_index.py's ``occ_rows`` and
``narrow_rows``, run under ``shard_map`` on the 8 virtual CPU devices)
for S = 1, 2, 3, 4 and 8 (a shard a card, and several shards on one
card beside cards of one), rows at every shard edge, rows past n and
below 0 (clamped), and a table whose last shards hold only padding; two
deliberate mutations of the mirror (the owner one shard off, the local
row one off) must not. The port's plain version
(``ops/sharded._sharded_gather``, the ``ShardedTables`` gathers) must
equal it too, also past the kernels' 8 shards a card (which only their
argument check refuses).

Then the scan in rounds, simulated: every card of a mesh row runs the
torch steps (``scan_steps.run_phases``) in a thread of its own, each of
their gathers (the four gather points of a step) its own shards' masked
gathers followed by a psum over the cards (a barrier and a sum); every
card must end with the same carry and log, equal bit for bit to JAX's
``make_index_sharded_log_search`` on an "idx" mesh of 2, 4 and 8 CPU
devices and on a 2 x 2 ("data", "idx") mesh, with a wide plan and the
auto plan; a round whose psum one card skips must fail that check.

Then the ``ShardedTables`` route: ``make_index_sharded_log_search``
hands each data shard's tables to ``_scan_phases``, which runs the plan
through ``ops/sharded.sharded_scan`` (the kernels on CUDA; the torch
steps over the plain gathers here), on an "idx" mesh of 3 shards (rows
a shard do not divide n + 1) and a ("data", "idx") mesh of 2 x 3; its
final carry and log must equal the JAX package's
``make_index_sharded_log_search`` and the replicated scan's; on 10
shards (more than the kernels take on one card) the replicated scan's.
Exact equality.
"""
import threading

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
from gramtools_tpu_torch.mapping.scan_steps import run_phases
from gramtools_tpu_torch.mapping.search_log_host import (LogConfig, _phase4,
                                                         auto_phases)
from gramtools_tpu_torch.ops.sharded import (ShardedTables, build_tables,
                                             check_tables, shard_occ)
from gramtools_tpu_torch.parallel.mesh import Mesh
from gramtools_tpu_torch.parallel.sharded_index import \
    make_index_sharded_log_search

from test_sharded_index import PHASES, seeded_batch
from test_torch_sharded_index import _assert_equal, _replicated, _torch, setup  # noqa: F401


def owner_load_np(padded, rps, rows, lo, hi, cards=None, owner_off=0,
                  local_off=0):
    """The kernels' gather of ``rows`` from the shards of ``padded`` (S ·
    rps rows), the shards grouped by card (``cards``: each card's shard
    indices; None: a shard a card): clamp to [lo, hi], owner r // rps,
    local r - owner · rps; each card's answer the row where it holds the
    owner, else 0; the cards' answers summed. ``owner_off`` and
    ``local_off`` mutate it (0: the kernels' own)."""
    S = padded.shape[0] // rps
    cards = [[i] for i in range(S)] if cards is None else cards
    r = np.clip(rows, lo, hi)
    s = np.clip(r // rps + owner_off, 0, S - 1)
    local = np.clip(r - s * rps + local_off, 0, rps - 1)
    shards = padded.reshape(S, rps, *padded.shape[1:])
    total = np.zeros_like(shards[s, local])
    for held in cards:
        mine = np.isin(s, held)
        if total.ndim > mine.ndim:
            mine = mine[:, None]
        total = total + np.where(mine, shards[s, local], 0)
    return total


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


@pytest.mark.parametrize("width", [4, 0])
@pytest.mark.parametrize("cards", [[[0, 1, 2], [3]], [[0], [1, 2], [3]],
                                   [[0, 1, 2, 3, 4], [5], [6, 7]],
                                   [[0, 2], [1, 3]]])
def test_owner_load_mirror_groups_shards_by_card(cards, width):
    """Several shards on one card and the rest on others (a card's
    shards need not be neighbours): the cards' masked gathers, summed,
    equal JAX's gathers and psum over a shard a device."""
    S = sum(len(c) for c in cards)
    n = 41
    rows_in = n + 1 if width else n
    hi = n if width else n - 1
    table = _table(rows_in, width, S + width)
    padded, rps = shard_occ(table if width else table[:, None], S)
    if not width:
        padded = padded[:, 0]
    rows = _edge_rows(rows_in, rps, S, S)
    want = jax_gather_psum(padded, rps, rows, 0, hi, S)
    np.testing.assert_array_equal(
        owner_load_np(padded, rps, rows, 0, hi, cards), want)


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
    assert not np.array_equal(
        owner_load_np(padded, rps, rows, 0, 37, [[0, 1], [2]], **kw), want)


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
    """The kernels hold 8 shard pointers a table on each card: their
    argument check refuses 9 shards on one device before it looks at
    the device's kind, and takes 8 on it (refusing them then only for
    not lying on a CUDA card)."""
    n = 29
    occ, nt = _table(n + 1, 4, 1), _table(n, 0, 2)
    t = build_tables(occ, nt, n, ["cpu"] * 9, "cpu")
    with pytest.raises(ValueError, match="at most 8 shards of a table on "
                                         "one card, 9 on cpu"):
        check_tables("sharded_rounds", t, n)
    t = build_tables(occ, nt, n, ["cpu"] * 8, "cpu")
    with pytest.raises(ValueError, match="on a CUDA card"):
        check_tables("sharded_rounds", t, n)


def _routed(monkeypatch):
    """Record each scan-kernel call: (name, the occ source or the phase
    kinds of its plan)."""
    seen = []
    for name in ("wide_steps", "locked_tail"):
        fn = getattr(search_log, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            seen.append((_name, "dense or packed"))
            return _fn(*args, **kwargs)
        monkeypatch.setattr(search_log, name, wrapped)
    fn = search_log.sharded_scan

    def sharded(di, reads, carry, plan, *args, _fn=fn):
        assert isinstance(args[-1], ShardedTables)
        seen.append(("sharded_scan",
                     tuple("wide" if e[3] == 0 else e[4] or "narrow"
                           for e in plan)))
        return _fn(di, reads, carry, plan, *args)
    monkeypatch.setattr(search_log, "sharded_scan", sharded)
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
    assert [name for name, _ in seen] == ["sharded_scan"]
    kinds = set(seen[0][1])
    assert kinds == ({"wide"} if plan == "wide"
                     else {"wide", "narrow", "locked"})
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
    assert [name for name, _ in seen] == ["sharded_scan"] * 2  # a data shard
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


# --------------------------------------------------------------------------
# the scan in rounds, simulated: a thread a card, a psum at each gather
# --------------------------------------------------------------------------

class _Row:
    """The cards of one mesh row, simulated: card c holds the shards
    ``groups[c]`` of ``tables`` and runs the torch steps in a thread of
    its own; each of its gathers is its shards' masked gathers summed,
    then a psum over the cards (every card puts its answer, a barrier,
    the sum). ``skip`` = (gather number, card): that card keeps its own
    answer of that gather, skipping the psum (a mutation). ``partial``
    gets the (gather number, card) pairs whose own answer is not the sum
    at a row past 1 (rows 0 and 1 are what the pool's empty slots
    gather)."""

    def __init__(self, tables, groups, skip=None):
        self.tables, self.groups, self.skip = tables, groups, skip
        self.barrier = threading.Barrier(len(groups), timeout=120)
        self.put = [None] * len(groups)
        self.partial = set()

    def _gather(self, c, shards, rps, lo, hi, counter):
        def gather(rows):
            r = rows.clamp(lo, hi)
            mine = None
            for i in self.groups[c]:
                local = r - i * rps
                ok = (local >= 0) & (local < rps)
                v = shards[i][local.clamp(0, rps - 1)]
                v = torch.where(ok[..., None] if v.dim() > ok.dim() else ok,
                                v, 0)
                mine = v if mine is None else mine + v
            k = counter[0]
            counter[0] += 1
            self.put[c] = mine
            self.barrier.wait()
            total = sum(self.put[1:], self.put[0])
            self.barrier.wait()
            off = mine != total
            if off.dim() > r.dim():
                off = off.any(dim=-1)
            if (off & (r > 1)).any():
                self.partial.add((k, c))
            return mine if self.skip == (k, c) else total
        return gather

    def scan(self, di, reads, carry, plan, R):
        """Every card's (final carry, (lp, le)) of the plan's scan."""
        t = self.tables
        L = sum(e[0] * e[2] for e in plan) * di.n_outcomes
        outs = [None] * len(self.groups)
        errors = []

        def card(c):
            counter = [0]
            lp = torch.empty(L, dtype=torch.int32)
            le = torch.empty(L, dtype=torch.int32)
            try:
                final, _ = run_phases(
                    di, reads, carry, plan, R, lp, le,
                    occ_rows=self._gather(c, t.occ, t.rows_per_shard, 0,
                                          t.size, counter),
                    narrow_rows=self._gather(c, t.narrow,
                                             t.nt_rows_per_shard, 0,
                                             t.size - 1, counter))
                outs[c] = (final, (lp, le))
            except Exception as e:      # noqa: BLE001 (re-raised below)
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=card, args=(c,))
                   for c in range(len(self.groups))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        return outs


def _rounds_scan(tdi, reads_T, carry, R, plan, groups, n_data=1, skip=None,
                 partial=None):
    """The simulated round-split scan of each data shard (its columns of
    the batch) on a row of cards holding ``groups`` of the index shards;
    asserts every card of a row ends with the same carry and log, and
    returns the rows' results concatenated in data-shard order, as
    make_index_sharded_log_search returns them."""
    S = sum(len(g) for g in groups)
    tables = build_tables(tdi.occ.numpy(), tdi.narrow_tab.numpy(), tdi.size,
                          ["cpu"] * S, "cpu")
    reads, carry = _torch(reads_T, carry)
    plan = [_phase4(e) for e in (plan or auto_phases(
        reads.shape[0], R, LogConfig(pool=64, hits=16), narrow=True))]
    parts = []
    for d in range(n_data):
        def cols(a):
            w = a.shape[-1] // n_data
            return a[..., d * w:(d + 1) * w]
        rid, lo, hi, pref, ovf = (cols(a) for a in carry)
        c_in = (rid.contiguous(), lo.contiguous(), hi.contiguous(),
                pref.contiguous(),
                torch.cat([ovf.to(torch.bool),
                           torch.zeros(1, dtype=torch.bool)]))
        row = _Row(tables, groups, skip)
        outs = row.scan(tdi, cols(reads).contiguous().to(torch.int32), c_in,
                        plan, R)
        if partial is not None:
            partial |= row.partial
        for other in outs[1:]:
            for a, b in zip(other[0] + other[1], outs[0][0] + outs[0][1]):
                assert torch.equal(a, b), "the cards of a row differ"
        (rid, lo, hi, pref, ovf), log = outs[0]
        parts.append(((rid, lo, hi, pref, ovf[:R]), log))
    cat = lambda xs: torch.cat(xs)
    return (tuple(cat([p[0][i] for p in parts]) for i in range(5)),
            tuple(cat([p[1][i] for p in parts]) for i in range(2)))


@pytest.mark.parametrize("plan", ["wide", "auto"])
@pytest.mark.parametrize("n_idx", [2, 4, 8])
def test_round_split_scan_equals_jax_idx_mesh(setup, n_idx, plan):
    """A card a shard on an "idx" mesh of 2, 4 and 8: every card's
    carry and log equal, and equal to JAX's index-sharded scan."""
    idx, jdi, tdi = setup
    phases = PHASES if plan == "wide" else None
    R = 6
    cfg = JaxLogConfig(pool=64, hits=16)
    reads_T, carry = seeded_batch(idx, np.random.RandomState(7), R, 16, cfg)
    got = _rounds_scan(tdi, reads_T, carry, R, phases,
                       [[i] for i in range(n_idx)])
    want = jax_index_sharded(
        JaxMesh(np.array(jax.devices()[:n_idx]), axis_names=("idx",)), jdi,
        cfg, R, phases=phases)(reads_T, jax.device_put(carry))
    _assert_equal(got, want)
    assert (got[1][0] >= 0).any()


@pytest.mark.parametrize("plan", ["wide", "auto"])
def test_round_split_scan_equals_jax_data_idx_mesh(setup, plan):
    """A 2 x 2 ("data", "idx") mesh: each data shard's row of two cards,
    equal to JAX's run on the same mesh."""
    idx, jdi, tdi = setup
    phases = PHASES if plan == "wide" else None
    R_shard = 4
    rng = np.random.RandomState(8)
    cfg = JaxLogConfig(pool=64, hits=16)
    halves = [seeded_batch(idx, rng, R_shard, 16, cfg) for _ in range(2)]
    reads_T = jnp.concatenate([h[0] for h in halves], axis=1)
    carry = tuple(np.concatenate(cs) for cs in zip(*[h[1] for h in halves]))
    got = _rounds_scan(tdi, reads_T, carry, R_shard, phases, [[0], [1]],
                       n_data=2)
    want = jax_index_sharded(
        JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2),
                axis_names=("data", "idx")), jdi, cfg, R_shard,
        phases=phases)(reads_T, jax.device_put(carry))
    _assert_equal(got, want)


@pytest.mark.parametrize("card", [0, 1])
def test_round_split_scan_skipped_psum_fails(setup, card):
    """The check can fail: the first gather whose answer on card 0
    (whose result is returned) or card 1 of a row of two is not the sum
    over the cards, with its psum skipped on that card, differs from
    JAX's scan, leaves the cards unequal or breaks the scan."""
    idx, jdi, tdi = setup
    R = 6
    cfg = JaxLogConfig(pool=64, hits=16)
    reads_T, carry = seeded_batch(idx, np.random.RandomState(7), R, 16, cfg)
    want = jax_index_sharded(
        JaxMesh(np.array(jax.devices()[:2]), axis_names=("idx",)), jdi, cfg,
        R, phases=PHASES)(reads_T, jax.device_put(carry))
    partial = set()
    _assert_equal(_rounds_scan(tdi, reads_T, carry, R, PHASES, [[0], [1]],
                               partial=partial), want)
    k = min(g for g, c in partial if c == card)
    # the wrong intervals may also drive a torch step out of its tables
    with pytest.raises((AssertionError, IndexError,
                        threading.BrokenBarrierError)):
        got = _rounds_scan(tdi, reads_T, carry, R, PHASES, [[0], [1]],
                           skip=(k, card))
        _assert_equal(got, want)
