"""K6 in the scan kernels: the 2-bit packed reads decoded where a base is
loaded, on the CPU.

The scan kernels (csrc/scan_common.cuh, ``Reads`` and ``read_base``)
decode base (window step s, read rc) of a packed matrix of ``total``
steps as: global step g = step0 + s, byte packed[g >> 2, rc], code
((byte >> 2 (g & 3)) & 3) + 1 where g < clamp(row_len[rc] - k, 0,
total), else 0. ``decode_np`` mirrors that in numpy; it must equal the
JAX package's ``_unpack_reads2`` (search_jax_log.py) at every window
offset 0-7, for rows shorter than k, of exactly k, past k + steps and of
length 0 (padding rows), and two deliberate mutations of the mirror
(the shift off by one step, the row body off by one) must not. The
port's plain version (``ops/packed_reads.py``: ``unpack_reads2``,
``PackedReads`` windows) must equal it too.

Then the packed route of ``search_log._scan_phases`` (a ``PackedReads``
in place of int32 rows, as ``log_search_record`` passes it; its twins
unpack each run's window) must give the int32 route's final carry,
flags and log, and JAX's ``_record_body`` seam (``_unpack_reads2``, the
carry from the seed tables, ``_log_search_phases``), on one captured
fused dispatch of a site graph (wide, hole-allocated and locked phases)
and of a nested one (wide phases). Integers: exact equality.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gramtools_tpu.mapping import search_jax_log as jsl
from gramtools_tpu_torch.mapping import search_log as tsl
from gramtools_tpu_torch.ops.packed_reads import PackedReads, unpack_reads2

from test_torch_record import Case

K = 5


def decode_np(packed, row_len, k, total, step0, S, shift=0, body_off=0):
    """The kernels' decode of window [step0, step0 + S) in numpy:
    (S, R) int32. ``shift`` and ``body_off`` mutate it (0: the kernels'
    own)."""
    R = packed.shape[1]
    g = (step0 + np.arange(S))[:, None] + np.zeros((1, R), np.int64)
    rc = np.arange(R)[None, :] + np.zeros((S, 1), np.int64)
    byte = packed[g >> 2, rc].astype(np.int64)
    code = ((byte >> (2 * ((g + shift) & 3))) & 3) + 1
    body = np.clip(row_len.astype(np.int64) - k, 0, total)[None, :]
    return np.where(g < body + body_off, code, 0).astype(np.int32)


def _matrix(seed, total, R=64):
    rng = np.random.RandomState(seed)
    packed = rng.randint(0, 256, size=(-(-total // 4), R)).astype(np.uint8)
    row_len = rng.randint(0, K + total + 4, size=R)
    # below k, exactly k, one past k, past k + total, a padding row
    row_len[:5] = [K - 1, K, K + 1, K + total + 7, 0]
    return packed, row_len.astype(np.int32)


def _jax(packed, row_len, total):
    return np.asarray(jsl._unpack_reads2(jnp.asarray(packed),
                                         jnp.asarray(row_len), total, K))


@pytest.mark.parametrize("step0", range(8))
def test_decode_mirror_equals_jax_at_every_offset(step0):
    total = step0 + 13
    packed, row_len = _matrix(step0, total)
    S = total - step0
    want = _jax(packed, row_len, total)[step0:]
    got = decode_np(packed, row_len, K, total, step0, S)
    np.testing.assert_array_equal(got, want)
    assert (want[:, 4] == 0).all() and (want[:, 0] == 0).all()  # no body
    assert (got > 0).any() and (got == 0).any()


@pytest.mark.parametrize("mutation", ["shift", "body"])
def test_decode_mirror_mutations_fail(mutation):
    """The check can fail: the mirror with its 2-bit shift one step off,
    or with a row's body one step longer, differs from JAX."""
    total = 19
    packed, row_len = _matrix(3, total)
    want = _jax(packed, row_len, total)[3:]
    kw = {"shift": 1} if mutation == "shift" else {"body_off": 1}
    bad = decode_np(packed, row_len, K, total, 3, total - 3, **kw)
    assert not np.array_equal(bad, want)


@pytest.mark.parametrize("step0,stop", [(0, 19), (3, 11), (5, 6), (4, 4),
                                        (7, 19)])
def test_plain_unpack_and_windows_equal_jax(step0, stop):
    total = 19
    packed, row_len = _matrix(7, total)
    full = PackedReads(torch.from_numpy(packed), torch.from_numpy(row_len),
                       K, total)
    want = _jax(packed, row_len, total)
    np.testing.assert_array_equal(
        unpack_reads2(full.packed, full.row_len, total, K).numpy(), want)
    window = full[step0:stop]
    assert window.shape == (stop - step0, packed.shape[1])
    np.testing.assert_array_equal(window.unpack().numpy(),
                                  want[step0:stop])
    # a window of a window: offsets add up
    inner = window[1:]
    np.testing.assert_array_equal(inner.unpack().numpy(),
                                  want[step0 + 1:stop])
    np.testing.assert_array_equal(
        decode_np(packed, row_len, K, total, window.start,
                  window.shape[0]), want[step0:stop])


def test_packed_window_rejects_bad_slices():
    packed, row_len = _matrix(1, 8)
    full = PackedReads(torch.from_numpy(packed), torch.from_numpy(row_len),
                       K, 8)
    with pytest.raises(TypeError):
        full[::2]
    with pytest.raises(ValueError):
        PackedReads(full.packed, full.row_len, K, 8, 3, 9)


@pytest.fixture(scope="module", params=["sites", "nested"])
def case(request):
    mp = pytest.MonkeyPatch()
    try:
        yield Case(request.param, mp)
    finally:
        mp.undo()


def _carry(case):
    a = case.np
    st = case.tst
    ok = torch.from_numpy(a["slot_sidx"]) >= 0
    sidc = torch.from_numpy(a["slot_sidx"]).clamp(0, st.n_states - 1)
    return (torch.where(ok, torch.from_numpy(a["slot_row"]), -1),
            torch.where(ok, st.k_lo[sidc], 0),
            torch.where(ok, st.k_hi[sidc], 0),
            torch.where(ok, -(torch.from_numpy(a["slot_sidx"]) + 1), 0),
            torch.zeros(case.R, dtype=torch.bool))


def test_packed_route_equals_int32_route_and_jax(case):
    """_scan_phases on the PackedReads of one fused dispatch: the int32
    route's carry, flags and log (Case.scan), and JAX's _record_body
    seam."""
    a = case.np
    steps = sum(e[0] for e in case.phases)
    reads = PackedReads(torch.from_numpy(a["reads_p"]),
                        torch.from_numpy(a["row_len"]), case.k, steps)
    L = tsl._log_length(case.tdi, case.phases)
    lp = torch.full((L,), -7, dtype=torch.int32)
    le = torch.full((L,), -7, dtype=torch.int32)
    out = tsl._scan_phases(case.tdi, reads, _carry(case), case.phases,
                           case.R, None, lp, le)
    got = [t.numpy() for t in out] + [lp.numpy(), le.numpy()]
    for g, w in zip(got, case.scan):
        np.testing.assert_array_equal(g, w)
    # JAX: _record_body's unpack, carry and scan
    jst = case.jst
    sidx = jnp.asarray(a["slot_sidx"])
    ok = sidx >= 0
    sidc = jnp.clip(sidx, 0, jst.n_states - 1)
    jcarry = (jnp.where(ok, jnp.asarray(a["slot_row"]), -1).astype(jnp.int32),
              jnp.where(ok, jst.k_lo[sidc], 0).astype(jnp.int32),
              jnp.where(ok, jst.k_hi[sidc], 0).astype(jnp.int32),
              jnp.where(ok, -(sidx + 1), 0).astype(jnp.int32),
              jnp.zeros((case.R,), bool))
    reads_T = jsl._unpack_reads2(jnp.asarray(a["reads_p"]),
                                 jnp.asarray(a["row_len"]), steps, case.k)
    (rid, lo, hi, pref, ovf), (jlp, jle) = jsl._log_search_phases(
        case.jdi, reads_T, jcarry, case.phases, case.R)
    for g, w in zip(got, (rid, lo, hi, pref, ovf, jlp, jle)):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert (got[0] >= 0).any()
