"""The port's mutable-precision SGEMM against the JAX package's.

`gemmul8_tpu_torch.ops.mpgemm` on the CPU: the accuracy ladder of
tests/test_mpgemm.py, each mode against `gemmul8_tpu.ops.mpgemm.mp_gemm`
within 1e-6 of sum |a||b| (the bf16 parts are the same; the f32 sums run
in another order), `exp_stats` equal, `gemm_Mx2x2` bit for bit against
numpy's separate operations, the ExpStatsHandle call sequence and
`mp_cgemm`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemmul8_tpu.ops import mpgemm as jm
from gemmul8_tpu_torch.bench.matrices import phi_matrix, relerr_stats
from gemmul8_tpu_torch.ops import mpgemm as pm

from test_torch_threads import one_torch_thread  # noqa: E402, F401

RTOL = 1e-6


@pytest.fixture(scope="module")
def data():
    a = phi_matrix(64, 256, 0.5, seed=600).astype(np.float32)
    b = phi_matrix(256, 64, 0.5, seed=601).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    return a, b, ref


def _mp(a, b, mode):
    c = pm.mp_gemm(a, b, mode, device="cpu")
    assert c.dtype == torch.float32
    return c.numpy().astype(np.float64)


def test_mode_accuracy_ladder(data):
    a, b, ref = data
    errs = {mode: relerr_stats(_mp(a, b, mode), ref)[1]
            for mode in (pm.Mode.BF16TC, pm.Mode.BF16X3, pm.Mode.BF16X6,
                         pm.Mode.NATIVE, pm.Mode.SCALING)}
    assert errs[pm.Mode.BF16X3] < errs[pm.Mode.BF16TC] / 10
    assert errs[pm.Mode.BF16X6] < errs[pm.Mode.BF16X3]
    assert errs[pm.Mode.BF16TC] > 1e-4       # plain bf16 is coarse
    assert errs[pm.Mode.BF16X3] < 5e-6       # corrected
    assert errs[pm.Mode.NATIVE] < 5e-7
    assert errs[pm.Mode.SCALING] < 5e-6


def test_auto_mode_picks_sane_path(data):
    a, b, ref = data
    assert relerr_stats(_mp(a, b, pm.Mode.AUTO), ref)[1] < 5e-6


@pytest.mark.parametrize("phi", [0.5, 2.0])
@pytest.mark.parametrize("mode", list(pm.Mode), ids=lambda m: m.name)
def test_mode_matches_jax(mode, phi):
    a = phi_matrix(64, 256, phi, seed=600).astype(np.float32)
    b = phi_matrix(256, 48, phi, seed=601).astype(np.float32)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    got = _mp(a, b, mode)
    want = np.asarray(jm.mp_gemm(jnp.asarray(a), jnp.asarray(b),
                                 jm.Mode(mode.value)), np.float64)
    assert np.all(np.abs(got - want) <= RTOL * scale), mode
    if mode == pm.Mode.BF16TC:      # and within its own (coarse) band
        ref = a.astype(np.float64) @ b.astype(np.float64)
        assert 1e-4 < relerr_stats(got, ref)[1] < 1e-2


def test_auto_takes_the_f32_branch_on_a_wide_range():
    """AUTO's host-side choice: an operand with most elements more than 16
    octaves under its max takes the f32 product, as the JAX cond does."""
    a = phi_matrix(32, 64, 0.5, seed=1).astype(np.float32)
    a[:, 1:] *= np.float32(2.0 ** -40)
    b = phi_matrix(64, 16, 0.5, seed=2).astype(np.float32)
    assert float(pm.exp_stats(a, device="cpu").lost_fraction) > 0.05
    got = pm.mp_gemm(a, b, pm.Mode.AUTO, device="cpu")
    assert torch.equal(got, pm.mp_gemm(a, b, pm.Mode.NATIVE, device="cpu"))
    want = np.asarray(jm.mp_gemm(a, b, jm.Mode.AUTO))
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    assert np.all(np.abs(got.numpy() - want) <= RTOL * scale)


def test_exp_stats():
    x = np.array([1.0, 2.0 ** -30, 4.0, 0.0], np.float32)
    s = pm.exp_stats(x, lose_threshold=16, device="cpu")
    assert int(s.max_exp) == 127 + 2
    assert int(s.total) == 3
    assert abs(float(s.lost_fraction) - 1 / 3) < 1e-6


@pytest.mark.parametrize("case", ["phi0.5", "phi6", "specials", "zeros"])
@pytest.mark.parametrize("lose", [4, 16])
def test_exp_stats_match_jax(case, lose):
    if case == "zeros":
        x = np.zeros((8, 8), np.float32)
    else:
        x = phi_matrix(40, 50, 6.0 if case == "phi6" else 0.5,
                       seed=9).astype(np.float32)
        if case == "specials":
            x[0, :5] = [0.0, -0.0, 1e-45, -1e-40, 3e38]
    got = pm.exp_stats(x, lose, device="cpu")
    want = jm.exp_stats(jnp.asarray(x), lose)
    assert got.max_exp.dtype == torch.int64 or got.max_exp.dtype == \
        torch.int32
    assert int(got.max_exp) == int(want.max_exp)
    assert int(got.total) == int(want.total)
    assert got.lost_fraction.dtype == torch.float32
    assert float(got.lost_fraction) == float(want.lost_fraction)


def _mx2x2_numpy(a, b):
    """numpy's separate multiplies and adds, in the JAX body's order."""
    a0, a1 = a[..., 0:1], a[..., 1:2]
    return np.concatenate(
        [a0 * b[..., 0:1, 0:1] + a1 * b[..., 1:2, 0:1],
         a0 * b[..., 0:1, 1:2] + a1 * b[..., 1:2, 1:2]], axis=-1)


def test_gemm_mx2x2_matches_numpy_bits():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((257, 2)).astype(np.float32)
    b = rng.standard_normal((2, 2)).astype(np.float32)
    got = pm.gemm_Mx2x2(a, b, device="cpu").numpy()
    want = _mx2x2_numpy(a, b)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # the JAX words within 1 ulp (XLA may contract its multiply-adds, C9)
    jw = np.asarray(jm.gemm_Mx2x2(jnp.asarray(a), jnp.asarray(b)))
    ulp = np.spacing(np.maximum(np.abs(jw), np.abs(want)))
    assert np.all(np.abs(got - jw) <= ulp)
    # mp_gemm reroutes (m, 2) x (2, 2) in every mode
    for mode in pm.Mode:
        assert np.array_equal(
            pm.mp_gemm(a, b, mode, device="cpu").numpy(), got)
    # strided batch via leading dims
    ab = rng.standard_normal((3, 65, 2)).astype(np.float32)
    bb = rng.standard_normal((3, 2, 2)).astype(np.float32)
    gotb = pm.gemm_Mx2x2(ab, bb, device="cpu").numpy()
    assert np.array_equal(gotb.view(np.int32),
                          _mx2x2_numpy(ab, bb).view(np.int32))
    # complex: numpy's complex products and sums, to within an ulp of the
    # terms (a vectorised complex multiply may fuse its two products)
    az = (a + 0.3j * a).astype(np.complex64)
    bz = (b - 0.7j * b).astype(np.complex64)
    gz = pm.gemm_Mx2x2(az, bz, device="cpu").numpy()
    wz = _mx2x2_numpy(az, bz)
    tz = np.abs(az) @ np.abs(bz)
    assert np.all(np.abs(gz - wz) <= 4 * np.finfo(np.float32).eps * tz)
    with pytest.raises(ValueError):
        pm.gemm_Mx2x2(np.ones((4, 3), np.float32), b, device="cpu")


def test_mx2x2_toggle():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((257, 2)).astype(np.float32)
    b = rng.standard_normal((2, 2)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    pm.disable_custom_gemm_Mx2x2()
    try:
        coarse = pm.mp_gemm(a, b, pm.Mode.BF16TC, device="cpu").numpy()
        assert np.abs(coarse - want).max() > 1e-5
    finally:
        pm.enable_custom_gemm_Mx2x2()
    fine = pm.mp_gemm(a, b, pm.Mode.BF16TC, device="cpu").numpy()
    assert np.abs(fine - want).max() < 1e-5


def test_exp_stats_handle_sequence_matches_jax():
    xs = [phi_matrix(16, 24, phi, seed=i).astype(np.float32)
          for i, phi in enumerate((0.5, 3.0, 8.0, 1.0))]
    xs.append(np.zeros((4, 4), np.float32))
    jh, ph = jm.ExpStatsHandle(ring_size=3), pm.ExpStatsHandle(
        ring_size=3, device="cpu")
    for h in (jh, ph):
        h.enable_exp_stats()
        h.set_exp_stats_params(1e-30, 2.0 ** -10, 0.1)
    for x in xs:
        ids = (jh.exp_stats_ext(x), ph.exp_stats_ext(x))
        assert ids[0] == ids[1]
        assert jh.get_exp_stats(ids[0]) == ph.get_exp_stats(ids[1])
        assert jh.get_max_exp(ids[0]) == ph.get_max_exp(ids[1])
        assert (jh.get_exp_stats_compute_mode_level(ids[0]).value
                == ph.get_exp_stats_compute_mode_level(ids[1]).value)
        assert (jh.get_current_exp_stats_buffer_id()
                == ph.get_current_exp_stats_buffer_id())
        mid = (jh.exp_max_ext(x), ph.exp_max_ext(x))
        assert mid[0] == mid[1]
        assert jh.get_max_exp(mid[0]) == ph.get_max_exp(mid[1])
        # scaling by an exact power of two; the JAX factor comes from
        # XLA's CPU exp2 and log2, which are not exact at integers (221 of
        # the 254 normal f32 powers of two differ, C3), so its scaled
        # words lie some ulps off: held within 1e-5
        sa = ph.scale_A(ids[1], x).numpy()
        f = ph._scale_factor(ids[1])
        assert f == 2.0 ** round(np.log2(f))
        assert np.array_equal(sa, x * np.float32(f))
        assert np.allclose(sa, np.asarray(jh.scale_A(ids[0], x)),
                           rtol=1e-5, atol=0)
        assert np.array_equal(ph.reset_scale_A(ids[1], sa).numpy(), x)
        c = ph.scale_C(ids[1], ids[1], x).numpy()
        assert np.array_equal(c, x * np.float32(1 / f / f))
        assert np.allclose(c, np.asarray(jh.scale_C(ids[0], ids[0], x)),
                           rtol=1e-5, atol=0)
    assert sorted(ph._buffers) == sorted(jh._buffers)
    with pytest.raises(KeyError):
        ph.get_exp_stats(1)                  # fell off the 3-entry ring
    for h in (jh, ph):
        h.reset_exp_stats_buffer_id()
        h.disable_exp_stats()
    assert ph.get_current_exp_stats_buffer_id() == 0 and not ph.enabled
    assert isinstance(pm.default_handle(), pm.ExpStatsHandle)
    assert pm.default_handle() is pm.default_handle()


def test_cgemm(data):
    a, b, _ = data
    az = (a + 1j * (a * 0.7 + 0.1)).astype(np.complex64)
    bz = (b + 0.5j * b).astype(np.complex64)
    c = pm.mp_cgemm(az, bz, device="cpu")
    assert c.dtype == torch.complex64
    refz = az.astype(np.complex128) @ bz.astype(np.complex128)
    err = np.abs(c.numpy().astype(np.complex128) - refz) / np.abs(refz)
    assert np.median(err) < 1e-5
    want = np.asarray(jm.mp_cgemm(jnp.asarray(az), jnp.asarray(bz)))
    scale = (np.abs(az).astype(np.float64) @ np.abs(bz).astype(np.float64))
    assert np.all(np.abs(c.numpy() - want) <= 2 * RTOL * scale)
    for mode in (pm.Mode.BF16TC, pm.Mode.SCALING):
        got = pm.mp_cgemm(az, bz, mode, device="cpu").numpy()
        want = np.asarray(jm.mp_cgemm(az, bz, jm.Mode(mode.value)))
        assert np.all(np.abs(got - want) <= 2 * RTOL * scale)


def test_tf32_setting_restored():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pm.no_tf32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_numpy_operands_need_a_device_they_can_reach():
    a = np.ones((4, 4), np.float32)
    with pytest.raises(ValueError, match="not on"):
        pm.mp_gemm(torch.from_numpy(a), a, pm.Mode.NATIVE, device="meta")
