"""The port's OS-I baseline and config against the JAX package's.

`gemmul8_tpu_torch.baselines.ozimmu` on the CPU against
`gemmul8_tpu.baselines.ozimmu`, bit for bit: the same slices (subnormals
sliced at exponent 1), the same exact integer sum and one rounding. And
`gemmul8_tpu_torch.config` against `gemmul8_tpu.config` under the same
environment, parse errors included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gemmul8_tpu import config as jcfg
from gemmul8_tpu.baselines import ozimmu as jo
from gemmul8_tpu.types import f64_to_bits
from gemmul8_tpu_torch import config as pcfg
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.baselines import ozimmu as po
from gemmul8_tpu_torch.bench.matrices import phi_matrix

from test_torch_threads import one_torch_thread  # noqa: E402, F401

SPECIALS = np.array([0.0, -0.0, 5e-324, -3e-310, 2.2250738585072014e-308 / 3,
                     -2.2250738585072014e-308])


def _with_specials(x, seed):
    """x with a tenth of its elements replaced by zeros, -0.0 and
    subnormals, and its first row and column all zero."""
    x = x.copy()
    flat = x.reshape(-1)
    rng = np.random.default_rng(seed)
    idx = rng.choice(flat.size, size=max(3, flat.size // 10), replace=False)
    flat[idx] = SPECIALS[np.arange(idx.size) % SPECIALS.size]
    x[0, :] = 0.0
    x[:, 0] = -0.0
    return x


def _bits(x):
    return np.ascontiguousarray(x, np.float64).view(np.int64)


def _operands(s, k):
    """A (24, k) and B (k, 20) with specials; phi 0.5 and 2, swapped on
    odd slice counts."""
    pa, pb = (0.5, 2.0) if s % 2 == 0 else (2.0, 0.5)
    a = _with_specials(phi_matrix(24, k, pa, seed=10 * s + k), s)
    b = _with_specials(phi_matrix(k, 20, pb, seed=10 * s + k + 1), s + 1)
    return a, b


@pytest.mark.parametrize("k", [5, 300, 2049])
@pytest.mark.parametrize("s", range(3, 17))
def test_ozimmu_gemm_matches_jax(s, k):
    a, b = _operands(s, k)
    want = jo.ozimmu_gemm_np(a, b, num_split=s)
    got = po.ozimmu_gemm_np(a, b, num_split=s, device="cpu")
    assert got.dtype == np.float64 and got.shape == (24, 20)
    assert np.array_equal(_bits(got), _bits(want))


def test_ozimmu_zgemm_matches_jax():
    rng = np.random.default_rng(4)
    a = (rng.random((32, 48)) - .5) + 1j * (rng.random((32, 48)) - .5)
    b = (rng.random((48, 24)) - .5) + 1j * (rng.random((48, 24)) - .5)
    a.real[3] = 0.0
    b.imag[:, 5] = -0.0
    for s in (5, 9):
        want = jo.ozimmu_zgemm_np(a, b, s)
        got = po.ozimmu_zgemm_np(a, b, s, device="cpu")
        assert np.array_equal(_bits(got.real), _bits(want.real))
        assert np.array_equal(_bits(got.imag), _bits(want.imag))
    ref = a @ b
    assert float(np.abs((got - ref) / np.abs(ref)).max()) < 1e-13
    re, im = po.ozimmu_zgemm(*(torch.from_numpy(np.ascontiguousarray(p))
                               for p in (a.real, a.imag, b.real, b.imag)),
                             9, device="cpu")
    assert np.array_equal(_bits(re.numpy()), _bits(got.real))
    assert np.array_equal(_bits(im.numpy()), _bits(got.imag))


def test_ozimmu_accuracy_curve():
    """The JAX package's curve test on the port: monotone in the slice
    count, f64 grade by 12 slices."""
    from gemmul8_tpu_torch.bench.native import dd_gemm, relerr_vs_dd

    a = phi_matrix(24, 256, 0.5, seed=500)
    b = phi_matrix(256, 24, 0.5, seed=501)
    ref = dd_gemm(a, b)
    errs = {s: relerr_vs_dd(po.ozimmu_gemm_np(a, b, s, device="cpu"),
                            *ref)[0] for s in (6, 8, 10, 12)}
    assert errs[8] < errs[6] and errs[10] < errs[8]
    assert errs[8] < 1e-5 and errs[12] < 1e-11, errs


@pytest.mark.parametrize("shape", [(5, 13, 7), (17, 8, 8), (1, 300, 1),
                                   (40, 2049, 33)])
def test_padded_int_mm_route_matches(shape):
    """The route the card takes (slices padded to more than 16 rows and k,
    n multiples of 8), forced on the CPU, gives the unpadded bits."""
    m, k, n = shape
    a = _with_specials(phi_matrix(m, k, 1.0, seed=m), 1) if m > 1 else \
        phi_matrix(m, k, 1.0, seed=m)
    b = phi_matrix(k, n, 1.0, seed=n + 7)
    for s in (3, 9):
        plain = po.ozimmu_gemm(a, b, s, device="cpu", pad=False)
        padded = po.ozimmu_gemm(a, b, s, device="cpu", pad=True)
        assert padded.shape == (m, n)
        assert torch.equal(plain.view(torch.int64), padded.view(torch.int64))
        if m > 1:
            want = jo.ozimmu_gemm_np(a, b, s)
            assert np.array_equal(_bits(plain.numpy()), _bits(want))


def test_split_slices_match_jax():
    a, _ = _operands(9, 300)
    bits = f64_to_bits(a)
    for axis in (0, 1):
        want8, want_e = jo._split_slices(bits, 9, axis)
        got8, got_e = po._split_slices(torch.from_numpy(a), 9, axis)
        assert np.array_equal(got8.numpy(), np.asarray(want8))
        assert np.array_equal(got_e.numpy(), np.asarray(want_e))


@pytest.mark.parametrize("phi", [0.5, 2.0, 6.0])
def test_mantissa_loss_and_auto_split_match_jax(phi):
    a = _with_specials(phi_matrix(40, 64, phi, seed=3), 3)
    b = _with_specials(phi_matrix(64, 30, phi, seed=4), 4)
    ba, bb = f64_to_bits(a), f64_to_bits(b)
    for s in (3, 7, 11, 16):
        for x, bx, axis in ((a, ba, 1), (b, bb, 0)):
            want = float(jo.mantissa_loss_stats(bx, s, axis))
            got = po.mantissa_loss_stats(x, s, axis, device="cpu")
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-30)
    for threshold in (None, 0.5, 2.0, 8.0, 40.0):
        assert (po.auto_num_split(a, b, threshold, device="cpu")
                == jo.auto_num_split(ba, bb, threshold))


def test_k_over_the_bound_raises():
    a = np.ones((2, tables.MAX_K + 1))
    b = np.ones((tables.MAX_K + 1, 2))
    with pytest.raises(ValueError, match="2\\^17"):
        po.ozimmu_gemm(a, b, 3, device="cpu")


def test_operand_checks():
    with pytest.raises(TypeError):
        po.ozimmu_gemm(np.ones((4, 4), np.float32), np.ones((4, 4)), 3,
                       device="cpu")
    with pytest.raises(ValueError):
        po.ozimmu_gemm(np.ones((4, 5)), np.ones((4, 4)), 3, device="cpu")
    with pytest.raises(ValueError, match="not on meta"):
        po.ozimmu_gemm(torch.ones(4, 4, dtype=torch.float64),
                       torch.ones(4, 4, dtype=torch.float64), 3,
                       device="meta")


# ---- config -----------------------------------------------------------------

ENV = ("GEMMUL8_NUM_MODULI", "GEMMUL8_FASTMODE", "GEMMUL8_COMPUTE_MODE",
       "GEMMUL8_INTERCEPT_THRESHOLD_M", "GEMMUL8_INTERCEPT_THRESHOLD_N",
       "GEMMUL8_INTERCEPT_THRESHOLD_K", "GEMMUL8_INFO", "GEMMUL8_ERROR",
       "GEMMUL8_PROFILE", "GEMMUL8_AUTO_AVG_MANTISSA_LOSS_THRESHOLD")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    jcfg._config = None
    pcfg._config = None


ENV_CASES = [
    {},
    {"GEMMUL8_NUM_MODULI": "8", "GEMMUL8_FASTMODE": "0",
     "GEMMUL8_COMPUTE_MODE": " Native ", "GEMMUL8_INFO": "yes",
     "GEMMUL8_ERROR": "off", "GEMMUL8_PROFILE": "TRUE",
     "GEMMUL8_AUTO_AVG_MANTISSA_LOSS_THRESHOLD": "0.75"},
    {"GEMMUL8_INTERCEPT_THRESHOLD_M": "1", "GEMMUL8_INTERCEPT_THRESHOLD_N":
     "2", "GEMMUL8_INTERCEPT_THRESHOLD_K": "", "GEMMUL8_FASTMODE": "",
     "GEMMUL8_COMPUTE_MODE": "off", "GEMMUL8_NUM_MODULI": ""},
]


@pytest.mark.parametrize("env", ENV_CASES)
def test_config_matches_jax(clean_env, env):
    for name, value in env.items():
        clean_env.setenv(name, value)
    want = dataclasses.asdict(jcfg.Config())
    assert dataclasses.asdict(pcfg.Config()) == want
    assert dataclasses.asdict(pcfg.reload_config()) == want
    assert pcfg.get_config() is pcfg.get_config()
    assert dataclasses.fields(pcfg.Config) and [
        f.name for f in dataclasses.fields(pcfg.Config)] == [
        f.name for f in dataclasses.fields(jcfg.Config)]


PARSE_ERRORS = [("GEMMUL8_NUM_MODULI", "fourteen"),
                ("GEMMUL8_INTERCEPT_THRESHOLD_K", "1.5"),
                ("GEMMUL8_FASTMODE", "maybe"), ("GEMMUL8_INFO", "2"),
                ("GEMMUL8_ERROR", "enabled"), ("GEMMUL8_PROFILE", "y"),
                ("GEMMUL8_COMPUTE_MODE", "fast"),
                ("GEMMUL8_COMPUTE_MODE", ""),
                ("GEMMUL8_AUTO_AVG_MANTISSA_LOSS_THRESHOLD", "two")]


@pytest.mark.parametrize("name,value", PARSE_ERRORS)
def test_config_parse_errors_match_jax(clean_env, name, value):
    clean_env.setenv(name, value)
    with pytest.raises(ValueError) as want:
        jcfg.Config()
    with pytest.raises(ValueError) as got:
        pcfg.Config()
    assert str(got.value) == str(want.value)


def test_config_logs_match_jax(clean_env, capsys):
    clean_env.setenv("GEMMUL8_INFO", "1")
    clean_env.setenv("GEMMUL8_ERROR", "1")
    for mod in (jcfg, pcfg):
        mod.reload_config()
        mod.log_info("info line")
        mod.log_error("error line")
    err = capsys.readouterr().err.splitlines()
    assert err == ["[gemmul8 INFO] info line", "[gemmul8 ERROR] error line"] * 2
    clean_env.setenv("GEMMUL8_INFO", "0")
    clean_env.setenv("GEMMUL8_ERROR", "0")
    for mod in (jcfg, pcfg):
        mod.reload_config()
        mod.log_info("x")
        mod.log_error("y")
    assert capsys.readouterr().err == ""


def test_auto_split_reads_the_config_threshold(clean_env):
    a = phi_matrix(16, 32, 2.0, seed=1)
    b = phi_matrix(32, 16, 2.0, seed=2)
    for value in ("1.0", "6.0"):
        clean_env.setenv("GEMMUL8_AUTO_AVG_MANTISSA_LOSS_THRESHOLD", value)
        pcfg.reload_config()
        assert (po.auto_num_split(a, b, device="cpu")
                == po.auto_num_split(a, b, float(value), device="cpu"))
