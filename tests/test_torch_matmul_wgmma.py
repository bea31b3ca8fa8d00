"""The wgmma tile of matmul_mod_u8 (csrc/matmul_mod.cu, csrc/wgmma_s8.cuh):
what of it the CPU can hold.

- The epilogue's multiply-and-shift division (`hopper.matmul.mod_divisor`
  and `mod_div`, the host arithmetic of csrc/moduli.cuh) against Python's
  `%` on a million random int32 values and on the edges of every modulus:
  bit equality.
- The int32 wrap at k = 2^17 (the modulus-256 lane's products exactly 2^31,
  the odd lanes' 127^2 * 2^17) through the plain `matmul_mod_u8` against
  the JAX package's jnp path (`slice_products`, int32, then `mod_reduce`):
  bit equality.
- The wrapper's argument checks, and that a tensor off the CPU never takes
  the plain version.
- The launch table (`hopper.launch`), with the capability passed in, and
  how the build compiles its entry into the kernel: the flags, the
  library's name, the ptxas report read back on a cache hit.

The card runs the kernel itself against the plain version and the division
against `mod_canon` over every int32 (chip_smoke.py phase 3w).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.core import slicegemm as jsg
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.hopper import build
from gemmul8_tpu_torch.hopper import launch
from gemmul8_tpu_torch.hopper import matmul as hm

from test_torch_threads import one_torch_thread  # noqa: E402, F401

REACH = 127 * 127 << 17   # largest |product| of centered odd-lane slices
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


@pytest.mark.parametrize("d", tables.MODULI)
def test_mod_div_random_int32(d):
    x = np.random.default_rng(d).integers(INT32_MIN, INT32_MAX, 10 ** 6,
                                          endpoint=True)
    np.testing.assert_array_equal(hm.mod_div(x, d), x % d)


@pytest.mark.parametrize("d", tables.MODULI)
def test_mod_div_edges(d):
    base = np.array([0, 1, d - 1, d, d + 1, 2 * d, REACH, REACH - 1,
                     REACH // d * d, INT32_MAX, INT32_MAX - d,
                     INT32_MAX // d * d, (1 << 31) - (1 << 31) % d - 1],
                    dtype=np.int64)
    x = np.concatenate([base, -base, [INT32_MIN, INT32_MIN + 1,
                                      INT32_MIN + d, -REACH]])
    np.testing.assert_array_equal(hm.mod_div(x, d), x % d)


@pytest.mark.parametrize("d", tables.MODULI)
def test_mod_divisor_constants(d):
    """Granlund and Montgomery's condition on the 33-bit multiplier
    2^32 + mul: 2^(32+l) < (2^32 + mul) d <= 2^(32+l) + 2^l; the 256 lane
    is the shift alone (mul 1: q = u >> 8, the residue x & 255)."""
    mul, sh, off = hm.mod_divisor(d)
    l = sh + 1
    assert 0 < mul < 1 << 32 and (1 << (l - 1)) < d <= 1 << l
    top = 1 << (32 + l)
    assert top < ((1 << 32) + mul) * d <= top + (1 << l)
    assert off == -(1 << 31) % d
    if d == 256:
        assert (mul, sh, off) == (1, 7, 0)


def test_mod_div_argument_checks():
    with pytest.raises(ValueError):
        hm.mod_divisor(1)
    with pytest.raises(ValueError):
        hm.mod_div([1 << 31], 255)
    with pytest.raises(ValueError):
        hm.mod_div([INT32_MIN - 1], 255)


def test_mod_div_mismatches_plain():
    bad = hm.mod_div_mismatches(-3000, 3000, 20)
    assert bad.dtype == torch.int64 and bad.tolist() == [0] * 20
    bad = hm.mod_div_mismatches(INT32_MAX - 300, INT32_MAX, 14,
                                moduli_idx=(2, 9, 13))
    assert bad.tolist() == [0, 0, 0]
    with pytest.raises(ValueError):
        hm.mod_div_mismatches(5, 4)
    with pytest.raises(ValueError):
        hm.mod_div_mismatches(INT32_MIN - 1, 0)
    with pytest.raises(ValueError):
        hm.mod_div_mismatches(0, 1, 14, moduli_idx=(3, 3))


@pytest.mark.parametrize("centered", [True, False])
def test_wrap_at_max_k_matches_jax(centered):
    """k = 2^17, m = n = 8, L = 20: slice 0 (modulus 256) all -128 on both
    sides, so every product is 2^31 (the JAX int32 product wraps to -2^31,
    0 mod 256); the odd slices at +-127, their largest products."""
    L, k, mn = tables.MAX_MODULI, tables.MAX_K, 8
    a8 = np.full((L, mn, k), -127, np.int8)
    b8 = np.full((L, k, mn), 127, np.int8)
    a8[0] = -128
    b8[0] = -128
    b8[1:, :, ::2] = -127
    b8[1:, ::3, 1] = -127
    ref = np.asarray(jsg.mod_reduce(
        jsg.slice_products(jnp.asarray(a8), jnp.asarray(b8)), L))
    assert (ref[0] == 0).all() and np.abs(ref).max() > 0
    if centered:
        ref = (ref - 128).astype(np.int8)
    got = hm.matmul_mod_u8(torch.from_numpy(a8), torch.from_numpy(b8), L,
                           centered=centered)
    assert got.dtype == (torch.int8 if centered else torch.uint8)
    np.testing.assert_array_equal(got.numpy(), ref)


def _slices(L, m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(-128, 128, (L, m, k), np.int8)),
            torch.from_numpy(rng.integers(-128, 128, (L, k, n), np.int8)))


@pytest.mark.parametrize("bad", [
    "dtype", "rank", "slices", "inner", "k", "moduli_dup", "moduli_range",
    "num_moduli"])
def test_matmul_mod_u8_argument_checks(bad):
    a8, b8 = _slices(3, 4, 16, 5)
    kw = {}
    num_moduli = 3
    if bad == "dtype":
        b8 = b8.to(torch.int16)
    elif bad == "rank":
        a8 = a8[0]
    elif bad == "slices":
        b8 = b8[:2]
    elif bad == "inner":
        b8 = b8[:, :15]
    elif bad == "k":
        a8 = torch.zeros((3, 4, tables.MAX_K + 16), dtype=torch.int8)
        b8 = torch.zeros((3, tables.MAX_K + 16, 5), dtype=torch.int8)
    elif bad == "moduli_dup":
        kw, num_moduli = {"moduli_idx": (1, 1, 2)}, 14
    elif bad == "moduli_range":
        kw, num_moduli = {"moduli_idx": (1, 2, 14)}, 14
    else:
        num_moduli = 21
    with pytest.raises((ValueError, TypeError)):
        hm.matmul_mod_u8(a8, b8, num_moduli, **kw)


def test_matmul_mod_u8_off_cpu_never_takes_the_plain_version():
    """One operand off the CPU: the wrapper goes to the kernel, whose
    device check refuses a tensor that is not on a CUDA card."""
    a8, b8 = _slices(2, 4, 16, 5)
    with pytest.raises(ValueError, match="CUDA"):
        hm.matmul_mod_u8(a8, b8.to("meta"), 2)


def test_launch_table_sm90():
    cfg = launch.get("matmul_mod", (9, 0))
    assert cfg == launch.MatmulModLaunch(tile_n=256, stages=4,
                                         raster_group=16)
    assert launch.get("matmul_mod", [9, 0]) is cfg
    assert launch.STATS_CHUNK == tables.STATS_CHUNK == 2048
    # the build compiles the entry into the kernel (and reports ptxas)
    assert cfg.defines() == ("-DGM8_MM_TILE_N=256", "-DGM8_MM_STAGES=4",
                             "-DGM8_MM_GROUP=16")
    assert build.ARCH_CAPABILITY == (9, 0)
    flags = build.SOURCE_FLAGS["matmul_mod.cu"]
    assert flags[:2] == ("-Xptxas", "-v") and flags[2:] == cfg.defines()


@pytest.mark.parametrize("cap", [(8, 0), (8, 9), (9, 1), (10, 0), (12, 0)])
def test_launch_table_unknown_capability_raises(cap):
    with pytest.raises(RuntimeError, match="no launch entry"):
        launch.get("matmul_mod", cap)


def test_launch_table_entry_checks():
    """An unknown name raises; every constant the entry passes is one the
    source reads, and the source refuses to build without them."""
    with pytest.raises(KeyError):
        launch.get("no_such_kernel", (9, 0))
    src = (build.CSRC / "matmul_mod.cu").read_text()
    for flag in launch.get("matmul_mod", (9, 0)).defines():
        name = flag[2:].split("=")[0]
        assert f"!defined({name})" in src and f"= {name};" in src


def _library(tmp_path, monkeypatch, flags):
    """The path the build gives the library under `flags` for
    matmul_mod.cu, in an empty build directory."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "SOURCE_FLAGS", {"matmul_mod.cu": flags})
    return build._library(build.sources())


def test_build_name_follows_the_launch_entry(tmp_path, monkeypatch):
    """Another launch entry is another library: an edited table never
    loads a build made with the old constants."""
    table = build.SOURCE_FLAGS["matmul_mod.cu"]
    other = ("-Xptxas", "-v",
             *launch.MatmulModLaunch(256, 3, 8).defines())
    assert _library(tmp_path, monkeypatch, table) != \
        _library(tmp_path, monkeypatch, other)


def test_build_cache_hit_reads_the_ptxas_report(tmp_path, monkeypatch):
    """A library already built comes with its ptxas report, read back
    into PTXAS_REPORT without compiling."""
    lib = _library(tmp_path, monkeypatch,
                        build.SOURCE_FLAGS["matmul_mod.cu"])
    lib.write_bytes(b"")
    report = {"matmul_mod.cu": "ptxas info    : Used 168 registers"}
    lib.with_suffix(".ptxas.json").write_text(json.dumps(report))
    monkeypatch.setattr(build, "PTXAS_REPORT", {})
    monkeypatch.setattr(build, "_nvcc", lambda: pytest.fail("compiled"))
    assert build._build() == lib
    assert build.PTXAS_REPORT == report
