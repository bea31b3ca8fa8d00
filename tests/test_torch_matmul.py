"""int8 slice matmul with the mod epilogue: the port vs the JAX Pallas
kernel (interpret mode), on the same int8 slices. Tolerance: bit equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.core import slicegemm as jsg
from gemmul8_tpu.pallas import matmul as pm
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import modmath
from gemmul8_tpu_torch.core import slicegemm as sg
from gemmul8_tpu_torch.hopper import matmul as hm

from test_torch_threads import one_torch_thread  # noqa: E402, F401


def _slices(L, m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (L, m, k), dtype=np.int8),
            rng.integers(-128, 128, (L, k, n), dtype=np.int8))


@pytest.mark.parametrize("L", [6, 14])
@pytest.mark.parametrize("centered", [True, False])
def test_matmul_mod_matches_pallas(L, centered):
    a8, b8 = _slices(L, 72, 168, 88, seed=1)
    ref = np.asarray(pm.matmul_mod_u8_pallas(
        jnp.asarray(a8), jnp.asarray(b8), L, block=(128, 128, 128),
        centered=centered))
    got = hm.matmul_mod_u8(torch.from_numpy(a8), torch.from_numpy(b8), L,
                           centered=centered)
    assert got.dtype == (torch.int8 if centered else torch.uint8)
    np.testing.assert_array_equal(ref, got.numpy())


def test_matmul_mod_ragged_extremes():
    """All -128 operands: the modulus-256 lane's largest magnitude; a
    ragged shape whose edges are not multiples of any tile."""
    L = 20
    a8 = np.full((L, 33, 257), -128, np.int8)
    b8 = np.full((L, 257, 17), -128, np.int8)
    a8[:, ::2, ::3] = 127
    ref = np.asarray(pm.matmul_mod_u8_pallas(
        jnp.asarray(a8), jnp.asarray(b8), L, block=(128, 128, 128)))
    got = hm.matmul_mod_u8(torch.from_numpy(a8), torch.from_numpy(b8), L)
    np.testing.assert_array_equal(ref, got.numpy())


def test_slice_products_and_mod_reduce_match_jax():
    L = 8
    a8, b8 = _slices(L, 24, 40, 16, seed=4)
    c_ref = np.asarray(jsg.slice_products(jnp.asarray(a8), jnp.asarray(b8)))
    c = sg.slice_products(torch.from_numpy(a8), torch.from_numpy(b8))
    np.testing.assert_array_equal(c_ref, c.numpy())
    r_ref = np.asarray(jsg.mod_reduce(jnp.asarray(c_ref), L))
    np.testing.assert_array_equal(r_ref, sg.mod_reduce(c, L).numpy())


@pytest.mark.parametrize("m", [173, 229, 255])
def test_modmath_exact(m):
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 4096))
    np.testing.assert_array_equal(modmath.mod_i32(x, m).numpy(),
                                  np.mod(x.numpy(), m))
    u = torch.from_numpy(rng.integers(0, 1 << 26, 4096))
    np.testing.assert_array_equal(modmath.mod_u26(u, m).numpy(),
                                  np.mod(u.numpy(), m))
    u = torch.from_numpy(rng.integers(0, 1 << 28, 4096))
    np.testing.assert_array_equal(modmath.mod_u26(u, m, 28).numpy(),
                                  np.mod(u.numpy(), m))


def test_matmul_argument_checks():
    a8, b8 = _slices(2, 4, 8, 4, seed=0)
    ta, tb = torch.from_numpy(a8), torch.from_numpy(b8)
    with pytest.raises(ValueError):
        hm.matmul_mod_u8(ta, tb[:, :7], 2)
    with pytest.raises(ValueError):
        hm.matmul_mod_u8(ta, tb, 3)
    with pytest.raises(TypeError):
        hm.matmul_mod_u8(ta.to(torch.int32), tb, 2)
    big_k = tables.MAX_K + 1
    with pytest.raises(ValueError, match="2\\^17"):
        hm.matmul_mod_u8(torch.zeros((2, 1, big_k), dtype=torch.int8),
                         torch.zeros((2, big_k, 1), dtype=torch.int8), 2)
    with pytest.raises(ValueError):
        hm.matmul_mod_u8(ta.to("meta"), tb.to("meta"), 2)
