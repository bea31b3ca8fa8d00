"""The port's constant tables equal the JAX package's, exactly."""

import numpy as np
import pytest

from gemmul8_tpu import tables as jt
from gemmul8_tpu.pallas import launch
from gemmul8_tpu_torch import tables as tt

from test_torch_threads import one_torch_thread  # noqa: E402, F401


def test_moduli_and_bounds():
    assert tt.MODULI == jt.MODULI
    assert tt.MAX_MODULI == jt.MAX_MODULI
    assert tt.MAX_K == jt.MAX_K
    assert tt.LIMB_BITS == jt.LIMB_BITS
    assert tt.STATS_CHUNK == launch.STATS_CHUNK


@pytest.mark.parametrize("L", range(2, 21))
def test_tables_equal(L):
    assert tt.big_m(L) == jt.big_m(L)
    assert tt.crt_weights(L) == jt.crt_weights(L)
    assert tt.threshold_fast(L) == jt.threshold_fast(L)
    assert tt.threshold_accurate(L) == jt.threshold_accurate(L)
    assert tt.num_limbs(L) == jt.num_limbs(L)
    np.testing.assert_array_equal(tt.crt_weight_limbs(L),
                                  jt.crt_weight_limbs(L))
    np.testing.assert_array_equal(tt.big_m_limbs(L), jt.big_m_limbs(L))
    assert tt.crt_weight_limbs(L).dtype == np.int32


def test_limb_counts_at_scale():
    assert tt.num_limbs(14) == 8
    assert tt.num_limbs(20) == 11


@pytest.mark.parametrize("L", [1, 21])
def test_moduli_count_out_of_range(L):
    with pytest.raises(ValueError):
        tt.big_m(L)
