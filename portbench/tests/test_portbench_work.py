"""The frozen work and bound arithmetic against the program's own
`bench/bounds.py` at the cells' size."""

import pytest

from gemmul8_tpu_torch.bench import bounds
from portbench import work as W

N, L = 8192, 14


class Shape:
    def __init__(self, *shape):
        self.shape = shape


def phases(L=L, word=8, complex_=False):
    return W.call_work(N, N, N, L, word, word, complex_)


def test_headline_bounds():
    assert W.bound_ms(phases()["gemm"]) == pytest.approx((7.778, "operations"),
                                                         abs=5e-4)
    assert W.bound_ms(phases()["crt"])[0] == pytest.approx(0.441, abs=5e-4)
    assert W.bound_ms(phases()["crt"])[1] == "bytes"


@pytest.mark.parametrize("kernel, group", [
    ("fast_sft", {"stats"}),
    ("encode_slices", {"encode"}),
    ("matmul_mod_u8", {"gemm"}),
    ("reconstruct", {"crt"}),
    ("fast_encode_fused", {"stats", "encode"}),
    ("matmul_reconstruct", {"gemm", "crt"}),
])
def test_bounds_match_the_program(kernel, group):
    mine = W.bound_ms(W.merge(phases(), group))
    theirs = bounds.kernel_bounds(Shape(N, N), Shape(N, N), L)[kernel]
    assert mine[0] == pytest.approx(theirs[0], rel=1e-12)
    assert mine[1] == theirs[1]


def test_complex_gemm_counts_four_products():
    # kernel_bounds' complex entry holds f64 parts; the work is word-blind
    mine = W.bound_ms(phases(L=8, word=4, complex_=True)["gemm"])
    theirs = bounds.kernel_bounds(Shape(N, N), Shape(N, N),
                                  8)["matmul_complex_mod"]
    assert mine == pytest.approx(theirs)
    assert mine[0] == pytest.approx(17.78, abs=0.01)


def test_merge_drops_only_what_stays_inside():
    p = phases()
    m = W.merge(p, {"gemm", "crt"})
    assert set(m.reads) == {"slices", "sft"}
    assert set(m.writes) == {"C"}
    m = W.merge(p, {"stats", "encode"})
    assert set(m.reads) == {"A", "B"}
    assert set(m.writes) == {"sft", "slices"}   # crt and gemm read them
    assert W.merge(p, {"gemm"}) == p["gemm"]


def test_useful_flops():
    assert W.useful_flops(2, 3, 4, False) == 48
    assert W.useful_flops(2, 3, 4, True) == 192
