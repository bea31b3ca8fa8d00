"""The planner's figure for complex calls (`planner.workspace_bytes`),
against an independent count of the tensors a complex call holds at each
of its moments (gemmul8_tpu_torch/core/complexgemm.py, api.py and
hopper/matmul.py), each tensor at the most the CUDA caching allocator
counts for it: its bytes rounded up to 512, and above 1 MiB another MiB
(the remainder of a block it does not split):

- the operands' contiguous Re and Im parts, 8 bytes a word (exact for
  complex128; complex64 is over-counted, as the signature has no word),
  live throughout, and the int32 shifts until the output parts are made;
- the residue GEMM: two int8 slice sets a side (three with the Karatsuba
  sums), B's K-major (L, n, kp), each A set's copy padded to kp where
  k % 16 != 0, and the Re and Im residues;
- Karatsuba only, the sum of A's slices (four slice sets, three int16
  temporaries of A's size, two (L, 1, 1) int16 constants), then of B's
  (the same, A's sums beside them);
- the reconstruct: both residue sets and two f64 output parts;
- the complex output beside its two parts.

At 8192^3 and 14 moduli every large tensor fills its block, and the
figures are the complex128 peaks measured on the card (chip_smoke.py phase
4c, PERF.md) plus 1 MiB a large tensor; at a ragged shape they are at or
above the measured peaks, within 5%. Tolerance: equality, else as stated.
"""

import pytest

from gemmul8_tpu_torch import planner
from gemmul8_tpu_torch.types import ComputeType

from test_torch_threads import one_torch_thread  # noqa: E402, F401

CT = ComputeType
STRATEGIES = [CT.COMPLEX_BIG_MATRIX_ENCODE, CT.COMPLEX_CLASSIC_MULT,
              CT.COMPLEX_KARATSUBA_MULT]
SHAPES = [(8192, 8192, 8192, 14), (64, 48, 40, 20), (100, 7, 300, 2),
          (16, 1000, 16, 8), (33, 65, 129, 14), (2000, 24, 2000, 20),
          (1000, 1500, 4100, 14), (3, 5, 7, 2)]


MIB = 1 << 20


def block(nbytes):
    b = -(-max(nbytes, 1) // 512) * 512
    return b + MIB if b > MIB else b


def expected(m, n, k, L, strategy):
    kp = -(-k // 16) * 16
    kara = strategy == CT.COMPLEX_KARATSUBA_MULT
    sets = 3 if kara else 2
    parts = [8 * m * k, 8 * m * k, 8 * k * n, 8 * k * n]
    shifts = [4 * m, 4 * n]
    a_set, b_set = [L * m * k], [L * n * kp]
    if kp != k:
        a_set.append(L * m * kp)
    residues = [L * m * n] * 2
    outputs = [8 * m * n] * 2
    moments = [
        parts + shifts + sets * (a_set + b_set) + residues,
        parts + shifts + residues + outputs,
        parts + outputs + [16 * m * n]]
    if kara:
        slices = 2 * [L * m * k] + 2 * [L * n * kp]
        consts = [2 * L] * 2
        moments += [parts + shifts + slices + 3 * [2 * L * m * k] + consts,
                    parts + shifts + slices + [L * m * k]
                    + 3 * [2 * L * n * kp] + consts]
    return max(sum(block(x) for x in moment) for moment in moments)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.name)
def test_complex_workspace_formula(strategy, shape):
    m, n, k, L = shape
    assert planner.workspace_bytes(m, n, k, L, strategy) == expected(
        m, n, k, L, strategy)


@pytest.mark.parametrize("strategy,peak,large", [
    (CT.COMPLEX_BIG_MATRIX_ENCODE, 7_784_693_760, 10),
    (CT.COMPLEX_CLASSIC_MULT, 7_784_693_760, 10),
    (CT.COMPLEX_KARATSUBA_MULT, 12_482_315_264, 12)],
    ids=lambda x: str(x))
def test_complex_workspace_at_the_measured_peak(strategy, peak, large):
    """At or above the complex128 peak measured on the card (NVIDIA H100
    80GB HBM3), within 5% of it, fast and accurate alike: the peak plus
    1 MiB for each large tensor of the figure's moment (the parts, the
    slice sets, the residues; Karatsuba's peak is its sum of B)."""
    plan = planner.workspace_bytes(8192, 8192, 8192, 14, strategy)
    assert peak <= plan <= peak / 0.95
    assert plan == peak + large * MIB


@pytest.mark.parametrize("strategy,peak", [
    (CT.COMPLEX_BIG_MATRIX_ENCODE, 609_407_488),
    (CT.COMPLEX_CLASSIC_MULT, 609_407_488),
    (CT.COMPLEX_KARATSUBA_MULT, 1_027_784_704)], ids=lambda x: str(x))
def test_complex_workspace_at_a_ragged_measured_peak(strategy, peak):
    """At (m, k, n) = (1000, 4100, 1500), 14 moduli, whose tensors are not
    multiples of the allocator's blocks: at or above the complex128 peak
    measured on the card (NVIDIA H100 80GB HBM3, chip_smoke.py phase 4c),
    within 5% of it, fast and accurate alike."""
    plan = planner.workspace_bytes(1000, 1500, 4100, 14, strategy)
    assert peak <= plan <= peak / 0.95


def test_complex_moments():
    """Which moment is the peak: the GEMM at square shapes; Karatsuba's sum
    of B's slices where B is much wider than A, of A's where A is much
    taller than B (their int16 temporaries); the complex output beside
    its parts where k and L are small; and A's padded copies where k is
    not a multiple of 16. Each large tensor (above 1 MiB) adds 1 MiB."""
    m, n, k, L = 16, 4096, 4096, 14
    kara = planner.workspace_bytes(m, n, k, L, CT.COMPLEX_KARATSUBA_MULT)
    parts = 8 * 2 * (m * k + k * n)
    shifts = 512 + 4 * 4096   # (16, 1) and (1, 4096) int32
    # large: B's two parts, two slice sets and three int16 temporaries
    assert kara == parts + shifts + 4 * L * (m * k + k * n) // 2 \
        + L * m * k + 6 * L * k * n + 1024 + 7 * MIB
    assert planner.workspace_bytes(n, m, k, L, CT.COMPLEX_KARATSUBA_MULT) \
        == parts + shifts + 4 * L * (m * k + k * n) // 2 \
        + 6 * L * n * k + 1024 + 7 * MIB  # A (4096, 4096) summed
    m, n, k, L = 4096, 4096, 16, 2
    classic = planner.workspace_bytes(m, n, k, L, CT.COMPLEX_CLASSIC_MULT)
    # large: the two f64 output parts and the complex output
    assert classic == 8 * 2 * (m * k + k * n) + 32 * m * n + 3 * MIB
    m, n, k, L = 1024, 1024, 1000, 14
    ragged = planner.workspace_bytes(m, n, k, L, CT.COMPLEX_CLASSIC_MULT)
    # two padded A copies more, each large; every part and set smaller
    assert ragged - planner.workspace_bytes(m, n, 1008, L,
                                            CT.COMPLEX_CLASSIC_MULT) == \
        2 * L * m * 1000 - 8 * 8 * 2 * (m + n) + 2 * MIB
    with pytest.raises(ValueError, match="complex"):
        planner.workspace_bytes(64, 64, 64, 14, CT.COMPLEX_KARATSUBA_MULT,
                                moduli_chunk=3)
