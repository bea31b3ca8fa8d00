"""The trailing updates of a blocked LU (LAPACK dgetrf) through the emulated
DGEMM, on the CPU at a tiny size with the benchmark cell's structure, and
the blocked-LU example (`gemmul8_tpu_torch.examples.blocked_lu`) against
the same loop on `torch.matmul`.

The update sequence is the cell `dgemm14-lu16384`'s at nb = 4, N = 128:
31 calls, m = n = 4 (31 - j), k = 4, alpha -1, beta 1, each on its own
seeded phi-matrices. Each output is held, as the benchmark's reference
holds it, to its widest gap to a float64 alpha A B + beta C as a share of
|alpha| |A||B| + |beta| |C|. UPDATE_TOL: 14 moduli carry the product to
a few units of 2^-53 of that share (the card reads 2-3e-15 at k = 8192,
PERF.md section 2; this sequence 2.4e-15), 40 times under it; float32
products miss it by about 2^-24 (1.6e-7 here), which a test below shows.
"""

import pytest
import torch

import gemmul8_tpu_torch as gt
from gemmul8_tpu_torch.bench.matrices import phi_matrix
from gemmul8_tpu_torch.examples import blocked_lu

from test_torch_threads import one_torch_thread  # noqa: E402, F401

N, NB = 128, 4
UPDATE_TOL = 1e-13
# the blocked LU's factors against the torch.matmul loop's, as a share of
# the widest factor element (the diagonal, about n): both loops are f64
# throughout, so they differ by the roundings of 8 updates and the solves
# fed by them (1.7e-18 at n = 256, seed 0), far under this; an update
# with float32 products moves them by about 3e-11
LU_TOL = 1e-14


def updates(n=N, nb=NB):
    """(m, n, k) of dgetrf's trailing updates, largest first."""
    return [(n - nb * (j + 1), n - nb * (j + 1), nb)
            for j in range(n // nb - 1)]


def operands(m, n, k, seed):
    return (torch.from_numpy(phi_matrix(m, k, 0.5, seed=3 * seed)),
            torch.from_numpy(phi_matrix(k, n, 0.5, seed=3 * seed + 1)),
            torch.from_numpy(phi_matrix(m, n, 0.5, seed=3 * seed + 2)))


def share(out, a, b, c):
    """Widest |out - (C - A B)| / (|A||B| + |C|)."""
    ref = c - a @ b
    return float(((out - ref).abs() / (a.abs() @ b.abs() + c.abs())).max())


def test_the_sequence_is_dgetrfs():
    got = updates()
    assert len(got) == 31
    assert got[0] == (124, 124, 4) and got[-1] == (4, 4, 4)


def test_every_update_meets_the_tolerance():
    worst = 0.0
    for j, (m, n, k) in enumerate(updates()):
        a, b, c = operands(m, n, k, j)
        out = gt.gemm(a, b, alpha=-1.0, beta=1.0, c=c, num_moduli=14,
                      fastmode=True)
        assert out.shape == (m, n) and out.dtype == torch.float64
        worst = max(worst, share(out, a, b, c))
    assert worst <= UPDATE_TOL


def test_float32_products_fail_the_tolerance():
    worst = 0.0
    for j, (m, n, k) in enumerate(updates()):
        a, b, c = operands(m, n, k, j)
        out = c - (a.float() @ b.float()).double()
        worst = max(worst, share(out, a, b, c))
    assert worst > 100 * UPDATE_TOL


def test_blocked_lu_matches_the_matmul_loop(capsys):
    got = blocked_lu.main(["--n", "256", "--nb", "32", "--device", "cpu"])
    assert got["gap"] <= LU_TOL
    want = got["matmul_factors"]
    lower = want.tril(-1) + torch.eye(256, dtype=torch.float64)
    a = lower @ want.triu()
    # the factors are the matrix's: phi-matrix plus n on the diagonal
    a0 = torch.from_numpy(phi_matrix(256, 256, 0.5, seed=0))
    a0.diagonal().add_(256.0)
    assert float((a - a0).abs().max()) <= 1e-12
    # the 7 updates' operands came as views of the matrix: A21 and U12
    # copied by the schedule each time
    assert got["operand_copies"] == {"a": 7, "b": 7}
    assert '"gap"' in capsys.readouterr().out


def test_an_update_with_float32_products_fails_the_lu_tolerance():
    a0 = torch.from_numpy(phi_matrix(256, 256, 0.5, seed=0))
    a0.diagonal().add_(256.0)
    want = blocked_lu.factor(a0.clone(), 32, blocked_lu.matmul_update)

    def f32(a21, a12, a22):
        a22.sub_((a21.float() @ a12.float()).double())

    got = blocked_lu.factor(a0.clone(), 32, f32)
    assert float((got - want).abs().max() / want.abs().max()) > 100 * LU_TOL


def test_blocked_lu_needs_a_card_for_its_timed_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        blocked_lu.main(["--n", "64", "--nb", "16"])
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err
