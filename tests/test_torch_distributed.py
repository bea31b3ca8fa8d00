"""The port's sharded engine on a 4-rank gloo CPU world vs the JAX
package's gemm_sharded / gemm_sharded_complex on the virtual CPU mesh.

One world of 4 processes (torch.multiprocessing, a file:// store under
tmp_path, so that no port is fixed) runs every case of
tests/test_distributed.py on a 2x2 and a 1x4 mesh, each rank on its own
shards (`parallel.smoke.case_worker`); the module-scoped fixture
assembles the tiles and each case is then held to the JAX package's
sharded call on a mesh of the same shape, on the same numpy operands.

Tolerance: bit equality, except at a shift's floor boundary: the port
merges its ranks' statistics as the JAX package's Pallas branch does
(norms rescaled by exact powers of two, summed in rank order) and its
accurate shift takes the correctly rounded f32 log2, where the JAX CPU
branch sums the norm flat and takes XLA's log2. Where an output word
differs, its row's or column's shift must lie within 1e-4 of a floor
boundary, and the word is held to the exact product (1e-12 of |A||B| for
f64 output, 2^-20 for f32).
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from gemmul8_tpu.parallel import distributed as jdist
from gemmul8_tpu.types import ComputeType as JCT
from gemmul8_tpu.types import bits_to_f64, f64_to_bits
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.core import slicegemm as sg
from gemmul8_tpu_torch.parallel import distributed as sd
from gemmul8_tpu_torch.parallel import smoke

from test_torch_threads import one_torch_thread  # noqa: E402, F401

SHIFT_RULE_FRAC = 1e-4
MESHES = [(2, 2), (1, 4)]
WORLD_TIMEOUT = 300   # seconds the 4-rank world may take (about 10 s)

# (name, case): tests/test_distributed.py's shapes, seeds and moduli
BASE = {
    "f64": dict(m=32, k=256, n=64, phi=0.5, seeds=(200, 201), a="f64",
                b="f64", L=14),
    "f32": dict(m=16, k=128, n=32, phi=0.5, seeds=(210, 211), a="f32",
                b="f32", L=8),
    "md": dict(m=16, k=128, n=32, phi=0.5, seeds=(212, 213), a="f64",
               b="f32", L=14, out_dtype="f64"),
    "accurate": dict(m=16, k=128, n=32, phi=1.0, seeds=(300, 301), a="f64",
                     b="f64", L=14, fastmode=False),
    "n_panel": dict(m=16, k=128, n=32, phi=0.5, seeds=(302, 303), a="f64",
                    b="f64", L=10, n_panel=8),
    "big": dict(m=16, k=64, n=32, phi=0.5, seeds=(310, 311, 312, 313),
                a="c128", b="c128", L=12,
                compute_type="COMPLEX_BIG_MATRIX_ENCODE"),
    "classic": dict(m=16, k=64, n=32, phi=0.5, seeds=(310, 311, 312, 313),
                    a="c128", b="c128", L=12,
                    compute_type="COMPLEX_CLASSIC_MULT"),
    "karatsuba": dict(m=16, k=64, n=32, phi=0.5, seeds=(310, 311, 312, 313),
                      a="c128", b="c128", L=12,
                      compute_type="COMPLEX_KARATSUBA_MULT"),
    "c128xc64": dict(m=16, k=64, n=32, phi=0.5, seeds=(320, 321, 322, 323),
                     a="c128", b="c64", L=10,
                     compute_type="COMPLEX_BIG_MATRIX_ENCODE"),
}
CASES = [dict(BASE[name], name=f"{name}-{nx}x{ny}", mesh=(nx, ny))
         for nx, ny in MESHES for name in BASE]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case run once on one 4-rank gloo world: {case name: the
    assembled global result}, and each rank's default mesh."""
    out = tmp_path_factory.mktemp("gloo4")
    ctx = mp.start_processes(smoke.case_worker,
                             args=(4, f"file://{out / 'store'}", CASES,
                                   str(out)),
                             nprocs=4, start_method="spawn", join=False)
    deadline = time.monotonic() + WORLD_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the gloo world hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    got = {}
    for case in CASES:
        tiles = [np.load(out / f"{case['name']}.{r}.npy") for r in range(4)]
        got[case["name"]] = sd.assemble(tiles, case["mesh"]).numpy()
    meshes = [tuple(np.load(out / f"mesh.{r}.npy")) for r in range(4)]
    return got, meshes


def _jax_operand(x):
    if x.dtype == np.float64:
        return f64_to_bits(x)
    if x.dtype == np.float32:
        return jax.numpy.asarray(x)
    return x


def _jax_result(out):
    if hasattr(out, "hi"):
        return bits_to_f64(out, to_numpy=True)
    if isinstance(out, tuple):
        re, im = (_jax_result(p) for p in out)
        return re + 1j * im
    return np.asarray(out)


def _jax_sharded(case):
    a, b = smoke.case_operands(case)
    mesh = jdist.make_mesh(4, shape=case["mesh"])
    if case.get("compute_type"):
        return _jax_result(jdist.gemm_sharded_complex(
            a, b, mesh, num_moduli=case["L"],
            compute_type=JCT[case["compute_type"]]))
    return _jax_result(jdist.gemm_sharded(
        _jax_operand(a), _jax_operand(b), mesh, num_moduli=case["L"],
        out_dtype=case.get("out_dtype"),
        fastmode=case.get("fastmode", True), n_panel=case.get("n_panel")))


def _parts(x):
    t = torch.from_numpy(np.ascontiguousarray(x))
    if t.is_complex():
        return [t.real.contiguous(), t.imag.contiguous()]
    return [t]


def _fracs(case, a, b):
    """Each row of A's and column of B's distance of its shift's pre-floor
    value from an integer, from the global operands."""
    L = case["L"]
    if not case.get("fastmode", True):
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        ea, eb = enc.emax(ta, 1), enc.emax(tb, 0)
        smax = sg.magmax(enc.mag7(ta, ea, 1), enc.mag7(tb, eb, 0))
        return tuple(enc.accurate_sft_floor_frac(s, L).numpy().ravel()
                     for s in smax)
    out = []
    for x, axis in ((a, 1), (b, 0)):
        parts = _parts(x)
        stats = enc.fast_stats(parts[0], axis)
        if len(parts) == 2:
            stats = enc.merge_stats(stats, enc.fast_stats(parts[1], axis))
        k = x.shape[axis] * len(parts)
        out.append(enc.sft_floor_frac(stats[1], k, L).numpy().ravel())
    return tuple(out)


def _words(x):
    x = np.ascontiguousarray(x)
    if np.iscomplexobj(x):
        x = x.view(x.real.dtype).reshape(*x.shape, 2)
    return x.view(np.uint64 if x.dtype == np.float64 else np.uint32)


def _hold(case, got, ref):
    """got (the port's global result) == ref (the JAX package's) bit for
    bit, but where a row's or column's shift lies at a floor boundary;
    there the word is held to the exact product."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    diff = _words(got) != _words(ref)
    if diff.ndim == 3:
        diff = diff.any(axis=2)
    if not diff.any():
        return
    a, b = smoke.case_operands(case)
    fa, fb = _fracs(case, a, b)
    rows, cols = np.nonzero(diff)
    assert np.all((fa[rows] < SHIFT_RULE_FRAC) | (fb[cols] < SHIFT_RULE_FRAC)
                  ), "bits differ away from a floor boundary"
    wide = np.complex128 if np.iscomplexobj(a) else np.float64
    a64, b64 = a.astype(wide), b.astype(wide)
    tol = 1e-12 if got.real.dtype == np.float64 else 2.0 ** -20
    err = np.abs(got.astype(wide) - a64 @ b64)
    assert np.all(err <= tol * (np.abs(a64) @ np.abs(b64)) + 1e-300)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_sharded_matches_jax(world, case):
    got = world[0][case["name"]]
    ref = _jax_sharded(case)
    _hold(case, got, ref)


def test_make_mesh_factors_the_world(world):
    """Four ranks factor as 2x2, rank r at (r // 2, r % 2): jax.make_mesh's
    row-major layout."""
    assert world[1] == [(2, 2, r // 2, r % 2) for r in range(4)]


def test_n_panel_and_strategies_give_one_shot_bits(world):
    got = world[0]
    for nx, ny in MESHES:
        s = f"-{nx}x{ny}"
        big = got["big" + s]
        assert np.array_equal(_words(got["classic" + s]), _words(big))
        assert np.array_equal(_words(got["karatsuba" + s]), _words(big))
    # the panel case's operands, one shot, on one rank: the same bits
    case = dict(BASE["n_panel"], name="one", mesh=(1, 1))
    a, b = smoke.case_operands(case)
    import gemmul8_tpu_torch as gt

    one = gt.gemm(a, b, num_moduli=case["L"], device="cpu").numpy()
    for nx, ny in MESHES:
        np.testing.assert_array_equal(
            _words(got[f"n_panel-{nx}x{ny}"]), _words(one))


def _fake_mesh(nx=1, ny=4, backend="gloo", device="cpu"):
    """A mesh that no collective can run on: a check that fires after a
    collective would fail on its groups first."""
    return sd.Mesh(nx, ny, 0, backend, torch.device(device), None, None)


def test_shape_validation():
    mesh = _fake_mesh()
    a = torch.zeros((30, 64), dtype=torch.float32)   # a rank's shards
    b = torch.zeros((64, 30), dtype=torch.float32)   # n = 30, 30 % 4 != 0
    with pytest.raises(ValueError, match="divide mesh"):
        sd.gemm_sharded(a, b, mesh, num_moduli=4)
    with pytest.raises(ValueError, match="divide mesh"):
        sd.gemm_sharded_complex(a.to(torch.complex64), b.to(torch.complex64),
                                mesh, num_moduli=4)
    with pytest.raises(ValueError, match="inner dims"):
        sd.gemm_sharded(a, b[:32], mesh, num_moduli=4)
    with pytest.raises(ValueError, match="2\\^17"):
        sd.gemm_sharded(torch.zeros((2, 2 ** 15 + 1)),
                        torch.zeros((2 ** 15 + 1, 4)), mesh)
    with pytest.raises(ValueError, match="int32-exactness"):
        sd.gemm_sharded_complex(torch.zeros((2, 2 ** 14 + 1)),
                                torch.zeros((2 ** 14 + 1, 4)), mesh,
                                compute_type=sd.ComputeType.
                                COMPLEX_KARATSUBA_MULT)
    with pytest.raises(ValueError, match="n_panel"):
        sd.gemm_sharded(torch.zeros((4, 16)), torch.zeros((16, 32)), mesh,
                        n_panel=6)
    with pytest.raises(NotImplementedError, match="fastmode"):
        sd.gemm_sharded(torch.zeros((4, 16)), torch.zeros((16, 32)), mesh,
                        fastmode=False, n_panel=8)
    with pytest.raises(ValueError, match="must divide mesh"):
        sd.shard_of(np.zeros((6, 8)), sd.Mesh(4, 1, 0, "gloo",
                                              torch.device("cpu"), None,
                                              None))
    # the JAX package's own message for the same global shape
    jmesh = jdist.make_mesh(4, shape=(1, 4))
    with pytest.raises(ValueError, match="divide mesh"):
        jdist.gemm_sharded(np.zeros((30, 256), np.float32),
                           np.zeros((256, 30), np.float32), jmesh,
                           num_moduli=4)


def test_backend_device_mismatch_raises():
    """No fallback: a CUDA shard on a (CPU) gloo mesh, a CPU shard on an
    NCCL mesh and a shard on another device raise before any collective
    (the NCCL case is a check on the mesh's backend and device)."""
    cpu = torch.zeros((4, 16))
    gloo = _fake_mesh(1, 1)
    with pytest.raises(ValueError, match="gloo mesh moves tensors on cpu"):
        sd.check_device(gloo, torch.device("cuda", 0))
    nccl = dataclasses.replace(gloo, backend="nccl",
                               device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="nccl mesh moves tensors on cuda"):
        sd.gemm_sharded(cpu, cpu.t(), nccl)
    with pytest.raises(ValueError, match="nccl mesh"):
        sd.gemm_sharded_complex(cpu.to(torch.complex128),
                                cpu.t().to(torch.complex128), nccl)
    with pytest.raises(ValueError, match="lies on meta"):
        sd.gemm_sharded(torch.zeros((4, 16), device="meta"), cpu.t(), gloo)
    with pytest.raises(RuntimeError, match="process group"):
        sd.make_mesh()


def test_mesh_device():
    """A mesh's device: the CPU on gloo by default, a named card on gloo
    (gloo moves CUDA tensors through host memory), never the CPU on
    NCCL."""
    assert sd.mesh_device("gloo") == torch.device("cpu")
    assert sd.mesh_device("gloo", "cuda:0") == torch.device("cuda", 0)
    assert sd.mesh_device("nccl", "cuda:1") == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="nccl mesh moves CUDA tensors"):
        sd.mesh_device("nccl", "cpu")


def test_stats_rescale_is_exact():
    """ROADMAP C13: the merge over y rescales each rank's norm by an exact
    power of two (torch.ldexp), where the JAX package's combine_stats takes
    jnp.exp2 of a float."""
    rng = np.random.default_rng(5)
    s = torch.from_numpy(rng.uniform(1.0, 2.0 ** 20, 4096).astype(
        np.float32))
    d = torch.from_numpy(rng.integers(-60, 1, 4096))
    got = sd.rescale_norm(s, d).numpy()
    want = (s.numpy().astype(np.float64)
            * np.exp2(2.0 * d.numpy())).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.dtype == np.float32
    # every exponent that keeps a norm in [1, 2^20) normal
    for dd in range(-50, 1):
        one = sd.rescale_norm(torch.tensor([1.5], dtype=torch.float32),
                              torch.tensor([dd])).item()
        assert one == 1.5 * 2.0 ** (2 * dd)
