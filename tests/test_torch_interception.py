"""The port's matmul interception vs the JAX package's, on the same bits.

gemmul8_tpu_torch.interception.override_matmuls enters a TorchFunctionMode
that routes torch.matmul / torch.mm / Tensor.matmul / Tensor.mm / `@`,
two-operand torch.einsum matmul spellings and torch.tensordot with one
contracted dim a side through gemmul8_tpu_torch.gemm on the operands'
device (here CPU tensors: every kernel's plain version). The cases are
those of the JAX package's interception tests (test_lowmem_intercept.py,
test_review_fixes.py, test_round2_api.py, test_mpgemm.py); each routed
result is held to the JAX package's intercepted result on the same inputs
(jnp.matmul / jnp.einsum / jax.lax.dot_general under its override_matmuls).

Tolerance: bit equality, except that a fast-mode shift may differ from the
JAX package's by 1 where its pre-floor value lies within 1e-4 of an integer
(the f32 norm's summation order); there the rule is asserted and the
output is held to the exact product (1e-12 of |A||B| for f64 output,
2^-20 for f32). The JAX case under jax.jit has no eager counterpart: its
place goes to a call under torch.no_grad().
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu_torch as gt
from gemmul8_tpu import interception as jicp
from gemmul8_tpu.core import gemm as gg
from gemmul8_tpu.types import f64_to_bits
from gemmul8_tpu_torch import interception as icp
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.hopper import kernels as hk

from test_torch_threads import one_torch_thread  # noqa: E402, F401

SHIFT_RULE_FRAC = 1e-4


def _mk(shape, phi=0.5, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) - 0.5)
            * np.exp(rng.standard_normal(shape) * phi)).astype(dtype)


def _emulate_all(m, n, k, dtype):
    return "emulate"


@pytest.fixture(autouse=True)
def _clean():
    """Every test starts with an empty profile log, no forced mode and
    the default thresholds."""
    icp.clear_profile_log()
    icp.unset_compute_mode()
    jicp.clear_profile_log()
    jicp.unset_compute_mode()
    yield
    icp.unset_compute_mode()
    jicp.unset_compute_mode()


def _jax(fn, L, fastmode=True, rule=_emulate_all):
    """fn() under the JAX package's override_matmuls: (numpy result, its
    last-func string)."""
    with jicp.override_matmuls(num_moduli=L, fastmode=fastmode, rule=rule):
        out = np.asarray(fn())
    return out, jicp.get_last_func_name()


def _jax_sfts(a, b, L):
    ja = f64_to_bits(a) if a.dtype == np.float64 else jnp.asarray(a)
    jb = f64_to_bits(b) if b.dtype == np.float64 else jnp.asarray(b)
    return (np.asarray(gg._fast_sft_only(ja, L, axis=1)),
            np.asarray(gg._fast_sft_only(jb, L, axis=0)))


def _assert_rule(ref, got, frac):
    diff = ref != got
    if not diff.any():
        return
    assert np.abs(ref[diff].astype(np.int64) - got[diff]).max() <= 1
    assert float(frac.numpy().reshape(ref.shape)[diff].max()) \
        < SHIFT_RULE_FRAC, "shift differs away from a floor boundary"


def _check(a, b, L, ref, got):
    """got (the port's intercepted output) == ref (the JAX package's), both
    for op(A) = a and op(B) = b (fast mode), when the shifts agree; else
    the floor-boundary rule holds and got is held to the exact product."""
    got = got.numpy()
    assert ref.dtype == got.dtype and ref.shape == got.shape
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = _jax_sfts(a, b, L)
    pa, pb = hk.fast_sft(ta, L, 1).numpy(), hk.fast_sft(tb, L, 0).numpy()
    if np.array_equal(ja, pa) and np.array_equal(jb, pb):
        np.testing.assert_array_equal(ref.view(np.uint8), got.view(np.uint8))
        return
    _assert_rule(ja, pa, enc.sft_floor_frac(enc.fast_stats(ta, 1)[1],
                                            a.shape[1], L))
    _assert_rule(jb, pb, enc.sft_floor_frac(enc.fast_stats(tb, 0)[1],
                                            b.shape[0], L))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    tol = 1e-12 if got.dtype == np.float64 else 2.0 ** -20
    assert np.all(np.abs(got.astype(np.float64) - a64 @ b64)
                  <= tol * (np.abs(a64) @ np.abs(b64)) + 1e-300)


# ---- the JAX package's interception cases -----------------------------------

def test_interception_routes_and_profiles():
    a = _mk((128, 128), seed=320)
    b = _mk((128, 128), seed=321)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    native = torch.matmul(ta, tb)
    with icp.override_matmuls(num_moduli=16, profile=True):
        out = torch.matmul(ta, tb)
        small = torch.matmul(ta[:2, :2], tb[:2, :2])  # below threshold
    log = icp.get_profile_log()
    # native-routed calls are recorded too (CULiP logs every call)
    assert [r.mode for r in log] == ["emulate-16", "native"]
    assert [(r.m, r.n, r.k, r.dtype) for r in log] == [
        (128, 128, 128, "float64"), (2, 2, 2, "float64")]
    assert all(r.seconds > 0 for r in log)
    assert torch.equal(small, ta[:2, :2] @ tb[:2, :2])
    ref, _ = _jax(lambda: jnp.matmul(jnp.asarray(a), jnp.asarray(b)), 16,
                  rule=jicp.default_rule)
    _check(a, b, 16, ref, out)
    # after exit, torch.matmul is native again
    assert torch.equal(torch.matmul(ta, tb), native)


def test_interception_rule_callback():
    a = torch.from_numpy(_mk((128, 64), seed=330))
    b = torch.from_numpy(_mk((64, 128), seed=331))
    calls = []

    def rule(m, n, k, dtype):
        calls.append((m, n, k, dtype))
        return "native"

    with icp.override_matmuls(rule=rule):
        out = torch.matmul(a, b)
    assert calls == [(128, 128, 64, torch.float64)]
    assert torch.equal(out, a @ b)


def test_hijack_control_forced_mode():
    a = np.random.default_rng(0).random((96, 96)).astype(np.float32)
    ta = torch.from_numpy(a)
    with icp.override_matmuls(num_moduli=8):
        icp.set_compute_mode("native")
        nat = torch.matmul(ta, ta)
        assert icp.get_last_func_name().endswith("->native")
        icp.set_compute_mode("emulate")
        emu = torch.matmul(ta, ta)
        assert icp.get_last_func_name() == "matmul[96x96x96,float32]->emulate"
        icp.unset_compute_mode()
    assert torch.equal(nat, ta @ ta)
    with pytest.raises(ValueError):
        icp.set_compute_mode("sometimes")

    def forced():
        jicp.set_compute_mode("emulate")
        return jnp.matmul(jnp.asarray(a), jnp.asarray(a))

    ref, name = _jax(forced, 8, rule=jicp.default_rule)
    assert name == "matmul[96x96x96,float32]->emulate"
    _check(a, a, 8, ref, emu)


def test_intercept_requires_both_dtypes_eligible():
    a = torch.ones((128, 128), dtype=torch.float32)
    b = torch.ones((128, 128), dtype=torch.int32)
    with pytest.raises(RuntimeError) as outside:
        torch.matmul(a, b)
    with icp.override_matmuls():
        # passed through: torch's own error, not one from the emulator
        with pytest.raises(RuntimeError) as inside:
            torch.matmul(a, b)
        ints = torch.matmul(b.long(), b.long())
    assert str(inside.value) == str(outside.value)
    assert ints.dtype == torch.int64 and bool((ints == 128).all())
    assert icp.get_profile_log() == []


def test_matmul_operator_is_intercepted():
    a = np.random.default_rng(0).standard_normal((128, 128)).astype(
        np.float32)
    ta = torch.from_numpy(a)
    with icp.override_matmuls(num_moduli=8, profile=True):
        out_op = ta @ ta
        out_fn = torch.matmul(ta, ta)
    log = icp.get_profile_log()
    assert len(log) == 2, f"@ operator not routed: {log}"
    assert all(r.mode.startswith("emulate") for r in log)
    assert torch.equal(out_op, out_fn)
    ref, _ = _jax(lambda: jnp.asarray(a) @ jnp.asarray(a), 8,
                  rule=jicp.default_rule)
    _check(a, a, 8, ref, out_op)
    # and the mode is gone outside the context
    assert torch.allclose(ta @ ta, torch.from_numpy(a @ a), rtol=1e-5)
    assert len(icp.get_profile_log()) == 2


def test_matmul_operator_intercepted_under_no_grad():
    """The JAX case runs `x @ x` under jax.jit; eager torch has no trace,
    so its place goes to a call under torch.no_grad()."""
    a = np.random.default_rng(1).standard_normal((128, 128)).astype(
        np.float32)
    ta = torch.from_numpy(a)
    with icp.override_matmuls(num_moduli=10), torch.no_grad():
        emulated = ta @ ta
    assert torch.equal(emulated, gt.gemm(ta, ta, num_moduli=10))
    ref, _ = _jax(lambda: jax.jit(lambda x: x @ x)(jnp.asarray(a)), 10,
                  rule=jicp.default_rule)
    _check(a, a, 10, ref, emulated)


def test_profile_logs_native_calls_too():
    a = torch.ones((8, 8), dtype=torch.float32)  # below intercept threshold
    with icp.override_matmuls(profile=True):
        torch.matmul(a, a)
    log = icp.get_profile_log()
    assert len(log) == 1 and log[0].mode == "native"


def test_einsum_interception_routes():
    a = _mk((48, 64), dtype=np.float32)
    b = _mk((64, 40), seed=1, dtype=np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = gt.gemm(ta, tb, num_moduli=8)
    with icp.override_matmuls(num_moduli=8, rule=_emulate_all, profile=True):
        got = torch.einsum("ij,jk", ta, tb)
    assert any(r.mode.startswith("emulate") for r in icp.get_profile_log())
    assert torch.equal(want, got)
    ref, _ = _jax(lambda: jnp.einsum("ij,jk", jnp.asarray(a),
                                     jnp.asarray(b)), 8)
    _check(a, b, 8, ref, got)


def test_einsum_interception_transposed_forms():
    a = _mk((48, 64), dtype=np.float32)
    bt = _mk((40, 64), seed=1, dtype=np.float32)  # (n, k): B^T
    ta, tbt = torch.from_numpy(a), torch.from_numpy(bt)
    want = gt.gemm(ta, tbt, num_moduli=8, op_b="T")
    with icp.override_matmuls(num_moduli=8, rule=_emulate_all):
        got = torch.einsum("ij,kj->ik", ta, tbt)
    assert torch.equal(want, got)
    assert icp.get_last_func_name().startswith("matmul[48x64x40")
    ref, name = _jax(lambda: jnp.einsum("ij,kj->ik", jnp.asarray(a),
                                        jnp.asarray(bt)), 8)
    assert name == icp.get_last_func_name()
    _check(a, np.ascontiguousarray(bt.T), 8, ref, got)


def test_einsum_passthrough_non_matmul():
    a = torch.from_numpy(_mk((8, 8), dtype=np.float32))
    with icp.override_matmuls(num_moduli=8, rule=_emulate_all,
                              profile=True):
        tr = torch.einsum("ii", a)            # trace: not a matmul
        hd = torch.einsum("ij,ij->ij", a, a)  # hadamard
    assert torch.equal(tr, torch.einsum("ii", a))
    assert torch.equal(hd, a * a)
    assert icp.get_profile_log() == []


def test_einsum_passthrough_scalar_output():
    """'ij,jk->' (explicit empty output) is a full contraction to a
    scalar, not a matmul: the router checks the separator."""
    a = torch.from_numpy(_mk((8, 16), dtype=np.float32))
    b = torch.from_numpy(_mk((16, 8), seed=1, dtype=np.float32))
    with icp.override_matmuls(num_moduli=8, rule=_emulate_all):
        s = torch.einsum("ij,jk->", a, b)
    assert s.dim() == 0
    assert torch.equal(s, torch.einsum("ij,jk->", a, b))


def test_tensordot_interception():
    """torch.tensordot with one contracted dim a side: the counterpart of
    the JAX package's lax.dot_general rule."""
    a = _mk((32, 96), dtype=np.float32)
    b = _mk((96, 24), seed=2, dtype=np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = gt.gemm(ta, tb, num_moduli=8)
    with icp.override_matmuls(num_moduli=8, rule=_emulate_all):
        got = torch.tensordot(ta, tb, dims=([1], [0]))
    assert torch.equal(want, got)
    ref, _ = _jax(lambda: jax.lax.dot_general(
        jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ()))), 8)
    _check(a, b, 8, ref, got)


def test_hijack_control_load_probe():
    assert not icp.is_library_loaded()
    with icp.override_matmuls(num_moduli=8):
        assert icp.is_library_loaded()
    assert not icp.is_library_loaded()
    # parity no-ops must exist and accept calls
    icp.enable_restoring_AB_after_scaling()
    icp.disable_restoring_AB_after_scaling()


def test_interception_restores_mode_stack():
    """The counterpart of the JAX test that the patched bindings are put
    back: the mode is on the stack inside the context and gone after."""
    from torch.overrides import _get_current_function_mode_stack

    before = len(_get_current_function_mode_stack())
    with icp.override_matmuls(num_moduli=8):
        assert len(_get_current_function_mode_stack()) == before + 1
    assert len(_get_current_function_mode_stack()) == before


# ---- every einsum and tensordot form, routed or passed through as in JAX ----

EINSUM_ROUTED = [("ij,jk->ik", "NN"), ("ij,jk", "NN"), ("ab,bc->ac", "NN"),
                 ("ji,jk->ik", "TN"), ("ij,kj->ik", "NT"),
                 ("ji,kj->ik", "TT"), ("ij,kj", "NT"),
                 (" ij , jk -> ik", "NN")]


@pytest.mark.parametrize("spec,ops", EINSUM_ROUTED,
                         ids=[s.replace(" ", "_") for s, _ in EINSUM_ROUTED])
def test_einsum_routed_forms(spec, ops):
    m, k, n = 40, 72, 24
    a_op, b_op = _mk((m, k), seed=11), _mk((k, n), seed=12)
    a = a_op if ops[0] == "N" else np.ascontiguousarray(a_op.T)
    b = b_op if ops[1] == "N" else np.ascontiguousarray(b_op.T)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with icp.override_matmuls(num_moduli=14, rule=_emulate_all,
                              profile=True):
        got = torch.einsum(spec, ta, tb)
    assert [r.mode for r in icp.get_profile_log()] == ["emulate-14"]
    assert icp.get_last_func_name() == f"matmul[{m}x{k}x{n},float64]->" \
                                       "emulate"
    ref, name = _jax(lambda: jnp.einsum(spec, jnp.asarray(a),
                                        jnp.asarray(b)), 14)
    assert name == icp.get_last_func_name()
    _check(a_op, b_op, 14, ref, got)


EINSUM_PASSED = [("ij,jk->", 2), ("ij,jk->ki", 2), ("kj,ji", 2),
                 ("ij,ij->ij", 2), ("ij,ij", 2), ("ii", 1),
                 ("ij,jk,kl->il", 3), ("ij,jk->ijk", 2), ("ijk,kl->ijl", 2)]


@pytest.mark.parametrize("spec,nops", EINSUM_PASSED,
                         ids=[s for s, _ in EINSUM_PASSED])
def test_einsum_passed_through_forms(spec, nops):
    """Each form the JAX router leaves to einsum: the scalar output, the
    reversed explicit or implicit output (a transposed matmul), the
    elementwise and trace forms, three operands, a batch operand."""
    shapes = {"ijk,kl->ijl": [(2, 8, 8), (8, 8)]}.get(spec, [(8, 8)] * nops)
    ts = [torch.from_numpy(_mk(s, seed=20 + i)) for i, s in enumerate(shapes)]
    with icp.override_matmuls(num_moduli=14, rule=_emulate_all,
                              profile=True):
        got = torch.einsum(spec, *ts)
    assert icp.get_profile_log() == []
    assert torch.equal(got, torch.einsum(spec, *ts))
    if nops == 2 and len(shapes[0]) == 2:
        # the JAX router passes the same spelling through too
        with jicp.override_matmuls(num_moduli=14, rule=_emulate_all,
                                   profile=True):
            jnp.einsum(spec, *(jnp.asarray(t.numpy()) for t in ts))
        assert [r.mode for r in jicp.get_profile_log()] == []


def test_einsum_list_form_passes_through():
    a = torch.from_numpy(_mk((64, 64), seed=3))
    with icp.override_matmuls(num_moduli=14, rule=_emulate_all,
                              profile=True):
        got = torch.einsum("ij,jk", [a, a])
    assert icp.get_profile_log() == []
    assert torch.equal(got, torch.einsum("ij,jk", [a, a]))


TENSORDOT_ROUTED = [(1, "NN"), (([1], [0]), "NN"), (((1,), (0,)), "NN"),
                    (([0], [0]), "TN"), (([1], [1]), "NT"), (([0], [1]), "TT"),
                    (([-1], [0]), "NN")]


@pytest.mark.parametrize("dims,ops", TENSORDOT_ROUTED,
                         ids=[str(d).replace(" ", "") for d, _ in
                              TENSORDOT_ROUTED])
def test_tensordot_routed_forms(dims, ops):
    m, k, n = 40, 72, 24
    a_op, b_op = _mk((m, k), seed=13), _mk((k, n), seed=14)
    a = a_op if ops[0] == "N" else np.ascontiguousarray(a_op.T)
    b = b_op if ops[1] == "N" else np.ascontiguousarray(b_op.T)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with icp.override_matmuls(num_moduli=14, rule=_emulate_all,
                              profile=True):
        got = torch.tensordot(ta, tb, dims=dims)
    assert [r.mode for r in icp.get_profile_log()] == ["emulate-14"]
    lc = (1,) if ops[0] == "N" else (0,)
    rc = (0,) if ops[1] == "N" else (1,)
    ref, name = _jax(lambda: jax.lax.dot_general(
        jnp.asarray(a), jnp.asarray(b), ((lc, rc), ((), ()))), 14)
    assert name == icp.get_last_func_name()
    _check(a_op, b_op, 14, ref, got)


@pytest.mark.parametrize("dims", [0, 2, ([0, 1], [0, 1])],
                         ids=["outer", "full", "two-a-side"])
def test_tensordot_passed_through_forms(dims):
    a = torch.from_numpy(_mk((64, 64), seed=5))
    b = torch.from_numpy(_mk((64, 64), seed=6))
    with icp.override_matmuls(num_moduli=14, rule=_emulate_all,
                              profile=True):
        got = torch.tensordot(a, b, dims=dims)
    assert icp.get_profile_log() == []
    assert torch.equal(got, torch.tensordot(a, b, dims=dims))


def test_out_argument_passes_through():
    a = torch.from_numpy(_mk((96, 96), seed=7))
    out = torch.empty((96, 96), dtype=torch.float64)
    dot = torch.empty((96, 96), dtype=torch.float64)
    with icp.override_matmuls(num_moduli=14, rule=_emulate_all,
                              profile=True):
        r1 = torch.matmul(a, a, out=out)
        r2 = torch.mm(a, a, out=torch.empty_like(out))
        r3 = torch.tensordot(a, a, dims=1, out=dot)
    assert icp.get_profile_log() == []
    assert r1 is out and r3 is dot
    native = torch.matmul(a, a)
    assert torch.equal(r1, native) and torch.equal(r2, native)


def test_mm_and_methods_route():
    a = torch.from_numpy(_mk((80, 96), seed=8))
    b = torch.from_numpy(_mk((96, 72), seed=9))
    want = gt.gemm(a, b, num_moduli=14)
    with icp.override_matmuls(num_moduli=14, rule=_emulate_all,
                              profile=True):
        outs = [torch.mm(a, b), a.mm(b), a.matmul(b), a @ b,
                b.__rmatmul__(a)]
    assert len(icp.get_profile_log()) == len(outs)
    for out in outs:
        assert torch.equal(out, want)


def test_below_threshold_is_native():
    a = torch.from_numpy(_mk((32, 32), seed=10))
    with icp.override_matmuls(num_moduli=14, profile=True):
        got = a @ a
    assert [r.mode for r in icp.get_profile_log()] == ["native"]
    assert icp.get_last_func_name() == "matmul[32x32x32,float64]->native"
    assert torch.equal(got, torch.matmul(a, a))


def test_complex_routes():
    za = _mk((64, 80), seed=15) + 1j * _mk((64, 80), seed=16)
    zb = _mk((80, 72), seed=17) + 1j * _mk((80, 72), seed=18)
    ta, tb = torch.from_numpy(za), torch.from_numpy(zb)
    with icp.override_matmuls(num_moduli=14, rule=_emulate_all):
        got = ta @ tb
    assert got.dtype == torch.complex128
    assert icp.get_last_func_name() == "matmul[64x80x72,complex128]->emulate"
    assert torch.equal(got, gt.gemm(ta, tb, num_moduli=14))
    ref, name = _jax(lambda: jnp.asarray(za) @ jnp.asarray(zb), 14)
    assert name == icp.get_last_func_name()
    np.testing.assert_array_equal(ref.view(np.uint8), got.numpy().view(
        np.uint8))


def test_requires_grad_passes_through():
    a = torch.from_numpy(_mk((96, 96), seed=19)).requires_grad_()
    with icp.override_matmuls(num_moduli=14, rule=_emulate_all,
                              profile=True):
        out = a @ a
        with torch.no_grad():
            emu = a @ a
    assert out.requires_grad and out.grad_fn is not None
    assert [r.mode for r in icp.get_profile_log()] == ["emulate-14"]
    assert torch.equal(emu, gt.gemm(a.detach(), a.detach(), num_moduli=14))


def test_nesting_innermost_settings_win():
    a = torch.from_numpy(_mk((96, 96), seed=21))
    with icp.override_matmuls(num_moduli=8, rule=_emulate_all,
                              profile=True):
        outer1 = a @ a
        with icp.override_matmuls(num_moduli=12, rule=_emulate_all,
                                  profile=True):
            inner = a @ a
            assert icp.is_library_loaded()
        outer2 = a @ a
        assert icp.is_library_loaded()
    assert not icp.is_library_loaded()
    assert [r.mode for r in icp.get_profile_log()] == [
        "emulate-8", "emulate-12", "emulate-8"]
    assert torch.equal(outer1, gt.gemm(a, a, num_moduli=8))
    assert torch.equal(outer2, outer1)
    assert torch.equal(inner, gt.gemm(a, a, num_moduli=12))


def test_restore_after_exception():
    from torch.overrides import _get_current_function_mode_stack

    a = torch.from_numpy(_mk((96, 96), seed=22))
    before = len(_get_current_function_mode_stack())
    with pytest.raises(KeyError):
        with icp.override_matmuls(num_moduli=8, rule=_emulate_all):
            with icp.override_matmuls(num_moduli=12, rule=_emulate_all):
                raise KeyError("inside")
    assert not icp.is_library_loaded()
    assert len(_get_current_function_mode_stack()) == before
    with icp.override_matmuls(num_moduli=8, profile=True):
        pass
    assert torch.equal(a @ a, torch.matmul(a, a))
    assert icp.get_profile_log() == []


def test_mode_is_thread_local():
    """The port's mode reroutes only the thread that entered it (the JAX
    package's patches are process-wide)."""
    a = torch.from_numpy(_mk((96, 96), seed=23))
    native = torch.matmul(a, a)
    seen = {}
    entered, done = threading.Event(), threading.Event()

    def other():
        entered.wait(timeout=60)
        seen["loaded"] = icp.is_library_loaded()
        seen["out"] = a @ a
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with icp.override_matmuls(num_moduli=14, rule=_emulate_all,
                              profile=True):
        entered.set()
        assert done.wait(timeout=60)
        mine = a @ a
    t.join(timeout=60)
    assert not t.is_alive()
    assert seen["loaded"] is False
    assert torch.equal(seen["out"], native)
    assert [r.mode for r in icp.get_profile_log()] == ["emulate-14"]
    assert torch.equal(mine, gt.gemm(a, a, num_moduli=14))


def test_default_rule_thresholds(monkeypatch):
    from gemmul8_tpu_torch import config as cfg

    monkeypatch.setenv("GEMMUL8_INTERCEPT_THRESHOLD_M", "100")
    cfg.reload_config()
    try:
        assert icp.default_rule(99, 128, 128, torch.float64) == "native"
        assert icp.default_rule(100, 128, 128, torch.float64) == "emulate"
        monkeypatch.setenv("GEMMUL8_COMPUTE_MODE", "off")
        cfg.reload_config()
        assert icp.default_rule(512, 512, 512, torch.float64) == "native"
    finally:
        monkeypatch.undo()
        cfg.reload_config()
