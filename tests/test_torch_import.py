"""The port imports without JAX, without nvcc and without a GPU, and
builds nothing at import."""

import subprocess
import sys
from pathlib import Path

from test_torch_threads import one_torch_thread  # noqa: E402, F401

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import gemmul8_tpu_torch
import gemmul8_tpu_torch.api, gemmul8_tpu_torch.core.gemm
import gemmul8_tpu_torch.planner, gemmul8_tpu_torch.pipelined
import gemmul8_tpu_torch.core.riders, gemmul8_tpu_torch.hopper.pipelined
import gemmul8_tpu_torch.core.complexgemm
import gemmul8_tpu_torch.core.encode, gemmul8_tpu_torch.core.reconstruct
import gemmul8_tpu_torch.core.slicegemm, gemmul8_tpu_torch.core.limbs
import gemmul8_tpu_torch.hopper.kernels, gemmul8_tpu_torch.hopper.matmul
import gemmul8_tpu_torch.bench.matrices, gemmul8_tpu_torch.bench.native
import gemmul8_tpu_torch.bench.timing, gemmul8_tpu_torch.hopper.probes
import gemmul8_tpu_torch.probes.clz, gemmul8_tpu_torch.probes.vpu_ops
import gemmul8_tpu_torch.probes.mxu_crt, gemmul8_tpu_torch.probes.deaddep
import gemmul8_tpu_torch.probes.__main__
import gemmul8_tpu_torch.config, gemmul8_tpu_torch.baselines.ozimmu
import gemmul8_tpu_torch.ops.mpgemm, gemmul8_tpu_torch.bench.evalref
import gemmul8_tpu_torch.bench.replay, gemmul8_tpu_torch.bench.harness
import gemmul8_tpu_torch.bench.power, gemmul8_tpu_torch.bench.__main__
import gemmul8_tpu_torch.interception, gemmul8_tpu_torch.parallel.multihost
import gemmul8_tpu_torch.parallel.distributed
import gemmul8_tpu_torch.parallel.smoke
import gemmul8_tpu_torch.scripts.accuracy_sweep
import gemmul8_tpu_torch.scripts.band_seed_sweep
import gemmul8_tpu_torch.scripts.time_sweep
import gemmul8_tpu_torch.scripts.scale_bench
import gemmul8_tpu_torch.scripts.profile_phases
import gemmul8_tpu_torch.scripts.weak_scaling
import gemmul8_tpu_torch.scripts.evidence
import gemmul8_tpu_torch.scripts.compare_csvs
import gemmul8_tpu_torch.scripts.tune_kernels
import gemmul8_tpu_torch.scripts.tune_matmul
import gemmul8_tpu_torch.bench.bounds
import gemmul8_tpu_torch.examples.one_accuracy
import gemmul8_tpu_torch.examples.one_accuracy_complex
import gemmul8_tpu_torch.examples.profile_one_call
import gemmul8_tpu_torch.examples.distributed_gemm
import gemmul8_tpu_torch.examples.blocked_lu
import torch.distributed
from gemmul8_tpu_torch.hopper import build
assert not torch.distributed.is_initialized(), "process group at import"
assert "jax" not in sys.modules, "jax imported"
assert not any(m.startswith("gemmul8_tpu.") or m == "gemmul8_tpu"
               for m in sys.modules), "JAX package imported"
assert build._lib is None, "kernel library loaded at import"
print("ok")
"""


def test_import_without_jax_or_nvcc(tmp_path):
    # PATH without nvcc; a fresh interpreter that never saw conftest's jax
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert not (tmp_path / "build").exists()


def test_sources_are_cuda_files():
    from gemmul8_tpu_torch.hopper import build

    names = sorted(p.name for p in build.sources())
    assert names == ["common.cuh", "crt.cuh", "crt_mma.cuh",
                     "crt_tail.cuh", "encode.cu", "encode_mma.cuh",
                     "fast_encode_fused.cu", "fast_sft.cu", "fast_stats.cuh",
                     "mag7.cu", "magmax.cu", "matmul_complex.cu",
                     "matmul_crt.cu", "matmul_mod.cu",
                     "matmul_mod_pipelined.cu", "matmul_reconstruct.cu",
                     "matmul_rider.cu",
                     "moduli.cuh", "probe_clz.cu",
                     "probe_deaddep.cu", "probe_mxu_crt.cu",
                     "probe_vpu_ops.cu", "reconstruct.cu",
                     "src_word.cuh", "transpose_b.cuh",
                     "wgmma_s8.cuh"]


def test_every_entry_point_has_a_signature():
    """ctypes needs the argument types of every exported C function, with
    one pointer or int per parameter."""
    import re

    from gemmul8_tpu_torch.hopper import build

    found = {}
    for src in build.sources():
        text = src.read_text()
        for name, params in re.findall(r"GM8_EXPORT int (gm8_\w+)\(([^)]*)\)",
                                       text):
            found[name] = len(params.split(","))
    assert found.keys() == build._SIGNATURES.keys()
    for name, n in found.items():
        assert len(build._SIGNATURES[name]) == n, name


def test_crt_table_layout():
    """The CRT constants (the reconstruct kernel's __constant__ table, and
    entry by entry the CRT-fused GEMMs' kernel parameter): 544 bytes per
    moduli count, weights that rebuild the CRT weights exactly."""
    import numpy as np

    from gemmul8_tpu_torch import tables
    from gemmul8_tpu_torch.hopper import kernels as hk

    blob = hk.crt_table_bytes()
    assert len(blob) == 544 * (tables.MAX_MODULI + 1)
    words = np.frombuffer(blob, dtype=np.uint32).reshape(21, 136)
    for L in (2, 14, 20):
        w = words[L, :120].reshape(20, 6)
        for j, wj in enumerate(tables.crt_weights(L)):
            assert sum(int(w[j, i]) << (32 * i) for i in range(6)) == wj
        m = sum(int(words[L, 120 + i]) << (32 * i) for i in range(6))
        assert m == tables.big_m(L)
        assert hk.crt_table_entry(L).tobytes() == blob[544 * L:544 * (L + 1)]
