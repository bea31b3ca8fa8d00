"""The port's multi-process entry path (parallel.multihost) and its smoke
and dry run (parallel.smoke) on gloo CPU ranks: the counterpart of
tests/test_multihost.py and of the JAX package's multi-chip dry run."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from gemmul8_tpu_torch.parallel import multihost

from test_torch_threads import one_torch_thread  # noqa: E402, F401

REPO = Path(__file__).resolve().parent.parent
_VARS = ("GEMMUL8_COORD", "GEMMUL8_NPROC", "GEMMUL8_PROC_ID",
         "GEMMUL8_LOCAL_DEVICE_IDS", "WORLD_SIZE", "RANK", "MASTER_ADDR",
         "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture
def bare_env(monkeypatch):
    for v in _VARS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def test_initialize_from_env_noop_single_process(bare_env):
    # no GEMMUL8_* variable, no launcher's world: a clean no-op
    assert multihost.initialize_from_env() is False
    assert multihost.initialize_from_env(force_cpu=True) is False
    assert not dist.is_initialized()
    assert multihost.is_multiprocess() is False
    assert multihost.process_summary() == "process 0/1: no process group"


def test_launcher_world_detection(bare_env):
    assert not multihost._on_pod()
    bare_env.setenv("WORLD_SIZE", "2")
    assert not multihost._on_pod()          # no rendezvous address
    bare_env.setenv("MASTER_ADDR", "127.0.0.1")
    assert multihost._on_pod()
    bare_env.setenv("WORLD_SIZE", "1")
    assert not multihost._on_pod()          # a world of one needs no group


def test_partial_variables_raise(bare_env):
    bare_env.setenv("GEMMUL8_COORD", "127.0.0.1:1")
    with pytest.raises(ValueError, match="GEMMUL8_NPROC, GEMMUL8_PROC_ID"):
        multihost.initialize_from_env(force_cpu=True)
    assert not dist.is_initialized()


def test_nccl_without_a_card_raises(bare_env, monkeypatch):
    """The default backend is NCCL; without a card it raises before any
    rendezvous (force_cpu=True is the gloo route)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bare_env.setenv("GEMMUL8_COORD", "127.0.0.1:1")
    bare_env.setenv("GEMMUL8_NPROC", "2")
    bare_env.setenv("GEMMUL8_PROC_ID", "0")
    with pytest.raises(RuntimeError, match="force_cpu=True"):
        multihost.initialize_from_env()
    assert not dist.is_initialized()


def _run(args):
    env = {k: v for k, v in os.environ.items() if k not in _VARS}
    return subprocess.run(
        [sys.executable, "-m", "gemmul8_tpu_torch.parallel.smoke", *args],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=280)


def test_two_process_smoke():
    r = _run([])
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "multihost smoke OK" in r.stdout
    assert r.stdout.count("; multihost smoke OK") == 2   # each worker


def test_dryrun_four_ranks_under_jax_bounds():
    """The JAX dry run's cases on 4 gloo ranks (mesh 2x2), each under the
    JAX dry run's bound: fast, accurate and the three complex strategies
    max relerr < 1e-8, mixed-width and f64 x f32 medians < 1e-6 (the
    n_panel bits and the f32 median are checked by the dry run itself)."""
    r = _run(["--dryrun", "4"])
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    line = next(s for s in r.stdout.splitlines()
                if s.startswith("dryrun_multichip OK"))
    assert "on 4 ranks (mesh 2x2" in line
    num = r"([0-9.]+e[-+][0-9]+)"
    fast = float(re.search(r"fast relerr " + num, line).group(1))
    accu = float(re.search(r"accurate " + num, line).group(1))
    big, classic, kara = map(float, re.search(
        r"big/classic/kara " + num + "/" + num + "/" + num, line).groups())
    mixed = float(re.search(r"mixed-width med " + num, line).group(1))
    md = float(re.search(r"md med " + num, line).group(1))
    assert max(fast, accu, big, classic, kara) < 1e-8
    assert max(mixed, md) < 1e-6
    assert "JAX dry run, 8 devices, mesh 2x4" in line
