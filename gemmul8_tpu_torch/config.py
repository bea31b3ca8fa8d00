"""Runtime configuration via environment variables.

Counterpart of `gemmul8_tpu/config.py`, a copy of it: the same `GEMMUL8_*`
names, defaults and parse errors, so that both packages read one
environment the same way. The port keeps its own copy (it imports nothing
of the JAX package). The reference hijack libraries' env config it
mirrors: ozIMMU (OZIMMU_COMPUTE_MODE / OZIMMU_INFO / OZIMMU_ERROR /
OZIMMU_INTERCEPT_THRESHOLD_{M,N,K}) and cuMpSGEMM (CUMPSGEMM_COMPUTE_MODE).

  GEMMUL8_NUM_MODULI            default moduli count (2-20)
  GEMMUL8_FASTMODE              1 = vecnorm (default), 0 = int8tc accurate
  GEMMUL8_COMPUTE_MODE          interception mode: emulate | native | off
  GEMMUL8_INTERCEPT_THRESHOLD_M/N/K   min dims for interception to engage
  GEMMUL8_INFO / GEMMUL8_ERROR  1 = emit info/error logs to stderr
  GEMMUL8_PROFILE               1 = record per-call profiles
  GEMMUL8_AUTO_AVG_MANTISSA_LOSS_THRESHOLD
                                OS-I auto-split bit budget (float; the
                                OZIMMU_AUTO_AVG_MANTISSA_LOSS_THRESHOLD
                                mirror) - baselines.ozimmu.auto_num_split
                                default

The interception thresholds, `compute_mode` and `profile` have no reader
in the port yet (interception is not ported); they are kept so that it
reads this same object. The kernel switches (GEMMUL8_PIPELINE,
GEMMUL8_FUSED_*, GEMMUL8_MM_PIPELINE, GEMMUL8_MXU_CRT, GEMMUL8_MAGMAX_SCRATCH)
are read at each call by the modules they steer, not through this registry.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    s = v.strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off", ""):
        return False
    raise ValueError(f"{name}={v!r}: expected a boolean "
                     "(1/0, true/false, yes/no, on/off)")


def _env_mode(name: str, default: str) -> str:
    v = os.environ.get(name, default).strip().lower()
    if v not in ("emulate", "native", "off"):
        raise ValueError(f"{name}={v!r}: must be emulate | native | off")
    return v


@dataclass
class Config:
    num_moduli: int = field(
        default_factory=lambda: _env_int("GEMMUL8_NUM_MODULI", 14))
    fastmode: bool = field(
        default_factory=lambda: _env_flag("GEMMUL8_FASTMODE", True))
    compute_mode: str = field(
        default_factory=lambda: _env_mode("GEMMUL8_COMPUTE_MODE", "emulate"))
    intercept_threshold_m: int = field(
        default_factory=lambda: _env_int("GEMMUL8_INTERCEPT_THRESHOLD_M", 64))
    intercept_threshold_n: int = field(
        default_factory=lambda: _env_int("GEMMUL8_INTERCEPT_THRESHOLD_N", 64))
    intercept_threshold_k: int = field(
        default_factory=lambda: _env_int("GEMMUL8_INTERCEPT_THRESHOLD_K", 64))
    info: bool = field(default_factory=lambda: _env_flag("GEMMUL8_INFO",
                                                         False))
    error: bool = field(default_factory=lambda: _env_flag("GEMMUL8_ERROR",
                                                          True))
    profile: bool = field(default_factory=lambda: _env_flag("GEMMUL8_PROFILE",
                                                            False))
    auto_avg_mantissa_loss_threshold: float = field(
        default_factory=lambda: float(os.environ.get(
            "GEMMUL8_AUTO_AVG_MANTISSA_LOSS_THRESHOLD", "2.0")))


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def reload_config() -> Config:
    global _config
    _config = Config()
    return _config


def log_info(msg: str) -> None:
    if get_config().info:
        print(f"[gemmul8 INFO] {msg}", file=sys.stderr)


def log_error(msg: str) -> None:
    if get_config().error:
        print(f"[gemmul8 ERROR] {msg}", file=sys.stderr)
