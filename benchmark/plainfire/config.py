"""Numeric and device policy for the PyTorch port.

Precision policy (the same as the JAX package's):
  * validation against the reference wants float64 — the default on CPU;
  * production runs on the GPU use float32 — the default on CUDA.
Callers pick another dtype explicitly (FireFoamSolver(dtype=...)).

Device policy: the port runs on the card. `default_device()` is CUDA and
raises where there is none; the CPU is used only when a caller passes
device="cpu" (the tests, `run --cpu`).

Every tensor the port builds carries an explicit device and dtype, so a
float64 host array never promotes a float32 device computation.
"""

from __future__ import annotations

import torch

__all__ = [
    "default_device",
    "real_dtype",
    "small",
    "TOL_FLOOR_EPS",
    "INT_DTYPE",
]

INT_DTYPE = torch.int64

# Stopping-floor multiplier on eps(dtype) for the Krylov solvers (about
# 1.2e-5 in float32): dictionary tolerances written for double precision
# are unreachable in float32 and would burn maxIter in every solve.
TOL_FLOOR_EPS = 100.0


def default_device() -> torch.device:
    """The CUDA card; raises where there is none (pass device="cpu" to run
    on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "firefoam_torch: no CUDA device; pass device=\"cpu\" (run --cpu) to run on the CPU"
        )
    return torch.device("cuda")


def real_dtype(device=None) -> torch.dtype:
    """The working real dtype: f64 on CPU, f32 on CUDA."""
    dev = torch.device(device) if device is not None else default_device()
    return torch.float64 if dev.type == "cpu" else torch.float32


def small(dtype=None) -> float:
    """Dtype-safe tiny guard for x/max(x, small()) denominators.

    1e-300 underflows to 0 in float32, which turns every max(x, 1e-300)
    guard into max(x, 0) and 0/0 into NaN; float32 gets 1e-32."""
    dtype = dtype or real_dtype()
    return 1e-300 if dtype == torch.float64 else 1e-32
