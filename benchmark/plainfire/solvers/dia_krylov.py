"""The DIA whole-solve entry points of the frozen reference: always the
plain PyTorch twins (solvers/linear.py), on any device. The measured
program's CUDA kernels are not part of this copy."""

from __future__ import annotations

from typing import Sequence

import torch

from . import linear
from .linear import SolverResult


def _check_dia(name, upper, lower, offsets, nC):
    """Raise unless upper and lower are DIA off-diagonals: K·nC long with
    K ≥ 1 offsets."""
    K = len(offsets)
    if K < 1 or upper.shape[-1] != K * nC or lower.shape[-1] != K * nC:
        raise ValueError(
            f"dia_{name}: not a DIA system ({K} offsets, nC={nC}, off-diagonals of "
            f"{upper.shape[-1]} and {lower.shape[-1]}; expected K·nC with K ≥ 1)")


def dia_matvec(diag, upper, lower, offsets: Sequence[int], x):
    """M·x on the DIA layout for x [B, nC] (the plain version of the
    kernels' `dia_row`): d·x + (Σ_k u_k·x[c+o_k] + Σ_k l_k[c−o_k]·x[c−o_k]),
    summed in FvMatrix.matvec's order."""
    nC = x.shape[-1]
    _check_dia("matvec", upper, lower, offsets, nC)
    K = len(offsets)
    up = upper.reshape(upper.shape[:-1] + (K, nC))
    lo = lower.reshape(lower.shape[:-1] + (K, nC))
    own = sum(up[..., k, :] * torch.roll(x, -o, dims=-1) for k, o in enumerate(offsets))
    nei = 0
    for k, o in enumerate(offsets):
        lx = lo[..., k, :] * x
        nei = nei + torch.cat([torch.zeros_like(lx[..., :o]), lx[..., :-o]], dim=-1)
    return diag * x + (own + nei)


def plain(fn, diag, upper, lower, b, x0, offsets, tol=1e-6, rel_tol=0.0, max_iter=1000,
          **kw):
    """The plain PyTorch version of a kernel, on any device: the twin `fn`
    (linear.pcg, linear.bicgstab or linear.jacobi_smooth, whose extra
    arguments pass through `kw`) with the DIA matvec."""

    def mv(v):
        return dia_matvec(diag, upper, lower, offsets, v)

    return fn(mv, x0, b, diag, tol=tol, rel_tol=rel_tol, max_iter=max_iter, **kw)


def plain_smooth(diag, upper, lower, b, x0, offsets, tol=1e-6, rel_tol=0.0, max_iter=1000,
                 omega=0.8, check_every=4):
    """K3's plain version: jacobi_smooth counts rounds of `check_every`
    sweeps and reports sweeps; the kernel's `max_iter` counts sweeps and
    starts a round while it < max_iter, i.e. ceil(max_iter/check_every)
    rounds."""
    return plain(linear.jacobi_smooth, diag, upper, lower, b, x0, offsets, tol, rel_tol,
                 -(-int(max_iter) // int(check_every)), n_sweeps=int(check_every),
                 damping=float(omega))


def dia_pcg(diag, upper, lower, b, x0, offsets, tol=1e-6, rel_tol=0.0,
            max_iter=1000) -> SolverResult:
    """Jacobi-preconditioned CG (PCG/GAMG role)."""
    _check_dia("pcg", upper, lower, offsets, x0.shape[-1])
    return plain(linear.pcg, diag, upper, lower, b, x0, offsets, tol, rel_tol, max_iter)


def dia_bicgstab(diag, upper, lower, b, x0, offsets, tol=1e-6, rel_tol=0.0,
                 max_iter=1000) -> SolverResult:
    """Jacobi-preconditioned BiCGStab (PBiCGStab role)."""
    _check_dia("bicgstab", upper, lower, offsets, x0.shape[-1])
    return plain(linear.bicgstab, diag, upper, lower, b, x0, offsets, tol, rel_tol, max_iter)


def dia_smooth(diag, upper, lower, b, x0, offsets, tol=1e-6, rel_tol=0.0,
               max_iter=1000, omega=0.8, check_every=4) -> SolverResult:
    """Damped-Jacobi smoother (smoothSolver role); `max_iter` counts sweeps."""
    _check_dia("smooth", upper, lower, offsets, x0.shape[-1])
    return plain_smooth(diag, upper, lower, b, x0, offsets, tol, rel_tol, max_iter,
                        omega, check_every)
