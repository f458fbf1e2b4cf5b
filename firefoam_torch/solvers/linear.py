"""Krylov solvers for FvMatrix systems: the plain PyTorch twins.

The PyTorch counterparts of firefoam_tpu/solvers/linear.py, with OpenFOAM's
convergence semantics: normFactor Σ(|Ax − A·x̄| + |b − A·x̄|) + tiny·1e6,
the L1 residual over it, and a stopping tolerance floored at
100·eps(dtype) (`config.TOL_FLOOR_EPS`):

  * `pcg`           — Jacobi-preconditioned conjugate gradients;
  * `bicgstab`      — Jacobi-preconditioned BiCGStab with restart on
                      breakdown;
  * `jacobi_smooth` — damped Jacobi with residual checks every n_sweeps.

Each twin takes vectors of shape [nC] or [B, nC] (a leading batch axis)
and freezes every row at its own stop — the semantics of `jax.vmap` over
the JAX solvers — so `n_iterations` is per row. The data-dependent loop is
a Python loop that reads the stop test on the host each iteration. On a
DIA mesh the twins are the CPU path and the reference the CUDA kernels
(solvers/dia_krylov.py) are held against; on a SEG or hybrid mesh they are
the path on either device, as the JAX package's flat solvers are there.

`solve_scalar` routes an FvMatrix system to the OpenFOAM-exact solvers of
solvers/dic.py when the caller holds their schedule and the dictionary names
them, else to `solve_ldu`: on DIA to dia_krylov, which launches the
hand-written kernel for CUDA tensors and runs these twins for CPU ones; on
SEG to these twins with `ldu_matvec`'s product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TOL_FLOOR_EPS

__all__ = ["SolverResult", "solve_scalar", "solve_ldu", "ldu_matvec", "pcg", "bicgstab",
           "jacobi_smooth"]


class SolverResult(NamedTuple):
    x: torch.Tensor
    initial_residual: torch.Tensor
    final_residual: torch.Tensor
    n_iterations: torch.Tensor


def _nz(x):
    """Guard a denominator against exact zero, preserving sign."""
    tiny = torch.finfo(x.dtype).tiny * 1e6
    return torch.where(
        torch.abs(x) < tiny,
        torch.where(x >= 0, torch.full_like(x, tiny), torch.full_like(x, -tiny)),
        x,
    )


def tol_floor(tol: float, dtype) -> float:
    """Precision-aware stopping floor max(tol, k·eps(dtype))."""
    return max(float(tol), TOL_FLOOR_EPS * torch.finfo(dtype).eps)


def failed_rows(res: SolverResult, tol: float, rel_tol: float = 0.0) -> torch.Tensor:
    """The rows of a `bicgstab` result whose step was not finite: they
    return x0 and their initial residual, which lies above their stop (a
    row that starts converged lies at or below it)."""
    stop = torch.clamp(rel_tol * res.initial_residual, min=tol_floor(tol, res.x.dtype))
    return (res.final_residual == res.initial_residual) & (res.initial_residual > stop)


def _rows(x0, b, diag):
    """Promote [nC] operands to [1, nC]; returns (x0, b, diag, squeeze)."""
    squeeze = x0.ndim == 1 and b.ndim == 1
    x0 = x0 if x0.ndim == 2 else x0[None]
    b = b if b.ndim == 2 else b[None]
    B = max(x0.shape[0], b.shape[0])
    return x0.expand(B, -1), b.expand(B, -1), diag, squeeze


def _sum(v):
    return torch.sum(v, dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _mean(v):
    return torch.mean(v, dim=-1)


def _norm_factor(matvec, x, b, sum_fn=_sum, mean_fn=_mean):
    xref = mean_fn(x)[..., None]
    Aref = matvec(xref.expand_as(x))
    Ax = matvec(x)
    norm = sum_fn(torch.abs(Ax - Aref) + torch.abs(b - Aref))
    return Ax, norm + torch.finfo(x.dtype).tiny * 1e6


def _finish(x, res0, res, it, squeeze):
    if squeeze:
        return SolverResult(x[0], res0[0], res[0], it[0])
    return SolverResult(x, res0, res, it)


def _sel(active, new, old):
    """Row-wise select: rows still iterating take `new`, frozen rows keep
    `old` (the vmap-of-while_loop semantics)."""
    a = active if new.ndim == 1 else active[:, None]
    return torch.where(a, new, old)


def pcg(matvec, x0, b, diag, tol=1e-6, rel_tol=0.0, max_iter=1000,
        sum_fn=_sum, dot_fn=_dot, mean_fn=_mean) -> SolverResult:
    """Diagonal-preconditioned CG with OpenFOAM convergence semantics.
    `matvec` maps [B, nC] → [B, nC]. sum_fn/dot_fn/mean_fn reduce the last
    axis; they are the SPMD injection points (a partition passes
    psum-reduced ones, parallel/sharded.py), so the stop test each rank
    reads on the host is the same global residual on every rank."""
    x0, b, diag, squeeze = _rows(x0, b, diag)
    rD = 1.0 / diag
    Ax0, norm = _norm_factor(matvec, x0, b, sum_fn, mean_fn)
    r = b - Ax0
    res0 = sum_fn(torch.abs(r)) / norm
    stop = torch.clamp(rel_tol * res0, min=tol_floor(tol, x0.dtype))
    x = x0.clone()
    p = torch.zeros_like(x0)
    rz_old = torch.ones_like(res0)
    it = torch.zeros(res0.shape, dtype=torch.int32, device=x0.device)
    res = res0.clone()
    while True:
        active = (res > stop) & (it < max_iter)
        if not bool(active.any()):
            break
        z = rD * r
        rz = dot_fn(r, z)
        beta = torch.where(it == 0, torch.zeros_like(rz), rz / rz_old)
        p_n = z + beta[:, None] * p
        Ap = matvec(p_n)
        alpha = rz / dot_fn(p_n, Ap)
        x_n = x + alpha[:, None] * p_n
        r_n = r - alpha[:, None] * Ap
        res_n = sum_fn(torch.abs(r_n)) / norm
        x, r, p = _sel(active, x_n, x), _sel(active, r_n, r), _sel(active, p_n, p)
        rz_old = _sel(active, rz, rz_old)
        res = _sel(active, res_n, res)
        it = it + active.to(it.dtype)
    return _finish(x, res0, res, it, squeeze)


def bicgstab(matvec, x0, b, diag, tol=1e-6, rel_tol=0.0, max_iter=1000,
             sum_fn=_sum, dot_fn=_dot, mean_fn=_mean) -> SolverResult:
    """Jacobi-preconditioned BiCGStab (PBiCGStab role) for asymmetric
    systems, restarting with the current residual on breakdown.

    Breakdown is |rhat·r| < tiny·1e3·(r·r) (the JAX solver's test), and also
    any denominator that `_nz` would have to clamp: ρ_old or ω at the start
    of an iteration, or rhat·v after a step that did not restart — that step
    is dropped and retried as a restart, without counting it. Where the JAX
    solver divides by the clamped value instead, its α or β overflows and
    the solve returns NaN: on the 100k-cell box fire one fvDOM ray's shadow
    residual decays to rounding noise (rhat·r ≈ 1e-18·r·r) until rhat·v is
    exactly 0. A step whose α, ω, t·s or t·t is not finite fails its row:
    the row returns x0 and res0 with the steps it took. In float32 a ray of
    the 500k-cell box fire's first fvDOM sweep can grow its residual until
    t·t overflows; the JAX solver returns NaN there, and the row's last
    finite iterate is far from any solution. Away from those cases both
    take the same steps. The reducers are the
    SPMD injection points (see pcg)."""
    x0, b, diag, squeeze = _rows(x0, b, diag)
    rD = 1.0 / diag
    Ax0, norm = _norm_factor(matvec, x0, b, sum_fn, mean_fn)
    r = b - Ax0
    res0 = sum_fn(torch.abs(r)) / norm
    stop = torch.clamp(rel_tol * res0, min=tol_floor(tol, x0.dtype))
    small = torch.finfo(x0.dtype).tiny * 1e3
    tiny = torch.finfo(x0.dtype).tiny * 1e6
    x = x0.clone()
    rhat = r.clone()
    p = torch.zeros_like(x0)
    v = torch.zeros_like(x0)
    one = torch.ones_like(res0)
    rho_old, alpha, omega = one, one, one
    it = torch.zeros(res0.shape, dtype=torch.int32, device=x0.device)
    retry = torch.zeros(res0.shape, dtype=torch.bool, device=x0.device)
    failed = torch.zeros_like(retry)
    res = res0.clone()
    while True:
        active = (res > stop) & (it < max_iter) & ~failed
        if not bool(active.any()):
            break
        rho = dot_fn(rhat, r)
        rr = dot_fn(r, r)
        restart = ((torch.abs(rho) < small * rr) | (it == 0) | retry
                   | (torch.abs(rho_old) < tiny) | (torch.abs(omega) < tiny))
        rhat_n = torch.where(restart[:, None], r, rhat)
        rho = torch.where(restart, rr, rho)
        beta = torch.where(
            restart, torch.zeros_like(rho), (rho / _nz(rho_old)) * (alpha / _nz(omega))
        )
        p_n = r + beta[:, None] * (p - omega[:, None] * v)
        phat = rD * p_n
        v_n = matvec(phat)
        rv = dot_fn(rhat_n, v_n)
        retry = ~restart & (torch.abs(rv) < tiny)
        alpha_n = rho / _nz(rv)
        s = r - alpha_n[:, None] * v_n
        shat = rD * s
        t = matvec(shat)
        ts, tt = dot_fn(t, s), dot_fn(t, t)
        omega_n = ts / _nz(tt)
        x_n = x + alpha_n[:, None] * phat + omega_n[:, None] * shat
        r_n = s - omega_n[:, None] * t
        res_n = sum_fn(torch.abs(r_n)) / norm
        finite = (torch.isfinite(alpha_n) & torch.isfinite(omega_n) & torch.isfinite(ts)
                  & torch.isfinite(tt))
        failed = failed | (active & ~retry & ~finite)
        step = active & ~retry & finite
        x, r, rhat = _sel(step, x_n, x), _sel(step, r_n, r), _sel(step, rhat_n, rhat)
        p, v = _sel(step, p_n, p), _sel(step, v_n, v)
        rho_old = _sel(step, rho, rho_old)
        alpha, omega = _sel(step, alpha_n, alpha), _sel(step, omega_n, omega)
        res = _sel(step, res_n, res)
        it = it + step.to(it.dtype)
    x, res = _sel(failed, x0, x), _sel(failed, res0, res)
    return _finish(x, res0, res, it, squeeze)


def jacobi_smooth(matvec, x0, b, diag, tol=1e-6, rel_tol=0.0, max_iter=1000,
                  n_sweeps=4, damping=0.8, sum_fn=_sum, dot_fn=_dot,
                  mean_fn=_mean) -> SolverResult:
    """Damped-Jacobi smoothSolver: n_sweeps passes per convergence check,
    with a stagnation exit when a check fails to drop the residual by 1e-4
    relative. `n_iterations` counts sweeps. The reducers are the SPMD
    injection points (see pcg)."""
    x0, b, diag, squeeze = _rows(x0, b, diag)
    rD = damping / diag
    Ax0, norm = _norm_factor(matvec, x0, b, sum_fn, mean_fn)
    res0 = sum_fn(torch.abs(b - Ax0)) / norm
    stop = torch.clamp(rel_tol * res0, min=tol_floor(tol, x0.dtype))
    x = x0.clone()
    it = torch.zeros(res0.shape, dtype=torch.int32, device=x0.device)
    res = res0.clone()
    res_prev = torch.full_like(res0, float("inf"))
    while True:
        improving = res < res_prev * (1.0 - 1e-4)
        active = (res > stop) & (it < max_iter) & (improving | (it == 0))
        if not bool(active.any()):
            break
        x_n = x
        for _ in range(n_sweeps):
            x_n = x_n + rD * (b - matvec(x_n))
        res_n = sum_fn(torch.abs(b - matvec(x_n))) / norm
        x = _sel(active, x_n, x)
        res_prev = _sel(active, res, res_prev)
        res = _sel(active, res_n, res)
        it = it + active.to(it.dtype)
    return _finish(x, res0, res, it * n_sweeps, squeeze)


def ldu_matvec(g, diag, upper, lower):
    """x ↦ M·x for raw LDU coefficients on the layout of geometry g, for x
    [nC] or [B, nC]; upper/lower are shared [nI] or per row [B, nI]. DIA:
    the product of dia_krylov.dia_matvec (K0's plain version). hybrid:
    d·x + the geometry's `lane_product` (FvMatrix.matvec's product). SEG:
    d·x + Σ_owned upper·x[nei] + Σ_neighbouring lower·x[own] through the
    geometry's order-fixed tables, after the geometry's halo refresh of x
    (`sync`: the identity on the global geometry; a partition's Krylov
    iterates update only their owned cells, parallel/localize.py)."""
    if g.layout == "dia":
        from . import dia_krylov

        return lambda x: dia_krylov.dia_matvec(diag, upper, lower, g.offsets, x)
    if g.layout == "hybrid":
        off = g.lane_product(upper, lower)
        return lambda x: diag * x + off(x)
    own, nei = g.own, g.nei

    def mv(x):
        x = g.sync(x, dim=-1)
        return diag * x + g.seg_both.last(
            upper * x.index_select(-1, nei), lower * x.index_select(-1, own))

    return mv


def solve_ldu(g, solver: str, diag, upper, lower, b, x0, tol: float = 1e-6,
              rel_tol: float = 0.0, max_iter: int = 1000) -> SolverResult:
    """One Krylov solve of raw LDU coefficients (rows as in `ldu_matvec`)
    by the fvSolution `solver` name: PCG/GAMG → CG, smoothSolver → damped
    Jacobi with max(maxIter, 200) rounds of 4 sweeps, any other → BiCGStab.
    DIA: the whole-solve kernels of dia_krylov (K2, K3, K1 on the card; the
    twins on the CPU). SEG and hybrid: the twins with the layout's product
    on either device, as the JAX package runs its flat solvers there; no
    kernel is launched.
    The twins take the geometry's reducers (`solver_reducers`) and the
    solution its halo refresh (`sync`): both the identity's equivalent on
    the global geometry, psum-reduced and exchanged on a partition."""
    if g.layout == "dia":
        from . import dia_krylov

        if solver in ("PCG", "GAMG"):
            kern = dia_krylov.dia_pcg
        elif solver == "smoothSolver":
            # K3 counts sweeps: the same max(maxIter, 200) rounds of 4
            kern, max_iter = dia_krylov.dia_smooth, max(int(max_iter), 200) * 4
        else:
            kern = dia_krylov.dia_bicgstab
        return kern(diag, upper, lower, b, x0, g.offsets, tol=tol, rel_tol=rel_tol,
                    max_iter=max_iter)
    mv = ldu_matvec(g, diag, upper, lower)
    red = dict(zip(("sum_fn", "dot_fn", "mean_fn"), g.solver_reducers()))
    if solver in ("PCG", "GAMG"):
        res = pcg(mv, x0, b, diag, tol, rel_tol, max_iter, **red)
    elif solver == "smoothSolver":
        res = jacobi_smooth(mv, x0, b, diag, tol, rel_tol, max(int(max_iter), 200), **red)
    else:
        res = bicgstab(mv, x0, b, diag, tol, rel_tol, max_iter, **red)
    return res._replace(x=g.sync(res.x, dim=-1))


def solve_scalar(m, x0: torch.Tensor, solver: str = "PCG", tol: float = 1e-6,
                 rel_tol: float = 0.0, max_iter: int = 1000, component: int = None,
                 sched=None, preconditioner: str = None, smoother: str = None,
                 n_sweeps: int = 1) -> SolverResult:
    """Solve one scalar FvMatrix system (or one `component` of a vector
    system). With an LduSchedule, PCG+DIC and smoothSolver+*GaussSeidel run
    the OpenFOAM-exact wavefront solvers of solvers/dic.py, so that
    iteration counts and left-over error modes track the reference's.
    Otherwise PCG/GAMG, PBiCGStab/PBiCG and smoothSolver go to `solve_ldu`:
    the whole-solve kernels on a DIA mesh, the twins on SEG. "diagonal"
    divides the source by the diagonal (the rhoEqn solver)."""
    diag_t, b = m.totals()
    if component is not None:
        diag_t = (diag_t[:, component] if diag_t.ndim == 2 else diag_t).contiguous()
        b = b[:, component].contiguous()
    g = m.geom
    if solver == "diagonal":
        x = b / diag_t
        z = torch.zeros((), dtype=x.dtype, device=x.device)
        return SolverResult(x, z, z, torch.zeros((), dtype=torch.int32, device=x.device))
    if sched is not None:
        from .dic import dic_pcg, sgs_solve

        matvec = ldu_matvec(g, diag_t, m.upper, m.lower)
        if solver == "PCG" and preconditioner == "DIC":
            return dic_pcg(sched, matvec, diag_t, m.upper, b, x0, tol, rel_tol, max_iter)
        if solver == "smoothSolver" and (smoother or "").endswith("GaussSeidel"):
            return sgs_solve(sched, matvec, diag_t, m.lower, m.upper, b, x0,
                             tol, rel_tol, max_iter, n_sweeps)
    if solver in ("PCG", "GAMG", "PBiCGStab", "PBiCG", "smoothSolver"):
        return solve_ldu(g, solver, diag_t, m.upper, m.lower, b, x0, tol, rel_tol, max_iter)
    raise NotImplementedError(f"linear solver '{solver}'")
