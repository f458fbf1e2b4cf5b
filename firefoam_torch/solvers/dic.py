"""OpenFOAM-exact LDU solvers: DIC-preconditioned CG and symGaussSeidel.

The PyTorch counterpart of firefoam_tpu/solvers/dic.py. These exist beside
the Jacobi-preconditioned Krylov solvers for fidelity to the reference's
logs: its p_rgh solves (PCG + DIC, tolerance 1e-6, relTol 0.01) stop on
OpenFOAM's normalised residual, which leaves a smooth-mode pressure error
that acts on the flow; matching the reference means matching its Krylov
method, preconditioner, normalisation and stopping rule (lduMatrix PCG.C,
DICPreconditioner.C, symGaussSeidelSmoother.C, smoothSolver.C).

OpenFOAM's triangular sweeps are sequential over cells. Here they are
wavefront (hyperplane) scheduled: cells are grouped into topological levels
of the owner→neighbour DAG (own < nei for every internal face), faces by
the level of their dependent cell, and each level is applied as one
vectorised step. A box mesh has about nx+ny+nz levels.

Sums over the faces of a cell never add into colliding indices: the host
builds, per level, a table [cells of the level, faces per cell] (padded
with a face of coefficient 0), the device gathers through it and sums along
the table's last axis in face order, and writes each cell once. Every sum
here is therefore order-fixed, and a solve is bitwise repeatable on the
card. Vectors are [nC] or [B, nC]; coefficients [nF] or [B, nF] (a matrix
per row); each row of a batch stops at its own rule. The data-dependent
loops read their stop test on the host once per trip.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from .linear import SolverResult, _finish, _rows, _sel

__all__ = ["LduSchedule", "build_schedule", "dic_pcg", "sgs_solve", "real_coeffs"]

_SMALL = 1e-20  # SolverPerformance::small_


@dataclass
class _Level:
    cells: torch.Tensor  # [nL] the level's cells, ascending
    faces: Optional[torch.Tensor]  # [nL, deg] faces ending in each cell (pad: nF)
    src: Optional[torch.Tensor]  # [nL, deg] the cell at the other end (pad: 0)


@dataclass
class _Tables:
    """The schedule's index tables on one device."""

    perm: Optional[torch.Tensor]
    swap: Optional[torch.Tensor]
    fwd: List[_Level]  # faces by the level of their nei cell; src = own
    bwd: List[_Level]  # faces by the level of their own cell; src = nei
    own_all: _Level  # every cell with the faces it owns; src = nei
    nei_all: _Level  # every cell with the faces it neighbours; src = own


@dataclass
class LduSchedule:
    """Host-precomputed wavefront schedule for triangular sweeps (numpy),
    with its device index tables built at first use per device."""

    own: np.ndarray  # [nF] int32, own < nei (OpenFOAM upper-triangular order)
    nei: np.ndarray  # [nF] int32
    fwd_faces: Tuple[np.ndarray, ...]  # faces whose nei-cell is at level L≥1
    fwd_cells: Tuple[np.ndarray, ...]  # [0]: cells w/o incoming faces; [L]: level-L cells
    bwd_faces: Tuple[np.ndarray, ...]
    bwd_cells: Tuple[np.ndarray, ...]
    n_cells: int
    perm: Optional[np.ndarray] = None  # original face → storage slot (DIA layouts)
    swap: Optional[np.ndarray] = None  # faces whose stored own/nei were reversed
    _tables: dict = field(default_factory=dict, repr=False, compare=False)

    def tables(self, device) -> _Tables:
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = _build_tables(self, device)
        return self._tables[device]


def _ell(target, src, faces, cells, n_faces, device) -> _Level:
    """The table of `faces` by their target cell: row i lists, in face
    order, the faces f of `faces` with target[f] == cells[i]."""
    ix = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)
    if len(faces) == 0:
        return _Level(ix(cells), None, None)
    pos = np.searchsorted(cells, target[faces])
    order = np.argsort(pos, kind="stable")
    pos_s, f_s = pos[order], np.asarray(faces)[order]
    rank = np.arange(len(f_s)) - np.searchsorted(pos_s, pos_s, side="left")
    F = np.full((len(cells), int(rank.max()) + 1), n_faces, np.int64)
    F[pos_s, rank] = f_s
    return _Level(ix(cells), ix(F), ix(np.append(src, 0)[F]))


def _build_tables(sch: LduSchedule, device) -> _Tables:
    own, nei, nF = sch.own, sch.nei, len(sch.own)
    every_face, every_cell = np.arange(nF), np.arange(sch.n_cells)
    return _Tables(
        perm=None if sch.perm is None else torch.as_tensor(
            np.asarray(sch.perm, np.int64), device=device),
        swap=None if sch.swap is None else torch.as_tensor(sch.swap, device=device),
        fwd=[_ell(nei, own, f, c, nF, device) for f, c in zip(sch.fwd_faces, sch.fwd_cells)],
        bwd=[_ell(own, nei, f, c, nF, device) for f, c in zip(sch.bwd_faces, sch.bwd_cells)],
        own_all=_ell(own, nei, every_face, every_cell, nF, device),
        nei_all=_ell(nei, own, every_face, every_cell, nF, device),
    )


def real_coeffs(sch: LduSchedule, lower, upper):
    """Map storage-layout lower/upper to the schedule's normalized face
    order (perm gather + own<nei swap)."""
    t = sch.tables(upper.device)
    if t.perm is not None:
        lower, upper = lower[..., t.perm], upper[..., t.perm]
    if t.swap is not None and bool(sch.swap.any()):
        lower, upper = torch.where(t.swap, upper, lower), torch.where(t.swap, lower, upper)
    return lower, upper


def build_schedule(own, nei, n_cells: int, perm=None) -> LduSchedule:
    own = np.asarray(own, np.int32)
    nei = np.asarray(nei, np.int32)
    swap = own > nei
    if swap.any():
        own, nei = np.where(swap, nei, own), np.where(swap, own, nei)

    def levels(src, dst):
        lv = np.zeros(n_cells, np.int64)
        for _ in range(n_cells):
            new = lv.copy()
            np.maximum.at(new, dst, lv[src] + 1)
            if (new == lv).all():
                return lv
            lv = new
        return lv

    def group(src, dst):
        lv = levels(src, dst)
        lmax = int(lv.max()) if n_cells else 0
        faces, cells = [], []
        flv = lv[dst]
        for L in range(lmax + 1):
            cells.append(np.where(lv == L)[0].astype(np.int32))
            faces.append(np.where(flv == L)[0].astype(np.int32) if L > 0 else
                         np.zeros(0, np.int32))
        return tuple(faces), tuple(cells)

    fwd_faces, fwd_cells = group(own, nei)
    bwd_faces, bwd_cells = group(nei, own)
    return LduSchedule(
        own, nei, fwd_faces, fwd_cells, bwd_faces, bwd_cells, n_cells,
        None if perm is None else np.asarray(perm),
        swap if swap.any() else None,
    )


# ---------------------------------------------------------------- tables
def _by_level(levels: List[_Level], coef):
    """coef [..., nF] gathered through each level's face table:
    [..., nL, deg] per level (0 at pads), None where a level has no faces."""
    ext = torch.cat([coef, torch.zeros_like(coef[..., :1])], dim=-1)
    return [None if lv.faces is None else ext[..., lv.faces] for lv in levels]


def _face_sum(lv: _Level, coef_lv, x):
    """Σ over each cell's faces of coef·x[cell at the other end], in face
    order: [..., nL]."""
    return torch.sum(coef_lv * x[..., lv.src], dim=-1)


# ------------------------------------------------------------------- DIC
def _reciprocal_d(t: _Tables, diag, upper_fwd):
    rD = diag.clone()
    for lv, u in zip(t.fwd, upper_fwd):
        if u is None:
            continue
        rD.index_add_(-1, lv.cells, torch.sum(u * u / rD[..., lv.src], dim=-1), alpha=-1)
    return 1.0 / rD


def _calc_reciprocal_d(sch: LduSchedule, diag, upper):
    """DICPreconditioner::calcReciprocalD — level-scheduled."""
    t = sch.tables(diag.device)
    shape = torch.broadcast_shapes(diag.shape[:-1], upper.shape[:-1])
    return _reciprocal_d(t, diag.expand(shape + diag.shape[-1:]), _by_level(t.fwd, upper))


def _precondition(t: _Tables, rD_fwd, rD_bwd, upper_fwd, upper_bwd, rD, r):
    w = rD * r
    for lv, u, d in zip(t.fwd, upper_fwd, rD_fwd):
        if u is not None:
            w.index_add_(-1, lv.cells, d * _face_sum(lv, u, w), alpha=-1)
    for lv, u, d in zip(t.bwd, upper_bwd, rD_bwd):
        if u is not None:
            w.index_add_(-1, lv.cells, d * _face_sum(lv, u, w), alpha=-1)
    return w


def _dic_plan(t: _Tables, rD, upper):
    """What one solve's preconditioner applications share: the level-wise
    gathers of upper and of rD."""
    return (
        [rD[..., lv.cells] for lv in t.fwd], [rD[..., lv.cells] for lv in t.bwd],
        _by_level(t.fwd, upper), _by_level(t.bwd, upper),
    )


def _dic_precondition(sch: LduSchedule, rD, upper, r):
    """DICPreconditioner::precondition — forward then backward sweep."""
    t = sch.tables(r.device)
    return _precondition(t, *_dic_plan(t, rD, upper), rD, r)


def _norm_factor(matvec, x, b):
    """lduMatrix::solver::normFactor: gSum(|A·x − A·x̄| + |b − A·x̄|) + small."""
    xref = torch.mean(x, dim=-1, keepdim=True)
    Aref = matvec(xref.expand_as(x))
    Ax = matvec(x)
    return Ax, torch.sum(torch.abs(Ax - Aref) + torch.abs(b - Aref), dim=-1) + _SMALL


def dic_pcg(sch: LduSchedule, matvec, diag, upper, b, x0,
            tol=1e-6, rel_tol=0.0, max_iter=1000, lower=None) -> SolverResult:
    """lduMatrix PCG with the DIC preconditioner (PCG.C recurrences).
    `upper` may be in storage layout — it is mapped through the schedule's
    perm/swap (for symmetric systems lower==upper, so `lower` is optional).
    `matvec` maps [B, nC] → [B, nC]. No tolerance floor, as in the JAX
    package: this is the float64 fidelity path."""
    x0, b, diag, squeeze = _rows(x0, b, diag)
    t = sch.tables(x0.device)
    _, upper = real_coeffs(sch, upper if lower is None else lower, upper)
    diag_b = diag.expand(torch.broadcast_shapes(diag.shape[:-1], upper.shape[:-1])
                         + diag.shape[-1:])
    rD = _reciprocal_d(t, diag_b, _by_level(t.fwd, upper))
    plan = _dic_plan(t, rD, upper)
    Ax0, norm = _norm_factor(matvec, x0, b)
    r = b - Ax0
    res0 = torch.sum(torch.abs(r), dim=-1) / norm
    stop = torch.clamp(rel_tol * res0, min=tol)
    x = x0.clone()
    p = torch.zeros_like(x0)
    rz_old = torch.ones_like(res0)
    it = torch.zeros(res0.shape, dtype=torch.int32, device=x0.device)
    res = res0.clone()
    while True:
        active = (res > stop) & (it < max_iter)
        if not bool(active.any()):
            break
        z = _precondition(t, *plan, rD, r)
        rz = torch.sum(r * z, dim=-1)
        beta = torch.where(it == 0, torch.zeros_like(rz), rz / rz_old)
        p_n = z + beta[:, None] * p
        Ap = matvec(p_n)
        alpha = rz / torch.sum(p_n * Ap, dim=-1)
        x_n = x + alpha[:, None] * p_n
        r_n = r - alpha[:, None] * Ap
        res_n = torch.sum(torch.abs(r_n), dim=-1) / norm
        x, r, p = _sel(active, x_n, x), _sel(active, r_n, r), _sel(active, p_n, p)
        rz_old = _sel(active, rz, rz_old)
        res = _sel(active, res_n, res)
        it = it + active.to(it.dtype)
    return _finish(x, res0, res, it, squeeze)


# ------------------------------------------------------- symGaussSeidel
def _sgs_plan(t: _Tables, diag, lower, upper):
    """What one solve's sweeps share: per-level gathers of diag, lower (by
    nei cell) and upper (by own cell), and the all-cell tables' gathers."""
    return (
        [diag[..., lv.cells] for lv in t.fwd], [diag[..., lv.cells] for lv in t.bwd],
        _by_level(t.fwd, lower), _by_level(t.bwd, upper),
        _by_level([t.own_all], upper)[0], _by_level([t.nei_all], lower)[0],
    )


def _sweep(t: _Tables, plan, b, x):
    d_fwd, d_bwd, lo_fwd, up_bwd, up_all, lo_all = plan
    # forward: the upper-neighbour term uses pre-sweep values everywhere
    rhs = b - _face_sum(t.own_all, up_all, x) if up_all is not None else b
    x = x.clone()
    for lv, lo, d in zip(t.fwd, lo_fwd, d_fwd):
        if len(lv.cells) == 0:
            continue
        v = rhs[..., lv.cells]
        if lo is not None:
            v = v - _face_sum(lv, lo, x)
        x[..., lv.cells] = v / d
    # backward: the lower-neighbour term uses post-forward values everywhere
    rhs = b - _face_sum(t.nei_all, lo_all, x) if lo_all is not None else b
    x = x.clone()
    for lv, up, d in zip(t.bwd, up_bwd, d_bwd):
        if len(lv.cells) == 0:
            continue
        v = rhs[..., lv.cells]
        if up is not None:
            v = v - _face_sum(lv, up, x)
        x[..., lv.cells] = v / d
    return x


def _sgs_sweep(sch: LduSchedule, diag, lower, upper, b, x):
    """One symGaussSeidel sweep (forward + backward GS), level-scheduled.

    Forward GS (GaussSeidelSmoother.C bPrime propagation):
      x_new[c] = (b[c] − Σ_{f:nei=c} lower·x_new[own]
                       − Σ_{f:own=c} upper·x_old[nei]) / diag[c]
    then the mirrored backward pass using post-forward lower values.
    """
    t = sch.tables(x.device)
    return _sweep(t, _sgs_plan(t, diag, lower, upper), b, x)


def sgs_solve(sch: LduSchedule, matvec, diag, lower, upper, b, x0,
              tol=1e-6, rel_tol=0.0, max_iter=10, n_sweeps=1) -> SolverResult:
    """smoothSolver with symGaussSeidel (smoothSolver.C): smooth nSweeps,
    re-check the normalised residual, stop on tolerance/relTol/maxIter
    (the dictionary's own maxIter; `n_iterations` counts sweeps).
    lower/upper may be in storage layout (mapped via the schedule)."""
    x0, b, diag, squeeze = _rows(x0, b, diag)
    t = sch.tables(x0.device)
    lower, upper = real_coeffs(sch, lower, upper)
    plan = _sgs_plan(t, diag, lower, upper)
    Ax0, norm = _norm_factor(matvec, x0, b)
    res0 = torch.sum(torch.abs(b - Ax0), dim=-1) / norm
    stop = torch.clamp(rel_tol * res0, min=tol)
    x = x0.clone()
    it = torch.zeros(res0.shape, dtype=torch.int32, device=x0.device)
    res = res0.clone()
    while True:
        active = (res > stop) & (it < max_iter)
        if not bool(active.any()):
            break
        x_n = x
        for _ in range(n_sweeps):
            x_n = _sweep(t, plan, b, x_n)
        res_n = torch.sum(torch.abs(b - matvec(x_n)), dim=-1) / norm
        x = _sel(active, x_n, x)
        res = _sel(active, res_n, res)
        it = it + n_sweeps * active.to(it.dtype)
    return _finish(x, res0, res, it, squeeze)
