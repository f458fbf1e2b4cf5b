"""Agglomeration multigrid — the GAMG role on a general LDU mesh.

The PyTorch counterpart of firefoam_tpu/solvers/amg.py. The reference solves
p_rgh and the fvDOM intensities with GAMG (faceAreaPair agglomeration);
diagonal-PCG iteration counts grow about O(√n) with the mesh, and a
multigrid hierarchy keeps the pressure solve near mesh-independent.

  * HOST (numpy, once per mesh): pairwise face-weight agglomeration (merge
    each cell with its strongest-face neighbour) gives per-level static
    index maps: cell restriction, coarse-face merge maps, the coarsest
    level's dense pattern.
  * DEVICE (every solve): Galerkin coarsening of the current (diag, lower,
    upper) through the static maps, then a V-cycle of Chebyshev-Jacobi
    smoothing with a dense coarsest solve, as the preconditioner of a CG
    with OpenFOAM's normFactor/tolerance semantics.

The hierarchy depends only on topology and face areas, so it is built once
at solver setup. Every segment sum (faces into cells, cells into coarse
cells, faces into coarse faces) goes through a table the host sorted once:
row s lists the sources of segment s in source order, padded with a slot
that holds 0; the device gathers through the table and sums along its last
axis. No sum adds into colliding indices, so the sums are order-fixed and a
solve is bitwise repeatable on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..ops.geometry import SegSum
from .linear import SolverResult, _norm_factor, tol_floor

__all__ = ["AMGHierarchy", "amg_pcg"]


def _pair_agglomerate(own, nei, w, n_cells):
    """One level of pairwise agglomeration by descending face weight.
    Returns coarse-cell index per fine cell."""
    coarse = -np.ones(n_cells, np.int64)
    order = np.argsort(-w, kind="stable")
    next_id = 0
    for f in order:
        a, b = own[f], nei[f]
        if a == b:
            continue
        if coarse[a] < 0 and coarse[b] < 0:
            coarse[a] = coarse[b] = next_id
            next_id += 1
    # unmatched cells join the neighbour group with the strongest face
    best_w = np.full(n_cells, -1.0)
    best_g = -np.ones(n_cells, np.int64)
    for f in order:
        a, b = own[f], nei[f]
        if a == b:
            continue
        if coarse[a] < 0 and coarse[b] >= 0 and w[f] > best_w[a]:
            best_w[a] = w[f]
            best_g[a] = coarse[b]
        if coarse[b] < 0 and coarse[a] >= 0 and w[f] > best_w[b]:
            best_w[b] = w[f]
            best_g[b] = coarse[a]
    un = (coarse < 0) & (best_g >= 0)
    coarse[un] = best_g[un]
    # isolated cells get their own coarse cell
    iso = coarse < 0
    coarse[iso] = next_id + np.arange(int(iso.sum()))
    return coarse, next_id + int(iso.sum())


@dataclass
class _Level:
    restrict: torch.Tensor  # [n_fine] → coarse cell
    n_fine: int
    n_coarse: int
    # fine-face → coarse-face maps
    face_coarse: torch.Tensor  # [nFf] coarse-face slot (nFc = dump for diag)
    face_flip: torch.Tensor  # [nFf] 1.0 where orientation swapped
    face_diag: torch.Tensor  # [nFf] 1.0 where fine face collapsed into diag
    c_own: torch.Tensor  # [nFc]
    c_nei: torch.Tensor  # [nFc]
    n_cfaces: int
    # order-fixed segment sums
    sum_cells: SegSum = None  # fine cells → coarse cells
    sum_diag_faces: SegSum = None  # collapsed fine faces → coarse cell of their owner
    sum_faces: SegSum = None  # surviving fine faces → coarse faces


@dataclass
class _Graph:
    """One level's faces with their two face→cell sums."""

    own: torch.Tensor
    nei: torch.Tensor
    n: int
    to_own: SegSum
    to_nei: SegSum

    @classmethod
    def build(cls, own, nei, n, device):
        ix = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        return cls(ix(own), ix(nei), n, SegSum(own, n, device), SegSum(nei, n, device))


@dataclass
class AMGHierarchy:
    levels: List[_Level]
    graphs: List[_Graph]  # level 0 … coarsest
    n_cells0: int
    n_coarsest: int
    pre_sweeps: int = 2
    post_sweeps: int = 2
    damping: float = 0.7  # damped-Jacobi fallback (smoother="jacobi")
    # Chebyshev-Jacobi smoothing (the recurrence of solvers/gmg._Cheby) over
    # [ratio*lmax, 1.1*lmax] with a Gershgorin lmax per level: no dot
    # products inside the V-cycle
    smoother: str = "chebyshev"
    cheby_ratio: float = 0.30

    @property
    def own0(self):
        return self.graphs[0].own

    @property
    def nei0(self):
        return self.graphs[0].nei

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls, own: np.ndarray, nei: np.ndarray, w: np.ndarray, n_cells: int,
        n_coarsest: int = 32, max_levels: int = 20, device=None,
    ) -> "AMGHierarchy":
        """The hierarchy for the mesh (own, nei, face weights w), its index
        tensors on `device` (default: the CPU)."""
        device = torch.device(device if device is not None else "cpu")
        ix = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        own = np.asarray(own, np.int64)
        nei = np.asarray(nei, np.int64)
        w = np.asarray(w, np.float64)
        levels: List[_Level] = []
        graphs = [_Graph.build(own, nei, n_cells, device)]
        n = n_cells
        while n > n_coarsest and len(levels) < max_levels:
            coarse, nc = _pair_agglomerate(own, nei, w, n)
            if nc >= n:  # stalled
                break
            co, cn = coarse[own], coarse[nei]
            flip = co > cn
            a = np.where(flip, cn, co)
            b = np.where(flip, co, cn)
            diag = a == b
            key = a * nc + b
            # unique coarse faces (exclude collapsed) sorted by (own, nei)
            ukey, inv = np.unique(np.where(diag, -1, key), return_inverse=True)
            inv = inv.reshape(-1)
            has_diag = ukey[0] == -1
            n_cf = len(ukey) - int(has_diag)
            face_slot = inv - int(has_diag)  # −1 for diag faces
            c_own = (ukey[int(has_diag):] // nc).astype(np.int64)
            c_nei = (ukey[int(has_diag):] % nc).astype(np.int64)
            face_coarse = np.where(face_slot < 0, n_cf, face_slot)
            levels.append(
                _Level(
                    restrict=ix(coarse),
                    n_fine=n,
                    n_coarse=nc,
                    face_coarse=ix(face_coarse),
                    face_flip=torch.as_tensor(flip.astype(np.float64), device=device),
                    face_diag=torch.as_tensor(diag.astype(np.float64), device=device),
                    c_own=ix(c_own),
                    c_nei=ix(c_nei),
                    n_cfaces=n_cf,
                    sum_cells=SegSum(coarse, nc, device),
                    sum_diag_faces=SegSum(coarse[own], nc, device, keep=diag),
                    sum_faces=SegSum(face_coarse, n_cf, device),
                )
            )
            # coarse weights for the next agglomeration level: summed areas
            wc = np.zeros(n_cf + 1)
            np.add.at(wc, face_coarse, w)
            own, nei, w, n = c_own, c_nei, wc[:n_cf], nc
            graphs.append(_Graph.build(own, nei, n, device))
        return cls(levels=levels, graphs=graphs, n_cells0=n_cells, n_coarsest=n)

    # ------------------------------------------------------------------
    # device-side pieces
    # ------------------------------------------------------------------
    def _coarsen(self, lvl: _Level, diag, lower, upper):
        """Galerkin coarse coefficients from fine (diag, lower, upper)."""
        # face_diag and face_flip are host-built float64 masks: cast to the
        # system dtype so the coarse hierarchy does not promote f32 solves
        fd = lvl.face_diag.to(diag.dtype)
        # collapsed faces add their off-diagonals into the coarse diagonal
        diag_c = lvl.sum_cells(diag) + lvl.sum_diag_faces(fd * (lower + upper))
        flip = lvl.face_flip > 0
        lo = torch.where(flip, upper, lower) * (1.0 - fd)
        up = torch.where(flip, lower, upper) * (1.0 - fd)
        return diag_c, lvl.sum_faces(lo), lvl.sum_faces(up)

    def prepare(self, diag, lower, upper):
        """Per solve: coarsen the matrix through every level. Returns the
        per-level (diag, lower, upper, graph, lmax) list and the dense
        coarsest matrix (lmax = Gershgorin bound for the Chebyshev
        smoother)."""
        mats = []
        d, l, u = diag, lower, upper
        for lvl, gr in zip(self.levels, self.graphs):
            mats.append((d, l, u, gr, self._lmax(d, l, u, gr)))
            d, l, u = self._coarsen(lvl, d, l, u)
        gr = self.graphs[-1]
        mats.append((d, l, u, gr, self._lmax(d, l, u, gr)))
        # dense coarsest
        n = self.n_coarsest
        A = torch.diag(d[:n])
        A.index_put_((gr.own, gr.nei), u, accumulate=True)
        A.index_put_((gr.nei, gr.own), l, accumulate=True)
        return mats, A

    @staticmethod
    def _matvec(d, l, u, gr: _Graph, x):
        return d * x + gr.to_own(u * x[gr.nei]) + gr.to_nei(l * x[gr.own])

    def _lmax(self, d, l, u, gr: _Graph):
        """Gershgorin bound on lambda_max(D^-1 A): 1 + max rowsum|off|/d,
        clamped to [1, 2.2] like solvers/gmg (SPD M-matrix territory)."""
        s = gr.to_own(torch.abs(u)) + gr.to_nei(torch.abs(l))
        return torch.clamp(torch.max(s / d) + 1.0, max=2.2)

    def _cheby(self, d, l, u, gr, lmax, x, b, degree):
        """Chebyshev-Jacobi over [ratio*lmax, 1.1*lmax] (hypre three-term
        recurrence) — no reductions inside the V-cycle body."""
        rD = 1.0 / d
        beta = 1.1 * lmax
        alpha = self.cheby_ratio * lmax
        theta = 0.5 * (beta + alpha)
        delta = 0.5 * (beta - alpha)
        r = b - self._matvec(d, l, u, gr, x)
        sigma = theta / delta
        rho = 1.0 / sigma
        z = rD * r / theta
        x = x + z
        for _ in range(degree - 1):
            r = b - self._matvec(d, l, u, gr, x)
            rho_new = 1.0 / (2.0 * sigma - rho)
            z = rho_new * rho * z + (2.0 * rho_new / delta) * (rD * r)
            x = x + z
            rho = rho_new
        return x

    def _smooth(self, d, l, u, gr, x, b, sweeps):
        rD = self.damping / d
        for _ in range(sweeps):
            x = x + rD * (b - self._matvec(d, l, u, gr, x))
        return x

    @staticmethod
    def factor(A_coarse):
        """LU factors of the dense coarsest matrix (partial pivoting, the
        factorisation a dense solve runs; no error check reads the host)."""
        lu, piv, _ = torch.linalg.lu_factor_ex(A_coarse)
        return lu, piv

    def vcycle(self, mats, coarse, b):
        """One V(pre,post) cycle for M⁻¹·b (zero initial guess). `coarse`
        is the dense coarsest matrix or its `factor()`; a solver factors
        once per solve, which gives the dense solve's result to rounding."""
        lu, piv = self.factor(coarse) if torch.is_tensor(coarse) else coarse

        def sm(i, x, b_i, sweeps):
            d, l, u, gr, lmax = mats[i]
            if self.smoother == "chebyshev":
                return self._cheby(d, l, u, gr, lmax, x, b_i, sweeps)
            return self._smooth(d, l, u, gr, x, b_i, sweeps)

        def down(i, b_i):
            d, l, u, gr, _ = mats[i]
            x = sm(i, torch.zeros_like(b_i), b_i, self.pre_sweeps)
            if i == len(self.levels):
                return x
            r = b_i - self._matvec(d, l, u, gr, x)
            lvl = self.levels[i]
            b_c = lvl.sum_cells(r)
            if i + 1 == len(self.levels):
                e_c = torch.linalg.lu_solve(lu, piv, b_c[:, None])[:, 0]
            else:
                e_c = down(i + 1, b_c)
            x = x + e_c[lvl.restrict]
            return sm(i, x, b_i, self.post_sweeps)

        return down(0, b)


def amg_pcg(hier: AMGHierarchy, diag, lower, upper, b, x0,
            tol=1e-6, rel_tol=0.0, max_iter=200) -> SolverResult:
    """CG preconditioned with one AMG V-cycle per iteration, for one system
    ([nC] and [nF] operands on the hierarchy's device) — OpenFOAM
    convergence semantics (normFactor, tol/relTol, the tolerance floored at
    100·eps) like linear.pcg."""
    mats, A_coarse = hier.prepare(diag, lower, upper)
    coarse = hier.factor(A_coarse)
    d0, l0, u0, gr0, _ = mats[0]

    def matvec(x):
        return AMGHierarchy._matvec(d0, l0, u0, gr0, x)

    Ax0, norm = _norm_factor(matvec, x0, b)
    r = b - Ax0
    res0 = torch.sum(torch.abs(r)) / norm
    stop = torch.clamp(rel_tol * res0, min=tol_floor(tol, b.dtype))
    x, p, rz_old, res, it = x0, None, None, res0, 0
    while it < max_iter and bool(res > stop):
        z = hier.vcycle(mats, coarse, r)
        rz = torch.sum(r * z)
        p = z if it == 0 else z + (rz / rz_old) * p
        Ap = matvec(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        res = torch.sum(torch.abs(r)) / norm
        rz_old = rz
        it += 1
    return SolverResult(x, res0, res, torch.tensor(it, dtype=torch.int32, device=x0.device))
