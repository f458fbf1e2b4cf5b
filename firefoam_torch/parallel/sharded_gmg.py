"""Sharded lattice multigrid — the GAMG role under partitioning.

The PyTorch port of firefoam_tpu/parallel/sharded_gmg.py. The reference's
production p_rgh solver is GAMG under MPI domain decomposition
(cases/steckler/system/fvSolution:63-71 + decomposePar): multigrid keeps
pressure iterations mesh-independent, where the flat diagonal-CG pays
O(sqrt n) iterations, each with its reductions.

Design (one rank per partition, parallel/comm.py):

  * the lattice is decomposed in contiguous Z-SLABS (x fastest, z
    outermost — each rank owns [nz_p, ny, nx]); coarsening only the x/y
    axes (semi-coarsening) makes every restriction/prolongation local:
    no communication in the grid-transfer hierarchy;
  * the only halo traffic is one (ny_l, nx_l) plane per z-neighbour per
    matvec — a ring ppermute pair; global-boundary wrap values are killed
    by the zero z-coupling coefficients at the lattice ends, so the ring
    needs no edge special-casing;
  * smoothing is Chebyshev-Jacobi (no reduction inside the V-cycle); the
    eigenvalue bound is one Gershgorin max + pmax at prepare time;
  * the coarsest x/y level keeps the full z extent; it is all-gathered
    (nz × ny_c × nx_c cells) and solved REDUNDANTLY on every rank by a
    dense Newton–Schulz inverse — the same bits on every rank, so no
    broadcast is needed.

The CG wrapper uses psum reductions with OpenFOAM normFactor semantics, so
its iteration counts compare with solvers.gmg.gmg_pcg's. The loop reads its
stop test on the host once per iteration: a psum'd residual, the same on
every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..solvers.gmg import _coarsen_axis, _inv_newton_schulz, _prolong, _restrict, _shift_p
from ..solvers.linear import SolverResult, tol_floor

__all__ = ["ShardedLatticeMG", "sharded_gmg_pcg"]


def _shift_m(x, axis):
    """out[i] = x[i+1] along axis, zero-filled at the end."""
    n = x.shape[axis]
    return torch.cat([x.narrow(axis, 1, n - 1), torch.zeros_like(x.narrow(axis, 0, 1))], dim=axis)


def _ring_perms(n: int):
    """(recv-from-next, recv-from-prev) ppermute schedules."""
    fwd = [(i, (i - 1) % n) for i in range(n)]  # i's data lands on i-1
    bwd = [(i, (i + 1) % n) for i in range(n)]
    return fwd, bwd


def _matvec3_slab(comm, d, offd, x):
    """DIA matvec on the local z-slab [nz_p, ny, nx]; x/y terms are local
    shifts, z terms exchange ONE plane with each ring neighbour."""
    ux, uy, uz = offd["u2"], offd["u1"], offd["u0"]
    lx, ly, lz = offd["l2"], offd["l1"], offd["l0"]
    y = d * x
    y = y + ux * _shift_m(x, 2) + _shift_p(lx * x, 2)
    y = y + uy * _shift_m(x, 1) + _shift_p(ly * x, 1)
    fwd, bwd = _ring_perms(comm.n_parts)
    # x_{k+1}: local planes 1.. plus the NEXT rank's first plane
    nxt0 = comm.ppermute(x[0], fwd)
    x_up = torch.cat([x[1:], nxt0[None]], dim=0)
    y = y + uz * x_up
    # (lz·x)_{k-1}: the previous rank's last plane enters plane 0
    lzx = lz * x
    prev_l = comm.ppermute(lzx[-1], bwd)
    y = y + torch.cat([prev_l[None], lzx[:-1]], dim=0)
    return y


def _rowsum_off_slab(comm, offd):
    s = torch.zeros_like(offd["u0"])
    for a in (1, 2):
        s = s + torch.abs(offd["u%d" % a]) + _shift_p(torch.abs(offd["l%d" % a]), a)
    s = s + torch.abs(offd["u0"])
    lz = torch.abs(offd["l0"])
    fwd, bwd = _ring_perms(comm.n_parts)
    prev_l = comm.ppermute(lz[-1], bwd)
    s = s + torch.cat([prev_l[None], lz[:-1]], dim=0)
    return s


class _ChebySlab:
    def __init__(self, comm, mats, lmax, degree=2, ratio=0.30):
        self.comm = comm
        self.mats = mats
        self.lmax = lmax
        self.degree = degree
        self.ratio = ratio

    def __call__(self, x, b):
        d, offd = self.mats
        rD = 1.0 / d
        beta = 1.1 * self.lmax
        alpha = self.ratio * self.lmax
        theta = 0.5 * (beta + alpha)
        delta = 0.5 * (beta - alpha)

        def mv(v):
            return _matvec3_slab(self.comm, d, offd, v)

        r = b - mv(x)
        sigma = theta / delta
        rho = 1.0 / sigma
        z = rD * r / theta
        x = x + z
        for _ in range(self.degree - 1):
            r = b - mv(x)
            rho_new = 1.0 / (2.0 * sigma - rho)
            z = rho_new * rho * z + (2.0 * rho_new / delta) * (rD * r)
            x = x + z
            rho = rho_new
        return x


@dataclass
class ShardedLatticeMG:
    """Static plan for the z-slab-sharded hierarchy. dims = (nx, ny, nz)
    GLOBAL; n_dev must divide nz. Coarsening acts on the x/y axes only
    (axes 2 and 1 of the [z, y, x] view) — z stays at full resolution so
    every transfer is local."""

    dims: Tuple[int, int, int]
    n_dev: int
    shapes: List[Tuple[int, int, int]]  # LOCAL (nz_p, ny_l, nx_l)
    axes: List[Tuple[int, ...]]
    pre_degree: int = 2
    cheby_ratio: float = 0.30

    @classmethod
    def build(cls, dims, n_dev, n_coarsest_xy: int = 16, max_levels: int = 12):
        nx, ny, nz = dims
        if nz % n_dev:
            return None
        nz_p = nz // n_dev
        shapes = [(nz_p, ny, nx)]
        axes: List[Tuple[int, ...]] = []
        cur = (nz_p, ny, nx)
        while cur[1] * cur[2] > n_coarsest_xy and len(axes) < max_levels:
            act = tuple(a for a in (1, 2) if cur[a] > 2)
            if not act:
                break
            nxt = (
                cur[0],
                (cur[1] + 1) // 2 if 1 in act else cur[1],
                (cur[2] + 1) // 2 if 2 in act else cur[2],
            )
            axes.append(act)
            shapes.append(nxt)
            cur = nxt
        if not axes:
            return None
        return cls(dims=tuple(dims), n_dev=n_dev, shapes=shapes, axes=axes)

    # ------------------------------------------------------- rank side
    def prepare(self, comm, d3, offd):
        """Coarsen the LOCAL slab through every level (local: only x/y
        axes coarsen) and build the redundant dense coarsest inverse."""
        mats = [(d3, offd)]
        for act in self.axes:
            cur = mats[-1]
            for ax in act:
                cur = _coarsen_axis(cur, ax)
            mats.append(cur)
        smooths = []
        for dl, od in mats:
            lam_loc = torch.max(_rowsum_off_slab(comm, od) / dl)
            lam = torch.clamp(comm.pmax(lam_loc) + 1.0, max=2.2)
            smooths.append(_ChebySlab(comm, (dl, od), lam, self.pre_degree, self.cheby_ratio))
        # redundant dense coarsest over the full z extent
        dc, odc = mats[-1]
        nz_p, nyc, nxc = dc.shape
        nzg = self.n_dev * nz_p

        def gat(a):
            return comm.all_gather(a).reshape(nzg, nyc, nxc)

        dg = gat(dc)
        og = {k: gat(v) for k, v in odc.items()}
        n = nzg * nyc * nxc
        A = torch.diag(dg.reshape(-1))
        idx = torch.arange(n, device=dg.device)
        for ax, st in ((2, 1), (1, nxc), (0, nyc * nxc)):
            if (nzg, nyc, nxc)[ax] <= 1:
                continue
            u = og["u%d" % ax].reshape(-1)
            l = og["l%d" % ax].reshape(-1)
            src = idx[: n - st]
            A[src, src + st] = A[src, src + st] + u[: n - st]
            A[src + st, src] = A[src + st, src] + l[: n - st]
        # matmul-only Newton–Schulz inverse (solvers/gmg.py) — computed
        # redundantly and bitwise-identically on every rank
        return mats, smooths, _inv_newton_schulz(A)

    def vcycle(self, comm, mats, smooths, A_inv, b3):
        def level(i, b_i):
            d, od = mats[i]
            sm = smooths[i]
            if i == len(mats) - 1:
                # gather → redundant dense solve → take the local slab
                nz_p, nyc, nxc = b_i.shape
                bg = comm.all_gather(b_i).reshape(-1)
                eg = (A_inv @ bg.to(A_inv.dtype)).to(b_i.dtype)
                return eg.reshape(self.n_dev, nz_p, nyc, nxc)[comm.rank]
            x = sm(torch.zeros_like(b_i), b_i)
            r = b_i - _matvec3_slab(comm, d, od, x)
            bc = _restrict(r, self.axes[i])
            ec = level(i + 1, bc)
            x = x + _prolong(ec, self.axes[i], b_i.shape)
            return sm(x, b_i)

        return level(0, b3)


def sharded_gmg_pcg(comm, mg: ShardedLatticeMG, d3, offd, b3, x03, tol=1e-6, rel_tol=0.0,
                    max_iter=200) -> SolverResult:
    """psum-CG preconditioned by the sharded V-cycle; OpenFOAM normFactor
    convergence semantics (all reductions global). All operands are this
    rank's z-slab [nz_p, ny, nx] views."""
    mats, smooths, A_inv = mg.prepare(comm, d3, offd)

    def gsum(v):
        return comm.psum(torch.sum(v))

    def gdot(a, b):
        return comm.psum(torch.sum(a * b))

    n_glob = mg.dims[0] * mg.dims[1] * mg.dims[2]

    def matvec(x):
        return _matvec3_slab(comm, d3, offd, x)

    xref = gsum(x03) / n_glob
    Aref = matvec(xref.expand_as(x03))
    Ax0 = matvec(x03)
    norm = gsum(torch.abs(Ax0 - Aref) + torch.abs(b3 - Aref)) + torch.finfo(x03.dtype).tiny * 1e6
    r = b3 - Ax0
    res0 = gsum(torch.abs(r)) / norm
    stop = torch.clamp(rel_tol * res0, min=tol_floor(tol, x03.dtype))
    x, p, rz_old, res, it = x03, torch.zeros_like(x03), None, res0, 0
    while it < max_iter and bool(res > stop):
        z = mg.vcycle(comm, mats, smooths, A_inv, r)
        rz = gdot(r, z)
        p = z if it == 0 else z + (rz / rz_old) * p
        Ap = matvec(p)
        alpha = rz / gdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        res = gsum(torch.abs(r)) / norm
        rz_old = rz
        it += 1
    return SolverResult(x, res0, res, torch.tensor(it, dtype=torch.int32, device=x03.device))


# ---------------------------------------------------------------------------
# rank functions for parallel.comm.launch (the tests)
# ---------------------------------------------------------------------------
def rank_slab_matvec(comm, ixs, ups, los, dg, x, dims):
    """_matvec3_slab of this rank's slab assembled from SEG-local face
    coefficients through the slab maps (ixs [P, 3, n_loc], ups/los
    [P, nF+1] with the appended zero); returns the local result."""
    nx, ny, nz = dims
    p = comm.rank
    nz_p = nz // comm.n_parts

    def t(a):
        return torch.as_tensor(np.asarray(a), device=comm.device)

    ix, ue, le = t(ixs[p]), t(ups[p]), t(los[p])
    offd = {}
    for a in (0, 1, 2):
        offd["u%d" % a] = ue[ix[a]].reshape(nz_p, ny, nx)
        offd["l%d" % a] = le[ix[a]].reshape(nz_p, ny, nx)
    d3 = t(dg).reshape(comm.n_parts, nz_p, ny, nx)[p]
    x3 = t(x).reshape(comm.n_parts, nz_p, ny, nx)[p]
    return _matvec3_slab(comm, d3, offd, x3).cpu().numpy()


def rank_gmg_solve(comm, dims, d, u, b, tol, max_iter):
    """sharded_gmg_pcg of the lattice system (d [nC], u [3, nC] symmetric
    couplings along x, y, z) on this rank's slab; returns (x_l, final
    residual, iterations, comm report)."""
    nx, ny, nz = dims
    P, p = comm.n_parts, comm.rank
    nz_p = nz // P
    mg = ShardedLatticeMG.build(dims, P, n_coarsest_xy=16)

    def sl(a):
        return torch.as_tensor(np.asarray(a).reshape(P, nz_p, ny, nx)[p], device=comm.device)

    offd = {"u2": sl(u[0]), "u1": sl(u[1]), "u0": sl(u[2]),
            "l2": sl(u[0]), "l1": sl(u[1]), "l0": sl(u[2])}
    res = sharded_gmg_pcg(comm, mg, sl(d), offd, sl(b), torch.zeros_like(sl(b)), tol=tol,
                          max_iter=max_iter)
    return (res.x.cpu().numpy(), float(res.final_residual), int(res.n_iterations), comm.report())
