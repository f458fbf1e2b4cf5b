"""Lattice geometric multigrid — the GAMG role for structured DIA meshes.

The PyTorch counterpart of firefoam_tpu/solvers/gmg.py. On a blockMesh
lattice the DIA offsets (1, nx, nx·ny) are the mesh structure, so

  * restriction and prolongation are pair sums and repeats along the
    lattice axes of a [nz, ny, nx] view: no gather, no scatter;
  * Galerkin coarsening of (diag, upper, lower) under piecewise-constant
    2× aggregation is strided slice-adds per axis, so the coarse operator
    stays DIA on the coarse lattice and the hierarchy is rebuilt from the
    current matrix values on every solve;
  * smoothing is Chebyshev-Jacobi: no inner products inside the V-cycle.

One V-cycle preconditions a CG with OpenFOAM's convergence semantics
(normFactor, tolerance/relTol), so logged iteration counts compare with the
other p_rgh solvers'.

Everything here is elementwise math on slices, a few small matmuls and
reductions over whole arrays: no sum adds into colliding indices, so a solve
is bitwise repeatable on the card. The CG loop reads its stop test on the
host once per iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .linear import SolverResult, _norm_factor, tol_floor

__all__ = ["LatticeMG", "gmg_pcg", "lattice_dims"]


def lattice_dims(offsets: Tuple[int, ...], n_cells: int) -> Optional[Tuple[int, int, int]]:
    """(nx, ny, nz) if the DIA offsets describe a full cuboid lattice with
    x fastest (offsets ⊆ (1, nx, nx*ny) and n_cells == nx*ny*nz), else
    None. 2-D lattices return nz == 1; 1-D return ny == nz == 1."""
    offs = tuple(int(o) for o in offsets)
    if not offs or offs[0] != 1:
        return None
    if len(offs) == 1:
        return (n_cells, 1, 1)
    nx = offs[1]
    if len(offs) == 2:
        if n_cells % nx:
            return None
        return (nx, n_cells // nx, 1)
    if len(offs) != 3 or offs[2] % nx:
        return None
    ny = offs[2] // nx
    if n_cells % (nx * ny):
        return None
    return (nx, ny, n_cells // (nx * ny))


# ---------------------------------------------------------------- shifts
def _shift_p(x, axis):
    """out[i] = x[i-1] along axis, zero-filled at the start."""
    n = x.shape[axis]
    return torch.cat([torch.zeros_like(x.narrow(axis, 0, 1)), x.narrow(axis, 0, n - 1)], dim=axis)


def _pad_even(a, axis, fill=0.0):
    if a.shape[axis] % 2 == 0:
        return a
    shape = list(a.shape)
    shape[axis] = 1
    return torch.cat([a, a.new_full(shape, fill)], dim=axis)


def _stride2(a, axis, start):
    return a[(slice(None),) * axis + (slice(start, None, 2),)]


def _even(a, axis):
    return _stride2(a, axis, 0)


def _odd(a, axis):
    return _stride2(a, axis, 1)


def _pair_sum(a, axis):
    return _even(a, axis) + _odd(a, axis)


def _matvec3(d, ux, uy, uz, lx, ly, lz, x):
    """DIA matvec on the 3-D lattice view (z, y, x axis order = 0, 1, 2).

    y_c = d_c x_c + sum_ax u_ax[c] x_{c+ax} + l_ax[c-ax] x_{c-ax}, the
    shifted products added onto slices of y (a zero-filled shift adds
    nothing at the end it fills)."""
    y = d * x
    for ax, u, l in ((2, ux, lx), (1, uy, ly), (0, uz, lz)):
        n = x.shape[ax] - 1
        if n < 1:
            continue
        lo, hi = x.narrow(ax, 0, n), x.narrow(ax, 1, n)
        y.narrow(ax, 0, n).addcmul_(u.narrow(ax, 0, n), hi)
        y.narrow(ax, 1, n).addcmul_(l.narrow(ax, 0, n), lo)
    return y


def _mv(mats, x):
    d, od = mats
    return _matvec3(d, od["u2"], od["u1"], od["u0"], od["l2"], od["l1"], od["l0"], x)


def _coarsen_axis(mats, axis):
    """Galerkin (piecewise-constant aggregation) coarsening of one axis by
    2: pairs (2I, 2I+1) merge. The intra-pair face (even slot) folds into
    the coarse diagonal; the inter-pair face (odd slot) becomes the coarse
    face; transverse faces pair-sum. Identity padding (diag 1, coupling 0)
    extends odd extents."""
    d, offd = mats
    d = _pad_even(d, axis, 1.0)
    offd = {k: _pad_even(v, axis) for k, v in offd.items()}
    u_ax, l_ax = offd["u%d" % axis], offd["l%d" % axis]
    dc = _pair_sum(d, axis) + _even(u_ax, axis) + _even(l_ax, axis)
    out = {"u%d" % axis: _odd(u_ax, axis), "l%d" % axis: _odd(l_ax, axis)}
    for a in range(3):
        if a == axis:
            continue
        out["u%d" % a] = _pair_sum(offd["u%d" % a], axis)
        out["l%d" % a] = _pair_sum(offd["l%d" % a], axis)
    return dc, out


def _restrict(r, axes):
    for ax in axes:
        r = _pair_sum(_pad_even(r, ax), ax)
    return r


def _prolong(e, axes, shape):
    for ax in axes:
        e = torch.repeat_interleave(e, 2, dim=ax)
    return e[tuple(slice(0, s) for s in shape)]


def _rowsum_off(offd):
    s = torch.zeros_like(offd["u0"])
    for a in range(3):
        s = s + torch.abs(offd["u%d" % a]) + _shift_p(torch.abs(offd["l%d" % a]), a)
    return s


def _inv_newton_schulz(A, iters: int = 30):
    """A^-1 for small SPD A via Newton-Schulz: X0 = Aᵀ/(‖A‖₁‖A‖∞)
    guarantees ‖I − X0·A‖ < 1 for SPD A and each step squares the error.
    Kept from the JAX package instead of torch.linalg.inv: the same 60
    matmuls give the same preconditioner (and so the same CG iteration
    counts), and no factorisation synchronises the card."""
    n = A.shape[0]
    norm1 = torch.max(torch.sum(torch.abs(A), dim=0))
    norminf = torch.max(torch.sum(torch.abs(A), dim=1))
    X = A.T / (norm1 * norminf)
    I2 = 2.0 * torch.eye(n, dtype=A.dtype, device=A.device)
    for _ in range(iters):
        X = X @ (I2 - A @ X)
    return X


class _Cheby:
    """Chebyshev-Jacobi smoother over [lmax*ratio, 1.1*lmax] (hypre-style
    three-term recurrence). No reductions inside: the eigenvalue bound is
    one Gershgorin max at prepare time, and the recurrence's scalars are
    0-d tensors computed there once."""

    def __init__(self, mats, lmax, degree=3, ratio=0.30):
        self.mats = mats
        self.lmax = lmax
        self.rD = 1.0 / mats[0]
        beta = 1.1 * lmax
        alpha = ratio * lmax
        self.theta = 0.5 * (beta + alpha)
        delta = 0.5 * (beta - alpha)
        sigma = self.theta / delta
        rho = 1.0 / sigma
        self.steps = []
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            self.steps.append((rho_new * rho, 2.0 * rho_new / delta))
            rho = rho_new

    def __call__(self, x, b):
        r = b - _mv(self.mats, x) if x is not None else b
        z = self.rD * r / self.theta
        x = z if x is None else x + z
        for c_z, c_r in self.steps:
            r = b - _mv(self.mats, x)
            z = c_z * z + c_r * (self.rD * r)
            x = x + z
        return x


@dataclass
class LatticeMG:
    """Static hierarchy plan: level shapes + active coarsening axes. The
    matrix-dependent pieces (coarse operators, eigenvalue bounds, dense
    coarsest inverse) are built per solve in prepare()."""

    dims: Tuple[int, int, int]  # (nx, ny, nz)
    shapes: List[Tuple[int, int, int]]  # (nz, ny, nx) 3-D view per level
    axes: List[Tuple[int, ...]]  # coarsened axes per level transition
    n_cells: int
    pre_degree: int = 2
    post_degree: int = 2
    cheby_ratio: float = 0.30
    n_coarsest_max: int = 512

    @classmethod
    def build(cls, offsets, n_cells, n_coarsest: int = 64,
              max_levels: int = 12) -> Optional["LatticeMG"]:
        dims = lattice_dims(offsets, n_cells)
        if dims is None:
            return None
        nx, ny, nz = dims
        shapes = [(nz, ny, nx)]
        axes: List[Tuple[int, ...]] = []
        cur = (nz, ny, nx)
        while cur[0] * cur[1] * cur[2] > n_coarsest and len(axes) < max_levels:
            act = tuple(a for a in range(3) if cur[a] > 2)
            if not act:
                break
            nxt = tuple((cur[a] + 1) // 2 if a in act else cur[a] for a in range(3))
            axes.append(act)
            shapes.append(nxt)
            cur = nxt
        if not axes:
            return None
        return cls(dims=dims, shapes=shapes, axes=axes, n_cells=n_cells,
                   n_coarsest_max=n_coarsest)

    # ------------------------------------------------------------- device
    def _to3(self, diag, upper, lower):
        """Flat DIA arrays -> per-axis 3-D coefficient views.

        upper/lower slot o*nC+c holds the face (c, c+off_o); offsets are
        sorted ascending, so slot 0 = x (+1), 1 = y (+nx), 2 = z (+nx*ny).
        Missing offsets (2-D / 1-D lattices) become zero couplings."""
        nz, ny, nx = self.shapes[0]
        K = upper.shape[0] // self.n_cells
        d3 = diag.reshape(nz, ny, nx)
        u = upper.reshape(K, nz, ny, nx)
        l = lower.reshape(K, nz, ny, nx)
        zero = torch.zeros_like(d3)
        offd = {"u0": zero, "u1": zero, "u2": zero, "l0": zero, "l1": zero, "l2": zero}
        # offset slot -> axis: x -> axis 2, y -> axis 1, z -> axis 0
        for s, ax in enumerate((2, 1, 0)[:K]):
            offd["u%d" % ax] = u[s]
            offd["l%d" % ax] = l[s]
        return d3, offd

    def prepare(self, diag, upper, lower):
        """Coarsen the current matrix through every level; returns the
        level matrices, the smoother chain and the dense coarsest inverse."""
        d3, offd = self._to3(diag, upper, lower)
        mats = [(d3, offd)]
        for act in self.axes:
            cur = mats[-1]
            for ax in act:
                cur = _coarsen_axis(cur, ax)
            mats.append(cur)
        smooths = []
        for d, od in mats:
            lam = torch.clamp(torch.max(_rowsum_off(od) / d) + 1.0, max=2.2)
            smooths.append(_Cheby((d, od), lam, self.pre_degree, self.cheby_ratio))
        # dense coarsest operator (tiny: <= n_coarsest_max cells), inverted
        # explicitly so that the coarsest apply is one small matmul per cycle
        dc, odc = mats[-1]
        sh = dc.shape
        n = sh[0] * sh[1] * sh[2]
        A = torch.diag(dc.reshape(-1))
        for ax, st in ((2, 1), (1, sh[2]), (0, sh[1] * sh[2])):
            if sh[ax] <= 1:
                continue
            A = A + torch.diag(odc["u%d" % ax].reshape(-1)[: n - st], st)
            A = A + torch.diag(odc["l%d" % ax].reshape(-1)[: n - st], -st)
        return mats, smooths, _inv_newton_schulz(A)

    def vcycle(self, mats, smooths, A_coarse, b3):
        """One V(pre, post) cycle approximating M^-1 b (zero initial
        guess), all levels in the 3-D lattice view."""

        def level(i, b_i):
            if i == len(mats) - 1:
                return (A_coarse @ b_i.reshape(-1)).reshape(b_i.shape)
            sm = smooths[i]
            x = sm(None, b_i)  # zero initial guess: the first residual is b
            r = b_i - _mv(mats[i], x)
            ec = level(i + 1, _restrict(r, self.axes[i]))
            x = x + _prolong(ec, self.axes[i], b_i.shape)
            return sm(x, b_i)

        return level(0, b3)


def gmg_pcg(mg: LatticeMG, diag, lower, upper, b, x0,
            tol=1e-6, rel_tol=0.0, max_iter=200) -> SolverResult:
    """CG preconditioned with one lattice-MG V-cycle per iteration, for one
    system ([nC] operands); OpenFOAM convergence semantics (normFactor,
    tol/relTol, the tolerance floored at 100·eps) identical to linear.pcg,
    so iteration counts are comparable."""
    mats, smooths, A_coarse = mg.prepare(diag, upper, lower)
    shape3 = mats[0][0].shape

    def matvec(x):
        return _mv(mats[0], x.reshape(shape3)).reshape(-1)

    Ax0, norm = _norm_factor(matvec, x0, b)
    r = b - Ax0
    res0 = torch.sum(torch.abs(r)) / norm
    stop = torch.clamp(rel_tol * res0, min=tol_floor(tol, x0.dtype))
    x, p, rz_old, res, it = x0, None, None, res0, 0
    while it < max_iter and bool(res > stop):
        z = mg.vcycle(mats, smooths, A_coarse, r.reshape(shape3)).reshape(-1)
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
