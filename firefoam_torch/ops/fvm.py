"""Implicit finite-volume operators (the fvm:: namespace) and FvMatrix.

FvMatrix follows OpenFOAM's lduMatrix conventions so that assembled
systems (and therefore solutions) match the reference:
  * row own:  diag[own]·x[own] + upper[f]·x[nei]
  * row nei:  diag[nei]·x[nei] + lower[f]·x[own]
  * boundary: internal_coeffs[b] adds to diag of b_own at solve time;
              boundary_coeffs[b] adds to the rhs of b_own.
  * the solved system is  M x = source (+ boundary contributions).

Boundary conditions enter in canonical mixed form (refValue, refGrad,
valueFraction) → value/gradient coefficient pairs, mirroring
fvPatchField::valueInternalCoeffs / gradientInternalCoeffs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from ..config import small
from .fields import SurfaceField, VolField
from .geometry import MeshGeometry

__all__ = [
    "FvMatrix",
    "ddt",
    "ddt_scalar",
    "div",
    "laplacian",
    "Sp",
    "Su",
    "mixed_value_coeffs",
    "mixed_gradient_coeffs",
    "upwind_weights",
    "filtered_linear2_limiter",
    "limited_linear_weights",
    "limited_linear_limiter",
    "limiter_weights",
    "lust_div",
]


def _bcol(x, like):
    """Broadcast a [n] array against [n] or [n,3]."""
    if like.ndim == 2 and x.ndim == 1:
        return x[:, None]
    return x


@dataclass
class FvMatrix:
    geom: MeshGeometry
    diag: torch.Tensor  # [nC]
    lower: torch.Tensor  # [nI]
    upper: torch.Tensor  # [nI]
    source: torch.Tensor  # [nC(,3)]
    internal_coeffs: torch.Tensor  # [nB(,3)] → diag contribution of b_own
    boundary_coeffs: torch.Tensor  # [nB(,3)] → rhs contribution of b_own
    psi: VolField  # current solution (for H/flux)

    # ------------------------------------------------------------ algebra
    def __add__(self, o: "FvMatrix") -> "FvMatrix":
        return FvMatrix(
            self.geom,
            self.diag + o.diag,
            self.lower + o.lower,
            self.upper + o.upper,
            self.source + o.source,
            self.internal_coeffs + o.internal_coeffs,
            self.boundary_coeffs + o.boundary_coeffs,
            self.psi,
        )

    def __sub__(self, o: "FvMatrix") -> "FvMatrix":
        return self + o.__neg__()

    def __neg__(self) -> "FvMatrix":
        return FvMatrix(
            self.geom,
            -self.diag,
            -self.lower,
            -self.upper,
            -self.source,
            -self.internal_coeffs,
            -self.boundary_coeffs,
            self.psi,
        )

    def add_source(self, per_volume: torch.Tensor) -> "FvMatrix":
        """Add an explicit per-volume source (RHS of `==`): source += s*V."""
        V = self.geom.V
        return replace(self, source=self.source + _bcol(V, per_volume) * per_volume)

    def add_sp(self, sp: torch.Tensor) -> "FvMatrix":
        """Implicit source fvm::Sp: diag += sp·V (the caller minds the sign)."""
        return replace(self, diag=self.diag + sp * self.geom.V)

    # --------------------------------------------------------- solve pieces
    def diag_total(self) -> torch.Tensor:
        """diag including boundary internal coeffs (addBoundaryDiag)."""
        g = self.geom
        ic = self.internal_coeffs
        if ic.ndim == 2:
            return self.diag[:, None] + g.boundary_to_cell_sum(ic)
        return self.diag + g.boundary_to_cell_sum(ic)

    def rhs_total(self) -> torch.Tensor:
        """source including boundary coeffs (addBoundarySource)."""
        return self.source + self.geom.boundary_to_cell_sum(self.boundary_coeffs)

    def totals(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(diag_total, rhs_total) through one batched boundary scatter."""
        g = self.geom
        ic, bc = self.internal_coeffs, self.boundary_coeffs
        if ic.ndim == 2:
            d = ic.shape[1]
            both = g.boundary_to_cell_sum(torch.cat([ic, bc], dim=1))
            return self.diag[:, None] + both[:, :d], self.source + both[:, d:]
        both = g.boundary_to_cell_sum(torch.stack([ic, bc], dim=1))
        return self.diag + both[:, 0], self.source + both[:, 1]

    def matvec(self, x: torch.Tensor, diag_total: Optional[torch.Tensor] = None) -> torch.Tensor:
        """M·x for a scalar component (x: [nC]). On a partition the Krylov
        iterate's halo slots are stale (only owned slots are updated each
        iteration), so the matvec refreshes them first — the one halo
        exchange per matvec the reference performs through processor
        patches inside every solve. The identity on the global geometry."""
        x = self.geom.sync(x)
        d = self.diag if diag_total is None else diag_total
        return d * x + self._H_off(x)

    # ------------------------------------------------- OpenFOAM-style ops
    def A(self) -> torch.Tensor:
        """Central coefficient / V (fvMatrix::A); vector matrices average
        the component coefficients like OpenFOAM's cmptAv."""
        dt = self.diag_total()
        if dt.ndim == 2:
            dt = torch.mean(dt, dim=1)
        return dt / self.geom.V

    def H(self) -> torch.Tensor:
        """fvMatrix::H: (−offdiag·psi + source + boundary_coeffs)/V."""
        g = self.geom
        x = self.psi.i
        b = g.boundary_to_cell_sum(self.boundary_coeffs)
        if x.ndim == 2:
            off = torch.stack([self._H_off(x[:, c]) for c in range(x.shape[1])], dim=1)
        else:
            off = self._H_off(x)
        return (-off + self.source + b) / _bcol(g.V, x)

    def _H_off(self, x):
        """Off-diagonal apply Σ_f upper·x_N (to own) + lower·x_P (to nei);
        on hybrid lane by lane, then the rest tail (`lane_product`)."""
        g = self.geom
        if g.layout == "hybrid":
            return g.lane_product(self.upper, self.lower)(x)
        return g.face_to_both_sum(
            self.upper * g.gather_nei(x), self.lower * g.gather_own(x)
        )

    def flux(self) -> SurfaceField:
        """fvMatrix::flux: internal upper·x_nei − lower·x_own per face, plus
        boundary internal_coeffs·x_own − boundary_coeffs (scalar psi only)."""
        g = self.geom
        x = self.psi.i
        fi = self.upper * g.gather_nei(x) - self.lower * g.gather_own(x)
        fb = self.internal_coeffs * g.cell_to_boundary(x) - self.boundary_coeffs
        return SurfaceField(fi, fb)

    def relax(self, alpha: float) -> "FvMatrix":
        """fvMatrix::relax: enforce diagonal dominance (including the
        boundary diagonal contribution) and under-relax. The source picks up
        (D_new − D_old)·psi so the converged solution is unchanged."""
        g = self.geom
        s = g.face_to_both_sum(torch.abs(self.upper), torch.abs(self.lower))
        ic = self.internal_coeffs
        ics = ic if ic.ndim == 1 else torch.mean(ic, dim=1)
        bdiag = g.boundary_to_cell_sum(ics)
        d0 = self.diag + bdiag
        d = torch.maximum(torch.abs(d0), s) / alpha
        src = self.source + _bcol(d - d0, self.source) * self.psi.i
        return replace(self, diag=d - bdiag, source=src)

    def residual_norm(self, x: torch.Tensor) -> torch.Tensor:
        """OpenFOAM-normalised initial residual for a scalar component."""
        dt = self.diag_total()
        b = self.rhs_total()
        Ax = self.matvec(x, dt)
        Aref = self.matvec(torch.mean(x).expand_as(x), dt)
        norm = torch.sum(torch.abs(Ax - Aref) + torch.abs(b - Aref)) + torch.finfo(x.dtype).tiny * 1e6
        return torch.sum(torch.abs(b - Ax)) / norm


def empty_matrix(geom: MeshGeometry, psi: VolField) -> FvMatrix:
    kw = dict(dtype=psi.i.dtype, device=psi.i.device)
    return FvMatrix(
        geom,
        torch.zeros((geom.n_cells,), **kw),
        torch.zeros((geom.n_internal,), **kw),
        torch.zeros((geom.n_internal,), **kw),
        torch.zeros(psi.i.shape, **kw),
        torch.zeros(psi.b.shape, **kw),
        torch.zeros(psi.b.shape, **kw),
        psi,
    )


# ---------------------------------------------------------------------------
# boundary coefficient helpers (canonical mixed form)
# ---------------------------------------------------------------------------

def mixed_value_coeffs(ref_v, ref_g, f, b_dc):
    """face value = vic·x_own + vbc   (fvPatchField::valueInternalCoeffs)."""
    b_dc = _bcol(b_dc, ref_v)
    vic = 1.0 - f
    vbc = f * ref_v + (1.0 - f) * ref_g / b_dc
    return vic, vbc


def mixed_gradient_coeffs(ref_v, ref_g, f, b_dc):
    """snGrad = gic·x_own + gbc   (fvPatchField::gradientInternalCoeffs)."""
    b_dc = _bcol(b_dc, ref_v)
    gic = -f * b_dc
    gbc = f * b_dc * ref_v + (1.0 - f) * ref_g
    return gic, gbc


# ---------------------------------------------------------------------------
# interpolation scheme weights (internal faces)
# ---------------------------------------------------------------------------

def upwind_weights(geom: MeshGeometry, phi_i: torch.Tensor) -> torch.Tensor:
    return (phi_i >= 0.0).to(phi_i.dtype)


def limited_linear_limiter(
    geom: MeshGeometry, phi_i: torch.Tensor, psi: VolField, k: float = 1.0,
    bound01: bool = False,
) -> torch.Tensor:
    """limitedLinear k limiter field (and the Limited01 wrapper used by
    limitedLinear01), matching OpenFOAM:

      NVDTVD::r — gradf = ψ_N − ψ_P; gradcf = d·∇ψ_upwind;
        r = |gradcf| ≥ 1000|gradf| ? 2000·sign(gradcf)·sign(gradf) − 1
                                   : 2·gradcf/gradf − 1
      limitedLinearLimiter — λ = clip(2/k · r, 0, 1)
      Limited01 — λ = 0 (upwind) wherever ψ_P or ψ_N is outside [0, 1].
    """
    from . import fvc

    g = fvc.grad_scalar(geom, psi)
    d = geom.d_face
    psi_o, psi_n = geom.gather_own(psi.i), geom.gather_nei(psi.i)
    g_o, g_n = geom.gather_own(g), geom.gather_nei(g)
    gradf = psi_n - psi_o
    gradcf = torch.where(
        phi_i >= 0, torch.sum(d * g_o, dim=1), torch.sum(d * g_n, dim=1)
    )
    big = torch.abs(gradcf) >= 1000.0 * torch.abs(gradf)
    safe = torch.where(gradf == 0.0, torch.ones_like(gradf), gradf)
    r = torch.where(
        big,
        2.0 * 1000.0 * torch.sign(gradcf) * torch.sign(gradf) - 1.0,
        2.0 * gradcf / safe - 1.0,
    )
    lim = torch.clamp(2.0 / k * r, 0.0, 1.0)
    if bound01:
        out = (torch.maximum(psi_o, psi_n) > 1.0) | (torch.minimum(psi_o, psi_n) < 0.0)
        lim = torch.where(out, torch.zeros_like(lim), lim)
    return lim


def limiter_weights(geom: MeshGeometry, phi_i: torch.Tensor, lim: torch.Tensor) -> torch.Tensor:
    """Blend linear/upwind weights from a limiter field:
    w = λ·w_linear + (1−λ)·w_upwind."""
    wu = upwind_weights(geom, phi_i)
    return lim * geom.w + (1.0 - lim) * wu


def limited_linear_weights(
    geom: MeshGeometry, phi_i: torch.Tensor, psi: VolField, k: float = 1.0,
    bound01: bool = False,
) -> torch.Tensor:
    """limitedLinear k (and limitedLinear01): limiter-blended weights."""
    return limiter_weights(geom, phi_i, limited_linear_limiter(geom, phi_i, psi, k, bound01))


def filtered_linear2_limiter(
    geom: MeshGeometry,
    psi: VolField,
    grad_psi: Optional[torch.Tensor] = None,
    k: float = 1.0,
    l: float = 0.0,
) -> torch.Tensor:
    """filteredLinear2 / filteredLinear2V limiter (fvSchemes
    `Gauss filteredLinear2V k l`, the pyrolysis1D and wallFireSpread2D
    reference cases' div(phi,U)): damps high-frequency "staggering" modes by
    comparing the face difference with both neighbouring cell gradients:

      df = ψ_N − ψ_P          (V variant: |Δψ|², projections along Δψ)
      dP = d·(∇ψ)_P,  dN = d·(∇ψ)_N
      λ  = clip((l+1) − k·max(|df−dP|, |df−dN|)/(|df| + SMALL), 0, 1)

    The JAX package's reconstruction from the published scheme, copied
    operation for operation."""
    from . import fvc

    if grad_psi is None:
        grad_psi = fvc.grad(geom, psi) if psi.i.ndim == 2 else fvc.grad_scalar(geom, psi)
    d = geom.d_face
    psi_o, psi_n = geom.gather_own(psi.i), geom.gather_nei(psi.i)
    g_o, g_n = geom.gather_own(grad_psi), geom.gather_nei(grad_psi)
    if psi.i.ndim == 2:  # filteredLinear2V: along the face difference
        dfV = psi_n - psi_o
        df = torch.einsum("fi,fi->f", dfV, dfV)
        dP = torch.einsum("fi,fi->f", dfV, torch.einsum("fi,fij->fj", d, g_o))
        dN = torch.einsum("fi,fi->f", dfV, torch.einsum("fi,fij->fj", d, g_n))
    else:
        df = psi_n - psi_o
        dP = torch.einsum("fd,fd->f", d, g_o)
        dN = torch.einsum("fd,fd->f", d, g_n)
    ratio = torch.maximum(torch.abs(df - dP), torch.abs(df - dN)) / (
        torch.abs(df) + small(psi.i.dtype)
    )
    return torch.clamp((l + 1.0) - k * ratio, 0.0, 1.0)


def lust_div(
    geom: MeshGeometry,
    phi,
    psi: VolField,
    vic,
    vbc,
    grad_psi: torch.Tensor,
) -> "FvMatrix":
    """fvm::div with the LUST scheme (div(phi,U) Gauss LUST grad(U)):
    0.75·linear + 0.25·linearUpwind. The upwind fraction's gradient
    reconstruction enters as an explicit deferred correction
    0.25·φ·(∇ψ)_up·(Cf − C_up)."""
    wu = upwind_weights(geom, phi.i)
    w = 0.75 * geom.w + 0.25 * wu
    up_own = phi.i >= 0
    C_up = torch.where(up_own[:, None], geom.C_own_f, geom.C_nei_f)
    d = geom.Cf - C_up
    g_o, g_n = geom.gather_own(grad_psi), geom.gather_nei(grad_psi)
    if psi.i.ndim == 2:
        g_up = torch.where(up_own[:, None, None], g_o, g_n)
        corr_i = 0.25 * torch.einsum("fi,fij->fj", d, g_up)
    else:
        g_up = torch.where(up_own[:, None], g_o, g_n)
        corr_i = 0.25 * torch.sum(d * g_up, dim=1)
    corr_b = torch.zeros_like(psi.b)
    return div(geom, phi, psi, w, vic, vbc, correction=SurfaceField(corr_i, corr_b))


# ---------------------------------------------------------------------------
# implicit operators
# ---------------------------------------------------------------------------

def ddt(geom: MeshGeometry, rho, psi: VolField, psi_old_i, rho_old, dt) -> FvMatrix:
    """fvm::ddt(rho, psi) (Euler): diag += rho·V/dt; source += rho_old·V/dt·psi_old."""
    m = empty_matrix(geom, psi)
    rdt = 1.0 / dt
    diag = geom.V * rdt * rho
    src = _bcol(geom.V * rdt * rho_old, m.source) * psi_old_i
    return replace(m, diag=diag, source=src)


def ddt_scalar(geom: MeshGeometry, psi: VolField, psi_old_i, dt) -> FvMatrix:
    """fvm::ddt(psi) (Euler, no density)."""
    one = torch.ones((), dtype=psi.i.dtype, device=psi.i.device)
    return ddt(geom, one, psi, psi_old_i, one, dt)


def div(
    geom: MeshGeometry,
    phi: SurfaceField,
    psi: VolField,
    weights: torch.Tensor,
    vic: torch.Tensor,
    vbc: torch.Tensor,
    correction: Optional[SurfaceField] = None,
) -> FvMatrix:
    """fvm::div(phi, psi) (Gauss) with given internal-face weights and
    boundary value coefficients (gaussConvectionScheme::fvmDiv):
      lower = −w·phi ; upper = lower + phi ; negSumDiag.
    `correction` (face values) adds an explicit deferred-correction flux."""
    m = empty_matrix(geom, psi)
    lower = -weights * phi.i
    upper = lower + phi.i
    diag = -geom.face_to_both_sum(lower, upper)
    ic = _bcol(phi.b, vic) * vic
    bc = -_bcol(phi.b, vbc) * vbc
    m = replace(m, lower=lower, upper=upper, diag=diag, internal_coeffs=ic, boundary_coeffs=bc)
    if correction is not None:
        corr = geom.surface_sum(
            _bcol(phi.i, correction.i) * correction.i, torch.zeros_like(correction.b)
        )
        m = replace(m, source=m.source - corr)
    return m


def laplacian(
    geom: MeshGeometry,
    gamma: SurfaceField,
    psi: VolField,
    gic: torch.Tensor,
    gbc: torch.Tensor,
    corr: torch.Tensor = None,
) -> FvMatrix:
    """fvm::laplacian(gamma, psi), Gauss:
      upper = lower = gamma_f·|Sf|·deltaCoeff ; negSumDiag;
      internalCoeffs = gamma_b·|Sf|·gic ; boundaryCoeffs = −gamma_b·|Sf|·gbc.

    corr (from fvc.non_orth_correction) selects the corrected/limited
    scheme: the implicit part takes the stabilised nonOrthDeltaCoeffs and the
    deferred face-flux correction Γ_f|Sf|·k·(∇ψ)_f enters the source.
    corr=None is 'Gauss <interp> uncorrected'."""
    m = empty_matrix(geom, psi)
    gmsf = gamma.i * geom.magSf * (geom.dc if corr is None else geom.nodc)
    diag = -geom.face_to_both_sum(gmsf, gmsf)
    gb = gamma.b * geom.b_magSf
    ic = _bcol(gb, gic) * gic
    bc = -_bcol(gb, gbc) * gbc
    m = replace(
        m, lower=gmsf, upper=gmsf, diag=diag, internal_coeffs=ic, boundary_coeffs=bc
    )
    if corr is not None:
        flux_i = _bcol(gamma.i * geom.magSf, corr) * corr
        zero_b = torch.zeros((geom.n_boundary,) + tuple(corr.shape[1:]), dtype=corr.dtype,
                             device=corr.device)
        m = replace(m, source=m.source - geom.surface_sum(flux_i, zero_b))
    return m


def Sp(geom: MeshGeometry, sp, psi: VolField) -> FvMatrix:
    """fvm::Sp(sp, psi): diag += sp·V (implicit source)."""
    m = empty_matrix(geom, psi)
    if not torch.is_tensor(sp) or sp.ndim == 0:
        sp = torch.full((geom.n_cells,), float(sp), dtype=psi.i.dtype, device=psi.i.device)
    return replace(m, diag=sp * geom.V)


def Su(geom: MeshGeometry, su: torch.Tensor, psi: VolField) -> FvMatrix:
    """Explicit source: source += su·V (`==` convention at the call site)."""
    m = empty_matrix(geom, psi)
    return replace(m, source=_bcol(geom.V, m.source) * su)
