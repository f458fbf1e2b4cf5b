"""Explicit finite-volume operators (the fvc:: namespace).

Face-based gather/sum formulations of Gauss interpolate/grad/div/
laplacian/snGrad on the DIA layout, matching the scheme definitions the
solver equations consume.
"""

from __future__ import annotations

import torch

from .fields import SurfaceField, VolField
from .geometry import MeshGeometry

__all__ = [
    "interpolate",
    "interpolate_weighted",
    "sn_grad",
    "sn_grad_corrected",
    "non_orth_correction",
    "dot_sf",
    "grad",
    "grad_scalar",
    "div_flux",
    "div_flux_psi",
    "laplacian",
    "surface_sum",
    "flux",
    "reconstruct",
    "average_to_cells",
    "volume_integrate",
]


def _wmul(w, x):
    """Multiply face weights with (possibly vector) face-gathered values."""
    if x.ndim == 2:
        return w[:, None] * x
    return w * x


def _col(V, like):
    return V[:, None] if like.ndim == 2 else V


def interpolate(geom: MeshGeometry, f: VolField) -> SurfaceField:
    """Linear (central) interpolation to faces; boundary = patch values."""
    return interpolate_weighted(geom, f, geom.w)


def interpolate_weighted(geom: MeshGeometry, f: VolField, w: torch.Tensor) -> SurfaceField:
    """Interpolation with caller-supplied internal-face weights (schemes)."""
    xo = geom.gather_own(f.i)
    xn = geom.gather_nei(f.i)
    return SurfaceField(_wmul(w, xo) + _wmul(1.0 - w, xn), f.b)


def sn_grad(geom: MeshGeometry, f: VolField, b_grad: torch.Tensor = None) -> SurfaceField:
    """Surface-normal gradient (uncorrected). Boundary snGrad defaults to
    dc*(b_value - cell_value); pass b_grad to override."""
    gi = _wmul(geom.dc, geom.gather_nei(f.i) - geom.gather_own(f.i))
    if b_grad is None:
        b_grad = _wmul(geom.b_dc, f.b - geom.cell_to_boundary(f.i))
    return SurfaceField(gi, b_grad)


def non_orth_correction(
    geom: MeshGeometry,
    f: VolField,
    grad_i: torch.Tensor = None,
    limiter: float = None,
) -> torch.Tensor:
    """Explicit non-orthogonal snGrad correction on internal faces:
    corr_f = k_f·(∇ψ)_f with k = n̂ − Δ·nodc (correctedSnGrad::correction).

    limiter=None → full 'corrected'; limiter=α ∈ (0,1) → limitedSnGrad:
    corr clipped to α/(1−α)·|orthogonal part| per face.
    Scalar ψ → [nI]; vector ψ → [nI,3] (corr_j = Σ_d k_d·∂_d ψ_j)."""
    if grad_i is None:
        grad_i = grad(geom, f)
    k = geom.kvec()
    go = geom.gather_own(grad_i)
    gn = geom.gather_nei(grad_i)
    if grad_i.ndim == 3:  # vector field gradient [nC,3,3]
        gf = geom.w[:, None, None] * go + (1.0 - geom.w)[:, None, None] * gn
        corr = torch.einsum("fd,fdj->fj", k, gf)
    else:
        gf = geom.w[:, None] * go + (1.0 - geom.w)[:, None] * gn
        corr = torch.einsum("fd,fd->f", k, gf)
    if limiter is not None and limiter < 1.0:
        orth = _wmul(geom.nodc, geom.gather_nei(f.i) - geom.gather_own(f.i))
        lim = (limiter / (1.0 - limiter)) * torch.abs(orth)
        corr = torch.clamp(corr, -lim, lim)
    return corr


def sn_grad_corrected(
    geom: MeshGeometry,
    f: VolField,
    b_grad: torch.Tensor = None,
    grad_i: torch.Tensor = None,
    limiter: float = None,
) -> SurfaceField:
    """Corrected/limited surface-normal gradient: nodc·(ψ_N − ψ_P) +
    k·(∇ψ)_f (correctedSnGrad/limitedSnGrad). Boundary part as sn_grad
    (one-sided, uncorrected)."""
    gi = _wmul(geom.nodc, geom.gather_nei(f.i) - geom.gather_own(f.i))
    gi = gi + non_orth_correction(geom, f, grad_i, limiter)
    if b_grad is None:
        b_grad = _wmul(geom.b_dc, f.b - geom.cell_to_boundary(f.i))
    return SurfaceField(gi, b_grad)


def surface_sum(geom: MeshGeometry, sf: SurfaceField) -> torch.Tensor:
    """Σ_faces of signed (outward) face values per cell."""
    return geom.surface_sum(sf.i, sf.b)


def div_flux(geom: MeshGeometry, phi: SurfaceField) -> torch.Tensor:
    """fvc::div(phi): (1/V) Σ phi_f."""
    return surface_sum(geom, phi) / geom.V


def div_flux_psi(geom: MeshGeometry, phi: SurfaceField, psi_f: SurfaceField) -> torch.Tensor:
    """fvc::div(phi, psi) with face-interpolated psi_f: (1/V) Σ phi_f psi_f."""
    pi = _wmul(phi.i, psi_f.i)
    pb = _wmul(phi.b, psi_f.b)
    return surface_sum(geom, SurfaceField(pi, pb)) / _col(geom.V, pi)


def grad_scalar(geom: MeshGeometry, f: VolField) -> torch.Tensor:
    """Gauss linear gradient of a scalar: [nC,3]."""
    pf = interpolate(geom, f)
    num = surface_sum(
        geom, SurfaceField(geom.Sf * pf.i[:, None], geom.b_Sf * pf.b[:, None])
    )
    return num / geom.V[:, None]


def grad(geom: MeshGeometry, f: VolField) -> torch.Tensor:
    """Gauss linear gradient. Scalar → [nC,3]; vector → [nC,3,3] with
    grad[c,i,j] = d(u_j)/d(x_i) (OpenFOAM convention: rows = direction)."""
    if not f.is_vector:
        return grad_scalar(geom, f)
    pf = interpolate(geom, f)
    gi = (geom.Sf[:, :, None] * pf.i[:, None, :]).reshape(-1, 9)
    gb = (geom.b_Sf[:, :, None] * pf.b[:, None, :]).reshape(-1, 9)
    g = geom.surface_sum(gi, gb).reshape(-1, 3, 3)
    return g / geom.V[:, None, None]


def laplacian(
    geom: MeshGeometry,
    gamma: SurfaceField,
    f: VolField,
    b_grad: torch.Tensor = None,
) -> torch.Tensor:
    """fvc::laplacian(gamma, psi): (1/V) Σ gamma_f |Sf| snGrad_f."""
    sg = sn_grad(geom, f, b_grad)
    vi = _wmul(gamma.i * geom.magSf, sg.i)
    vb = _wmul(gamma.b * geom.b_magSf, sg.b)
    return surface_sum(geom, SurfaceField(vi, vb)) / _col(geom.V, vi)


def flux(geom: MeshGeometry, u: VolField) -> SurfaceField:
    """fvc::flux(U) = Sf · U_f (linear interpolation)."""
    uf = interpolate(geom, u)
    return SurfaceField(
        torch.sum(geom.Sf * uf.i, dim=1),
        torch.sum(geom.b_Sf * uf.b, dim=1),
    )


def dot_sf(geom: MeshGeometry, sf_vec: SurfaceField) -> SurfaceField:
    """Contract a vector surface field with Sf."""
    return SurfaceField(
        torch.einsum("fd,fd->f", geom.Sf, sf_vec.i),
        torch.einsum("fd,fd->f", geom.b_Sf, sf_vec.b),
    )


def reconstruct(geom: MeshGeometry, phi: SurfaceField) -> torch.Tensor:
    """fvc::reconstruct(faceFlux) → cell vector:
    inv(Σ Sf⊗Sf/|Sf|) & Σ (Sf/|Sf|)·phi_f, both sums unsigned over each
    cell's faces (Sf⊗Sf and Sf·phi are orientation-invariant)."""
    msf = torch.clamp(geom.magSf, min=torch.finfo(geom.magSf.dtype).tiny * 1e6)
    rhs = geom.cell_sum_unsigned(
        geom.Sf / msf[:, None] * phi.i[:, None],
        geom.b_Sf / geom.b_magSf[:, None] * phi.b[:, None],
    )
    return torch.einsum("cab,cb->ca", geom.recon_inv, rhs)


def average_to_cells(geom: MeshGeometry, sf: SurfaceField) -> torch.Tensor:
    """Area-weighted average of face values to cells (fvc::average)."""
    num = geom.cell_sum_unsigned(geom.magSf * sf.i, geom.b_magSf * sf.b)
    den = geom.cell_sum_unsigned(geom.magSf, geom.b_magSf)
    return num / den


def volume_integrate(geom: MeshGeometry, x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * _col(geom.V, x), dim=0)
