"""viewFactor and opaqueSolid radiation models.

Reference: packages/thermophysicalModels/radiation/radiationModels/
{viewFactor,opaqueSolid}. viewFactor treats the medium as transparent and
exchanges radiation between boundary faces through a view-factor matrix
(the reference reads the one the viewFactorsGen utility writes);
opaqueSolid takes part in no transport and only carries the solid's
absorptivity/emissivity for region coupling (opaqueSolid.C:96-120).

The F matrix is assembled on the host once (it depends on the mesh only)
from the point-to-point form F_ij = cosθ_i cosθ_j A_j/(π r²), with
visibility by orientation only, then scaled toward closure and reciprocity
(50 Sinkhorn passes), as the JAX package builds it. The host arrays grow as
nSel² for nSel wall faces. The grey radiosity solve
    J = εσT⁴ + (1−ε)·F·J
runs 30 fixed-point sweeps of a dense matrix product; qr = ε(σT⁴ − F·J).
The per-face results go back to the boundary through distinct-index
writes."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..io.foamdict import FoamDict
from .fvdom import SIGMA

__all__ = ["ViewFactorRadiation", "OpaqueSolid"]

N_SWEEPS = 30  # radiosity fixed-point sweeps
N_SINKHORN = 50  # closure/reciprocity scaling passes of the F build


def view_factors(C: np.ndarray, Sf: np.ndarray, A: np.ndarray) -> np.ndarray:
    """Row-normalised, reciprocal view factors between faces with centres
    C [n, 3], outward area vectors Sf [n, 3] and areas A [n] (float64)."""
    n = Sf / A[:, None]
    r = C[None, :, :] - C[:, None, :]  # i -> j
    d2 = np.einsum("ijk,ijk->ij", r, r)
    d = np.sqrt(np.maximum(d2, 1e-30))
    # boundary normals point OUT of the domain; surfaces radiate into the
    # cavity along −n: cosθ_i = (−n_i)·r̂ and cosθ_j = (−n_j)·(−r̂)
    cos_i = -np.einsum("ijk,ik->ij", r, n) / d
    cos_j = np.einsum("ijk,jk->ij", r, n) / d
    vis = (cos_i > 0) & (cos_j > 0)
    F = np.where(vis, cos_i * cos_j * A[None, :] / (np.pi * d2 + 1e-30), 0.0)
    np.fill_diagonal(F, 0.0)
    # closure (row sums 1) AND reciprocity A_i·F_ij = A_j·F_ji: Sinkhorn-style
    # scaling of M = A_i·F_ij toward a symmetric matrix with row sums A_i
    M = A[:, None] * F
    for _ in range(N_SINKHORN):
        rs = M.sum(1, keepdims=True)
        M = np.where(rs > 1e-14, M * (A[:, None] / np.maximum(rs, 1e-14)), 0.0)
        M = 0.5 * (M + M.T)
    return M / A[:, None]


@dataclass
class ViewFactorRadiation:
    geom: object
    solver_freq: int
    emissivity: torch.Tensor  # [nSel] per selected boundary face
    F: torch.Tensor  # [nSel, nSel] view factors (row-normalised)
    sel: torch.Tensor  # [nSel] boundary-face indices taking part
    n_rays = 0
    n_bands = 1

    @classmethod
    def from_case_dict(cls, rp: FoamDict, geom, case) -> "ViewFactorRadiation":
        vfc = rp.get_dict("viewFactorCoeffs", FoamDict())
        # the faces taking part: every wall-type patch (the reference's
        # viewFactorWall patch group)
        sel = []
        for p in geom.patches:
            if "wall" in (p.ptype or "").lower():
                sel.extend(range(p.slice.start, p.slice.stop))
        sel = np.asarray(sel, np.int64)
        host = lambda t: t.detach().cpu().numpy().astype(np.float64)[sel]
        F = view_factors(host(geom.b_Cf), host(geom.b_Sf), host(geom.b_magSf))
        kw = dict(dtype=geom.dtype, device=geom.device)
        return cls(
            geom=geom,
            solver_freq=max(rp.get_int("solverFreq", 1), 1),
            emissivity=torch.full((len(sel),), vfc.get_scalar("emissivity", 1.0), **kw),
            F=torch.as_tensor(F, **kw),
            sel=torch.as_tensor(sel, device=geom.device),
        )

    def initial_state(self) -> Dict:
        nb = self.geom.n_boundary
        kw = dict(dtype=self.F.dtype, device=self.F.device)
        return {
            "qr_b": torch.zeros(nb, **kw),
            "qin_b": torch.zeros(nb, **kw),
            "since": torch.zeros((), dtype=torch.int32, device=self.F.device),
        }

    def _solve(self, T_b):
        Ts = T_b[self.sel]
        eps = self.emissivity.to(Ts.dtype)
        E = eps * SIGMA * Ts**4
        refl = 1.0 - eps
        Fm = self.F.to(Ts.dtype)
        J = E
        for _ in range(N_SWEEPS):
            J = E + refl * (Fm @ J)
        H = Fm @ J  # incident irradiation
        return eps * (SIGMA * Ts**4 - H), H

    def maybe_correct(self, state, gas) -> Dict:
        rad = state["rad"]
        since = rad["since"] + 1
        if int(since) < self.solver_freq:
            return {"qr_b": rad["qr_b"], "qin_b": rad["qin_b"], "since": since}
        qr_s, H_s = self._solve(state["T"].b)
        # the selected faces are distinct: each slot is written once
        qr = torch.zeros_like(rad["qr_b"]).index_copy(0, self.sel, qr_s)
        qin = torch.zeros_like(rad["qin_b"]).index_copy(0, self.sel, H_s)
        return {"qr_b": qr, "qin_b": qin, "since": torch.zeros_like(since)}

    def Sh(self, state, gas):
        # transparent medium: no volumetric exchange (viewFactor.C::Ru/Rp)
        return torch.zeros_like(state["T"].i)

    def qr_boundary(self, rad):
        return rad["qr_b"]

    def qin_boundary(self, rad):
        return rad["qin_b"]

    def G_bands(self, rad):
        return torch.zeros((1, self.geom.n_cells), dtype=rad["qr_b"].dtype,
                           device=rad["qr_b"].device)


@dataclass
class OpaqueSolid:
    """opaqueSolid.C: no radiative transport in the solid region; the model
    only carries the absorptionEmission properties for boundary coupling
    (Ru = Rp = 0)."""

    geom: object
    absorptivity: float = 1.0
    emissivity: float = 1.0
    n_rays = 0
    n_bands = 1
    solver_freq = 1

    @classmethod
    def from_case_dict(cls, rp: FoamDict, geom, case) -> "OpaqueSolid":
        aem = str(rp.lookup("absorptionEmissionModel", "constantAbsorptionEmission"))
        aec = rp.get_dict(aem + "Coeffs", FoamDict())
        return cls(
            geom=geom,
            absorptivity=aec.get_scalar("absorptivity", aec.get_scalar("a", 1.0)),
            emissivity=aec.get_scalar("emissivity", aec.get_scalar("e", 1.0)),
        )

    def initial_state(self) -> Dict:
        return {"since": torch.zeros((), dtype=torch.int32, device=self.geom.device)}

    def maybe_correct(self, state, gas) -> Dict:
        return state["rad"]

    def Sh(self, state, gas):
        return torch.zeros_like(state["T"].i)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.geom.dtype, device=self.geom.device)

    def qr_boundary(self, rad):
        return self._zeros(self.geom.n_boundary)

    def qin_boundary(self, rad):
        return self._zeros(self.geom.n_boundary)

    def G_bands(self, rad):
        return self._zeros(1, self.geom.n_cells)
