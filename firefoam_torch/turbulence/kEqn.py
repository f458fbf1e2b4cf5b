"""LES SGS models kEqn, WALE/WALE2 and SIGMA2 (+ cubeRootVol delta).

kEqn:
  nut  = Ck·sqrt(k)·Δ
  k-eqn: ddt(ρk) + div(φ,k) − lap(ρ·DkEff,k) =
         ρ·G − (2/3)ρ·divU·k − Ce·ρ·k^1.5/Δ
  G    = nut·(dev(2·symm(∇U)) : ∇U)
  ε    = Ce·k^1.5/Δ   (used by the EDM combustion rate)

WALE / WALE2 (WALE.C:120-133): the same k transport with the WALE eddy
viscosity in the production and the diffusivity,
  nuSgs = (cw·Δ)²·(Sd:Sd)^{3/2} / ((S:S)^{5/2} + (Sd:Sd)^{5/4} + ε),
  Sd = dev(symm(g·g)),  g = ∇U.
SIGMA2 (SIGMA2.C): algebraic σ-model from the singular values of ∇U (the
closed-form eigenvalues of ∇Uᵀ∇U), no k transport: k = (nuSgs/(Ck·Δ))².

Also provides divDevRhoReff's explicit part for the momentum equation:
−div(muEff·dev2(∇Uᵀ)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops import bcs as bcmod
from ..ops import fvc, fvm
from ..ops.fields import SurfaceField, VolField
from ..ops.geometry import MeshGeometry
from ..solvers.linear import SolverResult, solve_scalar

__all__ = ["KEqnLES"]


@dataclass
class KEqnLES:
    geom: MeshGeometry
    delta: torch.Tensor  # [nC] cubeRootVol filter width
    Ck: float = 0.094
    Ce: float = 1.048
    Prt: float = 1.0
    k_min: float = 1e-14
    model: str = "kEqn"  # kEqn | WALE | WALE2 | SIGMA2
    cw: float = 0.5  # WALE coefficient
    cx: float = 1.35  # SIGMA coefficient
    div_scheme: tuple = ("limitedLinear", 1.0)
    # laplacianSchemes' non-orthogonal correction (set by FireFoamSolver):
    # None uncorrected, 1.0 corrected, α < 1 limited α
    lap_limiter: Optional[float] = None

    @classmethod
    def from_case(cls, geom: MeshGeometry, turb_dict, les_props=None) -> "KEqnLES":
        """Build from turbulenceProperties, preferring constant/LESProperties
        (the 2.4.x dictionary style the reference's golden runs read)."""
        les = turb_dict.get_dict("LES")
        model = les.get_word("LESModel", les.get_word("model", "kEqn"))
        coeffs = les.get_dict(model + "Coeffs", None) if les.found(model + "Coeffs") else None
        crv = les.get_dict("cubeRootVolCoeffs", None) if les.found("cubeRootVolCoeffs") else None
        ck_default, ce_default = 0.094, 1.048
        if les_props is not None and les_props.found("LESModel"):
            model = les_props.get_word("LESModel", model)
            coeffs = (
                les_props.get_dict(model + "Coeffs")
                if les_props.found(model + "Coeffs")
                else None
            )
            if les_props.found("cubeRootVolCoeffs"):
                crv = les_props.get_dict("cubeRootVolCoeffs", None)
        delta_coeff = crv.get_scalar("deltaCoeff", 1.0) if crv else 1.0
        delta = delta_coeff * torch.pow(geom.V, 1.0 / 3.0)
        kw = {}
        if coeffs:
            kw["Ck"] = coeffs.get_scalar("Ck", coeffs.get_scalar("ck", ck_default))
            kw["Ce"] = coeffs.get_scalar("Ce", coeffs.get_scalar("ce", ce_default))
            kw["Prt"] = coeffs.get_scalar("Prt", 1.0)
            kw["cw"] = coeffs.get_scalar("cw", 0.5)
            kw["cx"] = coeffs.get_scalar("cx", 1.35)
        if model == "oneEqEddy":
            model = "kEqn"  # 2.4.x name for the same one-equation SGS model
        if model not in ("kEqn", "WALE", "WALE2", "SIGMA2"):
            model = "kEqn"  # stock core models default to kEqn behaviour
        return cls(geom=geom, delta=delta, model=model, **kw)

    # --------------------------------------------- gradU-based viscosities
    def _nut_wale(self, gradU: torch.Tensor) -> torch.Tensor:
        """WALE operator (WALE.C:120-129)."""
        S = 0.5 * (gradU + gradU.transpose(-1, -2))
        gg = torch.einsum("cij,cjk->cik", gradU, gradU)
        sym_gg = 0.5 * (gg + gg.transpose(-1, -2))
        tr = torch.diagonal(sym_gg, dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(3, dtype=gradU.dtype, device=gradU.device)
        Sd = sym_gg - (tr / 3.0)[:, None, None] * eye
        SdSd = torch.einsum("cij,cij->c", Sd, Sd)
        SuSu = torch.einsum("cij,cij->c", S, S)
        eps = torch.finfo(gradU.dtype).tiny * 1e6
        return (self.cw * self.delta) ** 2 * SdSd ** 1.5 / (SuSu ** 2.5 + SdSd ** 1.25 + eps)

    def _nut_sigma(self, gradU: torch.Tensor) -> torch.Tensor:
        """σ-model via the closed-form eigenvalues of ∇Uᵀ∇U (SIGMA2.C)."""
        G = torch.einsum("cji,cjk->cik", gradU, gradU)  # gradU.T & gradU
        L1 = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
        GG = torch.einsum("cij,cjk->cik", G, G)
        L2 = 0.5 * (L1 ** 2 - torch.diagonal(GG, dim1=-2, dim2=-1).sum(-1))
        L3 = torch.linalg.det(G)
        eps = torch.finfo(gradU.dtype).tiny * 1e6
        A1 = torch.clamp(L1 ** 2 / 9.0 - L2 / 3.0, min=0.0) + eps
        A2 = L1 ** 3 / 27.0 - L1 * L2 / 6.0 + L3 / 2.0
        R12 = torch.clamp(A2 / (A1 ** 1.5 + eps), -1.0, 1.0)
        A3 = torch.arccos(0.9999 * R12) / 3.0
        sq = torch.sqrt(A1)
        ss1 = L1 / 3.0 + 2.0 * sq * torch.cos(A3)
        ss2 = L1 / 3.0 - 2.0 * sq * torch.cos(math.pi / 3.0 + A3)
        ss3 = L1 / 3.0 - 2.0 * sq * torch.cos(math.pi / 3.0 - A3)
        S1 = torch.sqrt(torch.abs(ss1))
        S2 = torch.sqrt(torch.abs(ss2))
        S3 = torch.sqrt(torch.abs(ss3))
        nut = (self.cx * self.delta) ** 2 * (S3 * (S1 - S2) * (S2 - S3)) / (S1 ** 2 + eps)
        return torch.abs(nut)

    # ------------------------------------------------------------- algebra
    def nut(self, k: torch.Tensor) -> torch.Tensor:
        return self.Ck * torch.sqrt(torch.clamp(k, min=0.0)) * self.delta

    def nut_b(self, k_b: torch.Tensor) -> torch.Tensor:
        """Boundary nut: filter width taken from the owner cell."""
        return self.Ck * torch.sqrt(torch.clamp(k_b, min=0.0)) * self.geom.cell_to_boundary(self.delta)

    def epsilon(self, k: torch.Tensor) -> torch.Tensor:
        return self.Ce * torch.clamp(k, min=0.0) ** 1.5 / self.delta

    def production(self, nut_i: torch.Tensor, gradU: torch.Tensor) -> torch.Tensor:
        """G = nut·(dev(2 symm(∇U)) : ∇U)."""
        S2 = gradU + gradU.transpose(-1, -2)
        tr = torch.diagonal(S2, dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(3, dtype=gradU.dtype, device=gradU.device)
        dev = S2 - (tr / 3.0)[:, None, None] * eye
        return nut_i * torch.einsum("cij,cij->c", dev, gradU)

    # --------------------------------------------------------------- solve
    def correct(self, k: VolField, k_bcs, U: VolField, rho: VolField, rho_old,
                phi: SurfaceField, mu: VolField, dt, ctx: dict,
                solver_ctl: dict) -> Tuple[VolField, torch.Tensor, SolverResult]:
        """Advance k one step; returns (k_new, nut_internal, solver stats)."""
        g = self.geom
        gradU = fvc.grad(g, U)
        if self.model in ("WALE", "WALE2"):
            nut_i = self._nut_wale(gradU)
        elif self.model == "SIGMA2":
            nut_i = self._nut_sigma(gradU)
            # algebraic model: no k transport (SIGMA2.C: k from muSgs)
            k_i = (nut_i / (self.Ck * self.delta)) ** 2
            k_new = bcmod.evaluate(k_bcs, g, VolField(k_i, k.b), ctx)
            zero = torch.zeros((), dtype=k.i.dtype, device=k.i.device)
            return k_new, nut_i, SolverResult(
                k_i, zero, zero, torch.zeros((), dtype=torch.int32, device=k.i.device))
        else:
            nut_i = self.nut(k.i)
        G = self.production(nut_i, gradU)
        divU = fvc.div_flux(g, fvc.flux(g, U))

        dk_eff = VolField(mu.i / rho.i + nut_i, mu.b / rho.b + self.nut_b(k.b))
        dk_eff_rho = SurfaceField(
            fvc.interpolate(g, VolField(rho.i * dk_eff.i, rho.b * dk_eff.b)).i,
            rho.b * dk_eff.b,
        )

        rv, rg, f = bcmod.resolve(k_bcs, g, k, ctx)
        vic, vbc = fvm.mixed_value_coeffs(rv, rg, f, g.b_dc)
        gic, gbc = fvm.mixed_gradient_coeffs(rv, rg, f, g.b_dc)
        sch = self.div_scheme
        if sch[0] in ("limitedLinear", "limitedLinear01"):
            w = fvm.limited_linear_weights(
                g, phi.i, k, k=float(sch[1]), bound01=sch[0].endswith("01")
            )
        elif sch[0] == "linear":
            w = g.w
        elif sch[0] == "upwind":
            w = fvm.upwind_weights(g, phi.i)
        elif sch[0] == "filteredLinear2":
            lim = fvm.filtered_linear2_limiter(g, k, None, k=sch[1], l=sch[2])
            w = fvm.limiter_weights(g, phi.i, lim)
        else:
            raise NotImplementedError(f"div(phi,k) scheme '{sch[0]}'")

        corr = None
        if self.lap_limiter is not None:
            corr = fvc.non_orth_correction(
                g, k, limiter=None if self.lap_limiter >= 1.0 else self.lap_limiter)
        m = (
            fvm.ddt(g, rho.i, k, k.i, rho_old, dt)
            + fvm.div(g, phi, k, w, vic, vbc)
            - fvm.laplacian(g, dk_eff_rho, k, gic, gbc, corr=corr)
            + fvm.Sp(g, self.Ce * rho.i * torch.sqrt(torch.clamp(k.i, min=0.0)) / self.delta, k)
        )
        # −(2/3)ρ·divU·k: SuSp — implicit where the coefficient is positive
        susp = (2.0 / 3.0) * rho.i * divU
        m = m + fvm.Sp(g, torch.clamp(susp, min=0.0), k)
        m = m.add_source(rho.i * G - torch.clamp(susp, max=0.0) * k.i)

        res = solve_scalar(
            m, k.i,
            solver=solver_ctl.get("solver", "PBiCGStab"),
            tol=solver_ctl.get("tolerance", 1e-8),
            rel_tol=solver_ctl.get("relTol", 0.0),
            max_iter=int(solver_ctl.get("maxIter", 1000)),
            sched=solver_ctl.get("sched"),
            preconditioner=solver_ctl.get("preconditioner"),
            smoother=solver_ctl.get("smoother"),
            n_sweeps=int(solver_ctl.get("nSweeps", 1)),
        )
        k_new_i = torch.clamp(res.x, min=self.k_min)  # bound k
        k_new = bcmod.evaluate(k_bcs, g, VolField(k_new_i, k.b), ctx)
        return k_new, self.nut(k_new.i), res

    # ------------------------------------------------- momentum stress term
    def div_dev_rho_reff(self, U: VolField, mu_eff: VolField, gradU: torch.Tensor):
        """Explicit part of divDevRhoReff: −div(muEff·dev2(∇Uᵀ)) is returned
        as +div(...) per volume [nC,3] (the caller adds it as a source);
        dev2(A) = A − (2/3)tr(A)I."""
        g = self.geom
        AT = gradU.transpose(-1, -2)
        tr = torch.diagonal(gradU, dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(3, dtype=gradU.dtype, device=gradU.device)
        dev2 = AT - (2.0 / 3.0) * tr[:, None, None] * eye
        tau = mu_eff.i[:, None, None] * dev2
        tau_f = (
            g.w[:, None, None] * g.gather_own(tau)
            + (1.0 - g.w)[:, None, None] * g.gather_nei(tau)
        )
        tau_b = mu_eff.b[:, None, None] * g.cell_to_boundary(dev2)
        flux_i = torch.einsum("fi,fij->fj", g.Sf, tau_f)
        flux_b = torch.einsum("fi,fij->fj", g.b_Sf, tau_b)
        return fvc.surface_sum(g, SurfaceField(flux_i, flux_b)) / g.V[:, None]
