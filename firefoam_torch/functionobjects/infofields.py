"""infoFieldsOutput diagnostics (solver/include/infoFieldsOutput.H and the
per-step updates of solver/include/infoOutput.H).

The port of firefoam_tpu/functionobjects/infofields.py: the mixture
fraction ft and the per-step flame heights the reference appends to
outFlameHeight, and `InfoFields`, the diagnostic volume and surface fields
(ft, UT, rhoU, …, HRR_fu, phiFt, species/enthalpy/momentum fluxes,
convective heat fluxes) computed from the state at write times."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import small
from ..ops import fvc
from ..ops.fields import SurfaceField, VolField

__all__ = ["mixture_fraction", "ft_stoich", "flame_heights", "InfoFields"]

_YO2_INF = 0.23301  # hardcoded in the reference createFields.H


def mixture_fraction(solver, Y_i, Y_b=None):
    """ft = (fu·s − O2 + YO2Inf)/(s + YO2Inf), clipped to [0,1]
    (createFields.H:232-259)."""
    r = solver.reaction
    s = float(r.s)

    def ft_of(Y):
        fu = Y[:, r.fuel_index]
        o2 = Y[:, solver.gas.index("O2")] if "O2" in solver.species else 0.0
        return torch.clamp((fu * s - o2 + _YO2_INF) / (s + _YO2_INF), 0.0, 1.0)

    if Y_b is None:
        return ft_of(Y_i)
    return VolField(ft_of(Y_i), ft_of(Y_b))


def ft_stoich(solver) -> float:
    """ftSt = 1/(1 + stoicRatio), stoicRatio = s/YO2Inf (air-fuel mass)."""
    return 1.0 / (1.0 + float(solver.reaction.s) / _YO2_INF)


def flame_heights(solver, state) -> Dict[str, torch.Tensor]:
    """The |C·ĝ| extent of cells with ft ≥ ftSt (flameHeight) and
    ft ≥ 0.2·ftSt (flameHeight2)."""
    g = solver.geom
    ft = mixture_fraction(solver, state["Y"].i)
    ghat = solver.g_vec / (np.linalg.norm(solver.g_vec) + small(torch.float64))
    h = torch.abs(g.C @ torch.as_tensor(ghat, dtype=g.dtype, device=g.device))
    ftSt = ft_stoich(solver)
    zero = torch.zeros_like(h)
    return {
        "flameHeight": g.rmax(torch.where(ft >= ftSt, h, zero)),
        "flameHeight2": g.rmax(torch.where(ft >= 0.2 * ftSt, h, zero)),
    }


class InfoFields:
    """The reference's diagnostic field set, computed from a state."""

    def __init__(self, solver):
        self.solver = solver
        qc = (solver.case.constant("QcWallFunctionDict")
              if solver.case.has_constant("QcWallFunctionDict") else None)
        self.Qc_flame = qc.get_scalar("QcFlame", 16000.0) if qc else 16000.0
        self.Qc_threshold = qc.get_scalar("QcThreshold", 5000.0) if qc else 5000.0

    # ------------------------------------------------------------------
    def volume_fields(self, state) -> Dict[str, VolField]:
        s = self.solver
        g = s.geom
        Y, T, U, rho = state["Y"], state["T"], state["U"], state["rho"]
        out: Dict[str, VolField] = {}
        out["ft"] = mixture_fraction(s, Y.i, Y.b)
        out["UT"] = VolField(U.i * T.i[:, None], U.b * T.b[:, None])
        out["rhoU"] = VolField(rho.i[:, None] * U.i, rho.b[:, None] * U.b)
        out["rhoT"] = VolField(rho.i * T.i, rho.b * T.b)
        fu = s.reaction.fuel_index
        out["rhoFu"] = VolField(rho.i * Y.i[:, fu], rho.b * Y.b[:, fu])
        # molecular / SGS diffusivities (infoOutput.H:141-148)
        out["d"] = VolField(state["alpha"].i / rho.i, state["alpha"].b / rho.b)
        out["dSgs"] = VolField(state["alphat"].i / rho.i, state["alphat"].b / rho.b)
        # SGS stress B = R() = (2/3)k·I − nut·dev(twoSymm(grad U)), stored
        # as the 6 symmTensor components (xx, xy, xz, yy, yz, zz)
        gradU = fvc.grad(g, U)
        twoSym = gradU + gradU.transpose(-1, -2)
        tr = torch.diagonal(twoSym, dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(3, dtype=gradU.dtype, device=gradU.device)
        dev = twoSym - (tr / 3.0)[:, None, None] * eye
        k, nut = state["k"], state["nut"]
        R = (2.0 / 3.0) * k.i[:, None, None] * eye - nut.i[:, None, None] * dev
        comp = torch.stack(
            [R[:, 0, 0], R[:, 0, 1], R[:, 0, 2], R[:, 1, 1], R[:, 1, 2], R[:, 2, 2]], dim=1
        )
        out["B"] = VolField(comp, torch.zeros((g.n_boundary, 6), dtype=comp.dtype,
                                              device=comp.device))
        # spray volume fraction theta() and equivalent water density
        if getattr(s, "cloud", None) is not None and "cloud" in state:
            theta = s.cloud.spray_volume(state["cloud"]) / g.V
            zb = torch.zeros(g.n_boundary, dtype=comp.dtype, device=comp.device)
            out["VFSpray"] = VolField(theta, zb)
            out["rhoSpray"] = VolField(1000.0 * theta, zb)
        out["QcWallFunction"] = self._qc_wall_function(state)
        return out

    def _qc_wall_function(self, state) -> VolField:
        """QcWallFunction (infoOutput.H:99-121): on mappedWall patches, the
        ignition heat-flux correlation (convective-flux-scaled QcFlame below
        the blowing threshold, mlr-attenuated above it); zero elsewhere."""
        s = self.solver
        g = s.geom
        T = state["T"]
        qc_b = torch.zeros(g.n_boundary, dtype=T.i.dtype, device=T.i.device)
        cfl_b = self._convective_flux_L_boundary(state)
        for pch in g.patches:
            if pch.ptype != "mappedWall":
                continue
            sl = pch.slice
            mlr = -state["phi"].b[sl] / g.b_magSf[sl] * 2.5 * 1000.0  # g/m²/s
            low = torch.clamp(cfl_b[sl], 0.0, self.Qc_threshold) / self.Qc_threshold * self.Qc_flame
            x = mlr / 10.0
            high = self.Qc_flame * (x / (torch.exp(torch.clamp(x, max=500.0)) - 1.0))
            qc_b[sl] = torch.where(mlr < 0.1, low, high)
        return VolField(torch.zeros(g.n_cells, dtype=T.i.dtype, device=T.i.device), qc_b)

    def _convective_flux_L_boundary(self, state) -> torch.Tensor:
        """Boundary part of convectiveHeatFlux_L = −α·Cp·snGrad(T)."""
        s = self.solver
        g = s.geom
        T = state["T"]
        cp_b = s.gas.cp(T.b, state["Y"].b)
        sg = (T.b - g.cell_to_boundary(T.i)) * g.b_dc
        return -state["alpha"].b * cp_b * sg

    # ------------------------------------------------------------------
    def surface_fields(self, state) -> Dict[str, SurfaceField]:
        s = self.solver
        g = s.geom
        Y, T, U, phi = state["Y"], state["T"], state["U"], state["phi"]
        alpha, alphat = state["alpha"], state["alphat"]
        a_eff = VolField(alpha.i + alphat.i, alpha.b + alphat.b)
        w_mv = s._multivariate_weights(state)
        out: Dict[str, SurfaceField] = {}

        def interp_mv(col_i, col_b):
            return SurfaceField(w_mv * g.gather_own(col_i) + (1.0 - w_mv) * g.gather_nei(col_i),
                                col_b)

        def sn_grad(col_i, col_b):
            return SurfaceField((g.gather_nei(col_i) - g.gather_own(col_i)) * g.dc,
                                (col_b - g.cell_to_boundary(col_i)) * g.b_dc)

        def adv_diff(col_i, col_b):
            """φ·interp_mv(c) − interp(αEff)·snGrad(c)·|Sf| (infoOutput.H)."""
            ci = interp_mv(col_i, col_b)
            ae = fvc.interpolate(g, a_eff)
            sg = sn_grad(col_i, col_b)
            return SurfaceField(phi.i * ci.i - ae.i * sg.i * g.magSf,
                                phi.b * ci.b - ae.b * sg.b * g.b_magSf)

        r = s.reaction
        q_fuel = float(r.q_fuel())
        fu_i, fu_b = Y.i[:, r.fuel_index], Y.b[:, r.fuel_index]
        # HRR_fu = (−interp(fu)·phi + interp(αEff·grad fu)&Sf)·qFuel
        grad_fu = fvc.grad_scalar(g, VolField(fu_i, fu_b))
        af_f = fvc.interpolate(
            g, VolField(a_eff.i[:, None] * grad_fu, a_eff.b[:, None] * g.cell_to_boundary(grad_fu))
        )
        ci = interp_mv(fu_i, fu_b)
        out["HRR_fu"] = SurfaceField(
            (-ci.i * phi.i + torch.einsum("fd,fd->f", g.Sf, af_f.i)) * q_fuel,
            (-ci.b * phi.b + torch.einsum("fd,fd->f", g.b_Sf, af_f.b)) * q_fuel,
        )
        ft = mixture_fraction(s, Y.i, Y.b)
        out["phiFt"] = adv_diff(ft.i, ft.b)
        for sp, nm in (("O2", "phiO2"), ("CO2", "phiCO2")):
            if sp in s.species:
                c = s.gas.index(sp)
                out[nm] = adv_diff(Y.i[:, c], Y.b[:, c])
        hc_sp = s.gas.hc_species(Y.i)
        hc_i, hc_b = Y.i @ hc_sp, Y.b @ hc_sp
        hs_i, hs_b = state["hs"].i, state["hs"].b
        out["phiHc"] = adv_diff(hc_i, hc_b)
        out["phiHs"] = adv_diff(hs_i, hs_b)
        out["phiH"] = adv_diff(hs_i + hc_i, hs_b + hc_b)
        # momentum fluxes (infoOutput.H:85-88)
        Uf = fvc.interpolate(g, U)
        for c, nm in enumerate(("momentumX", "momentumY", "momentumZ")):
            out[nm] = SurfaceField(phi.i * Uf.i[:, c], phi.b * Uf.b[:, c])
        # convective heat fluxes (infoOutput.H:92-96)
        cp_f = fvc.interpolate(g, VolField(s.gas.cp(T.i, Y.i), s.gas.cp(T.b, Y.b)))
        sgT = sn_grad(T.i, T.b)
        al_f = fvc.interpolate(g, alpha)
        ae_f = fvc.interpolate(g, a_eff)
        out["convectiveHeatFlux_L"] = SurfaceField(-al_f.i * cp_f.i * sgT.i,
                                                   -al_f.b * cp_f.b * sgT.b)
        out["convectiveHeatFlux_T"] = SurfaceField(-ae_f.i * cp_f.i * sgT.i,
                                                   -ae_f.b * cp_f.b * sgT.b)
        return out
