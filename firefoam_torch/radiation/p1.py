"""P1 spherical-harmonics radiation model.

The reference P1 model (packages/thermophysicalModels/radiation/
radiationModels/P1/P1.C:212-258 calculate) as a single diffusion solve on
the incident-radiation field G:

    laplacian(gamma, G) - a·G = -4·e·σT⁴ - E ,   gamma = 1/(3a + 3σs + ε)

with MarshakRadiation walls (MarshakRadiationFvPatchScalarField.C:156-188):
mixed BC, refValue = 4σT_w⁴, refGrad = 0, valueFraction
f = 1/(1 + gamma·Δc/Ep), Ep = ε/(2(2−ε)).

The system is one row of the whole-solve BiCGStab (solvers/linear.py
`solve_ldu`: K1 on a DIA mesh on CUDA, the twin on SEG). Absorption/emission submodels are shared with fvDOM
(fvdom.grey_absorption): constRadFractionEmission (a = 0, E = χ_r·Qdot),
constantAbsorptionEmission, greyMeanAbsorptionEmission (e = a,
greyMeanAbsorptionEmission.C:259-262), the grey WSGG models. Energy
coupling Sh = Ru − Rp·T⁴ = a·G − 4eσT⁴ − E (P1.C:261-279). Wall fluxes:
qr = −gamma·snGrad(G) (P1.C:246-257), qin ≈ G_w/4.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..io import Case
from ..io.foamdict import FoamDict
from ..ops import fvm
from ..ops.fields import SurfaceField, VolField
from ..ops.geometry import MeshGeometry
from ..solvers.linear import solve_ldu
from ..utils.spans import span
from .fvdom import (_GREY_MEAN, SIGMA, RadiantFractionGate, _aslist, grey_absorption,
                    parse_grey_species)

__all__ = ["P1"]


@dataclass
class P1(RadiantFractionGate):
    geom: MeshGeometry
    solver_freq: int
    a_const: float
    e_const: float
    sigma_s: float  # constant scatter coefficient
    ehrr: float
    ehrr1: float
    ehrr2: float
    rad_scaling: bool
    patch1: tuple
    patch2: tuple
    ae_model: str
    grey_species: tuple
    emissivity: torch.Tensor  # [nB]
    tol: float = 1e-6
    wsggm: object = None
    # G solves run since construction (each one K1 launch on a DIA mesh on
    # the card):
    # host-side bookkeeping, not part of the state
    solves: int = 0
    last_iters: Optional[torch.Tensor] = None

    n_rays = 0  # no ordinate axis

    @classmethod
    def from_case_dict(cls, rp: FoamDict, geom: MeshGeometry, case: Case) -> "P1":
        aem = str(rp.lookup("absorptionEmissionModel", "constRadFractionEmission"))
        aec = rp.get_dict(aem + "Coeffs", FoamDict())
        a_const = e_const = 0.0
        if aem == "constantAbsorptionEmission":
            a_const = aec.get_scalar("a", 0.01)
            e_const = aec.get_scalar("e", 0.0)
        grey_species = parse_grey_species(aec) if aem in _GREY_MEAN else ()
        wsggm = None
        if aem.startswith("wsggmAbsorptionEmissionGrey"):
            # the JAX package reads both grey WSGG variants' coefficients
            # through the Smith model here; so does the port
            from .wsggm import WSGGMGreySmith

            wsggm = WSGGMGreySmith.from_coeffs(aec)
        sc = rp.get_dict("constantScatterCoeffs", FoamDict())
        return cls(
            geom=geom,
            solver_freq=rp.get_int("solverFreq", 1),
            a_const=a_const,
            e_const=e_const,
            sigma_s=(sc.get_scalar("sigma", 0.0)
                     if str(rp.lookup("scatterModel", "none")) == "constantScatter" else 0.0),
            ehrr=aec.get_scalar("EhrrCoeff", 0.2),
            ehrr1=aec.get_scalar("Ehrr1", 0.3),
            ehrr2=aec.get_scalar("Ehrr2", 0.3),
            rad_scaling=aec.get_bool("radScaling", False),
            patch1=tuple(str(x) for x in _aslist(aec.lookup("patch1", []))),
            patch2=tuple(str(x) for x in _aslist(aec.lookup("patch2", []))),
            ae_model=aem,
            grey_species=grey_species,
            emissivity=torch.ones((geom.n_boundary,), dtype=geom.dtype, device=geom.device),
            wsggm=wsggm,
        )

    # ----------------------------------------------------------- state
    def initial_state(self) -> Dict:
        g = self.geom
        kw = dict(dtype=g.dtype, device=g.device)
        return {
            "G": torch.zeros((g.n_cells,), **kw),
            "G_b": torch.zeros((g.n_boundary,), **kw),
            "gamma_b": torch.zeros((g.n_boundary,), **kw),
            "E": torch.zeros((g.n_cells,), **kw),
            "a": torch.full((g.n_cells,), self.a_const, **kw),
            "e": torch.full((g.n_cells,), self.e_const, **kw),
            "count": torch.zeros((), dtype=torch.int32, device=g.device),
            "chi": torch.full((), self.ehrr, **kw),
        }

    # --------------------------------------------------- absorption
    def _ae(self, state, gas):
        """(a, a_b, e) by submodel; greyMean/WSGGM: e = a (Kirchhoff,
        greyMeanAbsorptionEmission.C:259-262, GreySmith.C:663-667)."""
        if self.wsggm is not None:
            a = self.wsggm.a(state["T"].i, state["Y"].i, state["p"].i, gas)
            a_b = self.wsggm.a(state["T"].b, state["Y"].b, state["p"].b, gas)
            return a, a_b, a
        a, a_b = grey_absorption(self.grey_species, self.a_const, self.ae_model, self.geom,
                                 state, gas)
        e = a if self.ae_model in _GREY_MEAN else torch.full_like(a, self.e_const)
        return a, a_b, e

    # ------------------------------------------------------------ solve
    def _solve_G(self, rad, state, gas):
        g = self.geom
        T = state["T"]
        chi = self._chi(state)
        E_tot = chi * state["Qdot"]
        a, a_b, e = self._ae(state, gas)

        gamma = 1.0 / (3.0 * a + 3.0 * self.sigma_s + 1e-8)
        gamma_f = g.w * g.gather_own(gamma) + (1.0 - g.w) * g.gather_nei(gamma)
        gamma_b = 1.0 / (3.0 * a_b + 3.0 * self.sigma_s + 1e-8)

        # Marshak mixed BC coefficients
        emis = self.emissivity
        Ep = emis / (2.0 * (2.0 - emis))
        f = 1.0 / (1.0 + gamma_b * g.b_dc / Ep)
        ref_v = 4.0 * SIGMA * T.b**4
        psi = VolField(rad["G"], rad["G_b"])
        gic, gbc = fvm.mixed_gradient_coeffs(ref_v, torch.zeros_like(ref_v), f, g.b_dc)

        # −laplacian(gamma,G) + a·G = 4eσT⁴ + E
        m = -fvm.laplacian(g, SurfaceField(gamma_f, gamma_b), psi, gic, gbc)
        m = m + fvm.Sp(g, a, psi)
        m = m.add_source(4.0 * e * SIGMA * T.i**4 + E_tot)
        diag, b = m.totals()
        res = solve_ldu(g, "PBiCGStab", diag, m.upper, m.lower, b, rad["G"].contiguous(),
                        tol=self.tol, rel_tol=0.0, max_iter=1000)
        self.solves += 1
        self.last_iters = res.n_iterations
        G = torch.clamp(res.x, min=0.0)
        return {
            "G": G,
            "G_b": f * ref_v + (1.0 - f) * g.cell_to_boundary(G),
            "gamma_b": gamma_b,
            "E": E_tot,
            "a": a,
            "e": e,
            "count": rad["count"] + 1,
            "chi": chi,
        }

    def maybe_correct(self, state, gas) -> Dict:
        rad = state["rad"]
        if not self._due(rad):
            return self._skip(rad)
        with span("radiation.solve"):
            return self._solve_G(rad, state, gas)

    # ------------------------------------------------------- energy source
    def Sh(self, state, gas) -> torch.Tensor:
        """Sh = Ru − Rp·T⁴ = a·G − 4eσT⁴ − E, with stale a/e/G between
        solverFreq solves and E re-evaluated every step (P1.C:261-296)."""
        E = self._chi(state) * state["Qdot"]
        rad = state["rad"]
        return rad["a"] * rad["G"] - 4.0 * rad["e"] * SIGMA * state["T"].i ** 4 - E

    # ------------------------------------------------------- diagnostics
    def qr_boundary(self, rad) -> torch.Tensor:
        """qr = −gamma·snGrad(G) at boundary faces (P1.C:246-257)."""
        g = self.geom
        return -rad["gamma_b"] * (rad["G_b"] - g.cell_to_boundary(rad["G"])) * g.b_dc

    def qin_boundary(self, rad) -> torch.Tensor:
        """Incident flux at walls under the P1 closure: qin ≈ G_w/4."""
        return 0.25 * rad["G_b"]
