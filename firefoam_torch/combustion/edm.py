"""Eddy-dissipation combustion model (EDM) for single-step chemistry.

The default fireFoam combustion model (eddyDissipationModel, C_EDC=4,
C_Diff=0, C_Stiff=1). Rate expression per the reference
eddyDissipationModel.C:71-91,142-147:

  rtTurb = C_EDC·ε/k            (turbulent mixing rate)
  rtDiff = C_Diff·α/(ρ·Δ²)      (laminar diffusion rate; Δ = LES filter)
  rt     = max(rtTurb, rtDiff)
  wFuel  = ρ·min(Y_fu, Y_O2/s) / (C_Stiff·dt) · (1 − exp(−C_Stiff·dt·rt))

Species sources R(Y_i) = wFuel·massStoichCoeff_i and heat release
Qdot = qFuel·wFuel, with the variants of the family (selected as the JAX
package selects them, `EddyDissipationModel.from_case`).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..thermo.single_step import SingleStepReaction

__all__ = ["EddyDissipationModel"]


@dataclass
class EddyDissipationModel:
    """EDM family. `variant` selects the rate expression:

      * eddyDissipationModel (default) — eddyDissipationModel.C:142-147
      * eddyDissipationLimitModel — rate factor clamped at 1 so at most the
        available reactant burns in one step; also the NoneStiff variant.
      * infinitelyFastChemistry — wFuel = ρ·min(YF, YO2/s)/(C·Δt).
      * eddyDissipationDiffusionModel — unstiffened ρ·lim·max(rtTurb,rtDiff)
        (also the DiffusionNoneStiff alias).
      * eddyDissipationBertExtModel / eddyDissipationFRVModel — extinction/
        reignition through the Fstar surrogate specie (combustion/edm_ext.py).
      * eddyDissipationIgnModel — trapezoidal pilot over an 'igniter'
        cellZone drawing fuel as dQI/qFuel.
      * eddyDissMultiFuelStreamModel — pooled multi-fuel rate split by pool
        share, with localRadFrac for localFuelRadFractionEmission.
    """

    reaction: SingleStepReaction
    C_EDC: float = 4.0
    C_Diff: float = 0.0
    C_Stiff: float = 1.0
    active: bool = True
    q_fuel: float = 0.0
    dY: np.ndarray = None  # mass stoich coefficients per kg fuel
    variant: str = "eddyDissipationModel"
    C_ifc: float = 10.0  # infinitelyFastChemistry C
    ext_coeffs: object = None  # ExtCoeffs for the BertExt/FRV variants
    fstar_index: int = None  # index of the quenched-fuel surrogate "Fstar"
    gas: object = None
    # eddyDissipationIgnModel: (tIgnBegin, tIgnRampUp, tIgnRampDown,
    # tIgnEnd) and the pilot heat dQI [W/m³] masked to the zone (a tensor,
    # set by FireFoamSolver)
    ign_times: tuple = None
    ign_dQI: object = None
    chi_ign: float = 0.0
    # eddyDissMultiFuelStreamModel: several fuel species burn as one pooled
    # fuel, each consumed in proportion to its share of the pool
    fuel_indices: tuple = None
    stream_rad_fracs: dict = None  # specie index → radiant fraction

    @classmethod
    def from_case(cls, comb_dict, reaction: SingleStepReaction) -> "EddyDissipationModel":
        """The JAX package's selection rule: aliases mapped, the extinction
        variants back on the base model (with a warning) when the gas has
        no Fstar, a multi-fuel model without fuels on the base model, and
        any other name silently on the base model."""
        from ..io.foamdict import FoamDict

        sel = comb_dict.get_word("combustionModel", "eddyDissipationModel")
        variant = sel.split("<")[0]
        coeffs = comb_dict.get_dict(variant + "Coeffs", None) or comb_dict.get_dict(
            "eddyDissipationModelCoeffs", FoamDict()
        )
        if variant == "eddyDissipationNoneStiffModel":
            variant = "eddyDissipationLimitModel"
        ext_coeffs = None
        fstar_index = None
        gas = reaction.gas
        if variant in ("eddyDissipationBertExtModel", "eddyDissipationFRVModel"):
            from .edm_ext import ExtCoeffs

            if "Fstar" in gas.species:
                ext_coeffs = ExtCoeffs.from_dict(coeffs)
                fstar_index = gas.index("Fstar")
            else:
                warnings.warn(
                    f"{variant} needs an 'Fstar' specie; falling back to "
                    "eddyDissipationModel"
                )
                variant = "eddyDissipationModel"
        if variant == "eddyDissipationDiffusionNoneStiffModel":
            variant = "eddyDissipationDiffusionModel"
        fuel_indices = None
        stream_rad_fracs = None
        if variant == "eddyDissMultiFuelStreamModel":
            names = [str(x) for x in (coeffs.get_list("fuelSpecies", []) or [])]
            fuel_indices = tuple(gas.index(n) for n in names if n in gas.species)
            streams = [str(x) for x in (coeffs.get_list("fuelStreams", []) or [])]
            fracs = [float(x) for x in (coeffs.get_list("fuelStreamsRadFracs", []) or [])]
            if streams and fracs:
                stream_rad_fracs = {
                    gas.index(n): f for n, f in zip(streams, fracs) if n in gas.species
                }
            if not fuel_indices:
                variant = "eddyDissipationModel"
        ign_times = None
        chi_ign = 0.0
        if variant == "eddyDissipationIgnModel":
            ign_times = (
                coeffs.get_scalar("tIgnBegin", 0.0),
                coeffs.get_scalar("tIgnRampUp", 1.0),
                coeffs.get_scalar("tIgnRampDown", 10.0),
                coeffs.get_scalar("tIgnEnd", 11.0),
            )
            chi_ign = coeffs.get_scalar("chiIgn", 0.0)
        known = (
            "eddyDissipationModel",
            "eddyDissipationLimitModel",
            "infinitelyFastChemistry",
            "eddyDissipationBertExtModel",
            "eddyDissipationFRVModel",
            "eddyDissipationDiffusionModel",
            "eddyDissipationIgnModel",
            "eddyDissMultiFuelStreamModel",
        )
        if variant not in known:
            variant = "eddyDissipationModel"
        return cls(
            reaction=reaction,
            C_EDC=coeffs.get_scalar("C_EDC", 4.0),
            C_Diff=coeffs.get_scalar("C_Diff", 0.0),
            C_Stiff=coeffs.get_scalar("C_Stiff", 1.0),
            active=coeffs.get_bool("active", True),
            q_fuel=reaction.q_fuel(),
            dY=reaction.mass_stoich_coeffs,
            variant=variant,
            C_ifc=coeffs.get_scalar("C", 10.0),
            ext_coeffs=ext_coeffs,
            fstar_index=fstar_index,
            gas=gas,
            ign_times=ign_times,
            chi_ign=chi_ign,
            fuel_indices=fuel_indices,
            stream_rad_fracs=stream_rad_fracs,
        )

    def _rt(self, rho, k, epsilon, alpha, delta):
        """max(rtTurb, rtDiff)."""
        rt_turb = self.C_EDC * epsilon / torch.clamp(k, min=1e-14)
        rt_diff = self.C_Diff * alpha / (rho * delta * delta)
        return torch.maximum(rt_turb, rt_diff)

    def w_fuel(self, rho, Y, k, epsilon, alpha, delta, dt) -> torch.Tensor:
        """Fuel consumption rate [kg/(m³ s)]."""
        if not self.active:
            return torch.zeros_like(rho)
        r = self.reaction
        YF = Y[:, r.fuel_index]
        YO2 = Y[:, r.o2_index]
        lim = torch.minimum(torch.clamp(YF, min=0.0), torch.clamp(YO2, min=0.0) / r.s)
        if self.variant == "infinitelyFastChemistry":
            return rho * lim / (self.C_ifc * dt)
        rt = self._rt(rho, k, epsilon, alpha, delta)
        if self.variant == "eddyDissipationDiffusionModel":
            # unstiffened rate (eddyDissipationDiffusionModel.C:90-99)
            return rho * lim * rt
        fac = (1.0 - torch.exp(-self.C_Stiff * dt * rt)) / self.C_Stiff
        if self.variant == "eddyDissipationLimitModel":
            fac = torch.clamp(fac, max=1.0)
        return rho * lim / dt * fac

    # -------------------------------------------------------- rates API
    def rates(self, rho, Y, k, epsilon, alpha, delta, dt, T=None, p=None,
              spray_rho=None, near_wall=None, t=None, nu=None, nut=None):
        """Per-step reaction state. Base variants: {'w_fuel'}; the
        BertExt/FRV extinction variants add the Fstar conversion rates and
        the extinction/reignition flags (combustion/edm_ext.py)."""
        if self.variant in (
            "eddyDissipationBertExtModel", "eddyDissipationFRVModel"
        ) and self.fstar_index is not None and T is not None:
            rt = self._rt(rho, k, epsilon, alpha, delta)
            if not self.active:
                z = torch.zeros_like(rho)
                return {"w_fuel": z, "WFstar": z, "FEF": z, "FIF": z}
            zero = torch.zeros_like(rho)
            spray = spray_rho if spray_rho is not None else zero
            tt = t if t is not None else torch.zeros((), dtype=rho.dtype, device=rho.device)
            from . import edm_ext

            if self.variant == "eddyDissipationBertExtModel":
                return edm_ext.bert_ext_rates(
                    self.gas, self.reaction, self.ext_coeffs, Y, T, p, rho,
                    rt, dt, self.C_Stiff, spray, near_wall, tt, self.fstar_index,
                )
            return edm_ext.frv_rates(
                self.gas, self.reaction, self.ext_coeffs, Y, T, p, rho,
                rt, dt, self.C_Stiff, spray,
                nu if nu is not None else zero,
                nut if nut is not None else zero,
                epsilon, tt, self.fstar_index,
            )
        if self.variant == "eddyDissMultiFuelStreamModel":
            # pooled fuel ẇ with the clipped-limited rate
            # (eddyDissMultiFuelStreamModel.C:138-145), split over the fuel
            # species by their pool share in R()
            r = self.reaction
            YFsum = sum(Y[:, i] for i in self.fuel_indices)
            YO2 = Y[:, r.o2_index]
            lim = torch.minimum(torch.clamp(YFsum, min=0.0), torch.clamp(YO2, min=0.0) / r.s)
            rt = self._rt(rho, k, epsilon, alpha, delta)
            fac = torch.clamp((1.0 - torch.exp(-self.C_Stiff * dt * rt)) / self.C_Stiff, max=1.0)
            # the JAX package's floor 1e-299 is 0 in float32, where a cell
            # without fuel would divide 0 by 0: there the floor is finfo.tiny
            floor = 1e-299 if Y.dtype == torch.float64 else torch.finfo(Y.dtype).tiny
            out = {
                "w_fuel": rho * lim / dt * fac,
                "fuel_sum": torch.clamp(YFsum, min=floor),
                "Y": Y,
            }
            if self.stream_rad_fracs:
                lrf = sum(f * Y[:, i] for i, f in self.stream_rad_fracs.items())
                out["localRadFrac"] = torch.clamp(lrf / out["fuel_sum"], min=0.0)
            return out
        w = self.w_fuel(rho, Y, k, epsilon, alpha, delta, dt)
        if self.variant == "eddyDissipationIgnModel" and self.ign_dQI is not None:
            # trapezoidal pilot ramp (eddyDissipationIgnModel::correct)
            b, up, dn, e = self.ign_times
            tt = t if t is not None else torch.zeros((), dtype=rho.dtype, device=rho.device)
            zero = torch.zeros_like(tt)
            ramp = torch.where(
                (tt >= b) & (tt <= up),
                (tt - b) / max(up - b, 1e-12),
                torch.where(
                    (tt > up) & (tt < dn),
                    zero + 1.0,
                    torch.where((tt >= dn) & (tt <= e), (e - tt) / max(e - dn, 1e-12), zero),
                ),
            )
            return {"w_fuel": w, "w_ign": ramp * self.ign_dQI / self.q_fuel}
        return {"w_fuel": w}

    def R(self, rates, specie_index: int) -> torch.Tensor:
        """Explicit species source [kg/(m³ s)] for specie i."""
        w = rates["w_fuel"]
        nu_i = float(self.dY[specie_index])
        if "FEF" in rates:  # eddyDissipationBertExtModel::R
            if specie_index == self.reaction.fuel_index:
                return w * nu_i + rates["FIF"] * rates["WFstar"]
            if specie_index == self.fstar_index:
                return rates["FEF"] * w - rates["FIF"] * rates["WFstar"]
            return (1.0 - rates["FEF"]) * w * nu_i
        if "FRV" in rates:  # eddyDissipationFRVModel::R
            if specie_index == self.reaction.fuel_index:
                return w * nu_i
            if specie_index == self.fstar_index:
                return (1.0 - rates["FRV"]) * w - rates["Fig"] * rates["WFstar"]
            return (rates["FRV"] * w + rates["Fig"] * rates["WFstar"]) * nu_i
        if "w_ign" in rates:
            return (w + rates["w_ign"]) * nu_i
        if "fuel_sum" in rates:  # eddyDissMultiFuelStreamModel::R
            fi = self.reaction.fuel_index
            if specie_index in (self.fuel_indices or ()):
                share = rates["Y"][:, specie_index] / rates["fuel_sum"]
                return w * float(self.dY[fi]) * share
            if specie_index == fi:
                return torch.zeros_like(w)
            return w * nu_i
        return w * nu_i

    def qdot(self, rates) -> torch.Tensor:
        """Heat-release rate [W/m³]."""
        w = rates["w_fuel"]
        if "FEF" in rates:
            return self.q_fuel * w * (1.0 - rates["FEF"])
        if "FRV" in rates:
            return self.q_fuel * (rates["FRV"] * w + rates["Fig"] * rates["WFstar"])
        if "w_ign" in rates:
            return self.q_fuel * (w + rates["w_ign"])
        return self.q_fuel * w
