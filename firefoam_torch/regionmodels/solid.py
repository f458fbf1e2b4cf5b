"""Solid-phase thermophysics and Arrhenius pyrolysis chemistry.

The port of firefoam_tpu/regionmodels/solid.py: constant-property solid
species (constIso transport, hConst thermo, rhoConst EoS) with mass-fraction
mixing, and irreversibleArrheniusSolidReaction kinetics in the form of
OpenFOAM's pyrolysisChemistryModel:

  ω = A·exp(−Ta/T)·[T ≥ Tcrit]·(c/c₀)^n·c₀        [kg/m³/s]

with c = ρ·Y the reactant's mass concentration and c₀ its initial value.
The solid product takes the share sr = ρ_product/ρ_reactant of the consumed
mass, the pyrolysate gas (1 − sr); the heat release is −Σ Hf_i·RRs_i.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..config import small
from ..io.foamdict import FoamDict

__all__ = ["SolidThermo", "SolidChemistry", "SolidReaction", "SIGMA_SB"]

SIGMA_SB = 5.670374419e-8
T_STD = 298.15


_DEV: dict = {}


def _vec(a, like: torch.Tensor) -> torch.Tensor:
    """A host property table on `like`'s device and dtype, copied once (a
    host-to-device copy a call would wait for the card)."""
    a = np.asarray(a, np.float64)
    key = (a.tobytes(), like.dtype, like.device)
    if key not in _DEV:
        _DEV[key] = torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return _DEV[key]


def _dot(Y: torch.Tensor, a) -> torch.Tensor:
    """Σ_s Y[..., s]·a[s] over the last axis as a chain of fused
    multiply-adds in species order: the rounding of XLA's CPU dot, so that
    the mixing rules agree with the JAX package's to the last bit."""
    p = _vec(a, Y)
    out = Y[..., 0] * p[0]
    for s in range(1, p.shape[0]):
        out = torch.addcmul(out, Y[..., s], p[s].expand_as(out))
    return out


@dataclass
class SolidThermo:
    """Constant-property solid species set with mass-fraction mixing."""

    species: List[str]
    rho_s: np.ndarray  # [nS]
    cp_s: np.ndarray  # [nS]
    hf_s: np.ndarray  # [nS]
    kappa_s: np.ndarray  # [nS]
    emissivity_s: np.ndarray  # [nS] (greyMeanSolidAbsorptionEmission)
    absorptivity_s: np.ndarray  # [nS]

    @classmethod
    def from_case(cls, thermo_dict: FoamDict, species: List[str],
                  rad_props: FoamDict = None) -> "SolidThermo":
        rho, cp, hf, kap = [], [], [], []
        for s in species:
            d = thermo_dict.get_dict(s)
            rho.append(d.get_dict("equationOfState").get_scalar("rho"))
            th = d.get_dict("thermodynamics")
            cp.append(th.get_scalar("Cp"))
            hf.append(th.get_scalar("Hf", 0.0))
            kap.append(d.get_dict("transport").get_scalar("kappa"))
        emis = np.zeros(len(species))
        absb = np.zeros(len(species))
        if rad_props is not None and rad_props.found("absorptionEmissionModel"):
            coeffs = rad_props.get_dict(
                str(rad_props.lookup("absorptionEmissionModel")) + "Coeffs", FoamDict())
            for i, s in enumerate(species):
                if coeffs.found(s):
                    emis[i] = coeffs.get_dict(s).get_scalar("emissivity", 0.0)
                    absb[i] = coeffs.get_dict(s).get_scalar("absorptivity", 0.0)
        return cls(species=list(species), rho_s=np.asarray(rho), cp_s=np.asarray(cp),
                   hf_s=np.asarray(hf), kappa_s=np.asarray(kap), emissivity_s=emis,
                   absorptivity_s=absb)

    def index(self, name: str) -> int:
        return self.species.index(name)

    # Y: [..., nS] mass fractions
    def cp(self, Y):
        return _dot(Y, self.cp_s)

    def kappa(self, Y):
        return _dot(Y, self.kappa_s)

    def hs(self, T, Y):
        return self.cp(Y) * (T - T_STD)

    def T_from_hs(self, hs, Y):
        return T_STD + hs / torch.clamp(self.cp(Y), min=1e-30)

    def _vol_weight(self, Y, prop):
        """Volume-fraction weighting X_i ∝ Y_i/ρ_i (greyMeanSolid rule)."""
        X = Y / _vec(self.rho_s, Y)
        X = X / torch.clamp(torch.sum(X, dim=-1, keepdim=True), min=small(Y.dtype))
        return _dot(X, prop)

    def emissivity(self, Y):
        return self._vol_weight(Y, self.emissivity_s)

    def absorptivity(self, Y):
        return self._vol_weight(Y, self.absorptivity_s)


@dataclass
class SolidReaction:
    """One irreversibleArrheniusSolidReaction."""

    lhs: int  # reactant solid index
    rhs_solid: int  # product solid index (−1 if none)
    exponent: float  # reaction order on (c/c0)
    A: float
    Ta: float
    Tcrit: float
    sr: float  # solid product mass share (ρ_product/ρ_reactant)


_RX = re.compile(r"\s*(?P<name>\w+)(?:\^(?P<exp>[\d.eE+-]+))?\s*")


@dataclass
class SolidChemistry:
    """Explicit solid chemistry (useChemistrySolvers false → calculate())."""

    thermo: SolidThermo
    gas_species: List[str]
    reactions: List[SolidReaction]

    @classmethod
    def from_case(cls, rx_dict: FoamDict, thermo: SolidThermo) -> "SolidChemistry":
        gas_species = [str(s) for s in rx_dict.get_list("gaseousSpecies")]
        rxs = []
        for _, rd in rx_dict.get_dict("reactions").subdicts():
            eq = str(rd.lookup("reaction")).strip('"')
            lhs_s, rhs_s = eq.split("=")
            m = _RX.match(lhs_s)
            lhs = thermo.index(m.group("name"))
            exp = float(m.group("exp") or 1.0)
            rhs_solid = -1
            for tok in rhs_s.split("+"):
                nm = _RX.match(tok).group("name")
                if nm in thermo.species:
                    rhs_solid = thermo.index(nm)
            sr = float(thermo.rho_s[rhs_solid] / thermo.rho_s[lhs]) if rhs_solid >= 0 else 0.0
            rxs.append(SolidReaction(lhs=lhs, rhs_solid=rhs_solid, exponent=exp,
                                     A=rd.get_scalar("A"), Ta=rd.get_scalar("Ta"),
                                     Tcrit=rd.get_scalar("Tcrit", 0.0), sr=sr))
        return cls(thermo=thermo, gas_species=gas_species, reactions=rxs)

    @property
    def n_solids(self) -> int:
        return len(self.thermo.species)

    def rates(self, rho, Ys, T, Ys0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(RRs [..., nS], RRg [...], Qdot [...]) in kg/m³/s and W/m³.
        Ys0: the reactants' initial mass concentrations c₀ [..., nS]."""
        RRs = torch.zeros_like(Ys)
        RRg = torch.zeros_like(T)
        tiny = small(T.dtype)
        for r in self.reactions:
            c = torch.clamp(rho * Ys[..., r.lhs], min=0.0)
            c0 = torch.clamp(Ys0[..., r.lhs], min=tiny)
            kf = r.A * torch.exp(-r.Ta / torch.clamp(T, min=1.0))
            kf = torch.where(T >= r.Tcrit, kf, torch.zeros_like(kf))
            omega = kf * (c / c0) ** r.exponent * c0
            RRs = RRs.clone()
            RRs[..., r.lhs] = RRs[..., r.lhs] - omega
            if r.rhs_solid >= 0:
                RRs[..., r.rhs_solid] = RRs[..., r.rhs_solid] + r.sr * omega
            RRg = RRg + (1.0 - r.sr) * omega
        qdot = -_dot(RRs, self.thermo.hf_s)
        return RRs, RRg, qdot
