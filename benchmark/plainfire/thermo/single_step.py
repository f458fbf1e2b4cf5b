"""Single-step reacting mixture: stoichiometry for one global fuel reaction.

Re-provides OpenFOAM's singleStepReactingMixture data consumed by the
reference solver (solver/createFields.H:197-212 reads s, stoicRatio, qFuel,
fuelIndex; golden log prints qFuel=46357151, air/fuel=15.571544,
O2/fuel=3.6282945, max products, ft_st=0.060344407 for steckler propane):

  * parse the reaction string "C3H8 + 5O2 + 18.8N2 = 3CO2 + 4H2O + 18.8N2"
  * s        = stoichiometric O2/fuel mass ratio
  * stoicRatio = stoichiometric air/fuel mass ratio
  * qFuel    = heat of combustion per kg fuel (from formation enthalpies)
  * specie_stoich_coeffs: dY_i per unit fuel reaction progress
  * fres     machinery for EDM (fresCorrect in eddyDissipationModel.C:101)
  * stoichiometric mixture fraction ft_st
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..io.foamdict import FoamDict
from .gas import GasThermo

__all__ = ["SingleStepReaction"]

_TERM = re.compile(r"\s*(\d*\.?\d*)\s*([A-Za-z][A-Za-z0-9]*)\s*")


def _parse_side(side: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for term in side.split("+"):
        m = _TERM.fullmatch(term)
        if not m:
            raise ValueError(f"cannot parse reaction term '{term}'")
        coeff = float(m.group(1)) if m.group(1) else 1.0
        out[m.group(2)] = out.get(m.group(2), 0.0) + coeff
    return out


@dataclass
class SingleStepReaction:
    gas: GasThermo
    fuel: str
    inert: str
    nu_react: np.ndarray  # [nSp] molar stoich coefficients, reactant side
    nu_prod: np.ndarray  # [nSp] product side

    @classmethod
    def from_case(
        cls, reactions_dict: FoamDict, gas: GasThermo, fuel: str, inert: str
    ) -> "SingleStepReaction":
        rxns = reactions_dict.get_dict("reactions")
        name = next(iter(rxns.keys()))
        eqn = str(rxns.get_dict(name).lookup("reaction"))
        lhs, rhs = eqn.split("=")
        react = _parse_side(lhs)
        prod = _parse_side(rhs)
        nsp = gas.n_species
        nu_r = np.zeros(nsp)
        nu_p = np.zeros(nsp)
        for sp, c in react.items():
            nu_r[gas.index(sp)] = c
        for sp, c in prod.items():
            nu_p[gas.index(sp)] = c
        return cls(gas=gas, fuel=fuel, inert=inert, nu_react=nu_r, nu_prod=nu_p)

    # ------------------------------------------------------------ derived
    @property
    def fuel_index(self) -> int:
        return self.gas.index(self.fuel)

    @property
    def o2_index(self) -> int:
        return self.gas.index("O2")

    @property
    def inert_index(self) -> int:
        return self.gas.index(self.inert)

    @property
    def specie_stoich_coeffs(self) -> np.ndarray:
        """Net molar coefficients (products − reactants), fuel = −1-normalised
        per mole of fuel."""
        nu = self.nu_prod - self.nu_react
        return nu / self.nu_react[self.fuel_index]

    @property
    def mass_stoich_coeffs(self) -> np.ndarray:
        """dY_i per kg of fuel consumed (fuel entry = −1)."""
        nu = self.specie_stoich_coeffs
        W = self.gas.W
        return nu * W / W[self.fuel_index]

    @property
    def s(self) -> float:
        """Stoichiometric O2/fuel mass ratio (createFields.H 's')."""
        return float(-self.mass_stoich_coeffs[self.o2_index])

    @property
    def stoic_ratio(self) -> float:
        """Stoichiometric air/fuel mass ratio. Air composition implied by the
        reaction's inert/O2 molar ratio (18.8/5 N2 per O2 for steckler)."""
        W = self.gas.W
        nuO2 = self.nu_react[self.o2_index]
        nuN2 = self.nu_react[self.inert_index]
        nuF = self.nu_react[self.fuel_index]
        m_air = nuO2 * W[self.o2_index] + nuN2 * W[self.inert_index]
        return float(m_air / (nuF * W[self.fuel_index]))

    def q_fuel(self) -> float:
        """Heat of combustion per kg fuel from formation enthalpies
        (golden log 'Fuel heat of combustion :46357151')."""
        like = torch.zeros((), dtype=torch.float64)
        hc = self.gas.hc_species(like).numpy()  # J/kg at T_std
        dY = self.mass_stoich_coeffs
        # energy released = −Σ dY_i·hc_i per kg fuel
        return float(-np.sum(dY * hc))

    def max_products(self) -> Dict[str, float]:
        """Product mass fractions of a stoichiometric fuel+air mixture
        (golden log 'Maximum products mass concentrations')."""
        W = self.gas.W
        nu = self.nu_react
        m_react = np.sum(nu * W) - nu[self.fuel_index] * W[self.fuel_index]
        m_tot = np.sum(nu * W)  # total reactant mass incl. fuel
        out = {}
        for i, sp in enumerate(self.gas.species):
            mp = self.nu_prod[i] * W[i]
            if mp > 0 and sp != self.fuel:
                out[sp] = float(mp / m_tot)
        return out

    @property
    def ft_stoich(self) -> float:
        """Stoichiometric mixture fraction: pure-fuel stream vs air stream
        (createFields.H mixture fraction ft; log 0.060344407)."""
        return float(1.0 / (1.0 + self.stoic_ratio))

    def air_composition(self) -> np.ndarray:
        """Y of the oxidiser stream implied by the reaction (O2 + inert)."""
        W = self.gas.W
        nuO2 = self.nu_react[self.o2_index]
        nuN2 = self.nu_react[self.inert_index]
        y = np.zeros(self.gas.n_species)
        mO2 = nuO2 * W[self.o2_index]
        mN2 = nuN2 * W[self.inert_index]
        y[self.o2_index] = mO2 / (mO2 + mN2)
        y[self.inert_index] = mN2 / (mO2 + mN2)
        return y
