"""mixtureFractionSoot: state-relation soot model.

The reference mixtureFractionSoot (packages/thermophysicalModels/radiation/
submodels/sootModel/mixtureFractionSoot/mixtureFractionSoot.C:76-155): a
prescribed soot yield nuSoot is appended to the single-step reaction's
product stoichiometry; the soot mass fraction is a linear state relation on
a product mass-fraction mapping field,

    sootMax = X_soot·W_soot / W_m      (mole-fraction-weighted product mix)
    soot    = sootMax · Y_map / Y_map,max

where Y_map,max is the complete-combustion product concentration (Yprod0).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.foamdict import FoamDict
from ..thermo import SingleStepReaction

__all__ = ["MixtureFractionSoot", "make_soot_model"]


@dataclass
class MixtureFractionSoot:
    soot_max: float
    map_index: int  # species index of the mapping field
    map_max: float  # Yprod0 of the mapping field

    @classmethod
    def from_case_dict(cls, coeffs: FoamDict, reaction: SingleStepReaction) -> "MixtureFractionSoot":
        nu_soot = coeffs.get_scalar("nuSoot", 0.055)
        w_soot = coeffs.get_scalar("Wsoot", 12.0)
        mapping = str(coeffs.lookup("mappingField", "none"))

        nu_p = reaction.nu_prod / reaction.nu_react[reaction.fuel_index]
        prod_idx = [i for i in range(len(nu_p)) if nu_p[i] > 0]
        total_mol = float(np.sum(np.abs(nu_p[prod_idx]))) + nu_soot
        W = np.asarray(reaction.gas.W)
        Xi = np.abs(nu_p[prod_idx]) / total_mol
        Wm = float(np.sum(Xi * W[prod_idx]))
        x_soot = nu_soot / total_mol
        Wm += x_soot * w_soot
        soot_max = x_soot * w_soot / Wm

        if mapping == "none":
            names = [reaction.gas.species[i] for i in prod_idx]
            mapping = "CO2" if "CO2" in names else names[0]
        return cls(soot_max=soot_max, map_index=reaction.gas.index(mapping),
                   map_max=reaction.max_products()[mapping])

    def soot(self, Y: torch.Tensor) -> torch.Tensor:
        """Soot mass fraction from the mapping-field state relation."""
        return self.soot_max * Y[:, self.map_index] / self.map_max


def make_soot_model(rp: FoamDict, reaction: SingleStepReaction):
    """sootModel::New — from radiationProperties 'sootModel'
    ('mixtureFractionSoot<gasHThermoPhysics>' in case dicts; 'none' by
    default)."""
    name = str(rp.lookup("sootModel", "none"))
    if name.startswith("mixtureFractionSoot"):
        coeffs = rp.get_dict("mixtureFractionSootCoeffs", FoamDict())
        return MixtureFractionSoot.from_case_dict(coeffs, reaction)
    return None
