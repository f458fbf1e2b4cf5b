"""spSootRadFracEmission — flamelet-table soot radiant fraction
(lib/thermophysicalModels/radiation/submodels/absorptionEmissionModel/
spSootRadFracEmission/spSootRadFracEmission.C).

The emitted power is E = PsiR·Qdot with PsiR interpolated from a 3-D lookup
table over (strain rate, prior enthalpy loss, oxidiser mass fraction). The
table ships as an OpenFOAM dictionary in constant/ (tableName in the coeffs'
lookupTableCoeffs subdict) with `SR`, `Hp` lists and an `oxyMassFracs`
subdict of {oxyMassFrac, PsiR[nSR·nHp]} tables. Inputs per computeQr():

    strainRate = Cη·√(ε·ρ/(μ+1e-9)),   Cη = Ceta0·1e-3/Ck
    Ft         = clip((Y_fu·s − Y_O2 + YO2∞)/(s + YO2∞), 0, 1)
    priorLoss  = (hs + hc − Ft·hc_fu − Y_O2·hc_O2 − Y_N2·hc_N2)
                 / (hc − Ft·hc_fu + 10 − Y_O2·hc_O2 − Y_N2·hc_N2)

with clamped bilinear interpolation in (SR, Hp) and linear blending between
the bracketing oxidiser tables (the default globalYO2 uses the far-field
YO2∞ for the oxidiser axis).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["SpSootRadFrac"]


class SpSootRadFrac:
    def __init__(self, sr, hp, oxy_fracs, tables, fuel, ceta, yo2_inf, global_yo2=True):
        self.sr = np.asarray(sr, float)
        self.hp = np.asarray(hp, float)
        # the oxidiser axis is stored descending in the reference tables
        self.oxy = np.asarray(oxy_fracs, float)
        self.tables = np.asarray(tables, float).reshape(len(oxy_fracs), len(self.sr), len(self.hp))
        self.fuel = fuel
        self.ceta = float(ceta)
        self.yo2_inf = float(yo2_inf)
        self.global_yo2 = bool(global_yo2)

    @classmethod
    def from_case(cls, case, coeffs, turb_ck=0.094) -> Optional["SpSootRadFrac"]:
        lt = coeffs.get_dict("lookupTableCoeffs", None)
        if lt is None:
            return None
        name = lt.get_word("tableName", "")
        if not name or not case.has_constant(name):
            return None
        d = case.constant(name)
        fracs, tables = [], []
        for _, sub in d.get_dict("oxyMassFracs").subdicts():
            fracs.append(sub.get_scalar("oxyMassFrac"))
            tables.append([float(x) for x in sub.get_list("PsiR")])
        return cls(
            [float(x) for x in d.get_list("SR")], [float(x) for x in d.get_list("Hp")],
            fracs, tables,
            fuel=str(d.get_word("fuel", "")),
            ceta=coeffs.get_scalar("Ceta0", 4.0) * 1e-3 / (turb_ck + 1e-20),
            yo2_inf=coeffs.get_scalar("YO2Inf", 0.23301),
            global_yo2=coeffs.get_bool("globalYO2", True),
        )

    def psi_r(self, state, gas, reaction, epsilon) -> torch.Tensor:
        """PsiR per cell (computeQr)."""
        Y = state["Y"].i
        rho, mu, hs = state["rho"].i, state["mu"].i, state["hs"].i
        kw = dict(dtype=Y.dtype, device=Y.device)
        fi = reaction.fuel_index
        iO2, iN2 = gas.index("O2"), gas.index("N2")
        hc_sp = gas.hc_species(Y)
        s = float(reaction.s)

        strain = self.ceta * torch.sqrt(epsilon * rho / (mu + 1e-9))
        ft = torch.clamp((Y[:, fi] * s - Y[:, iO2] + self.yo2_inf) / (s + self.yo2_inf), 0.0, 1.0)
        hc = Y @ hc_sp
        correct_hc = Y[:, iO2] * hc_sp[iO2] + Y[:, iN2] * hc_sp[iN2]
        prior = (hs + hc - ft * hc_sp[fi] - correct_hc) / (hc - ft * hc_sp[fi] + 10.0 - correct_hc)
        prior = torch.where(ft < 1e-6, torch.full_like(prior, 1e3), prior)
        # an out-of-range priorLoss folds to 0 after the reference's final
        # sanity clip: the [−1, 1] reset
        prior = torch.where((prior >= 1.0) | (prior <= -1.0), torch.zeros_like(prior), prior)

        sr = torch.as_tensor(self.sr, **kw)
        hp = torch.as_tensor(self.hp, **kw)
        strain = torch.clamp(strain, sr[0], sr[-1])
        pl = torch.clamp(prior, hp[0], hp[-1])
        i1 = torch.clamp(torch.searchsorted(sr, strain, right=True) - 1, 0, len(self.sr) - 2)
        j1 = torch.clamp(torch.searchsorted(hp, pl, right=True) - 1, 0, len(self.hp) - 2)
        wi = (strain - sr[i1]) / (sr[i1 + 1] - sr[i1])
        wj = (pl - hp[j1]) / (hp[j1 + 1] - hp[j1])

        def bilinear(tab):
            t = torch.as_tensor(tab, **kw)
            return ((1 - wi) * (1 - wj) * t[i1, j1] + wi * (1 - wj) * t[i1 + 1, j1]
                    + (1 - wi) * wj * t[i1, j1 + 1] + wi * wj * t[i1 + 1, j1 + 1])

        yox = torch.full_like(strain, self.yo2_inf) if self.global_yo2 else Y[:, iO2]
        # the oxidiser tables are ordered by DESCENDING mass fraction
        oxy = self.oxy
        psi = torch.zeros_like(strain)
        for k in range(len(oxy) - 1):
            hi, lo = oxy[k], oxy[k + 1]
            in_band = (yox < hi) & (yox >= lo)
            w = (yox - lo) / (hi - lo)
            val = w * bilinear(self.tables[k]) + (1 - w) * bilinear(self.tables[k + 1])
            psi = torch.where(in_band, val, psi)
        psi = torch.where(yox == oxy[0], bilinear(self.tables[0]), psi)
        # outside the tabulated oxidiser range: no soot radiation
        zero = torch.zeros_like(psi)
        psi = torch.where((yox > oxy[0]) | (yox < oxy[-1]), zero, psi)
        return torch.clamp(torch.where((psi < 0.0) | (psi > 1.0), zero, psi), 0.0, 1.0)
