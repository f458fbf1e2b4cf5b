"""Gas-phase thermophysics: JANAF polynomials, Sutherland transport,
perfect gas, multi-component mass-weighted mixing, hs↔T inversion.

The OpenFOAM thermo stack of the reference (hePsiThermo<psiReactionThermo,
singleStepReactingMixture<gasHThermoPhysics>>): janafThermo cp/h,
sutherlandTransport mu/kappa (modified Euken), perfectGas psi=1/(R T).
Evaluation is vectorised over cells with Y[nC, nSp]: per-species
polynomials are evaluated against powers of T and mass-weighted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..io.foamdict import FoamDict

__all__ = ["GasThermo", "RU", "T_STD", "P_STD"]

RU = 8314.47  # J/(kmol K) — universal gas constant (OpenFOAM RR value)
T_STD = 298.15
P_STD = 101325.0


def _t(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


@dataclass
class GasThermo:
    """Stacked per-species data + vectorised mixture evaluation."""

    species: List[str]
    W: np.ndarray  # [nSp] molecular weight kg/kmol
    lo: np.ndarray  # JANAF low/high coefficient sets [nSp, 7]
    hi: np.ndarray
    Tcommon: np.ndarray
    Tlow: np.ndarray
    Thigh: np.ndarray
    As: np.ndarray  # [nSp] Sutherland
    Ts: np.ndarray

    @classmethod
    def from_dict(cls, thermo_dict: FoamDict, species: List[str]) -> "GasThermo":
        W, lo, hi, Tc, Tl, Th, As, Ts = [], [], [], [], [], [], [], []
        for sp in species:
            d = thermo_dict.get_dict(sp)
            W.append(d.get_dict("specie").get_scalar("molWeight"))
            td = d.get_dict("thermodynamics")
            lo.append([float(x) for x in td.get_list("lowCpCoeffs")])
            hi.append([float(x) for x in td.get_list("highCpCoeffs")])
            Tc.append(td.get_scalar("Tcommon"))
            Tl.append(td.get_scalar("Tlow"))
            Th.append(td.get_scalar("Thigh"))
            tr = d.get_dict("transport")
            As.append(tr.get_scalar("As"))
            Ts.append(tr.get_scalar("Ts"))
        return cls(
            species=list(species),
            W=np.asarray(W),
            lo=np.asarray(lo),
            hi=np.asarray(hi),
            Tcommon=np.asarray(Tc),
            Tlow=np.asarray(Tl),
            Thigh=np.asarray(Th),
            As=np.asarray(As),
            Ts=np.asarray(Ts),
        )

    @property
    def n_species(self) -> int:
        return len(self.species)

    def index(self, name: str) -> int:
        return self.species.index(name)

    @property
    def R_sp(self) -> np.ndarray:
        """R_specific per species [J/kg/K]."""
        return RU / self.W

    # ---------------------------------------------------------- per-species
    def _coeffs(self, T: torch.Tensor) -> torch.Tensor:
        """Select low/high coefficient set per (cell, species): [nC, nSp, 7]."""
        lo, hi, Tc = _t(self.lo, T), _t(self.hi, T), _t(self.Tcommon, T)
        use_hi = (T[:, None] > Tc[None, :])[..., None]
        return torch.where(use_hi, hi[None], lo[None])

    def cp_species(self, T: torch.Tensor) -> torch.Tensor:
        """cp_i(T) [nC, nSp] in J/(kg K)."""
        a = self._coeffs(T)
        Tp = torch.stack([torch.ones_like(T), T, T**2, T**3, T**4], dim=-1)
        poly = torch.einsum("csk,ck->cs", a[..., :5], Tp)
        return poly * _t(self.R_sp, T)[None, :]

    def ha_species(self, T: torch.Tensor) -> torch.Tensor:
        """Absolute enthalpy (incl. formation) h_i(T) [nC, nSp] J/kg."""
        a = self._coeffs(T)
        Tp = torch.stack([T, T**2 / 2, T**3 / 3, T**4 / 4, T**5 / 5], dim=-1)
        poly = torch.einsum("csk,ck->cs", a[..., :5], Tp) + a[..., 5]
        return poly * _t(self.R_sp, T)[None, :]

    def hc_species(self, like: torch.Tensor) -> torch.Tensor:
        """Chemical (formation) enthalpy h_i(T_std) [nSp] J/kg."""
        return self.ha_species(torch.full((1,), T_STD, dtype=like.dtype, device=like.device))[0]

    def hs_species(self, T: torch.Tensor) -> torch.Tensor:
        """Sensible enthalpy hs_i(T) = ha_i(T) − ha_i(T_std)."""
        return self.ha_species(T) - self.hc_species(T)[None, :]

    # ------------------------------------------------------------- mixture
    def cp(self, T, Y):
        return torch.einsum("cs,cs->c", Y, self.cp_species(T))

    def hs(self, T, Y):
        return torch.einsum("cs,cs->c", Y, self.hs_species(T))

    def ha(self, T, Y):
        return torch.einsum("cs,cs->c", Y, self.ha_species(T))

    def R(self, Y):
        return Y @ _t(self.R_sp, Y)

    def psi(self, T, Y):
        """Compressibility psi = 1/(R T) [s²/m²]: rho = psi·p."""
        return 1.0 / (self.R(Y) * T)

    def rho(self, p, T, Y):
        return self.psi(T, Y) * p

    def mu(self, T, Y):
        """Sutherland viscosity with mass-weighted As/Ts (OpenFOAM mixing)."""
        As = Y @ _t(self.As, Y)
        Ts = Y @ _t(self.Ts, Y)
        return As * torch.sqrt(T) / (1.0 + Ts / T)

    def kappa(self, T, Y):
        """Modified-Euken conductivity: kappa = mu·Cv·(1.32 + 1.77 R/Cv)."""
        mu = self.mu(T, Y)
        R = self.R(Y)
        cv = self.cp(T, Y) - R
        return mu * cv * (1.32 + 1.77 * R / cv)

    def alpha(self, T, Y):
        """Thermal diffusivity alpha = kappa/cp [kg/(m s)] (thermo.alpha())."""
        return self.kappa(T, Y) / self.cp(T, Y)

    def T_from_hs(self, hs, Y, T_guess, n_iter: int = None):
        """Invert hs(T) by Newton iteration (hePsiThermo T solve) from the
        previous T: 8 steps reach f64 roundoff, 5 exceed f32 resolution.
        The per-iteration change is limited to T/2 as OpenFOAM does."""
        if n_iter is None:
            n_iter = 8 if T_guess.dtype == torch.float64 else 5
        T = T_guess
        for _ in range(int(n_iter)):
            f = self.hs(T, Y) - hs
            Tn = T - f / self.cp(T, Y)
            dT = torch.clamp(Tn - T, -T / 2, T / 2)
            T = torch.clamp(T + dT, 100.0, 6000.0)
        return T
