"""Liquid property correlations for Lagrangian droplets (H2O sprays).

The port of firefoam_tpu/lagrangian/liquids.py: the slice of OpenFOAM's
liquidProperties used by the reference's reacting spray clouds (SLGThermo liquid side — reference
solver/createFields.H:16; droplet composition is pure H2O per
cases/steckler/constant/reactingCloud1Properties singlePhaseMixtureCoeffs).

All correlations are standard NSRDS/DIPPR forms over temperature, evaluated
as closed-form elementwise tensor math (no table lookups). Validity clamped
to [Tlow, Thigh] to keep the physics NaN-free when masked-out (dead)
parcels carry garbage temperatures. Temperatures are tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import small

__all__ = [
    "Liquid", "H2O", "C7H16", "C2H5OH", "LiquidMixture", "liquid_by_name",
]


@dataclass(frozen=True)
class Liquid:
    """One liquid species: NSRDS-correlation property set."""

    name: str
    W: float  # molecular weight [kg/kmol]
    Tc: float  # critical temperature [K]
    Pc: float  # critical pressure [Pa]
    Tlow: float
    Thigh: float

    # NSRDS5 density: rho = a / b^(1 + (1 - T/c)^d)
    rho_c: tuple
    # NSRDS1 vapour pressure: pv = exp(a + b/T + c ln T + d T^e)
    pv_c: tuple
    # NSRDS6 latent heat: hl = a (1 - Tr)^(b + c Tr + d Tr^2 + e Tr^3)
    hl_c: tuple
    # NSRDS0 liquid Cp: polynomial in T
    cp_c: tuple
    # NSRDS1 dynamic viscosity: mu = exp(a + b/T + c ln T + d T^e)
    mu_c: tuple
    # NSRDS0 thermal conductivity: polynomial in T
    kappa_c: tuple
    # NSRDS6 surface tension: sigma = a (1 - Tr)^(b + c Tr + d Tr^2 + e Tr^3)
    sigma_c: tuple
    # Fuller diffusion volume of the vapour
    diff_Vm: float = 12.7

    def _clamp(self, T):
        return torch.clamp(T, self.Tlow, self.Thigh)

    def rho(self, p, T):
        a, b, c, d = self.rho_c
        T = self._clamp(T)
        return a / b ** (1.0 + (1.0 - T / c) ** d)

    def pv(self, p, T):
        a, b, c, d, e = self.pv_c
        T = self._clamp(T)
        return torch.exp(a + b / T + c * torch.log(T) + d * T**e)

    def hl(self, p, T):
        a, b, c, d, e = self.hl_c
        T = self._clamp(T)
        Tr = T / self.Tc
        return a * (1.0 - Tr) ** (b + Tr * (c + Tr * (d + Tr * e)))

    def cp(self, p, T):
        T = self._clamp(T)
        out = 0.0
        for coef in reversed(self.cp_c):
            out = out * T + coef
        return out

    def mu(self, p, T):
        a, b, c, d, e = self.mu_c
        T = self._clamp(T)
        return torch.exp(a + b / T + c * torch.log(T) + d * T**e)

    def kappa(self, p, T):
        T = self._clamp(T)
        out = 0.0
        for coef in reversed(self.kappa_c):
            out = out * T + coef
        return out

    def sigma(self, p, T):
        a, b, c, d, e = self.sigma_c
        T = self._clamp(T)
        Tr = T / self.Tc
        return a * (1.0 - Tr) ** (b + Tr * (c + Tr * (d + Tr * e)))

    def D(self, p, T, Wb: float = 28.96):
        """Vapour diffusivity in air [m2/s] — Fuller correlation with
        diffusion volumes (self.diff_Vm for the vapour, 20.1 for air)."""
        T = self._clamp(T)
        alpha = np.sqrt(1.0 / self.W + 1.0 / Wb)
        beta = (self.diff_Vm ** (1.0 / 3.0) + 20.1 ** (1.0 / 3.0)) ** 2
        return 1.013e-2 * T**1.75 * alpha / (p * beta)

    def h(self, p, T, Tref: float = 298.15):
        """Liquid sensible enthalpy relative to Tref via Cp quadrature
        (analytic integral of the Cp polynomial)."""
        T = self._clamp(T)

        def anti(Tv):
            out = 0.0
            for k, coef in enumerate(self.cp_c):
                out = out + coef * Tv ** (k + 1) / (k + 1)
            return out

        return anti(T) - anti(torch.full_like(T, Tref))


# Water — NSRDS/DIPPR correlation coefficients (public property-database
# constants; sanity-validated in tests: rho(298)≈997, pv(373)≈1 atm,
# hl(373)≈2.26e6, cp(298)≈4183, mu(298)≈8.9e-4, kappa(298)≈0.61,
# sigma(298)≈0.072).
H2O = Liquid(
    name="H2O",
    W=18.015,
    Tc=647.13,
    Pc=2.2055e7,
    Tlow=273.16,
    Thigh=643.0,
    rho_c=(98.343885, 0.30542, 647.13, 0.081),
    pv_c=(73.649, -7258.2, -7.3037, 4.1653e-6, 2.0),
    hl_c=(2889425.47876769, 0.3199, -0.212, 0.25795, 0.0),
    cp_c=(
        15341.1046350264,
        -116.019983347211,
        0.451013044684985,
        -0.000783569247849015,
        5.20127671384957e-07,
    ),
    mu_c=(-51.964, 3670.6, 5.7331, -5.349e-29, 10.0),
    kappa_c=(-0.4267, 0.0056903, -8.0065e-06, 1.815e-09),
    sigma_c=(0.18548, 2.717, -3.554, 2.047, 0.0),
)


# n-heptane and ethanol: standard DIPPR-form correlation fits (published
# property data; the reference's liquidProperties C7H16/C2H5OH analogues)
C7H16 = Liquid(
    name="C7H16",
    W=100.204,
    Tc=540.2,
    Pc=2.74e6,
    Tlow=182.57,
    Thigh=535.0,
    rho_c=(61.38045, 0.26211, 540.2, 0.28141),
    pv_c=(87.829, -6996.4, -9.8802, 7.2099e-6, 2.0),
    hl_c=(500140.0, 0.38795, 0.0, 0.0, 0.0),
    cp_c=(612.0, 5.47, 0.0, 0.0, 0.0),
    mu_c=(-24.451, 1533.1, 2.0087, 0.0, 1.0),
    kappa_c=(0.215, -3.07e-4, 0.0, 0.0),
    sigma_c=(0.054143, 1.2512, 0.0, 0.0, 0.0),
    diff_Vm=153.5,
)

C2H5OH = Liquid(
    name="C2H5OH",
    W=46.069,
    Tc=513.92,
    Pc=6.137e6,
    Tlow=159.05,
    Thigh=508.0,
    rho_c=(68.4, 0.26, 513.92, 0.2367),
    pv_c=(74.475, -7164.3, -7.327, 3.1340e-6, 2.0),
    hl_c=(1334000.0, 0.4, 0.0, 0.0, 0.0),
    cp_c=(1280.0, 3.9, 0.0, 0.0, 0.0),
    mu_c=(7.875, 781.98, -3.0418, 0.0, 1.0),
    kappa_c=(0.253, -2.8e-4, 0.0, 0.0),
    sigma_c=(0.0626, 1.2, 0.0, 0.0, 0.0),
    diff_Vm=50.36,
)

_LIQUIDS = {"H2O": H2O, "C7H16": C7H16, "C2H5OH": C2H5OH}


def liquid_by_name(name: str) -> Liquid:
    try:
        return _LIQUIDS[name]
    except KeyError:
        raise NotImplementedError(
            f"liquid '{name}' not implemented (available: {sorted(_LIQUIDS)})"
        )


class LiquidMixture:
    """SingleMixtureFraction liquid phase, frozen-composition subset.

    Reference: submodels/Reacting/CompositionModel/SingleMixtureFraction —
    parcels carry one mixture fraction over (gas, liquid, solid) phases with
    fixed RELATIVE composition inside each phase. Here the liquid-phase
    composition is that fixed vector: bulk properties are mass-fraction
    weighted and the evaporated vapour is split across components by
    Raoult-weighted volatility Y_i·pv_i(T). (Per-parcel preferential-
    evaporation drift of the composition vector is not tracked — the
    reference's single-mixture-fraction parcels don't track it either;
    only multi-fraction clouds do.)
    """

    def __init__(self, names, fracs):
        self.components = [liquid_by_name(n) for n in names]
        Y = np.asarray(fracs, float)
        self.Y = Y / Y.sum()
        self.name = "+".join(names)
        self.W = float(1.0 / (self.Y / np.asarray([l.W for l in self.components])).sum())

    def _wsum(self, fn, *args):
        return sum(
            y * getattr(l, fn)(*args) for y, l in zip(self.Y, self.components)
        )

    def rho(self, p, T):
        # volume-additive mixture: 1/ρ = Σ Y_i/ρ_i
        inv = sum(
            y / l.rho(p, T) for y, l in zip(self.Y, self.components)
        )
        return 1.0 / inv

    def cp(self, p, T):
        return self._wsum("cp", p, T)

    def hl(self, p, T):
        return self._wsum("hl", p, T)

    def mu(self, p, T):
        return self._wsum("mu", p, T)

    def kappa(self, p, T):
        return self._wsum("kappa", p, T)

    def sigma(self, p, T):
        return self._wsum("sigma", p, T)

    def h(self, p, T, Tref: float = 298.15):
        return self._wsum("h", p, T, Tref)

    def pv(self, p, T):
        # Raoult: p_mix = Σ x_i·pv_i (mole-fraction weighted)
        xs = self.mole_fractions()
        return sum(
            x * l.pv(p, T) for x, l in zip(xs, self.components)
        )

    def D(self, p, T, Wb: float = 28.96):
        return self._wsum("D", p, T, Wb)

    def mole_fractions(self):
        n = self.Y / np.asarray([l.W for l in self.components])
        return n / n.sum()

    def vapour_split(self, T):
        """Mass split of evaporated vapour over components ∝ x_i·pv_i·W_i."""
        xs = self.mole_fractions()
        w = torch.stack(
            [
                x * l.pv(101325.0, T) * l.W
                for x, l in zip(xs, self.components)
            ]
        )
        return w / torch.clamp(w.sum(0), min=small(w.dtype))

    # ---- per-parcel composition support (ReactingParcel Y_ lanes) ----
    # The reference's reacting parcels carry a per-parcel liquid mass-
    # fraction vector and LiquidEvaporation(Boil) evaporates each
    # component against its OWN vapour pressure/diffusivity
    # (ReactingParcel.C:389-607, LiquidEvaporation.C calculate); these
    # stacked evaluators give the cloud that path with [N, K] lanes.

    def comp_W(self):
        return [l.W for l in self.components]

    def comp_pv(self, p, T):
        """[N, K] per-component saturation pressure at (p, T)."""
        return torch.stack([l.pv(p, T) for l in self.components], dim=-1)

    def comp_D(self, p, T, Wb: float = 28.96):
        return torch.stack(
            [l.D(p, T, Wb) for l in self.components], axis=-1
        )

    def comp_hl(self, p, T):
        return torch.stack([l.hl(p, T) for l in self.components], dim=-1)

    def rho_Y(self, p, T, Y):
        """Volume-additive density with per-parcel mass fractions [N, K]."""
        rhos = torch.stack(
            [l.rho(p, T) for l in self.components], axis=-1
        )
        return 1.0 / torch.clamp(torch.sum(Y / rhos, dim=-1), min=small(Y.dtype))

    def cp_Y(self, p, T, Y):
        cps = torch.stack([l.cp(p, T) for l in self.components], dim=-1)
        return torch.sum(Y * cps, dim=-1)

    def x_Y(self, Y):
        """Per-parcel liquid mole fractions from mass fractions [N, K]."""
        n = torch.stack([Y[..., i] / l.W for i, l in enumerate(self.components)], dim=-1)
        return n / torch.clamp(torch.sum(n, dim=-1, keepdim=True), min=small(Y.dtype))
