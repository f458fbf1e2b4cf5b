"""WSGGM (weighted-sum-of-grey-gases) grey absorption-emission model.

The reference wsggmAbsorptionEmissionGreySmith (packages/
thermophysicalModels/radiation/submodels/absorptionEmissionModel/
wsggmAbsorptionEmissionGreySmith.C:90-660, Smith/Shen/Friedman 1982
coefficients with the Sikic 2014 extensions) and GreyCassol, evaluated over
every cell (or boundary face) at once:

    pL  = W_mix·(p/1 atm)·(Y_CO2/W_CO2 + Y_H2O/W_H2O)·L
    w_i = Σ_j b_ij·T^j                 (polynomial fits, per T band)
    ε   = Σ_i w_i·(1 − exp(−k_i·pL))
    a   = −ln(1 − min(ε, 0.9999))/L + Csoot·fv·T

Coefficient sets are keyed by the Pw/Pc pressure-ratio regime (2, 1,
0.001 = CO2-only, 1000 = H2O-only, 10 = H2O at 1 atm) and by temperature
band (≤2400 K, ≤2500 K, ≤3000 K; the H2O-only regimes define the low band
only, as the reference does).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..io.foamdict import FoamDict

__all__ = ["WSGGMGreySmith", "WSGGMGreyCassol"]

# emissivityCoeffs[regime][gas] — pressure-absorption coefficients k_i
# [1/(atm·m)]; regimes: 0: Pw/Pc=2, 1: Pw/Pc=1, 2: CO2-only, 3: H2O→0,
# 4: H2O=1atm (wsggmAbsorptionEmissionGreySmith.C:106-140, 215-246)
_K_LOW = np.array(
    [
        [0.4201, 6.516, 131.9],
        [0.4303, 7.055, 178.1],
        [0.3966, 15.64, 394.3],
        [0.4098, 6.325, 120.5],
        [0.4496, 7.113, 119.7],
    ]
)
_K_MID = np.array(
    [
        [0.527, 3.78, 99.54],
        [0.464, 3.47, 121.6],
        [0.3966, 15.64, 394.3],
    ]
)
_K_HIGH = _K_MID.copy()

# fittingFactors[regime][gas][j]: w_i = Σ_j b_ij·T^j with the reference's
# 1/10, 1e-4, 1e-7, 1e-11 scalings applied (GreySmith.C:148-260)
_SCALE = np.array([0.1, 1e-4, 1e-7, 1e-11])
_B_LOW = np.array(
    [
        [[6.508, -5.551, 3.029, -5.353],
         [-0.2504, 6.112, -3.882, 6.528],
         [2.718, -3.118, 1.221, -1.612]],
        [[5.150, -2.303, 0.9779, -1.494],
         [0.7749, 3.399, -2.297, 3.770],
         [1.907, -1.824, 0.5608, -0.5122]],
        [[0.4334, 2.620, -1.560, 2.565],
         [-0.4814, 2.822, -1.794, 3.274],
         [0.5492, 0.1087, -0.3500, 0.9123]],
        [[5.977, -5.119, 3.042, -5.564],
         [0.5677, 3.333, -1.967, 2.718],
         [1.8, -2.334, 1.008, -1.454]],
        [[6.324, -8.358, 6.135, -13.03],
         [-0.2016, 7.145, -5.212, 9.868],
         [3.5, -5.04, 2.425, -3.888]],
    ]
) * _SCALE
# mid/high bands: regimes 0-1 use unscaled linear fits; regime 2 keeps the
# scaled cubic (GreySmith.C:262-352)
_B_MID = np.array(
    [
        [[0.132, 0.0000725, 0.0, 0.0],
         [0.547, -0.000171, 0.0, 0.0],
         [0.0489, -0.0000176, 0.0, 0.0]],
        [[0.136, 0.0000726, 0.0, 0.0],
         [0.516, -0.000163, 0.0, 0.0],
         [0.0517, -0.0000176, 0.0, 0.0]],
        [[0.04334, 2.620e-4, -1.560e-7, 2.565e-11],
         [-0.04814, 2.822e-4, -1.794e-7, 3.274e-11],
         [0.05492, 0.1087e-4, -0.3500e-7, 0.9123e-11]],
    ]
)
_B_HIGH = np.array(
    [
        [[0.430, -0.0000472, 0.0, 0.0],
         [0.37, -0.000101, 0.0, 0.0],
         [0.0184, -0.00000511, 0.0, 0.0]],
        [[0.464, -0.0000596, 0.0, 0.0],
         [0.336, -0.0000909, 0.0, 0.0],
         [0.0245, -0.00000654, 0.0, 0.0]],
        [[0.04334, 2.620e-4, -1.560e-7, 2.565e-11],
         [-0.04814, 2.822e-4, -1.794e-7, 3.274e-11],
         [0.05492, 0.1087e-4, -0.3500e-7, 0.9123e-11]],
    ]
)

_REGIMES = {2.0: 0, 1.0: 1, 0.001: 2, 1000.0: 3, 10.0: 4}


def _pL(T, Y, p, gas, path_length):
    """Partial-pressure path length of CO2 + H2O [atm·m]."""
    W_mix = 8314.47 / gas.R(Y)
    mol = torch.zeros_like(T)
    for sp in ("CO2", "H2O"):
        if sp in gas.species:
            si = gas.index(sp)
            mol = mol + Y[:, si] / gas.W[si]
    return W_mix * (p / 101325.0) * mol * path_length


def _emissivity(Tl, pL, B, K):
    """Σ_i w_i(T)·(1 − exp(−k_i·pL)) for polynomial weights B [nGas, nPow]."""
    B = torch.as_tensor(B, dtype=Tl.dtype, device=Tl.device)
    K = torch.as_tensor(K, dtype=Tl.dtype, device=Tl.device)
    powers = torch.stack([Tl**j for j in range(B.shape[1])], dim=-1)
    w = powers @ B.T  # [n, nGas]
    return torch.sum(w * (1.0 - torch.exp(-K[None, :] * pL[:, None])), dim=-1)


def _path_length(coeffs: FoamDict) -> float:
    pl = coeffs.lookup("pathLength")
    return float(pl[-1] if isinstance(pl, list) else pl)  # dimensionedScalar: value last


@dataclass
class WSGGMGreySmith:
    path_length: float
    regime: int  # index into the coefficient tables
    c_soot: float

    @classmethod
    def from_coeffs(cls, coeffs: FoamDict) -> "WSGGMGreySmith":
        ratio = float(coeffs.get_scalar("Pw_div_Pc", 2.0))
        if ratio not in _REGIMES:
            raise ValueError(f"WSGGM GreySmith: unsupported Pw_div_Pc {ratio}")
        return cls(path_length=_path_length(coeffs), regime=_REGIMES[ratio],
                   c_soot=coeffs.get_scalar("Csoot", 0.0))

    def a(self, T, Y, p, gas, fv: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Grey absorption coefficient [1/m] over cells or faces."""
        pL = _pL(T, Y, p, gas, self.path_length)
        Tl = torch.clamp(T, max=3000.0)
        r = self.regime
        e_low = _emissivity(Tl, pL, _B_LOW[r], _K_LOW[r])
        if r <= 2:
            e_mid = _emissivity(Tl, pL, _B_MID[r], _K_MID[r])
            e_high = _emissivity(Tl, pL, _B_HIGH[r], _K_HIGH[r])
            e = torch.where(Tl <= 2400.0, e_low, torch.where(Tl <= 2500.0, e_mid, e_high))
        else:
            # the H2O-only regimes define the low band only (GreySmith.C:610-647)
            e = e_low
        a = -torch.log1p(-torch.clamp(e, 0.0, 0.9999)) / self.path_length
        if fv is not None and self.c_soot != 0.0:
            a = a + self.c_soot * fv * Tl
        return a


# ---------------------------------------------------------------------------
# GreyCassol: 4 grey gases, Cassol et al. 2014 coefficients
# (wsggmAbsorptionEmissionGreyCassol.C:104-230; regimes 0: Pw/Pc=2 mixture,
# 1: H2O only, 2: CO2 only — selected by Pw_div_Pc 2/1/0).
# The shipped reference applies the fitting factors UNscaled; the published
# Cassol table carries 1e-5/1e-8/1e-11/1e-15 scalings on the T^1..T^4
# coefficients (the banded variant in the same repo applies exactly these),
# so we use the published scalings.
# ---------------------------------------------------------------------------

_CASSOL_K = np.array(
    [
        [0.192, 1.719, 11.37, 111.016],
        [0.171, 1.551, 5.562, 49.159],
        [0.138, 1.895, 13.301, 340.811],
    ]
)
_CASSOL_SCALE = np.array([1.0, 1e-5, 1e-8, 1e-11, 1e-15])
_CASSOL_B = (
    np.array(
        [
            [
                [0.05617, 78.44, -85.63, 42.46, -74.4],
                [0.1426, 17.95, -1.077, -6.971, 17.74],
                [0.1362, 25.74, -37.11, 15.7, -22.67],
                [0.1222, -2.327, -7.492, 4.275, -6.608],
            ],
            [
                [0.06617, 55.48, -48.41, 22.27, -40.17],
                [0.11045, 0.576, 24.0, -17.01, 30.96],
                [-0.04915, 70.63, -70.12, 26.07, -34.94],
                [0.23675, -18.91, -0.907, 4.082, -8.778],
            ],
            [
                [0.0999, 64.41, -86.94, 41.27, -67.74],
                [0.00942, 10.36, -2.277, -2.134, 6.497],
                [0.14511, -30.73, 37.65, -18.41, 30.16],
                [-0.02915, 25.23, -26.1, 9.965, -13.26],
            ],
        ]
    )
    * _CASSOL_SCALE
)

_CASSOL_REGIMES = {2.0: 0, 1.0: 1, 0.0: 2}


@dataclass
class WSGGMGreyCassol:
    """Grey-lumped Cassol WSGG (wsggmAbsorptionEmissionGreyCassol.C):
    ε = Σ_i w_i(T)·(1 − e^{−k_i·pL}), a = −ln(1−ε)/L (+ soot)."""

    path_length: float
    regime: int
    c_soot: float

    @classmethod
    def from_coeffs(cls, coeffs: FoamDict) -> "WSGGMGreyCassol":
        ratio = float(coeffs.get_scalar("Pw_div_Pc", 2.0))
        if ratio not in _CASSOL_REGIMES:
            raise ValueError(f"WSGGM GreyCassol: unsupported Pw_div_Pc {ratio}")
        csv = coeffs.lookup("Csoot", 0.0)
        return cls(path_length=_path_length(coeffs), regime=_CASSOL_REGIMES[ratio],
                   c_soot=float(csv[-1] if isinstance(csv, list) else csv))

    def a(self, T, Y, p, gas, fv: Optional[torch.Tensor] = None) -> torch.Tensor:
        pL = _pL(T, Y, p, gas, self.path_length)
        Tl = torch.clamp(T, max=3000.0)  # no data above (GreyCassol.C:104)
        e = _emissivity(Tl, pL, _CASSOL_B[self.regime], _CASSOL_K[self.regime])
        a = -torch.log1p(-torch.clamp(e, 0.0, 0.9999)) / self.path_length
        if fv is not None and self.c_soot != 0.0:
            a = a + self.c_soot * fv * Tl
        return a
