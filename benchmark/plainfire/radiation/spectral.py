"""Spectral (multi-band) absorption/emission models for fvDOM.

The non-grey slice of the reference absorption-emission model family
(packages/thermophysicalModels/radiation/submodels/absorptionEmissionModel,
lib/thermophysicalModels/radiation/submodels/absorptionEmissionModel):

  * wideBandAbsorptionEmission        — per-band species T-polynomials,
    banded radiant-fraction emission (aCont/ECont; bandLimits + EhrrCoeff
    per band subdict)
  * wsggmAbsorptionEmissionSmithBand  — WSGG banded: per-band k·p_mix
    absorption + T-polynomial weights, last band weight = 1 − Σ
  * wsggmAbsorptionEmissionCassolBand — same structure, Cassol scalings
  * wsggmAbsorptionEmissionJohanssonBand — k = (b0+b1·MR)·(pH2O+pCO2),
    weights quadratic in MR and T/1200
  * constRadFracWideBandEmission      — transparent gas, banded χ·Qdot
    emission split by blackbody fractions at a fixed radiation temperature
  * binaryAbsorptionEmission          — sum of two submodels
  * greyMeanSolidAbsorptionEmission   — volume-fraction-weighted solid
    absorptivity/emissivity

All band models present one interface consumed by FvDOM:

  n_lambda                              number of bands
  eval(T, Tb, Y, Yb, p, pb, gas, Qdot, chi) ->
      dict(a [nL,nC], a_b [nL,nB], E [nL,nC], enFrac [nL,nC],
           enFrac_b [nL,nB])

where enFrac is the banded blackbody energy fraction used by the RTE
emission term and the banded diffusive wall BC.

The blackbody band fraction f(λT) is evaluated with the convergent series
for the fractional blackbody emissive power (15/π⁴·Σ e^{-nx}(x³+3x²/n+
6x/n²+6/n³), x = C2/λT) instead of the reference's lookup table
(blackBodyEmission.C:48-180), which tabulates the same function.

Known deviation, kept from the JAX package this port is held against: the
reference GreyCassol / CassolBand fitting factors are applied unscaled in
the shipped grey code (the published Cassol-2014 coefficients carry
1e-5/1e-8/1e-11/1e-15 scalings, which the banded variant applies); the
published scalings are used consistently for both.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.foamdict import FoamDict

__all__ = [
    "blackbody_fraction",
    "band_fractions",
    "WideBandAE",
    "WSGGBandAE",
    "ConstRadFracWideBandAE",
    "BinaryAE",
    "GreyMeanSolidAE",
    "parse_band_coeffs",
]

_C2 = 14387.7687750563  # Planck second radiation constant [µm·K]


def blackbody_fraction(lam_T):
    """Fractional blackbody emissive power f(0→λT), λT in [µm·K].

    Series form of the function the reference tabulates in
    blackBodyEmission.C:37-180 (error < 1e-10 with 10 terms)."""
    if not torch.is_tensor(lam_T):
        lam_T = torch.as_tensor(lam_T, dtype=torch.float64)
    x = _C2 / torch.clamp(lam_T, min=1e-8)
    out = torch.zeros_like(x)
    for n in range(1, 11):
        xn = n * x
        out = out + torch.exp(-xn) / n * (x**3 + 3.0 * x**2 / n + 6.0 * x / n**2 + 6.0 / n**3)
    series = out * (15.0 / np.pi**4)
    # the series' truncation error grows as x→0 (λT→∞); the Taylor
    # expansion of 1 − (15/π⁴)∫₀ˣ t³/(eᵗ−1)dt takes over there
    near = 1.0 - (15.0 / np.pi**4) * (x**3 / 3.0 - x**4 / 8.0 + x**5 / 60.0 - x**7 / 5040.0)
    return torch.clamp(torch.where(x < 0.7, near, series), 0.0, 1.0)


def band_fractions(bands, T):
    """Banded blackbody fractions f(λ1T→λ2T) for each band [nL, ...].

    bands: [nL, 2] wavelength limits in metres; a (1,1) band means grey
    (fraction 1 — blackBodyEmission.C:224-229 `band == one` branch)."""
    fr = []
    for lo, hi in bands:
        if lo == 1.0 and hi == 1.0:
            fr.append(torch.ones_like(T))
        else:
            fr.append(blackbody_fraction(hi * 1e6 * T) - blackbody_fraction(lo * 1e6 * T))
    return torch.stack(fr)


# ---------------------------------------------------------------------------
# absorptionCoeffs: the 6-coefficient lo/hi T-polynomial bundle used by
# wideBand and the banded WSGG models (absorptionCoeffs.H)
# ---------------------------------------------------------------------------


def parse_band_coeffs(sd: FoamDict):
    """(Tcommon, invTemp, lo[6], hi[6], Tlow, Thigh) from a species dict."""
    return (
        sd.get_scalar("Tcommon", 300.0),
        sd.get_bool("invTemp", False),
        tuple(float(x) for x in sd.get_list("loTcoeffs")),
        tuple(float(x) for x in sd.get_list("hiTcoeffs")),
        sd.get_scalar("Tlow", 200.0),
        sd.get_scalar("Thigh", 2500.0),
    )


def _poly_coeffs(T, Tcommon, invTemp, lo, hi, Tlow, Thigh):
    """Evaluate the lo/hi polynomial bundle at T (clipped to [Tlow,Thigh])."""
    Tc = torch.clamp(T, Tlow, Thigh)
    Tx = (1.0 / Tc) if invTemp else Tc

    def ev(cs):
        out = torch.zeros_like(Tx)
        for k, c in enumerate(cs):
            out = out + c * Tx**k
        return out

    return torch.where(Tc < Tcommon, ev(lo), ev(hi))


def _coeff_select(T, Tcommon, lo, hi, k):
    """Pick coefficient k of the lo/hi arrays by temperature."""
    c_lo = lo[k] if k < len(lo) else 0.0
    c_hi = hi[k] if k < len(hi) else 0.0
    return torch.where(T < Tcommon, torch.full_like(T, c_lo), torch.full_like(T, c_hi))


def _mole_pressures(T, Y, p, gas):
    """X_CO2·p and X_H2O·p [atm]."""
    W_mix = 8314.47 / gas.R(Y)
    p_atm = p / 101325.0

    def xp(name):
        if name not in gas.species:
            return torch.zeros_like(T)
        si = gas.index(name)
        return Y[:, si] * W_mix / gas.W[si] * p_atm

    return xp("CO2"), xp("H2O")


# ---------------------------------------------------------------------------
# wideBandAbsorptionEmission
# ---------------------------------------------------------------------------


@dataclass
class WideBandAE:
    """wideBandAbsorptionEmission.C: per-band per-species 6-coeff polynomial
    absorption in X_i·p [atm], banded emission E_b = Ehrr_b·Qdot·Δλ_b/Σλ."""

    bands: tuple  # ((lo, hi) [m], ...)
    ehrr: tuple  # per-band EhrrCoeff
    species: tuple  # species names, one order across bands
    coeffs: tuple  # coeffs[band][spec] = bundle

    @property
    def n_lambda(self) -> int:
        return len(self.bands)

    @classmethod
    def from_coeffs(cls, aec: FoamDict) -> "WideBandAE":
        bands, ehrr, names, coeffs = [], [], [], []
        for _, bd in aec.subdicts():
            lim = bd.get_list("bandLimits")
            bands.append((float(lim[0]), float(lim[1])))
            ehrr.append(bd.get_scalar("EhrrCoeff", 0.0))
            sp = bd.get_dict("species", FoamDict())
            row = []
            for sname, sd in sp.subdicts():
                if len(bands) == 1:
                    names.append(sname)
                row.append(parse_band_coeffs(sd))
            coeffs.append(tuple(row))
        return cls(bands=tuple(bands), ehrr=tuple(ehrr), species=tuple(names),
                   coeffs=tuple(coeffs))

    def _a_band(self, b, T, Y, p, gas):
        W_mix = 8314.47 / gas.R(Y)
        p_atm = p / 101325.0
        a = torch.zeros_like(T)
        for n, name in enumerate(self.species):
            if name not in gas.species:
                continue  # an unsolved specie without a lookup table
            si = gas.index(name)
            # moles × p [atm]: X_i·p_atm for a transported specie
            w = Y[:, si] * W_mix / gas.W[si] * p_atm
            a = a + w * _poly_coeffs(T, *self.coeffs[b][n])
        return torch.clamp(a, min=0.0)

    def eval(self, T, Tb, Y, Yb, p, pb, gas, Qdot, chi):
        total = sum(hi - lo for lo, hi in self.bands)
        nL = self.n_lambda
        return {
            "a": torch.stack([self._a_band(b, T, Y, p, gas) for b in range(nL)]),
            "a_b": torch.stack([self._a_band(b, Tb, Yb, pb, gas) for b in range(nL)]),
            "E": torch.stack([self.ehrr[b] * Qdot * (self.bands[b][1] - self.bands[b][0]) / total
                              for b in range(nL)]),
            "enFrac": band_fractions(self.bands, T),
            "enFrac_b": band_fractions(self.bands, Tb),
        }


# ---------------------------------------------------------------------------
# WSGG banded family (Smith / Cassol / Johansson)
# ---------------------------------------------------------------------------

# weight polynomial scalings by variant: w = Σ_j b[j+1]·T^j·scale[j]
_W_SCALE = {
    "smith": (1e-1, 1e-4, 1e-7, 1e-11),
    "cassol": (1e-0, 1e-5, 1e-8, 1e-11, 1e-15),
}


@dataclass
class WSGGBandAE:
    """Banded WSGG: each band is one grey gas; enFrac = the WSGG weight
    (wsggmAbsorptionEmission{Smith,Cassol,Johansson}Band.C ggCoeff), the
    last band's weight = 1 − w(poly) (transparent-windows gas)."""

    variant: str  # smith | cassol | johansson
    coeffs: tuple  # coeffs[band][spec] = bundle
    n_species: int
    c_soot: float
    n_bands: int = 0

    @property
    def n_lambda(self) -> int:
        return self.n_bands

    @classmethod
    def from_coeffs(cls, aec: FoamDict, variant: str) -> "WSGGBandAE":
        coeffs = []
        nsp = 0
        for _, bd in aec.subdicts():
            if not bd.found("species"):
                continue
            row = [parse_band_coeffs(sd) for _, sd in bd.get_dict("species").subdicts()]
            nsp = len(row)
            coeffs.append(tuple(row))
        csv = aec.lookup("Csoot", 0.0)
        return cls(variant=variant, coeffs=tuple(coeffs), n_species=nsp,
                   c_soot=float(csv[-1] if isinstance(csv, list) else csv),
                   n_bands=len(coeffs))

    def _band_coeff(self, b, T, k):
        """Coefficient k of band b's bundle at T."""
        # the reference loops over the species but overwrites a/w on every
        # pass: the LAST species entry wins
        Tcommon, _, lo, hi, Tlow, Thigh = self.coeffs[b][-1]
        return _coeff_select(torch.clamp(T, Tlow, Thigh), Tcommon, lo, hi, k)

    def _weights(self, b, T):
        w = torch.zeros_like(T)
        for j, s in enumerate(_W_SCALE[self.variant]):
            w = w + self._band_coeff(b, T, j + 1) * T**j * s
        return w

    def eval(self, T, Tb, Y, Yb, p, pb, gas, Qdot, chi):
        nL = self.n_bands

        def per(Tx, Yx, px):
            pc, pw = _mole_pressures(Tx, Yx, px, gas)
            p_mix = pc + pw
            mr = pw / torch.clamp(pc, min=1e-10)
            fv = torch.zeros_like(Tx)  # soot volume fraction (registry "fv")
            a_rows, w_rows = [], []
            for b in range(nL):
                if self.variant == "johansson":
                    # a = (b0 + b1·MR)(pH2O+pCO2)·0.986923 [bar→atm]
                    k = self._band_coeff(b, Tx, 0) + self._band_coeff(b, Tx, 1) * mr
                    a = k * p_mix * 0.986923
                    tr = Tx / 1200.0
                    w = torch.zeros_like(Tx)
                    for jj in range(3):  # T^jj; MR^0..2 coefficients at 2+jj, 5+jj, 8+jj
                        cj = (self._band_coeff(b, Tx, 2 + jj)
                              + self._band_coeff(b, Tx, 5 + jj) * mr
                              + self._band_coeff(b, Tx, 8 + jj) * mr**2)
                        w = w + cj * tr**jj
                else:
                    a = self._band_coeff(b, Tx, 0) * p_mix + self.c_soot * fv * Tx
                    w = self._weights(b, Tx)
                # the last band is the transparent-windows remainder,
                # evaluated with its OWN coefficients: w = 1 − poly(b_last)
                if b == nL - 1:
                    w = 1.0 - w
                a_rows.append(torch.clamp(a, min=0.0))
                w_rows.append(torch.clamp(w, 0.0, 1.0))
            return torch.stack(a_rows), torch.stack(w_rows)

        a, w = per(T, Y, p)
        a_b, w_b = per(Tb, Yb, pb)
        E = torch.zeros((nL,) + tuple(T.shape), dtype=T.dtype, device=T.device)
        return {"a": a, "a_b": a_b, "E": E, "enFrac": w, "enFrac_b": w_b}


# ---------------------------------------------------------------------------
# constRadFracWideBandEmission
# ---------------------------------------------------------------------------


@dataclass
class ConstRadFracWideBandAE:
    """Transparent gas, banded radiant-fraction emission: E_b = χ·Qdot·f_b
    where f_b are blackbody fractions at a FIXED radiation temperature
    (constRadFracWideBandEmission.C:241-263, setEnergyFracs :283-300).
    The radScaling χ blend comes from the caller (chi argument)."""

    bands: tuple
    rad_temp: float
    en_fracs: tuple  # static per-band fractions at rad_temp

    @property
    def n_lambda(self) -> int:
        return len(self.bands)

    @classmethod
    def from_coeffs(cls, aec: FoamDict) -> "ConstRadFracWideBandAE":
        bands = []
        for _, bd in aec.subdicts():
            if bd.found("bandLimits"):
                lim = bd.get_list("bandLimits")
                bands.append((float(lim[0]), float(lim[1])))
        rt = aec.get_scalar("radTemp", 1300.0)
        fr = [float(blackbody_fraction(hi * 1e6 * rt) - blackbody_fraction(lo * 1e6 * rt))
              for lo, hi in bands]
        return cls(bands=tuple(bands), rad_temp=rt, en_fracs=tuple(fr))

    def eval(self, T, Tb, Y, Yb, p, pb, gas, Qdot, chi):
        nL = self.n_lambda
        kw = dict(dtype=T.dtype, device=T.device)
        return {
            "a": torch.zeros((nL,) + tuple(T.shape), **kw),
            "a_b": torch.zeros((nL,) + tuple(Tb.shape), **kw),
            "E": torch.stack([chi * Qdot * f for f in self.en_fracs]),
            "enFrac": band_fractions(self.bands, T),
            "enFrac_b": band_fractions(self.bands, Tb),
        }


# ---------------------------------------------------------------------------
# binaryAbsorptionEmission — sum of two models with equal n_lambda
# ---------------------------------------------------------------------------


@dataclass
class BinaryAE:
    """binaryAbsorptionEmission.C:91-123 — a/E sums of two submodels;
    energy fractions from model1."""

    model1: object
    model2: object

    @property
    def n_lambda(self) -> int:
        return self.model1.n_lambda

    def eval(self, *args):
        r1 = self.model1.eval(*args)
        r2 = self.model2.eval(*args)
        return {
            "a": r1["a"] + r2["a"],
            "a_b": r1["a_b"] + r2["a_b"],
            "E": r1["E"] + r2["E"],
            "enFrac": r1["enFrac"],
            "enFrac_b": r1["enFrac_b"],
        }


# ---------------------------------------------------------------------------
# greyMeanSolidAbsorptionEmission — solid-region (opaqueSolid) radiation
# ---------------------------------------------------------------------------


@dataclass
class GreyMeanSolidAE:
    """a = Σ_i absorptivity_i·X_i, e = Σ_i emissivity_i·X_i over solid
    volume fractions (greyMeanSolidAbsorptionEmission.C:143-196). X are
    the caller's volume fractions; species without data add nothing."""

    names: tuple
    absorptivity: tuple
    emissivity: tuple
    n_lambda: int = 1

    @classmethod
    def from_coeffs(cls, aec: FoamDict) -> "GreyMeanSolidAE":
        names, ab, em = [], [], []
        for sname, sd in aec.subdicts():
            if not sd.found("absorptivity"):
                continue
            names.append(sname)
            ab.append(sd.get_scalar("absorptivity", 0.0))
            em.append(sd.get_scalar("emissivity", 0.0))
        return cls(names=tuple(names), absorptivity=tuple(ab), emissivity=tuple(em))

    def a_of(self, X: dict):
        a = None
        for n, ab in zip(self.names, self.absorptivity):
            if n in X:
                a = ab * X[n] if a is None else a + ab * X[n]
        return a

    def e_of(self, X: dict):
        e = None
        for n, em in zip(self.names, self.emissivity):
            if n in X:
                e = em * X[n] if e is None else e + em * X[n]
        return e
