"""Film-region inlet boundary conditions.

The port of firefoam_tpu/regionmodels/filmbcs.py: the reference's film
inlet fvPatchFields (surfaceFilmModels/derivedFvPatchFields) as rim-edge
inflow models. Each prescribes the inlet film height δ_in, the inflow speed
u_in (into the film, along −be_m) and the temperature; the film transport
adds the mass, momentum and energy influx every substep:

  filmHeightInletVelocity[Wavy]      U = ṁ/(ρ·δ·width) at a set height
                                     (+ a transverse sinusoidal wobble)
  inclinedFilmNusseltHeight          δ(d) = δ̄ + a·sin(ω·2π·d), δ̄ from a
                                     bisection of Γ̄ = mean((δ/C)³)
  inclinedFilmNusseltInletVelocity   Γ(d) = Γ̄·(1 + a·sin(ω·2π·d)),
                                     |U| = (g_t·μ/3ρ)^⅓·Re^⅔
  massFlowInlet                      δ = (3ν²/g_t)^⅓·Re^⅓, Re = γ/μ
  filmHeightInlet / wavyFilmHeight   δ(d, t) temporally and spatially
                                     modulated

Inlet edges are selected geometrically (a bounding box and/or an
outward-direction match). Everything but the time modulation is static and
evaluated on the host at setup.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..io.foamdict import FoamDict

__all__ = ["FilmInlet", "parse_film_inlets", "bind_liquid"]

_KINDS = (
    "filmHeightInletVelocity",
    "filmHeightInletVelocityWavy",
    "inclinedFilmNusseltHeight",
    "inclinedFilmNusseltInletVelocity",
    "massFlowInlet",
    "filmHeightInlet",
    "wavyFilmHeight",
)


def _dimval(v, default=0.0):
    if isinstance(v, list):
        v = v[-1]
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


@dataclass
class FilmInlet:
    """One rim-edge inlet."""

    kind: str
    rows: np.ndarray  # selected rim-edge indices into fm.be_*
    T_in: float = 298.15
    # mass supply: gamma = mass flow per unit rim width [kg/m/s]; mdot =
    # total mass flow [kg/s] over the inlet
    gamma: float = 0.0
    mdot: Optional[float] = None
    delta_in: Optional[float] = None  # prescribed height (filmHeightInlet*)
    a: float = 0.0  # wavy amplitude
    omega_sp: float = 0.0  # spatial frequency [1/m]
    f_t1: float = 0.0  # temporal frequencies (filmHeightInlet/wavyFilmHeight)
    f_t2: float = 0.0
    wavy_sf: float = 32.0  # filmHeightInletVelocityWavy spatial frequency
    wavy_amp: float = 1.0  # … and transverse amplitude (reference constants)

    d_tan: np.ndarray = None  # tangential coordinate along the rim
    g_t: float = 9.81  # tangential gravity magnitude at the inlet
    width: float = 1.0  # Σ be_len over the selected edges
    rho_in: float = 1000.0  # inlet-liquid properties at T_in
    mu_in: float = 1e-3
    cp_in: float = 4186.0

    def bind(self, fm, g_tan_face: np.ndarray) -> "FilmInlet":
        rows = self.rows
        be_C = fm.be_C.double().cpu().numpy()[rows]
        be_m = fm.be_m.double().cpu().numpy()[rows]
        faces = fm.be_face.cpu().numpy()[rows]
        n_hat = fm.n_hat.double().cpu().numpy()[faces]
        # rim tangent nTan = n̂ × n with n into the film
        # (inclinedFilmNusseltHeight…C:133-145); d = nTan·C
        n_tan = np.cross(n_hat, -be_m)
        n_tan /= np.linalg.norm(n_tan, axis=1, keepdims=True) + 1e-300
        self.d_tan = np.einsum("ed,ed->e", n_tan, be_C)
        gt = np.asarray(g_tan_face)[faces]
        self.g_t = float(np.maximum(np.linalg.norm(gt, axis=1).mean(), 1e-8))
        self.width = float(fm.be_len.double().cpu().numpy()[rows].sum())
        return self

    def set_liquid(self, liquid) -> "FilmInlet":
        T = _f64(self.T_in)
        self.rho_in = float(liquid.rho(101325.0, T))
        self.mu_in = float(liquid.mu(101325.0, T))
        self.cp_in = float(liquid.cp(101325.0, T))
        return self

    # -------------------------------------------------------------- physics
    def _nusselt_C(self, rho: float, mu: float) -> float:
        """C with Γ = (δ/C)³ the mass flow per unit width."""
        nu = mu / rho
        return (3.0 * nu * nu / (mu * self.g_t)) ** (1.0 / 3.0)

    def _nusselt_height_mean(self, rho: float, mu: float) -> float:
        """Bisection for δ̄ with mean((δ̄ + a·sin(ω2πd))/C)³ = Γ̄."""
        C = self._nusselt_C(rho, mu)
        wave = self.a * np.sin(self.omega_sp * 2.0 * math.pi * self.d_tan)
        lo, hi = 2e-6, 2e-2
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if self.gamma - float(np.mean(((mid + wave) / C) ** 3)) > 0.0:
                lo = mid
            else:
                hi = mid
            if hi - lo < 1e-12:
                break
        return 0.5 * (lo + hi)

    def inflow(self, liquid, t, dtype=torch.float64, device="cpu") -> Dict:
        """Per selected rim edge: film height δ_in [m], inflow speed u_in
        [m/s] (into the film), temperature and the transverse wobble."""
        rho, mu = self.rho_in, self.mu_in
        nu = mu / rho
        d = self.d_tan
        two_pi = 2.0 * math.pi
        wob = np.zeros_like(d)
        kw = dict(dtype=dtype, device=device)
        if self.kind == "inclinedFilmNusseltHeight":
            dm = self._nusselt_height_mean(rho, mu)
            delta = np.maximum(dm + self.a * np.sin(self.omega_sp * two_pi * d), 1e-8)
            u = (delta / self._nusselt_C(rho, mu)) ** 3 / (rho * delta)
        elif self.kind == "inclinedFilmNusseltInletVelocity":
            G = self.gamma * (1.0 + self.a * np.sin(self.omega_sp * two_pi * d))
            Re = np.maximum(G, 0.0) / mu
            u = (self.g_t * mu / (3.0 * rho)) ** (1.0 / 3.0) * Re ** (2.0 / 3.0)
            delta = (3.0 * nu * nu / self.g_t) ** (1.0 / 3.0) * Re ** (1.0 / 3.0)
        elif self.kind == "massFlowInlet":
            Re = self.gamma / mu
            delta = np.full_like(d, (3.0 * nu * nu / self.g_t) ** (1.0 / 3.0) * Re ** (1.0 / 3.0))
            u = self.gamma / (rho * np.maximum(delta, 1e-8))
        elif self.kind in ("filmHeightInletVelocity", "filmHeightInletVelocityWavy"):
            delta = np.full_like(d, max(self.delta_in or 1e-4, 1e-8))
            mdot = self.mdot if self.mdot is not None else self.gamma * self.width
            u = np.full_like(d, mdot / (rho * delta * max(self.width, 1e-12)))
            if self.kind.endswith("Wavy"):
                wob = self.wavy_amp * np.sin(self.wavy_sf * two_pi * d)
        else:  # filmHeightInlet / wavyFilmHeight: modulated in time
            t = torch.as_tensor(t, **kw)
            osc1 = torch.cos(two_pi * self.f_t1 * t)
            osc2 = torch.cos(two_pi * self.f_t2 * t)
            base = self.delta_in if self.delta_in is not None else 1e-4
            dt_ = torch.as_tensor(d, **kw)
            delta = base * (1.0 + osc1 * self.a * torch.sin(self.omega_sp * two_pi * dt_
                                                            + osc2 * two_pi))
            delta = torch.clamp(delta, min=1e-8)
            u = self.g_t * delta ** 2 / (3.0 * nu)  # the local Nusselt balance
        return {
            "delta": torch.as_tensor(delta, **kw),
            "u": torch.as_tensor(u, **kw),
            "T": self.T_in,
            "wobble": torch.as_tensor(wob, **kw),
            "rho": rho,
        }


def parse_film_inlets(coeffs: FoamDict, fm, g_tan) -> List[FilmInlet]:
    """The inlet models of the film coeffs' `inletModels` subdict; each
    named entry selects rim edges by a `box (lo) (hi)` and/or an outward
    `direction`, and carries its BC's parameters."""
    out: List[FilmInlet] = []
    sub = coeffs.get_dict("inletModels", FoamDict())
    be_C = fm.be_C.double().cpu().numpy()
    be_m = fm.be_m.double().cpu().numpy()
    if be_C.shape[0] == 0:
        return out
    for _, e in sub.subdicts():
        kind = e.get_word("type", "")
        if kind not in _KINDS:
            continue
        sel = np.ones(be_C.shape[0], bool)
        box = e.lookup("box", None)
        if isinstance(box, list) and len(box) == 2:
            lo = np.asarray([float(x) for x in box[0]])
            hi = np.asarray([float(x) for x in box[1]])
            sel &= ((be_C >= lo) & (be_C <= hi)).all(axis=1)
        dirn = e.lookup("direction", None)
        if isinstance(dirn, list) and len(dirn) == 3:
            v = np.asarray([float(x) for x in dirn])
            v /= np.linalg.norm(v) + 1e-300
            sel &= be_m @ v > 0.5
        rows = np.nonzero(sel)[0]
        if rows.size == 0:
            continue
        look = e.lookup
        delta_in = (_dimval(look("deltaf", None), None) if look("deltaf", None) is not None
                    else (_dimval(look("mean", None), None) if look("mean", None) is not None
                          else None))
        out.append(FilmInlet(
            kind=kind,
            rows=rows,
            T_in=e.get_scalar("T", 298.15),
            gamma=_dimval(look("GammaMean", look("gamma", 0.0))),
            mdot=_dimval(look("mdot", None), None) if look("mdot", None) is not None else None,
            delta_in=delta_in,
            a=_dimval(look("a", look("amplitude", 0.0))),
            omega_sp=_dimval(look("omega", look("spatialFrequency", 0.0))),
            f_t1=e.get_scalar("temporalFrequency1", 0.0),
            f_t2=e.get_scalar("temporalFrequency2", 0.0),
        ).bind(fm, g_tan))
    return out


def bind_liquid(inlets: List[FilmInlet], liquid) -> List[FilmInlet]:
    for i in inlets:
        i.set_liquid(liquid)
    return inlets
