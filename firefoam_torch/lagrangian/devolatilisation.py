"""Devolatilisation + n-phase parcel ledger (ReactingMultiphase parcels).

The port of firefoam_tpu/lagrangian/devolatilisation.py, the reference
devolatilisation submodels (packages/lagrangian/intermediateNew/submodels/
ReactingMultiphase/DevolatilisationModel/):

- ConstantRateDevolatilisation  (ConstantRateDevolatilisation.C:95-131):
      dMass_i = min(dt · A0_i · massVolatile0_i, massVolatile_i)
- SingleKineticRateDevolatilisation
  (SingleKineticRateDevolatilisation.C:96-137):
      kappa_i  = A1_i · exp(−E_i / (R·T))
      dMass_i  = min(dt · kappa_i · massVolatile_i, massVolatile_i)
- NoDevolatilisation (null)

with the reference gating (ReactingMultiphaseParcel.C calcDevolatilisation):
nothing below constProps TDevol or while the parcel is suppression-inhibited
(canCombust == −1, SuppressionCollision.C:52); once every volatile has
evolved to `residualCoeff · massVolatile0` the parcel is combustion-ready
(canCombust = 1). The evolved mass draws the latent heat LDevol from the
particle (ReactingMultiphaseParcel.C:566) and enters the carrier at its own
species enthalpy (the cloud's `_calc`).

Phase ledger (the reference's phaseProperties gas/liquid/solid bookkeeping):
parcels carry per-particle volatile masses `mv` [cap, nVol] (+ the initial
`mv0`) and an inert solid mass `ms` [cap] on top of the liquid droplet
core. Injection splits the seeded particle mass by the composition phases'
Y0 fractions (constantVolume bookkeeping: the diameter follows the liquid
core). Surface reactions: the reference ships only NoSurfaceReaction, so
`surfaceReactionModel none;` is the whole surface.

One masked update over the parcel SoA per substep: no per-parcel branches,
the regime gates are masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..io.foamdict import FoamDict

__all__ = ["PhaseLedger", "Devolatilisation", "parse_phases"]

_RR = 8314.47  # J/(kmol·K), OpenFOAM's RR in these units


def parse_phases(comp: FoamDict) -> Dict[str, List[Tuple[str, float]]]:
    """phases ( gas {..} liquid {..} solid {..} ) → {phase: [(name, Y)]}.

    A bare component dict with no phase name is liquid (the
    singlePhaseMixture droplet form of the shipped cases)."""
    out: Dict[str, List[Tuple[str, float]]] = {}
    if not comp.found("phases"):
        return out
    name = None
    for it in comp.get_list("phases"):
        if isinstance(it, str):
            name = it
            continue
        if isinstance(it, FoamDict):
            ph = name if name in ("gas", "liquid", "solid") else "liquid"
            ents = out.setdefault(ph, [])
            for k in it:
                try:
                    ents.append((k, float(it.get_scalar(k, 1.0))))
                except Exception:
                    ents.append((k, 1.0))
            name = None
    return out


@dataclass
class PhaseLedger:
    """Initial gas/liquid/solid split of an injected particle's mass."""

    gas_names: Tuple[str, ...]
    gas_fracs: np.ndarray  # mass fraction of TOTAL particle mass, per comp
    liquid_frac: float  # total liquid fraction
    solid_frac: float  # total (inert) solid fraction

    @classmethod
    def from_phases(cls, phases: Dict[str, List[Tuple[str, float]]]):
        """None when the composition is pure liquid (the droplet path stays
        as it is)."""
        gas = phases.get("gas", [])
        solid = phases.get("solid", [])
        if not gas and not solid:
            return None
        yl = sum(f for _, f in phases.get("liquid", []))
        yg = np.asarray([f for _, f in gas], np.float64)
        ys = sum(f for _, f in solid)
        tot = float(yg.sum() + yl + ys)
        if tot <= 0:
            return None
        return cls(
            gas_names=tuple(n for n, _ in gas),
            gas_fracs=yg / tot,
            liquid_frac=yl / tot,
            solid_frac=ys / tot,
        )


@dataclass
class Devolatilisation:
    """Runtime-selected devolatilisation model over the volatile ledger."""

    kind: str  # 'constantRate' | 'singleKineticRate'
    names: Tuple[str, ...]  # volatile specie names (volatileData order)
    gas_indices: Tuple[int, ...]  # carrier specie index per volatile
    A: np.ndarray  # A0 (constantRate) or A1 (singleKineticRate)
    E: np.ndarray  # activation energies (singleKineticRate; zeros otherwise)
    residual_coeff: float
    T_devol: float
    L_devol: float

    @classmethod
    def from_dict(cls, sub: FoamDict, cp: FoamDict, gas) -> "Devolatilisation":
        """sub = the cloud's subModels dict; cp = constantProperties.
        None for 'none'/absent (every shipped case)."""
        name = sub.get_word("devolatilisationModel", "none")
        if name in ("none", "noDevolatilisation"):
            return None
        kind = "constantRate" if name.lower().startswith("constantrate") else "singleKineticRate"
        coeffs = sub.get_dict(name + "Coeffs", FoamDict())
        vd = coeffs.get_list("volatileData") if coeffs.found("volatileData") else []
        names, A, E = [], [], []
        for row in vd:
            row = list(row) if isinstance(row, (list, tuple)) else [row]
            names.append(str(row[0]))
            A.append(float(row[1]) if len(row) > 1 else 0.0)
            E.append(float(row[2]) if len(row) > 2 else 0.0)
        return cls(
            kind=kind,
            names=tuple(names),
            gas_indices=tuple(gas.index(n) for n in names),
            A=np.asarray(A, np.float64),
            E=np.asarray(E, np.float64),
            residual_coeff=coeffs.get_scalar("residualCoeff", 1e-6),
            T_devol=cp.get_scalar("TDevol", 0.0),
            L_devol=cp.get_scalar("LDevol", 0.0),
        )

    @property
    def n_vol(self) -> int:
        return len(self.gas_indices)

    def _coeff(self, name, like: torch.Tensor) -> torch.Tensor:
        """A or E as a [1, nVol] tensor on the parcels' device, made once (a
        host-to-device copy from pageable memory waits for the card)."""
        cache = self.__dict__.setdefault("_dev", {})
        key = (name, like.dtype, like.device)
        if key not in cache:
            cache[key] = torch.as_tensor(getattr(self, name), dtype=like.dtype,
                                         device=like.device)[None, :]
        return cache[key]

    def calculate(self, dt, T, mv, mv0, can_combust, gate):
        """Devolatilisation over the parcel SoA.

        mv/mv0: per-particle volatile masses [cap, nVol]; gate: [cap] bool
        (alive and any volatile content). Returns (dmv [cap, nVol],
        canCombust')."""
        gate = gate & (T >= self.T_devol) & (can_combust != -1)
        if self.kind == "constantRate":
            rate = self._coeff("A", mv) * mv0
        else:
            kappa = self._coeff("A", mv) * torch.exp(-self._coeff("E", mv) / (_RR * T[:, None]))
            rate = kappa * mv
        dmv = torch.minimum(dt * rate, mv)
        dmv = torch.where(gate[:, None], dmv, torch.zeros_like(dmv))
        # combustion allowed once ALL volatiles evolved to the residual
        done = torch.all(mv - dmv <= self.residual_coeff * mv0, dim=1)
        can_new = torch.where(gate & done & (can_combust != -1),
                              torch.ones_like(can_combust), can_combust)
        return dmv, can_new
