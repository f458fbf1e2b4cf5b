"""SuppressionCollision — fire-suppression gating of parcel combustion.

Re-implements the reference stochastic-collision submodel
(packages/lagrangian/intermediateNew/submodels/ReactingMultiphase/
StochasticCollision/SuppressionCollision/SuppressionCollision.{H,C}):
water-spray coverage suppresses devolatilisation/surface reaction of the
reacting (burning-commodity) cloud's parcels. Per cell,

    P_suppress = 1 − exp(−vDotSweep·Δt)

where vDotSweep is the suppressing cloud's swept-volume rate
(Σ nP·π/4·d²·|U| / V, kinematicCloud::vDotSweep), and each parcel of the
target cloud is independently marked non-combustible (canCombust = −1,
typeId raised to suppressedParcelType) with that probability
(SuppressionCollision.C::collide).

The port of firefoam_tpu/lagrangian/suppression.py: one vectorised
Bernoulli draw over the parcel SoA (prng, the JAX package's draws) instead
of the reference's per-parcel RNG loop; suppression state is the
`canCombust` lane of the cloud state."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..io.foamdict import FoamDict
from . import prng

__all__ = ["SuppressionCollision"]


@dataclass
class SuppressionCollision:
    suppression_cloud: str
    suppressed_parcel_type: int

    @classmethod
    def from_dict(cls, d: FoamDict) -> "SuppressionCollision":
        c = d.get_dict("SuppressionCollisionCoeffs", FoamDict())
        return cls(
            suppression_cloud=c.get_word("suppressionCloud", "reactingCloud1"),
            suppressed_parcel_type=c.get_int("suppressedParcelType", 5),
        )

    def collide(self, st: dict, vdot_sweep: torch.Tensor, dt) -> dict:
        """Mark target-cloud parcels non-combustible with per-cell
        probability 1 − exp(−vDotSweep·Δt). `st` must carry `canCombust`
        (int) and `typeId` (int) lanes."""
        key, sub = prng.split(st["rng"], 2)
        P = 1.0 - torch.exp(-vdot_sweep * dt)  # [nCells]
        xx = prng.uniform(sub, tuple(st["cell"].shape), P.dtype, device=P.device)
        hitp = st["alive"] & (xx < P[st["cell"]])
        st = dict(st)
        st["rng"] = key
        st["canCombust"] = torch.where(hitp, -1, st["canCombust"])
        st["typeId"] = torch.maximum(
            st["typeId"],
            torch.where(hitp, self.suppressed_parcel_type, st["typeId"]),
        )
        return st
