"""Cloud function objects (submodels/CloudFunctionObjects/*).

The port of firefoam_tpu/lagrangian/cloudfunctions.py. Reference
semantics, vectorised over the parcel SoA inside the cloud's evolve:

  VoidFraction        VoidFraction.C: θ[cell] = Σ nP·V_p·dt_track/(Δt·V) —
                      dispersed-phase volume fraction accumulated over the
                      substeps of each flow step.
  ParticleErosion     ParticleErosion.C:postPatch — Finnie erosion Q per
                      boundary face from parcel wall impacts.
  ParticleTrap        ParticleTrap.C:postMove — parcels in cells with
                      α < threshold are specularly reflected off ∇α.
  ParticleTracks      ParticleTracks.C — every trackInterval-th substep,
                      sample parcel position/diameter into a ring buffer
                      (maxSamples per parcel), written as track files.
  PatchPostProcessing PatchPostProcessing.C — record (x, U, d, nP, T) rows
                      of parcels striking listed patches (maxStoredParcels).
  FacePostProcessing  FacePostProcessing.C — per-faceZone accumulated mass
                      of parcels crossing the zone faces (boundary zones
                      accumulate on wall hits).

All state lives in fixed-shape arrays inside the cloud state ("cfo" key),
so every hook is a masked scatter (sums order-fixed, tracking.cell_sum) —
no dynamic allocation and no host read.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import INT_DTYPE
from ..io.foamdict import FoamDict
from .tracking import cell_sum

_PI = math.pi


@dataclass
class VoidFraction:
    name: str

    def init_state(self, capacity, n_cells, dtype, device="cpu") -> Dict:
        return {"theta": torch.zeros(n_cells, dtype=dtype, device=device)}

    def post_move(self, cst, st, dt_sub, dt, gas, geom):
        c = st["cell"]
        vol = st["nP"] * (_PI / 6.0) * st["d"] ** 3
        add = torch.where(st["alive"], vol * dt_sub, 0.0)
        theta = cst["theta"] + cell_sum(add, c, geom.n_cells, keep=st["alive"]) / (dt * geom.V)
        return dict(cst, theta=theta), st

    def reset(self, cst):
        return dict(cst, theta=torch.zeros_like(cst["theta"]))


@dataclass
class ParticleErosion:
    """Finnie model (ParticleErosion.C:postPatch): for an impact at angle α
    (from the surface), Q += nP·m·|U|²/(p·ψ·K)·f(α)."""

    name: str
    patches: Tuple[str, ...]
    p: float = 2.7e9
    psi: float = 2.0
    K: float = 2.0

    def init_state(self, capacity, n_boundary, dtype, device="cpu") -> Dict:
        return {"Q": torch.zeros(n_boundary, dtype=dtype, device=device)}

    def post_patch(self, cst, st, hit, hit_mask, mass, U_in, b_normal):
        """hit: boundary-face index per parcel; hit_mask: parcels that
        struck an erosion patch this substep; U_in their pre-hit velocity."""
        n = b_normal[hit]  # outward normal
        magU = torch.sqrt(torch.sum(U_in * U_in, dim=1))
        Udir = U_in / torch.clamp(magU, min=1e-30)[:, None]
        cosb = torch.clamp(torch.sum(n * Udir, dim=1), -1.0, 1.0)
        toward = cosb > 0.0
        alpha = _PI / 2.0 - torch.arccos(cosb)
        coeff = mass * magU**2 / (self.p * self.psi * self.K)
        shallow = torch.tan(alpha) < self.K / 6.0
        f = torch.where(
            shallow,
            torch.sin(2.0 * alpha) - 6.0 / self.K * torch.sin(alpha) ** 2,
            self.K * torch.cos(alpha) ** 2 / 6.0,
        )
        add = torch.where(hit_mask & toward, coeff * f, 0.0)
        Q = cst["Q"] + cell_sum(add, hit, cst["Q"].shape[0], keep=hit_mask & toward)
        return dict(cst, Q=Q)


@dataclass
class ParticleTrap:
    name: str
    alpha_name: str = "alpha"
    threshold: float = 0.95

    def init_state(self, capacity, n_cells, dtype, device="cpu") -> Dict:
        return {}

    def post_move(self, cst, st, dt_sub, dt, gas, geom):
        alpha = gas.get(self.alpha_name)
        grad = gas.get("grad_" + self.alpha_name)
        if alpha is None or grad is None:
            return cst, st
        c = st["cell"]
        active = st["alive"] & (alpha[c] < self.threshold)
        g = grad[c]
        nhat = g / torch.clamp(torch.sqrt(torch.sum(g * g, dim=1)), min=1e-30)[:, None]
        nU = torch.sum(nhat * st["U"], dim=1)
        refl = active & (nU < 0.0)
        U = torch.where(refl[:, None], st["U"] - 2.0 * nhat * nU[:, None], st["U"])
        st = dict(st)
        st["U"] = U
        return cst, st


@dataclass
class ParticleTracks:
    name: str
    track_interval: int = 1
    max_samples: int = 8

    def init_state(self, capacity, n_cells, dtype, device="cpu") -> Dict:
        return {
            "pos": torch.zeros((capacity, self.max_samples, 3), dtype=dtype, device=device),
            "dia": torch.zeros((capacity, self.max_samples), dtype=dtype, device=device),
            "n_samp": torch.zeros(capacity, dtype=INT_DTYPE, device=device),
            "tick": torch.zeros((), dtype=INT_DTYPE, device=device),
        }

    def post_move(self, cst, st, dt_sub, dt, gas, geom):
        tick = cst["tick"] + 1
        fire = (tick % self.track_interval) == 0
        slot = torch.clamp(cst["n_samp"], max=self.max_samples - 1)
        take = fire & st["alive"] & (cst["n_samp"] < self.max_samples)
        rows = torch.arange(st["x"].shape[0], device=slot.device)
        pos = cst["pos"].clone()
        pos[rows, slot] = torch.where(take[:, None], st["x"], cst["pos"][rows, slot])
        dia = cst["dia"].clone()
        dia[rows, slot] = torch.where(take, st["d"], cst["dia"][rows, slot])
        return dict(
            cst,
            pos=pos,
            dia=dia,
            n_samp=cst["n_samp"] + take.to(INT_DTYPE),
            tick=tick,
        ), st


@dataclass
class PatchPostProcessing:
    name: str
    patches: Tuple[str, ...]
    max_stored: int = 100

    def init_state(self, capacity, n_cells, dtype, device="cpu") -> Dict:
        # one scratch row at the end absorbs the overflow writes so valid
        # rows are never clobbered by duplicate clipped indices
        return {
            "rows": torch.zeros((self.max_stored + 1, 8), dtype=dtype, device=device),  # x3 U3 d nP
            "n_rows": torch.zeros((), dtype=INT_DTYPE, device=device),
        }

    def post_patch(self, cst, st, hit, hit_mask, mass, U_in, b_normal):
        # compact the hitting parcels into the next free rows
        # hits first, in slot order (a stable sort)
        order = torch.sort((~hit_mask).to(torch.int32), stable=True).indices
        take_n = torch.sum(hit_mask).to(INT_DTYPE)
        data = torch.cat(
            [st["x"], U_in, st["d"][:, None], st["nP"][:, None]], dim=1
        )[order]
        idx = torch.arange(data.shape[0], device=data.device)
        dst = cst["n_rows"] + idx
        ok = (idx < take_n) & (dst < self.max_stored)
        # every overflow write lands on the scratch row with zeros, so the
        # duplicate writes there agree
        rows = cst["rows"].clone()
        rows[torch.where(ok, dst, self.max_stored)] = torch.where(ok[:, None], data, 0.0)
        n_rows = torch.clamp(cst["n_rows"] + take_n, max=self.max_stored)
        return dict(cst, rows=rows, n_rows=n_rows)


@dataclass
class FacePostProcessing:
    name: str
    zone_faces: Dict[str, np.ndarray] = field(default_factory=dict)
    # boundary-face zones: accumulate parcel mass on hit

    def init_state(self, capacity, n_boundary, dtype, device="cpu") -> Dict:
        return {"zone_mass": torch.zeros(max(len(self.zone_faces), 1), dtype=dtype, device=device)}

    def post_patch(self, cst, st, hit, hit_mask, mass, U_in, b_normal):
        zm = cst["zone_mass"]
        adds = []
        for zi, (zname, faces) in enumerate(sorted(self.zone_faces.items())):
            fset = torch.as_tensor(np.asarray(faces), dtype=INT_DTYPE, device=hit.device)
            in_zone = torch.isin(hit, fset)
            adds.append(torch.sum(torch.where(hit_mask & in_zone, mass, 0.0)))
        if adds:
            zm = zm + torch.nn.functional.pad(torch.stack(adds), (0, zm.shape[0] - len(adds)))
        return dict(cst, zone_mass=zm)


def make_cloud_functions(props: FoamDict, geom, boundary_zones=None):
    """Parse cloudFunctions sub-dict → list of function objects."""
    cfs = []
    cf_dict = props.get_dict("cloudFunctions", FoamDict())
    for name, d in cf_dict.subdicts():
        kind = d.get_word("type", name)
        if kind == "voidFraction":
            cfs.append(VoidFraction(name))
        elif kind == "particleErosion":
            cfs.append(
                ParticleErosion(
                    name,
                    tuple(str(x) for x in (d.get_list("patches", []) or [])),
                    p=d.get_scalar("p", 2.7e9),
                    psi=d.get_scalar("psi", 2.0),
                    K=d.get_scalar("K", 2.0),
                )
            )
        elif kind == "particleTrap":
            cfs.append(
                ParticleTrap(
                    name,
                    alpha_name=d.get_word("alphaName", "alpha"),
                    threshold=d.get_scalar("threshold", 0.95),
                )
            )
        elif kind == "particleTracks":
            cfs.append(
                ParticleTracks(
                    name,
                    track_interval=d.get_int("trackInterval", 1),
                    max_samples=d.get_int("maxSamples", 8),
                )
            )
        elif kind == "patchPostProcessing":
            cfs.append(
                PatchPostProcessing(
                    name,
                    tuple(str(x) for x in (d.get_list("patches", []) or [])),
                    max_stored=d.get_int("maxStoredParcels", 100),
                )
            )
        elif kind == "facePostProcessing":
            zones = {}
            for zn in (d.get_list("faceZones", []) or []):
                zn = str(zn)
                if boundary_zones and zn in boundary_zones:
                    zones[zn] = np.asarray(boundary_zones[zn])
            cfs.append(FacePostProcessing(name, zones))
        # particleCollector handled by collector.py (ParticleCollectorFmg)
    return cfs
