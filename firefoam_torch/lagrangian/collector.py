"""ParticleCollectorFmg: parcel flux collection through user surfaces.

The port of firefoam_tpu/lagrangian/collector.py. It re-designs the
reference cloud function object (lib/
additionalCloudFunctionObjects/ParticleCollectorFmg/ParticleCollectorFmg.C,
1136 LoC: polygon / concentric-circle collection of parcel mass with dv50 +
velocity sampling, CHANGELOG 17.11.09/10) for the SoA parcel world:

  - each substep, every alive parcel's segment (x_pre → x_post) is tested
    against the collector plane; a sign change of (x−p0)·n̂ marks a
    crossing, the intersection point is binned into the polygon that
    contains it (convex point-in-polygon edge test) or the (ring, sector)
    annulus bin.
  - per bin the collector accumulates mass, momentum magnitude (for the
    mean collected velocity) and a per-collector mass-weighted log-diameter
    histogram from which dv50 is interpolated at write time (the reference
    stores the raw drop list; a fixed histogram is the static-shape
    equivalent).

All accumulators live in the cloud state, so checkpoints capture the
collection history; the bin sums are order-fixed (tracking.cell_sum).
Host-side `summarise()` feeds one dat file per collector.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..io.foamdict import FoamDict
from . import prng
from .tracking import CellSum, cell_sum

__all__ = ["ParticleCollector", "make_collectors"]

_N_DBIN = 24
_D_EDGES = np.logspace(-5, -2, _N_DBIN + 1)  # 10 µm .. 10 mm


@dataclass
class ParticleCollector:
    name: str
    mode: str  # polygon | concentricCircle
    normal: np.ndarray  # [3] unit plane normal
    p0: np.ndarray  # [3] point on the plane
    # polygon mode: [nPoly, maxV, 3] vertices padded by repeating the last
    verts: np.ndarray
    n_verts: np.ndarray  # [nPoly]
    # concentricCircle mode
    radii: np.ndarray  # ring outer radii [nRing]
    n_sector: int
    e1: np.ndarray
    e2: np.ndarray
    remove_collected: bool
    negate_parcels: bool  # collect on negative-direction crossings too
    # ParticleCollectorFmgMassThres (lib/additionalCloudFunctionObjects/
    # ParticleCollectorFmgMassThres.C:753-756, 1008-1040): threshold-based
    # parcel removal — fixed mode removes until accumMass reaches massThres,
    # continuous mode thins stochastically by massThres/stMassFlowRate with
    # an exponentially-smoothed flow-rate estimate (smoothingWindow).
    fixed_mass_remove: bool = False
    cont_mass_remove: bool = False
    mass_thres: float = 0.2
    smoothing_window: float = 1.0

    @property
    def n_bins(self) -> int:
        if self.mode == "polygon":
            return self.verts.shape[0]
        return len(self.radii) * self.n_sector

    # ----------------------------------------------------------- factory
    @classmethod
    def from_dict(cls, name: str, d: FoamDict) -> "ParticleCollector":
        mode = d.get_word("mode", "polygon")
        remove = d.get_bool("removeCollected", False)
        negate = d.get_bool("negateParcelsOppositeNormal", False)
        thres_kw = dict(
            fixed_mass_remove=d.get_bool("fixedMassRemove", False),
            cont_mass_remove=d.get_bool("contMassRemove", False),
            mass_thres=d.get_scalar("massThres", 0.2),
            smoothing_window=d.get_scalar("smoothingWindow", 1.0),
        )
        if mode == "polygon":
            polys = d.get_list("polygons")
            plist = [np.asarray([np.asarray(v, float) for v in poly]) for poly in polys]
            max_v = max(p.shape[0] for p in plist)
            verts = np.stack(
                [
                    np.vstack([p, np.repeat(p[-1:], max_v - p.shape[0], axis=0)])
                    for p in plist
                ]
            )
            n_verts = np.asarray([p.shape[0] for p in plist])
            # plane from the first polygon (reference: all coplanar)
            v0 = plist[0]
            n = np.cross(v0[1] - v0[0], v0[2] - v0[0])
            n /= np.linalg.norm(n)
            if d.found("normal"):
                want = np.asarray(d.get_vector("normal"), float)
                if np.dot(n, want) < 0:
                    n = -n
            return cls(
                name=name, mode=mode, normal=n, p0=v0[0].copy(),
                verts=verts, n_verts=n_verts,
                radii=np.zeros(0), n_sector=0,
                e1=np.zeros(3), e2=np.zeros(3),
                remove_collected=remove, negate_parcels=negate, **thres_kw,
            )
        if mode == "concentricCircle":
            p0 = np.asarray(d.get_vector("origin"), float)
            radii = np.sort(np.asarray([float(r) for r in d.get_list("radius")]))
            n_sector = d.get_int("nSector", 1)
            n = np.asarray(d.get_vector("normal"), float)
            n /= np.linalg.norm(n)
            ref = np.asarray(d.get_vector("refDir", [1.0, 0.0, 0.0]), float)
            e1 = ref - np.dot(ref, n) * n
            if np.linalg.norm(e1) < 1e-12:
                ref = np.array([0.0, 1.0, 0.0])
                e1 = ref - np.dot(ref, n) * n
            e1 /= np.linalg.norm(e1)
            e2 = np.cross(n, e1)
            return cls(
                name=name, mode=mode, normal=n, p0=p0,
                verts=np.zeros((0, 0, 3)), n_verts=np.zeros(0, int),
                radii=radii, n_sector=n_sector, e1=e1, e2=e2,
                remove_collected=remove, negate_parcels=negate, **thres_kw,
            )
        raise NotImplementedError(f"particleCollector mode '{mode}'")

    # ------------------------------------------------------------- state
    def init_state(self, dtype, device="cpu") -> Dict:
        nb = self.n_bins
        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
        st = {
            "mass": z(nb),
            "mom": z(nb),  # Σ mass·|U| for mean velocity
            "hist": z(_N_DBIN),  # mass-weighted d histogram
            "t_open": z(),  # collection time (for flux)
        }
        if self.fixed_mass_remove or self.cont_mass_remove:
            st["accumMass"] = z(nb)
            st["stMFR"] = z(nb)  # smoothed flow rate
        return st

    # ----------------------------------------------------------- collect
    def collect(
        self, cst: Dict, x0, x1, mass, d, U, alive, dt, key=None
    ) -> Tuple[Dict, torch.Tensor]:
        """Accumulate crossings of segment x0→x1; returns (state, collected
        mask) so the caller can remove collected parcels if configured."""
        dtype, dev = mass.dtype, mass.device
        small = 1e-300 if dtype == torch.float64 else 1e-32
        # device copies of the host geometry, made once (a host-to-device
        # copy from pageable memory waits for the card)
        cache = self.__dict__.setdefault("_tables", {})

        def vec(a):
            a = np.asarray(a, np.float64)
            k = (a.tobytes(), a.shape, dtype, dev)
            if k not in cache:
                cache[k] = torch.as_tensor(a, dtype=dtype, device=dev)
            return cache[k]

        n = vec(self.normal)
        s0 = (x0 - vec(self.p0)) @ n
        s1 = (x1 - vec(self.p0)) @ n
        # collect crossings moving WITH the normal; negateParcelsOppositeNormal
        # subtracts opposite crossings (OpenFOAM ParticleCollector semantics)
        with_n = (s0 < 0.0) & (s1 >= 0.0)
        against = (s0 > 0.0) & (s1 <= 0.0)
        crossed = alive & ((with_n | against) if self.negate_parcels else with_n)
        sign = torch.where(with_n, 1.0, -1.0).to(dtype)
        t = s0 / torch.where(torch.abs(s0 - s1) < small, small, s0 - s1)
        p = x0 + t[:, None] * (x1 - x0)

        if self.mode == "polygon":
            # convex point-in-polygon: every edge cross product ((b−a)×(p−a))·n̂
            # shares one sign (orientation-agnostic)
            binof = torch.full(mass.shape, -1, dtype=torch.int64, device=dev)
            for k in range(self.verts.shape[0]):
                nv = int(self.n_verts[k])
                cs = []
                for e in range(nv):
                    a = vec(self.verts[k, e])
                    b = vec(self.verts[k, (e + 1) % nv])
                    cs.append(torch.linalg.cross((b - a).expand(p.shape), p - a) @ n)
                cs = torch.stack(cs)
                inside = (cs >= -1e-12).all(dim=0) | (cs <= 1e-12).all(dim=0)
                binof = torch.where(inside & (binof < 0), k, binof)
        else:
            rel = p - vec(self.p0)
            xp = rel @ vec(self.e1)
            yp = rel @ vec(self.e2)
            r = torch.sqrt(xp**2 + yp**2)
            ring = torch.searchsorted(vec(self.radii), r).to(torch.int64)
            in_r = ring < len(self.radii)
            theta = torch.remainder(torch.atan2(yp, xp), 2.0 * math.pi)
            sec = torch.clamp(
                (theta / (2.0 * math.pi / self.n_sector)).to(torch.int64),
                max=self.n_sector - 1,
            )
            binof = torch.where(in_r, ring * self.n_sector + sec, -1)

        hit = crossed & (binof >= 0)
        w = torch.where(hit, mass * sign, 0.0)
        nb = self.n_bins
        cst = dict(cst)
        bin_safe = torch.where(hit, binof, 0)
        umag = torch.sqrt(torch.sum(U * U, dim=1))
        bins = CellSum(bin_safe, nb, keep=hit)
        both = bins(torch.stack([w, w * umag], dim=1))
        cst["mass"] = cst["mass"] + both[:, 0]
        cst["mom"] = cst["mom"] + both[:, 1]
        dbin = torch.clamp(
            torch.searchsorted(vec(_D_EDGES[1:]), d).to(torch.int64), 0, _N_DBIN - 1
        )
        cst["hist"] = cst["hist"] + cell_sum(w, dbin, _N_DBIN, keep=hit)
        cst["t_open"] = cst["t_open"] + dt
        # MassThres removal (ParticleCollectorFmgMassThres.C:1008-1040)
        if self.fixed_mass_remove or self.cont_mass_remove:
            remove = torch.zeros_like(hit)
            if self.fixed_mass_remove:
                # remove until the bin's accumulated removed mass reaches
                # the threshold, then pass parcels through
                under = cst["accumMass"][bin_safe] < self.mass_thres
                remove = remove | (hit & under)
                cst["accumMass"] = cst["accumMass"] + bins(torch.where(hit & under, mass, 0.0))
            # smoothed flow-rate estimate: st ← α·st + β·massSum/Δt with
            # α = (W−Δt)/W, β = Δt/W (W = smoothingWindow)
            mass_sum = bins(torch.where(hit, mass, 0.0))
            W = self.smoothing_window
            alpha1 = (W - dt) / (W + small)
            beta1 = dt / (W + small)
            cst["stMFR"] = alpha1 * cst["stMFR"] + beta1 * mass_sum / (dt + small)
            if self.cont_mass_remove and key is not None:
                ratio = self.mass_thres / (cst["stMFR"][bin_safe] + small)
                u = prng.uniform(key, tuple(hit.shape), dtype, device=dev)
                remove = remove | (hit & (u > ratio))
            return cst, remove
        return cst, hit

    # ------------------------------------------------------------- write
    def summarise(self, cst: Dict) -> Dict:
        mass = cst["mass"].double().cpu().numpy()
        mom = cst["mom"].double().cpu().numpy()
        hist = cst["hist"].double().cpu().numpy()
        tot = hist.sum()
        dv50 = float("nan")
        if tot > 0:
            cum = np.cumsum(hist) / tot
            i = int(np.searchsorted(cum, 0.5))
            lo = cum[i - 1] if i > 0 else 0.0
            f = (0.5 - lo) / max(cum[i] - lo, 1e-300)
            dv50 = _D_EDGES[i] * (_D_EDGES[i + 1] / _D_EDGES[i]) ** f
        vel = np.where(mass > 0, mom / np.maximum(mass, 1e-300), 0.0)
        return {"mass": mass, "velocity": vel, "dv50": dv50,
                "time": float(cst["t_open"])}


def make_collectors(props: FoamDict) -> List[ParticleCollector]:
    """Parse cloudFunctions { <name> { type particleCollectorFmg; ... } }."""
    cf = props.get_dict("cloudFunctions", FoamDict())
    out = []
    for name, d in cf.subdicts():
        kind = d.get_word("type", "")
        if kind in ("particleCollectorFmg", "particleCollector",
                    "particleCollectorFmgMassThres"):
            out.append(ParticleCollector.from_dict(name, d))
    return out
