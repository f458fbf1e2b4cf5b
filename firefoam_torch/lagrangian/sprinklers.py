"""FM Global sprinkler injection family (lib/injectionModels/*).

The port of firefoam_tpu/lagrangian/sprinklers.py: the four non-"detailed"
sprinkler models, each a fixed-capacity candidate-batch injector (see
injection.py for the batch contract):

  * SprinklerInjection (SprinklerInjection.C) — ANALYTIC spray pattern:
    azimuth×elevation "cells", per-cell 5-coefficient Gaussian fits of
    volume flux / dv50 / sigma / gamma / velocity vs elevation,
    pressure-interpolated between a low/high fit pressure (√p for flux &
    velocity, p^(−1/3) for dv50/σ/γ — SprinklerInjection.C:159-175), with
    K-factor-dependent basis centres (kFactor 205 vs 162) and composite
    lognormal(+stretched-exponential for K162) drop-size CDFs
    (setParticleDiameter :731-813).
  * MultiSprinklerInjection — the same analytic pattern over a positionList
    of heads, each with its own RTI link.
  * LookupTableSprinklerInjection — flat lookup.foam.{header,avgFlux,dv50,
    area,avgVelMag,ele,azi} tables in constant/<tableDirectory>; per batch,
    sampleSize bins sampled UNIFORMLY over the sphere, flux·area-weighted
    parcel masses rescaled to the ideal K·√p flow.
  * LookupTableVolumeFluxSprinklerInjection — same tables, bins sampled
    uniformly over table INDICES, constant dv50/velMag scalars.
  * UniformSamplingSprinklerInjection — uniform-sphere sampling with
    Rosin-Rammler diameters about a scalar dv50 and flux-only weighting.

All support rtiCoeffs link activation (the RTI/C ODE against gas T,|U| at
the head). The per-head sums are order-fixed (tracking.cell_sum).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import INT_DTYPE
from ..io.foamdict import FoamDict, parse_file
from . import prng
from .injection import InjectorBase, rosin_rammler_dv50
from .tracking import cell_sum

__all__ = [
    "AnalyticSprinklerInjection",
    "LookupTableSprinklerInjection",
    "LookupTableVolumeFluxSprinklerInjection",
    "UniformSamplingSprinklerInjection",
]

_PI = math.pi
_RHO_WATER = 1000.0
_SMALL = 1e-300


def _aslist(v):
    return v if isinstance(v, list) else [v]


def _scalars(v):
    return np.asarray([float(x) for x in _aslist(v)], float)


def _small(dtype):
    return 1e-300 if dtype == torch.float64 else 1e-32


# ---------------------------------------------------------------------------
# shared RTI link activation (rtiCoeffs — SprinklerInjection.C:128-152,
# computeLinkTemperature :959-1009)
# ---------------------------------------------------------------------------
class _RtiMixin:
    def _parse_rti(self, d: FoamDict):
        rti = d.get_dict("rtiCoeffs", FoamDict())
        self.rti_active = rti.get_bool("active", False)
        self.RTI = rti.get_scalar("RTI", 200.0)
        self.C_rti = rti.get_scalar("C", 0.0)
        self.T0_link = rti.get_scalar("initialTemperature", 298.0)
        self.T_act = rti.get_scalar("activationTemperature", 432.0)

    def _rti_state(self, n, dtype):
        return {
            "Te": torch.full((n,), self.T0_link, dtype=dtype, device=self.device),
            "t_act": torch.full((n,), -1.0, dtype=dtype, device=self.device),
        }

    def _update_links(self, st, t, dt, gas, cells):
        Tg = gas["T"][cells]
        Ug = torch.sqrt(torch.sum(gas["U"][cells] ** 2, dim=1))
        sqU = torch.sqrt(torch.clamp(Ug, min=1e-6))
        dTe_old = st["Te"] - self.T0_link
        dTe = sqU / self.RTI * ((Tg - self.T0_link) - (1.0 + self.C_rti / sqU) * dTe_old) * dt
        Te = st["Te"] + dTe
        newly = (Te >= self.T_act) & (st["t_act"] < 0.0)
        st = dict(st)
        st["Te"] = Te
        st["t_act"] = torch.where(newly, t, st["t_act"])
        return st


def _direction_frame(d: FoamDict):
    """(direction, arm, dir×arm) orthonormal spray frame."""
    direction = np.asarray(d.get_vector("direction"), float)
    direction /= np.linalg.norm(direction)
    arm = np.asarray(d.get_vector("armDirection"), float)
    arm /= np.linalg.norm(arm)
    return direction, arm, np.cross(direction, arm)


def _dir_vec(ele_deg, azi_deg, direction, t1, t2):
    """parcelDirVec = sin(e)·dir + cos(e)·(t1·cos(a)+t2·sin(a)), elevation
    measured from the horizontal (SprinklerInjection.C:620-639)."""
    er = torch.deg2rad(ele_deg)
    ar = torch.deg2rad(azi_deg)
    v = (
        torch.sin(er)[:, None] * direction
        + torch.cos(er)[:, None] * (t1 * torch.cos(ar)[:, None] + t2 * torch.sin(ar)[:, None])
    )
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=1, keepdim=True)), min=1e-12)


# ---------------------------------------------------------------------------
# analytic SprinklerInjection / MultiSprinklerInjection
# ---------------------------------------------------------------------------

# Gaussian basis (centre, width) per coefficient slot 1..4, by K-factor mode
_BASIS = {
    205: ((15.0, 7.0), (35.0, 15.0), (55.0, 15.0), (90.0, 10.0)),
    162: ((30.0, 15.0), (45.0, 15.0), (60.0, 15.0), (90.0, 5.0)),
}
_VEL_BASIS = {205: ((15.0, 10.0), (60.0, 40.0)), 162: ((45.0, 40.0),)}


def _gauss(coeffs, ele, basis):
    """c0 + Σ ci·exp(−((e−ci_ctr)/w)²) over the basis slots."""
    out = coeffs[..., 0]
    for i, (c, w) in enumerate(basis):
        out = out + coeffs[..., 1 + i] * torch.exp(-(((ele - c) / w) ** 2))
    return out


class AnalyticSprinklerInjection(InjectorBase, _RtiMixin):
    """SprinklerInjection / MultiSprinklerInjection analytic spray."""

    def __init__(self, name: str, d: FoamDict, walk, dtype, multi: bool):
        soi = d.get_scalar("SOI", 0.0)
        dur = d.get_scalar("duration")
        super().__init__(name, soi, dur)
        self.dtype = dtype
        self.device = walk.C.device
        self.p_op = d.get_scalar("operatingPressure")
        self.k_factor = int(d.get_scalar("kFactor"))
        if self.k_factor not in (205, 162):
            raise ValueError(f"{name}: kFactor must be 205 or 162 (got {self.k_factor})")
        self.radius = d.get_scalar("radiusToSprinkler")
        if multi and d.found("positionList"):
            pl = d.get_list("positionList")
            self.positions = np.array([np.asarray(p, float) for p in pl])
        else:
            self.positions = np.asarray(d.get_vector("position"), float)[None, :]
        self.n_spr = len(self.positions)
        self.direction, self.arm, self.tan2 = _direction_frame(d)
        self.pps = d.get_scalar("parcelsPerSecond")
        self.multiple = d.get_bool("multipleParcelsPerCell", True)
        self._parse_rti(d)

        e1 = _scalars(d.get_list("cellEleAngle1"))
        e2 = _scalars(d.get_list("cellEleAngle2"))
        a1 = _scalars(d.get_list("cellAziAngle1"))
        a2 = _scalars(d.get_list("cellAziAngle2"))
        n_cells = len(e1)
        fit_p = _scalars(d.get_list("fitPressureRange"))
        fit_vstd = _scalars(d.get_list("fitVelocityStdevRange"))
        fit_azi = _scalars(d.get_list("fitAzimuthalAngle"))

        def interp(lo_key, hi_key, expo):
            lo = _scalars(d.get_list(lo_key))
            hi = _scalars(d.get_list(hi_key))
            grad = (hi - lo) / (fit_p[1] ** expo - fit_p[0] ** expo)
            return lo + (self.p_op**expo - fit_p[0] ** expo) * grad

        # pressure interpolation: √p for flux/velocity, p^(-1/3) for size
        # shape params (SprinklerInjection.C:159-175)
        coe_flux = interp("fitCoeFluxLowPres", "fitCoeFluxHighPres", 0.5)
        coe_dv50 = interp("fitCoeDv50LowPres", "fitCoeDv50HighPres", -1.0 / 3.0)
        coe_sig = interp("fitCoeSigmaLowPres", "fitCoeSigmaHighPres", -1.0 / 3.0)
        if self.k_factor == 162 and d.found("fitCoeGammaLowPres"):
            coe_gam = interp("fitCoeGammaLowPres", "fitCoeGammaHighPres", -1.0 / 3.0)
        else:
            coe_gam = np.zeros_like(coe_flux)
        coe_vel = interp("fitCoeVelocityLowPres", "fitCoeVelocityHighPres", 0.5)
        gv = (fit_vstd[1] - fit_vstd[0]) / (fit_p[1] ** 0.5 - fit_p[0] ** 0.5)
        self.vel_stdev = fit_vstd[0] + (self.p_op**0.5 - fit_p[0] ** 0.5) * gv

        # mirror the quarter-pattern fit angles over 4 quadrants
        # (SprinklerInjection.C:178-202)
        nfa = len(fit_azi)
        n_all = 4 * (nfa - 1) + 1
        all_azi = np.zeros(n_all)
        all_azi[:nfa] = fit_azi
        per5 = lambda arr: arr.reshape(-1, 5).copy()
        F, D, S, G, V = (per5(x) for x in (coe_flux, coe_dv50, coe_sig, coe_gam, coe_vel))

        def mirrored(tab):
            out = np.zeros((n_all, 5))
            out[:nfa] = tab[:nfa]
            for q in range(1, 4):
                for j in range(1, nfa):
                    out[q * (nfa - 1) + j] = out[q * (nfa - 1) - j]
            return out

        Fm, Dm, Sm, Gm, Vm = (mirrored(x) for x in (F, D, S, G, V))
        for q in range(1, 4):
            for j in range(1, nfa):
                all_azi[q * (nfa - 1) + j] = q * 180.0 - all_azi[q * (nfa - 1) - j]

        # per-cell coefficients = average of fit angles inside the cell
        cC = {k: np.zeros((n_cells, 5)) for k in "FDSGV"}
        for ic in range(n_cells):
            sel = (all_azi >= a1[ic]) & (all_azi < a2[ic])
            if sel.any():
                cC["F"][ic] = Fm[sel].mean(axis=0)
                cC["D"][ic] = Dm[sel].mean(axis=0)
                cC["S"][ic] = Sm[sel].mean(axis=0)
                cC["G"][ic] = Gm[sel].mean(axis=0)
                cC["V"][ic] = Vm[sel].mean(axis=0)

        # per-cell flow rates from the flux fit at the cell-centre elevation
        # (SprinklerInjection.C:272-312), rescaled twice to the profile rate
        area = np.abs(
            self.radius**2
            * (np.sin(np.radians(e2)) - np.sin(np.radians(e1)))
            * (np.radians(a2) - np.radians(a1))
        )
        basis = _BASIS[self.k_factor]
        flow = np.zeros(n_cells)
        for ic in range(n_cells):
            ele = float(int(0.5 * (e1[ic] + e2[ic])))
            if e2[ic] == 90:
                ele = 90.0
            vf = cC["F"][ic][0] + sum(
                cC["F"][ic][1 + i] * math.exp(-(((ele - c) / w) ** 2))
                for i, (c, w) in enumerate(basis)
            )
            flow[ic] = max(area[ic] * vf / 60.0 / 1000.0, 0.0)  # lpm/m² → m³/s
        fr = d.lookup("flowRateProfile")
        target = float(fr[-1] if isinstance(fr, list) else fr)  # m³/s (constant)
        flow *= target / max(flow.sum(), _SMALL)
        flow *= target / max(flow.sum(), _SMALL)
        self.flow_cell = flow
        self.Q = flow.sum()  # m³/s per head
        self.vol_frac = flow / max(flow.sum(), _SMALL)

        # parcels per cell (1..12, ∝ flow/ratioAvgToMin — :330-352)
        avg = flow.sum() / max(n_cells - 1, 1)
        ratio = max((avg - flow.min()) / 6.0, _SMALL)
        npc = np.clip((flow / ratio).astype(int), 1, 12)
        if not self.multiple:
            npc[:] = 1
        self.n_parcels_cell = npc
        self.total_parcels = int(npc.sum())
        # static per-parcel-slot cell index (one batch = total_parcels slots)
        self.slot_cell = np.repeat(np.arange(n_cells), npc)
        self.e1, self.e2, self.a1, self.a2 = e1, e2, a1, a2
        self.cellC = cC

        self.head_cells = np.array([walk.find_cell_host(p) for p in self.positions])
        if (self.head_cells < 0).any():
            raise ValueError(f"{name}: sprinkler position outside mesh")

    def capacity_for_dt(self, dt_max: float) -> int:
        return self.total_parcels * self.n_spr

    def init_state(self) -> Dict:
        kw = dict(dtype=self.dtype, device=self.device)
        st = {
            "n_inj": torch.zeros((), dtype=INT_DTYPE, device=self.device),
            "m_owed": torch.zeros((self.n_spr,), **kw),
            "budget": torch.zeros((), **kw),
        }
        st.update(self._rti_state(self.n_spr, self.dtype))
        return st

    # -- per-parcel property fits at a sampled elevation -------------------
    def _fits(self, slot, ele):
        dtp, dev = self.dtype, self.device
        basis = _BASIS[self.k_factor]
        vbasis = _VEL_BASIS[self.k_factor]
        Dc = self._c("cellCD", self.cellC["D"], dtp)[slot]
        Sc = self._c("cellCS", self.cellC["S"], dtp)[slot]
        Gc = self._c("cellCG", self.cellC["G"], dtp)[slot]
        Vc = self._c("cellCV", self.cellC["V"], dtp)[slot]
        dv50 = _gauss(Dc, ele, basis) * 1e-3
        if self.k_factor == 162:
            dv50 = torch.clamp(dv50, min=0.0004)
        sigma = _gauss(Sc, ele, basis)
        gamma = _gauss(Gc, ele, basis)
        vel = _gauss(Vc, ele, vbasis)
        return dv50, torch.clamp(sigma, min=1e-3), torch.clamp(gamma, min=0.1), vel

    def _sample_diameter(self, key, dv50, sigma, gamma):
        """Composite drop-size CDF over 61 bins (setParticleDiameter):
        lognormal below dv50 (both K-factors); K162 switches to the
        stretched-exponential tail above dv50."""
        dtp = self.dtype
        n_bins = 61
        dmax = torch.clamp(4.0 * dv50, 0.001, 0.006)
        bw = dmax / (n_bins - 1)  # [cap]
        i = torch.arange(1, n_bins, dtype=dtp, device=dv50.device)
        dbin = i[None, :] * bw[:, None]  # [cap, 60]
        logn = (
            torch.exp(-((torch.log(dbin / dv50[:, None])) ** 2) / (2.0 * sigma[:, None] ** 2))
            / (math.sqrt(2.0 * _PI) * sigma[:, None] * dbin)
            * bw[:, None]
        )
        if self.k_factor == 162:
            prev = torch.cat([torch.zeros_like(bw)[:, None], dbin[:, :-1]], dim=1)
            tail = torch.exp(-0.693 * (prev / dv50[:, None]) ** gamma[:, None]) - torch.exp(
                -0.693 * (dbin / dv50[:, None]) ** gamma[:, None]
            )
            pdf = torch.where(dbin <= dv50[:, None], logn, tail)
        else:
            pdf = logn
        cdf = torch.cumsum(pdf, dim=1)
        # cvfCorrect renormalisation of the super-dv50 range (:790-801)
        corr = 1.0 / torch.clamp(cdf[:, -1], min=1e-12)
        cdf = torch.where(
            (corr[:, None] > 1.02) & (dbin > dv50[:, None]), cdf * corr[:, None], cdf
        )
        k = prng.split(key, 2)
        r = torch.clamp(prng.uniform(k[0], tuple(dv50.shape), dtp, device=dv50.device), 0.099,
                        0.959)
        idx = torch.sum((cdf < r[:, None]).to(INT_DTYPE), dim=1)
        idx = torch.clamp(idx + 1, max=n_bins - 1)  # bins are 1-based (bin 0 = 0)
        dsel = idx.to(dtp) * bw
        r2 = prng.uniform(k[1], tuple(dv50.shape), dtp, device=dv50.device)
        return torch.clamp(dsel - bw * r2, 0.000091, 0.006)

    def inject(self, st: Dict, key, t, dt, gas) -> Tuple[Dict, Dict]:
        cap = self.max_per_step
        dtp, dev = self.dtype, self.device
        head_cells = self._c("head_cells", self.head_cells, INT_DTYPE)
        if self.rti_active:
            st = self._update_links(st, t, dt, gas, head_cells)
            active = st["t_act"] >= 0.0
        else:
            st = dict(st)
            active = torch.ones((self.n_spr,), dtype=torch.bool, device=dev)
        in_window = (t >= self.soi) & (t < self.soi + self.duration)

        # batch gating: round(Δt_since_last · pps) ≥ totalParcels fires one
        # full batch (parcelsToInject :533-558)
        budget = st["budget"] + self.pps * dt * torch.where(in_window, 1.0, 0.0)
        fires = budget >= self.total_parcels
        budget = torch.where(fires, budget - self.total_parcels, budget)
        st["budget"] = budget.to(dtp)

        idx = torch.arange(cap, dtype=INT_DTYPE, device=dev)
        spr = idx % self.n_spr
        slot = self._c("slot_cell", self.slot_cell, INT_DTYPE)[idx // self.n_spr]
        valid = fires & active[spr] & in_window

        ks = prng.split(key, 4)
        u1 = prng.uniform(ks[0], cap, dtp, device=dev)
        u2 = prng.uniform(ks[1], cap, dtp, device=dev)
        e1 = self._c("e1", self.e1, dtp)[slot]
        e2 = self._c("e2", self.e2, dtp)[slot]
        a1 = self._c("a1", self.a1, dtp)[slot]
        a2 = self._c("a2", self.a2, dtp)[slot]
        ele = e1 + u1 * (e2 - e1)
        azi = a1 + u2 * (a2 - a1)
        dirv = _dir_vec(
            ele, azi,
            self._c("direction", self.direction, dtp), self._c("arm", self.arm, dtp), self._c("tan2", self.tan2, dtp),
        )
        x = self._c("positions", self.positions, dtp)[spr] + self.radius * dirv

        dv50, sigma, gamma, vel = self._fits(slot, ele)
        dia = self._sample_diameter(ks[2], dv50, sigma, gamma)
        # diameter-dependent velocity attenuation + stdev jitter (:816-840)
        if self.k_factor == 205:
            vel = vel * (1.0 - 0.8 * torch.exp(-((dia / 0.0005) ** 2)))
        else:
            vel = vel * (1.0 - 0.9 * torch.exp(-((dia / 0.0007) ** 2)))
        vel = vel + prng.uniform(ks[3], cap, dtp, device=dev) * self.vel_stdev
        U = vel[:, None] * dirv
        if self.k_factor == 162:
            # hard-coded downward jets in the frame-arm azimuth cells (:842-857)
            azi_mid = 0.5 * (a1 + a2)
            jet = ((azi_mid > -5.0) & (azi_mid < 5.0)) | ((azi_mid > 175.0) & (azi_mid < 185.0))
            dia = torch.where(jet, 0.0031, dia)
            gdir = self._c("direction", self.direction, dtp)
            U = torch.where(jet[:, None], 2.4 * gdir, U)

        # owed-mass accounting: each head accrues Q·ρ·dt, released over its
        # batch ∝ cell volume fractions / parcels-per-cell
        accrue = torch.where(active & in_window, self.Q * _RHO_WATER * dt, 0.0)
        owed = st["m_owed"] + accrue.to(dtp)
        frac = self._c("vol_frac", self.vol_frac, dtp)[slot] / self._c("n_parcels_cell", self.n_parcels_cell, dtp)[slot]
        mass = torch.where(valid, owed[spr] * frac, 0.0)
        st["m_owed"] = torch.where(fires & active & in_window, 0.0, owed)
        st["n_inj"] = st["n_inj"] + torch.sum(valid).to(INT_DTYPE)
        cand = {
            "x": x, "U": U, "d": dia,
            "cell": head_cells[spr],  # the cloud's walk relocalises from the head
            "valid": valid, "mass": mass,
        }
        return st, cand


# ---------------------------------------------------------------------------
# lookup.foam.* table family
# ---------------------------------------------------------------------------
class LookupTableSprinklerInjection(InjectorBase, _RtiMixin):
    """lookupTable sprinkler: flat per-bin tables, uniform-sphere sampling
    (mode='sphere'), per-bin dv50/velMag; subclasses change the sampling
    and size treatment."""

    mode = "sphere"  # 'sphere' | 'index'
    flux_area_weight = True  # mass ∝ flux·area (False: flux only)
    per_bin_size = True  # dv50/velMag from the tables (False: scalars)
    rosin_rammler = False  # UniformSampling: RR diameters about dv50

    def __init__(self, name: str, d: FoamDict, walk, case, dtype):
        soi = d.get_scalar("SOI", 0.0)
        dur = d.get_scalar("duration")
        super().__init__(name, soi, dur)
        self.dtype = dtype
        self.device = walk.C.device
        self.radius_cfg = d.get_scalar("radiusToSprinkler")
        pl = d.get_list("positionList")
        self.positions = np.array([np.asarray(p, float) for p in pl])
        self.n_spr = len(self.positions)
        self.direction, self.arm, self.tan2 = _direction_frame(d)
        self.pps = d.get_scalar("parcelsPerSecond")
        self._parse_rti(d)
        lt = d.get_dict("lookupTableCoeffs", FoamDict())
        self.sample_size = lt.get_int("sampleSize", 100)
        tdir = lt.get_word("tableDirectory", "")
        self._read_tables(case, tdir)
        self.head_cells = np.array([walk.find_cell_host(p) for p in self.positions])
        if (self.head_cells < 0).any():
            raise ValueError(f"{name}: sprinkler position outside mesh")

    def _read_tables(self, case, tdir: str):
        """constant/<tableDirectory>/lookup.foam.* (readTableData)."""
        base = os.path.join(case.root, "constant", tdir) if tdir else os.path.join(
            case.root, "constant"
        )

        def load(suffix):
            return parse_file(os.path.join(base, "lookup.foam." + suffix))

        hdr = load("header")
        self.n_ele = hdr.get_int("nEle")
        self.n_azi = hdr.get_int("nAzi")
        self.pressure = hdr.get_scalar("pressure")
        self.k_factor = hdr.get_scalar("kFactor")
        self.radius = hdr.get_scalar("radius", self.radius_cfg)

        def grab(name, key):
            v = load(name).get_list(key)
            if v and isinstance(v[-1], list):
                v = v[-1]
            return np.asarray([float(x) for x in v], float)

        self.avg_flux = grab("avgFlux", "avgFlux")  # L/s/m² per bin
        self.area = grab("area", "area")
        self.ele = grab("ele", "ele")
        self.azi = grab("azi", "azi")
        if self.per_bin_size:
            self.dv50 = grab("dv50", "dv50")  # m
            self.vel_mag = grab("avgVelMag", "avgVelMag")
        else:
            self.dv50 = None
            self.vel_mag = None
        # scalar fallbacks for the VolumeFlux/UniformSampling variants
        hdr_dv = hdr.lookup("dv50", 0.001)
        self.dv50_scalar = float(hdr_dv[-1] if isinstance(hdr_dv, list) else hdr_dv)
        hdr_v = hdr.lookup("velMag", 10.0)
        self.vel_scalar = float(hdr_v[-1] if isinstance(hdr_v, list) else hdr_v)
        # ideal flow K·√p [L/min] → L/s (computeIdealFlowRate)
        self.ideal_flow = self.k_factor * math.sqrt(max(self.pressure, 0.0)) / 60.0

    def capacity_for_dt(self, dt_max: float) -> int:
        return self.sample_size * self.n_spr

    def init_state(self) -> Dict:
        kw = dict(dtype=self.dtype, device=self.device)
        st = {
            "n_inj": torch.zeros((), dtype=INT_DTYPE, device=self.device),
            "m_owed": torch.zeros((self.n_spr,), **kw),
            "budget": torch.zeros((), **kw),
        }
        st.update(self._rti_state(self.n_spr, self.dtype))
        return st

    def _sample_bins(self, key, cap):
        """Sample table bin indices: uniform over the sphere rounded onto
        the (ele, azi) grid, or uniform over indices (VolumeFlux). The
        sphere draws are float64, as the JAX package's default dtype."""
        k = prng.split(key, 2)
        if self.mode == "sphere":
            u = prng.uniform(k[0], cap, device=self.device)
            theta = torch.floor(u * 360.0)  # rounded degrees
            v = prng.uniform(k[1], cap, device=self.device)
            phi = 90.0 - torch.rad2deg(torch.arccos(torch.clamp(2.0 * v - 1.0, -1.0, 1.0)))
            phi = torch.round(torch.clamp(phi, 0.0, 90.0))
            azi_skip = 360.0 / self.n_azi
            ele_skip = 90.0 / (self.n_ele - 1.0)
            ai = torch.clamp((theta / azi_skip).to(INT_DTYPE), 0, self.n_azi - 1)
            ei = torch.clamp((phi / ele_skip).to(INT_DTYPE), 0, self.n_ele - 1)
        else:
            ai = prng.randint(k[0], cap, 0, self.n_azi, device=self.device)
            ei = prng.randint(k[1], cap, 0, self.n_ele, device=self.device)
        return ei + ai * self.n_ele

    def inject(self, st: Dict, key, t, dt, gas) -> Tuple[Dict, Dict]:
        cap = self.max_per_step
        dtp, dev = self.dtype, self.device
        head_cells = self._c("head_cells", self.head_cells, INT_DTYPE)
        if self.rti_active:
            st = self._update_links(st, t, dt, gas, head_cells)
            active = st["t_act"] >= 0.0
        else:
            st = dict(st)
            active = torch.ones((self.n_spr,), dtype=torch.bool, device=dev)
        in_window = (t >= self.soi) & (t < self.soi + self.duration)

        budget = st["budget"] + self.pps * dt * torch.where(in_window, 1.0, 0.0)
        fires = budget >= self.sample_size
        budget = torch.where(fires, budget - self.sample_size, budget)
        st["budget"] = budget.to(dtp)

        idx = torch.arange(cap, dtype=INT_DTYPE, device=dev)
        spr = idx % self.n_spr
        valid = fires & active[spr] & in_window

        ks = prng.split(key, 3)
        b = self._sample_bins(ks[0], cap)
        ele = self._c("ele", self.ele, dtp)[b]
        azi = self._c("azi", self.azi, dtp)[b]
        flux = self._c("avg_flux", self.avg_flux, dtp)[b]
        area = self._c("area", self.area, dtp)[b]
        if self.per_bin_size:
            dia = self._c("dv50", self.dv50, dtp)[b]
            vel = self._c("vel_mag", self.vel_mag, dtp)[b]
        else:
            dia = torch.full((cap,), self.dv50_scalar, dtype=dtp, device=dev)
            vel = torch.full((cap,), self.vel_scalar, dtype=dtp, device=dev)
        if self.rosin_rammler:
            dia = rosin_rammler_dv50(ks[1], dia).to(dtp)

        dirv = _dir_vec(
            ele, azi,
            self._c("direction", self.direction, dtp), self._c("arm", self.arm, dtp), self._c("tan2", self.tan2, dtp),
        )
        x = self._c("positions", self.positions, dtp)[spr] + self.radius * dirv
        U = vel[:, None] * dirv

        # mass weights ∝ flux(·area), normalised per head, released from the
        # owed account accrued at the ideal K·√p flow (sampleInjectionTable
        # ratio rescaling)
        w = flux * area if self.flux_area_weight else flux
        w = torch.where(valid, w, 0.0)
        wsum = cell_sum(w, spr, self.n_spr, keep=valid)
        accrue = torch.where(active & in_window, self.ideal_flow * 1e-3 * _RHO_WATER * dt, 0.0)
        owed = st["m_owed"] + accrue.to(dtp)
        mass = torch.where(valid, owed[spr] * w / torch.clamp(wsum[spr], min=_small(dtp)), 0.0)
        st["m_owed"] = torch.where(fires & active & in_window, 0.0, owed)
        st["n_inj"] = st["n_inj"] + torch.sum(valid).to(INT_DTYPE)
        cand = {
            "x": x, "U": U, "d": dia, "cell": head_cells[spr],
            "valid": valid, "mass": mass,
        }
        return st, cand


class LookupTableVolumeFluxSprinklerInjection(LookupTableSprinklerInjection):
    """Volume-flux-table variant: uniform INDEX sampling, flux·area mass
    weighting, constant dv50/velMag scalars (LookupTableVolumeFlux
    SprinklerInjection.C sampleInjectionTable)."""

    mode = "index"
    flux_area_weight = True
    per_bin_size = False


class UniformSamplingSprinklerInjection(LookupTableSprinklerInjection):
    """Uniform-sphere sampling with Rosin-Rammler diameters about the
    table dv50 and flux-only weighting (UniformSamplingSprinkler
    Injection.C sampleInjectionTable)."""

    mode = "sphere"
    flux_area_weight = False
    per_bin_size = False
    rosin_rammler = True
