"""Parcel injection models: cone sprays and FM-style sprinkler tables.

The port of firefoam_tpu/lagrangian/injection.py:
  - base contract (reference InjectionModel.H:282-364): each step an
    injector yields `parcelsToInject` new parcels with position/cell/
    properties. Every injector emits a fixed-capacity candidate batch
    (static shape) with a validity mask: data-dependent parcel counts
    become masks, never dynamic shapes, and nothing is read on the host.
  - `ConeInjection` (submodels/Kinematic/InjectionModel/ConeInjection):
    per-position cone spray between thetaInner/thetaOuter with a size
    distribution and mass-based parcel weighting.
  - `DetailedSprinklerInjection` (lib/injectionModels/
    DetailedSprinklerInjection — FM Global's model): pressure-interpolated
    (elevation × azimuth) lookup tables of volume flux / dv50 / velocity
    magnitude sampled per parcel, K-factor total flow, truncated
    Rosin-Rammler (n = 2.6) diameters (DetailedSprinklerInjection.C:
    1483-1499), RTI/C link activation against gas T,|U| at the sprinkler.
  - `PatchInjection`: parcels released over a patch's faces.

Random draws come from `prng` (JAX's generator, bit for bit), in the JAX
package's order, so both packages inject the same parcels from one key.
Injector state lives in the cloud state (cumulative counts, link
temperatures), so checkpoints capture activation history. The film's drip
re-injection (`FilmDripInjection`) is added by the solver when a film
drips. The stock injectors (manual, cellZone, fieldActivated, the lookup
tables, coneNozzle, inflation, none) are in injection_stock.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import INT_DTYPE
from ..io.foamdict import FoamDict
from . import prng

__all__ = [
    "make_injector",
    "ConeInjection",
    "DetailedSprinklerInjection",
    "PatchInjection",
    "FilmDripInjection",
]

_PI = math.pi
# the JAX package's host guard (float64 runs); injector tables are built in
# float64 on the host whatever the run's dtype
_SMALL = 1e-300

# gpm/psi^0.5 K-factor → m3/s at p[psig]:  Q[gpm] = K·√p;  1 gpm = 6.30902e-5 m3/s
_GPM_TO_M3S = 6.30902e-5

# the stock injectors (injection_stock.py)
STOCK_KINDS = (
    "manualInjection", "cellZoneInjection", "fieldActivatedInjection",
    "kinematicLookupTableInjection", "thermoLookupTableInjection",
    "reactingLookupTableInjection",
    "reactingMultiphaseLookupTableInjection", "coneNozzleInjection",
    "none", "noInjection", "inflationInjection",
)


# ---------------------------------------------------------------------------
# size distributions (src distributionModels; configured like the
# sizeDistribution of a cloud's injector)
# ---------------------------------------------------------------------------
def _make_size_sampler(d: FoamDict):
    """sample(key, n, device) -> [n] float64 diameters on `device`."""
    kind = d.get_word("type")
    cfg = d.get_dict(kind + "Distribution", None) or d.get_dict(kind, None) or d

    if kind == "uniform":
        lo = cfg.get_scalar("minValue")
        hi = cfg.get_scalar("maxValue")

        def sample(key, n, device):
            return prng.uniform(key, n, torch.float64, lo, hi, device)

    elif kind == "fixedValue":
        val = cfg.get_scalar("value")

        def sample(key, n, device):
            return torch.full((n,), val, dtype=torch.float64, device=device)

    elif kind == "normal":
        mu = cfg.get_scalar("expectation")
        sd = cfg.get_scalar("variance") ** 0.5 if cfg.found("variance") else cfg.get_scalar("standardDeviation")
        lo = cfg.get_scalar("minValue")
        hi = cfg.get_scalar("maxValue")

        def sample(key, n, device):
            return torch.clamp(mu + sd * prng.normal(key, n, device=device), lo, hi)

    elif kind in ("RosinRammler", "rosinRammler"):
        dref = cfg.get_scalar("d")
        nexp = cfg.get_scalar("n")
        lo = cfg.get_scalar("minValue")
        hi = cfg.get_scalar("maxValue")
        K = 1.0 - math.exp(-(((hi - lo) / dref) ** nexp))

        def sample(key, n, device):
            y = prng.uniform(key, n, device=device)
            return lo + dref * (-torch.log(1.0 - y * K)) ** (1.0 / nexp)

    else:
        raise NotImplementedError(f"sizeDistribution type '{kind}'")
    return sample


def rosin_rammler_dv50(key, dv50, n_exp: float = 2.6):
    """Truncated Rosin-Rammler sample given a (per-parcel) dv50 —
    DetailedSprinklerInjection.C:1483-1499 (FDS-recommended n = 2.6). The
    draw is float64, so a float32 dv50 promotes as in the JAX package."""
    small = 1e-300 if dv50.dtype == torch.float64 else 1e-32
    d_ = dv50 / 0.693 ** (1.0 / n_exp)
    max_v = d_ * 6.9077 ** (1.0 / n_exp)
    min_v = torch.clamp(0.001 * d_ * 0.1054 ** (1.0 / n_exp), min=2e-6)
    K = 1.0 - torch.exp(-(((max_v - min_v) / (d_ + small)) ** n_exp))
    y = prng.uniform(key, tuple(dv50.shape), device=dv50.device)
    return min_v + d_ * (-torch.log(1.0 - y * K)) ** (1.0 / n_exp)


def _orthonormal_frame(axis: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    a = axis / np.linalg.norm(axis)
    t = np.array([1.0, 0.0, 0.0]) if abs(a[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    e1 = np.cross(a, t)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(a, e1)
    return e1, e2


# ---------------------------------------------------------------------------
@dataclass
class InjectorBase:
    name: str
    soi: float
    duration: float
    max_per_step: int = 0

    def _c(self, key, a, dtype):
        """The device copy of a host table, made once: a host-to-device copy
        from pageable memory waits for the card, so none runs per step."""
        cache = self.__dict__.setdefault("_tables", {})
        if (key, dtype) not in cache:
            cache[(key, dtype)] = torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)
        return cache[(key, dtype)]

    def init_state(self) -> Dict:
        # m_owed accumulates mass for steps where no parcel fires (the
        # reference InjectionModel holds timeStep0_ so un-injected mass is
        # carried to the next firing step rather than dropped). float64,
        # as the JAX package's default-dtype zeros.
        return {
            "n_inj": torch.zeros((), dtype=INT_DTYPE, device=self.device),
            "m_owed": torch.zeros((), dtype=torch.float64, device=self.device),
        }


# ---------------------------------------------------------------------------
class ConeInjection(InjectorBase):
    """Multi-position cone spray (ConeInjection submodel)."""

    def __init__(self, name: str, d: FoamDict, walk, dtype):
        soi = d.get_scalar("SOI")
        dur = d.get_scalar("duration")
        super().__init__(name, soi, dur)
        self.dtype = dtype
        self.device = walk.C.device
        pa = d.get_list("positionAxis")
        self.positions = np.array([np.asarray(p[0], float) for p in pa])
        axes = [np.asarray(p[1], float) for p in pa]
        self.axes = np.array([a / np.linalg.norm(a) for a in axes])
        self.frames = np.array([_orthonormal_frame(a) for a in self.axes])
        self.n_pos = len(self.positions)
        self.mass_total = d.get_scalar("massTotal", 0.0)
        self.pps = d.get_scalar("parcelsPerSecond")
        self.umag = _constant_profile(d, "Umag")
        self.theta_i = math.radians(_constant_profile(d, "thetaInner"))
        self.theta_o = math.radians(_constant_profile(d, "thetaOuter"))
        self.size_sampler = _make_size_sampler(d.get_dict("sizeDistribution"))
        # flowRateProfile: only 'constant' supported → uniform mass rate
        self.mass_rate = self.mass_total / max(dur, _SMALL)
        self.cells = np.array([walk.find_cell_host(p) for p in self.positions])
        if (self.cells < 0).any():
            raise ValueError(f"{name}: injector position outside mesh")

    def capacity_for_dt(self, dt_max: float) -> int:
        return max(1, int(math.ceil(self.pps * dt_max)) + 1, self.n_pos)

    def inject(self, st: Dict, key, t, dt, gas) -> Tuple[Dict, Dict]:
        cap = self.max_per_step
        dtp, dev = self.dtype, self.device
        # cumulative-count injection (InjectionModel::parcelsToInject)
        el0 = torch.clamp(t - self.soi, 0.0, self.duration)
        el1 = torch.clamp(t + dt - self.soi, 0.0, self.duration)
        want = torch.floor(el1 * self.pps).to(INT_DTYPE) - st["n_inj"]
        n_new = torch.clamp(want, 0, cap)
        mass_new = self.mass_rate * (el1 - el0)

        ks = prng.split(key, 4)
        idx = torch.arange(cap, dtype=INT_DTYPE, device=dev)
        valid = idx < n_new
        pos_id = (st["n_inj"] + idx) % self.n_pos

        x = self._c("positions", self.positions, dtp)[pos_id]
        cell = self._c("cells", self.cells, INT_DTYPE)[pos_id]
        axis = self._c("axes", self.axes, dtp)[pos_id]
        e1 = self._c("e1", self.frames[:, 0], dtp)[pos_id]
        e2 = self._c("e2", self.frames[:, 1], dtp)[pos_id]

        # uniform in solid angle between thetaInner and thetaOuter
        u = prng.uniform(ks[0], cap, dtp, device=dev)
        cos_t = math.cos(self.theta_i) + u * (math.cos(self.theta_o) - math.cos(self.theta_i))
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t**2, min=0.0))
        phi = prng.uniform(ks[1], cap, dtp, device=dev) * 2.0 * _PI
        dirv = (
            axis * cos_t[:, None]
            + (e1 * torch.cos(phi)[:, None] + e2 * torch.sin(phi)[:, None]) * sin_t[:, None]
        )
        U = self.umag * dirv
        dia = self.size_sampler(ks[2], cap, dev).to(dtp)
        # mass-basis parcel weighting: all mass owed since the last firing
        # step (this step's + carried-over) split over this step's parcels
        owed = st["m_owed"] + mass_new
        mass_per = torch.where(n_new > 0, owed / torch.clamp(n_new, min=1), 0.0)
        st = {
            "n_inj": st["n_inj"] + n_new,
            "m_owed": torch.where(n_new > 0, 0.0, owed),
        }
        cand = {
            "x": x, "U": U, "d": dia, "cell": cell, "valid": valid,
            "mass": torch.where(valid, mass_per, 0.0),
        }
        return st, cand


def _unwrap_list(v):
    """'phi List<scalar> 42 ( ... )' tokenises as [String, 42, [...]] —
    unwrap to the trailing value list."""
    if v and isinstance(v[-1], list):
        return v[-1]
    return v


def _midpoint_edges(phi_tab: np.ndarray, theta_tab: np.ndarray):
    """v1 bin-edge reconstruction from cell centres (computeAreas :1125-1160):
    interior edges are midpoints of neighbouring centres; the first elevation
    edge is pinned to 0° while the outermost elevation/azimuth edges coincide
    with the outermost centres. Tables are [nAzi, nEle]."""
    ele_lo = np.empty_like(theta_tab)
    ele_hi = np.empty_like(theta_tab)
    mid_e = 0.5 * (theta_tab[:, :-1] + theta_tab[:, 1:])  # [nAzi, nEle-1]
    ele_lo[:, 0] = 0.0
    ele_lo[:, 1:] = mid_e
    ele_hi[:, :-1] = mid_e
    ele_hi[:, -1] = theta_tab[:, -1]
    azi_lo = np.empty_like(phi_tab)
    azi_hi = np.empty_like(phi_tab)
    mid_a = 0.5 * (phi_tab[:-1, :] + phi_tab[1:, :])  # [nAzi-1, nEle]
    azi_lo[0, :] = phi_tab[0, :]
    azi_lo[1:, :] = mid_a
    azi_hi[:-1, :] = mid_a
    azi_hi[-1, :] = phi_tab[-1, :]
    return azi_lo, azi_hi, ele_lo, ele_hi


def _constant_profile(d: FoamDict, key: str) -> float:
    v = d.lookup(key)
    if isinstance(v, list):  # e.g. "constant 4.0" parses as [String, 4.0]
        return float(v[-1])
    return float(v)


# ---------------------------------------------------------------------------
class DetailedSprinklerInjection(InjectorBase):
    """FM Global detailed sprinkler spray from measured (ele×azi) tables.

    version=1: DetailedSprinklerInjection.C — per-pressure phi/theta tables,
    bin edges reconstructed by the midpoint rule (computeAreas :1100-1185),
    RTI default 200, scalar |U| link ODE.
    version=2: DetailedSprinklerInjection2.C — phiMinMax/thetaMinMax bin-edge
    lists in the table dict (:991-1031), RTI default 22 plus RTI_deflector,
    link ODE split into deflector-normal/tangential components (:748-760).
    Both inject the ideal K-factor flow in total (v1 volumeTotal_ :232,
    v2 normalises the measured fluxes by input/ideal ratio :1201-1211).
    """

    def __init__(self, name: str, d: FoamDict, walk, case, dtype, version: int = 1):
        soi = d.get_scalar("SOI")
        dur = d.get_scalar("duration")
        super().__init__(name, soi, dur)
        self.dtype = dtype
        self.device = walk.C.device
        self.version = version
        lt = d.get_dict("lookupTableCoeffs")
        self.table_name = lt.get_word("tableName")
        self.p_op = lt.get_scalar("operatingPressure")  # psig
        self.pps = d.get_scalar("parcelsPerSecond")
        pl = d.get_list("positionList")
        self.positions = np.array([np.asarray(p, float) for p in pl])
        self.n_spr = len(self.positions)
        self.direction = np.asarray(d.get_vector("direction"), float)
        self.direction /= np.linalg.norm(self.direction)
        self.arm = np.asarray(d.get_vector("armDirection"), float)
        self.arm /= np.linalg.norm(self.arm)
        self.radius = d.get_scalar("radiusToSprinkler")
        self.momentum_eff = d.get_scalar("momentumEfficiency", 0.8)
        self.reduction_factor = d.get_scalar("reductionFactor", 0.0)
        rti = d.get_dict("rtiCoeffs", FoamDict())
        self.rti_active = rti.get_bool("active", False)
        rti_default = 22.0 if version == 2 else 200.0
        self.RTI = rti.get_scalar("RTI", rti_default)
        self.RTI_deflector = rti.get_scalar("RTI_deflector", self.RTI)
        self.C = rti.get_scalar("C", 0.0)
        self.T0_link = rti.get_scalar("initialTemperature", 298.15)
        self.T_act = rti.get_scalar("activationTemperature", 432.0)

        self._read_table(case)
        self.cells = np.array([walk.find_cell_host(p) for p in self.positions])
        if (self.cells < 0).any():
            raise ValueError(f"{name}: sprinkler position outside mesh")
        self.walk = walk

    # -- table ingestion (readTableData v1 :930-1000 / v2 :960-1035)
    def _read_table(self, case):
        tdict = case.constant(self.table_name)
        self.k_factor = tdict.get_scalar("kFactor")  # gpm/psi^0.5
        n_ele = tdict.get_int("nEle")
        n_azi = tdict.get_int("nAzi")
        sampled_radius = tdict.get_scalar("radius", self.radius)
        v2_format = tdict.found("phiMinMax") and tdict.found("thetaMinMax")
        if v2_format:
            # v2: bin EDGES shipped directly; cell centres are mid-edges
            # (DetailedSprinklerInjection2.C:1013-1031)
            phi_e = np.asarray(_unwrap_list(tdict.get_list("phiMinMax")), float)
            the_e = np.asarray(_unwrap_list(tdict.get_list("thetaMinMax")), float)
            n_azi = len(phi_e) - 1
            n_ele = len(the_e) - 1
            self.phi_tab = np.broadcast_to(
                0.5 * (phi_e[:-1] + phi_e[1:])[:, None], (n_azi, n_ele)
            ).copy()
            self.theta_tab = np.broadcast_to(
                0.5 * (the_e[:-1] + the_e[1:])[None, :], (n_azi, n_ele)
            ).copy()
            azi_lo = np.broadcast_to(phi_e[:-1][:, None], (n_azi, n_ele))
            azi_hi = np.broadcast_to(phi_e[1:][:, None], (n_azi, n_ele))
            ele_lo = np.broadcast_to(the_e[:-1][None, :], (n_azi, n_ele))
            ele_hi = np.broadcast_to(the_e[1:][None, :], (n_azi, n_ele))
        press = tdict.get_dict("pressures")
        entries = []
        for _, sub in press.subdicts():
            p = sub.get_scalar("pressure")

            def grab(k):
                return np.asarray(_unwrap_list(sub.get_list(k)), float).reshape(n_azi, n_ele)

            phi_th = (None, None) if v2_format else (grab("phi"), grab("theta"))
            entries.append(
                (p, phi_th[0], phi_th[1], grab("volFlux"), grab("dv50"),
                 grab("velMag"), sub.get_scalar("velocityCorrection", 1.0))
            )
        entries.sort(key=lambda e: e[0])
        ps = np.array([e[0] for e in entries])
        # linear interpolation in pressure at the operating pressure; outside
        # the table range the reference linearly EXTRAPOLATES from the end
        # segment (interpolatePressure, both versions) — so no clamping
        po = self.p_op
        hi = int(np.searchsorted(ps, po, side="left").clip(1, len(ps) - 1))
        lo = hi - 1
        f = (po - ps[lo]) / max(ps[hi] - ps[lo], _SMALL)
        blend = lambda i: (1 - f) * entries[lo][i] + f * entries[hi][i]
        if not v2_format:
            self.phi_tab = blend(1)  # deg [nAzi, nEle]
            self.theta_tab = blend(2)
            azi_lo, azi_hi, ele_lo, ele_hi = _midpoint_edges(self.phi_tab, self.theta_tab)
        vol_flux = blend(3)  # L/m2/s
        self.dv50_tab = blend(4) * 1e-3  # mm → m
        vel_corr = blend(6)
        self.vel_tab = blend(5) * self.momentum_eff * vel_corr

        # per-bin sampled area at the measurement radius:
        #   A = R²·(sin e2 − sin e1)·Δazi_rad    (computeAreas :1170-1171)
        d2r = math.pi / 180.0
        area = (
            sampled_radius ** 2
            * (np.sin(d2r * ele_hi) - np.sin(d2r * ele_lo))
            * d2r * (azi_hi - azi_lo)
        )
        area = np.abs(area)
        # under-nozzle reduction: scale = (1−rf) at ele 90° → 1 at 0°
        # (computeVolFlow :1195-1200)
        rf = self.reduction_factor
        scale = (1.0 - rf) - ((90.0 - self.theta_tab) / 90.0) * ((1.0 - rf) - 1.0)
        # bin sampling probability ∝ volFlow = volFlux·area·scale
        # (weightedSampling :1285-1305)
        w = (vol_flux * area * scale).ravel()
        w = np.maximum(w, 0.0)
        self.bin_p = w / max(w.sum(), _SMALL)
        self.n_bins = w.size
        self.n_ele, self.n_azi = n_ele, n_azi
        # total volumetric flow from the K-factor at operating pressure
        # (both versions inject the ideal flow: v1 volumeTotal_ :232)
        self.Q = self.k_factor * math.sqrt(max(self.p_op, 0.0)) * _GPM_TO_M3S  # m3/s

    def capacity_for_dt(self, dt_max: float) -> int:
        return max(1, int(math.ceil(self.pps * dt_max * self.n_spr)) + self.n_spr)

    def init_state(self) -> Dict:
        st = super().init_state()
        kw = dict(dtype=self.dtype, device=self.device)
        st["Te"] = torch.full((self.n_spr,), self.T0_link, **kw)
        st["t_act"] = torch.full((self.n_spr,), -1.0, **kw)
        st["m_owed"] = torch.zeros((self.n_spr,), **kw)  # per-sprinkler
        return st

    def _update_links(self, st, t, dt, gas) -> Dict:
        """RTI link ODE against gas T,|U| at the sprinkler cells — the
        reference's DetailedSprinklerInjection activation and solver/rti.H:
        34-47. v2 splits the convective coefficient into deflector-normal
        (|U·dir|, RTI_deflector) and tangential (|U×dir|, RTI) parts
        (DetailedSprinklerInjection2.C:748-760)."""
        cells = self._c("cells", self.cells, INT_DTYPE)
        Tg = gas["T"][cells]
        Ucell = gas["U"][cells]
        dTg = Tg - self.T0_link
        dTe_old = st["Te"] - self.T0_link
        if self.version == 2:
            dirv = self._c("direction", self.direction, self.dtype)
            Un = torch.abs(Ucell @ dirv)
            cr = torch.linalg.cross(Ucell, dirv[None, :].expand_as(Ucell))
            Ut = torch.sqrt(torch.clamp(torch.sum(cr**2, dim=1), min=0.0))
            sqUn = torch.sqrt(torch.clamp(Un, min=1e-6))
            sqUt = torch.sqrt(torch.clamp(Ut, min=1e-6))
            coeff = (
                sqUn / self.RTI_deflector * (dTg - (1.0 + self.C / sqUn) * dTe_old)
                + sqUt / self.RTI * (dTg - (1.0 + self.C / sqUt) * dTe_old)
            )
            dTe = coeff * dt
        else:
            Ug = torch.sqrt(torch.sum(Ucell**2, dim=1))
            sqU = torch.sqrt(torch.clamp(Ug, min=1e-6))
            dTe = sqU / self.RTI * (dTg - (1.0 + self.C / sqU) * dTe_old) * dt
        Te = st["Te"] + dTe
        newly = (Te >= self.T_act) & (st["t_act"] < 0.0)
        st = dict(st)
        st["Te"] = Te
        st["t_act"] = torch.where(newly, t, st["t_act"])
        return st

    def inject(self, st: Dict, key, t, dt, gas) -> Tuple[Dict, Dict]:
        cap = self.max_per_step
        dtp, dev = self.dtype, self.device
        if self.rti_active:
            st = self._update_links(st, t, dt, gas)
            active = st["t_act"] >= 0.0  # [nSpr]
        else:
            st = dict(st)
            active = torch.ones((self.n_spr,), dtype=torch.bool, device=dev)
        in_window = (t >= self.soi) & (t < self.soi + self.duration)

        per_spr = cap // self.n_spr
        want = torch.floor(torch.clamp(t + dt - self.soi, 0.0, self.duration) * self.pps).to(INT_DTYPE)
        n_per = torch.clamp(want - torch.div(st["n_inj"], self.n_spr, rounding_mode="floor"),
                            0, per_spr)

        idx = torch.arange(cap, dtype=INT_DTYPE, device=dev)
        spr = idx % self.n_spr
        k_in_spr = idx // self.n_spr
        valid = (k_in_spr < n_per) & active[spr] & in_window

        ks = prng.split(key, 5)
        # sample table bin ∝ volFlux·sinθ
        cdf = torch.cumsum(self._c("bin_p", self.bin_p, dtp), dim=0)
        u = prng.uniform(ks[0], cap, dtp, device=dev)
        b = torch.searchsorted(cdf, u).to(INT_DTYPE)
        theta = torch.deg2rad(self._c("theta_tab", self.theta_tab.ravel(), dtp))[b]
        phi = torch.deg2rad(self._c("phi_tab", self.phi_tab.ravel(), dtp))[b]
        dv50 = self._c("dv50_tab", self.dv50_tab.ravel(), dtp)[b]
        vmag = self._c("vel_tab", self.vel_tab.ravel(), dtp)[b]
        # jitter within the bin + mirror the quarter-table over 4 quadrants
        quad = prng.randint(ks[1], cap, 0, 4, device=dev)
        # (π in float64: torch.where of two Python floats would be float32)
        phi_full = torch.where(quad % 2 == 0, phi, _PI - phi) + _PI * (quad >= 2).to(torch.float64)

        a = self._c("direction", self.direction, dtp)  # spray axis (down)
        e1 = self._c("arm", self.arm, dtp)
        e2 = self._c("e2", np.cross(self.direction, self.arm), dtp)
        dirv = (
            a * torch.cos(theta)[:, None]
            + (e1 * torch.cos(phi_full)[:, None] + e2 * torch.sin(phi_full)[:, None])
            * torch.sin(theta)[:, None]
        )
        x = self._c("positions", self.positions, dtp)[spr] + self.radius * dirv
        U = vmag[:, None] * dirv
        dia = rosin_rammler_dv50(ks[2], dv50).to(dtp)
        # per-parcel mass: each active sprinkler's K-factor flow accrues into
        # a per-sprinkler owed-mass account, released over that sprinkler's
        # parcels when a batch fires (the reference's timeStep0_ semantics)
        rho_l = 1000.0
        accrue = torch.where(active & in_window, self.Q * rho_l * dt, 0.0)
        owed = st["m_owed"] + accrue.to(dtp)
        fires = (n_per > 0) & active & in_window  # [nSpr]
        mass_per_spr = torch.where(fires, owed / torch.clamp(n_per, min=1), 0.0)
        st["m_owed"] = torch.where(fires, 0.0, owed)
        cell = self._c("cells", self.cells, INT_DTYPE)[spr]  # walk relocalises

        n_new = torch.sum(valid).to(INT_DTYPE)
        st["n_inj"] = st["n_inj"] + n_new
        cand = {
            "x": x, "U": U, "d": dia, "cell": cell, "valid": valid,
            "mass": torch.where(valid, mass_per_spr[spr], 0.0),
        }
        return st, cand


# ---------------------------------------------------------------------------
class PatchInjection(InjectorBase):
    """Parcels released over a patch's faces (stock PatchInjection,
    submodels/Kinematic/InjectionModel/PatchInjection): face sampled ∝
    area, released just inside the owner cell with velocity U0."""

    def __init__(self, name: str, d: FoamDict, geom, dtype):
        soi = d.get_scalar("SOI", 0.0)
        dur = d.get_scalar("duration")
        super().__init__(name, soi, dur)
        self.dtype = dtype
        self.device = geom.C.device
        patch = geom.patch(d.get_word("patchName", d.get_word("patch", "")))
        sl = patch.slice
        self.cells = geom.b_own[sl].cpu().numpy()
        Cf = geom.b_Cf[sl].double().cpu().numpy()
        C = geom.C.double().cpu().numpy()[self.cells]
        # release point nudged off the face into the owner cell
        self.x_rel = Cf + 0.05 * (C - Cf)
        area = geom.b_magSf[sl].double().cpu().numpy()
        self.face_cdf = np.cumsum(area) / area.sum()
        self.U0 = np.asarray(d.get_vector("U0"), float)
        self.pps = d.get_scalar("parcelsPerSecond")
        self.mass_total = d.get_scalar("massTotal", 0.0)
        self.mass_rate = self.mass_total / max(dur, _SMALL)
        self.size_sampler = _make_size_sampler(d.get_dict("sizeDistribution"))

    def capacity_for_dt(self, dt_max: float) -> int:
        return max(1, int(math.ceil(self.pps * dt_max)) + 1)

    def inject(self, st: Dict, key, t, dt, gas) -> Tuple[Dict, Dict]:
        cap = self.max_per_step
        dtp, dev = self.dtype, self.device
        el0 = torch.clamp(t - self.soi, 0.0, self.duration)
        el1 = torch.clamp(t + dt - self.soi, 0.0, self.duration)
        want = torch.floor(el1 * self.pps).to(INT_DTYPE) - st["n_inj"]
        n_new = torch.clamp(want, 0, cap)
        mass_new = self.mass_rate * (el1 - el0)

        ks = prng.split(key, 2)
        idx = torch.arange(cap, dtype=INT_DTYPE, device=dev)
        valid = idx < n_new
        u = prng.uniform(ks[0], cap, dtp, device=dev)
        f = torch.searchsorted(self._c("face_cdf", self.face_cdf, dtp), u).to(INT_DTYPE)
        f = torch.clamp(f, max=len(self.cells) - 1)
        x = self._c("x_rel", self.x_rel, dtp)[f]
        cell = self._c("cells", self.cells, INT_DTYPE)[f]
        U = self._c("U0", self.U0, dtp).expand(cap, 3)
        dia = self.size_sampler(ks[1], cap, dev).to(dtp)
        owed = st["m_owed"] + mass_new
        mass_per = torch.where(n_new > 0, owed / torch.clamp(n_new, min=1), 0.0)
        st = {
            "n_inj": st["n_inj"] + n_new,
            "m_owed": torch.where(n_new > 0, 0.0, owed),
        }
        cand = {
            "x": x, "U": U, "d": dia, "cell": cell, "valid": valid,
            "mass": torch.where(valid, mass_per, 0.0),
        }
        return st, cand


# ---------------------------------------------------------------------------
class FilmDripInjection(InjectorBase):
    """Film → cloud drip re-injection (the reference's surfaceFilm().inject:
    KinematicCloud.C:186 on the cloud side, drippingInjection on the film's).

    Takes the film's dripped-mass flux per boundary face (gas["film_drip_b"],
    kg/m²/s, set each step by the solver) into an owed-mass account; parcels
    leave from the film face centres (nudged into the gas) with the film's
    velocity there plus a small kick along gravity, sizes uniform in
    [d_min, d_max], particlesPerParcel particles each, as many as the owed
    mass affords."""

    def __init__(self, name, geom, bidx, d_min, d_max, n_per_parcel, g_vec,
                 dtype=torch.float64, max_parcels_per_step: int = 64, rho_l: float = 1000.0):
        super().__init__(name, soi=0.0, duration=1e30)
        self.dtype = dtype
        self.device = geom.C.device
        self.geom = geom
        self.bidx = np.asarray(bidx)  # film-covered boundary-face indices
        self.d_min, self.d_max = d_min, d_max
        self.n_per_parcel = n_per_parcel
        self.rho_l = rho_l
        self.max_per_step = max_parcels_per_step
        own = geom.b_own.cpu().numpy()[self.bidx]
        Cf = geom.b_Cf.double().cpu().numpy()[self.bidx]
        C = geom.C.double().cpu().numpy()[own]
        self.cells = own
        self.x_rel = Cf + 0.1 * (C - Cf)
        g = np.asarray(g_vec, float)
        self.g_hat = g / max(np.linalg.norm(g), 1e-12)
        self.areas = geom.b_magSf.double().cpu().numpy()[self.bidx]

    def capacity_for_dt(self, dt_max: float) -> int:
        return self.max_per_step

    def init_state(self) -> Dict:
        return {"n_inj": torch.zeros((), dtype=INT_DTYPE, device=self.device),
                "m_owed": torch.zeros((), dtype=self.dtype, device=self.device)}

    def inject(self, st: Dict, key, t, dt, gas) -> Tuple[Dict, Dict]:
        cap = self.max_per_step
        dtp, dev = self.dtype, self.device
        drip_b = gas.get("film_drip_b")  # [nB] kg/m²/s
        if drip_b is None or self.bidx.size == 0:
            return dict(st), {
                "x": torch.zeros((cap, 3), dtype=dtp, device=dev),
                "U": torch.zeros((cap, 3), dtype=dtp, device=dev),
                "d": torch.full((cap,), self.d_min, dtype=dtp, device=dev),
                "cell": torch.zeros((cap,), dtype=INT_DTYPE, device=dev),
                "valid": torch.zeros((cap,), dtype=torch.bool, device=dev),
                "mass": torch.zeros((cap,), dtype=dtp, device=dev),
            }
        bidx = self._c("bidx", self.bidx, torch.int64)
        w = drip_b[bidx] * self._c("areas", self.areas, dtp)  # kg/s
        w_sum = torch.sum(w)
        owed = st["m_owed"] + (w_sum * dt).to(dtp)
        ks = prng.split(key, 3)
        # release faces sampled ∝ dripped mass (uniformly when none drips)
        wsafe = torch.where(w_sum > 0, w, torch.ones_like(w))
        cdf = torch.cumsum(wsafe, 0) / torch.sum(wsafe)
        u = prng.uniform(ks[0], cap, dtp, device=dev)
        f = torch.clamp(torch.searchsorted(cdf, u), max=len(self.bidx) - 1)
        dia = prng.uniform(ks[1], cap, dtp, self.d_min, self.d_max, device=dev)
        m_par = self.n_per_parcel * self.rho_l * _PI / 6.0 * dia ** 3
        # as many parcels as the owed account affords
        valid = torch.cumsum(m_par, 0) <= owed
        released = torch.sum(torch.where(valid, m_par, torch.zeros_like(m_par)))
        st = dict(st)
        st["m_owed"] = owed - released
        st["n_inj"] = st["n_inj"] + torch.sum(valid).to(INT_DTYPE)
        filmU = gas.get("film_U_b")
        U = filmU[bidx][f] if filmU is not None else torch.zeros((cap, 3), dtype=dtp, device=dev)
        U = U + 0.1 * self._c("g_hat", self.g_hat, dtp)[None, :]
        cand = {
            "x": self._c("x_rel", self.x_rel, dtp)[f],
            "U": U,
            "d": dia,
            "cell": self._c("cells", self.cells, INT_DTYPE)[f],
            "valid": valid,
            "mass": torch.where(valid, m_par, torch.zeros_like(m_par)),
        }
        return st, cand


# ---------------------------------------------------------------------------
def make_injector(name: str, d: FoamDict, walk, case, dtype, geom=None,
                  cell_zones=None) -> InjectorBase:
    kind = d.get_word("type")
    if kind == "coneInjection":
        return ConeInjection(name, d, walk, dtype)
    if kind in STOCK_KINDS:
        from . import injection_stock as stk

        if kind == "manualInjection":
            return stk.ManualInjection(name, d, walk, case, dtype)
        if kind == "cellZoneInjection":
            return stk.CellZoneInjection(name, d, walk, case, geom, cell_zones or {}, dtype)
        if kind == "fieldActivatedInjection":
            return stk.FieldActivatedInjection(name, d, walk, case, dtype)
        if kind == "kinematicLookupTableInjection":
            return stk.KinematicLookupTableInjection(name, d, walk, case, dtype)
        if kind == "thermoLookupTableInjection":
            return stk.ThermoLookupTableInjection(name, d, walk, case, dtype)
        if kind == "reactingLookupTableInjection":
            return stk.ReactingLookupTableInjection(name, d, walk, case, dtype)
        if kind == "reactingMultiphaseLookupTableInjection":
            return stk.ReactingMultiphaseLookupTableInjection(name, d, walk, case, dtype)
        if kind == "coneNozzleInjection":
            return stk.ConeNozzleInjection(name, d, walk, dtype)
        if kind == "inflationInjection":
            return stk.InflationInjection(name, d, walk, case, geom, cell_zones or {}, dtype)
        return stk.NoInjection(name, d, dtype, walk.C.device)
    if kind in ("patchInjection", "patchFlowRateInjection") and geom is not None:
        return PatchInjection(name, d, geom, dtype)
    if kind in ("detailedSprinklerInjection", "detailedSprinklerInjection2"):
        return DetailedSprinklerInjection(
            name, d, walk, case, dtype,
            version=2 if kind.endswith("2") else 1,
        )
    if kind in ("sprinklerInjection", "multiSprinklerInjection"):
        from .sprinklers import AnalyticSprinklerInjection

        return AnalyticSprinklerInjection(
            name, d, walk, dtype, multi=(kind == "multiSprinklerInjection")
        )
    if kind == "lookupTableSprinklerInjection":
        from .sprinklers import LookupTableSprinklerInjection

        return LookupTableSprinklerInjection(name, d, walk, case, dtype)
    if kind == "lookupTableVolumeFluxSprinklerInjection":
        from .sprinklers import LookupTableVolumeFluxSprinklerInjection

        return LookupTableVolumeFluxSprinklerInjection(name, d, walk, case, dtype)
    if kind == "uniformSamplingSprinklerInjection":
        from .sprinklers import UniformSamplingSprinklerInjection

        return UniformSamplingSprinklerInjection(name, d, walk, case, dtype)
    raise NotImplementedError(f"injection model '{kind}'")
