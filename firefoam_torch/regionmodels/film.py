"""thermoSingleLayer surface film: a shallow-water wall film.

The port of firefoam_tpu/regionmodels/film.py (the reference's
surfaceFilmModels: kinematicSingleLayer + thermoSingleLayer, evolveRegion
thermoSingleLayer.C:828-884). The film is a per-wall-face batch on a
FilmMesh edge stencil, integrated with sub-stepped explicit upwind
transport:

  ∂(δ)/∂t  + ∇ₛ·(δ U)   = (ṁ_imp − ṁ_evap)/ρ                (continuity)
  ∂(δU)/∂t + ∇ₛ·(δ U U) = δ g_t + (τ_gas − τ_wall)/ρ + U ṁ_imp/ρ (momentum)
  ∂(δ T)/∂t + ∇ₛ·(δ U T) = [q_wall + q_gas − ṁ_evap L + ṁ_imp h_imp]/(ρ cp)

with τ_wall = 3μU/δ, τ_gas = Cf·ρg|Ug−U|(Ug−U), standardPhaseChange
evaporation (Spalding mass transfer + boil limit) or solidification,
dripping at rim edges and the injection models (drippingInjection,
BrunDrippingInjection, curvatureSeparation, exfoliationInjection,
removeInjection). The families: thermoSingleLayer, thermoSingleLayerPw
(hysteretic partial wetting + surface absorption), thermoSingleLayerFmPanel/
FmBox (the augmented-radiation window) and the roll-paper pairing.

Every sum of edges or rim edges into faces goes through the FilmMesh's
host-sorted tables, so a substep is bitwise repeatable on the card.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import small
from ..io.foamdict import FoamDict
from ..lagrangian.liquids import liquid_by_name
from ..ops.geometry import SegSum
from ..radiation.fvdom import interp
from .surfmesh import FilmMesh

__all__ = ["ThermoSingleLayerFilm"]

SIGMA_SB = 5.670374419e-8


def _aslist(v):
    return v if isinstance(v, list) else [v]


def _dimval(v, default=None):
    """Last token of a dimensionedScalar-style entry."""
    if isinstance(v, list):
        return float(v[-1])
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


class ThermoSingleLayerFilm:
    """One film region over a set of wall faces."""

    def __init__(self, fm: FilmMesh, props: FoamDict, g_vec, dtype=None, n_sub: int = 3):
        self.dtype = dtype or fm.area.dtype
        self.device = fm.area.device
        self.fm = fm
        self.n_sub = n_sub
        # model family (surfaceFilmModel.C::New)
        self.model = props.get_word("surfaceFilmModel", "thermoSingleLayer")
        coeffs = props.get_dict(self.model + "Coeffs",
                                props.get_dict("thermoSingleLayerCoeffs", FoamDict()))
        self.partial_wetting = False
        self.absorption = False
        self.qrad_window = None
        if self.model == "thermoSingleLayerPw":
            self.partial_wetting = coeffs.get_bool("partialWetting", False)
            pw = coeffs.get_dict("partialWettingCoeffs", FoamDict())
            self.pw_delta_crit = pw.get_scalar("criticalFilmThickness", 2e-4)
            self.pw_wet_toggle = pw.get_scalar("wetToggle", 0.5)
            self.pw_dry_toggle = pw.get_scalar("dryToggle", 0.01)
            self.absorption = coeffs.get_bool("absorption", False)
        elif self.model in ("thermoSingleLayerFmPanel", "thermoSingleLayerFmBox"):
            if coeffs.get_bool("augmentedRadiation", False):
                ar = coeffs.get_dict("augmentedRadiationCoeffs", coeffs)
                self.qrad_window = dict(
                    q=ar.get_scalar("qRadConstant", 0.0),
                    xmin=ar.get_scalar("qRadXMin", -1e30), xmax=ar.get_scalar("qRadXMax", 1e30),
                    ymin=ar.get_scalar("qRadYMin", -1e30), ymax=ar.get_scalar("qRadYMax", 1e30),
                    t0=ar.get_scalar("qRadBegin", 0.0), t1=ar.get_scalar("qRadEnd", 1e30),
                )
        self.liquid = liquid_by_name(coeffs.get_word("liquid", "H2O"))
        lam = coeffs.get_dict("laminarCoeffs", FoamDict())
        self.Cf = lam.get_scalar("Cf", coeffs.get_scalar("Cf", 0.005))
        self.delta_wet = coeffs.get_scalar("deltaWet", 2e-4)
        self.T_min = coeffs.get_scalar("Tmin", 200.0)
        self.T_max = coeffs.get_scalar("Tmax", 500.0)

        # heatTransfer submodels (thermoSingleLayer.C:215-249): constant c0,
        # mappedConvective (the gas-side htc), conduction, alKhalil, flatPlate
        def _htc(side_key, default_c0):
            side = coeffs.get_dict(side_key, FoamDict())
            model = side.get_word("heatTransferModel", "constant")
            mc = side.get_dict(model + "Coeffs", FoamDict())
            return model, mc.get_scalar("c0", default_c0), mc.get_scalar("L", 1.0)

        self.htcw_model, self.htc_wall, _ = _htc("lowerSurfaceModels", 1e3)
        self.htcs_model, self.htc_gas, self.htc_L = _htc("upperSurfaceModels", 10.0)

        # filmViscosityModel: liquid, constant mu0, Arrhenius, thixotropic
        self.visc_model = coeffs.get_word("filmViscosityModel", "liquid")
        vc = coeffs.get_dict(self.visc_model + "ViscosityCoeffs",
                             coeffs.get_dict(self.visc_model + "Coeffs", FoamDict()))
        self.mu0 = _dimval(vc.lookup("mu0", 1e-3))
        self.visc_k1 = vc.get_scalar("k1", 0.0)
        self.visc_k2 = vc.get_scalar("k2", 0.0)
        self.visc_Tref = vc.get_scalar("Tref", 298.15)
        self.thixotropic = self.visc_model == "thixotropic"
        if self.thixotropic:
            self.thx_a = _dimval(vc.lookup("a", 0.0))
            self.thx_b = _dimval(vc.lookup("b", 1.0))
            self.thx_c = _dimval(vc.lookup("c", 0.0))
            self.thx_d = _dimval(vc.lookup("d", 1.0))
            self.thx_muInf = _dimval(vc.lookup("muInf", self.mu0))
            self.thx_K = 1.0 - math.sqrt(self.thx_muInf / max(self.mu0, 1e-300))

        # phaseChangeModel: standardPhaseChange, solidification or none
        self.pc_model = coeffs.get_word("phaseChangeModel", "standardPhaseChange")
        if self.pc_model == "noPhaseChange":
            self.pc_model = "none"
        sc = coeffs.get_dict("solidificationCoeffs", FoamDict())
        self.solid_T0 = sc.get_scalar("T0", 273.15)
        self.solid_max_frac = sc.get_scalar("maxSolidificationFrac", 0.2)
        self.solid_max_rate = _dimval(sc.lookup("maxSolidificationRate", 1e30))
        if coeffs.get_word("massAbsorptionModel", "none") == "standardMassAbsorption":
            self.absorption = True

        # filmRadiation: standardRadiation/primaryRadiation (qin·alpha),
        # constantRadiation and rampingRadiation (a prescribed flux)
        self.rad_model = coeffs.get_word("radiationModel", "standardRadiation")
        rc = coeffs.get_dict(self.rad_model + "Coeffs", FoamDict())
        self.rad_absorptivity = rc.get_scalar("absorptivity", 0.9)
        self.rad_qr_const = _dimval(rc.lookup("qrConst", 0.0))
        self.rad_time_start = rc.get_scalar("timeStart", 0.0)
        self.rad_duration = rc.get_scalar("duration", 1e30)
        self.rad_ramp_dt = rc.get_scalar("rampTimeInterval", 1e30)
        self.rad_ramp_step = _dimval(rc.lookup("rampStep", 0.0))

        # forces: thermocapillary and the contact-angle line force
        forces = [str(x) for x in _aslist(coeffs.lookup("forces", []))]
        self.f_thermocap = "thermocapillary" in forces
        ca = next((f for f in forces if "ontactAngle" in f), None)
        self.f_contact = ca is not None
        cac = coeffs.get_dict((ca or "x") + "Coeffs", FoamDict())
        self.ca_Ccf = cac.get_scalar("Ccf", 0.016)
        pw = coeffs.get_dict("partialWettingCoeffs", FoamDict())
        dist = cac.get_dict("distribution", FoamDict()).get_dict("normalDistribution", FoamDict())
        self.ca_theta = math.radians(
            dist.get_scalar("expectation", pw.get_scalar("contactAngleMean", 75.0)))
        # temperatureDependent(/perturbed)ContactAngleForce: θ(T), constant
        # or a table (the perturbation taken at its expectation)
        self.ca_theta_table = None
        if ca is not None and "emperatureDependent" in ca:
            tv = cac.lookup("theta", None)
            if isinstance(tv, list) and len(tv) >= 2:
                kind = str(tv[0])
                if kind == "constant":
                    try:
                        self.ca_theta = math.radians(float(tv[1]))
                    except (TypeError, ValueError):
                        pass
                elif kind == "table" and isinstance(tv[1], list):
                    rows = sorted((float(r[0]), float(r[1])) for r in tv[1]
                                  if isinstance(r, list) and len(r) == 2)
                    if rows:
                        self.ca_theta_table = (np.asarray([r[0] for r in rows]),
                                               np.radians([r[1] for r in rows]))

        # injectionModels
        inj = [str(x) for x in _aslist(coeffs.lookup("injectionModels", []))]
        self.plain_drip = "drippingInjection" in inj or not inj
        self.brun_drip = "BrunDrippingInjection" in inj
        self.drip_enabled = self.plain_drip or self.brun_drip
        bdc = coeffs.get_dict("BrunDrippingInjectionCoeffs", FoamDict())
        self.brun_ubar = bdc.get_scalar("ubarStar", 1.62208)
        self.brun_dcoeff = bdc.get_scalar("dCoeff", 3.3)
        self.brun_delta_stable = bdc.get_scalar("deltaStable", 0.0)
        dc = coeffs.get_dict("drippingInjectionCoeffs", FoamDict())
        self.delta_stable = dc.get_scalar("deltaStable", 1e30 if not inj else 1e-3)
        self.particles_per_parcel = dc.get_scalar("particlesPerParcel", 100.0)
        pd = dc.get_dict("parcelDistribution", FoamDict()).get_dict("uniformDistribution",
                                                                     FoamDict())
        self.drip_d_min = pd.get_scalar("minValue", 1e-3)
        self.drip_d_max = pd.get_scalar("maxValue", 2e-3)
        self.curvature_sep = "curvatureSeparation" in inj
        cs = coeffs.get_dict("curvatureSeparationCoeffs", FoamDict())
        self.delta_by_r1_min = cs.get_scalar("deltaByR1Min", 0.0)
        self.remove_inj = "removeInjection" in inj
        self.exfoliation = "exfoliationInjection" in inj
        ec = coeffs.get_dict("exfoliationInjectionCoeffs", FoamDict())
        self.exf_threshold = ec.get_scalar("expelThreshold", 0.5)
        self.exf_fraction = ec.get_scalar("expelFraction", 0.1)

        g = np.asarray(g_vec, float)
        n = fm.n_hat.double().cpu().numpy()
        g_tan = g[None, :] - (n @ g)[:, None] * n
        self.fm.g_tan = self._t(g_tan)
        from .filmbcs import bind_liquid, parse_film_inlets

        self.inlets = bind_liquid(parse_film_inlets(coeffs, fm, g_tan), self.liquid)
        # each inlet's rim-edge → face sum, order-fixed
        self._inlet_sums = [
            SegSum(fm.be_face.cpu().numpy()[i.rows], fm.n_faces, self.device)
            for i in self.inlets
        ]
        # dripping rim edges: gravity has a component out of the film there
        be_m = fm.be_m.double().cpu().numpy()
        self._drip_edge = torch.as_tensor((be_m @ g) > 0.1 * np.linalg.norm(g) + 1e-12,
                                          device=self.device)
        # faces where gravity detaches the film (n̂ points into the wall, so
        # a ceiling has g·n̂ < 0)
        gmag = max(np.linalg.norm(g), 1e-12)
        self._detach_face = torch.as_tensor((n @ g) < -0.5 * gmag, device=self.device)
        self.g_mag = gmag
        # Brun dripping statics: sinα = −g·n̂/|g| (BrunDrippingInjection.C:79,92)
        self._sin_alpha = self._t(np.maximum(-(n @ g) / gmag, 0.0))
        if self.brun_drip:
            sig = float(self.liquid.sigma(101325.0, torch.tensor(300.0, dtype=torch.float64)))
            lc0 = math.sqrt(sig / (998.0 * gmag))
            self.drip_d_min = self.drip_d_max = self.brun_dcoeff * lc0
        # static surface curvature 1/R1 for curvatureSeparation
        if self.curvature_sep and fm.n_edges > 0:
            e_own = fm.e_own.cpu().numpy()
            e_nei = fm.e_nei.cpu().numpy()
            inv_r_e = np.linalg.norm(n[e_nei] - n[e_own], axis=1) * fm.e_dc.double().cpu().numpy()
            inv_r = np.zeros(fm.n_faces)
            cnt = np.zeros(fm.n_faces)
            np.add.at(inv_r, e_own, inv_r_e)
            np.add.at(inv_r, e_nei, inv_r_e)
            np.add.at(cnt, e_own, 1.0)
            np.add.at(cnt, e_nei, 1.0)
            self._inv_r1 = self._t(inv_r / np.maximum(cnt, 1.0))
        else:
            self._inv_r1 = None

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    def initial_state(self, delta0: float = 0.0, T0: float = 298.15) -> Dict:
        nF = self.fm.n_faces
        kw = dict(dtype=self.dtype, device=self.device)
        st = {
            "delta": torch.full((nF,), delta0, **kw),
            "U": torch.zeros((nF, 3), **kw),
            "T": torch.full((nF,), T0, **kw),
            "drippedMass": torch.zeros((), **kw),
            "removedMass": torch.zeros((), **kw),
            "evaporatedMass": torch.zeros((), **kw),
        }
        if self.partial_wetting:
            st["omega"] = (st["delta"] > self.pw_wet_toggle * self.pw_delta_crit).to(self.dtype)
        if self.absorption:
            st["cumAbsorption"] = torch.zeros((nF,), **kw)  # kg/m² absorbed
            st["absorbedMass"] = torch.zeros((), **kw)
        if self.thixotropic:
            st["lambda"] = torch.ones((nF,), **kw)  # fully structured at rest
        if self.pc_model == "solidification":
            st["solidMass"] = torch.zeros((nF,), **kw)  # kg/m² frozen out
        return st

    # ------------------------------------------------------------------
    def _viscosity(self, p, T, lam=None):
        if self.visc_model == "constant":
            return torch.full_like(T, self.mu0)
        if self.thixotropic:
            lam = torch.clamp(lam if lam is not None else torch.ones_like(T), 0.0, 1.0)
            return self.thx_muInf / (1.0 - self.thx_K * lam + small(T.dtype)) ** 2
        mu = self.liquid.mu(p, T)
        if self.visc_model == "Arrhenius":
            mu = mu * torch.exp(self.visc_k1 * (1.0 / (T + self.visc_k2)
                                                - 1.0 / (self.visc_Tref + self.visc_k2)))
        return mu

    def _htc_lower(self, p, T, U, delta, mu, rho):
        """Wall-side h: constant c0, conduction 2κ_f/δ, or alKhalil."""
        if self.htcw_model == "conduction":
            kap = self.liquid.kappa(p, T)
            return torch.clamp(2.0 * kap / torch.clamp(delta, min=1e-8), max=1.2e4)
        if self.htcw_model == "alKhalil":
            kap = self.liquid.kappa(p, T)
            dU = 1.5 * torch.linalg.norm(U, dim=1)
            Re = rho * dU * delta / torch.clamp(mu, min=1e-12)
            Nu = 3.20 + 0.000237 * Re
            return torch.clamp(Nu * kap / torch.clamp(delta, min=1e-8), max=1e4)
        return torch.full_like(T, self.htc_wall)

    def _htc_upper(self, T, U, U_gas, T_gas, rho_gas, htc_mapped):
        """Gas-side h: constant c0, the mapped gas-side htc, or the
        flat-plate correlation (air transport constants)."""
        if self.htcs_model in ("flatPlate", "htcConv"):
            mu_g = 1.458e-6 * T_gas ** 1.5 / (T_gas + 110.4)
            kappa_g = mu_g * 1007.0 / 0.7
            dU = torch.linalg.norm(U_gas - U, dim=1)
            Re = rho_gas * dU * self.htc_L / torch.clamp(mu_g, min=1e-12)
            Pr13 = 0.7 ** (1.0 / 3.0)
            Nu = torch.where(Re < 5.0e5, 0.664 * torch.sqrt(Re) * Pr13, 0.037 * Re ** 0.8 * Pr13)
            return Nu * kappa_g / self.htc_L
        if self.htcs_model == "constant" or htc_mapped is None:
            return torch.full_like(T, self.htc_gas)
        return htc_mapped

    def _absorbed_radiation(self, qr, delta, alpha, t=0.0):
        """filmRadiation submodel → absorbed heat flux [W/m²]."""
        if self.rad_model == "none":
            return torch.zeros_like(qr)
        if self.rad_model in ("constantRadiation", "rampingRadiation"):
            t = torch.as_tensor(t, dtype=qr.dtype, device=qr.device)
            q = self.rad_qr_const
            if self.rad_model == "rampingRadiation" and self.rad_ramp_step:
                n_ramps = torch.floor(torch.clamp(t - self.rad_time_start, min=0.0)
                                      / self.rad_ramp_dt)
                q = q + self.rad_ramp_step * n_ramps
            window = (t >= self.rad_time_start) & (t <= self.rad_time_start + self.rad_duration)
            val = torch.where(window, self.rad_absorptivity * torch.as_tensor(q, dtype=qr.dtype,
                                                                             device=qr.device),
                              torch.zeros((), dtype=qr.dtype, device=qr.device))
            return val * torch.ones_like(qr)
        return qr * alpha

    def _inflow(self, inlet, t) -> Dict:
        """An inlet's inflow on the film's device, with its rim rows; the
        kinds with no time dependence are evaluated once (a host-to-device
        copy a substep would wait for the card)."""
        cache = self.__dict__.setdefault("_inflow_cache", {})
        q = cache.get(id(inlet))
        if q is None:
            q = inlet.inflow(self.liquid, t, self.dtype, self.device)
            q["rows"] = torch.as_tensor(inlet.rows, device=self.device)
            if inlet.kind not in ("filmHeightInlet", "wavyFilmHeight"):
                cache[id(inlet)] = q
        return q

    def inlet_mass_rate(self, t) -> torch.Tensor:
        """The inlets' total mass inflow [kg/s] at time t."""
        fm = self.fm
        out = torch.zeros((), dtype=self.dtype, device=self.device)
        for inlet in self.inlets:
            q = self._inflow(inlet, t)
            out = out + torch.sum(q["rho"] * q["delta"] * q["u"] * fm.be_len[q["rows"]])
        return out

    # ------------------------------------------------------------------
    def alpha(self, delta: torch.Tensor) -> torch.Tensor:
        """Wet coverage fraction."""
        return torch.clamp(delta / self.delta_wet, 0.0, 1.0)

    def courant(self, st: Dict, dt) -> torch.Tensor:
        fm = self.fm
        if fm.n_edges == 0:
            return torch.zeros((), dtype=self.dtype, device=self.device)
        ue = 0.5 * (st["U"][fm.e_own] + st["U"][fm.e_nei])
        un = torch.abs(torch.einsum("ed,ed->e", ue, fm.e_m))
        return torch.max(un * fm.e_dc) * dt

    # ------------------------------------------------------------------
    def _substep(self, st: Dict, dt_sub, inp: Dict) -> Tuple[Dict, Dict]:
        fm = self.fm
        dtp = self.dtype
        tiny = small(dtp)
        delta, U, T = st["delta"], st["U"], st["T"]
        # liquid properties at the local gas pressure
        p = inp.get("p_gas")
        if p is None:
            p = torch.full_like(T, 101325.0)
        rho = self.liquid.rho(p, T)
        mu = self._viscosity(p, T, st.get("lambda"))
        cp = self.liquid.cp(p, T)
        alpha = self.alpha(delta)
        if self.partial_wetting:
            # hysteretic wet/dry indicator (partialWetting.H:73-91)
            om = st["omega"]
            om = torch.where(delta > self.pw_wet_toggle * self.pw_delta_crit,
                             torch.ones_like(om), om)
            om = torch.where(delta < self.pw_dry_toggle * self.pw_delta_crit,
                             torch.zeros_like(om), om)
            st = dict(st)
            st["omega"] = om
            alpha = om
        d_eff = torch.clamp(delta, min=1e-8)

        # ---- sources ----
        m_imp = inp.get("mass_imp")
        if m_imp is None:
            m_imp = torch.zeros_like(delta)
        h_imp = inp.get("h_imp")
        if h_imp is None:
            h_imp = m_imp * cp * inp.get("T_imp", T)
        T_wall = inp.get("T_wall")
        if T_wall is None:
            T_wall = torch.full_like(T, 298.15)
        T_gas = inp.get("T_gas")
        if T_gas is None:
            T_gas = torch.full_like(T, 298.15)
        U_gas = inp.get("U_gas")
        if U_gas is None:
            U_gas = torch.zeros_like(U)
        rho_gas = inp.get("rho_gas")
        if rho_gas is None:
            rho_gas = torch.full_like(T, 1.2)
        htc_gas = self._htc_upper(T, U, U_gas, T_gas, rho_gas, inp.get("htc_gas"))
        qr = inp.get("qr")
        if qr is None:
            qr = torch.zeros_like(T)
        t_now = inp.get("t", 0.0)
        if self.qrad_window is not None:
            # FmPanel/FmBox augmentedRadiation: a constant panel heat flux in
            # the (x, y) window during [qRadBegin, qRadEnd]
            w = self.qrad_window
            C = fm.C
            in_win = ((C[:, 0] >= w["xmin"]) & (C[:, 0] <= w["xmax"])
                      & (C[:, 1] >= w["ymin"]) & (C[:, 1] <= w["ymax"]))
            tt = torch.as_tensor(t_now, dtype=dtp, device=delta.device)
            on = (tt >= w["t0"]) & (tt <= w["t1"])
            qr = qr + torch.where(in_win & on, torch.full_like(qr, w["q"]), torch.zeros_like(qr))
        Yv_gas = inp.get("Yv_gas")
        if Yv_gas is None:
            Yv_gas = torch.zeros_like(T)
        p_gas = inp.get("p_gas")
        if p_gas is None:
            p_gas = torch.full_like(T, 101325.0)

        htc_wall = self._htc_lower(p, T, U, delta, mu, rho)

        # ---- rim-edge inlet BCs: prescribed δ/U/T inflow as sources ----
        m_inlet = torch.zeros_like(delta)
        mom_inlet = torch.zeros_like(U)
        h_inlet = torch.zeros_like(delta)
        for inlet, isum in zip(self.inlets, self._inlet_sums):
            q = self._inflow(inlet, t_now)
            rows = q["rows"]
            faces = fm.be_face[rows]
            m_e = q["rho"] * q["delta"] * q["u"] * fm.be_len[rows]  # kg/s per edge
            dirv = -fm.be_m[rows]  # into the film
            if inlet.kind == "filmHeightInletVelocityWavy":
                tan_e = torch.cross(fm.n_hat[faces], dirv, dim=1)
                dirv = dirv + q["wobble"][:, None] * tan_e
            inv_A = 1.0 / fm.area[faces]
            m_inlet = m_inlet + isum(m_e * inv_A)
            mom_inlet = mom_inlet + isum((m_e * q["u"] * inv_A)[:, None] * dirv)
            h_inlet = h_inlet + isum(m_e * inlet.cp_in * inlet.T_in * inv_A)
        m_imp = m_imp + m_inlet
        h_imp = h_imp + h_inlet

        # ---- phase change (standardPhaseChange: Spalding + boil limit) ----
        pv = self.liquid.pv(p_gas, T)
        hl = self.liquid.hl(p_gas, T)
        W_l = self.liquid.W
        W_air = 28.96
        Ys = pv * W_l / (pv * W_l + (p_gas - pv) * W_air)
        B = torch.clamp((Ys - Yv_gas) / torch.clamp(1.0 - Ys, min=1e-6), 0.0, 50.0)
        kc = htc_gas / torch.clamp(rho_gas * 1007.0, min=1e-30)
        m_evap = rho_gas * kc * torch.log1p(B)
        q_rad = self._absorbed_radiation(qr, delta, self.alpha(delta), t_now)
        q_in_tot = htc_wall * (T_wall - T) + htc_gas * (T_gas - T) + q_rad
        m_boil = torch.clamp(q_in_tot, min=0.0) / hl
        m_evap = torch.where(T >= 373.0, torch.maximum(m_evap, m_boil), m_evap)
        m_evap = m_evap * alpha
        m_evap = torch.minimum(m_evap, rho * delta / torch.clamp(dt_sub, min=tiny))
        if self.pc_model == "none":
            m_evap = torch.zeros_like(m_evap)
        elif self.pc_model == "solidification":
            # solidification.C:110-160: below T0 a rate-limited fraction of
            # the film freezes out (no latent-heat term); no evaporation
            rate_lim = torch.clamp(self.solid_max_rate * dt_sub, max=self.solid_max_frac)
            freeze = (alpha > 0.5) & (T < self.solid_T0)
            dm_sol = torch.where(freeze, rate_lim * rho * delta, torch.zeros_like(delta))
            m_evap = dm_sol / torch.clamp(dt_sub, min=tiny)
            st = dict(st)
            st["solidMass"] = st["solidMass"] + dm_sol
            hl = torch.zeros_like(hl)

        # ---- Pw surface absorption (partialWetting.H:169-199) ----
        m_abs = torch.zeros_like(delta)
        if self.absorption:
            T1, A1, n1 = 293.15, 0.0207, 0.456
            T2, A2, n2 = 316.15, 0.0317, 0.465
            w_T = (torch.clamp(T, T1, T2) - T1) / (T2 - T1)
            A_c = A1 + w_T * (A2 - A1)
            n_c = n1 + w_T * (n2 - n1)
            cum = st["cumAbsorption"]
            t_eq = torch.maximum((torch.clamp(cum, min=0.0) / A_c) ** (1.0 / n_c) * 60.0,
                                 dt_sub + torch.zeros_like(cum))
            t_o = torch.clamp(t_eq - dt_sub, min=1e-15)
            dm = A_c * ((t_eq / 60.0) ** n_c - (t_o / 60.0) ** n_c)
            dm = torch.where(alpha > 0.5, dm, torch.zeros_like(dm))
            dm = torch.minimum(dm, rho * delta)
            m_abs = dm / torch.clamp(dt_sub, min=tiny)
            st = dict(st)
            st["cumAbsorption"] = cum + dm
            st["absorbedMass"] = st["absorbedMass"] + torch.sum(dm * fm.area)

        # ---- transport fluxes over edges (upwind) ----
        has_edges = fm.n_edges > 0
        if has_edges:
            ue = 0.5 * (U[fm.e_own] + U[fm.e_nei])
            un = torch.einsum("ed,ed->e", ue, fm.e_m)
            q_edge = un * fm.e_len
            flux_m = q_edge * fm.edge_upwind(q_edge, delta)
            U_up = torch.where((q_edge > 0.0)[:, None], U[fm.e_own], U[fm.e_nei])
            T_up = fm.edge_upwind(q_edge, T)

        # ---- dripping at rim edges ----
        drip = torch.zeros_like(delta)
        if fm.be_face.shape[0] > 0:
            u_out = torch.clamp(torch.einsum("ed,ed->e", U[fm.be_face], fm.be_m), min=0.0)
            u_out = torch.where(self._drip_edge, u_out, torch.zeros_like(u_out))
            drip_e = u_out * fm.be_len * delta[fm.be_face]
            drip = (drip + fm.sum_rim(drip_e)) / fm.area

        # ---- drippingInjection (deltaStable) on detaching faces ----
        if self.plain_drip:
            excess = torch.clamp(delta - self.delta_stable, min=0.0)
            drip = drip + torch.where(self._detach_face, excess / torch.clamp(dt_sub, min=tiny),
                                      torch.zeros_like(excess))

        # ---- BrunDrippingInjection (BrunDrippingInjection.C:88-125) ----
        if self.brun_drip:
            sigma_b = self.liquid.sigma(p, T)
            lc = torch.sqrt(sigma_b / (rho * self.g_mag))
            sa = torch.clamp(self._sin_alpha, min=tiny)
            d_stab = torch.clamp(
                3.0 * lc * torch.sqrt(torch.clamp(1.0 - sa * sa, min=0.0))
                / (self.brun_ubar * torch.sqrt(sa) * sa), min=self.brun_delta_stable)
            excess_b = torch.clamp(delta - d_stab, min=0.0)
            drip = drip + torch.where(self._sin_alpha > 1e-6,
                                      excess_b / torch.clamp(dt_sub, min=tiny),
                                      torch.zeros_like(excess_b))

        # ---- curvatureSeparation (curvatureSeparation.C:correct) ----
        if self._inv_r1 is not None:
            inv_r1 = self._inv_r1
            r1 = 1.0 / torch.clamp(inv_r1, min=1e-12)
            r2 = r1 + delta
            magU2 = torch.sum(U * U, dim=1)
            sigma_l = self.liquid.sigma(p, T)
            Fi = -delta * rho * magU2 * (72.0 / 60.0) * inv_r1
            Fb = -0.5 * rho * self.g_mag * inv_r1 * (r1 ** 2 - r2 ** 2)
            Fs = sigma_l / torch.clamp(r2, min=1e-12)
            separate = ((inv_r1 > 0.0) & (delta * inv_r1 > self.delta_by_r1_min)
                        & (Fi + Fb + Fs + 1e-10 < 0.0))
            drip = drip + torch.where(separate, delta / torch.clamp(dt_sub, min=tiny),
                                      torch.zeros_like(delta))

        # ---- exfoliationInjection (a dried-out film flakes off) ----
        if self.exfoliation:
            Yv_f = inp.get("Yv_film")
            if Yv_f is not None:
                drip = drip + torch.where(
                    Yv_f < self.exf_threshold,
                    self.exf_fraction * torch.clamp(delta, min=0.0) / torch.clamp(dt_sub, min=tiny),
                    torch.zeros_like(delta))

        # ---- removeInjection: the whole available film is deleted ----
        removed = torch.zeros_like(delta)
        if self.remove_inj:
            removed = delta / torch.clamp(dt_sub, min=tiny)

        # ---- donor-limited continuity: scale every outgoing flux by the
        # donor face's available film so δ ≥ 0 and mass is conserved
        out_rate = drip + removed + (m_evap + m_abs) / rho
        if has_edges:
            out_rate = (out_rate + fm.sum_own(torch.clamp(flux_m, min=0.0) / fm.area[fm.e_own])
                        + fm.sum_nei(torch.clamp(-flux_m, min=0.0) / fm.area[fm.e_nei]))
        lim = torch.clamp((delta / torch.clamp(dt_sub, min=tiny) + m_imp / rho)
                          / torch.clamp(out_rate, min=tiny), max=1.0)
        drip = drip * lim
        removed = removed * lim
        m_evap = m_evap * lim
        if has_edges:
            flux_m = torch.where(flux_m > 0.0, flux_m * lim[fm.e_own], flux_m * lim[fm.e_nei])
            div_m = fm.div_edges(flux_m)
            div_mom = torch.stack([fm.div_edges(flux_m * U_up[:, c]) for c in range(3)], dim=1)
            div_e = fm.div_edges(flux_m * T_up)
        else:
            div_m = torch.zeros_like(delta)
            div_mom = torch.zeros_like(U)
            div_e = torch.zeros_like(T)

        ddelta = -div_m - drip - removed + (m_imp - m_evap - m_abs) / rho
        delta_new = torch.clamp(delta + dt_sub * ddelta, min=0.0)

        # ---- momentum ----
        tau_gas = self.Cf * rho_gas[:, None] * (U_gas - U) * torch.linalg.norm(
            U_gas - U, dim=1, keepdim=True)
        tau_wall_coeff = 3.0 * mu / d_eff  # τ_w = 3 μ U / δ (implicit below)

        # surface forces: the contact-angle line force at wet/dry interfaces
        # and thermocapillary dσ/dT·∇ₛT
        f_surf = torch.zeros_like(U)
        if (self.f_contact or self.f_thermocap) and has_edges:
            def sgrad(qv):
                dq = (qv[fm.e_nei] - qv[fm.e_own]) * fm.e_dc
                contrib = dq[:, None] * fm.e_m * fm.e_len[:, None]
                return (fm.sum_own(contrib) + fm.sum_nei(contrib)) / (2.0 * fm.area[:, None])

            sigma_l = self.liquid.sigma(p, T)
            if self.f_contact:
                ga = sgrad(alpha)
                gmagn = torch.clamp(torch.linalg.norm(ga, dim=1, keepdim=True), min=1e-12)
                iface_e = ((alpha[fm.e_own] > 0.5) != (alpha[fm.e_nei] > 0.5)).to(dtp)
                iface = (fm.sum_own(iface_e) + fm.sum_nei(iface_e)) > 0.0
                ratio = torch.clamp(delta / 2e-4, max=1.0)
                if self.ca_theta_table is not None:
                    tt, th = self.ca_theta_table
                    theta_f = interp(T, self._t(tt), self._t(th))
                    one_m_cos = 1.0 - torch.cos(theta_f)
                else:
                    one_m_cos = 1.0 - math.cos(self.ca_theta)
                f_ca = (ga / gmagn) * (sigma_l * one_m_cos / self.ca_Ccf * ratio)[:, None]
                f_surf = f_surf + torch.where(iface[:, None], f_ca, torch.zeros_like(f_ca))
            if self.f_thermocap:
                dT = 0.5
                dsig_dT = (self.liquid.sigma(p, T + dT) - self.liquid.sigma(p, T - dT)) / (2.0 * dT)
                f_surf = f_surf + dsig_dT[:, None] * sgrad(T)

        mom = delta[:, None] * U
        U_imp = inp.get("U_imp", U * 0.0)
        rhs = (-div_mom
               - (drip + removed)[:, None] * U
               + delta[:, None] * fm.g_tan
               + (tau_gas + f_surf + (m_imp - m_inlet)[:, None] * U_imp + mom_inlet)
               / rho[:, None])
        mom_new = mom + dt_sub * rhs
        d_new_eff = torch.clamp(delta_new, min=1e-8)
        U_new = mom_new / d_new_eff[:, None]
        # implicit wall drag U/(1 + dt·3ν/δ²)
        U_new = U_new / (1.0 + dt_sub * tau_wall_coeff / (rho * d_new_eff))[:, None]
        # project onto the surface, no velocity on dry faces
        U_new = U_new - torch.einsum("fd,fd->f", U_new, fm.n_hat)[:, None] * fm.n_hat
        U_new = torch.where((delta_new > 1e-8)[:, None], U_new, torch.zeros_like(U_new))

        # ---- energy ----
        q_net = (htc_wall * (T_wall - T) * alpha + htc_gas * (T_gas - T) * alpha + q_rad
                 - m_evap * hl + h_imp)
        en_new = delta * T + dt_sub * (
            -div_e - (drip + removed + (m_evap + m_abs) / rho) * T + q_net / (rho * cp))
        T_new = torch.where(delta_new > 1e-8, en_new / d_new_eff, T_wall)
        T_new = torch.clamp(T_new, self.T_min, self.T_max)

        # ---- thixotropic structure transport (thixotropicViscosity.C:147-166)
        lam_new = None
        if self.thixotropic:
            lam = torch.clamp(st["lambda"], 0.0, 1.0)
            g_dot = alpha * 1.5 * torch.linalg.norm(U, dim=1) / torch.clamp(d_eff, min=tiny)
            adv = torch.zeros_like(lam)
            if has_edges:
                lam_up = fm.edge_upwind(q_edge, lam)
                adv = fm.div_edges(q_edge * lam_up) - lam * fm.div_edges(q_edge)
            dilute = m_imp / torch.clamp(rho * d_eff, min=tiny)
            dlam = (self.thx_a * torch.clamp(1.0 - lam, min=0.0) ** self.thx_b
                    - self.thx_c * g_dot ** self.thx_d * lam - dilute * lam - adv)
            lam_new = torch.clamp(lam + dt_sub * dlam, 0.0, 1.0)

        out = {
            # frozen mass stays on the substrate: only evaporation reaches
            # the gas as vapour
            "m_evap": m_evap if self.pc_model != "solidification" else torch.zeros_like(m_evap),
            "q_gas": htc_gas * (T_gas - T) * alpha,
            "drip": drip * rho,
        }
        st2 = {
            "delta": delta_new,
            "U": U_new,
            "T": T_new,
            "drippedMass": st["drippedMass"] + torch.sum(drip * rho * fm.area) * dt_sub,
            "removedMass": st["removedMass"] + torch.sum(removed * rho * fm.area) * dt_sub,
            "evaporatedMass": st["evaporatedMass"] + torch.sum(m_evap * fm.area) * dt_sub,
        }
        for k in ("omega", "cumAbsorption", "absorbedMass", "solidMass"):
            if k in st:
                st2[k] = st[k]
        if lam_new is not None:
            st2["lambda"] = lam_new
        return st2, out

    # ------------------------------------------------------------------
    def evolve(self, st: Dict, dt, inp: Optional[Dict] = None) -> Tuple[Dict, Dict]:
        """One gas-step film evolution (thermoSingleLayer::evolveRegion) in
        n_sub substeps."""
        inp = inp or {}
        dt = torch.as_tensor(dt, dtype=self.dtype, device=self.device)
        dt_sub = dt / self.n_sub
        acc = None
        for _ in range(self.n_sub):
            st, out = self._substep(st, dt_sub, inp)
            if acc is None:
                acc = {k: v / self.n_sub for k, v in out.items()}
            else:
                acc = {k: acc[k] + v / self.n_sub for k, v in out.items()}
        acc["alpha"] = self.alpha(st["delta"])
        acc["T_film"] = st["T"]
        acc["delta_max"] = torch.max(st["delta"])
        acc["mass"] = torch.sum(st["delta"] * self.liquid.rho(101325.0, st["T"]) * self.fm.area)
        return st, acc
