"""reactingOneDim pyrolysis: batched 1-D solid heat-up and decomposition.

The port of firefoam_tpu/regionmodels/pyrolysis.py (the reference's
reactingOneDim.C and the FM fork's reactingOneDim21): per wall-face column
of solid cells, evolveRegion (reactingOneDim.C:686-722) runs

  solid chemistry (explicit calculate(), useChemistrySolvers false)
  → solveContinuity  (ddt(rho) = −RRg)
  → solveSpeciesMass (ddt(rho, Yi) = RRs(i))
  → solveEnergy      (ddt(rho, h) − lap(alpha, h) [+ correction to κ∇T]
                      = Qc − Sp(RRg, h))
  → calculateMassTransfer (the pyrolysate flux to the gas)

Every column is one lane of a dense [nFaces, nLayers] batch and the energy
equation is one batched tridiagonal (Thomas) solve. The variants of the
collection come along: reactingOneDim21CharOxi (char oxidation by the
gas's O2), the roll-paper family (reactingOneDimRPvol/RPvol2/RollPaper:
delamination, a buffered fuel release and the page blockage) and moveMesh
(surface regression).

End boundary conditions (from 0/<region>/T): fixedIncidentRadiation,
constHTemperature, constHTemperatureRadiation (fixed h or the Churchill-Chu
correlation), zeroGradient, and coupled (the gas-side q_conv and qr are
supplied each step by the primary region).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import real_dtype, small
from ..io.foamdict import FoamDict, expand_env, parse_file
from .oned import Region1D, tridiag_solve
from .solid import SIGMA_SB, SolidChemistry, SolidThermo

__all__ = ["ReactingOneDim", "PyrolysisCollection", "EndBC"]

# pyrolysisModelCollection.C: the models the collection builds; "none" and
# "noPyrolysis" build no zone
MODELS = ("reactingOneDim", "reactingOneDim21", "reactingOneDim21CharOxi",
          "reactingOneDimRPvol", "reactingOneDimRPvol2", "reactingOneDimRollPaper")


@dataclass
class EndBC:
    kind: str
    h: float = 0.0
    Tinf: float = 298.15
    qr_incident: float = 0.0
    emissivity: float = 1.0
    mode: str = "fixed"  # constHTemperatureRadiation: fixed | correlation


def _uniform(v) -> float:
    if isinstance(v, list):  # "uniform 298.15" → [String('uniform'), 298.15]
        return float(v[-1])
    return float(v)


def _parse_end_bc(bf: FoamDict, patch: str) -> EndBC:
    d = None
    for k, v in bf.items():
        if k == patch or (not k.isidentifier() and re.fullmatch(k.strip('"'), patch)):
            d = v
    if d is None:
        return EndBC("zeroGradient")
    kind = str(d.lookup("type"))
    if kind == "constHTemperature":
        return EndBC("constH", h=_uniform(d.lookup("h", 0.0)),
                     Tinf=_uniform(d.lookup("Tinf", 298.15)))
    if kind == "constHTemperatureRadiation":
        return EndBC("constHRad", h=_uniform(d.lookup("h", 0.0)),
                     Tinf=_uniform(d.lookup("Tinf", 298.15)),
                     emissivity=_uniform(d.lookup("emissivity", 1.0)),
                     mode=str(d.lookup("mode", "fixed")))
    if kind == "fixedIncidentRadiation":
        return EndBC("fixedIncidentRadiation", qr_incident=_uniform(d.lookup("QrIncident")))
    if "oupled" in kind or kind.startswith("compressible::turbulentTemperature"):
        return EndBC("coupled")
    return EndBC("zeroGradient")


class ReactingOneDim:
    """One pyrolysis zone (the reference's pyrolysisModel + reactingOneDim)."""

    def __init__(self, case_dir: str, cm, zone_dict: FoamDict, dtype=None, device=None):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.dtype = dtype or real_dtype(self.device)
        self.region_name = zone_dict.get_word("regionName")
        self.model = zone_dict.get_word("pyrolysisModel", "reactingOneDim")
        coeffs = zone_dict.get_dict(
            self.model + "Coeffs", zone_dict.get_dict("reactingOneDimCoeffs", FoamDict()))
        # moving-mesh surface regression (reactingOneDim::updateMesh,
        # reactingOneDim.C:214-238): outgassed mass shrinks each layer at
        # constant material density; layers clamp at minimumDelta
        self.move_mesh = coeffs.get_bool("moveMesh", False)
        self.min_delta = coeffs.get_scalar("minimumDelta", 1e-6)

        self.region = Region1D.from_case(case_dir, cm, self.region_name)
        r = self.region

        # ---- thermo + chemistry ----
        rdir = f"{case_dir}/constant/{self.region_name}"
        tp = parse_file(f"{rdir}/thermophysicalProperties", case_dir=case_dir)
        rx = parse_file(expand_env(str(tp.lookup("foamChemistryFile")), case_dir),
                        case_dir=case_dir)
        th = parse_file(expand_env(str(tp.lookup("foamChemistryThermoFile")), case_dir),
                        case_dir=case_dir)
        species = [str(s) for s in rx.get_list("species")]
        rad = None
        if os.path.exists(f"{rdir}/radiationProperties"):
            rad = parse_file(f"{rdir}/radiationProperties", case_dir=case_dir)
        self.thermo = SolidThermo.from_case(th, species, rad)
        self.chem = SolidChemistry.from_case(rx, self.thermo)

        # ---- initial fields (0/<region>/) ----
        self.T_init = self._region_field_value(case_dir, "T", 298.15)
        Y0 = np.zeros((len(species),))
        for i, s in enumerate(species):
            Y0[i] = self._region_field_value(case_dir, s, 1.0 if i == 0 else 0.0)
        Y0 = Y0 / max(Y0.sum(), 1e-300)
        self._Y0 = Y0
        self._rho0 = float(Y0 @ self.thermo.rho_s)

        # ---- char oxidation (reactingOneDim21CharOxi.H:64-87): O2 from the
        # gas burns available char (12 g/mol) to CO2 (44 g/mol) at HocChar
        self.char_oxi = self.model in ("reactingOneDim21CharOxi", "pyroCUPOneDimV1") \
            and "char" in species
        if self.char_oxi:
            self.char_idx = species.index("char")
        self.hoc_char = 32.8e6

        # ---- roll-paper delamination (reactingOneDimRPvol.C:1215-1330)
        self.roll_paper = self.model in (
            "reactingOneDimRPvol", "reactingOneDimRPvol2", "reactingOneDimRollPaper")
        if self.roll_paper:
            self.Tcrt = coeffs.get_scalar("Tcrt", 600.0)
            self.paper_to_fuel = coeffs.get_scalar("paperToFuelRatio", 1.0)

        # ---- end BCs from 0/<region>/T ----
        tfield = self._region_field(case_dir, "T")
        bf = tfield.get_dict("boundaryField") if tfield is not None else FoamDict()
        self.bc_exposed = _parse_end_bc(bf, r.coupled_patch)
        self.bc_back = _parse_end_bc(bf, f"{r.zone}_top")

    # ------------------------------------------------------------------
    def _region_field(self, case_dir: str, name: str) -> Optional[FoamDict]:
        p = f"{case_dir}/0/{self.region_name}/{name}"
        if os.path.exists(p):
            return parse_file(p, case_dir=case_dir)
        return None

    def _region_field_value(self, case_dir: str, name: str, default: float) -> float:
        d = self._region_field(case_dir, name)
        if d is None:
            return default
        v = d.lookup("internalField", None)
        return default if v is None else _uniform(v)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype, device=self.device)

    def _c(self, name: str, a) -> torch.Tensor:
        """A host constant's device copy, made once (a pageable host-to-device
        copy waits for the card)."""
        cache = self.__dict__.setdefault("_dev", {})
        if name not in cache:
            cache[name] = self._t(a)
        return cache[name]

    # ------------------------------------------------------------------
    def initial_state(self) -> Dict:
        r = self.region
        nF, nL = r.n_faces, r.n_layers
        kw = dict(dtype=self.dtype, device=self.device)
        Y = self._t(self._Y0).expand(nF, nL, -1).clone()
        T = torch.full((nF, nL), self.T_init, **kw)
        rho = torch.full((nF, nL), self._rho0, **kw)
        st = {
            "rho": rho,
            "Y": Y,
            "T": T,
            "h": self.thermo.hs(T, Y),
            "Ys0": rho[..., None] * Y,  # c₀ per species (pyrolysisChemistryModel)
            "lostSolidMass": torch.zeros((), **kw),
            "addedGasMass": torch.zeros((), **kw),
        }
        if self.char_oxi:
            st["mCharBurnt"] = torch.zeros((nF,), **kw)
        if self.move_mesh:
            st["dx"] = self._t(r.dx).expand(nF, -1).clone()
        if self.roll_paper:
            for k in ("page", "QnetSmooth", "blockFactor", "vD0", "vD1", "vD2"):
                st[k] = torch.zeros((nF,), **kw)
        return st

    # ------------------------------------------------------------------
    def _end_flux_lin(self, bc: EndBC, T_end, Y_end, q_ext, qr_ext):
        """Semi-implicit linearised boundary heat flux into the end cell,
        F ≈ A − B·(h_new − h_old). Returns (A, B)."""
        cp = torch.clamp(self.thermo.cp(Y_end), min=1e-30)
        if bc.kind == "fixedIncidentRadiation":
            eps = self.thermo.emissivity(Y_end)
            return (eps * (bc.qr_incident - SIGMA_SB * T_end ** 4),
                    4.0 * eps * SIGMA_SB * T_end ** 3 / cp)
        if bc.kind == "constH":
            return bc.h * (bc.Tinf - T_end), bc.h / cp + torch.zeros_like(T_end)
        if bc.kind == "constHRad":
            # convection + grey surroundings radiation at Tinf; 'correlation':
            # Churchill-Chu Nu(Ra_L) with the reference's air properties
            h = bc.h
            if bc.mode == "correlation":
                Tf = 0.5 * (T_end + bc.Tinf)
                beta = 1.0 / torch.clamp(Tf, min=1.0)
                RaL = torch.clamp(
                    9.8 * beta * (T_end - bc.Tinf) * 0.9 ** 3 / (26.4e-6 * 38.3e-6), min=0.0)
                NuL = (0.825 + 0.387 * RaL ** (1.0 / 6.0)
                       / (1.0 + (0.492 / 0.69) ** (9.0 / 16.0)) ** (8.0 / 27.0)) ** 2
                h = NuL * 33.8e-3 / 0.9
            eps = bc.emissivity
            F = h * (bc.Tinf - T_end) + eps * SIGMA_SB * (bc.Tinf ** 4 - T_end ** 4)
            return F, (h + 4.0 * eps * SIGMA_SB * T_end ** 3) / cp
        if bc.kind == "coupled":
            # flux into the solid = kΔ_gas·(T_gas − T_s) + a·qin − εσT_s⁴,
            # linearised in T_s (turbulentTemperatureRadiationQinCoupledMixed,
            # solid side)
            eps = self.thermo.emissivity(Y_end)
            ab = self.thermo.absorptivity(Y_end)
            kd = q_ext["kDelta"] if q_ext is not None else 0.0
            Tn = q_ext["T_nbr"] if q_ext is not None else T_end
            qin = qr_ext if qr_ext is not None else 0.0
            F = kd * (Tn - T_end) + ab * qin - eps * SIGMA_SB * T_end ** 4
            return F, (kd + 4.0 * eps * SIGMA_SB * T_end ** 3) / cp
        zero = torch.zeros_like(T_end)
        return zero, zero

    # ------------------------------------------------------------------
    def evolve(self, st: Dict, dt, q_conv: Optional[Dict] = None,
               qr: Optional[torch.Tensor] = None) -> Tuple[Dict, Dict]:
        """One pyrolysis step (reactingOneDim::evolveRegion)."""
        r = self.region
        dtp = self.dtype
        tiny = small(dtp)
        rho, Y, T, h, Ys0 = st["rho"], st["Y"], st["T"], st["h"], st["Ys0"]
        dt = torch.as_tensor(dt, dtype=dtp, device=rho.device)
        nF, nL = rho.shape
        dx2 = st["dx"] if self.move_mesh else self._c("dx", r.dx).expand(nF, nL)

        # ---- chemistry (explicit rates, availability-limited) ----
        RRs, RRg, qc = self.chem.rates(rho, Y, T, Ys0)
        for rx in self.chem.reactions:
            avail = torch.clamp(rho * Y[..., rx.lhs], min=0.0)
            cons = torch.clamp(-RRs[..., rx.lhs], min=tiny) * dt
            scale = torch.clamp(avail / cons, max=1.0)
            RRs = RRs * scale[..., None]
            RRg = RRg * scale
            qc = qc * scale

        # ---- continuity + species ----
        rho_new = torch.clamp(rho - dt * RRg, min=1e-3)
        rhoY = rho[..., None] * Y + dt * RRs
        Y_new = torch.clamp(rhoY / rho_new[..., None], min=0.0)
        Y_new = Y_new / torch.clamp(Y_new.sum(-1, keepdim=True), min=tiny)
        # the products' c₀ (updateC0 in pyrolysisChemistryModel::omega)
        Ys0_new = Ys0
        for rx in self.chem.reactions:
            if rx.rhs_solid >= 0:
                Ys0_new = Ys0_new.clone()
                Ys0_new[..., rx.rhs_solid] = (Ys0_new[..., rx.rhs_solid]
                                              + rx.sr * -RRs[..., rx.lhs] * dt)

        # ---- moving-mesh surface regression ----
        if self.move_mesh:
            dx_reg = torch.clamp(dx2 * rho_new / torch.clamp(rho, min=tiny), min=self.min_delta)
            Ys0_new = Ys0_new * (dx2 / dx_reg)[..., None]
            rho_reg = rho_new * dx2 / dx_reg
        else:
            dx_reg, rho_reg = dx2, rho_new

        # ---- energy: implicit tridiagonal in h ----
        cp = self.thermo.cp(Y_new)
        kappa = self.thermo.kappa(Y_new)
        alpha = kappa / cp
        a_f = 0.5 * (alpha[:, 1:] + alpha[:, :-1])
        k_f = 0.5 * (kappa[:, 1:] + kappa[:, :-1])
        dcc = 0.5 * (dx_reg[:, 1:] + dx_reg[:, :-1])  # [nF, nL-1]
        cond = a_f / dcc
        zcol = torch.zeros((nF, 1), dtype=dtp, device=rho.device)
        lower = torch.cat([zcol, -cond], dim=1)
        upper = torch.cat([-cond, zcol], dim=1)
        # diag: transient + gas-loss sink + both faces' conductances
        diag = rho_reg * dx_reg / dt + RRg * dx2
        diag = diag + torch.cat([zcol, cond], dim=1)
        diag = diag + torch.cat([cond, zcol], dim=1)
        rhs = rho * h * dx2 / dt + qc * dx2
        # explicit correction ∇·(κ∇T) − ∇·(α∇h) (composition-varying cp)
        corr_f = k_f * (T[:, 1:] - T[:, :-1]) / dcc - a_f * (h[:, 1:] - h[:, :-1]) / dcc
        rhs = rhs + torch.cat([corr_f, zcol], dim=1)
        rhs = rhs + torch.cat([zcol, -corr_f], dim=1)

        # end fluxes (exposed = layer 0, back = layer nL−1)
        A0, B0 = self._end_flux_lin(self.bc_exposed, T[:, 0], Y_new[:, 0], q_conv, qr)
        if self.roll_paper:
            # curled delaminated pages shadow the incident flux; the blocked
            # fraction exchanges radiatively with the gas through the page
            # (rollPaperTwoZoneSTFvPatchScalarField.C:614-624)
            bf0 = torch.clamp(st["blockFactor"], 0.0, 1.0)
            shade = 1.0 - bf0
            eps0 = self.thermo.emissivity(Y_new[:, 0])
            cp0 = torch.clamp(self.thermo.cp(Y_new[:, 0]), min=1e-30)
            Tg = (q_conv["T_nbr"] if isinstance(q_conv, dict) and q_conv.get("T_nbr") is not None
                  else T[:, 0])
            q_block = eps0 * SIGMA_SB * (Tg ** 4 - T[:, 0] ** 4)
            A0 = shade * A0 + bf0 * q_block
            B0 = shade * B0 + bf0 * (4.0 * eps0 * SIGMA_SB * T[:, 0] ** 3 / cp0)
        An, Bn = self._end_flux_lin(self.bc_back, T[:, -1], Y_new[:, -1], None, None)
        # the end layers' one-hot rows (device constants: a slice
        # assignment of a Python number would read a scalar on the host)
        end0 = self._c("end0", np.eye(1, nL, 0)[0])[None, :]
        endn = self._c("endn", np.eye(1, nL, nL - 1)[0])[None, :]
        diag = diag + end0 * B0[:, None]
        rhs = rhs + end0 * (A0 + B0 * h[:, 0])[:, None]
        diag = diag + endn * Bn[:, None]
        rhs = rhs + endn * (An + Bn * h[:, -1])[:, None]

        # ---- char oxidation (reactingOneDim21CharOxi::updateCharOxi) ----
        area = self._c("area", r.area)
        zf = torch.zeros((nF,), dtype=dtp, device=rho.device)
        phi_o2, phi_co2, char_qdot = zf, zf, zf
        m_char_burnt = st.get("mCharBurnt")
        if self.char_oxi and isinstance(q_conv, dict) and q_conv.get("O2_nbr") is not None:
            mW_O2, mW_char, mW_CO2 = 32.0, 12.0, 44.0
            # O2 diffusive flux from the gas: phiO2 = −αΔ·O2·|Sf| [kg/s]
            phi_o2 = -q_conv["alphaDelta_O2"] * q_conv["O2_nbr"] * area
            dm_o2 = -phi_o2 * dt
            m_char = torch.sum(rho_new * Y_new[..., self.char_idx] * (dx_reg * area[:, None]),
                               dim=1)
            char_avail = torch.clamp(m_char - m_char_burnt, min=0.0)
            dm_burn = torch.minimum(char_avail, dm_o2 / mW_O2 * mW_char)
            dt_s = torch.clamp(dt, min=tiny)
            phi_o2 = -dm_burn / mW_char * mW_O2 / dt_s
            phi_co2 = dm_burn / mW_char * mW_CO2 / dt_s
            m_char_burnt = m_char_burnt + dm_burn
            q_char = self.hoc_char * dm_burn / (area * dt_s)  # [W/m²] into layer 0
            rhs = rhs + end0 * q_char[:, None]
            char_qdot = q_char * area

        h_new = tridiag_solve(lower, diag, upper, rhs)
        T_new = self.thermo.T_from_hs(h_new, Y_new)

        # ---- mass transfer to the gas (calculateMassTransfer) ----
        mlr = torch.sum(RRg * dx2, dim=1)  # kg/m²/s
        phi_gas = mlr * area  # [nF] kg/s

        # ---- roll-paper delamination + buffered fuel release ----
        rp_state = {}
        if self.roll_paper:
            paper_thick = dx_reg[:, 0]
            qnet_s = (st["QnetSmooth"] + A0 * dt) / (1.0 + dt)
            # the surface above Tcrt peels a page: the surface layer's virgin
            # mass × paperToFuelRatio enters the release buffer
            dela = T_new[:, 0] > self.Tcrt
            lv = paper_thick * area
            m_sp = rho_reg[:, 0, None] * Y_new[:, 0, :] * lv[:, None]
            pM = torch.where(dela, m_sp[:, 0] * self.paper_to_fuel, zf)
            v0 = st["vD0"] + pM
            m_sp = torch.cat([(m_sp[:, 0] - pM)[:, None], m_sp[:, 1:]], dim=1)
            m_tot = torch.clamp(m_sp.sum(-1), min=tiny)
            rho_reg = torch.cat([torch.clamp(m_tot / lv, min=1e-3)[:, None], rho_reg[:, 1:]],
                                dim=1)
            Y_new = torch.cat([(m_sp / m_tot[:, None])[:, None, :], Y_new[:, 1:, :]], dim=1)
            page = st["page"] + dela.to(dtp)
            # double-exponential release (reactingOneDimRPvol.C:203-209)
            v1 = (st["vD1"] + v0 * dt) / (1.0 + dt)
            release = (v1 - st["vD2"]) / (1.0 + dt)
            v2 = (st["vD2"] + v1 * dt) / (1.0 + dt)
            phi_gas = phi_gas + torch.clamp(release, min=0.0)
            # blockFactor relaxation toward fa0(page) (Ning correlation)
            fa0 = 0.5 - 10.0 / (20.0 + page)
            tshrink = torch.clamp(paper_thick * 1.5e8 / (1.0e4 + torch.abs(qnet_s)), 0.05, 5.0)
            bf = st["blockFactor"] - (st["blockFactor"] - fa0) * dt / tshrink
            bf = torch.where(dela, torch.ones_like(bf), bf)
            bf = torch.where(page > 0, bf, zf)
            rp_state = {"page": page, "QnetSmooth": qnet_s, "blockFactor": bf,
                        "vD0": v0, "vD1": v1, "vD2": v2}

        vol = dx_reg * area[:, None]
        st_new = {
            "rho": rho_reg,
            "Y": Y_new,
            "T": T_new,
            "h": h_new,
            "Ys0": Ys0_new,
            "lostSolidMass": st["lostSolidMass"] - torch.sum(RRs.sum(-1) * vol) * dt,
            "addedGasMass": st["addedGasMass"] + torch.sum(RRg * vol) * dt,
        }
        if self.char_oxi:
            st_new["mCharBurnt"] = m_char_burnt
        if self.move_mesh:
            st_new["dx"] = dx_reg
        st_new.update(rp_state)
        out = {
            "phiGas": phi_gas,
            "mlr": mlr,
            "T_surface": T_new[:, 0],
            "Qdot_total": torch.sum(qc * vol),
            "T_min": torch.min(T_new),
            "T_max": torch.max(T_new),
            "phiO2": phi_o2,  # [nF] kg/s (≤ 0: consumed from the gas)
            "phiCO2": phi_co2,  # [nF] kg/s returned to the gas
            "charOxiQdot": torch.sum(char_qdot),
        }
        return st_new, out

    # ------------------------------------------------------------------
    def diffusion_number(self, st: Dict, dt) -> torch.Tensor:
        """solidRegionDiffNo (reactingOneDim.C:612-629)."""
        if "dx" in st:
            dcc = 0.5 * (st["dx"][:, 1:] + st["dx"][:, :-1])
        else:
            x = self._c("x", self.region.x)
            dcc = x[1:] - x[:-1]
        Y, rho = st["Y"], st["rho"]
        kappa = self.thermo.kappa(Y)
        rcp = rho * self.thermo.cp(Y)
        k_f = 0.5 * (kappa[:, 1:] + kappa[:, :-1])
        rcp_f = 0.5 * (rcp[:, 1:] + rcp[:, :-1])
        return torch.max(k_f / rcp_f / dcc ** 2) * dt


class PyrolysisCollection:
    """All pyrolysis zones of constant/pyrolysisZones
    (pyrolysisModelCollection.C:108-123)."""

    def __init__(self, case_dir: str, cm, dtype=None, device=None):
        zones_dict = parse_file(f"{case_dir}/constant/pyrolysisZones", case_dir=case_dir)
        self.zones: List[ReactingOneDim] = []
        for name, zd in zones_dict.subdicts():
            if name == "FoamFile" or not zd.get_bool("active", True):
                continue
            model = zd.get_word("pyrolysisModel", "reactingOneDim")
            if model == "pyroCUPOneDimV1":
                from .pyrocup import PyroCUP

                self.zones.append(PyroCUP(case_dir, cm, zd, dtype, device))
            elif model in MODELS:
                self.zones.append(ReactingOneDim(case_dir, cm, zd, dtype, device))
            elif model not in ("none", "noPyrolysis"):
                raise NotImplementedError(f"pyrolysisModel '{model}'")

    def initial_state(self) -> List[Dict]:
        return [z.initial_state() for z in self.zones]

    def evolve(self, states, dt, q_conv=None, qr=None):
        new_states, outs = [], []
        for z, st in zip(self.zones, states):
            qc = q_conv.get(z.region_name) if isinstance(q_conv, dict) else q_conv
            qr_z = qr.get(z.region_name) if isinstance(qr, dict) else qr
            st2, out = z.evolve(st, dt, qc, qr_z)
            new_states.append(st2)
            outs.append(out)
        return new_states, outs

    def diffusion_number(self, states, dt):
        return torch.max(torch.stack([z.diffusion_number(s, dt)
                                      for z, s in zip(self.zones, states)]))
