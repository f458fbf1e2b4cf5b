"""pyroCUPOneDimV1: the cartoned-commodity (CUP) pyrolysis ledger.

The port of firefoam_tpu/regionmodels/pyrocup.py (the reference's
pyroCUPOneDimV1.{H,C}). A lumped unit-cell burn ledger on top of
reactingOneDim21CharOxi: each coupled boundary face carries a
cartoned-commodity unit cell that burns in regimes, and the inner unit
cells of each pallet deplete as one lumped mass:

  IOL     the outer (cardboard) liner is present: the 1-D solid supplies
          phiGas; its pyrolysate depletion is tracked per face until the
          OLCrit fraction has burnt through (pyroCUPOneDimV1.C:903-905);
  IOUCHU  the outer unit cell heats up from the incident fluxes to
          igniTempUC (:1222-1226);
  IOUCR1  regime 1: the CCMassFracUC fraction of the corrugated cardboard
          gasifies at heatGassUC with flame feedback QFlameUC (:1186, :1237);
  IOUCR2  regime 2: the rest burns at heatGassUC2 with QFlameUC2; near
          burnout the energy splits 50/50 with the inner cells (:929-934);
  IIUC    the inner unit cells: a lumped per-pallet ledger, the local
          rate capped by the pallet's remaining mass (:1289-1306).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import small
from ..io.foamdict import FoamDict
from .pyrolysis import ReactingOneDim

__all__ = ["PyroCUP"]

SIGMA = 5.670367e-8


def _pos(x):
    """OpenFOAM pos(): 1 where x > 0 else 0."""
    return (x > 0).to(x.dtype) if torch.is_tensor(x) else float(x > 0)


class PyroCUP(ReactingOneDim):
    """pyroCUPOneDimV1: CharOxi transport + the CUP unit-cell ledger."""

    def __init__(self, case_dir: str, cm, zone_dict: FoamDict, dtype=None, device=None):
        super().__init__(case_dir, cm, zone_dict, dtype, device)
        coeffs = zone_dict.get_dict(
            self.model + "Coeffs", zone_dict.get_dict("reactingOneDimCoeffs", FoamDict()))

        def g(k, d):
            return float(coeffs.get_scalar(k, d))

        p = {}
        p["igniTempUC"] = g("igniTempUC", 800.0)
        p["CpUC"] = g("CpUC", 600.0)
        emm = g("emissivityUC", 0.6)
        ab = g("absorptivityUC", 0.75)
        p["emmHU"], p["absHU"] = emm, ab
        p["emmR1"] = g("emissivityUCR1", emm)
        p["emmR2"] = g("emissivityUCR2", emm)
        p["absR1"] = g("absorptivityUCR1", ab)
        p["absR2"] = g("absorptivityUCR2", ab)
        p["heatGassUC"] = g("heatGassUC", 1.8e6)
        p["heatGassUC2"] = g("heatGassUC2", 6e6)
        p["QFlameUC"] = g("QFlameUC", 30000.0)
        p["QFlameUC2"] = g("QFlameUC2", 36000.0)
        p["QFlameExtra"] = g("QFlameExtra", 10000.0)
        p["QFlameExtraOUCR1"] = g("QFlameExtraOUCR1", 10000.0)
        p["OLCrit"] = g("OLCrit", 0.04)
        p["OUCEnSplit"] = g("OUCEnSplit", 0.02)
        p["multFacQFl"] = g("multFacQFl", 1.0)
        p["EnLossFracSpec"] = coeffs.get_bool("EnLossFracSpec", True)
        p["UCEnLossFr"] = g("UCEnLossFr", 0.2)
        p["UCEnLossFixed"] = g("UCEnLossFixed", 20000.0)
        p["ConvLossFracSpec"] = coeffs.get_bool("ConvLossFracSpec", True)
        p["UCConvLossFr"] = g("UCConvLossFr", 0.1)
        p["UCConvLossFrR2"] = g("UCConvLossFrR2", 0.1)
        p["UCConvLossFixed"] = g("UCConvLossFixed", 10000.0)
        p["massFracUC"] = g("CCMassFracUC", 0.6)
        p["heatGassIUC"] = g("heatGassInnerUC", 3e6)
        p["initMassUCCC"] = g("initMassUCCC", 2.2)
        p["initMassUCPS"] = g("initMassUCPS", 3.2)
        p["initMassIUCCC"] = g("initMassIUCCC", 2.2)
        p["initMassIUCPS"] = g("initMassIUCPS", 3.2)
        p["initMassUC"] = p["initMassUCCC"] + p["initMassUCPS"]
        p["initMassIUC"] = p["initMassIUCCC"] + p["initMassIUCPS"]
        p["hocPyrCC"] = g("hocPyrCC", 1.3e7)
        p["hocPyrPS"] = g("hocPyrPS", 2.6e7)
        p["hocPyrUC"] = p["hocPyrCC"]
        mf = p["massFracUC"]
        p["hocPyrUC2"] = (
            (1.0 - mf) * p["initMassUCCC"] * p["hocPyrCC"] + p["initMassUCPS"] * p["hocPyrPS"]
        ) / ((1.0 - mf) * p["initMassUCCC"] + p["initMassUCPS"])
        p["hocPyrIUC"] = (
            p["initMassIUCCC"] * p["hocPyrCC"] + p["initMassIUCPS"] * p["hocPyrPS"]
        ) / (p["initMassIUCCC"] + p["initMassIUCPS"])
        p["tempIUC"] = g("TempInnerUC", 800.0)
        p["emmIUC"] = g("emissivityInnerUC", 0.6)
        p["absIUC"] = g("absorptivityInnerUC", 0.6)
        # threshold between regime 1 and 2 (pyroCUPOneDimV1.C:869)
        p["thresholdUCMass"] = p["initMassUC"] - mf * p["initMassUCCC"]
        # regime-2 energy-split threshold (:920-927)
        es = p["OUCEnSplit"] * p["thresholdUCMass"]
        crit = 0.01 * p["initMassUC"]
        p["energySplitThres"] = max(es, crit + 1e-16)
        # UC-vs-IUC CC heat fractions for the fuel split (:1046-1051)
        p["UC_CCFrac"] = ((1.0 - mf) * p["initMassUCCC"] * p["hocPyrCC"]) / (
            (1.0 - mf) * p["initMassUCCC"] * p["hocPyrCC"] + p["initMassUCPS"] * p["hocPyrPS"])
        p["IUC_CCFrac"] = (p["initMassIUCCC"] * p["hocPyrCC"]) / (
            p["initMassIUCCC"] * p["hocPyrCC"] + p["initMassIUCPS"] * p["hocPyrPS"])
        self.cup = p

        # solid species roles (preEvolveRegion :860-866)
        names = [str(s) for s in self.thermo.species]
        self.v_idx = names.index("v") if "v" in names else 0
        self.ch_idx = names.index("char") if "char" in names else None
        self.dspec_idx = names.index("dSpec") if "dSpec" in names else None
        rhoV = float(self.thermo.rho_s[self.v_idx])
        rhoC = float(self.thermo.rho_s[self.ch_idx]) if self.ch_idx is not None else 0.0
        self.gasToVFac = rhoV / max(rhoV - rhoC, 1e-12)

        # ---- pallet grid (face → pallet, :228-420) ----
        r = self.region
        nx = int(coeffs.get_scalar("nXPallets", 2))
        ny = int(coeffs.get_scalar("nYPallets", 2))
        nz = int(coeffs.get_scalar("nZPallets", 2))
        dX, dY, dZ = g("dXPallets", 1.2192), g("dYPallets", 1.2192), g("dZPallets", 1.524)
        lX, lY, lZ = g("lXPallet", 1.0668), g("lYPallet", 1.0668), g("lZPallet", 1.0668)
        org = coeffs.lookup("botCorPalletOrigin", None)
        org = (np.asarray([float(v) for v in org]) if org is not None
               else np.array([-0.6096, -0.6096, 1.143]))
        self.n_pallets = nx * ny * nz
        cf = np.asarray(cm.mesh.Cf)[np.asarray(r.prim_faces)]
        f2p = np.full(r.n_faces, -1, np.int64)
        pid = 0
        for kz in range(nz):
            for jy in range(ny):
                for ix in range(nx):
                    lo = org + np.array([ix * dX, jy * dY, kz * dZ])
                    hi = lo + np.array([lX, lY, lZ])
                    inside = np.all((cf >= lo - 1e-9) & (cf <= hi + 1e-9), axis=1)
                    f2p[inside & (f2p < 0)] = pid
                    pid += 1
        self._face2pallet = np.maximum(f2p, 0)
        self._has_pallet = (f2p >= 0).astype(np.float64)
        area = np.asarray(r.area, np.float64)
        pa = np.zeros(self.n_pallets)
        np.add.at(pa, np.maximum(f2p, 0), np.where(f2p >= 0, area, 0.0))
        self.pallet_area = np.maximum(pa, 1e-30)
        # per-face initial OL virgin mass [kg]: rhoV × column volume (:484-488)
        self._mOLInit = rhoV * area * float(np.sum(np.asarray(r.dx)))
        # the per-pallet sum of face fluxes in a fixed order: one row per
        # pallet listing its faces (no colliding addition on any device)
        from ..ops.geometry import SegSum

        self._pallet_sum = SegSum(self._face2pallet, self.n_pallets, self.device)

    @property
    def mOLInit(self) -> torch.Tensor:
        return self._c("mOLInit", self._mOLInit)

    # ------------------------------------------------------------------
    def initial_state(self) -> Dict:
        st = super().initial_state()
        nF = self.region.n_faces
        kw = dict(dtype=self.dtype, device=self.device)
        p = self.cup
        st.update(
            tempUC=torch.full((nF,), 298.0, **kw),
            massUC=torch.full((nF,), p["initMassUC"], **kw),
            mOLLost=torch.zeros((nF,), **kw),
            totalMassIUC=self._t(p["initMassIUC"] * self.pallet_area),
        )
        return st

    # ------------------------------------------------------------------
    def _indicators(self, st):
        """preEvolveRegion indicator update (pyroCUPOneDimV1.C:856-954)."""
        p = self.cup
        m_UC = st["massUC"]
        T_UC = st["tempUC"]
        IOL = _pos((1.0 - p["OLCrit"]) * self.mOLInit - self.gasToVFac * st["mOLLost"])
        ccBurnt = 1.0 - 2.0 * IOL
        IIUC = _pos(0.01 * p["initMassUC"] - m_UC)
        UCBurnt = 2.0 * IIUC - 1.0
        IOUCHU = _pos(ccBurnt) * _pos(p["igniTempUC"] - T_UC - 1e-15)
        thres = _pos(m_UC - p["thresholdUCMass"])
        IOUCR1 = _pos(ccBurnt) * _pos(0.5 - IOUCHU) * thres
        pre_R2 = _pos(-UCBurnt) * _pos(0.5 - thres) * _pos(0.5 - IOUCHU)
        # near-burnout 50/50 energy split with the IUC (:929-934)
        IOUCR2 = pre_R2 * torch.clamp(_pos(m_UC - p["energySplitThres"]), min=0.5)
        IIUC = IIUC + pre_R2 * (1.0 - IOUCR2)
        return IOL, IOUCHU, IOUCR1, IOUCR2, IIUC

    # ------------------------------------------------------------------
    def evolve(self, st, dt, q_conv=None, qr=None):
        p = self.cup
        r = self.region
        dtp = self.dtype
        nF = r.n_faces
        area = self._c("area", r.area)
        zero = torch.zeros((nF,), dtype=dtp, device=self.device)
        dt = torch.as_tensor(dt, dtype=dtp, device=self.device)
        qrad = qr if qr is not None else zero
        qconv = q_conv if torch.is_tensor(q_conv) else zero

        IOL, IOUCHU, IOUCR1, IOUCR2, IIUC = self._indicators(st)

        # where the liner is gone, its solid becomes dSpec (:938-948)
        if self.dspec_idx is not None:
            gone = (1.0 - IOL)[:, None, None]
            Y = st["Y"]
            dcol = self._c("dspec", np.eye(1, Y.shape[-1], self.dspec_idx)[0]).expand_as(Y)
            st = dict(st)
            st["Y"] = Y * (1.0 - gone) + dcol * gone

        st2, out = super().evolve(st, dt, q_conv=q_conv, qr=qr)
        st2 = dict(st2)
        for k in ("tempUC", "massUC", "mOLLost", "totalMassIUC"):
            st2[k] = st[k]
        T_UC = st2["tempUC"]
        m_UC = st2["massUC"]
        Cp_UC = p["CpUC"]

        # regime-composited emissivity/absorptivity (:1203-1210)
        base_e = self.thermo.emissivity(st["Y"][:, 0])
        emm = (base_e * IOL + p["emmHU"] * IOUCHU + p["emmR1"] * IOUCR1
               + p["emmR2"] * IOUCR2 + p["emmIUC"] * IIUC)
        ab = (base_e * IOL + p["absHU"] * IOUCHU + p["absR1"] * IOUCR1
              + p["absR2"] * IOUCR2 + p["absIUC"] * IIUC)

        # energy-loss terms (:1212-1231)
        QLoss = qrad * p["UCEnLossFr"] if p["EnLossFracSpec"] else p["UCEnLossFixed"] + zero
        QConvLoss = (
            qrad * (p["UCConvLossFr"] * IOUCR1 + p["UCConvLossFrR2"] * (IOUCR2 + IIUC))
            if p["ConvLossFracSpec"] else p["UCConvLossFixed"] + zero)
        qnet_wo_emm = (qrad * ab + 0.5 * QLoss) * area
        IUCExist = _pos(IIUC - 0.25)
        OUCExist = _pos(IOUCR2 - 0.25)

        q_to_R1 = (qnet_wo_emm + (p["QFlameUC"] + p["QFlameExtraOUCR1"]) * area) * IOUCR1
        q_to_OUC = (
            (qnet_wo_emm + (p["QFlameUC2"] + p["QFlameExtra"]) * area) * (1.0 - IUCExist)
            + 0.67 * (qrad * ab + 0.2 * QLoss + p["multFacQFl"] * p["QFlameUC2"]
                      + p["QFlameExtra"]) * area * IUCExist
        ) * OUCExist
        q_to_IUC = (
            (qnet_wo_emm + (1.5 * p["QFlameUC2"] + p["QFlameExtra"]) * area) * (1.0 - OUCExist)
            + 0.33 * (qrad * ab + 0.4 * QLoss + p["multFacQFl"] * p["QFlameUC2"]
                      + p["QFlameExtra"]) * area * OUCExist
        ) * IUCExist

        # remaining incident radiation + in-cell flame release (:1249-1263)
        qinc_rem = (qrad - qrad * ab - QConvLoss - 0.5 * QLoss
                    - 0.1 * QLoss * IUCExist * OUCExist)
        QFlame = (IOUCR1 * p["QFlameUC"] + p["QFlameUC2"] * (IOUCR2 + IIUC)
                  + (p["multFacQFl"] - 1.0) * p["QFlameUC2"] * IUCExist)
        energyRelUC = torch.maximum(25.0 + QFlame - qinc_rem, QFlame)

        # unit-cell heat-up (:1218-1228)
        Tbnd = 298.0 * IOL + T_UC * (IOUCHU + IOUCR1 + IOUCR2) + p["tempIUC"] * IIUC
        qemm = emm * SIGMA * Tbnd ** 4 * area
        qnet = (qrad * ab + qconv) * area - qemm
        dT = qnet * dt / (Cp_UC * area * (m_UC + 1e-16))
        T_UC = torch.clamp(T_UC + dT * IOUCHU, 298.0, p["igniTempUC"] + 5.0)
        Tbnd = 298.0 * IOL + T_UC * (IOUCHU + IOUCR1 + IOUCR2) + p["tempIUC"] * IIUC

        # effective emissivity from the UC emissive flux (:1233-1238)
        qemmUC = qinc_rem + energyRelUC - QFlame
        effEmm = torch.clamp(qemmUC, min=0.0) / (SIGMA * Tbnd ** 4)
        emm = base_e * IOL + p["emmHU"] * IOUCHU + effEmm * (IOUCR1 + IOUCR2 + IIUC)
        ab = base_e * IOL + p["absHU"] * IOUCHU + 1.0 * (IOUCR1 + IOUCR2 + IIUC)

        # unit-cell mass loss (:1240-1244, :1272)
        mdot_UC = q_to_R1 / p["heatGassUC"] + q_to_OUC / p["heatGassUC2"]
        mdot_UC = torch.minimum(torch.clamp(mdot_UC, min=0.0), m_UC * area / dt)
        m_UC = torch.clamp(m_UC - mdot_UC * dt / area, min=0.0)
        mdot_IUC = torch.clamp(q_to_IUC / p["heatGassIUC"], min=0.0)

        # OL pyrolysate depletion ledger (:1242)
        mOLLost = st2["mOLLost"] + out["phiGas"] * IOL * dt

        # flame-energy deduction from the outgoing flux (:1272)
        mdot_UC = torch.clamp(
            mdot_UC - energyRelUC * area * IOUCR1 / p["hocPyrUC"]
            - energyRelUC * area * IOUCR2 / p["hocPyrUC2"], min=0.0)

        # per-pallet IUC depletion with global mass capping (:1289-1346)
        has = self._c("has_pallet", self._has_pallet)
        f2p = self._c("face2pallet", self._face2pallet).long()
        flux_pallet = self._pallet_sum(mdot_IUC * has)
        total = st2["totalMassIUC"]
        scale = torch.where(flux_pallet * dt > total,
                            total / torch.clamp(flux_pallet * dt, min=small(dtp)),
                            torch.ones_like(total))
        total_new = torch.clamp(total - scale * flux_pallet * dt, min=0.0)
        mdot_IUC = mdot_IUC * scale[f2p] * has
        mdot_IUC = torch.clamp(mdot_IUC - energyRelUC * area * IIUC / p["hocPyrIUC"], min=0.0)

        phi_gas = out["phiGas"] * IOL + mdot_UC + mdot_IUC

        # pyrolysate heat of combustion + CC/PS fuel split (:1363-1375)
        tot = mdot_UC + mdot_IUC + 1e-16
        pyrHOC = p["hocPyrUC"] * IOUCR1 + (IOUCR2 + IIUC) * (
            mdot_UC * p["hocPyrUC2"] + mdot_IUC * p["hocPyrIUC"]) / tot
        e_tot = mdot_UC * p["hocPyrUC2"] + mdot_IUC * p["hocPyrIUC"] + 1e-16
        mfCC = (IOL + IOUCHU + IOUCR1 + (IOUCR2 + IIUC) * (
            mdot_UC * p["hocPyrUC2"] * p["UC_CCFrac"]
            + mdot_IUC * p["hocPyrIUC"] * p["IUC_CCFrac"]) / e_tot)
        mfCC = torch.clamp(mfCC, 0.0, 1.0)

        st2["tempUC"] = T_UC
        st2["massUC"] = m_UC
        st2["mOLLost"] = mOLLost
        st2["totalMassIUC"] = total_new
        out = dict(out)
        out["phiGas"] = phi_gas
        out["mlr"] = torch.sum(phi_gas)
        out["emissivity"] = emm
        out["absorptivity"] = ab
        out["pyrHOC"] = pyrHOC
        out["massFluxFracCC"] = mfCC
        out["massFluxFracPS"] = 1.0 - mfCC
        out["T_bnd_UC"] = Tbnd
        out["mdotUC"] = mdot_UC
        out["mdotIUC"] = mdot_IUC
        return st2, out
