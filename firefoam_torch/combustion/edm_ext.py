"""EDM extinction variants: eddyDissipationBertExtModel and
eddyDissipationFRVModel (lib/thermophysicalModels/combustionModels/*).

Both extend the base EDM with a quenched-fuel surrogate specie "Fstar":
extinguished fuel converts to Fstar instead of burning, and reignites back
when conditions recover.

BertExt (eddyDissipationBertExtModel.C):
  * per-cell adiabatic flame temperature Tad (with optional radiative loss)
    from a hardcoded-C3H8 mole balance + secant iteration,
  * an extinction temperature from the strain correlation
    Textinction = 1328.5·a^0.1143 (a > 7, else 1659 — C3H8 fit),
  * flags FEF (extinction: T_cell < FuelExtTemp or Tad < Textinction after
    ExtinctionStart) and FIF (reignition: T_cell > FuelStarExtTemp),
  * R(fuel) = −ẇ + FIF·ẆFstar, R(Fstar) = FEF·ẇ − FIF·ẆFstar,
    R(other) = (1−FEF)·ẇ·ν_i, Qdot = q_fuel·ẇ·(1−FEF).

FRV (eddyDissipationFRVModel.C): laminar-flamelet reactive-volume fraction
  * Tad/TadMixed by Cp-slope Newton on the species enthalpy balance,
  * Karlovitz number Ka vs quenching limit KaExt from SL(Tad), flame
    thickness and the radiative-loss coefficient (calculateReactiveVolume),
  * FRV ∈ [0,1] burning fraction and Fig reignition flag,
  * R(fuel) = −ẇ, R(Fstar) = (1−FRV)·ẇ − Fig·ẆFstar,
    R(other) = (FRV·ẇ + Fig·ẆFstar)·ν_i.

Everything is cell-wise algebra with fixed iteration counts (5 secant
steps, 10 Newton steps, 10 partial-extinction steps: the JAX package's,
never cut short by a tolerance), so the reference's forAll loops become
masked vector ops and both packages take the same steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ExtCoeffs", "bert_ext_rates", "frv_rates"]

_SIGMA = 5.67e-8


@dataclass
class ExtCoeffs:
    """Shared + per-model coefficients (lookupOrDefault defaults)."""

    t_ext: float = 5.0  # ExtinctionStart
    T_fuel_ext: float = 400.0  # FuelExtTemp
    T_fstar_ext: float = 1000.0  # FuelStarExtTemp
    C_strain: float = 0.25  # Cstrain
    C_evap: float = 0.5  # Cevap
    Xr_ext: float = 0.05  # XrExtinction
    near_wall_ext: bool = False  # nearWallExtinction
    rad_heat_loss: bool = False  # radiativeHeatLoss
    # FRV extras
    ZN: float = 10.0
    c_ka: float = 1.0  # cKa
    c_kapa: float = 1.0  # cKapa
    T_air: float = 293.15  # TAir
    Tad_air: float = 2400.0  # TadAir
    SLC1: float = 56.0
    SLC2: float = 11.4
    T_fuel: float = 293.15  # TFuel (inlet fuel temperature)

    @classmethod
    def from_dict(cls, coeffs) -> "ExtCoeffs":
        g = coeffs.get_scalar
        return cls(
            t_ext=g("ExtinctionStart", 5.0),
            T_fuel_ext=g("FuelExtTemp", 400.0),
            T_fstar_ext=g("FuelStarExtTemp", 1000.0),
            C_strain=g("Cstrain", 0.25),
            C_evap=g("Cevap", 0.5),
            Xr_ext=g("XrExtinction", coeffs.get_scalar("XrExt", 0.05)),
            near_wall_ext=coeffs.get_bool("nearWallExtinction", False),
            rad_heat_loss=coeffs.get_bool("radiativeHeatLoss", False),
            ZN=g("ZN", 10.0),
            c_ka=g("cKa", 1.0),
            c_kapa=g("cKapa", 1.0),
            T_air=g("TAir", 293.15),
            Tad_air=g("TadAir", 2400.0),
            SLC1=g("SLC1", 56.0),
            SLC2=g("SLC2", 11.4),
            T_fuel=g("TFuel", 293.15),
        )


def _max(a, b):
    """jnp.maximum with either side a Python number."""
    if not torch.is_tensor(a):
        return torch.clamp(b, min=a)
    if not torch.is_tensor(b):
        return torch.clamp(a, min=b)
    return torch.maximum(a, b)


def _min(a, b):
    """jnp.minimum with either side a Python number."""
    if not torch.is_tensor(a):
        return torch.clamp(b, max=a)
    if not torch.is_tensor(b):
        return torch.clamp(a, max=b)
    return torch.minimum(a, b)


def _where(cond, a, b):
    """jnp.where with either branch a Python number."""
    like = a if torch.is_tensor(a) else b
    as_t = lambda v: v if torch.is_tensor(v) else torch.tensor(
        v, dtype=like.dtype, device=like.device)
    return torch.where(cond, as_t(a), as_t(b))


def _hs(gas, idx, T):
    """Per-specie sensible enthalpy at T [J/kg] (thermo Hs(p,T))."""
    return gas.hs_species(T)[:, idx]


# ---------------------------------------------------------------------------
# BertExt
# ---------------------------------------------------------------------------

def _bert_flame_temperature(gas, reaction, co: ExtCoeffs, Y, T, p, rho,
                            spray_rho, fstar_idx):
    """calculateFlameTemperature (eddyDissipationBertExtModel.C:506-660):
    mole balance with the reference's hardcoded C3H8/product molar masses,
    entrainment of local products and spray water, then TadLoss by the
    published quadratic fit and Tad by 5 secant steps on the CO2/H2O/N2
    enthalpy balance."""
    r = reaction
    fi = r.fuel_index
    iO2, iN2 = gas.index("O2"), gas.index("N2")
    iCO2, iH2O = gas.index("CO2"), gas.index("H2O")
    s = float(r.s)
    qF = float(r.q_fuel())

    YF, YO2 = Y[:, fi], Y[:, iO2]
    YN2, YCO2, YH2O = Y[:, iN2], Y[:, iCO2], Y[:, iH2O]
    YFs = Y[:, fstar_idx]
    active = (YF > 1e-3) & (YO2 > 1e-3)

    m = rho
    mFuel = m * (YF + YFs)
    mO2, mN2 = m * YO2, m * YN2
    mCO2, mH2O = m * YCO2, m * YH2O
    mWater = spray_rho

    nFuel, nO2 = mFuel / 44.0, mO2 / 32.0
    nN2, nCO2, nH2O = mN2 / 28.0, mCO2 / 44.0, mH2O / 18.0

    RN = nN2 * 5.0 / _max(nO2 + 1.6667 * nCO2, 1e-30)
    nN2r = RN * nO2 / 5.0
    nN2p = _max(0.0, nN2 - nN2r)
    nH2Op = 1.33333 * nCO2
    mN2p = nN2p * 28.0

    dmFuel = _min(mFuel, mO2 / s)
    dmCO2 = 3.0 * dmFuel
    dmH2Op = 4.0 * dmFuel * 18.0 / 44.0
    dmN2 = RN * dmFuel * 28.0 / 44.0

    dnFuel = dmFuel / 44.0
    entrain = dnFuel * (1.0 + 5.0 + RN) / _max(nO2 + nN2r + nFuel, 1e-30)
    dmWater = co.C_evap * mWater * entrain

    CCO2 = dmCO2 + entrain * mCO2
    CH2O = dmH2Op + entrain * mH2O + dmWater
    CN2 = dmN2 + entrain * mN2p
    hrr = dmFuel * qF
    hrr_loss = dmFuel * qF * (1.0 - co.Xr_ext)

    # sensible enthalpy of the entrained mixture above 293.15 K
    hT = gas.hs_species(T)
    h293 = gas.hs_species(torch.full_like(T, 293.15))
    mhp = entrain * (
        mFuel * (hT[:, fi] - h293[:, fi])
        + mO2 * (hT[:, iO2] - h293[:, iO2])
        + mCO2 * (hT[:, iCO2] - h293[:, iCO2])
        + mH2O * (hT[:, iH2O] - h293[:, iH2O])
        + mN2 * (hT[:, iN2] - h293[:, iN2])
    )
    h_evap = dmWater * 2.6e6

    # published quadratic fit (eA·X² + eB·X − eC = eD)
    eA = CCO2 * 0.0926897 + CH2O * 0.282627 + CN2 * 0.0672494
    eB = CCO2 * 1077.18 + CH2O * 1892.55 + CN2 * 1064.99
    eC = CCO2 * 38985.8 + CH2O * 24301.8 + CN2 * 14618.6
    eD = mhp + hrr - h_evap
    eD_loss = mhp + hrr_loss - h_evap
    eA = _max(eA, 1e-30)
    tad_loss = (torch.sqrt(eB * eB + 4.0 * eA * (eC + eD_loss)) - eB) / (2.0 * eA) + 293.15

    # secant iteration on CCO2·Hs_CO2(T) + CH2O·Hs_H2O(T) + CN2·Hs_N2(T) = eD
    def balance(Tx):
        h = gas.hs_species(Tx)
        return CCO2 * h[:, iCO2] + CH2O * h[:, iH2O] + CN2 * h[:, iN2] - eD

    T1 = torch.full_like(T, 1500.0)
    T2 = torch.full_like(T, 1600.0)
    T3 = torch.full_like(T, 1700.0)
    dH2 = balance(T2)
    for _ in range(5):
        dH3 = balance(T3)
        go = (torch.abs(dH3) > CCO2 * 1e4) & (T3 > 300.0) & (T3 < 3000.0)
        T1n, dH1n = T2, dH2
        T2n, dH2n = T3, dH3
        T3n = T1n - (T2n - T1n) * dH1n / _where(
            torch.abs(dH2n - dH1n) < 1e-30, 1e-30, dH2n - dH1n
        )
        T1 = _where(go, T1n, T1)
        dH2 = _where(go, dH2n, dH2)
        T2 = _where(go, T2n, T2)
        T3 = _where(go, T3n, T3)
    tad = T3
    return _where(active, tad, 0.0), _where(active, tad_loss, 0.0)


def bert_ext_rates(gas, reaction, co: ExtCoeffs, Y, T, p, rho, rt, dt,
                   C_stiff, spray_rho, near_wall, t, fstar_idx):
    """Rates + flags (eddyDissipationBertExtModel::correct)."""
    r = reaction
    s = float(r.s)
    YF, YO2 = Y[:, r.fuel_index], Y[:, gas.index("O2")]
    YFs = Y[:, fstar_idx]
    fac = (1.0 - torch.exp(-C_stiff * dt * rt)) / (C_stiff * dt)
    w_fuel = rho * _min(YF, YO2 / s) * fac
    w_fstar = rho * YFs * fac

    strain = co.C_strain * rt
    tad, tad_loss = _bert_flame_temperature(
        gas, reaction, co, Y, T, p, rho, spray_rho, fstar_idx
    )
    # C3H8 strain-extinction correlation (eddyDissipationBertExtModel.C:370)
    t_ext_T = _where(
        strain > 7.0, 1328.5 * _max(strain, 1e-10) ** 0.1143, 1659.0
    )
    fif = (T > co.T_fstar_ext).to(Y.dtype)
    t_cmp = tad_loss if co.rad_heat_loss else tad
    fef = (
        (t >= co.t_ext) & ((T < co.T_fuel_ext) | (t_cmp < t_ext_T))
    ).to(Y.dtype)
    if not co.near_wall_ext and near_wall is not None:
        fef = _where(near_wall, 0.0, fef)
    # a still-flammable extinguished cell cannot simultaneously reignite
    fif = _where((fef > 0) & (YF > 1e-3) & (YO2 > 1e-3), 0.0, fif)
    return {"w_fuel": w_fuel, "WFstar": w_fstar, "FEF": fef, "FIF": fif,
            "Tad": tad, "Textinction": t_ext_T}


# ---------------------------------------------------------------------------
# FRV
# ---------------------------------------------------------------------------

def _frv_flame_temperatures(gas, reaction, co: ExtCoeffs, Y, T, p, rho,
                            spray_rho, fstar_idx):
    """Tad/ExpR and TadMixed/ExpRMixed (eddyDissipationFRVModel.C:700-925):
    Cp-slope Newton on the local premixed-adiabatic enthalpy balance."""
    r = reaction
    fi = r.fuel_index
    iO2, iN2 = gas.index("O2"), gas.index("N2")
    iCO2, iH2O = gas.index("CO2"), gas.index("H2O")
    W = 8314.47 / np.asarray(gas.R_sp)
    WF, WO2, WN2 = float(W[fi]), float(W[iO2]), float(W[iN2])
    WCO2, WH2O = float(W[iCO2]), float(W[iH2O])
    s = float(r.s)
    qF = float(r.q_fuel())
    # product mass yields per kg fuel
    dY = np.asarray(reaction.mass_stoich_coeffs)
    rCO2, rH2O = float(dY[iCO2]), float(dY[iH2O])

    YF, YO2 = Y[:, fi], Y[:, iO2]
    YN2, YCO2, YH2O = Y[:, iN2], Y[:, iCO2], Y[:, iH2O]
    YFs = Y[:, fstar_idx]

    O2tot = YCO2 / WCO2 + 0.5 * YH2O / WH2O + YO2 / WO2
    XO2 = torch.clamp(O2tot / (O2tot + YN2 / WN2 + 1e-6), 1e-6, 0.25)
    rN2 = s * (1.0 - XO2) * WN2 / (XO2 * WO2)
    Yspray = _min(co.C_evap * spray_rho / rho, 1.0)

    hT = gas.hs_species(T)
    hs_mix_T = YO2 * hT[:, iO2] + YN2 * hT[:, iN2] + YCO2 * hT[:, iCO2] + YH2O * hT[:, iH2O]

    def newton(CN2c, CCO2c, CH2Oc, CFsc, CO2c, RHS, T0):
        Tn = T0
        for _ in range(10):
            c, h = gas.cp_species(Tn), gas.hs_species(Tn)
            cp_eff = (
                CN2c * c[:, iN2]
                + CCO2c * c[:, iCO2]
                + CH2Oc * c[:, iH2O]
                + CFsc * c[:, fi]
                + CO2c * c[:, iO2]
            )
            lhs = (
                CN2c * h[:, iN2]
                + CCO2c * h[:, iCO2]
                + CH2Oc * h[:, iH2O]
                + CFsc * h[:, fi]
                + CO2c * h[:, iO2]
            )
            Tn = torch.clamp(Tn + (RHS - lhs) / _max(cp_eff, 1e-10), 200.0, 5000.0)
        return Tn

    # ---- normal fuel ----
    act1 = (YF > 1e-4) & (YO2 > 1e-4)
    YN2R = _min(YN2, YO2 * WN2 * (1.0 - XO2) / (WO2 * XO2))
    YN2P = _max(0.0, YN2 - YN2R)
    YFR = _min(YF, YO2 / s)
    MFO, MFN = WF / WO2, WF / WN2
    ER = (
        YFR * (1.0 + s * MFO + s * MFN * YN2R / _max(YO2, 1e-30))
        / _max(YF + MFO * YO2 + MFN * YN2, 1e-30)
    )
    CN2c = ER * YN2P + rN2 * YFR
    CCO2c = ER * YCO2 + rCO2 * YFR
    CH2Oc = ER * (YH2O + Yspray) + rH2O * YFR
    CFsc = ER * YFs
    RHS1 = YFR * qF * (1.0 - co.Xr_ext)
    RHS2 = _min(RHS1, ER * Yspray * 3.0e6)
    RHS3 = ER * (hs_mix_T + (YF + YFs) * hT[:, fi])
    TF0 = torch.full_like(T, co.T_fuel)
    TA0 = torch.full_like(T, co.T_air)
    RHS4 = (
        (YFR - ER * YF) * _hs(gas, fi, TF0)
        + (s * YFR - ER * YO2) * _hs(gas, iO2, TA0)
        + (rN2 * YFR - ER * YN2R) * _hs(gas, iN2, TA0)
    )
    tad = newton(CN2c, CCO2c, CH2Oc, CFsc, torch.zeros_like(T),
                 RHS1 - RHS2 + RHS3 + RHS4, T)
    exp_factor = (rCO2 / WCO2 + rH2O / WH2O + rN2 / WN2) / (
        1.0 / WF + s / WO2 + rN2 / WN2
    )
    expr = _where(act1, tad / co.T_air * exp_factor, 1.0)
    tad = _where(act1, tad, T)

    # ---- mixed (Fstar) fuel ----
    act2 = (YFs > 1e-4) & (YO2 > 1e-4)
    YFR2 = _min(YFs, YO2 / s)
    CN2m = YN2
    CH2Om = YH2O + rH2O * YFR2 + Yspray
    CCO2m = YCO2 + rCO2 * YFR2
    CFsm = YFs - YFR2
    CO2m = YO2 - s * YFR2
    R1 = YFR2 * qF * (1.0 - co.Xr_ext)
    R2 = _min(R1, Yspray * 3.0e6)
    R3 = hs_mix_T + YFs * hT[:, fi]
    tadm = newton(CN2m, CCO2m, CH2Om, CFsm, CO2m, R1 - R2 + R3, T)
    exprm = _where(act2, tadm / co.T_air * exp_factor, 1.0)
    tadm = _where(act2, tadm, T)
    return tad, expr, tadm, exprm


def frv_rates(gas, reaction, co: ExtCoeffs, Y, T, p, rho, rt, dt, C_stiff,
              spray_rho, nu, nut, eps_sgs, t, fstar_idx):
    """Reactive-volume fraction FRV and reignition flag Fig
    (eddyDissipationFRVModel::calculateReactiveVolume)."""
    r = reaction
    s = float(r.s)
    YF, YO2 = Y[:, r.fuel_index], Y[:, gas.index("O2")]
    YFs = Y[:, fstar_idx]
    fac = (1.0 - torch.exp(-C_stiff * dt * rt)) / (C_stiff * dt)
    w_fuel = rho * _min(YF, YO2 / s) * fac
    w_fstar = rho * _min(YFs, YO2 / s) * fac

    tad, expr, tadm, exprm = _frv_flame_temperatures(
        gas, reaction, co, Y, T, p, rho, spray_rho, fstar_idx
    )

    krad = 0.7
    kai = (tad / co.T_air) ** 1.75 * 1.4e-5 / 0.75
    eps_g = eps_sgs * (kai + nut) / (1e-8 + nut)

    def branch(tad_x, expr_x, kai_x, Y_gate):
        SL = _max(1e-4, co.SLC1 * torch.exp(-1000.0 * co.SLC2 / tad_x))
        d_fl = _min(0.1, kai_x / SL)
        beta = torch.clamp(
            co.ZN * (co.Tad_air / tad_x) ** 2 * (tad_x - co.T_air)
            / (co.Tad_air - co.T_air),
            6.0, 20.0,
        )
        disc = torch.sqrt(_max((beta + 0.667) ** 2 - 6.667 * beta, 0.0))
        Xext = ((beta + 0.667) + disc) / (2.0 * beta)
        Cka = (expr_x * co.ZN) ** 2 / (6.0 * co.c_kapa * (tad_x / co.T_air) ** 1.75) / torch.exp(beta)
        Te0 = Xext * tad_x
        Calpha = (
            5.33 * _SIGMA * krad * d_fl ** 2 * Te0 ** 3
            / (co.c_kapa * kai_x * (1.2 * co.T_air / Te0) * 530.0 * Te0 ** 0.1131)
        )
        Ka = _min(10.0, co.c_ka * d_fl ** 2 * torch.sqrt(eps_g) / kai_x ** 1.5)
        KaExt = _max(
            0.0,
            Cka * (1.0 - Xext) * torch.exp(beta * Xext) / Xext ** (5.0 / 3.0)
            - Calpha * Xext ** (4.0 / 3.0),
        ) ** 1.5
        ext_no = KaExt - 1.0 / Xext
        return SL, d_fl, beta, Xext, Cka, Calpha, Ka, KaExt, ext_no

    # normal-fuel branch → FRV
    SL, d_fl, beta, Xext, Cka, Calpha, Ka, KaExt, ext_no = branch(
        tad, expr, kai, YF
    )
    # partial-extinction inner iteration (10 fixed steps)
    X1 = Xext - 0.05
    X2 = Xext + 0.05
    X3 = Xext - 0.05
    for _ in range(10):
        X1 = torch.log(
            _max(
                X1 * ((Ka * X1) ** 0.667 + Calpha * X1 ** 2)
                / _max(Cka * (1.0 - X1), 1e-30),
                1e-30,
            )
        ) / beta
        YX2 = (
            torch.exp(_min(beta * X2, 50.0)) * Cka * X2 ** 0.333
            / _max(Ka ** 0.667 + Calpha * X2 ** 1.333, 1e-30)
        )
        X2 = (torch.sqrt(YX2 ** 2 + 4.0 * YX2) - YX2) / 2.0
        X3 = torch.log(
            _max(
                X3 * (1.0 + Calpha * X3 ** 2)
                / _max(Cka * (1.0 - X3), 1e-30),
                1e-30,
            )
        ) / beta
    frv_partial = torch.clamp(
        (torch.abs(X3 / _where(torch.abs(X1) < 1e-30, 1e-30, X1)) ** 5.0
         - torch.abs(X3) ** 5.0)
        / _max(1.0 - torch.abs(X3) ** 5.0, 1e-30),
        0.0, 1.0,
    )
    frv = _where(
        ext_no < 0.0,
        0.0,
        _where(
            Ka > KaExt,
            0.0,
            _where(
                Ka < 1.1,
                1.0,
                _where(KaExt - Ka < 0.05, 0.3, frv_partial),
            ),
        ),
    )
    frv = _where((YF > 1e-4) & (YO2 > 1e-4), frv, 0.0)
    frv = _where(YO2 < 1e-4, 1.0, frv)  # pure fuel stays flammable

    # mixed-fuel branch → Fig
    kaim = (tadm / co.T_air) ** 1.75 * 1.4e-5 / 0.75
    _, _, _, _, _, _, KaM, KaExtM, ext_noM = branch(tadm, exprm, kaim, YFs)
    fig = ((YFs > 1e-4) & (ext_noM >= 0.0) & (KaM <= KaExtM)).to(Y.dtype)

    before = t < co.t_ext
    frv = _where(before, 1.0, frv)
    fig = _where(before, 1.0, fig)
    return {"w_fuel": w_fuel, "WFstar": w_fstar, "FRV": frv, "Fig": fig,
            "Tad": tad, "TadMixed": tadm}
