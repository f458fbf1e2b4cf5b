"""MPPIC (multiphase particle-in-cell) submodels.

The port of firefoam_tpu/lagrangian/mppic.py. Reference: packages/
lagrangian/intermediateNew/submodels/MPPIC/* and the MPPICParcel averaging
sweep (MPPICParcelTrackingDataI.H:140-246). The dense-spray corrections work
on Eulerian averages of the parcel population:

  averages   volume α, mass, mass-weighted ū and |U−ū|², Sauter-type radius
             r = Σn·Vp / Σn·Vp^{2/3}, collision frequency
             f = 0.75·α/r³·(d/2+r)²·|U−ū| (f²-weighted cell average)
  stress     τ(α, ρ, u²): HarrisCrighton Ps·α^β/max(αcp−α, ε(1−α));
             Lun α·ρ·(1+2(1+e)α·g0)·u²/3 with g0 = 0.6/max(1−(α/αcp)^⅓,…);
             exponential g0/preExp·exp(preExp(α−αcp)) (capped expMax)
  timescale  1/τt: equilibrium / nonEquilibrium a·α·√u²/r·αcp/(αcp−α),
             isotropic a·f·αcp/(αcp−α)  (e-restitution constants)
  packing    Explicit.C: dU = −Δt·∇τ/(ρp·α), correction-limited;
             Implicit shares the same gradient form
  damping    Relaxation.C: dU = (ū−U)·x/(x+2), x = Δt/τt
  isotropy   Stochastic.C: resample U ~ ū + N(0,1)·√(u²/3) with prob
             1−exp(−Δt/τt), then restore the cell mean/variance

Every average is an order-fixed parcel→cell sum (tracking.CellSum over the
alive parcels: a dead lane adds exact zeros in the JAX package's
segment_sum, so leaving it out changes nothing) and every correction is
masked elementwise math. The isotropy draws come from the key the cloud
passes in (prng: the JAX package's generator bit for bit).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..io.foamdict import FoamDict
from ..ops import fvc
from ..ops.fields import VolField
from . import prng
from .tracking import CellSum

__all__ = ["MPPIC", "ParticleStress", "TimeScale", "limited_velocity", "mppic_averages"]

_PI = math.pi
_SMALL = 1e-15


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=1))


# ---------------------------------------------------------------- averages
def mppic_averages(st, rho_p, geom, seg: Optional[CellSum] = None):
    """Cell averages of the parcel population (MPPICParcelTrackingDataI.H).
    Returns per-cell alpha, u_mean [·,3], u_sqr, radius, freq and the
    per-parcel mass m_p. `seg`: the alive parcels' CellSum (built here when
    not given)."""
    c = st["cell"]
    alive = st["alive"]
    if seg is None:
        seg = CellSum(c, geom.n_cells, keep=alive)
    w = torch.where(alive, st["nP"], torch.zeros_like(st["nP"]))
    vol_p = (_PI / 6.0) * st["d"] ** 3
    m_p = rho_p * vol_p
    wm = w * m_p
    s1 = seg(torch.stack([w * vol_p, wm, wm * st["U"][:, 0], wm * st["U"][:, 1],
                          wm * st["U"][:, 2], w * vol_p ** (2.0 / 3.0)], dim=1))
    vol_sum, mass_sum = s1[:, 0], s1[:, 1]
    alpha = vol_sum / geom.V
    msum = torch.clamp(mass_sum, min=_SMALL)
    u_mean = s1[:, 2:5] / msum[:, None]
    du = st["U"] - u_mean[c]
    # Sauter-type radius: Σn·Vp / Σn·Vp^{2/3}
    radius = vol_sum / torch.clamp(s1[:, 5], min=_SMALL)
    # collision frequency, f²-weighted
    r_c = radius[c]
    f_p = 0.75 * alpha[c] / torch.clamp(r_c ** 3, min=_SMALL) * (0.5 * st["d"] + r_c) ** 2 * _norm(du)
    s2 = seg(torch.stack([wm * torch.sum(du * du, dim=1), w * f_p * f_p, w * f_p], dim=1))
    u_sqr = s2[:, 0] / msum
    freq = s2[:, 1] / torch.clamp(s2[:, 2], min=_SMALL)
    return {"alpha": alpha, "u_mean": u_mean, "u_sqr": u_sqr, "radius": radius,
            "freq": freq, "m_p": m_p}


# ------------------------------------------------------------------ stress
@dataclass
class ParticleStress:
    kind: str = "HarrisCrighton"
    alpha_packed: float = 0.6
    Ps: float = 10.0
    beta: float = 2.0
    eps: float = 1e-7
    e: float = 0.9
    pre_exp: float = 500.0
    exp_max: float = 1000.0
    g0: float = 1000.0

    @classmethod
    def from_dict(cls, d: FoamDict) -> "ParticleStress":
        kind = d.get_word("type", "HarrisCrighton")
        sub = d.get_dict(kind + "Coeffs", d)
        return cls(
            kind=kind,
            alpha_packed=d.get_scalar("alphaPacked", sub.get_scalar("alphaPacked", 0.6)),
            Ps=sub.get_scalar("pSolid", 10.0),
            beta=sub.get_scalar("beta", 2.0),
            eps=sub.get_scalar("eps", 1e-7),
            e=sub.get_scalar("e", 0.9),
            pre_exp=sub.get_scalar("preExp", 500.0),
            exp_max=sub.get_scalar("expMax", 1000.0),
            g0=sub.get_scalar("g0", 1000.0),
        )

    def tau(self, alpha, rho, u_sqr):
        acp = self.alpha_packed
        if self.kind == "Lun":
            den = torch.maximum(
                1.0 - (torch.clamp(alpha, min=0.0) / acp) ** (1.0 / 3.0),
                torch.clamp(self.eps * (1.0 - alpha), min=_SMALL),
            )
            g0 = 0.6 / den
            return alpha * rho * (1.0 + 2.0 * (1.0 + self.e) * alpha * g0) * u_sqr / 3.0
        if self.kind == "exponential":
            return (self.g0 * torch.clamp(torch.exp(self.pre_exp * (alpha - acp)),
                                          max=self.exp_max) / self.pre_exp)
        # HarrisCrighton
        den = torch.maximum(acp - alpha, torch.clamp(self.eps * (1.0 - alpha), min=_SMALL))
        return self.Ps * torch.clamp(alpha, min=0.0) ** self.beta / den


# --------------------------------------------------------------- timescale
@dataclass
class TimeScale:
    kind: str = "nonEquilibrium"
    alpha_packed: float = 0.6
    e: float = 0.9

    @classmethod
    def from_dict(cls, d: FoamDict) -> "TimeScale":
        kind = d.get_word("type", "nonEquilibrium")
        sub = d.get_dict(kind + "Coeffs", d)
        return cls(kind=kind, alpha_packed=sub.get_scalar("alphaPacked", 0.6),
                   e=sub.get_scalar("e", 0.9))

    def one_by_tau(self, alpha, r32, u_sqr, f):
        acp, e = self.alpha_packed, self.e
        pack = acp / torch.clamp(acp - alpha, min=_SMALL)
        if self.kind == "isotropic":
            a = 8.0 * math.sqrt(2.0) / (5.0 * _PI) * 0.25 * (3.0 - e) * (1.0 + e)
            return a * f * pack
        if self.kind == "equilibrium":
            a = 16.0 / math.sqrt(3.0 * _PI) * 0.25 * (1.0 - e * e)
        else:  # nonEquilibrium
            a = 8.0 * math.sqrt(2.0) / (3.0 * _PI) * 0.25 * (1.0 - e * e)
        return a * alpha * torch.sqrt(torch.clamp(u_sqr, min=0.0)) / torch.clamp(
            r32, min=_SMALL) * pack


# ----------------------------------------------------------------- limiter
def limited_velocity(kind: str, e: float, U_p, dU, u_mean):
    """CorrectionLimitingMethods: minMod(dU, −(1+e)·uRel[·|U|/|uRel|])."""
    if kind in ("none", "noCorrectionLimiting"):
        return dU
    rel = U_p - u_mean
    if kind == "absolute":
        mag_rel = torch.clamp(_norm(rel), min=_SMALL)
        lim = -(1.0 + e) * rel * (_norm(U_p) / mag_rel)[:, None]
    else:  # relative
        lim = -(1.0 + e) * rel
    # component-wise minMod (OpenFOAM minMod: smaller magnitude, same sign)
    same = dU * lim > 0.0
    pick = torch.where(torch.abs(dU) < torch.abs(lim), dU, lim)
    return torch.where(same, pick, torch.zeros_like(pick))


# -------------------------------------------------------------------- MPPIC
@dataclass
class MPPIC:
    """Composed packing/damping/isotropy pass over the parcel SoA."""

    packing: Optional[str] = None  # explicit | implicit
    stress: Optional[ParticleStress] = None
    limiter_kind: str = "absolute"
    limiter_e: float = 0.9
    damping: Optional[str] = None  # relaxation
    damping_ts: Optional[TimeScale] = None
    isotropy: Optional[str] = None  # stochastic
    isotropy_ts: Optional[TimeScale] = None
    rho_p: float = 1000.0

    @classmethod
    def from_dict(cls, sub: FoamDict, rho0: float) -> Optional["MPPIC"]:
        """The subModels dict's packingModel/dampingModel/isotropyModel
        entries; None when all are none/absent."""
        self = cls(rho_p=rho0)
        pk = sub.get_word("packingModel", "none")
        if pk.lower() not in ("none", "nopacking"):
            self.packing = "implicit" if pk.lower().startswith("impl") else "explicit"
            pc = sub.get_dict(pk + "Coeffs", FoamDict())
            self.stress = ParticleStress.from_dict(
                pc.get_dict("particleStressModel", pc.get_dict("particleStress", pc)))
            lim = pc.get_dict("correctionLimitingMethod", FoamDict())
            self.limiter_kind = lim.get_word("type", "absolute")
            self.limiter_e = lim.get_dict(self.limiter_kind + "Coeffs", lim).get_scalar("e", 0.9)
        dm = sub.get_word("dampingModel", "none")
        if dm.lower() not in ("none", "nodamping"):
            self.damping = "relaxation"
            dc = sub.get_dict(dm + "Coeffs", sub.get_dict("relaxationCoeffs", FoamDict()))
            self.damping_ts = TimeScale.from_dict(dc.get_dict("timeScaleModel", dc))
        im = sub.get_word("isotropyModel", "none")
        if im.lower() not in ("none", "noisotropy"):
            self.isotropy = "stochastic"
            ic = sub.get_dict(im + "Coeffs", sub.get_dict("stochasticCoeffs", FoamDict()))
            self.isotropy_ts = TimeScale.from_dict(ic.get_dict("timeScaleModel", ic))
        if not (self.packing or self.damping or self.isotropy):
            return None
        return self

    # ------------------------------------------------------------------
    def apply(self, st: Dict, geom, dt, key) -> Dict:
        """One MPPIC correction pass (MPPICCloud::motion order: damping →
        packing → isotropy at step end)."""
        c = st["cell"]
        alive = st["alive"]
        seg = CellSum(c, geom.n_cells, keep=alive)
        av = mppic_averages(st, self.rho_p, geom, seg)
        U = st["U"]

        if self.damping is not None:
            inv_tau = self.damping_ts.one_by_tau(av["alpha"], av["radius"], av["u_sqr"],
                                                 av["freq"])
            x = dt * inv_tau[c]
            dU = (av["u_mean"][c] - U) * (x / (x + 2.0))[:, None]
            U = torch.where(alive[:, None], U + dU, U)

        if self.packing is not None:
            # cell stress field → Gauss gradient → parcel correction
            tau_c = self.stress.tau(av["alpha"], self.rho_p, av["u_sqr"])
            grad_tau = fvc.grad_scalar(geom, VolField(tau_c, geom.cell_to_boundary(tau_c)))
            alpha_p = torch.clamp(av["alpha"][c], min=1e-8)
            dU = -dt * grad_tau[c] / (self.rho_p * alpha_p)[:, None]
            dU = limited_velocity(self.limiter_kind, self.limiter_e, U, dU, av["u_mean"][c])
            U = torch.where(alive[:, None], U + dU, U)

        if self.isotropy is not None:
            inv_tau = self.isotropy_ts.one_by_tau(av["alpha"], av["radius"], av["u_sqr"],
                                                  av["freq"])
            x_cell = torch.exp(-dt * inv_tau)
            k1, k2 = prng.split(key)
            u = prng.uniform(k1, tuple(st["d"].shape), U.dtype, device=U.device)
            resample = (u > x_cell[c]) & alive
            r = prng.normal(k2, tuple(U.shape), U.dtype, device=U.device)
            u_rms = torch.sqrt(torch.clamp(av["u_sqr"][c], min=0.0))
            U_new = av["u_mean"][c] + r * (u_rms / math.sqrt(3.0))[:, None]
            U = torch.where(resample[:, None], U_new, U)
            # conservation correction: restore the cell mean and variance
            w = torch.where(alive, st["nP"] * av["m_p"], torch.zeros_like(av["m_p"]))
            s1 = seg(torch.stack([w, w * U[:, 0], w * U[:, 1], w * U[:, 2]], dim=1))
            msum = torch.clamp(s1[:, 0], min=_SMALL)
            u_tilde = s1[:, 1:4] / msum[:, None]
            du = U - u_tilde[c]
            ut_sqr = seg(w * torch.sum(du * du, dim=1)) / msum
            scale = u_rms / torch.clamp(torch.sqrt(torch.clamp(ut_sqr, min=0.0))[c], min=_SMALL)
            U_corr = av["u_mean"][c] + du * scale[:, None]
            U = torch.where(alive[:, None], U_corr, U)

        st = dict(st)
        st["U"] = U
        return st
