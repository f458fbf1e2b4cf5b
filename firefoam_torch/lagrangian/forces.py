"""Particle force family (submodels/Kinematic/ParticleForces).

The port of firefoam_tpu/lagrangian/forces.py.

Reference: packages/lagrangian/intermediateNew/submodels/Kinematic/
ParticleForces — each model returns a forceSuSp: explicit Su [N] plus an
implicit coefficient Sp [kg/s] applied to (Uc − Up), composed additively by
ParticleForceList. Here the whole list is one vectorised evaluation over the
parcel SoA: every model maps to masked elementwise math over [N]-arrays, the
composition is two running sums (Su, Sp), and the drag-implicit Euler update
in cloud.py consumes them unchanged — no per-parcel virtual dispatch.

Models (reference file: formula):
  sphereDrag        SphereDragForce.C       CdRe = 24(1+Re^{2/3}/6) | 0.424·Re
  nonSphereDrag     NonSphereDragForce.C    Haider-Levenspiel shape factor φ
  distortedSphereDrag DistortedSphereDragForce.C  sphere CdRe·(1+2.632 y)
  WenYuDrag         WenYuDragForce.C        αc-corrected Schiller-Naumann
  ErgunWenYuDrag    ErgunWenYuDragForce.C   Ergun (αc<0.8) / WenYu branch
  PlessisMasliyahDrag PlessisMasliyahDragForce.C  granular A,B model
  SaffmanMeiLift    SaffmanMeiLiftForce.C   Cl(Rew, β) shear lift
  TomiyamaLift      TomiyamaLiftForce.C     Eötvös-number bubble lift
  pressureGradient  PressureGradientForce.C Su = m·ρc/ρp·DUc/Dt
  virtualMass       VirtualMassForce.C      Cvm·pressureGradient + added mass
  gravity           GravityForce.C          m·g·(1 − ρc/ρp)
  paramagnetic / nonInertialFrame / SRF: accepted but inert without the
  field data they require (magnetic field / frame motion), matching the
  solver's use (no fire case exercises them).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["ParticleForces"]

_PI = float(np.pi)


def _sphere_cdre(Re):
    """SphereDragForce::CdRe (SphereDragForce.C:31-41)."""
    return torch.where(
        Re > 1000.0, 0.424 * Re, 24.0 * (1.0 + (Re ** (2.0 / 3.0)) / 6.0)
    )


def _schiller_naumann_cdre(Re):
    """WenYuDragForce::CdRe (WenYuDragForce.C:33-43)."""
    return torch.where(
        Re > 1000.0, 0.44 * Re, 24.0 * (1.0 + 0.15 * Re**0.687)
    )


@dataclass
class ParticleForces:
    """Vectorised ParticleForceList. Parsed once from the cloud dict's
    particleForces sub-dict; `suSp` evaluates all active models."""

    drag_model: Optional[str] = None  # one of the 6 drag variants
    drag_params: dict = field(default_factory=dict)
    lift_model: Optional[str] = None  # SaffmanMeiLift / TomiyamaLift
    lift_params: dict = field(default_factory=dict)
    gravity: bool = False
    pressure_gradient: bool = False
    virtual_mass: bool = False
    Cvm: float = 0.0
    inert: Tuple[str, ...] = ()  # names of active body-force models
    srf: Optional[dict] = None  # {omega, origin}
    nif: Optional[dict] = None  # {W, omega, omegaDot, CofR}
    para: Optional[dict] = None  # {chi}

    _DRAG = (
        "sphereDrag", "nonSphereDrag", "distortedSphereDrag",
        "WenYuDrag", "ErgunWenYuDrag", "PlessisMasliyahDrag",
    )
    _LIFT = ("SaffmanMeiLift", "TomiyamaLift")
    _INERT = ("paramagnetic", "nonInertialFrame", "SRF", "nonInertialFrameForce")

    @classmethod
    def from_dict(cls, forces_dict) -> "ParticleForces":
        """Parse the particleForces sub-dict (model names as keys, each with
        an optional coefficient sub-dict — `sphereDrag;` bare words parse
        to empty lists, so sub-dicts are fetched leniently)."""

        def sub_of(name):
            from ..io.foamdict import FoamDict

            v = forces_dict.lookup(name, None)
            return v if isinstance(v, FoamDict) else None

        self = cls()
        for name in cls._DRAG:
            if forces_dict.found(name):
                self.drag_model = name
                sub = sub_of(name)
                if sub is not None and sub.found("phi"):
                    self.drag_params["phi"] = sub.get_scalar("phi", 1.0)
        for name in cls._LIFT:
            if forces_dict.found(name):
                self.lift_model = name
                sub = sub_of(name)
                if sub is not None and sub.found("sigma"):
                    self.lift_params["sigma"] = sub.get_scalar("sigma", 0.07)
        self.gravity = forces_dict.found("gravity")
        self.pressure_gradient = forces_dict.found("pressureGradient")
        if forces_dict.found("virtualMass"):
            self.virtual_mass = True
            sub = sub_of("virtualMass")
            self.Cvm = sub.get_scalar("Cvm", 0.5) if sub is not None else 0.5
        self.inert = tuple(n for n in cls._INERT if forces_dict.found(n))
        # rotating-frame / magnetic body forces (ParticleForces/SRF,
        # NonInertialFrame, Paramagnetic). The reference reads the frame
        # data from mesh-registered objects (SRFModel, uniformDimensioned
        # fields, a HdotGradH volVectorField); this framework takes them
        # from the force entry's coefficient sub-dict — absent coefficients
        # leave the model accepted-but-zero, matching the pre-round-3
        # behaviour for dicts that merely name the force.
        def vec(sub, key, default=(0.0, 0.0, 0.0)):
            v = sub.lookup(key, None) if sub is not None else None
            if isinstance(v, (list, tuple)) and len(v) == 3:
                return np.asarray([float(x) for x in v])
            return np.asarray(default, float)

        if forces_dict.found("SRF"):
            sub = sub_of("SRF")
            self.srf = {
                "omega": vec(sub, "omega"),
                "origin": vec(sub, "origin"),
            }
        if forces_dict.found("nonInertialFrame") or forces_dict.found(
            "nonInertialFrameForce"
        ):
            sub = sub_of("nonInertialFrame") or sub_of("nonInertialFrameForce")
            self.nif = {
                "W": vec(sub, "linearAcceleration"),
                "omega": vec(sub, "angularVelocity"),
                "omegaDot": vec(sub, "angularAcceleration"),
                "CofR": vec(sub, "centreOfRotation"),
            }
        if forces_dict.found("paramagnetic"):
            sub = sub_of("paramagnetic")
            self.para = {
                "chi": sub.get_scalar("magneticSusceptibility", 0.0)
                if sub is not None
                else 0.0
            }
        if self.drag_model == "nonSphereDrag":
            phi = self.drag_params.setdefault("phi", 1.0)
            # Haider-Levenspiel coefficients (NonSphereDragForce.C:58-61)
            self.drag_params["a"] = float(
                np.exp(2.3288 - 6.4581 * phi + 2.4486 * phi**2)
            )
            self.drag_params["b"] = 0.0964 + 0.5565 * phi
            self.drag_params["c"] = float(
                np.exp(4.9050 - 13.8944 * phi + 18.4222 * phi**2 - 10.2599 * phi**3)
            )
            self.drag_params["d"] = float(
                np.exp(1.4681 + 12.2584 * phi - 20.7322 * phi**2 + 15.8855 * phi**3)
            )
        return self

    # ------------------------------------------------------------------
    def needs_curl(self) -> bool:
        return self.lift_model is not None

    def needs_ddt(self) -> bool:
        return self.pressure_gradient or self.virtual_mass

    # ------------------------------------------------------------------
    def drag_sp(self, Re, mu_c, rho_p, d, mass, alpha_c=None, y=None):
        """Implicit drag coefficient Sp [kg/s]: F_drag = Sp·(Uc − Up).
        All reference drag models reduce to Sp = m·0.75·μc·CdRe/(ρp·d²)
        (times an αc factor for the dense variants)."""
        if self.drag_model in (None, "sphereDrag"):
            cdre = _sphere_cdre(Re)
            return mass * 0.75 * mu_c * cdre / (rho_p * d**2)
        if self.drag_model == "nonSphereDrag":
            a, b, c, dd = (self.drag_params[k] for k in "abcd")
            cdre = 24.0 * (1.0 + a * Re**b) + Re * c / (1.0 + dd / (Re + 1e-30))
            return mass * 0.75 * mu_c * cdre / (rho_p * d**2)
        if self.drag_model == "distortedSphereDrag":
            yy = torch.clamp(y, 0.0, 1.0) if y is not None else 0.0
            cdre = _sphere_cdre(Re)
            return mass * 0.75 * mu_c * cdre * (1.0 + 2.632 * yy) / (rho_p * d**2)
        ac = alpha_c if alpha_c is not None else 1.0
        if self.drag_model == "WenYuDrag":
            # (mass/ρp)·0.75·μc·CdRe(αc·Re)·αc^{-2.65}/(αc·d²)
            cdre = _schiller_naumann_cdre(ac * Re)
            return mass * 0.75 * mu_c * cdre * ac ** (-2.65) / (rho_p * ac * d**2)
        if self.drag_model == "ErgunWenYuDrag":
            ap = 1.0 - ac
            ergun = mass * (
                150.0 * ap / ac + 1.75 * Re
            ) * mu_c / (ac * rho_p * d**2)
            cdre = _schiller_naumann_cdre(ac * Re)
            wenyu = mass * 0.75 * mu_c * cdre * ac ** (-2.65) / (rho_p * ac * d**2)
            return torch.where(ac < 0.8, ergun, wenyu)
        if self.drag_model == "PlessisMasliyahDrag":
            ap = 1.0 - ac
            cbrt_ap = ap ** (1.0 / 3.0)
            A = 26.8 * ac**3 / (
                cbrt_ap**2 * (1.0 - cbrt_ap) * (1.0 - cbrt_ap**2) ** 2 + 1e-30
            )
            B = ac**2 / (1.0 - cbrt_ap**2) ** 2
            return mass * (A * ap / ac + B * Re) * mu_c / (ac * rho_p * d**2)
        raise ValueError(self.drag_model)

    # ------------------------------------------------------------------
    def lift_su(self, U_p, U_c, curl_Uc, Re, mu_c, rho_c, rho_p, d, mass,
                g=None):
        """Explicit lift force Su [N] (LiftForce.C:calcCoupled):
        Su = (m/ρp)·ρc·Cl·((Uc − Up) × curl Uc)."""
        if self.lift_model is None:
            return torch.zeros_like(U_p)
        if self.lift_model == "SaffmanMeiLift":
            Rew = rho_c * torch.linalg.vector_norm(curl_Uc, dim=1) * d**2 / (mu_c + 1e-30)
            beta = 0.5 * Rew / (Re + 1e-30)
            alpha = 0.3314 * torch.sqrt(beta)
            f = (1.0 - alpha) * torch.exp(-0.1 * torch.clamp(Re, max=100.0)) + alpha
            Cld = torch.where(Re < 40.0, 6.46 * f, 6.46 * 0.0524 * torch.sqrt(beta * Re))
            Cl = 3.0 / (2.0 * _PI * torch.sqrt(Rew + 1e-30)) * Cld
        else:  # TomiyamaLift (TomiyamaLiftForce.C::Cl)
            sigma = self.lift_params.get("sigma", 0.07)
            gmag = float(np.linalg.norm(g)) if g is not None else 9.81
            Eo = gmag * torch.abs(rho_c - rho_p) * d**2 / sigma
            dH = d * (1.0 + 0.163 * Eo**0.757) ** (1.0 / 3.0)
            Eod = gmag * torch.abs(rho_c - rho_p) * dH**2 / sigma
            f = 0.00105 * Eod**3 - 0.0159 * Eod**2 - 0.0204 * Eod + 0.474
            Cl = torch.where(
                Eod <= 4.0,
                torch.minimum(0.288 * torch.tanh(0.121 * Re), f),
                torch.where(Eod <= 10.0, f, -0.27),
            )
        rel = U_c - U_p
        return (mass / rho_p * rho_c * Cl)[:, None] * torch.linalg.cross(rel, curl_Uc)

    # ------------------------------------------------------------------
    def pgrad_su(self, DUcDt, rho_c, rho_p, mass):
        """pressureGradient + virtualMass explicit Su [N]:
        m·(ρc/ρp)·DUc/Dt·(1 [+ Cvm])."""
        if not (self.pressure_gradient or self.virtual_mass):
            return 0.0
        scale = (1.0 if self.pressure_gradient else 0.0) + (
            self.Cvm if self.virtual_mass else 0.0
        )
        return scale * (mass * rho_c / rho_p)[:, None] * DUcDt

    def mass_add(self, mass, rho_c, rho_p):
        """virtualMass massAdd: m·(ρc/ρp)·Cvm (VirtualMassForce.C:massAdd)."""
        if not self.virtual_mass:
            return torch.zeros_like(mass)
        return mass * (rho_c / rho_p) * self.Cvm

    # ------------------------------------------------------------------
    def has_body_forces(self) -> bool:
        return self.srf is not None or self.nif is not None or (
            self.para is not None
        )

    def body_su(self, x, U, mass, rho_c, rho_p, hdgh=None):
        """Explicit frame/magnetic body forces Su [N] summed over models.

        SRF (SRFForce.C:calcNonCoupled): Coriolis + centrifugal,
            Su = m·(1 − ρc/ρp)·(2·(U×ω) + ω×(r×ω)),  r = x − origin.
        nonInertialFrame (NonInertialFrameForce.C:calcNonCoupled):
            Su = m·(−W + r×ω̇ + 2·(U×ω) + ω×(r×ω)),  r = x − CofR.
        paramagnetic (ParamagneticForce.C:calcNonCoupled):
            Su = m·3·μ0/ρp·χ/(χ+3)·(H·∇H)  at the parcel cell."""
        su = torch.zeros_like(U)
        vec = lambda v: torch.as_tensor(np.asarray(v, np.float64), dtype=U.dtype, device=U.device)

        def cross(a, b):
            a, b = torch.broadcast_tensors(a, b)
            return torch.linalg.cross(a, b, dim=-1)
        if self.srf is not None:
            w = vec(self.srf["omega"])
            r = x - vec(self.srf["origin"])[None, :]
            acc = 2.0 * cross(U, w[None, :]) + cross(
                w.expand(U.shape), cross(r, w[None, :])
            )
            su = su + (mass * (1.0 - rho_c / rho_p))[:, None] * acc
        if self.nif is not None:
            w = vec(self.nif["omega"])
            wd = vec(self.nif["omegaDot"])
            W = vec(self.nif["W"])
            r = x - vec(self.nif["CofR"])[None, :]
            acc = (
                -W[None, :]
                + cross(r, wd[None, :])
                + 2.0 * cross(U, w[None, :])
                + cross(w.expand(U.shape), cross(r, w[None, :]))
            )
            su = su + mass[:, None] * acc
        if self.para is not None and hdgh is not None:
            chi = self.para["chi"]
            mu0 = 4.0e-7 * np.pi
            su = su + (
                mass * 3.0 * mu0 / rho_p * chi / (chi + 3.0)
            )[:, None] * hdgh
        return su
