"""fvDOM discrete-ordinates radiation, batched-ray formulation.

The reference fvDOM stack (fvDOM.C:549-586 calculate,
radiativeIntensityRay.C:267-322 per-ray per-band RTE, radiationModel.C:
209-244 correct/Sh) as ONE batched solve over the flattened (ray ×
wavelength-band) axis: every (ray, band) pair is one row of the whole-solve
BiCGStab (solvers/linear.py `solve_ldu`: K1 on a DIA mesh on CUDA, the
twin on SEG) with its own upwind matrix.

Ray discretisation (θ ∈ nTheta bands of π (z polar), φ ∈ 4·nPhi sectors):
  ω_r   = (cosθ₁ − cosθ₂)·Δφ
  dAve_r = ∫∫ d̂ sinθ dθ dφ  (analytic, used for the convective flux d·Sf)

Per-ray per-band RTE (radiativeIntensityRay.C:289-306):
  div(I·dAve) + (k_λ + σ_eff)·ω·I =
      ω/π·(k_λ·σT⁴·enFrac_λ + E_λ/4) + ω·σs·G_λ/4π
with enFrac_λ the banded blackbody energy fraction (fvDOM.C:553
correctEnFrac) and banded diffusive walls: incoming rays get
I = (ε·enFrac_λ(T_w)·σT_w⁴ + (1−absorptivity)·qin_λ)/π, outgoing rays are
upwind-transparent. Scatter: constantScatter extinction σs·(3−C) with
isotropic in-scatter σs·G_λ/4π.

Each ray's upwind convection depends on the mesh only: it is assembled once
(diagonal, off-diagonals and the boundary's diagonal part), and a solve adds
each band's (k_λ + σ_eff)·ω·V to the diagonal as one batched operation.

Energy coupling: Sh = Σ_λ a_λ·G_λ − 4σT³·Σ_λ(a_λ·enFrac_λ)·T − E, with E
re-evaluated every step from the current Qdot and the absorbed terms stale
between solverFreq ray solves. A solve sweeps the rays up to maxIter times
while the largest initial residual is above `convergence`.

Spray (state["cloud_rad"], the cloud's per-band accumulators): the
spray's absorption aDisp joins the extinction, its emission Ep/4 the
source (radiativeIntensityRay.C:296-303), its scattering sigmap the
extinction and an anisotropic in-scatter with the asymmetry factor g
clipped to ±0.999 (ThermoCloud::setCScatCoeffs); a cloud with another
band count than nLambda is lumped to grey and split equally.

Walls coupled to a solid region (emissivityMode/absorptivityMode
solidRadiation, solidThermo, pyrolysisModel) take the solid's surface
emissivity at each solve, through `solid_eps_fn` (set by the solver).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..config import small
from ..io import Case
from ..io.foamdict import FoamDict
from ..ops.geometry import MeshGeometry
from ..solvers.linear import failed_rows, solve_ldu

__all__ = ["FvDOM", "SIGMA", "parse_grey_species", "read_ft_table", "grey_absorption"]

SIGMA = 5.670367e-8  # Stefan–Boltzmann (OpenFOAM physicoChemical::sigma)

# absorptionEmissionModel names that carry an nLambda band axis
_BAND_MODELS = {
    "wideBandAbsorptionEmission",
    "wsggmAbsorptionEmissionSmithBand",
    "wsggmAbsorptionEmissionCassolBand",
    "wsggmAbsorptionEmissionJohanssonBand",
    "constRadFracWideBandEmission",
}
_GREY_MEAN = ("greyMeanAbsorptionEmission", "greyMeanAbsorptionEmissionSoot")
_SOLID_MODES = ("solidRadiation", "solidThermo", "pyrolysisModel")


def _ray_geometry(n_theta: int, n_phi: int):
    """(dAve [nRay, 3], ω [nRay], unit bin-centre directions [nRay, 3]) for
    4·nPhi·nTheta ordinates, float64 numpy. nTheta < 1 falls back to the
    reference's 2-D mode (a single polar band of π)."""
    n_theta = max(int(n_theta), 1)
    n_phi = max(int(n_phi), 1)
    d_theta = np.pi / n_theta
    n_phi_tot = 4 * n_phi
    d_phi = 2.0 * np.pi / n_phi_tot
    omegas, d_aves, dirs = [], [], []
    for i in range(n_theta):
        t1, t2 = i * d_theta, (i + 1) * d_theta
        tm = 0.5 * (t1 + t2)
        for j in range(n_phi_tot):
            p1, p2 = j * d_phi, (j + 1) * d_phi
            pm = 0.5 * (p1 + p2)
            omega = (np.cos(t1) - np.cos(t2)) * d_phi
            st = 0.5 * (t2 - t1) - 0.25 * (np.sin(2 * t2) - np.sin(2 * t1))
            dx = st * (np.sin(p2) - np.sin(p1))
            dy = st * (np.cos(p1) - np.cos(p2))
            dz = 0.5 * (np.sin(t2) ** 2 - np.sin(t1) ** 2) * d_phi
            omegas.append(omega)
            d_aves.append([dx, dy, dz])
            dirs.append([np.sin(tm) * np.cos(pm), np.sin(tm) * np.sin(pm), np.cos(tm)])
    return np.asarray(d_aves), np.asarray(omegas), np.asarray(dirs)


def parse_grey_species(aec: FoamDict) -> tuple:
    """Per-species polynomial data of greyMeanAbsorptionEmission
    (greyMeanAbsorptionEmission.C: lo/hi T-polynomial absorption
    coefficients, optionally in 1/T, weighted by partial pressure [atm])."""
    gs = []
    for name, sd in aec.subdicts():
        if not sd.found("hiTcoeffs"):
            continue
        gs.append((
            name,
            sd.get_scalar("Tcommon", 300.0),
            sd.get_bool("invTemp", True),
            tuple(float(x) for x in sd.get_list("loTcoeffs")),
            tuple(float(x) for x in sd.get_list("hiTcoeffs")),
            sd.get_scalar("Tlow", 200.0),
            sd.get_scalar("Thigh", 2500.0),
        ))
    return tuple(gs)


def read_ft_table(case, fname):
    """constant/<fname> interpolationLookUpTable over mixture fraction ft
    (greyMeanAbsorptionEmission.C ctor 'lookUpTableFileName'): one input
    field block (ft, min/max/N) + output species columns. Returns
    (ft_grid [N+1], {species: mole-fraction column}) or None."""
    try:
        d = case.constant(str(fname).strip('"'))
    except (FileNotFoundError, AttributeError, TypeError, KeyError):
        return None
    try:
        out_entries = d.lookup("output")[1]
        names = [str(x.lookup("name")) for x in out_entries if hasattr(x, "lookup")]
        raw = d.lookup("values")[1]  # counted lists: [n0, col0, n1, col1, ...]
        cols = []
        for cnt, payload in zip(raw[0::2], raw[1::2]):
            arr = np.asarray([float(x) for x in payload], float)
            if arr.size == 1 and int(cnt) > 1:
                arr = np.full(int(cnt), arr[0])  # uniform shorthand 'n{v}'
            cols.append(arr)
    except (TypeError, IndexError, AttributeError, ValueError):
        return None
    if not cols or len(cols) != len(names) + 1:
        return None
    return cols[0], dict(zip(names, cols[1:]))


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation of (xp, fp) at x with constant
    extrapolation (numpy.interp's rule; torch has no interp)."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    flat = torch.abs(dx) <= float(np.spacing(torch.finfo(xp.dtype).eps))
    f = torch.where(flat, f0, f0 + ((x - x0) / torch.where(flat, torch.ones_like(dx), dx)) * (f1 - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def grey_absorption(grey_species, a_const, ae_model, geom, state, gas, ft_table=None,
                    reaction=None):
    """Grey absorption coefficient a [1/m] on (cells, boundary faces).

    Species carried by the gas mixture use the transported mass fraction;
    species only present in the ft lookup table (e.g. CO, soot) take their
    mole fraction from a linear interpolation over the local mixture
    fraction on the table's grid (greyMeanAbsorptionEmission(Soot).C::aCont
    floors the table index; the JAX package interpolates, and so does this
    port)."""
    kw = dict(dtype=geom.dtype, device=geom.device)
    if ae_model not in _GREY_MEAN or not grey_species:
        return (torch.full((geom.n_cells,), a_const, **kw),
                torch.full((geom.n_boundary,), a_const, **kw))

    # mixture fraction for table species (createFields.H ft definition)
    use_table = ft_table is not None and reaction is not None and any(
        g[0] not in gas.species and g[0] in ft_table[1] for g in grey_species)

    def ft_of(Y):
        YO2Inf = 0.23301
        s = float(reaction.s)
        fu = Y[:, reaction.fuel_index]
        o2 = Y[:, gas.index("O2")] if "O2" in gas.species else 0.0
        return torch.clamp((fu * s - o2 + YO2Inf) / (s + YO2Inf), 0.0, 1.0)

    def a_of(T, Y, p):
        W_mix = 8314.47 / gas.R(Y)
        p_atm = p / 101325.0
        ft = ft_of(Y) if use_table else None
        a = torch.zeros_like(T)
        for name, tc, inv, lo, hi, tlow, thigh in grey_species:
            if name in gas.species:
                si = gas.index(name)
                Xi = Y[:, si] * W_mix / gas.W[si]
            elif use_table and name in ft_table[1]:
                Xi = interp(ft, torch.as_tensor(ft_table[0], dtype=T.dtype, device=T.device),
                            torch.as_tensor(ft_table[1][name], dtype=T.dtype, device=T.device))
            else:
                continue
            Tc = torch.clamp(T, tlow, thigh)
            Tx = 1.0 / Tc if inv else Tc

            def poly(coeffs):
                out = torch.zeros_like(Tx)
                for k, c in enumerate(coeffs):
                    out = out + c * Tx**k
                return out

            ai = torch.where(T < tc, poly(lo), poly(hi))
            a = a + ai * Xi * p_atm
        return torch.clamp(a, min=0.0)

    return (a_of(state["T"].i, state["Y"].i, state["p"].i),
            a_of(state["T"].b, state["Y"].b, state["p"].b))


def _scalar_entry(d: FoamDict, key: str, default: float) -> float:
    """A plain or dimensioned scalar entry (the value is the last token)."""
    v = d.lookup(key, default)
    return float(v[-1] if isinstance(v, list) else v)


class RadiantFractionGate:
    """What fvDOM and P1 share: the radScaling radiant fraction and the
    radiationModel::correct gating (the first call, then every solverFreq
    time steps; time index = count of completed radiation opportunities)."""

    def _chi(self, state) -> torch.Tensor:
        """constRadFractionEmission radScaling: mass-loss-rate-weighted blend
        of Ehrr1/Ehrr2 floored at min(Ehrr1,Ehrr2)."""
        g = self.geom
        if not self.rad_scaling:
            return torch.full((), self.ehrr, dtype=g.dtype, device=g.device)
        phi_b = state["phi"].b

        def mlr(names):
            tot = torch.zeros((), dtype=phi_b.dtype, device=phi_b.device)
            for p in g.patches:
                if p.name in names:
                    tot = tot - g.bsum(phi_b, p.slice)
            return tot

        m1, m2 = mlr(self.patch1), mlr(self.patch2)
        chi = (m1 * self.ehrr1 + m2 * self.ehrr2) / torch.clamp(m1 + m2, min=1e-15)
        return torch.clamp(chi, min=min(self.ehrr1, self.ehrr2))

    def _due(self, rad) -> bool:
        """Whether this step solves (one host read of the step counter)."""
        count = int(rad["count"])
        return count == 0 or (self.solver_freq > 0 and count % self.solver_freq == 0)

    @staticmethod
    def _skip(rad) -> Dict:
        out = dict(rad)
        out["count"] = rad["count"] + 1
        return out


@dataclass
class FvDOM(RadiantFractionGate):
    geom: MeshGeometry
    n_theta: int
    n_phi: int
    convergence: float
    max_iter: int
    solver_freq: int
    a_const: float  # grey absorption coefficient (constRadFraction: 0)
    ehrr: float
    ehrr1: float
    ehrr2: float
    rad_scaling: bool
    patch1: tuple
    patch2: tuple
    emissivity: torch.Tensor  # [nB]
    ae_model: str
    grey_species: tuple  # greyMean per-species polynomial data
    d_ave: torch.Tensor  # [nRay, 3]
    omega: torch.Tensor  # [nRay]
    phi_ray: torch.Tensor  # [nRay, nI] = dAve·Sf
    phi_ray_b: torch.Tensor  # [nRay, nB]
    d_hat: torch.Tensor  # [nRay, 3] unit bin-centre directions
    tol: float = 1e-4
    wsggm: object = None  # WSGGMGreySmith / GreyCassol when selected
    sigma_s: float = 0.0  # constantScatter coefficient [1/m]
    scatter_C: float = 0.0  # constantScatter linear-anisotropy coefficient
    spectral: object = None  # band model (spectral.py) when selected
    spsoot: object = None  # SpSootRadFrac flamelet table when selected
    ft_table: object = None  # (ft_grid, {species: X column}) greyMean lookup
    reaction: object = None  # set by the solver (ft table, spSoot)
    epsilon_fn: object = None  # set by the solver: state → SGS dissipation
    n_lambda: int = 1
    # the wall ABSORPTIVITY, used for the reflection (1−absorptivity)·qin
    # while the wall emits ε·σT⁴ (radiationCoupledBaseFF absorptivityMode,
    # greyDiffusiveRadiationFF...C:199-210); equal to ε by default
    absorptivity: Optional[torch.Tensor] = None  # [nB]
    # emissivityMode/absorptivityMode solidRadiation, solidThermo or
    # pyrolysisModel: the wall ε/absorptivity of these faces (numpy bool
    # masks) is the coupled solid's, from solid_eps_fn (state → ε [nB],
    # set by the solver) at each solve
    solid_eps_mask: object = None
    solid_abs_mask: object = None
    solid_eps_fn: object = None
    _solid_masks: object = field(default=None, repr=False)
    # ray sweeps run since construction (each one K1 launch on a DIA mesh
    # on the card):
    # host-side bookkeeping, not part of the state
    sweeps: int = 0
    last_iters: Optional[torch.Tensor] = None  # [nR·nL] iterations of the last sweep
    # (ray × band) rows whose step was not finite in this step's sweeps (they
    # keep their intensity; ROADMAP R18), a device int; the step logs it
    failed_rows: Optional[torch.Tensor] = None
    _rays: Optional[dict] = field(default=None, repr=False)

    # ------------------------------------------------------------ factory
    @classmethod
    def try_from_case(cls, case_dir: str, geom: Optional[MeshGeometry] = None):
        case = Case(case_dir)
        if not case.has_constant("radiationProperties"):
            return None
        rp = case.constant("radiationProperties")
        if not rp.get_bool("radiation", False):
            return None
        if str(rp.lookup("radiationModel", "none")) != "fvDOM":
            return None
        if geom is None:
            return _DeferredFvDOM(case_dir)
        return cls.from_case_dict(rp, geom, case)

    @classmethod
    def from_case_dict(cls, rp: FoamDict, geom: MeshGeometry, case: Case) -> "FvDOM":
        c = rp.get_dict("fvDOMCoeffs")
        aem = str(rp.lookup("absorptionEmissionModel", "constRadFractionEmission"))
        aec = rp.get_dict(aem + "Coeffs", FoamDict())
        kw = dict(dtype=geom.dtype, device=geom.device)
        n_theta = c.get_int("nTheta", 4)
        n_phi = c.get_int("nPhi", 2)
        d_ave, omega, d_hat = _ray_geometry(n_theta, n_phi)
        d_ave_t = torch.as_tensor(d_ave, **kw)
        # constRadFractionEmission: a = 0, e = 0 (transparent gas, pure
        # radiant-fraction emission); constantAbsorptionEmission: a from
        # its coeffs dict
        if aem == "constantAbsorptionEmission":
            a_const = rp.get_dict("constantAbsorptionEmissionCoeffs", FoamDict()).get_scalar("a", 0.01)
        else:
            a_const = 0.0
        grey_species = ()
        ft_table = None
        if aem in _GREY_MEAN:
            grey_species = parse_grey_species(aec)
            tname = aec.lookup("lookUpTableFileName", "none")
            if str(tname).strip('"') not in ("none", ""):
                ft_table = read_ft_table(case, tname)
        wsggm = None
        if aem.startswith("wsggm") or aem == "spSootRadFracEmission":
            raise NotImplementedError(f"the benchmark's reference has no {aem}")
        spectral = None
        if aem in _BAND_MODELS or aem == "binaryAbsorptionEmission":
            spectral = _build_spectral(aem, aec, rp)
        spsoot = None
        emissivity, absorptivity, solid_eps_mask, solid_abs_mask = _read_wall_radprops(case, geom)
        sigma_s = scatter_C = 0.0
        if str(rp.lookup("scatterModel", "none")) == "constantScatter":
            sc = rp.get_dict("constantScatterCoeffs", FoamDict())
            sigma_s = _scalar_entry(sc, "sigma", 0.0)
            scatter_C = _scalar_entry(sc, "C", 0.0)
        return cls(
            geom=geom,
            n_theta=n_theta,
            n_phi=n_phi,
            convergence=c.get_scalar("convergence", 0.0),
            max_iter=c.get_int("maxIter", 1),
            solver_freq=rp.get_int("solverFreq", 1),
            a_const=a_const,
            ehrr=aec.get_scalar("EhrrCoeff", 0.2),
            ehrr1=aec.get_scalar("Ehrr1", 0.2),
            ehrr2=aec.get_scalar("Ehrr2", 0.2),
            rad_scaling=aec.get_bool("radScaling", False),
            patch1=tuple(str(x) for x in _aslist(aec.lookup("patch1", []))),
            patch2=tuple(str(x) for x in _aslist(aec.lookup("patch2", []))),
            ae_model=aem,
            grey_species=grey_species,
            emissivity=emissivity,
            absorptivity=absorptivity,
            solid_eps_mask=solid_eps_mask,
            solid_abs_mask=solid_abs_mask,
            wsggm=wsggm,
            sigma_s=sigma_s,
            scatter_C=scatter_C,
            spectral=spectral,
            spsoot=spsoot,
            ft_table=ft_table,
            n_lambda=spectral.n_lambda if spectral is not None else 1,
            d_ave=d_ave_t,
            omega=torch.as_tensor(omega, **kw),
            d_hat=torch.as_tensor(d_hat, **kw),
            phi_ray=torch.einsum("rd,fd->rf", d_ave_t, geom.Sf),
            phi_ray_b=torch.einsum("rd,fd->rf", d_ave_t, geom.b_Sf),
        )

    @property
    def n_rays(self) -> int:
        return self.d_ave.shape[0]

    # ----------------------------------------------------------- state
    def initial_state(self) -> Dict:
        g = self.geom
        kw = dict(dtype=g.dtype, device=g.device)
        return {
            "I": torch.zeros((self.n_rays, self.n_lambda, g.n_cells), **kw),
            "G": torch.zeros((g.n_cells,), **kw),
            "E": torch.zeros((g.n_cells,), **kw),
            "a": torch.full((g.n_cells,), self.a_const, **kw),
            # stale Sh ingredients: Σ_λ a_λ·G_λ and Σ_λ a_λ·enFrac_λ
            "aG": torch.zeros((g.n_cells,), **kw),
            "aEn": torch.full((g.n_cells,), self.a_const, **kw),
            "count": torch.zeros((), dtype=torch.int32, device=g.device),
            "chi": torch.full((), self.ehrr, **kw),
        }

    # ------------------------------------------------------- absorption
    def absorption(self, state, gas):
        """Grey absorption coefficient a [1/m] on cells and boundary."""
        if self.wsggm is not None:
            return (self.wsggm.a(state["T"].i, state["Y"].i, state["p"].i, gas),
                    self.wsggm.a(state["T"].b, state["Y"].b, state["p"].b, gas))
        return grey_absorption(self.grey_species, self.a_const, self.ae_model, self.geom,
                               state, gas, ft_table=self.ft_table, reaction=self.reaction)

    def _chi_field(self, state, gas):
        """Radiant fraction: scalar for constRadFraction, per cell for
        localFuelRadFractionEmission (the EDM's localRadFrac) and
        spSootRadFracEmission (the flamelet PsiR table)."""
        if self.ae_model == "localFuelRadFractionEmission":
            lrf = state.get("localRadFrac")
            if lrf is not None:
                return lrf
        if (self.ae_model == "spSootRadFracEmission" and self.spsoot is not None
                and self.reaction is not None and self.epsilon_fn is not None):
            return self.spsoot.psi_r(state, gas, self.reaction, self.epsilon_fn(state))
        return self._chi(state)

    def spectral_eval(self, state, gas) -> Dict:
        """Banded absorption/emission/energy-fraction arrays [nL, ...]."""
        T = state["T"]
        chi = self._chi_field(state, gas)
        if self.spectral is not None:
            Y, p = state.get("Y"), state.get("p")
            return dict(
                self.spectral.eval(T.i, T.b, None if Y is None else Y.i,
                                   None if Y is None else Y.b, None if p is None else p.i,
                                   None if p is None else p.b, gas, state["Qdot"], chi),
                chi=chi,
            )
        a, a_b = self.absorption(state, gas)
        return {
            "a": a[None],
            "a_b": a_b[None],
            "E": (chi * state["Qdot"])[None],
            "enFrac": torch.ones_like(T.i)[None],
            "enFrac_b": torch.ones_like(T.b)[None],
            "chi": chi if chi.ndim == 0 else self.geom.rmean(chi),
        }

    # ------------------------------------------------------------ solve
    def _cloud_terms(self, state):
        """Spray radiation fields from the cloud accumulators, per band:
        aDisp (ThermoCloud::ap), sigmap, Ep (ThermoCloudI.H:377-492) and the
        scatter asymmetry factor g = radAreaPScAsy/radAreaPSc. None when no
        cloud radiation state is present."""
        cr = state.get("cloud_rad")
        if cr is None:
            return None
        # stored per band already divided by V and flow dt
        ap, sigmap, asy, Ep = cr["ap"], cr["sigmap"], cr["asy"], cr["Ep"]
        if ap.shape[0] != self.n_lambda:
            # cloud nBands ≠ fvDOM nLambda: lump to grey, split equally
            # (the reference's getQAbsQSct nBands==1 beam-length lumping)
            nL = self.n_lambda
            ap = torch.mean(ap, dim=0)[None].repeat(nL, 1)
            sigmap = torch.mean(sigmap, dim=0)[None].repeat(nL, 1)
            asy = torch.mean(asy, dim=0)[None].repeat(nL, 1)
            Ep = (torch.sum(Ep, dim=0)[None] / nL).repeat(nL, 1)
        g = asy / torch.clamp(sigmap, min=small(sigmap.dtype))
        # static anisotropic-scatter geometry (ThermoCloud::setCScatCoeffs):
        # Σ_{r≠s} (ŝ_r·ŝ_s)^k ω_r I_r as one [nR, nR] weight per power k
        s_dot = self.d_hat @ self.d_hat.T  # [nR, nR]
        nR = s_dot.shape[0]
        off = 1.0 - torch.eye(nR, dtype=s_dot.dtype, device=s_dot.device)
        c_geo = [torch.sum(self.omega[1:] * s_dot[0, 1:] ** k) / (4.0 * np.pi - self.omega[0])
                 for k in range(1, 5)]
        gf = torch.clamp(g, -0.999, 0.999)  # [nL, nC]
        A = 2.0 * gf / (1.0 + gf * gf)
        B = (1.0 - gf * gf) / (1.0 + gf * gf)
        cscat = 1.0 / (
            B * (1.0 + A * c_geo[0] + A**2 * c_geo[1] + A**3 * c_geo[2] + A**4 * c_geo[3])
            + small(B.dtype)
        )
        return {
            "ap": ap,
            "sigmap": sigmap,
            "Ep": Ep,
            "A": A,
            # the in-scatter's factor σp·cscat·B, and the ray weights
            "scat_coef": sigmap * cscat * B,
            "W": [off * s_dot**k for k in range(5)],
        }

    def _spray_scatter(self, I, cloud):
        """The spray's anisotropic in-scatter [nR, nL, nC]:
        σp·cscat·B·Σ_k A^k·Σ_{r≠s}(ŝ_r·ŝ_s)^k ω_r I_r / (4π − ω_s)."""
        Iw = I * self.omega[:, None, None]
        A = cloud["A"]
        poly = torch.einsum("rs,rlc->slc", cloud["W"][0], Iw)
        for k in range(1, 5):
            poly = poly + (A[None] ** k) * torch.einsum("rs,rlc->slc", cloud["W"][k], Iw)
        return (cloud["scat_coef"][None] * poly) / (4.0 * np.pi - self.omega[:, None, None])

    def _ray_operators(self):
        """The rays' upwind convection, which depends on the mesh only:
        per ray the diagonal, the boundary faces' diagonal part summed into
        their cells, the faces where the ray enters, and the off-diagonals
        repeated once per band (one row per (ray, band) pair)."""
        if self._rays is None:
            g = self.geom
            nL = self.n_lambda
            phi, phi_b = self.phi_ray, self.phi_ray_b  # [nR, nI], [nR, nB]
            w_up = (phi >= 0.0).to(phi.dtype)
            lower = -w_up * phi
            upper = lower + phi
            diag = -g.face_to_both_sum(lower.T, upper.T).T  # [nR, nC]
            # incoming rays see the wall value: valueFraction 1 where phi_b < 0
            f = (phi_b < 0.0).to(phi.dtype)
            ic = phi_b * (1.0 - f)
            self._rays = {
                "diag": diag.contiguous(),
                "bdiag": g.boundary_to_cell_sum(ic.T).T.contiguous(),
                "f": f,
                "w_in": torch.clamp(-phi_b, min=0.0) / g.b_magSf,
                "upper": upper.repeat_interleave(nL, dim=0).contiguous(),
                "lower": lower.repeat_interleave(nL, dim=0).contiguous(),
            }
        return self._rays

    def _sweep(self, I, k_tot, sig_eff, src_emit, emis, absorp, enf_b, sigT4_w, cloud=None):
        """One sweep of every (ray × band) intensity as ONE batched solve.
        Returns (I_new [nR, nL, nC], the largest initial residual)."""
        g = self.geom
        nR, nL, nC = I.shape
        ops = self._ray_operators()
        # incident flux per band per boundary face for the wall reflection,
        # which goes through the wall ABSORPTIVITY
        qin = torch.einsum("rlb,rb->lb", I.index_select(2, g.b_own), ops["w_in"])
        I_wall = (emis[None] * enf_b * sigT4_w[None] + (1.0 - absorp[None]) * qin) / np.pi
        scat = 0.0
        if self.sigma_s != 0.0:
            G_band = torch.einsum("rlc,r->lc", I, self.omega)
            scat = (self.sigma_s / (4.0 * np.pi)) * G_band
        if cloud is not None:
            scat = scat + self._spray_scatter(I, cloud)
        om = self.omega[:, None, None]
        # each band's implicit extinction (k_λ + σ_eff)·ω·V on the ray's
        # upwind diagonal, and both sources with the ray's ω
        diag = (ops["diag"][:, None] + ((k_tot + sig_eff)[None] * om) * g.V) + ops["bdiag"][:, None]
        bc = -self.phi_ray_b[:, None] * (ops["f"][:, None] * I_wall[None])  # [nR, nL, nB]
        rhs = g.V * (om * (src_emit[None] + scat)) + g.boundary_to_cell_sum(
            bc.reshape(nR * nL, -1).T).T.reshape(nR, nL, nC)
        res = solve_ldu(
            g, "PBiCGStab", diag.reshape(nR * nL, nC).contiguous(), ops["upper"], ops["lower"],
            rhs.reshape(nR * nL, nC).contiguous(), I.reshape(nR * nL, nC).contiguous(),
            tol=self.tol, rel_tol=0.0, max_iter=500,
        )
        self.sweeps += 1
        self.last_iters = res.n_iterations
        n_failed = failed_rows(res, self.tol).sum(dtype=torch.int32)
        self.failed_rows = n_failed if self.failed_rows is None else self.failed_rows + n_failed
        return torch.clamp(res.x, min=0.0).reshape(nR, nL, nC), torch.max(res.initial_residual)

    def _solve_rays(self, rad, state, gas):
        """One fvDOM calculate(): sweep all (ray × band) intensities up to
        maxIter times until the largest initial residual drops below
        `convergence`, re-evaluating the wall reflection and the in-scatter
        each sweep (fvDOM.C:549-586 do-while over radIter). With maxIter > 1
        the loop's exit reads that residual on the host once per sweep."""
        T = state["T"]
        sp = self.spectral_eval(state, gas)
        chi = sp["chi"]
        a_gas = sp["a"]  # [nL, nC]
        E_band = sp["E"]
        enf, enf_b = sp["enFrac"], sp["enFrac_b"]
        cloud = self._cloud_terms(state)
        emis = self.emissivity
        absorp = self.absorptivity if self.absorptivity is not None else emis
        if self.solid_eps_fn is not None:
            eps_dyn = self.solid_eps_fn(state)
            if self._solid_masks is None:  # device copies, made once
                self._solid_masks = tuple(torch.as_tensor(m, device=eps_dyn.device)
                                          for m in (self.solid_eps_mask, self.solid_abs_mask))
            if self.solid_eps_mask.any():
                emis = torch.where(self._solid_masks[0], eps_dyn, emis)
            if self.solid_abs_mask.any():
                absorp = torch.where(self._solid_masks[1], eps_dyn, absorp)
        sigT4_w = SIGMA * T.b**4
        # constantScatter: the extinction uses sigmaEff = σs·(3−C)
        sig_eff = self.sigma_s * (3.0 - self.scatter_C)
        if cloud is None:
            k_tot = a_gas
            # per-band emission source (per ω, per π): k·σT⁴·enFrac + E/4
            src_emit = (a_gas * SIGMA * T.i**4 * enf + 0.25 * E_band) / np.pi  # [nL, nC]
        else:
            # absorptionEmissionModel::a = aCont + aDisp; the source is
            # (k − aDisp)·σT⁴·enFrac + E/4 + Ep/4 (radiativeIntensityRay.C:
            # 296-303); the spray's sigmap joins the extinction
            k_tot = a_gas + cloud["ap"]
            src_emit = (a_gas * SIGMA * T.i**4 * enf + 0.25 * (E_band + cloud["Ep"])) / np.pi
            sig_eff = sig_eff + cloud["sigmap"]
        args = (k_tot, sig_eff, src_emit, emis, absorp, enf_b, sigT4_w, cloud)
        I, res = self._sweep(rad["I"], *args)
        it = 1
        while it < self.max_iter and float(res) > self.convergence:
            I, res = self._sweep(I, *args)
            it += 1
        G_band = torch.einsum("rlc,r->lc", I, self.omega)
        aEn = torch.sum(a_gas * enf, dim=0)
        return {
            "I": I,
            "G": torch.sum(G_band, dim=0),
            "E": torch.sum(E_band, dim=0),
            "a": aEn,
            "aG": torch.sum(a_gas * G_band, dim=0),
            "aEn": aEn,
            "count": rad["count"] + 1,
            "chi": chi if chi.ndim == 0 else self.geom.rmean(chi),
        }

    def maybe_correct(self, state, gas) -> Dict:
        rad = state["rad"]
        self.failed_rows = torch.zeros((), dtype=torch.int32, device=rad["I"].device)
        return self._solve_rays(rad, state, gas) if self._due(rad) else self._skip(rad)

    # ------------------------------------------------------- energy source
    def Sh(self, state, gas) -> torch.Tensor:
        """Net radiative source to sensible enthalpy [W/m³]: the emission
        E = χ·Qdot·(static band factor) is fresh every step, the absorbed
        terms Σ a_λ·G_λ and Σ a_λ·enFrac_λ stale between solverFreq ray
        solves (fvDOM.C:588-649)."""
        E = self._chi_field(state, gas) * state["Qdot"] * self._e_qdot_coeff()
        rad = state["rad"]
        return rad["aG"] - 4.0 * SIGMA * state["T"].i ** 4 * rad["aEn"] - E

    def _e_qdot_coeff(self) -> float:
        """Static Σ_λ(E_λ)/(χ·Qdot): 1 for grey, Σ f_b for
        constRadFracWideBand, Σ(Ehrr_b·Δλ_b)/Σλ / χ for wideBand (per-band
        EhrrCoeff replaces the global one there), 0 otherwise (WSGG band
        models prescribe no emission)."""
        from .spectral import ConstRadFracWideBandAE, WideBandAE

        spc = self.spectral
        if spc is None:
            return 1.0
        if isinstance(spc, ConstRadFracWideBandAE):
            return float(sum(spc.en_fracs))
        if isinstance(spc, WideBandAE):
            total = sum(hi - lo for lo, hi in spc.bands)
            return float(sum(e * (hi - lo) for e, (lo, hi) in zip(spc.ehrr, spc.bands))
                         / total / max(self.ehrr, small(self.geom.dtype)))
        return 0.0

    # ------------------------------------------------------- diagnostics
    def qr_boundary(self, rad) -> torch.Tensor:
        """Net radiative heat flux at boundary faces [W/m²] (into the wall +)."""
        g = self.geom
        return torch.einsum("rlb,rb->b", rad["I"].index_select(2, g.b_own),
                            self.phi_ray_b) / g.b_magSf

    def qin_boundary(self, rad) -> torch.Tensor:
        """Incident radiative flux at boundary faces [W/m²] (fvDOM qin, read
        by the pyrolysis conjugate BC)."""
        g = self.geom
        return torch.einsum("rlb,rb->b", rad["I"].index_select(2, g.b_own),
                            torch.clamp(-self.phi_ray_b, min=0.0) / g.b_magSf)

    def G_bands(self, rad) -> torch.Tensor:
        """Per-band incident radiation [nL, nCells] (fvDOM GLambda, read by
        the parcels' radiative heating)."""
        return torch.einsum("rlc,r->lc", rad["I"], self.omega)


def _build_spectral(aem: str, aec: FoamDict, rp: FoamDict):
    """The banded spectral model (spectral.py) of `aem`."""
    from .spectral import BinaryAE, ConstRadFracWideBandAE, WideBandAE, WSGGBandAE

    if aem == "wideBandAbsorptionEmission":
        return WideBandAE.from_coeffs(aec)
    if aem == "constRadFracWideBandEmission":
        return ConstRadFracWideBandAE.from_coeffs(aec)
    if aem == "wsggmAbsorptionEmissionSmithBand":
        return WSGGBandAE.from_coeffs(aec, "smith")
    if aem == "wsggmAbsorptionEmissionCassolBand":
        return WSGGBandAE.from_coeffs(aec, "cassol")
    if aem == "wsggmAbsorptionEmissionJohanssonBand":
        return WSGGBandAE.from_coeffs(aec, "johansson")
    if aem == "binaryAbsorptionEmission":
        subs = []
        for m in (str(aec.lookup("model1", "none")), str(aec.lookup("model2", "none"))):
            # cloudAbsorptionEmission enters through the cloud's radiation
            # state (state["cloud_rad"]), not the gas spectral model
            if m in ("none", "cloudAbsorptionEmission"):
                continue
            subs.append(_build_spectral(m, aec.get_dict(m + "Coeffs", FoamDict()), rp))
        if len(subs) == 2:
            return BinaryAE(subs[0], subs[1])
        if len(subs) == 1:
            return subs[0]
        return None
    raise ValueError(f"unsupported spectral absorptionEmissionModel {aem}")


def _aslist(v):
    return v if isinstance(v, list) else [v]


def _uniform_scalar(bd, key):
    v = bd.lookup(key, None)
    if v is None:
        return None
    if isinstance(v, list):  # 'uniform 1.0' tokenises as [String, value]
        v = v[-1]
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _read_wall_radprops(case, geom: MeshGeometry):
    """Per-boundary-face wall emissivity and absorptivity from 0/IDefault
    greyDiffusiveRadiation(FF/Fire) / wideBandDiffusiveRadiation(FF)
    patches (radiationCoupledBase + radiationCoupledBaseFF.H:62-75):
      emissivityMode   lookup              → 'emissivity uniform X'
                       solidRadiation / solidThermo / pyrolysisModel
                                           → ε of the coupled solid region,
                                             each step (mask)
      absorptivityMode emissivity (default) → absorptivity = emissivity
                                             (its solid mask too)
                       lookup              → 'absorptivity uniform X'
                       a solid mode        → the solid's ε (mask)
    Unspecified patches are black (ε = absorptivity = 1). Returns
    (emissivity [nB], absorptivity [nB], solid_eps_mask [nB],
    solid_abs_mask [nB]); the masks are numpy bool."""
    em = np.ones(geom.n_boundary)
    ab = np.ones(geom.n_boundary)
    m_e = np.zeros(geom.n_boundary, bool)
    m_a = np.zeros(geom.n_boundary, bool)
    kw = dict(dtype=geom.dtype, device=geom.device)
    try:
        ff = case.field("IDefault")
    except (FileNotFoundError, AttributeError, TypeError):
        return torch.as_tensor(em, **kw), torch.as_tensor(ab, **kw), m_e, m_a
    for p in geom.patches:
        bd = ff.boundary.get_dict(p.name, None)
        if bd is None:
            continue
        emode = str(bd.lookup("emissivityMode", "lookup"))
        if emode in _SOLID_MODES:
            m_e[p.slice] = True
        else:
            v = _uniform_scalar(bd, "emissivity")
            if v is not None:
                em[p.slice] = v
        amode = str(bd.lookup("absorptivityMode", "emissivity"))
        if amode in _SOLID_MODES:
            m_a[p.slice] = True
        elif amode == "lookup":
            v = _uniform_scalar(bd, "absorptivity")
            if v is not None:
                ab[p.slice] = v
        else:  # 'emissivity': mirror the emissivity, its solid mask too
            ab[p.slice] = em[p.slice]
            m_a[p.slice] = m_e[p.slice]
    return torch.as_tensor(em, **kw), torch.as_tensor(ab, **kw), m_e, m_a


class _DeferredFvDOM:
    """Placeholder returned before the geometry exists; bind(geom) builds
    the model."""

    def __init__(self, case_dir):
        self.case_dir = case_dir

    def bind(self, geom: MeshGeometry) -> Optional[FvDOM]:
        case = Case(self.case_dir)
        return FvDOM.from_case_dict(case.constant("radiationProperties"), geom, case)
