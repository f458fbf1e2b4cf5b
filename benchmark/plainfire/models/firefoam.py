"""The fireFoam gas step, frozen for the benchmark's plain reference.

A copy of the port's models/firefoam.py cut to the gas phase the
benchmark's cases run: one `State` dict of tensors and a
`step(state) → (state, log)` running rhoEqn → PIMPLE{ UEqn, YEEqn
(species + energy), fvDOM, nCorr×pEqn, kEqn } with adaptive Δt:
  solver/rhoEqn.H:32-46   continuity
  solver/UEqn.H:1-34      momentum with buoyancy flux reconstruction
  solver/YEEqn.H:1-119    multivariate species + sensible-enthalpy energy
  solver/pEqn.H:1-60      p_rgh PISO corrector with hydrostatic splitting
  solver/phrghEqn.H:1-62  hydrostatic initialisation
  solver/setMultiRegionDeltaT.H:34-63  Courant-limited Δt growth

Every linear solve goes through solvers/linear.py's `solve_ldu`, the plain
Jacobi-preconditioned CG, BiCGStab and damped Jacobi, on any device. The
Lagrangian cloud, the film and pyrolysis regions, fvOptions, the function
objects, the RTI probes, the multigrid and OpenFOAM-exact solvers and the
partitioned step of the port are left out: a case that asks for one of
them raises at construction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import os
import time

import numpy as np
import torch

from ..combustion.edm import EddyDissipationModel
from ..config import default_device, real_dtype, small
from ..io import Case
from ..io.foamdict import FoamDict, expand_env, parse_file
from ..mesh import build_case_mesh
from ..ops import MeshGeometry, SurfaceField, VolField
from ..ops import bcs as bcmod
from ..ops import fvc, fvm
from ..ops.bcs import initial_boundary, make_field_bcs
from ..solvers.linear import solve_ldu, solve_scalar
from ..thermo import GasThermo, SingleStepReaction
from ..turbulence.kEqn import KEqnLES

__all__ = ["FireFoamSolver", "state_from_numpy", "state_to_numpy"]

def spalding_utau(mag_up, mag_grad_u, nuw, y, kappa=0.41, E=9.8):
    """u_τ from Spalding's unified wall law by Newton iteration
    (nutUSpaldingWallFunctionFvPatchScalarField::calcUTau), a fixed 30
    steps as in the JAX package. The guard is the JAX package's
    finfo.tiny·1e6 in float64; in float32 its square underflows and a face
    with |ΔU| = 0 would divide 0 by 0, so float32 guards with 1e-18."""
    dtype = mag_up.dtype
    tiny = torch.finfo(dtype).tiny * 1e6 if dtype == torch.float64 else 1e-18
    ut = torch.sqrt(nuw * mag_grad_u)
    for _ in range(30):
        ut_s = torch.clamp(ut, min=tiny)
        kuu = torch.clamp(kappa * mag_up / ut_s, max=50.0)
        fkuu = torch.exp(kuu) - 1.0 - kuu * (1.0 + 0.5 * kuu)
        f = -ut_s * y / nuw + mag_up / ut_s + 1.0 / E * (fkuu - kuu ** 3 / 6.0)
        df = y / nuw + mag_up / ut_s ** 2 + 1.0 / E * kuu * fkuu / ut_s
        ut = torch.clamp(ut_s + f / torch.clamp(df, min=tiny), min=0.0)
    return ut


def _solver_controls(fv_solution: FoamDict, *names: str) -> dict:
    """Look up solver controls, trying name variants in order."""
    solvers = fv_solution.get_dict("solvers")
    d = None
    for name in names:
        d = solvers.lookup(name, None)
        if d is not None:
            break
    if d is None:
        raise KeyError(f"none of {names} found in fvSolution solvers")
    return {
        "solver": str(d.lookup("solver")),
        "tolerance": d.get_scalar("tolerance", 1e-6),
        "relTol": d.get_scalar("relTol", 0.0),
        "maxIter": int(d.get_scalar("maxIter", 1000)),
        "preconditioner": str(d.lookup("preconditioner", "") or ""),
        "smoother": str(d.lookup("smoother", "") or ""),
        "nSweeps": int(d.get_scalar("nSweeps", 1)),
    }


@dataclass
class Controls:
    dt0: float
    end_time: float
    adjust: bool
    max_co: float
    max_dt: float
    write_interval: float
    adjustable_write: bool
    n_correctors: int
    n_outer: int
    momentum_predictor: bool
    hydrostatic_init: bool
    n_hydrostatic: int


class FireFoamSolver:
    """Host-side case setup + the eager step."""

    def __init__(self, case_dir: str, device=None, dtype=None, radiation: bool = True,
                 p_rgh_f64: bool = False, layout: Optional[str] = None):
        """p_rgh_f64: solve p_rgh in float64 inside a float32 step. layout:
        None/"auto" (DIA where the mesh fits, else SEG), "dia", "banded"
        (DIA up to 64 offsets), "seg" or "hybrid"
        (MeshGeometry.from_polymesh). `setup_seconds` holds the host's
        seconds for the mesh and the geometry."""
        self._refuse_left_out(case_dir)
        self.device = torch.device(device) if device is not None else default_device()
        self.dtype = dtype or real_dtype(self.device)
        self.case = Case(case_dir)
        t0 = time.perf_counter()
        self.cm = build_case_mesh(case_dir)
        t1 = time.perf_counter()
        self.geom = MeshGeometry.from_polymesh(self.cm.mesh, dtype=self.dtype,
                                               device=self.device, layout=layout)
        self.setup_seconds = {"mesh": t1 - t0, "geometry": time.perf_counter() - t1}
        g = self.geom
        self._read_additional_controls()

        # ---- thermo / chemistry ----
        tp = self.case.constant("thermophysicalProperties")
        self.fuel = tp.get_word("fuel", "C3H8")
        self.inert = tp.get_word("inertSpecie", "N2")
        rx = parse_file(expand_env(str(tp.lookup("foamChemistryFile")), case_dir), case_dir=case_dir)
        th = parse_file(expand_env(str(tp.lookup("foamChemistryThermoFile")), case_dir), case_dir=case_dir)
        self.species: List[str] = [str(s) for s in rx.get_list("species")]
        self.gas = GasThermo.from_dict(th, self.species)
        self.lewis_no = tp.get_scalar("lewisNo", 1.0)
        self.const_D = tp.get_bool("constD", False)
        _dm = tp.lookup("DM", 0.0)
        self.DM = float(_dm[-1]) if isinstance(_dm, list) else float(_dm or 0.0)
        self.reaction = SingleStepReaction.from_case(rx, self.gas, self.fuel, self.inert)
        self.combustion = EddyDissipationModel.from_case(
            self.case.constant("combustionProperties"), self.reaction
        )
        # cells next to wall patches (BertExt's nearWallCells gate)
        near_wall = torch.zeros(g.n_cells, dtype=torch.bool, device=self.device)
        for pch in g.patches:
            if "wall" in (pch.ptype or "").lower():
                near_wall[g.b_own[pch.slice]] = True
        self._near_wall_mask = near_wall

        # ---- turbulence ----
        self.turb = KEqnLES.from_case(
            g,
            self.case.constant("turbulenceProperties"),
            les_props=(
                self.case.constant("LESProperties")
                if self.case.has_constant("LESProperties")
                else None
            ),
        )

        # ---- radiation (fvDOM/P1/viewFactor, from constant/radiationProperties) ----
        rad_props = (
            self.case.constant("radiationProperties")
            if self.case.has_constant("radiationProperties")
            else FoamDict()
        )
        from ..radiation import make_radiation, make_soot_model

        # radiation=False runs without the radiation model (run --no-radiation)
        self.radiation = make_radiation(rad_props, g, self.case) if radiation else None
        if hasattr(self.radiation, "epsilon_fn"):
            # fvDOM's ft table and spSootRadFracEmission's strain-rate lookup
            # need the reaction and the SGS dissipation
            self.radiation.reaction = self.reaction
            self.radiation.epsilon_fn = lambda st: self.turb.epsilon(st["k"].i)
        # the soot model belongs to the radiation model (radiationModel.C:
        # 222-225) and is built whether radiation is on or not
        self.soot = make_soot_model(rad_props, self.reaction)
        aec = rad_props.get_dict("constRadFractionEmissionCoeffs", FoamDict())
        self.ehrr = aec.get_scalar("Ehrr2", aec.get_scalar("EhrrCoeff", 0.2))

        # ---- gravity / reference values ----
        self.g_vec = np.asarray(self.case.constant("g").get_vector("value"))
        href = (
            self.case.constant("hRef").get_scalar("value", 0.0)
            if self.case.has_constant("hRef") else 0.0
        )
        gh_ref = -float(np.linalg.norm(self.g_vec)) * float(href)  # ghRef = −|g|·hRef
        C = g.C.cpu().numpy()
        Cf = g.Cf.cpu().numpy()
        bCf = g.b_Cf.cpu().numpy()
        self.gh = self._t(C @ self.g_vec - gh_ref)
        self.ghf_i = self._t(Cf @ self.g_vec - gh_ref)
        self.ghf_b = self._t(bCf @ self.g_vec - gh_ref)
        self.p_ref = (
            self.case.constant("pRef").get_scalar("value", 101325.0)
            if self.case.has_constant("pRef") else 101325.0
        )

        # ---- controls ----
        cd = self.case.control_dict
        pimple = self.case.fv_solution.get_dict("PIMPLE")
        self.ctl = Controls(
            dt0=cd.get_scalar("deltaT"),
            end_time=cd.get_scalar("endTime"),
            adjust=cd.get_bool("adjustTimeStep", False),
            max_co=cd.get_scalar("maxCo", 1.0),
            max_dt=cd.get_scalar("maxDeltaT", 1e6),
            write_interval=cd.get_scalar("writeInterval", 1.0),
            adjustable_write=str(cd.lookup("writeControl", "timeStep")) == "adjustableRunTime",
            n_correctors=pimple.get_int("nCorrectors", 2),
            n_outer=pimple.get_int("nOuterCorrectors", 1),
            momentum_predictor=pimple.get_bool("momentumPredictor", True),
            hydrostatic_init=pimple.get_bool("hydrostaticInitialization", False),
            n_hydrostatic=pimple.get_int("nHydrostaticCorrectors", 5),
        )
        self.fv_solution = self.case.fv_solution
        # laplacianSchemes default: '... uncorrected' (None), '... corrected'
        # (1.0) or '... limited α' (α): the deferred non-orthogonal
        # correction on every implicit laplacian of the step
        self.lap_limiter: Optional[float] = None
        lsch = self.case.fv_schemes.get_dict("laplacianSchemes", FoamDict()).lookup("default", "")
        toks = [str(t) for t in lsch] if isinstance(lsch, list) else [str(lsch)]
        if "corrected" in toks:
            self.lap_limiter = 1.0
        elif "limited" in toks:
            i = toks.index("limited")
            self.lap_limiter = float(toks[i + 1]) if i + 1 < len(toks) else 1.0
        self.turb.lap_limiter = self.lap_limiter
        self.u_div_scheme = self._parse_div_scheme("div(phi,U)", ("LUST",))
        self.turb.div_scheme = self._parse_div_scheme("div(phi,k)", ("limitedLinear", 1.0))
        self.p_rgh_f64 = bool(p_rgh_f64)
        rf = self.fv_solution.get_dict("relaxationFactors", FoamDict())
        self._eq_relax = rf.get_dict("equations", None)

        # ---- fields & BCs ----
        self.t0_name = self.case.start_time()
        self.t0 = float(self.t0_name)
        self._read_initial_fields()
        if self.combustion.variant == "eddyDissipationIgnModel" and (
                self.case.has_field("dQI") or self.case.has_field("dQI", self.t0_name)):
            # pilot heat field dQI masked to the 'igniter' cellZone
            # (eddyDissipationIgnModel::correct)
            dqi, _ = self._read_field("dQI")
            mask = np.zeros(self.cm.mesh.n_cells)
            zone = self.cm.sets.cell_zones.get("igniter")
            if zone is not None:
                mask[np.asarray(zone)] = 1.0
            self.combustion.ign_dQI = dqi.i * self._t(mask)

    # ------------------------------------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype, device=self.device)

    @staticmethod
    def _refuse_left_out(case_dir: str):
        """Raise where the case asks for what this copy leaves out."""
        case = Case(case_dir)
        for name in ("reactingCloud1Properties", "pyrolysisZones", "surfaceFilmProperties",
                     "rtiProperties", "fvOptions"):
            if case.has_constant(name):
                raise NotImplementedError(f"the benchmark's reference has no {name}")
        for name in ("fvOptions", "rtisDict"):
            if os.path.exists(os.path.join(case_dir, "system", name)):
                raise NotImplementedError(f"the benchmark's reference has no system/{name}")
        cd = case.control_dict
        if "functions" in cd:
            raise NotImplementedError("the benchmark's reference has no function objects")

    def _read_additional_controls(self):
        """constant/additionalControls: solvePrimaryRegion false (the
        regions alone) is left out."""
        case = self.case
        ac = case.constant("additionalControls") if case.has_constant(
            "additionalControls") else FoamDict()
        if not ac.get_bool("solvePrimaryRegion", True):
            raise NotImplementedError("the benchmark's reference solves the gas")

    def _read_field(self, name: str, default_name: Optional[str] = None):
        t0 = self.t0_name
        if t0 != "0" and self.case.has_field(name, t0):
            ff = self.case.field(name, t0)
        elif self.case.has_field(name):
            ff = self.case.field(name)
        elif default_name is not None:
            ff = self.case.field_or_default(name, default_name)
        else:
            raise FileNotFoundError(f"0/{name}")
        g = self.geom
        internal = self._t(ff.internal_array(g.n_cells))
        boundary = initial_boundary(ff, g, self.dtype, self.device)
        return VolField(internal, boundary), make_field_bcs(ff, g)

    def _read_initial_fields(self):
        self.U, self.U_bcs = self._read_field("U")
        self.T, self.T_bcs = self._read_field("T")
        self.p_rgh, self.p_rgh_bcs = self._read_field("p_rgh")
        self.p, self.p_bcs = self._read_field("p")
        self.k, self.k_bcs = self._read_field("k")
        self.alphat, self.alphat_bcs = self._read_field("alphat")
        self.nut, self.nut_bcs = self._read_field("nut")
        Yi, Yb, self.Y_bcs = [], [], []
        for sp in self.species:
            f, b = self._read_field(sp, default_name="Ydefault")
            Yi.append(f.i)
            Yb.append(f.b)
            self.Y_bcs.append(b)
        # the inert specie is never solved: Y_inert = 1 − ΣY everywhere
        inert = self.species.index(self.inert)
        Yi[inert] = torch.clamp(1.0 - sum(Yi[s] for s in range(len(Yi)) if s != inert), min=0.0)
        Yb[inert] = torch.clamp(1.0 - sum(Yb[s] for s in range(len(Yb)) if s != inert), min=0.0)
        self.Y = VolField(torch.stack(Yi, dim=1), torch.stack(Yb, dim=1))

    # ------------------------------------------------------------------
    def initial_state(self) -> Dict:
        """Build the State dict: thermo init + hydrostatic initialisation."""
        g = self.geom
        Y, T, p = self.Y, self.T, self.p

        # totalFlowRateAdvectiveDiffusive inlets start as zeroGradient (the
        # mixed fraction is 0 at phi = 0): the initial face composition is
        # the cell mixture, not the file's 'value'
        tfrad_patches = {
            pch.name
            for bcs in self.Y_bcs
            for bc, pch in zip(bcs.bcs, g.patches)
            if bc.kind == "totalFlowRateAdvectiveDiffusive"
        }
        Yb = Y.b.clone()
        for pch in g.patches:
            if pch.name in tfrad_patches:
                Yb[pch.slice, :] = g.cell_to_boundary(Y.i)[pch.slice, :]
        Y = VolField(Y.i, Yb)

        gas = self.gas
        psi_i = gas.psi(T.i, Y.i)
        psi_b = gas.psi(T.b, Y.b)
        rho = VolField(psi_i * p.i, psi_b * p.b)
        hs = VolField(gas.hs(T.i, Y.i), gas.hs(T.b, Y.b))
        mu = VolField(gas.mu(T.i, Y.i), gas.mu(T.b, Y.b))
        alpha = VolField(gas.alpha(T.i, Y.i), gas.alpha(T.b, Y.b))

        rho_f = fvc.interpolate(g, rho)
        uflux = fvc.flux(g, self.U)
        phi = SurfaceField(rho_f.i * uflux.i, rho_f.b * uflux.b)

        z_c = torch.zeros(g.n_cells, dtype=self.dtype, device=self.device)
        z_b = torch.zeros(g.n_boundary, dtype=self.dtype, device=self.device)
        state = {
            "t": self._t(self.t0),
            "dt": self._t(self.ctl.dt0),
            "U": self.U,
            "p_rgh": self.p_rgh,
            "p": p,
            "p_old_i": p.i,
            "rho": rho,
            "rho_old_i": rho.i,
            "Y": Y,
            "hs": hs,
            "T": T,
            "psi": VolField(psi_i, psi_b),
            "mu": mu,
            "alpha": alpha,
            "k": self.k,
            "nut": VolField(self.turb.nut(self.k.i), self.turb.nut_b(self.k.b)),
            "alphat": self.alphat,
            "phi": phi,
            "Qdot": z_c,
            "ph_rgh_b": z_b,
            "_phi_b_prev": z_b,
            "dpdt": z_c,
            "K_old_i": 0.5 * torch.sum(self.U.i * self.U.i, dim=1),
        }
        if self.radiation is not None:
            state["rad"] = self.radiation.initial_state()
        if self.combustion.stream_rad_fracs:
            state["localRadFrac"] = z_c
        # phrghEqn.H runs only at t = 0
        if self.ctl.hydrostatic_init and self.t0 == 0.0:
            state = self._hydrostatic_init(state)
        # old-time snapshots for the pressure equation's ddt/ddtCorr terms
        state["psi_old_i"] = state["psi"].i
        state["p_rgh_old_i"] = state["p_rgh"].i
        state["phi_old_i"] = state["phi"].i
        state["rhoU_old_i"] = state["rho"].i[:, None] * state["U"].i
        # the reference updates Δt at the top of the loop (fireFoam.C:78-82):
        # setInitialDeltaT.H then one loop-top update here
        if self.ctl.adjust:
            co = self.courant(state)
            grown = torch.clamp(
                self.ctl.max_co * state["dt"] / torch.clamp(co, min=small(self.dtype)),
                max=self.ctl.max_dt,
            )
            state["dt"] = torch.where(co > 1e-15, grown, state["dt"])
            state["dt"] = self.new_dt(state)
        state["_dt_prev"] = state["dt"]
        return state

    # ------------------------------------------------------------------
    def _phrgh_fixed_mask(self):
        """[n_boundary] 1.0 where ph_rgh is a fixed-value patch. Prefers the
        0/ph_rgh(.orig) file's own BC types (phrghEqn.H MUST_READ)."""
        g = self.geom
        kinds = None
        for nm in ("ph_rgh", "ph_rgh.orig"):
            if self.case.has_field(nm):
                ff = self.case.field(nm)
                kinds = {}
                for pname in ff.boundary:
                    sub = ff.boundary.get_dict(pname, None)
                    if isinstance(sub, FoamDict):
                        kinds[pname] = sub.get_word("type", "")
                break
        f_list = []
        for bc, pch in zip(self.p_rgh_bcs.bcs, g.patches):
            if kinds is not None and pch.name in kinds:
                is_fixed = kinds[pch.name] in ("fixedValue", "totalPressure", "uniformFixedValue")
            else:
                is_fixed = bc.kind in ("prghTotalHydrostaticPressure", "fixedValue", "totalPressure")
            f_list.append(torch.full((pch.n,), 1.0 if is_fixed else 0.0,
                                     dtype=self.dtype, device=self.device))
        return torch.cat(f_list)

    def _hydrostatic_init(self, state: Dict) -> Dict:
        """solver/phrghEqn.H: iterate lap(rho_f, ph_rgh) = div(phig) so the
        initial pressure field is in hydrostatic balance."""
        g = self.geom
        z_b = torch.zeros(g.n_boundary, dtype=self.dtype, device=self.device)
        ph = VolField(torch.zeros(g.n_cells, dtype=self.dtype, device=self.device), z_b)
        Y, T = state["Y"], state["T"]
        p = state["p"]
        f = self._phrgh_fixed_mask()
        ctl = _solver_controls(self.fv_solution, "ph_rgh", "p_rgh")
        for _ in range(self.ctl.n_hydrostatic):
            psi_i = self.gas.psi(T.i, Y.i)
            psi_b = self.gas.psi(T.b, Y.b)
            rho = VolField(psi_i * p.i, psi_b * p.b)
            rho_f = fvc.interpolate(g, rho)
            sg_rho = fvc.sn_grad(g, rho)
            phig = SurfaceField(
                -rho_f.i * self.ghf_i * sg_rho.i * g.magSf,
                -rho_f.b * self.ghf_b * sg_rho.b * g.b_magSf,
            )
            rhs = fvc.surface_sum(g, phig)  # div(phig)·V
            # gradient patches: snGrad(ph_rgh) = phig/(ρ_f·A) so the boundary
            # buoyancy flux cancels (constrainPressure)
            rg = phig.b / (rho_f.b * g.b_magSf)
            gic, gbc = fvm.mixed_gradient_coeffs(z_b, rg, f, g.b_dc)
            m = -fvm.laplacian(g, rho_f, ph, gic, gbc, corr=self._lap_corr(ph))
            m = fvm.FvMatrix(
                g, m.diag, m.lower, m.upper, m.source - rhs,
                m.internal_coeffs, m.boundary_coeffs, m.psi,
            )
            res = solve_scalar(m, ph.i, solver=ctl["solver"], tol=ctl["tolerance"],
                               rel_tol=ctl["relTol"],
                               preconditioner=ctl["preconditioner"])
            ph_b = f * 0.0 + (1.0 - f) * (g.cell_to_boundary(res.x) + rg / g.b_dc)
            ph = VolField(res.x, ph_b)
            p = VolField(
                ph.i + rho.i * self.gh + self.p_ref,
                ph.b + rho.b * self.ghf_b + self.p_ref,
            )
        state = dict(state)
        state["p"] = VolField(p.i, state["p"].b)
        # old-time copies refresh too, or step 0 sees a spurious dpdt
        state["p_old_i"] = p.i
        state["p_rgh"] = VolField(ph.i, ph.b)
        state["ph_rgh_b"] = ph.b
        psi_i = self.gas.psi(T.i, Y.i)
        state["rho"] = VolField(psi_i * p.i, state["rho"].b)
        state["rho_old_i"] = state["rho"].i
        state["psi"] = VolField(psi_i, state["psi"].b)
        return state

    # ------------------------------------------------------------------
    def _ctx(self, state: Dict, overrides=None) -> dict:
        alpha_eff_b = state["alphat"].b + state["alpha"].b
        return {
            "phi": state["phi"],
            "rho": state["rho"],
            "U": state["U"],
            "t": state["t"],
            "alphaEff_b": alpha_eff_b,
            "kappaEff_b": alpha_eff_b * self.gas.cp(state["T"].b, state["Y"].b),
            "ph_rgh_b": state["ph_rgh_b"],
            "phi_prev_b": state.get("_phi_b_prev"),
            "overrides": overrides or {},
        }

    # ------------------------------------------------------------------
    def courant(self, state: Dict) -> torch.Tensor:
        """compressibleCourantNo: 0.5·max(Σ|φ| / (ρ V))·Δt."""
        g = self.geom
        sum_phi = g.cell_sum_unsigned(torch.abs(state["phi"].i), torch.abs(state["phi"].b))
        return 0.5 * g.rmax(sum_phi / (state["rho"].i * g.V)) * state["dt"]

    def courant_mean(self, state: Dict) -> torch.Tensor:
        """compressibleCourantNo meanCoNum: 0.5·(ΣsumPhi/ρ)/ΣV·Δt."""
        g = self.geom
        sum_phi = g.cell_sum_unsigned(torch.abs(state["phi"].i), torch.abs(state["phi"].b))
        return 0.5 * g.rsum(sum_phi / state["rho"].i) / g.rsum(g.V) * state["dt"]

    def _adjust_write_dt(self, t, dt):
        """Time::adjustDeltaT (adjustableRunTime): land an integer number of
        steps exactly on the next write time."""
        if not self.ctl.adjustable_write:
            return dt
        interval = self.ctl.write_interval
        t_next = (torch.floor((t - self.t0) / interval + 1e-9) + 1.0) * interval + self.t0
        remain = torch.clamp(t_next - t, min=1e-12)
        n = torch.floor(torch.clamp(remain / dt, min=1.0) + 0.99)
        return remain / n

    def new_dt(self, state: Dict) -> torch.Tensor:
        """Next-step Δt: setMultiRegionDeltaT.H (the fluid Courant) then the
        stock setDeltaT.H, each re-landing on the adjustable write time
        (fireFoam.C:78-82)."""
        co = self.courant(state)
        t_fluid = self.ctl.max_co / (co + 1e-15)
        fact = torch.clamp(t_fluid, max=1.2)
        dt = torch.clamp(fact * state["dt"], max=self.ctl.max_dt)
        dt = self._adjust_write_dt(state["t"], dt)
        fact2 = torch.clamp(torch.minimum(t_fluid, 1.0 + 0.1 * t_fluid), max=1.2)
        dt = torch.clamp(fact2 * dt, max=self.ctl.max_dt)
        return self._adjust_write_dt(state["t"], dt)

    # ------------------------------------------------------------------
    def _eqn_relax_factor(self, name: str) -> Optional[float]:
        """relaxationFactors.equations lookup; None = no relax() call."""
        if self._eq_relax is None:
            return None
        v = self._eq_relax.lookup(name, None)
        return None if v is None else float(v)

    def _parse_div_scheme(self, key: str, default: tuple) -> tuple:
        """fvSchemes.divSchemes[key] → ('LUST',) | ('linear',) | ('upwind',)
        | ('limitedLinear'|'limitedLinear01', k) | ('filteredLinear2', k, l)
        (filteredLinear2 and filteredLinear2V alike). Other schemes raise."""
        v = self.case.fv_schemes.get_dict("divSchemes").lookup(key, None)
        if v is None:
            return default
        toks = [str(t) for t in v] if isinstance(v, list) else [str(v)]
        if toks and toks[0] == "Gauss":
            toks = toks[1:]
        if not toks:
            return default
        name = toks[0]
        if name == "LUST":
            return ("LUST",)
        if name in ("linear", "upwind"):
            return (name,)
        if name in ("limitedLinear", "limitedLinearV", "limitedLinear01"):
            k = float(toks[1]) if len(toks) > 1 else 1.0
            return ("limitedLinear01" if name.endswith("01") else "limitedLinear", k)
        if name in ("filteredLinear2", "filteredLinear2V"):
            k = float(toks[1]) if len(toks) > 1 else 1.0
            l = float(toks[2]) if len(toks) > 2 else 0.0
            return ("filteredLinear2", k, l)
        raise NotImplementedError(f"divSchemes {key}: scheme '{name}'")

    def _div_weights(self, scheme: tuple, phi, psi, grad_psi=None):
        """Per-face interpolation weights of a parsed div scheme (LUST is
        handled at the call site)."""
        g = self.geom
        name = scheme[0]
        if name == "linear":
            return g.w
        if name == "upwind":
            return fvm.upwind_weights(g, phi.i)
        if name == "filteredLinear2":
            lim = fvm.filtered_linear2_limiter(g, psi, grad_psi, k=scheme[1], l=scheme[2])
            return fvm.limiter_weights(g, phi.i, lim)
        return fvm.limited_linear_weights(g, phi.i, psi, k=scheme[1], bound01=name.endswith("01"))

    def _lap_corr(self, psi) -> Optional[torch.Tensor]:
        """The deferred non-orthogonal laplacian correction of the
        laplacianSchemes default (None under 'uncorrected')."""
        if self.lap_limiter is None:
            return None
        lim = None if self.lap_limiter >= 1.0 else self.lap_limiter
        return fvc.non_orth_correction(self.geom, psi, limiter=lim)

    def _lin_fn(self, ctl):
        """fn(diag, upper, lower, b, x0) → SolverResult for the controls,
        by `solve_ldu`: PCG/GAMG → plain CG, smoothSolver → damped Jacobi,
        every other Krylov solver → BiCGStab, with the JAX package's
        budgets."""
        sol, tol, rel, mx = ctl["solver"], ctl["tolerance"], ctl["relTol"], ctl["maxIter"]
        g = self.geom

        def fn(d, up, lo, b, x0):
            return solve_ldu(g, sol, d, up, lo, b, x0, tol=tol, rel_tol=rel, max_iter=mx)

        return fn

    # ------------------------------------------------------------------
    # equation pieces
    # ------------------------------------------------------------------
    def _u_eqn(self, state, log, srcs):
        g = self.geom
        U, rho, phi, mu = state["U"], state["rho"], state["phi"], state["mu"]
        mu_eff = VolField(mu.i + rho.i * state["nut"].i, mu.b + rho.b * state["nut"].b)
        ctx = self._ctx(state, srcs.get("_ov"))

        rv, rg, f = bcmod.resolve(self.U_bcs, g, U, ctx)
        vic, vbc = fvm.mixed_value_coeffs(rv, rg, f, g.b_dc)
        gic, gbc = fvm.mixed_gradient_coeffs(rv, rg, f, g.b_dc)

        gradU = fvc.grad(g, U)
        mu_eff_f = SurfaceField(fvc.interpolate(g, mu_eff).i, mu_eff.b)
        if self.u_div_scheme[0] == "LUST":
            conv = fvm.lust_div(g, phi, U, vic, vbc, gradU)
        else:
            conv = fvm.div(g, phi, U, self._div_weights(self.u_div_scheme, phi, U, gradU), vic, vbc)
        m = (
            fvm.ddt(g, rho.i, U, U.i, state["rho_old_i"], state["dt"])
            + conv
            - fvm.laplacian(g, mu_eff_f, U, gic, gbc, corr=self._lap_corr(U))
        )
        div_tau = self.turb.div_dev_rho_reff(U, mu_eff, gradU)
        m = m.add_source(div_tau + srcs["SU"])
        rf = self._eqn_relax_factor("U")
        if rf is not None:
            m = m.relax(rf)

        # buoyancy + pressure-gradient source (UEqn.H:22-31) enters only the
        # solved system: the named UEqn (whose A()/H() pEqn uses) excludes it
        sg_rho = fvc.sn_grad(g, rho)
        sg_p = fvc.sn_grad(g, state["p_rgh"])
        face_src = SurfaceField(
            (-self.ghf_i * sg_rho.i - sg_p.i) * g.magSf,
            (-self.ghf_b * sg_rho.b - sg_p.b) * g.b_magSf,
        )
        m_solve = m.add_source(fvc.reconstruct(g, face_src))

        # one batched solve over the 3 components (shared off-diagonals)
        fn = self._lin_fn(_solver_controls(self.fv_solution, "Ux", "U"))
        dtot, b = m_solve.totals()
        res = fn(dtot.T.contiguous(), m_solve.upper, m_solve.lower,
                 b.T.contiguous(), U.i.T.contiguous())
        for c, comp in enumerate("xyz"):
            log[f"U{comp}_res0"] = res.initial_residual[c]
            log[f"U{comp}_iters"] = res.n_iterations[c]
        U_new = bcmod.apply_coeffs(g, VolField(res.x.T, U.b), rv, rg, f)
        # the resolved coefficients are reused by pEqn.H:46's
        # U.correctBoundaryConditions() (updateCoeffs runs once per step)
        return U_new, m, (rv, rg, f)

    def _multivariate_weights(self, state):
        """div(phi,Yi_h) Gauss multivariateSelection: one shared convection
        weight field from the elementwise MIN limiter over every species
        (limitedLinear01) and hs (limitedLinear)."""
        g = self.geom
        phi_i = state["phi"].i
        Y = state["Y"]
        lim = None
        for s in range(len(self.species)):
            l = fvm.limited_linear_limiter(
                g, phi_i, VolField(Y.i[:, s], Y.b[:, s]), k=1.0, bound01=True
            )
            lim = l if lim is None else torch.minimum(lim, l)
        lim = torch.minimum(lim, fvm.limited_linear_limiter(g, phi_i, state["hs"], k=1.0))
        return fvm.limiter_weights(g, phi_i, lim)

    def _y_eqns(self, state, log, srcs, w_mv):
        """Species transport with EDM source (YEEqn.H:27-77)."""
        g = self.geom
        rho, phi, Y, dt = state["rho"], state["phi"], state["Y"], state["dt"]
        spray_rho = None
        rates = self.combustion.rates(
            rho.i, Y.i, state["k"].i, self.turb.epsilon(state["k"].i),
            state["alpha"].i, self.turb.delta, dt, T=state["T"].i, p=state["p"].i,
            spray_rho=spray_rho, near_wall=self._near_wall_mask, t=state["t"],
            nu=state["mu"].i / rho.i, nut=state["nut"].i,
        )
        qdot = self.combustion.qdot(rates)
        if "localRadFrac" in rates:
            # consumed by localFuelRadFractionEmission (ECont = lrf·Qdot)
            state["localRadFrac"] = rates["localRadFrac"]

        # species effective diffusivity dEff (YEEqn.H:12-25)
        if self.const_D:
            alpha_eff = VolField(state["alphat"].i + self.DM * rho.i,
                                 state["alphat"].b + self.DM * rho.b)
        elif self.lewis_no != 1.0:
            alpha_eff = VolField(state["alphat"].i + state["alpha"].i / self.lewis_no,
                                 state["alphat"].b + state["alpha"].b / self.lewis_no)
        else:
            alpha_eff = VolField(state["alphat"].i + state["alpha"].i,
                                 state["alphat"].b + state["alpha"].b)
        alpha_eff_f = SurfaceField(fvc.interpolate(g, alpha_eff).i, alpha_eff.b)
        ctx = self._ctx(state, srcs.get("_ov"))
        inert_idx = self.gas.index(self.inert)
        solved = [s for s in range(len(self.species)) if s != inert_idx]
        rfs = {self._eqn_relax_factor(self.species[s]) for s in solved}
        relax_f = rfs.pop() if len(rfs) == 1 else None

        # assemble every solved species, then ONE batched solve (a row each)
        ds, ups, los, bs = [], [], [], []
        for s in solved:
            Ysf = VolField(Y.i[:, s], Y.b[:, s])
            rv, rg, f = bcmod.resolve(self.Y_bcs[s], g, Ysf, ctx)
            vic, vbc = fvm.mixed_value_coeffs(rv, rg, f, g.b_dc)
            gic, gbc = fvm.mixed_gradient_coeffs(rv, rg, f, g.b_dc)
            m = (
                fvm.ddt(g, rho.i, Ysf, Ysf.i, state["rho_old_i"], dt)
                + fvm.div(g, phi, Ysf, w_mv, vic, vbc)
                - fvm.laplacian(g, alpha_eff_f, Ysf, gic, gbc, corr=self._lap_corr(Ysf))
            )
            src_s = self.combustion.R(rates, s)
            extra = srcs.get("SY", {}).get(s)  # per-component evaporation
            if extra is not None:
                src_s = src_s + extra
            m = m.add_source(src_s)
            if relax_f is not None:
                m = m.relax(relax_f)
            d, b = m.totals()
            ds.append(d)
            ups.append(m.upper)
            los.append(m.lower)
            bs.append(b)
        fn = self._lin_fn(_solver_controls(self.fv_solution, "Yi"))
        x0 = torch.stack([Y.i[:, s] for s in solved])
        res = fn(torch.stack(ds), torch.stack(ups), torch.stack(los), torch.stack(bs), x0)

        new_cols_i = [None] * len(self.species)
        new_cols_b = [None] * len(self.species)
        for k, s in enumerate(solved):
            yi = torch.clamp(res.x[k], min=0.0)
            ys_new = bcmod.evaluate(self.Y_bcs[s], g, VolField(yi, Y.b[:, s]), ctx)
            new_cols_i[s] = ys_new.i
            new_cols_b[s] = ys_new.b
            log[f"{self.species[s]}_res0"] = res.initial_residual[k]
            log[f"{self.species[s]}_iters"] = res.n_iterations[k]
        # inert specie: Yt bookkeeping (YEEqn.H:62-66)
        others_i = sum(c for i, c in enumerate(new_cols_i) if i != inert_idx)
        others_b = sum(c for i, c in enumerate(new_cols_b) if i != inert_idx)
        new_cols_i[inert_idx] = torch.clamp(1.0 - others_i, min=0.0)
        new_cols_b[inert_idx] = torch.clamp(1.0 - others_b, min=0.0)
        Y_new = VolField(torch.stack(new_cols_i, dim=1), torch.stack(new_cols_b, dim=1))
        return Y_new, qdot

    def _hs_bcs_from_T(self, state, Y_new, ov=None):
        """Sensible-enthalpy mixed BC coefficients from T's BCs
        (mixedEnergyFvPatchScalarField::updateCoeffs)."""
        g = self.geom
        rvT, rgT, fT = bcmod.resolve(self.T_bcs, g, state["T"], self._ctx(state, ov))
        hs_ref = self.gas.hs(torch.clamp(rvT, min=10.0), Y_new.b)
        cp_b = self.gas.cp(state["T"].b, Y_new.b)
        hs_w = self.gas.hs(state["T"].b, Y_new.b)
        hs_c = self.gas.hs(g.cell_to_boundary(state["T"].i), Y_new.b)
        rg = cp_b * rgT + g.b_dc * (hs_w - hs_c)
        return hs_ref, rg, fT

    def _e_eqn(self, state, Y_new, qdot, log, srcs, w_mv):
        """Sensible-enthalpy energy equation (YEEqn.H:84-118)."""
        g = self.geom
        rho, phi, hs, U, dt = state["rho"], state["phi"], state["hs"], state["U"], state["dt"]
        alpha_eff = VolField(state["alphat"].i + state["alpha"].i,
                             state["alphat"].b + state["alpha"].b)
        alpha_eff_f = SurfaceField(fvc.interpolate(g, alpha_eff).i, alpha_eff.b)
        rv, rg, f = self._hs_bcs_from_T(state, Y_new, srcs.get("_ov"))
        vic, vbc = fvm.mixed_value_coeffs(rv, rg, f, g.b_dc)
        gic, gbc = fvm.mixed_gradient_coeffs(rv, rg, f, g.b_dc)

        # kinetic-energy and dpdt terms (explicit)
        K = VolField(0.5 * torch.sum(U.i * U.i, dim=1), 0.5 * torch.sum(U.b * U.b, dim=1))
        ddtK = (rho.i * K.i - state["rho_old_i"] * state["K_old_i"]) / dt
        divK = fvc.div_flux_psi(g, phi, fvc.interpolate(g, K))
        if self.radiation is not None:
            sh_rad = self.radiation.Sh(state, self.gas)
        else:
            sh_rad = -self.ehrr * qdot  # optically-thin fallback

        m = (
            fvm.ddt(g, rho.i, hs, hs.i, state["rho_old_i"], dt)
            + fvm.div(g, phi, hs, w_mv, vic, vbc)
            - fvm.laplacian(g, alpha_eff_f, hs, gic, gbc, corr=self._lap_corr(hs))
        )
        m = m.add_source(qdot + sh_rad + srcs["Sh"] + state["dpdt"] - ddtK - divK)
        rf = self._eqn_relax_factor("h")
        if rf is not None:
            m = m.relax(rf)
        ctl = _solver_controls(self.fv_solution, "h", "hs")
        res = solve_scalar(m, hs.i, solver=ctl["solver"], tol=ctl["tolerance"],
                           rel_tol=ctl["relTol"], max_iter=ctl["maxIter"],
                           preconditioner=ctl["preconditioner"],
                           smoother=ctl["smoother"], n_sweeps=ctl["nSweeps"])
        log["h_res0"] = res.initial_residual
        log["h_iters"] = res.n_iterations

        # thermo.correct(): T(hs), boundary values, transport props
        gas = self.gas
        T_i = gas.T_from_hs(res.x, Y_new.i, state["T"].i)
        hs_b = f * rv + (1.0 - f) * (g.cell_to_boundary(res.x) + rg / g.b_dc)
        T_b = gas.T_from_hs(hs_b, Y_new.b, state["T"].b)
        return (
            VolField(res.x, hs_b),
            VolField(T_i, T_b),
            VolField(gas.psi(T_i, Y_new.i), gas.psi(T_b, Y_new.b)),
            VolField(gas.mu(T_i, Y_new.i), gas.mu(T_b, Y_new.b)),
            VolField(gas.alpha(T_i, Y_new.i), gas.alpha(T_b, Y_new.b)),
        )

    def _p_eqn(self, state, u_matrix, final: bool, srcs, ubc_coeffs):
        """PISO pressure corrector (solver/pEqn.H); `final` selects the
        p_rghFinal solver controls."""
        g = self.geom
        dt = state["dt"]
        psi, p_rgh = state["psi"], state["p_rgh"]
        rho = VolField(psi.i * state["p"].i, psi.b * state["p"].b)  # thermo.rho()

        rAU = 1.0 / u_matrix.A()
        rho_rAU_f = fvc.interpolate(g, VolField(rho.i * rAU, rho.b * g.cell_to_boundary(rAU)))
        # UEqn.H() with the CURRENT U (pEqn.H is re-included per corrector)
        m_h = fvm.FvMatrix(
            g, u_matrix.diag, u_matrix.lower, u_matrix.upper, u_matrix.source,
            u_matrix.internal_coeffs, u_matrix.boundary_coeffs, state["U"],
        )
        HbyA_i = rAU[:, None] * m_h.H()
        # flowRateInletVelocity patches re-metered against this corrector's
        # thermo rho_b, so the inflow stays exactly ṁ
        U_b_eff = state["U"].b.clone()
        metered = []
        for bc in self.U_bcs.bcs:
            if bc.kind != "flowRateInletVelocity":
                continue
            sl = g.patch(bc.patch).slice
            mdot = bcmod.mass_flow_rate(bc, state["t"])
            A = g.bsum(g.b_magSf, sl)
            n = g.b_Sf[sl] / g.b_magSf[sl, None]
            u_met = -n * (mdot / (rho.b[sl] * A))[:, None]
            U_b_eff[sl] = u_met
            metered.append((sl, u_met))
        HbyA = VolField(HbyA_i, U_b_eff)

        sg_rho = fvc.sn_grad(g, rho)
        phig = SurfaceField(
            -rho_rAU_f.i * self.ghf_i * sg_rho.i * g.magSf,
            -rho_rAU_f.b * self.ghf_b * sg_rho.b * g.b_magSf,
        )
        # fvc::flux(rho*HbyA): interpolate the product field (pEqn.H:13)
        rhoHbyA = VolField(rho.i[:, None] * HbyA.i, rho.b[:, None] * HbyA.b)
        hflux = fvc.flux(g, rhoHbyA)
        # rhorAUf*fvc::ddtCorr(rho, U, phi), Euler, from old-time fields
        phi_old = state["phi_old_i"]
        flux_old = fvc.flux(
            g, VolField(state["rhoU_old_i"], torch.zeros_like(rhoHbyA.b))
        ).i
        diff = phi_old - flux_old
        coeff = 1.0 - torch.clamp(torch.abs(diff) / (torch.abs(phi_old) + small(self.dtype)), max=1.0)
        ddt_corr_i = rho_rAU_f.i * coeff * diff / dt
        phi_hbya = SurfaceField(hflux.i + ddt_corr_i + phig.i, hflux.b + phig.b)

        # constrainPressure: fixedFluxPressure gradients so flux matches U_b
        u_flux_b = rho.b * torch.sum(g.b_Sf * U_b_eff, dim=1)
        grad_override = (phi_hbya.b - u_flux_b) / (rho_rAU_f.b * g.b_magSf)
        overrides = dict(srcs.get("_ov") or {})
        for bc, pch in zip(self.p_rgh_bcs.bcs, g.patches):
            if bc.kind == "fixedFluxPressure":
                overrides[("p_rgh", pch.name, "gradient")] = grad_override[pch.slice]
        ctx = self._ctx(state, overrides)
        rv, rg, f = bcmod.resolve(self.p_rgh_bcs, g, p_rgh, ctx)
        gic, gbc = fvm.mixed_gradient_coeffs(rv, rg, f, g.b_dc)
        corr = self._lap_corr(p_rgh)
        m_lap = fvm.laplacian(g, rho_rAU_f, p_rgh, gic, gbc, corr=corr)

        # p_rghEqn (pEqn.H:26-38) with old-time values in every ddt
        psi_old = state["psi_old_i"]
        rho_old = state["rho_old_i"]
        m = -m_lap
        m = fvm.FvMatrix(
            g,
            m.diag + psi.i * g.V / dt,
            m.lower,
            m.upper,
            m.source
            + psi.i * g.V / dt * state["p_rgh_old_i"]
            - (self.gh * (psi.i * rho.i - psi_old * rho_old) / dt) * g.V
            - (self.p_ref * (psi.i - psi_old) / dt) * g.V
            - fvc.surface_sum(g, phi_hbya)
            + srcs["Srho"] * g.V,
            m.internal_coeffs,
            m.boundary_coeffs,
            m.psi,
        )
        res = self._solve_p_rgh(m, p_rgh.i, final)
        info = {"res0": res.initial_residual, "iters": res.n_iterations}

        # boundary update + flux reconstruction
        p_rgh_b = f * rv + (1.0 - f) * (g.cell_to_boundary(res.x) + rg / g.b_dc)
        p_rgh_new = VolField(res.x, p_rgh_b)
        lap_flux = fvm.FvMatrix(
            g, m_lap.diag, m_lap.lower, m_lap.upper, m_lap.source,
            m_lap.internal_coeffs, m_lap.boundary_coeffs, p_rgh_new,
        ).flux()
        if corr is not None:
            # p_rghEqn.flux() carries the deferred correction's face flux
            # (fvMatrix::flux adds faceFluxCorrectionPtr), so phi balances
            # the equation just solved. The JAX package leaves it out; on a
            # non-orthogonal mesh its phi then breaks continuity and the
            # wall fire diverges (ROADMAP, reference fault R3)
            lap_flux = SurfaceField(lap_flux.i + rho_rAU_f.i * g.magSf * corr, lap_flux.b)
        phi_new = SurfaceField(phi_hbya.i - lap_flux.i, phi_hbya.b - lap_flux.b)

        # velocity correction; U.correctBoundaryConditions() (pEqn.H:46)
        # re-applies the UEqn-time coefficients
        corr_flux = SurfaceField(
            (phig.i - lap_flux.i) / rho_rAU_f.i, (phig.b - lap_flux.b) / rho_rAU_f.b
        )
        U_new_i = HbyA.i + rAU[:, None] * fvc.reconstruct(g, corr_flux)
        U_new = bcmod.apply_coeffs(g, VolField(U_new_i, state["U"].b), *ubc_coeffs)
        if metered:
            ub = U_new.b.clone()
            for sl, u_met in metered:
                ub[sl] = u_met
            U_new = VolField(U_new.i, ub)

        # p = p_rgh + rho·gh + pRef (rho = thermo.rho() from the corrector
        # start, pEqn.H:52)
        p_new = VolField(
            p_rgh_new.i + rho.i * self.gh + self.p_ref,
            p_rgh_new.b + rho.b * self.ghf_b + self.p_ref,
        )
        psi_new = state["psi"]
        # rhoEqn.H after the p update: the carried rho is the conservative
        # continuity solution (pEqn.H:55)
        rho_cont = state["rho_old_i"] - dt * (fvc.div_flux(g, phi_new) - srcs["Srho"])
        rho_new = VolField(rho_cont, psi_new.b * p_new.b)
        thermo_rho = psi_new.i * p_new.i
        total_mass = g.rsum(rho_cont * g.V)
        info["cont_local"] = g.rsum(torch.abs(rho_cont - thermo_rho) * g.V) / total_mass
        info["cont_global"] = g.rsum((rho_cont - thermo_rho) * g.V) / total_mass
        return p_rgh_new, p_new, rho_new, phi_new, U_new, info

    def _solve_p_rgh(self, m, x0, final: bool):
        """The p_rgh solve of one corrector: the Jacobi-CG, with
        `p_rgh_f64` in float64 inside a float32 step. The tolerances are
        p_rghFinal's on the last corrector; solver, preconditioner and
        maxIter are p_rgh's. On the card it stops at the dictionary's
        maxIter, as the port's K2 does; on the CPU (and on SEG) at 1000, as
        the JAX package's flat CG does."""
        g = self.geom
        c0 = _solver_controls(self.fv_solution, "p_rgh")
        c = _solver_controls(self.fv_solution, "p_rghFinal", "p_rgh") if final else c0
        tol, rel = c["tolerance"], c["relTol"]
        fused = self.device.type == "cuda" and g.layout == "dia"
        cg_max_iter = c0["maxIter"] if fused else 1000
        dtot, b = m.totals()
        if self.p_rgh_f64 and self.dtype != torch.float64:
            # the tolerances pass through the step's dtype first
            tol, rel = (float(torch.tensor(v, dtype=self.dtype)) for v in (tol, rel))
            f8 = torch.float64
            res = solve_ldu(
                g, "PCG", dtot.to(f8), m.upper.to(f8), m.lower.to(f8), b.to(f8), x0.to(f8),
                tol=tol, rel_tol=rel, max_iter=cg_max_iter,
            )
            return res._replace(x=res.x.to(self.dtype))
        return solve_ldu(g, "PCG", dtot, m.upper, m.lower, b, x0, tol=tol, rel_tol=rel,
                         max_iter=cg_max_iter)

    def _no_sources(self) -> Dict:
        """The gas sources of the regions this copy leaves out: zero."""
        g = self.geom
        kw = dict(dtype=self.dtype, device=self.device)
        return {
            "Srho": torch.zeros(g.n_cells, **kw),
            "SU": torch.zeros((g.n_cells, 3), **kw),
            "SYv": torch.zeros(g.n_cells, **kw),
            "Sh": torch.zeros(g.n_cells, **kw),
        }

    def step(self, state: Dict) -> Tuple[Dict, Dict]:
        """One full time step."""
        g = self.geom
        log: Dict[str, torch.Tensor] = {}
        state = dict(state)
        dt = state["dt"]

        # Courant as the reference prints it: before setDeltaT, with the
        # previous step's dt
        dt_prev = state.get("_dt_prev", dt)
        log["CoNum"] = self.courant(state) * (dt_prev / dt)
        log["CoMean"] = self.courant_mean(state) * (dt_prev / dt)
        state["_dt_prev"] = dt
        # boundary phi the species equations see now: the lagged refValue
        # gate of the next step's species inlet BCs
        phi_b_species = state["phi"].b
        srcs = self._no_sources()
        srcs["_ov"] = {}

        # ---- rhoEqn (diagonal) ----
        rho_i = state["rho_old_i"] - dt * fvc.div_flux(g, state["phi"]) + dt * srcs["Srho"]
        state["rho"] = VolField(rho_i, state["rho"].b)

        for _ in range(self.ctl.n_outer):
            U_new, u_matrix, ubc_coeffs = self._u_eqn(state, log, srcs)
            state["U"] = U_new

            # species + energy share one multivariate weight field, frozen
            # before the Yi solves (YEEqn.H:1-10)
            w_mv = self._multivariate_weights(state)
            Y_new, qdot = self._y_eqns(state, log, srcs, w_mv)
            state["Qdot"] = qdot

            # radiation: first step + every solverFreq steps, after combustion
            if self.radiation is not None:
                state["rad"] = self.radiation.maybe_correct(state, self.gas)
                if getattr(self.radiation, "failed_rows", None) is not None:
                    # fvDOM's ray rows left unsolved this step (ROADMAP R18)
                    log["rad_failedRows"] = self.radiation.failed_rows
            hs_new, T_new, psi_new, mu_new, alpha_new = self._e_eqn(
                state, Y_new, qdot, log, srcs, w_mv
            )
            state["Y"] = Y_new
            state["hs"] = hs_new
            state["T"] = T_new
            state["psi"] = psi_new
            state["mu"] = mu_new
            state["alpha"] = alpha_new
            log["T_min"] = torch.minimum(g.rmin(T_new.i), g.bmin(T_new.b))
            log["T_max"] = torch.maximum(g.rmax(T_new.i), g.bmax(T_new.b))

            # ---- pressure correctors ----
            n_corr = self.ctl.n_correctors
            base_state = dict(state)
            carry = (state["p_rgh"], state["p"], state["rho"], state["phi"], state["U"])
            for c in range(n_corr):
                st2 = dict(base_state)
                (st2["p_rgh"], st2["p"], st2["rho"], st2["phi"], st2["U"]) = carry
                *fields, info = self._p_eqn(st2, u_matrix, c == n_corr - 1, srcs, ubc_coeffs)
                carry = tuple(fields)
                log[f"p_rgh_res0_{c}"] = info["res0"]
                log[f"p_rgh_iters_{c}"] = info["iters"]
                log[f"cont_local_{c}"] = info["cont_local"]
                log[f"cont_global_{c}"] = info["cont_global"]
            (state["p_rgh"], state["p"], state["rho"], state["phi"], state["U"]) = carry
            state["dpdt"] = (state["p"].i - state["p_old_i"]) / dt

            # ---- turbulence ----
            ctx = self._ctx(state, srcs.get("_ov"))
            ctl_k = _solver_controls(self.fv_solution, "k", "kFinal")
            k_new, nut_i, res_k = self.turb.correct(
                state["k"], self.k_bcs, state["U"], state["rho"],
                state["rho_old_i"], state["phi"], state["mu"], dt, ctx, ctl_k,
            )
            state["k"] = k_new
            nut_b = self.turb.nut_b(k_new.b)
            state["nut"] = VolField(nut_i, nut_b)
            state["alphat"] = VolField(
                state["rho"].i * nut_i / self.turb.Prt,
                state["rho"].b * nut_b / self.turb.Prt,
            )
            # the wall functions: the fire alphat first, then the nut family
            # (nutFire consumes the fire-corrected alphat), then
            # compressible::alphatWallFunction from the new nut
            state = self._apply_wall_functions(state)
            nut_b = self._nut_wall_functions(state, k_new, nut_b)
            state["nut"] = VolField(nut_i, nut_b)
            alphat_b = state["alphat"].b
            for bc, p in zip(self.alphat_bcs.bcs, g.patches):
                if bc.kind == "compressible::alphatWallFunction":
                    if alphat_b is state["alphat"].b:
                        alphat_b = alphat_b.clone()
                    alphat_b[p.slice] = state["rho"].b[p.slice] * nut_b[p.slice] / self.turb.Prt
            state["alphat"] = VolField(state["alphat"].i, alphat_b)
            log["k_res0"] = res_k.initial_residual
            log["k_iters"] = res_k.n_iterations

        # ---- advance time, choose next dt ----
        state["rhoU_old_i"] = state["rho"].i[:, None] * state["U"].i
        state["rho_old_i"] = state["rho"].i
        state["p_old_i"] = state["p"].i
        state["psi_old_i"] = state["psi"].i
        state["p_rgh_old_i"] = state["p_rgh"].i
        state["phi_old_i"] = state["phi"].i
        state["K_old_i"] = 0.5 * torch.sum(state["U"].i * state["U"].i, dim=1)
        state["_phi_b_prev"] = phi_b_species
        state["t"] = state["t"] + dt
        if self.ctl.adjust:
            state["dt"] = self.new_dt(state)
        log["Qdot_total"] = g.rsum(state["Qdot"] * g.V)
        log["Qdot_max"] = g.rmax(state["Qdot"])
        for pch in g.patches:
            if pch.name == "burner":
                log["burner_influx"] = -g.bsum(state["phi"].b, pch.slice)
                log["burner_rho_b"] = g.bmean(state["rho"].b, pch.slice)
                log["burner_Yfuel_b"] = torch.mean(
                    state["Y"].b[pch.slice, self.reaction.fuel_index]
                )
        log["HRR"] = log["Qdot_total"] / 1e3  # kW
        log["k_max"] = g.rmax(state["k"].i)
        log["T_max_int"] = g.rmax(state["T"].i)
        log["T_max_b"] = g.bmax(state["T"].b)
        log["U_max"] = g.rmax(torch.linalg.norm(state["U"].i, dim=1))
        y_min = g.rminc(state["Y"].i)
        y_ave = g.rmeanc(state["Y"].i)
        y_max = g.rmaxc(state["Y"].i)
        for s, sp in enumerate(self.species):
            log[f"Y_{sp}_min"] = y_min[s]
            log[f"Y_{sp}_ave"] = y_ave[s]
            log[f"Y_{sp}_max"] = y_max[s]
        log["t"] = state["t"]
        log["dt"] = dt
        return state, log

    # ------------------------------------------------------------------
    def _apply_wall_functions(self, state: Dict) -> Dict:
        """alphatFireWallFunction: the gas-side turbulent thermal
        diffusivity on burning walls from the QcWallFunction flame-heat-flux
        correlation (alphatFireWallFunctionFvPatchScalarField.C:218-249):
          qwL = −α_w·Cp_w·∂T/∂n  (laminar flux into the wall)
          ṁ″ = −φ_w/|Sf|·2.5·1000 [g/m²/s fuel-equivalent]
          qw = ṁ″<0.1 ? clamp(qwL,0,QcThr)/QcThr·QcFlame
                       : QcFlame·(ṁ″/10)/(e^{ṁ″/10}−1)
          alphat_w = min(1, qw/(Cp_w·(−∂T/∂n)) − α_w)."""
        g = self.geom
        fire = [(bc, p) for bc, p in zip(self.alphat_bcs.bcs, g.patches)
                if bc.kind == "alphatFireWallFunction"]
        if not fire:
            return state
        state = dict(state)
        T, Y = state["T"], state["Y"]
        alphat_b = state["alphat"].b.clone()
        tiny = torch.finfo(self.dtype).tiny * 1e6
        T_c = g.cell_to_boundary(T.i)
        for bc, p in fire:
            sl = p.slice
            cp_w = self.gas.cp(T.b[sl], Y.b[sl])
            alpha_w = state["alpha"].b[sl]
            grad_tw = g.b_dc[sl] * (T.b[sl] - T_c[sl])
            qwl = -alpha_w * cp_w * grad_tw
            fmf = -state["phi"].b[sl] / g.b_magSf[sl] * 2.5 * 1000.0
            qc_flame = float(bc.params.get("QcFlame", 20000.0))
            qc_thr = float(bc.params.get("QcThreshold", 2000.0))
            expn = torch.clamp(fmf / 10.0, max=50.0)
            qw = torch.where(
                fmf < 0.1,
                torch.clamp(qwl, 0.0, qc_thr) / qc_thr * qc_flame,
                qc_flame * (fmf / 10.0) / torch.clamp(torch.expm1(expn), min=tiny),
            )
            a_eff = qw / cp_w / torch.clamp(-grad_tw, min=tiny)
            a_t = torch.clamp(a_eff - alpha_w, max=1.0)
            alphat_b[sl] = torch.where(qwl <= tiny, torch.zeros_like(a_t), a_t)
        state["alphat"] = VolField(state["alphat"].i, alphat_b)
        return state

    def _nut_wall_functions(self, state: Dict, k_new, nut_b) -> torch.Tensor:
        """The nut wall-function family:

        * nutkWallFunction: log-law from k, y⁺ = Cμ^¼√k·y/ν,
          νt = ν·(y⁺κ/ln(Ey⁺) − 1) above the laminar y⁺;
        * nutUSpaldingWallFunction: u_τ from Spalding's law (spalding_utau),
          νt = u_τ²/|∂U/∂n| − ν;
        * nutUSpaldingBlowingWallFunction: the same u_τ attenuated by the
          transpiration factor min(1, (ṁ″/hOCp)/(e^{ṁ″/hOCp}−1));
        * nutFireWallFunction: νt = αt·ν/α from the fire-corrected alphat."""
        g = self.geom
        kinds = {"nutkWallFunction", "nutUSpaldingWallFunction",
                 "nutUSpaldingBlowingWallFunction", "nutFireWallFunction"}
        wf = [(bc, p) for bc, p in zip(self.nut_bcs.bcs, g.patches) if bc.kind in kinds]
        if not wf:
            return nut_b
        kappa, E, cmu25 = 0.41, 9.8, 0.09 ** 0.25
        ypl = 11.0  # yPlusLam: the fixed point of y⁺ = ln(E y⁺)/κ
        for _ in range(10):
            ypl = np.log(E * ypl) / kappa
        U, rho, mu = state["U"], state["rho"], state["mu"]
        tiny = torch.finfo(self.dtype).tiny * 1e6
        nut_b = nut_b.clone()
        for bc, p in wf:
            sl = p.slice
            nuw = mu.b[sl] / rho.b[sl]
            y = 1.0 / g.b_dc[sl]
            if bc.kind == "nutkWallFunction":
                k_c = g.cell_to_boundary(k_new.i)[sl]
                yp = cmu25 * torch.sqrt(torch.clamp(k_c, min=0.0)) * y / nuw
                val = torch.where(
                    yp > ypl,
                    nuw * (yp * kappa / torch.log(torch.clamp(E * yp, min=1.0 + 1e-12)) - 1.0),
                    torch.zeros_like(yp),
                )
            elif bc.kind == "nutFireWallFunction":
                val = state["alphat"].b[sl] * nuw / torch.clamp(state["alpha"].b[sl], min=tiny)
            else:  # nutUSpalding[Blowing]
                du = g.cell_to_boundary(U.i)[sl] - U.b[sl]
                mag_up = torch.linalg.norm(du, dim=1)
                mag_grad = mag_up * g.b_dc[sl]
                ut = spalding_utau(mag_up, mag_grad, nuw, y, kappa, E)
                val = ut ** 2 / torch.clamp(mag_grad, min=tiny)
                if bc.kind == "nutUSpaldingBlowingWallFunction":
                    h_ocp = float(bc.params.get("hOCp", 10.0))
                    r_phi = float(bc.params.get("rPhi", 2.5))
                    x = -state["phi"].b[sl] / g.b_magSf[sl] * r_phi * 1000.0 / h_ocp
                    atten = torch.clamp(
                        (x + 1e-15) / (torch.expm1(torch.clamp(x, -50.0, 50.0)) + 1e-15), max=1.0)
                    val = val * atten
                val = val - nuw
            nut_b[sl] = torch.clamp(val, min=0.0)
        return nut_b

    # ------------------------------------------------------------------
    def make_step(self):
        """The step function (eager: PyTorch needs no trace)."""
        return self.step

    def make_chunk(self, n: int):
        """A function running n steps; returns (final_state, logs) with every
        log entry stacked along a leading [n] axis."""

        def chunk(state):
            logs = []
            for _ in range(n):
                state, log = self.step(state)
                logs.append(log)
            return state, {k: torch.stack([lg[k] for lg in logs]) for k in logs[0]}

        return chunk


# ----------------------------------------------------------------------
# State exchange with numpy (and through it, with the JAX package)
# ----------------------------------------------------------------------
def _is_field(x) -> bool:
    return isinstance(x, tuple) and getattr(x, "_fields", None) == ("i", "b")


def state_from_numpy(d, device=None, dtype=None):
    """The port's state from a numpy state dict — e.g. the JAX package's
    state after `jax.device_get`. VolField/SurfaceField (i, b) pairs of
    either package map onto the port's classes; lists (the cloud's
    per-injector and per-collector states) stay lists; floating leaves
    take `dtype`, booleans stay bool, uint32 leaves (random keys) stay
    uint32 on the host (lagrangian/prng.py), other integer leaves become
    int32."""
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or real_dtype(device)

    def conv(x):
        if _is_field(x):
            cls = SurfaceField if type(x).__name__ == "SurfaceField" else VolField
            return cls(conv(x.i), conv(x.b))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        a = np.asarray(x)
        if a.dtype == np.bool_:
            return torch.as_tensor(a, device=device)
        if a.dtype == np.uint32:
            return torch.as_tensor(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int32), device=device)
        return torch.as_tensor(a.astype(np.float64), dtype=dtype, device=device)

    return {k: conv(v) for k, v in d.items()}


def state_to_numpy(state):
    """The reverse of state_from_numpy: numpy leaves, fields as the port's
    (i, b) NamedTuples."""

    def conv(x):
        if _is_field(x):
            return type(x)(conv(x.i), conv(x.b))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x.detach().cpu().numpy()

    return {k: conv(v) for k, v in state.items()}
