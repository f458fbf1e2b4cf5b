"""Boundary conditions in canonical mixed form.

Every fvPatchField kind is expressed as (refValue, refGrad, valueFraction)
per boundary face:

    face value = f·refValue + (1−f)·(x_own + refGrad/deltaCoeff)
    snGrad     = f·deltaCoeff·(refValue − x_own) + (1−f)·refGrad

which is OpenFOAM's mixedFvPatchField identity; fixedValue is f=1,
zeroGradient/fixedGradient are f=0. Matrix coefficients derive from the
same three arrays (ops.fvm.mixed_value_coeffs/mixed_gradient_coeffs).

The port carries every kind of the JAX package's registry that needs no
region model: fixedValue, zeroGradient, fixedGradient, calculated, noSlip,
inletOutlet, outletInlet, fixedFluxPressure, flowRateInletVelocity (a
constant or tabled massFlowRate), pressureInletOutletVelocity,
totalFlowRateAdvectiveDiffusive, nonUniFlowRateAdvectiveDiffusive,
fixedEnthalpyFluxTemperature, prghTotalHydrostaticPressure, empty,
symmetry, symmetryPlane, slip, compressible::thermalBaffle1D<h|e…>, the
wall-function placeholders (their values are set by the solver's
wall-function pass, alphatFilmWallFunction included), greyDiffusiveRadiation,
and the kinds coupled to a pyrolysis or film region: the gas side of the
conjugate wall (turbulentTemperatureRadiation*Coupled*,
filmPyrolysisTemperatureCoupled, rollPaperTwoZoneST),
flowRateInletVelocityPyrolysisCoupled (and FuelConvertCoupled) and
filmPyrolysisVelocityCoupled, whose values the solver supplies each step
through ctx["overrides"].

Dynamic inputs (fluxes, gradients set by pEqn) come through a `ctx` dict;
static parameters live in the BC's params.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..io.fields import FieldFile
from ..io.foamdict import FoamDict
from .fields import VolField
from .geometry import MeshGeometry, PatchInfo

__all__ = ["BC", "FieldBCs", "make_field_bcs", "resolve", "evaluate", "apply_coeffs",
           "initial_boundary", "mass_flow_rate"]


@dataclass(frozen=True)
class BC:
    kind: str
    patch: str
    params: dict  # static parameters


@dataclass(frozen=True)
class FieldBCs:
    field: str
    bcs: Tuple[BC, ...]  # one per patch, in geometry patch order
    n_components: int = 1


def _kw(psi_i):
    return dict(dtype=psi_i.dtype, device=psi_i.device)


def _full(p: PatchInfo, val, ncomp, psi_i):
    shape = (p.n,) if ncomp == 1 else (p.n, ncomp)
    arr = torch.as_tensor(np.asarray(val, np.float64), **_kw(psi_i))
    return torch.broadcast_to(arr, shape).clone()


def _zeros(p, ncomp, psi_i):
    return torch.zeros((p.n,) if ncomp == 1 else (p.n, ncomp), **_kw(psi_i))


def _fcol(f, ncomp):
    """valueFraction broadcast: scalar-per-face f for vector fields."""
    if ncomp > 1 and f.ndim == 1:
        return torch.broadcast_to(f[:, None], (f.shape[0], ncomp))
    return f


def _phi_b(ctx, p: PatchInfo):
    return ctx["phi"].b[p.slice]


# ---------------------------------------------------------------------------
# kind implementations: fn(bc, p, geom, psi_i, psi_b, ctx, ncomp)
#   → (refValue, refGrad, valueFraction) for the patch
# ---------------------------------------------------------------------------

def _fixed_value(bc, p, geom, psi_i, psi_b, ctx, nc):
    v = _full(p, bc.params.get("value", 0.0), nc, psi_i)
    return v, _zeros(p, nc, psi_i), _fcol(torch.ones((p.n,), **_kw(psi_i)), nc)


def _zero_gradient(bc, p, geom, psi_i, psi_b, ctx, nc):
    z = _zeros(p, nc, psi_i)
    return z, z, _fcol(torch.zeros((p.n,), **_kw(psi_i)), nc)


def _fixed_gradient(bc, p, geom, psi_i, psi_b, ctx, nc):
    g = ctx.get("overrides", {}).get((ctx.get("_field"), p.name, "gradient"))
    if g is None:
        g = _full(p, bc.params.get("gradient", 0.0), nc, psi_i)
    return _zeros(p, nc, psi_i), g, _fcol(torch.zeros((p.n,), **_kw(psi_i)), nc)


def _symmetry(bc, p, geom, psi_i, psi_b, ctx, nc):
    """symmetry/symmetryPlane/slip: scalars mirror as zero-gradient;
    vectors keep the tangential component through the diagonal
    valueFraction f = n̂_k² with refValue 0 (exact for axis-aligned planes,
    the diagonal approximation of the direction-mixed fraction otherwise)."""
    if nc == 1:
        return _zero_gradient(bc, p, geom, psi_i, psi_b, ctx, nc)
    n = geom.b_Sf[p.slice] / geom.b_magSf[p.slice, None]
    return _zeros(p, nc, psi_i), _zeros(p, nc, psi_i), n * n


def _calculated(bc, p, geom, psi_i, psi_b, ctx, nc):
    # value maintained externally (stored boundary values)
    return psi_b[p.slice], _zeros(p, nc, psi_i), _fcol(torch.ones((p.n,), **_kw(psi_i)), nc)


def _inlet_outlet(bc, p, geom, psi_i, psi_b, ctx, nc):
    phi = _phi_b(ctx, p)
    f = (~(phi > 0.0)).to(psi_i.dtype)  # outflow → zeroGradient
    iv = _full(p, bc.params.get("inletValue", 0.0), nc, psi_i)
    return iv, _zeros(p, nc, psi_i), _fcol(f, nc)


def _outlet_inlet(bc, p, geom, psi_i, psi_b, ctx, nc):
    phi = _phi_b(ctx, p)
    f = (phi > 0.0).to(psi_i.dtype)  # inflow → zeroGradient
    ov = _full(p, bc.params.get("outletValue", 0.0), nc, psi_i)
    return ov, _zeros(p, nc, psi_i), _fcol(f, nc)


def _no_slip(bc, p, geom, psi_i, psi_b, ctx, nc):
    return _zeros(p, nc, psi_i), _zeros(p, nc, psi_i), _fcol(torch.ones((p.n,), **_kw(psi_i)), nc)


def _flow_rate_inlet_velocity(bc, p, geom, psi_i, psi_b, ctx, nc):
    """U = −n̂ · (ṁ / (ρ_b ΣA)) uniform over the patch (extrapolateProfile
    false); ṁ constant or tabled against the time."""
    t = ctx.get("t")
    mdot = mass_flow_rate(bc, t if t is not None else torch.zeros((), **_kw(psi_i)))
    rho_b = ctx["rho"].b[p.slice]
    A = geom.bsum(geom.b_magSf, p.slice)
    n = geom.b_Sf[p.slice] / geom.b_magSf[p.slice, None]
    u = -n * (mdot / (rho_b * A))[:, None]
    return u, _zeros(p, nc, psi_i), _fcol(torch.ones((p.n,), **_kw(psi_i)), nc)


def _pressure_inlet_outlet_velocity(bc, p, geom, psi_i, psi_b, ctx, nc):
    """Outflow: zeroGradient. Inflow: tangential components fixed to zero
    (valueFraction = diag(I − n⊗n))."""
    phi = _phi_b(ctx, p)
    n = geom.b_Sf[p.slice] / geom.b_magSf[p.slice, None]
    inflow = (phi < 0.0).to(psi_i.dtype)
    f = inflow[:, None] * (1.0 - n * n)
    return _zeros(p, nc, psi_i), _zeros(p, nc, psi_i), f


def _total_flow_rate_adv_diff(bc, p, geom, psi_i, psi_b, ctx, nc):
    """totalFlowRateAdvectiveDiffusive (species inlet): valueFraction =
    1/(1 + α_b·Δc / max(|phi|/A, small)); the refValue lags the flux by one
    step (gated by the previous step's boundary flux)."""
    phi = _phi_b(ctx, p)
    alpha_b = ctx.get("alphaEff_b")
    if alpha_b is None:
        alpha_b = torch.zeros((geom.n_boundary,), **_kw(psi_i))
    a = alpha_b[p.slice]

    def frac(ph):
        per_area = torch.clamp(torch.abs(ph) / geom.b_magSf[p.slice], min=1e-30)
        return 1.0 / (1.0 + a * geom.b_dc[p.slice] / per_area)

    f = frac(phi)
    # a scalar, or per face (nonUniFlowRateAdvectiveDiffusive)
    mf = torch.as_tensor(np.asarray(bc.params.get("massFluxFraction", 0.0), np.float64),
                         **_kw(psi_i))
    phi_prev = ctx.get("phi_prev_b")
    gate = torch.ones_like(f) if phi_prev is None else frac(phi_prev[p.slice])
    return mf * gate, _zeros(p, nc, psi_i), f


def _fixed_enthalpy_flux_T(bc, p, geom, psi_i, psi_b, ctx, nc):
    """fixedEnthalpyFluxTemperature: gas T mixed BC whose valueFraction
    balances advective against diffusive enthalpy flux,
    f = 1/(1 + αEff·Δc·A/max(|φ|, small)): the dictionary's refValue where
    advection dominates, zero gradient where diffusion does."""
    phi = _phi_b(ctx, p)
    alpha_b = ctx.get("alphaEff_b")
    if alpha_b is None:
        alpha_b = torch.zeros((geom.n_boundary,), **_kw(psi_i))
    f = 1.0 / (1.0 + alpha_b[p.slice] * geom.b_dc[p.slice] * geom.b_magSf[p.slice]
               / torch.clamp(torch.abs(phi), min=1e-30))
    rv = bc.params.get("refValue", bc.params.get("value", None))
    if rv is None:
        rv = psi_b[p.slice]
    else:
        rv = torch.broadcast_to(
            torch.as_tensor(np.asarray(rv, np.float64), **_kw(psi_i)).reshape(-1), (p.n,))
    return rv, _zeros(p, nc, psi_i), f


def _thermal_baffle_1d(bc, p, geom, psi_i, psi_b, ctx, nc):
    """compressible::thermalBaffle1D<solidType> on T: 1-D steady conduction
    through a thin solid baffle between this patch and its samplePatch, with
    a per-side surface heat source Qs/2 (thermalBaffle1DFvPatchScalarField::
    updateCoeffs):

        KΔs   = κ_solid / thickness
        α     = KΔs − (Qs/2)/T_w            (source linearised in T_w)
        f     = α / (α + κ_eff,gas·Δc)
        refV  = (KΔs·T_nbr,face + Qs/2) / α

    T_nbr,face is the sample patch's stored face value from the previous
    update (both sides read each other's old values)."""
    Tp = psi_b[p.slice]
    T_nbr = psi_b.index_select(0, bc.params["nbr_idx"])
    KDs = float(bc.params.get("kappa", 1.0)) / float(bc.params.get("thickness", 1e-3))
    qs = float(bc.params.get("Qs", 0.0)) / 2.0
    kappa_eff = ctx.get("kappaEff_b")
    if kappa_eff is None:
        kappa_eff = torch.zeros((geom.n_boundary,), **_kw(psi_i))
    my_kdelta = kappa_eff[p.slice] * geom.b_dc[p.slice]
    alpha = KDs - qs / Tp
    return (KDs * T_nbr + qs) / alpha, _zeros(p, nc, psi_i), alpha / (alpha + my_kdelta)


def _prgh_total_hydrostatic(bc, p, geom, psi_i, psi_b, ctx, nc):
    """p_rgh = ph_rgh − ½ρ|U|² on inflow, ph_rgh on outflow (fixedValue)."""
    phi = _phi_b(ctx, p)
    ph = ctx.get("ph_rgh_b")
    ph = ph[p.slice] if ph is not None else torch.zeros((p.n,), **_kw(psi_i))
    rho_b = ctx["rho"].b[p.slice]
    U_b = ctx["U"].b[p.slice]
    magsqr = torch.sum(U_b * U_b, dim=-1)
    inflow = (phi < 0.0).to(psi_i.dtype)
    v = ph - 0.5 * rho_b * inflow * magsqr
    return v, _zeros(p, nc, psi_i), torch.ones((p.n,), **_kw(psi_i))



def _coupled_wall_T(bc, p, geom, psi_i, psi_b, ctx, nc):
    """The gas side of the conjugate wall (the fluid branch of
    turbulentTemperatureRadiationQinCoupledMixed, lib/fvPatchFieldsPyrolysis/
    ...C:210-218): Dirichlet T_wall = the neighbour region's surface T,
    supplied each step through ctx overrides; the stored boundary value
    before the coupling is active."""
    v = ctx.get("overrides", {}).get((ctx.get("_field"), p.name, "value"))
    if v is None:
        v = psi_b[p.slice]
    return v, _zeros(p, nc, psi_i), _fcol(torch.ones((p.n,), **_kw(psi_i)), nc)


def _flow_rate_pyro_coupled(bc, p, geom, psi_i, psi_b, ctx, nc):
    """flowRateInletVelocityPyrolysisCoupled: the inlet velocity from the
    neighbour pyrolysis region's fuel-equivalent pyrolysate flux
    (phiGas·hocPyr/qFuel [kg/s] per face, ctx overrides)."""
    mdot = ctx.get("overrides", {}).get(("U", p.name, "mdot"))
    one = _fcol(torch.ones((p.n,), **_kw(psi_i)), nc)
    if mdot is None:
        return _zeros(p, nc, psi_i), _zeros(p, nc, psi_i), one
    rho_b = ctx["rho"].b[p.slice]
    n = geom.b_Sf[p.slice] / geom.b_magSf[p.slice, None]
    u = -n * (mdot / (rho_b * geom.b_magSf[p.slice]))[:, None]
    return u, _zeros(p, nc, psi_i), one


def _film_velocity_coupled(bc, p, geom, psi_i, psi_b, ctx, nc):
    """filmPyrolysisVelocityCoupled: the FM fork pins the gas velocity to the
    film surface velocity (ctx overrides ('U', patch, 'value')); without it,
    the pyrolysate inflow of _flow_rate_pyro_coupled."""
    v = ctx.get("overrides", {}).get(("U", p.name, "value"))
    if v is not None:
        return v, _zeros(p, nc, psi_i), _fcol(torch.ones((p.n,), **_kw(psi_i)), nc)
    return _flow_rate_pyro_coupled(bc, p, geom, psi_i, psi_b, ctx, nc)

_REGISTRY: Dict[str, Callable] = {
    "fixedValue": _fixed_value,
    "zeroGradient": _zero_gradient,
    "fixedGradient": _fixed_gradient,
    "calculated": _calculated,
    "inletOutlet": _inlet_outlet,
    "outletInlet": _outlet_inlet,
    "noSlip": _no_slip,
    "fixedFluxPressure": _fixed_gradient,
    "flowRateInletVelocity": _flow_rate_inlet_velocity,
    "pressureInletOutletVelocity": _pressure_inlet_outlet_velocity,
    "totalFlowRateAdvectiveDiffusive": _total_flow_rate_adv_diff,
    # per-face massFluxFraction variant (the same mixed fractions)
    "nonUniFlowRateAdvectiveDiffusive": _total_flow_rate_adv_diff,
    "fixedEnthalpyFluxTemperature": _fixed_enthalpy_flux_T,
    "prghTotalHydrostaticPressure": _prgh_total_hydrostatic,
    "empty": _zero_gradient,
    "symmetry": _symmetry,
    "symmetryPlane": _symmetry,
    "slip": _symmetry,  # slipFvPatchField == symmetry transform for vectors
    # wall functions: values computed by the solver's wall-function pass
    # each step and kept in the stored boundary array
    "compressible::alphatWallFunction": _calculated,
    "alphatFireWallFunction": _calculated,
    "nutFireWallFunction": _calculated,
    "nutUSpaldingBlowingWallFunction": _calculated,
    "nutkWallFunction": _calculated,
    "nutUSpaldingWallFunction": _calculated,
    "kqRWallFunction": _zero_gradient,
    "compressible::thermalBaffle1D<hConstSolidThermoPhysics>": _thermal_baffle_1d,
    "compressible::thermalBaffle1D<eConstSolidThermoPhysics>": _thermal_baffle_1d,
    # walls seen by fvDOM: the radiation module reads the emissivity; the
    # intensity field itself keeps its stored boundary values
    "greyDiffusiveRadiation": _calculated,
    # conjugate gas↔solid coupling (pyrolysis and film regions)
    "compressible::turbulentTemperatureRadiationQinCoupledMixed": _coupled_wall_T,
    "compressible::turbulentTemperatureRadiationQinQcScaleCoupledMixed": _coupled_wall_T,
    "compressible::turbulentTemperatureRadiationQinQcWallFunctionCoupledMixed": _coupled_wall_T,
    "compressible::turbulentTemperatureRadiationCoupledMixedST": _coupled_wall_T,
    "compressible::turbulentTemperatureRadiationCoupledQcWallFunctionMixedST": _coupled_wall_T,
    "compressible::turbulentTemperatureRadiativeCoupledMixedST": _coupled_wall_T,
    "compressible::turbulentTemperatureRadiativeCoupledQcWallFunctionMixedST": _coupled_wall_T,
    "compressible::turbulentTemperatureRadCoupledMixed": _coupled_wall_T,
    "filmPyrolysisTemperatureCoupled": _coupled_wall_T,
    # roll-paper back-to-back coupling (rollPaperTwoZoneST, fluid branch):
    # the solver's film overrides supply Twall
    "compressible::rollPaperTwoZoneST": _coupled_wall_T,
    "flowRateInletVelocityPyrolysisCoupled": _flow_rate_pyro_coupled,
    "flowRateInletVelocityFuelConvertCoupled": _flow_rate_pyro_coupled,
    "filmPyrolysisVelocityCoupled": _film_velocity_coupled,
    # gas-side αt over a wall film: set by the solver's wall-function pass
    "alphatFilmWallFunction": _calculated,
}


def mass_flow_rate(bc: BC, t: torch.Tensor) -> torch.Tensor:
    """flowRateInletVelocity's ṁ at time t: the constant, or the table
    interpolated piecewise-linearly (OpenFOAM Function1 'table', held at
    its end values outside it; jnp.interp's arithmetic)."""
    if "massFlowRate_table" not in bc.params:
        return torch.as_tensor(float(bc.params.get("massFlowRate", 0.0)), dtype=t.dtype,
                               device=t.device)
    table = bc.params["massFlowRate_table"]
    xp = torch.as_tensor(np.ascontiguousarray(table[:, 0]), dtype=t.dtype, device=t.device)
    fp = torch.as_tensor(np.ascontiguousarray(table[:, 1]), dtype=t.dtype, device=t.device)
    x = t.reshape(1)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.dtype(str(t.dtype)[6:])).eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (x - xp[i - 1]) / torch.where(
        dx0, torch.ones_like(dx), dx) * df)
    f = torch.where(x < xp[0], fp[0], f)
    f = torch.where(x > xp[-1], fp[-1], f)
    return f[0]


def resolve(fbcs: FieldBCs, geom: MeshGeometry, psi: VolField, ctx: dict):
    """Mixed coefficients (refValue, refGrad, f) for the whole boundary."""
    nc = fbcs.n_components
    ctx = dict(ctx)
    ctx["_field"] = fbcs.field
    rvs, rgs, fs = [], [], []
    for bc, p in zip(fbcs.bcs, geom.patches):
        rv, rg, f = _REGISTRY[bc.kind](bc, p, geom, psi.i, psi.b, ctx, nc)
        rvs.append(rv)
        rgs.append(rg)
        fs.append(_fcol(f, nc))
    return torch.cat(rvs), torch.cat(rgs), torch.cat(fs)


def apply_coeffs(geom: MeshGeometry, psi: VolField, rv, rg, f) -> VolField:
    """Refresh boundary values from already-resolved mixed coefficients
    (OpenFOAM updates BC coefficients once per step; later
    correctBoundaryConditions calls re-evaluate with the same ones)."""
    own_vals = geom.cell_to_boundary(psi.i)
    dc = geom.b_dc[:, None] if own_vals.ndim == 2 else geom.b_dc
    return VolField(psi.i, f * rv + (1.0 - f) * (own_vals + rg / dc))


def evaluate(fbcs: FieldBCs, geom: MeshGeometry, psi: VolField, ctx: dict) -> VolField:
    """Update boundary values from the mixed form (correctBoundaryConditions)."""
    return apply_coeffs(geom, psi, *resolve(fbcs, geom, psi, ctx))


# ---------------------------------------------------------------------------
# construction from case field files
# ---------------------------------------------------------------------------

def _param_value(pd: FoamDict, key: str):
    """Parse a BC parameter that may be `uniform x`, `uniform (x y z)`,
    a bare number, or a table."""
    v = pd.lookup(key, None)
    if v is None:
        return None
    if isinstance(v, list) and v and v[0] == "uniform":
        val = v[1]
        return np.asarray(val, np.float64) if isinstance(val, list) else float(val)
    if isinstance(v, list) and v and v[0] == "table":
        return ("table", np.asarray(v[-1], np.float64))
    if isinstance(v, list) and v and v[0] == "constant":
        return float(v[1])
    if isinstance(v, list) and v and v[0] == "nonuniform":
        return np.asarray(v[-1], np.float64)
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, list) and all(isinstance(x, (int, float)) for x in v):
        return np.asarray(v, np.float64)
    return v


def make_field_bcs(ff: FieldFile, geom: MeshGeometry) -> FieldBCs:
    """Build a FieldBCs from a parsed 0/ field file against a geometry."""
    ncomp = 3 if ff.is_vector else 1
    bcs: List[BC] = []
    for p in geom.patches:
        pd = ff.boundary.lookup(p.name, None)
        if pd is None:
            # defaultFaces-style patches fall back to zeroGradient
            bcs.append(BC("zeroGradient" if p.ptype != "empty" else "empty", p.name, {}))
            continue
        kind = str(pd.lookup("type"))
        if kind not in _REGISTRY:
            raise NotImplementedError(f"BC '{kind}' ({ff.name}/{p.name})")
        params = {}
        for key in ("value", "refValue", "inletValue", "outletValue", "gradient",
                    "massFluxFraction", "emissivity", "hocSolid", "hocPyr",
                    "QcFlame", "QcThreshold", "Tinf", "h", "QrIncident",
                    "hOCp", "rPhi", "filmDeltaDry", "filmDeltaWet",
                    "convectiveCoefficient", "convectiveScaling"):
            v = _param_value(pd, key)
            if v is not None and not isinstance(v, tuple):
                params[key] = v
        mfr = _param_value(pd, "massFlowRate")
        if isinstance(mfr, tuple) and mfr[0] == "table":
            params["massFlowRate_table"] = mfr[1]
        elif mfr is not None:
            params["massFlowRate"] = mfr
        if kind.startswith("compressible::thermalBaffle1D"):
            params["samplePatch"] = str(pd.lookup("samplePatch", ""))
            th = _param_value(pd, "thickness")
            if th is not None:
                params["thickness"] = float(np.mean(th)) if hasattr(th, "ndim") else float(th)
                params["owner"] = True
            qs = _param_value(pd, "Qs")
            if qs is not None:
                params["Qs"] = float(np.mean(qs)) if hasattr(qs, "ndim") else float(qs)
            tr = pd.lookup("transport", None)
            if tr is not None:
                params["kappa"] = float(tr.get_scalar("kappa", 1.0))
        bcs.append(BC(kind, p.name, params))
    _link_baffles(bcs, geom)
    return FieldBCs(field=ff.name, bcs=tuple(bcs), n_components=ncomp)


def _link_baffles(bcs: List[BC], geom: MeshGeometry):
    """thermalBaffle1D post-pass: map each baffle face to its samplePatch
    partner face (nearest face centre, on the host) and copy the solid
    properties from the owner side to the slave (the reference slave reads
    the owner's dictionary through mappedPatchBase)."""
    by_name = {b.patch: b for b in bcs}
    b_cf = None
    for i, bc in enumerate(bcs):
        if not bc.kind.startswith("compressible::thermalBaffle1D"):
            continue
        q = by_name.get(bc.params.get("samplePatch", ""))
        if q is None:
            continue
        if b_cf is None:
            b_cf = geom.b_Cf.double().cpu().numpy()
        pp, qq = geom.patch(bc.patch), geom.patch(q.patch)
        d2 = ((b_cf[pp.slice][:, None, :] - b_cf[qq.slice][None, :, :]) ** 2).sum(-1)
        params = dict(bc.params)
        params["nbr_idx"] = torch.as_tensor(np.argmin(d2, axis=1) + qq.start,
                                            dtype=torch.int64, device=geom.device)
        if not params.get("owner"):
            for k in ("thickness", "Qs", "kappa"):
                if k in q.params:
                    params[k] = q.params[k]
        bcs[i] = BC(bc.kind, bc.patch, params)


def initial_boundary(ff: FieldFile, geom: MeshGeometry, dtype, device) -> torch.Tensor:
    """Initial boundary-face values from the field file's per-patch `value`
    entries (falling back to the internal value)."""
    nc = 3 if ff.is_vector else 1
    out = []
    for p in geom.patches:
        pd = ff.boundary.lookup(p.name, None)
        val = None
        if pd is not None:
            val = _param_value(pd, "value")
            if val is None:
                val = _param_value(pd, "inletValue")
        if val is None:
            val = np.asarray(ff.internal) if not ff.internal_uniform else ff.internal
            if not ff.internal_uniform:
                val = val.mean(axis=0)
        arr = torch.as_tensor(np.asarray(val, np.float64), dtype=dtype, device=device)
        out.append(torch.broadcast_to(arr, (p.n,) if nc == 1 else (p.n, nc)))
    return torch.cat(out, dim=0)
