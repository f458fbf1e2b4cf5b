"""The port's solid-region modules against the JAX package's on the CPU in
float64, to 1e-10: tridiag_solve (and against a dense solve), SolidThermo and
SolidChemistry, one ReactingOneDim.evolve per model the collection accepts
(reactingOneDim, reactingOneDim21, reactingOneDim21CharOxi with the gas's O2,
the roll-paper family RPvol/RPvol2/RollPaper, moveMesh), every end BC
(coupled, fixedIncidentRadiation, constHTemperature, constHTemperatureRadiation
fixed and correlation), the diffusion number, PyroCUP's ledger over its
regimes, the collection's model selection ("none" builds no zone) and ROADMAP
R15. The
inputs come from firefoam_torch.utils.synthcase.write_panel_fire_case at
(8, 6, 7) and numpy draws from a seed."""

import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_torch.utils.synthcase import write_panel_fire_case

torch.set_num_threads(1)
TOL = 1e-10
N = (8, 6, 7)


def _rel(a, b, floor=1e-300):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b), initial=0.0) / max(np.max(np.abs(b), initial=0.0), floor))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(ours: dict, ref: dict, what, floor=1e-300):
    assert set(ours) == set(ref), (what, set(ours) ^ set(ref))
    for k in ref:
        assert _rel(_np(ours[k]), _np(ref[k]), floor) <= TOL, (what, k, _rel(_np(ours[k]),
                                                                          _np(ref[k]), floor))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from firefoam_torch.mesh import build_case_mesh as t_mesh
    from firefoam_tpu.mesh.case_mesh import build_case_mesh as j_mesh

    root = write_panel_fire_case(str(tmp_path_factory.mktemp("panel") / "case"), n=N)
    return root, j_mesh(root), t_mesh(root)


def _zone_dict(model, extra=""):
    text = (f"active true; pyrolysisModel {model}; regionName panelRegion;\n"
            f"{model}Coeffs {{ moveMesh false; minimumDelta 1e-6; {extra} }}\n")
    from firefoam_torch.io.foamdict import parse_string as tps
    from firefoam_tpu.io.foamdict import parse_string as jps

    return jps(text), tps(text)


def _zones(case, model, extra="", cls=None):
    from firefoam_torch.regionmodels import pyrocup as tpc
    from firefoam_torch.regionmodels import pyrolysis as tpy
    from firefoam_tpu.regionmodels import pyrocup as jpc
    from firefoam_tpu.regionmodels import pyrolysis as jpy

    root, jcm, tcm = case
    jd, td = _zone_dict(model, extra)
    if cls == "cup":
        return jpc.PyroCUP(root, jcm, jd, jnp.float64), tpc.PyroCUP(root, tcm, td, torch.float64)
    return (jpy.ReactingOneDim(root, jcm, jd, jnp.float64),
            tpy.ReactingOneDim(root, tcm, td, torch.float64))


def _with_T_bc(case, tmp_path, spec):
    """A copy of the case whose solid T has `spec` on its coupled side."""
    from firefoam_torch.mesh import build_case_mesh as t_mesh
    from firefoam_tpu.mesh.case_mesh import build_case_mesh as j_mesh

    root = str(tmp_path / "case")
    shutil.copytree(case[0], root)
    path = os.path.join(root, "0", "panelRegion", "T")
    with open(path) as f:
        txt = f.read()
    old = "type compressible::turbulentTemperatureRadiationQinCoupledMixed;"
    assert old in txt
    with open(path, "w") as f:
        f.write(txt.replace(old, spec))
    return root, j_mesh(root), t_mesh(root)


def _inputs(z, seed=0, o2=False):
    nF = z.region.n_faces
    rng = np.random.default_rng(seed)
    q = {"kDelta": rng.uniform(1.0, 20.0, nF), "T_nbr": rng.uniform(300.0, 1400.0, nF)}
    if o2:
        q["O2_nbr"] = rng.uniform(0.05, 0.23, nF)
        q["alphaDelta_O2"] = rng.uniform(1e-4, 1e-3, nF)
    qr = rng.uniform(0.0, 4e4, nF)
    jq = {k: jnp.asarray(v) for k, v in q.items()}
    tq = {k: torch.as_tensor(v) for k, v in q.items()}
    return (jq, jnp.asarray(qr)), (tq, torch.as_tensor(qr))


def _run(jz, tz, n, dt, seed=0, o2=False, none_q=False, state_edit=None):
    js, ts = jz.initial_state(), tz.initial_state()
    _same(ts, js, "initial_state")
    if state_edit is not None:
        js, ts = state_edit(js, ts)
    for k in range(n):
        (jq, jqr), (tq, tqr) = _inputs(jz, seed + k, o2)
        if none_q:
            jq = tq = None
        js, jo = jz.evolve(js, dt, jq, jqr)
        ts, to = tz.evolve(ts, torch.tensor(dt, dtype=torch.float64), tq, tqr)
        _same(ts, js, f"state after step {k}")
        _same(to, jo, f"out of step {k}")
    assert _rel(_np(tz.diffusion_number(ts, dt)), _np(jz.diffusion_number(js, dt))) <= TOL
    return js, ts, jo, to


def test_tridiag_solve_against_jax_and_dense():
    from firefoam_torch.regionmodels.oned import tridiag_solve as t_tri
    from firefoam_tpu.regionmodels.oned import tridiag_solve as j_tri

    rng = np.random.default_rng(3)
    nF, nL = 7, 20
    a = -rng.uniform(0.1, 1.0, (nF, nL))
    c = -rng.uniform(0.1, 1.0, (nF, nL))
    b = 2.5 + rng.uniform(0.0, 1.0, (nF, nL))
    d = rng.normal(size=(nF, nL))
    x_t = t_tri(*(torch.as_tensor(v) for v in (a, b, c, d))).numpy()
    x_j = np.asarray(j_tri(*(jnp.asarray(v) for v in (a, b, c, d))))
    assert _rel(x_t, x_j) <= 1e-12
    for f in range(nF):
        A = np.diag(b[f]) + np.diag(a[f, 1:], -1) + np.diag(c[f, :-1], 1)
        assert _rel(x_t[f], np.linalg.solve(A, d[f])) <= 1e-12


def test_solid_thermo_and_chemistry(case):
    jz, tz = _zones(case, "reactingOneDim21")
    rng = np.random.default_rng(1)
    Y = rng.uniform(0.0, 1.0, (30, 5, 2))
    Y /= Y.sum(-1, keepdims=True)
    T = rng.uniform(300.0, 900.0, (30, 5))
    rho = rng.uniform(20.0, 114.7, (30, 5))
    Ys0 = rng.uniform(10.0, 114.7, (30, 5, 2))
    for name in ("cp", "kappa", "emissivity", "absorptivity"):
        assert _rel(getattr(tz.thermo, name)(torch.as_tensor(Y)).numpy(),
                    np.asarray(getattr(jz.thermo, name)(jnp.asarray(Y)))) <= TOL, name
    assert _rel(tz.thermo.hs(torch.as_tensor(T), torch.as_tensor(Y)).numpy(),
                np.asarray(jz.thermo.hs(jnp.asarray(T), jnp.asarray(Y)))) <= TOL
    tr = tz.chem.rates(*(torch.as_tensor(v) for v in (rho, Y, T, Ys0)))
    jr = jz.chem.rates(*(jnp.asarray(v) for v in (rho, Y, T, Ys0)))
    for a, b in zip(tr, jr):
        assert _rel(a.numpy(), np.asarray(b)) <= TOL
    assert float(np.max(-np.asarray(jr[0])[..., 0])) > 0.0  # the wood reacts
    assert tz.chem.reactions[0].sr == jz.chem.reactions[0].sr


@pytest.mark.parametrize("model", ["reactingOneDim", "reactingOneDim21"])
def test_evolve_coupled(case, model):
    jz, tz = _zones(case, model)
    assert tz.bc_exposed.kind == jz.bc_exposed.kind == "coupled"
    _, _, jo, _ = _run(jz, tz, 4, 0.05)
    assert float(np.sum(np.asarray(jo["phiGas"]))) > 0.0


def test_evolve_char_oxidation(case):
    jz, tz = _zones(case, "reactingOneDim21CharOxi")
    assert tz.char_oxi and jz.char_oxi
    _, _, jo, _ = _run(jz, tz, 4, 0.2, o2=True)
    assert float(np.asarray(jo["charOxiQdot"])) > 0.0


@pytest.mark.parametrize("model", ["reactingOneDimRPvol", "reactingOneDimRPvol2",
                                   "reactingOneDimRollPaper"])
def test_evolve_roll_paper(case, model):
    # Tcrt below the surface T: pages peel, the buffer releases fuel
    jz, tz = _zones(case, model, "Tcrt 450; paperToFuelRatio 0.8;")
    js, _, _, _ = _run(jz, tz, 4, 0.1)
    assert float(np.max(np.asarray(js["page"]))) > 0.0


def test_evolve_move_mesh(case):
    from firefoam_torch.io.foamdict import parse_string as tps
    from firefoam_tpu.io.foamdict import parse_string as jps

    text = ("active true; pyrolysisModel reactingOneDim21; regionName panelRegion;\n"
            "reactingOneDim21Coeffs { moveMesh true; minimumDelta 1e-4; }\n")
    from firefoam_torch.regionmodels.pyrolysis import ReactingOneDim as TZ
    from firefoam_tpu.regionmodels.pyrolysis import ReactingOneDim as JZ

    root, jcm, tcm = case
    jz, tz = JZ(root, jcm, jps(text), jnp.float64), TZ(root, tcm, tps(text), torch.float64)
    js, _, _, _ = _run(jz, tz, 4, 0.5)
    assert float(np.min(np.asarray(js["dx"]))) < float(jz.region.dx[0])  # the surface regresses


@pytest.mark.parametrize("spec", [
    "type fixedIncidentRadiation; QrIncident uniform 50000;",
    "type constHTemperature; h uniform 20; Tinf uniform 600;",
    "type constHTemperatureRadiation; h uniform 15; Tinf uniform 700; emissivity uniform 0.9;",
    "type constHTemperatureRadiation; mode correlation; Tinf uniform 300; emissivity uniform 0.8;",
])
def test_end_bcs(case, tmp_path, spec):
    c2 = _with_T_bc(case, tmp_path, spec)
    jz, tz = _zones(c2, "reactingOneDim21")
    assert tz.bc_exposed == jz.bc_exposed or tz.bc_exposed.__dict__ == jz.bc_exposed.__dict__
    _run(jz, tz, 3, 0.05, none_q=True)


def test_pyrocup_ledger(case):
    """PyroCUP from a state where the liner has burnt through (the ledger
    walks heat-up, regime 1 and 2 within the steps)."""
    extra = ("igniTempUC 400; CpUC 600; heatGassUC 1e6; heatGassUC2 2e6; heatGassInnerUC 2e6;"
             " QFlameUC 20000; QFlameUC2 25000; initMassUCCC 0.004; initMassUCPS 0.006;"
             " initMassIUCCC 0.4; initMassIUCPS 0.6; CCMassFracUC 0.6; OLCrit 0.04;"
             " nXPallets 1; nYPallets 1; nZPallets 1; botCorPalletOrigin (-1 -1 -1);"
             " lXPallet 3; lYPallet 3; lZPallet 3; dXPallets 3; dYPallets 3; dZPallets 3;")
    jz, tz = _zones(case, "pyroCUPOneDimV1", extra, cls="cup")

    def burnt(js, ts):
        js, ts = dict(js), dict(ts)
        lost = np.asarray(jz.mOLInit) / jz.gasToVFac
        js["mOLLost"] = jnp.asarray(lost)
        ts["mOLLost"] = torch.as_tensor(lost)
        return js, ts

    js, _, jo, _ = _run(jz, tz, 12, 0.5, none_q=True, state_edit=burnt)
    assert float(np.max(np.asarray(js["tempUC"]))) > 298.0
    assert float(np.sum(np.asarray(jo["phiGas"]))) > 0.0


def test_collection_selects_the_models(case, tmp_path):
    from firefoam_torch.regionmodels.pyrolysis import PyrolysisCollection as TP
    from firefoam_tpu.regionmodels.pyrolysis import PyrolysisCollection as JP

    root, jcm, tcm = case
    jc, tc = JP(root, jcm, jnp.float64), TP(root, tcm, torch.float64)
    assert [z.model for z in tc.zones] == [z.model for z in jc.zones] == ["reactingOneDim21"]
    assert tc.zones[0].region.n_faces == jc.zones[0].region.n_faces == 4 * 7
    assert np.array_equal(tc.zones[0].region.prim_bidx, jc.zones[0].region.prim_bidx)
    path = os.path.join(root, "constant", "pyrolysisZones")
    with open(path) as f:
        txt = f.read()
    c2 = str(tmp_path / "none")
    shutil.copytree(root, c2)
    with open(os.path.join(c2, "constant", "pyrolysisZones"), "w") as f:
        f.write(txt.replace("pyrolysisModel reactingOneDim21;", "pyrolysisModel none;"))
    assert TP(c2, tcm, torch.float64).zones == [] == JP(c2, jcm, jnp.float64).zones


def test_r15_pyrocup_takes_the_coupled_gas_flux(case):
    """ROADMAP R15: the JAX package's PyroCUP adds the solver's coupled
    q_conv (a dict of kDelta/T_nbr arrays) to a flux, which raises; the port
    takes a convective flux only when one is given as an array (a zone on a
    coupled wall evolves with the ledger's convective term at 0)."""
    extra = "nXPallets 1; nYPallets 1; nZPallets 1; botCorPalletOrigin (-1 -1 -1);" \
            " lXPallet 3; lYPallet 3; lZPallet 3;"
    jz, tz = _zones(case, "pyroCUPOneDimV1", extra, cls="cup")
    (jq, jqr), (tq, tqr) = _inputs(jz)
    with pytest.raises(TypeError):
        jz.evolve(jz.initial_state(), 0.1, jq, jqr)
    st, out = tz.evolve(tz.initial_state(), torch.tensor(0.1, dtype=torch.float64), tq, tqr)
    assert bool(torch.isfinite(out["phiGas"]).all())
