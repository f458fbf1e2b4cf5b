"""The port's film modules against the JAX package's on the CPU in float64,
to 1e-10: FilmMesh (the edge lists and its edge→face sums, which the port
makes order-fixed), each film inlet kind, one ThermoSingleLayerFilm.evolve per
family and option (thermoSingleLayer, Pw with partial wetting and absorption,
FmPanel's radiation window, the viscosity, heat-transfer, phase-change,
radiation, force and injection submodels), the cloud's film interaction
(absorb and the Bai-Gosman splash on a set parcel batch, its draws from the
same key) and the gas-side coupled BCs. The film lies over the floor and the
panel of firefoam_torch.utils.synthcase.write_wetted_panel_fire_case at
(8, 6, 7); the inputs are numpy draws from a seed."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_torch.utils.synthcase import write_wetted_panel_fire_case

torch.set_num_threads(1)
TOL = 1e-10
N = (8, 6, 7)

_BASE = """filmThermoModel liquid; liquid H2O; deltaWet 0.0002; Tmin 200; Tmax 500;
laminarCoeffs { Cf 0.005; }"""


def _rel(a, b, floor=1e-300):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b), initial=0.0) / max(np.max(np.abs(b), initial=0.0), floor))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """(root, JAX FilmMesh, port FilmMesh, both primary meshes) over the film
    faces of the wetted case."""
    from firefoam_torch.mesh import build_case_mesh as t_mesh
    from firefoam_torch.regionmodels.surfmesh import FilmMesh as TFM
    from firefoam_tpu.mesh.case_mesh import build_case_mesh as j_mesh
    from firefoam_tpu.regionmodels.surfmesh import FilmMesh as JFM

    root = write_wetted_panel_fire_case(str(tmp_path_factory.mktemp("wet") / "case"), n=N,
                                        pps=1000.0, max_dt=0.005)
    jcm, tcm = j_mesh(root), t_mesh(root)
    faces = []
    for z in ("panelLow", "panelHigh"):
        faces += [int(f) for f in tcm.face_zones[z].faces]
    base = next(p for p in tcm.mesh.patches if p.name == "base")
    faces += list(range(base.start, base.start + base.n_faces))
    return root, JFM.from_faces(jcm.mesh, faces, jnp.float64), TFM.from_faces(
        tcm.mesh, faces, torch.float64, "cpu")


def _films(meshes, model, coeffs):
    from firefoam_torch.io.foamdict import parse_string as tps
    from firefoam_torch.regionmodels.film import ThermoSingleLayerFilm as TF
    from firefoam_tpu.io.foamdict import parse_string as jps
    from firefoam_tpu.regionmodels.film import ThermoSingleLayerFilm as JF

    text = f"active true; surfaceFilmModel {model}; {model}Coeffs {{ {_BASE} {coeffs} }}"
    _, jfm, tfm = meshes
    g = (0.0, -9.81, 0.0)
    return JF(jfm, jps(text), g, jnp.float64), TF(tfm, tps(text), g, torch.float64)


def _inputs(nF, seed):
    rng = np.random.default_rng(seed)
    d = {
        "mass_imp": rng.uniform(0.0, 0.05, nF) * (rng.uniform(size=nF) > 0.5),
        "T_gas": rng.uniform(300.0, 900.0, nF),
        "U_gas": rng.normal(0.0, 1.0, (nF, 3)),
        "rho_gas": rng.uniform(0.4, 1.2, nF),
        "Yv_gas": rng.uniform(0.0, 0.05, nF),
        "p_gas": rng.uniform(1.0130e5, 1.0135e5, nF),
        "htc_gas": rng.uniform(5.0, 40.0, nF),
        "T_wall": rng.uniform(290.0, 500.0, nF),
        "qr": rng.uniform(0.0, 2e4, nF),
    }
    d["h_imp"] = d["mass_imp"] * 4180.0 * 300.0
    return ({k: jnp.asarray(v) for k, v in d.items()} | {"t": jnp.asarray(0.3)},
            {k: torch.as_tensor(v) for k, v in d.items()} | {"t": torch.tensor(0.3,
                                                                              dtype=torch.float64)})


def _evolve_both(jf, tf, n=4, dt=0.01, delta0=2e-4, T0=310.0, seed=0):
    js, ts = jf.initial_state(delta0, T0), tf.initial_state(delta0, T0)
    nF = jf.fm.n_faces
    rng = np.random.default_rng(seed + 100)
    u0 = rng.normal(0.0, 0.05, (nF, 3))
    js["U"], ts["U"] = jnp.asarray(u0), torch.as_tensor(u0)
    d0 = delta0 * rng.uniform(0.0, 20.0, nF)
    js["delta"], ts["delta"] = jnp.asarray(d0), torch.as_tensor(d0)
    for k in range(n):
        ji, ti = _inputs(nF, seed + k)
        js, jo = jf.evolve(js, dt, ji)
        ts, to = tf.evolve(ts, torch.tensor(dt, dtype=torch.float64), ti)
        assert set(ts) == set(js) and set(to) == set(jo)
        for key in js:
            assert _rel(_np(ts[key]), _np(js[key])) <= TOL, (k, key, _rel(_np(ts[key]),
                                                                          _np(js[key])))
        for key in jo:
            assert _rel(_np(to[key]), _np(jo[key])) <= TOL, (k, key)
    assert _rel(_np(tf.courant(ts, 0.01)), _np(jf.courant(js, 0.01))) <= TOL
    return js, jo


def test_film_mesh_and_edge_sums(meshes):
    _, jfm, tfm = meshes
    assert tfm.n_faces == jfm.n_faces == 44 + 28  # the floor less the burner, the panel
    for name in ("area", "C", "n_hat", "e_own", "e_nei", "e_len", "e_m", "e_dc", "e_w",
                 "be_face", "be_len", "be_m", "be_C"):
        assert _rel(_np(getattr(tfm, name)), _np(getattr(jfm, name))) <= 1e-14, name
    assert np.array_equal(tfm.prim_bidx, jfm.prim_bidx)
    assert np.array_equal(tfm.prim_cells, jfm.prim_cells)
    rng = np.random.default_rng(5)
    psi = rng.normal(size=tfm.n_faces)
    ev = rng.normal(size=tfm.n_edges)
    assert _rel(tfm.div_edges(torch.as_tensor(ev)).numpy(),
                np.asarray(jfm.div_edges(jnp.asarray(ev)))) <= 1e-12
    assert _rel(tfm.grad_edges(torch.as_tensor(psi)).numpy(),
                np.asarray(jfm.grad_edges(jnp.asarray(psi)))) <= 1e-12
    # the floor and the two panel zones: one film over both, its rim
    # includes the panel's bottom edge (where the film drips)
    assert tfm.n_edges > 0 and tfm.be_face.shape[0] > 0


@pytest.mark.parametrize("inlet", [
    "type massFlowInlet; gamma 0.02; T 305;",
    "type inclinedFilmNusseltHeight; GammaMean 0.02; a 1e-5; omega 2; T 300;",
    "type inclinedFilmNusseltInletVelocity; GammaMean 0.02; a 0.2; omega 2; T 300;",
    "type filmHeightInletVelocity; deltaf 1e-4; mdot 0.003; T 300;",
    "type filmHeightInletVelocityWavy; deltaf 1e-4; mdot 0.003; T 300;",
    "type filmHeightInlet; mean 1e-4; a 0.3; omega 3; temporalFrequency1 2;"
    " temporalFrequency2 1; T 300;",
    "type wavyFilmHeight; mean 1e-4; a 0.3; omega 3; temporalFrequency1 2; T 300;",
])
def test_film_inlets(meshes, inlet):
    coeffs = (f"inletModels {{ feed {{ {inlet} box (-0.01 0.99 -0.01) (0.01 1.01 1.01);"
              " direction (0 1 0); } }")
    jf, tf = _films(meshes, "thermoSingleLayer", coeffs)
    assert len(tf.inlets) == len(jf.inlets) == 1
    ji, ti = jf.inlets[0], tf.inlets[0]
    assert np.array_equal(ti.rows, ji.rows) and _rel(ti.d_tan, ji.d_tan) <= 1e-14
    for t in (0.0, 0.37):
        qj = ji.inflow(jf.liquid, jnp.asarray(t))
        qt = ti.inflow(tf.liquid, torch.tensor(t, dtype=torch.float64))
        for k in ("delta", "u", "wobble"):
            assert _rel(_np(qt[k]), np.broadcast_to(_np(qj[k]), _np(qt[k]).shape)) <= TOL, k
        assert abs(qt["rho"] - qj["rho"]) <= 1e-14 * qj["rho"]
    _evolve_both(jf, tf, n=3)


@pytest.mark.parametrize("model,coeffs", [
    ("thermoSingleLayer", "injectionModels ( drippingInjection );"
     " drippingInjectionCoeffs { deltaStable 1e-4; }"
     " upperSurfaceModels { heatTransferModel mappedConvectiveHeatTransfer; }"),
    ("thermoSingleLayerPw", "partialWetting true; absorption true;"
     " partialWettingCoeffs { criticalFilmThickness 2e-4; wetToggle 0.5; dryToggle 0.01; }"),
    ("thermoSingleLayerFmPanel", "augmentedRadiation true; augmentedRadiationCoeffs"
     " { qRadConstant 30000; qRadXMin -1; qRadXMax 0.5; qRadYMin 0.2; qRadYMax 0.9;"
     " qRadBegin 0.1; qRadEnd 10; }"),
    ("thermoSingleLayerFmBox", "augmentedRadiation false;"),
    ("thermoSingleLayer", "filmViscosityModel Arrhenius; ArrheniusViscosityCoeffs"
     " { k1 -500; k2 10; Tref 300; } lowerSurfaceModels { heatTransferModel conduction; }"
     " upperSurfaceModels { heatTransferModel flatPlate; flatPlateCoeffs { L 0.5; } }"),
    ("thermoSingleLayer", "filmViscosityModel thixotropic; thixotropicCoeffs"
     " { mu0 0.01; muInf 0.001; a 1; b 1; c 0.1; d 1; }"
     " lowerSurfaceModels { heatTransferModel alKhalil; }"),
    ("thermoSingleLayer", "phaseChangeModel solidification; solidificationCoeffs"
     " { T0 400; maxSolidificationFrac 0.2; maxSolidificationRate 5; }"
     " radiationModel rampingRadiation; rampingRadiationCoeffs { qrConst 1000; rampStep 500;"
     " rampTimeInterval 0.1; absorptivity 0.8; }"),
    ("thermoSingleLayer", "phaseChangeModel none; radiationModel constantRadiation;"
     " constantRadiationCoeffs { qrConst 5000; timeStart 0; duration 5; absorptivity 0.9; }"
     " injectionModels ( removeInjection );"),
    ("thermoSingleLayer", "forces ( thermocapillary contactAngle );"
     " contactAngleCoeffs { Ccf 0.085; distribution { normalDistribution"
     " { expectation 60; } } }"),
    ("thermoSingleLayer", "forces ( temperatureDependentContactAngle );"
     " temperatureDependentContactAngleCoeffs { Ccf 0.085; theta table ( (300 70) (400 40) ); }"
     " injectionModels ( BrunDrippingInjection curvatureSeparation );"
     " BrunDrippingInjectionCoeffs { deltaStable 1e-4; } massAbsorptionModel standardMassAbsorption;"),
])
def test_film_evolve(meshes, model, coeffs):
    jf, tf = _films(meshes, model, coeffs)
    js, jo = _evolve_both(jf, tf)
    assert float(np.asarray(jo["mass"])) > 0.0


def test_film_drips_at_the_panel_rim(meshes):
    """A thick film on the panel runs over its bottom rim edge: the rim drip
    and the drip tally agree."""
    jf, tf = _films(meshes, "thermoSingleLayer", "")
    js, _ = _evolve_both(jf, tf, n=3, delta0=5e-4)
    assert float(np.asarray(js["drippedMass"])) > 0.0


def _cloud_pair(meshes, splash):
    """Both packages' clouds on the wetted case, film faces marked."""
    from firefoam_torch.models.firefoam import FireFoamSolver as TS
    from firefoam_tpu.models.firefoam import FireFoamSolver as JS

    root = meshes[0]
    if not splash:
        import os
        import shutil

        r2 = root + "_absorb"
        if not os.path.isdir(r2):
            shutil.copytree(root, r2)
            p = os.path.join(r2, "constant", "reactingCloud1Properties")
            with open(p) as f:
                txt = f.read()
            with open(p, "w") as f:
                f.write(txt.replace("interactionType splashBai;", "interactionType absorb;"))
        root = r2
    with pytest.MonkeyPatch.context() as mp:
        for k in ("EXACT_SOLVERS", "AMG", "GMG", "PALLAS"):
            mp.setenv(f"FIREFOAM_TPU_{k}", "0")
        js = JS(root)
    ts = TS(root, device="cpu", dtype=torch.float64, exact_solvers=False, gmg=False, amg=False)
    return js, ts


@pytest.mark.parametrize("splash", [True, False])
def test_cloud_film_interaction(meshes, splash):
    """_film_interaction on a set parcel batch: parcels striking film faces
    (wet and dry ones) at speeds spanning absorb, bounce and splash."""
    js, ts = _cloud_pair(meshes, splash)
    jc, tc = js.cloud, ts.cloud
    assert np.array_equal(tc.b_code.numpy(), np.asarray(jc.b_code))
    from firefoam_torch.lagrangian.tracking import INTERACT_FILM

    film_faces = np.nonzero(tc.b_code.numpy() == INTERACT_FILM)[0]
    assert film_faces.size == ts.film.fm.n_faces
    cap = 64
    rng = np.random.default_rng(11)
    nB = ts.geom.n_boundary
    st = {
        "x": rng.uniform(0.1, 0.9, (cap, 3)),
        "U": rng.normal(0.0, 1.0, (cap, 3)) * rng.uniform(0.1, 12.0, (cap, 1)),
        "d": rng.uniform(2e-4, 2e-3, cap),
        "T": rng.uniform(290.0, 350.0, cap),
        "nP": rng.uniform(1.0, 50.0, cap),
        "alive": rng.uniform(size=cap) > 0.1,
    }
    hit = np.where(rng.uniform(size=cap) > 0.2, rng.choice(film_faces, cap), -1)
    code = np.where(hit >= 0, INTERACT_FILM, 0)
    mass = rng.uniform(1e-7, 1e-4, cap)
    delta_b = np.zeros(nB)
    delta_b[film_faces] = rng.uniform(0.0, 4e-4, film_faces.size)
    src = {"filmMass": np.zeros(nB), "filmEnthalpy": np.zeros(nB)}
    from firefoam_torch.lagrangian import prng

    key = np.asarray(jax.random.PRNGKey(9))
    jst = {k: jnp.asarray(v) for k, v in st.items()} | {"rng": jnp.asarray(key)}
    tst = {k: torch.as_tensor(v) for k, v in st.items()} | {"rng": prng.PRNGKey(9)}
    assert np.array_equal(tst["rng"].numpy(), key)
    jst2, jsrc = jc._film_interaction(
        jst, {k: jnp.asarray(v) for k, v in src.items()}, jnp.asarray(code), jnp.asarray(hit),
        jnp.asarray(mass), jnp.asarray(st["T"]), jnp.asarray(delta_b), {})
    tst2, tsrc = tc._film_interaction(
        tst, {k: torch.as_tensor(v) for k, v in src.items()}, torch.as_tensor(code),
        torch.as_tensor(hit), torch.as_tensor(mass), torch.as_tensor(delta_b))
    for k in jst2:
        a, b = _np(tst2[k]), np.asarray(jst2[k])
        if b.dtype.kind in "biu":
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), k
        else:
            assert _rel(a, b) <= TOL, k
    for k in ("filmMass", "filmEnthalpy"):
        assert _rel(_np(tsrc[k]), np.asarray(jsrc[k])) <= TOL, k
    assert float(np.sum(np.asarray(jsrc["filmMass"]))) > 0.0
    if splash:  # the batch spans the regimes
        assert bool(np.any(np.asarray(jst2["d"]) != st["d"]))


def test_coupled_bcs():
    """The gas-side coupled kinds resolve as the JAX package's do, from the
    same overrides."""
    from firefoam_torch.ops import bcs as tb
    from firefoam_torch.ops import fields as tf_
    from firefoam_tpu.ops import bcs as jb

    assert set(k for k in jb._REGISTRY if "oupled" in k or "rollPaper" in k
               or "FilmWall" in k) <= set(tb._REGISTRY)

    class P:
        name, ptype, start, n = "pan", "mappedWall", 2, 4
        slice = slice(2, 6)

    rng = np.random.default_rng(2)
    nB = 8
    Sf = rng.normal(size=(nB, 3))
    magSf = np.linalg.norm(Sf, axis=1)

    class G:
        def __init__(self, lib):
            self.b_Sf, self.b_magSf, self.n_boundary = lib(Sf), lib(magSf), nB

    rho_b = rng.uniform(0.5, 1.2, nB)
    psi_b = rng.uniform(300.0, 600.0, nB)
    mdot = rng.uniform(0.0, 1e-3, 4)
    u_f = rng.normal(size=(4, 3))
    T_v = rng.uniform(400.0, 700.0, 4)
    for kind, field, nc, ov in [
        ("compressible::turbulentTemperatureRadiationQinCoupledMixed", "T", 1,
         {("T", "pan", "value"): T_v}),
        ("filmPyrolysisTemperatureCoupled", "T", 1, {}),
        ("flowRateInletVelocityPyrolysisCoupled", "U", 3, {("U", "pan", "mdot"): mdot}),
        ("flowRateInletVelocityPyrolysisCoupled", "U", 3, {}),
        ("filmPyrolysisVelocityCoupled", "U", 3, {("U", "pan", "value"): u_f,
                                                  ("U", "pan", "mdot"): mdot}),
        ("filmPyrolysisVelocityCoupled", "U", 3, {("U", "pan", "mdot"): mdot}),
    ]:
        outs = []
        for mod, lib, fl in ((jb, jnp.asarray, None), (tb, torch.as_tensor, tf_)):
            ctx = {"_field": field, "overrides": {k: lib(v) for k, v in ov.items()},
                   "rho": type("F", (), {"b": lib(rho_b)})}
            bc = mod.BC(kind, "pan", {})
            args = (bc, P, G(lib), lib(np.zeros(3)), lib(psi_b), ctx, nc)
            if mod is jb:
                args = args + (jnp.float64,)
            outs.append([_np(x) for x in mod._REGISTRY[kind](*args)])
        for a, b in zip(outs[1], outs[0]):
            assert _rel(a, np.broadcast_to(b, a.shape)) <= 1e-14, kind
