"""The port's Lagrangian modules against the JAX package's, one by one, on the
CPU in float64 with the same seeded inputs (numpy): the liquid properties
(H2O, n-heptane, ethanol and a mixture), the containment-walk tables and a
walk with rebound, stick and escape (cells and hit codes equal), every
particle force, the ParticleCollectorFmg modes (polygon, concentric circle,
the mass-threshold removals), every cloud function object, and
SuppressionCollision, and one fvDOM solve with the spray's radiation
fields. Fields within 1e-10 relative unless a test says otherwise. The mesh is the spray fire case of
firefoam_torch.utils.synthcase at (6, 5, 6); both packages read its files.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.io import parse_string as jparse
from firefoam_tpu.lagrangian import cloudfunctions as jcf
from firefoam_tpu.lagrangian import collector as jcol
from firefoam_tpu.lagrangian import forces as jforces
from firefoam_tpu.lagrangian import liquids as jliq
from firefoam_tpu.lagrangian.suppression import SuppressionCollision as JSup
from firefoam_tpu.lagrangian.tracking import WalkMesh as JWalk
from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_torch.io import parse_string as tparse
from firefoam_torch.lagrangian import cloudfunctions as tcf
from firefoam_torch.lagrangian import collector as tcol
from firefoam_torch.lagrangian import forces as tforces
from firefoam_torch.lagrangian import liquids as tliq
from firefoam_torch.lagrangian import prng
from firefoam_torch.lagrangian.suppression import SuppressionCollision as TSup
from firefoam_torch.lagrangian.tracking import (INTERACT_ESCAPE, INTERACT_REBOUND,
                                                INTERACT_STICK, WalkMesh as TWalk, cell_sum)
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.utils.synthcase import write_spray_fire_case

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
N = (6, 5, 6)
TOL = 1e-10


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)) if b.size else 0.0


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(ours, ref, tol=TOL):
    """Every leaf of two (nested) dicts/lists within tol (ints and bools equal)."""
    if isinstance(ref, dict):
        assert set(ours) == set(ref), (set(ours), set(ref))
        for k in ref:
            _same(ours[k], ref[k], tol)
        return
    if isinstance(ref, (list, tuple)):
        for a, b in zip(ours, ref):
            _same(a, b, tol)
        return
    a, b = _np(ours), _np(ref)
    if b.dtype.kind in "biu":
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64))
    else:
        nan = np.isnan(b)
        assert np.array_equal(np.isnan(a), nan)  # e.g. dv50 of an empty histogram
        assert _rel(a[~nan], b[~nan]) <= tol


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    root = write_spray_fire_case(str(tmp_path_factory.mktemp("lag") / "c"), n=N)
    jm, tm = j_build(root).mesh, t_build(root).mesh
    return {
        "jw": JWalk.from_polymesh(jm), "tw": TWalk.from_polymesh(tm),
        "jg": JGeom.from_polymesh(jm), "tg": TGeom.from_polymesh(tm, dtype=torch.float64,
                                                                 device="cpu"),
    }


def _parcels(rng, walk, n):
    """n parcels in random cells of the mesh, displaced by up to 1.5 cell
    widths, with random velocities and sizes."""
    C = walk._h_C
    h = np.cbrt(np.prod(np.ptp(C, axis=0)) / C.shape[0])
    cell = rng.integers(0, C.shape[0], n)
    return {
        "x": C[cell] + rng.uniform(-1.5, 1.5, (n, 3)) * h,
        "U": rng.normal(0.0, 2.0, (n, 3)),
        "cell": cell,
        "alive": rng.uniform(size=n) < 0.9,
        "d": rng.uniform(1e-4, 2e-3, n),
        "nP": rng.uniform(1.0, 50.0, n),
        "T": rng.uniform(290.0, 370.0, n),
    }


J = lambda a: jnp.asarray(a)  # noqa: E731
T = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731


# ---------------------------------------------------------------- liquids
@pytest.mark.parametrize("name", ("H2O", "C7H16", "C2H5OH"))
def test_liquid_properties(name):
    Tk = np.linspace(150.0, 700.0, 97)  # beyond both ends: the clamp
    jl, tl = jliq.liquid_by_name(name), tliq.liquid_by_name(name)
    for fn in ("rho", "pv", "hl", "cp", "mu", "kappa", "sigma", "D", "h"):
        a = getattr(tl, fn)(T(np.full(97, 1.2e5)), T(Tk))
        b = getattr(jl, fn)(J(np.full(97, 1.2e5)), J(Tk))
        assert _rel(_np(a), b) <= TOL, fn


def test_liquid_mixture():
    names, fracs = ["H2O", "C2H5OH", "C7H16"], [0.5, 0.3, 0.2]
    jm, tm = jliq.LiquidMixture(names, fracs), tliq.LiquidMixture(names, fracs)
    rng = np.random.default_rng(3)
    Tk = rng.uniform(280.0, 500.0, 64)
    p = rng.uniform(0.9e5, 1.2e5, 64)
    Y = rng.dirichlet(np.ones(3), 64)
    for fn in ("rho", "cp", "hl", "mu", "kappa", "sigma", "h", "pv", "D", "comp_pv", "comp_D",
               "comp_hl"):
        assert _rel(_np(getattr(tm, fn)(T(p), T(Tk))), getattr(jm, fn)(J(p), J(Tk))) <= TOL, fn
    for fn in ("rho_Y", "cp_Y"):
        assert _rel(_np(getattr(tm, fn)(T(p), T(Tk), T(Y))),
                    getattr(jm, fn)(J(p), J(Tk), J(Y))) <= TOL, fn
    assert _rel(_np(tm.x_Y(T(Y))), jm.x_Y(J(Y))) <= TOL
    assert _rel(_np(tm.vapour_split(T(Tk))), jm.vapour_split(J(Tk))) <= TOL
    assert tm.W == pytest.approx(jm.W, rel=1e-15)


# ---------------------------------------------------------------- tracking
def test_walk_tables_and_location(mesh):
    jw, tw = mesh["jw"], mesh["tw"]
    assert jw.max_faces == tw.max_faces
    for k in ("cf_Cf", "cf_n", "cf_nei", "cf_bidx", "tol", "C"):
        _same(getattr(tw, k), getattr(jw, k), 0.0)
    rng = np.random.default_rng(0)
    for p in rng.uniform(-0.1, 1.1, (40, 3)):
        assert tw.find_cell_host(p) == jw.find_cell_host(p)


def test_walk_rebound_stick_escape(mesh):
    jw, tw, tg = mesh["jw"], mesh["tw"], mesh["tg"]
    code = np.zeros(tg.n_boundary, np.int64)
    e = np.ones(tg.n_boundary)
    for p in tg.patches:
        code[p.slice] = {"top": INTERACT_ESCAPE, "base": INTERACT_STICK}.get(p.name,
                                                                             INTERACT_REBOUND)
        e[p.slice] = 0.7 if p.name == "sides" else 1.0
    par = _parcels(np.random.default_rng(1), tw, 400)
    args = [par["x"], par["U"], par["cell"], par["alive"], code, e]
    got = tw.walk(*[T(a) for a in args], n_steps=6)
    ref = jw.walk(*[J(a) for a in args], n_steps=6)
    names = ("x", "U", "cell", "alive", "hit", "code")
    for k, a, b in zip(names, got, ref):
        _same(a, b, 1e-12)
    hit_codes = set(_np(got[5])[_np(got[4]) >= 0].tolist())
    assert hit_codes == {INTERACT_ESCAPE, INTERACT_STICK, INTERACT_REBOUND}
    assert (~_np(got[3]) & par["alive"]).any()  # some escaped


@pytest.mark.parametrize("masked", (False, True))
def test_cell_sum_order(masked):
    """The order-fixed parcel→cell sum against the JAX package's segment_sum
    (with a mask, the left-out parcels carry zeros on the JAX side)."""
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 180, 5000)
    v = rng.normal(size=(5000, 4)) * 10.0 ** rng.integers(-8, 8, (5000, 1))
    keep = rng.uniform(size=5000) < 0.3 if masked else np.ones(5000, bool)
    a = _np(cell_sum(T(v), T(idx), 180, keep=T(keep) if masked else None))
    b = np.asarray(jax.ops.segment_sum(J(np.where(keep[:, None], v, 0.0)), J(idx),
                                       num_segments=180))
    assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(b))


# ---------------------------------------------------------------- forces
FORCES = (
    "sphereDrag; gravity;",
    "nonSphereDrag { phi 0.7; } pressureGradient; virtualMass { Cvm 0.5; }",
    "distortedSphereDrag; SaffmanMeiLift;",
    "WenYuDrag; TomiyamaLift { sigma 0.05; }",
    "ErgunWenYuDrag; SRF { omega (0 0 3); origin (0.5 0 0.5); }",
    "PlessisMasliyahDrag; nonInertialFrame { linearAcceleration (0 1 0); "
    "angularVelocity (0 2 0); angularAcceleration (0.1 0 0); centreOfRotation (0 0 0); } "
    "paramagnetic { magneticSusceptibility 0.2; }",
)


@pytest.mark.parametrize("spec", FORCES)
def test_forces(spec):
    jf = jforces.ParticleForces.from_dict(jparse(spec))
    tf = tforces.ParticleForces.from_dict(tparse(spec))
    assert (tf.drag_model, tf.lift_model, tf.needs_curl(), tf.needs_ddt(),
            tf.has_body_forces()) == (jf.drag_model, jf.lift_model, jf.needs_curl(),
                                      jf.needs_ddt(), jf.has_body_forces())
    rng = np.random.default_rng(4)
    n = 200
    Re = 10.0 ** rng.uniform(-2, 3.5, n)
    mu, rc, rp = rng.uniform(1e-5, 3e-5, n), rng.uniform(0.3, 1.2, n), rng.uniform(900, 1000, n)
    d, m = rng.uniform(1e-4, 2e-3, n), rng.uniform(1e-9, 1e-6, n)
    ac, y = rng.uniform(0.5, 1.0, n), rng.uniform(0.0, 1.2, n)
    Up, Uc, curl = (rng.normal(size=(n, 3)) for _ in range(3))
    x, hdgh = rng.uniform(size=(n, 3)), rng.normal(size=(n, 3))
    args = (Re, mu, rp, d, m)
    _same(tf.drag_sp(*map(T, args), alpha_c=T(ac), y=T(y)),
          jf.drag_sp(*map(J, args), alpha_c=J(ac), y=J(y)))
    if tf.lift_model:
        largs = (Up, Uc, curl, Re, mu, rc, rp, d, m)
        _same(tf.lift_su(*map(T, largs), g=np.array([0, -9.81, 0])),
              jf.lift_su(*map(J, largs), g=np.array([0, -9.81, 0])))
    if tf.needs_ddt():
        _same(tf.pgrad_su(T(curl), T(rc), T(rp), T(m)), jf.pgrad_su(J(curl), J(rc), J(rp), J(m)))
    _same(tf.mass_add(T(m), T(rc), T(rp)), jf.mass_add(J(m), J(rc), J(rp)))
    if tf.has_body_forces():
        bargs = (x, Up, m, rc, rp, hdgh)
        _same(tf.body_su(*map(T, bargs)), jf.body_su(*map(J, bargs)))


# ---------------------------------------------------------------- collector
COLLECTORS = {
    "polygon": "mode polygon; normal (0 -1 0); removeCollected yes; "
               "polygons ( ((0.1 0.3 0.1) (0.5 0.3 0.1) (0.5 0.3 0.5) (0.1 0.3 0.5)) "
               "((0.5 0.3 0.5) (0.9 0.3 0.5) (0.9 0.3 0.9)) );",
    "circle": "mode concentricCircle; origin (0.5 0.3 0.5); normal (0 1 0); radius (0.1 0.25 0.4); "
              "nSector 6; refDir (1 0 0); negateParcelsOppositeNormal yes;",
    "fixedThres": "mode concentricCircle; origin (0.5 0.3 0.5); normal (0 -1 0); radius (0.5); "
                  "nSector 2; fixedMassRemove yes; massThres 2e-3;",
    "contThres": "mode concentricCircle; origin (0.5 0.3 0.5); normal (0 -1 0); radius (0.3 0.5); "
                 "nSector 4; contMassRemove yes; massThres 1e-3; smoothingWindow 0.05;",
}


@pytest.mark.parametrize("kind", sorted(COLLECTORS))
def test_collector(kind):
    jc = jcol.ParticleCollector.from_dict(kind, jparse(COLLECTORS[kind]))
    tc = tcol.ParticleCollector.from_dict(kind, tparse(COLLECTORS[kind]))
    rng = np.random.default_rng(5)
    jst, tst = jc.init_state(jnp.float64), tc.init_state(torch.float64)
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    for _ in range(4):
        n = 600
        x0 = rng.uniform(0.0, 1.0, (n, 3))
        x1 = x0 + rng.normal(0.0, 0.2, (n, 3))
        mass, d = rng.uniform(1e-6, 1e-4, n), 10.0 ** rng.uniform(-4.5, -2.5, n)
        U, alive = rng.normal(size=(n, 3)), rng.uniform(size=n) < 0.95
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk, 2)
        jst, jcaught = jc.collect(jst, *map(J, (x0, x1, mass, d, U, alive)), 0.01, key=jsub)
        tst, tcaught = tc.collect(tst, *map(T, (x0, x1, mass, d, U, alive)), 0.01, key=tsub)
        _same(tcaught, jcaught)
        _same(tst, jst, 1e-12)
    assert _np(tst["mass"]).any()
    js, ts = jc.summarise(jst), tc.summarise(tst)
    _same(ts, js, 1e-12)


def test_make_collectors_and_functions(mesh):
    spec = ("cloudFunctions { c1 { type particleCollectorFmg; " + COLLECTORS["polygon"] + " } "
            "vf { type voidFraction; } er { type particleErosion; patches (base); } "
            "tr { type particleTrap; alphaName alpha; threshold 0.9; } "
            "tk { type particleTracks; trackInterval 2; maxSamples 3; } "
            "pp { type patchPostProcessing; patches (base); maxStoredParcels 30; } }")
    assert [c.name for c in tcol.make_collectors(tparse(spec))] == ["c1"]
    tf = tcf.make_cloud_functions(tparse(spec), mesh["tg"])
    jf = jcf.make_cloud_functions(jparse(spec), mesh["jg"])
    assert [type(f).__name__ for f in tf] == [type(f).__name__ for f in jf]
    assert [type(f).__name__ for f in tf] == ["VoidFraction", "ParticleErosion", "ParticleTrap",
                                               "ParticleTracks", "PatchPostProcessing"]


# ---------------------------------------------------------------- cloud functions
def test_cloud_functions(mesh):
    jg, tg, tw = mesh["jg"], mesh["tg"], mesh["tw"]
    rng = np.random.default_rng(6)
    n = 300
    par = _parcels(rng, tw, n)
    nC, nB = tg.n_cells, tg.n_boundary
    gas = {"alpha": rng.uniform(0.8, 1.0, nC), "grad_alpha": rng.normal(size=(nC, 3))}
    fns = [
        (tcf.VoidFraction("vf"), jcf.VoidFraction("vf"), nC),
        (tcf.ParticleErosion("er", ("base",)), jcf.ParticleErosion("er", ("base",)), nB),
        (tcf.ParticleTrap("tr", threshold=0.9), jcf.ParticleTrap("tr", threshold=0.9), nC),
        (tcf.ParticleTracks("tk", 2, 3), jcf.ParticleTracks("tk", 2, 3), nC),
        (tcf.PatchPostProcessing("pp", ("base",), 25), jcf.PatchPostProcessing("pp", ("base",), 25),
         nB),
        (tcf.FacePostProcessing("fp", {"z0": np.arange(0, nB, 3), "z1": np.arange(1, 40)}),
         jcf.FacePostProcessing("fp", {"z0": np.arange(0, nB, 3), "z1": np.arange(1, 40)}), nB),
    ]
    b_normal = _np(tg.b_Sf) / _np(tg.b_magSf)[:, None]
    for tfn, jfn, size in fns:
        tst, jst = tfn.init_state(n, size, torch.float64), jfn.init_state(n, size, jnp.float64)
        tpar = {k: T(v) for k, v in par.items()}
        jpar = {k: J(v) for k, v in par.items()}
        for rnd in range(3):
            if hasattr(tfn, "reset") and rnd == 1:
                tst, jst = tfn.reset(tst), jfn.reset(jst)
            if hasattr(tfn, "post_patch"):
                hit = rng.integers(0, nB, n)
                hmask = rng.uniform(size=n) < 0.3
                mass, U_in = rng.uniform(1e-7, 1e-5, n), rng.normal(size=(n, 3))
                tst = tfn.post_patch(tst, tpar, T(hit), T(hmask), T(mass), T(U_in), T(b_normal))
                jst = jfn.post_patch(jst, jpar, J(hit), J(hmask), J(mass), J(U_in), J(b_normal))
            else:
                tgas = {k: T(v) for k, v in gas.items()}
                jgas = {k: J(v) for k, v in gas.items()}
                tst, tpar = tfn.post_move(tst, tpar, 0.002, 0.01, tgas, tg)
                jst, jpar = jfn.post_move(jst, jpar, 0.002, 0.01, jgas, jg)
                _same(tpar, jpar, 1e-12)
            if isinstance(tfn, tcf.PatchPostProcessing):
                # the scratch row past max_stored holds whatever overflowed
                _same(tst["rows"][:-1], jst["rows"][:-1], 1e-12)
                _same(tst["n_rows"], jst["n_rows"])
            else:
                _same(tst, jst, 1e-12)


# ---------------------------------------------------------------- suppression
def test_suppression_collision():
    spec = ("stochasticCollisionModel SuppressionCollision; SuppressionCollisionCoeffs "
            "{ suppressionCloud sprayCloud; suppressedParcelType 3; }")
    js, ts = JSup.from_dict(jparse(spec)), TSup.from_dict(tparse(spec))
    assert (ts.suppression_cloud, ts.suppressed_parcel_type) == ("sprayCloud", 3)
    rng = np.random.default_rng(7)
    n, nC = 500, 60
    st = {"cell": rng.integers(0, nC, n), "alive": rng.uniform(size=n) < 0.9,
          "canCombust": np.ones(n, np.int32), "typeId": rng.integers(0, 5, n).astype(np.int32)}
    vdot = rng.uniform(0.0, 40.0, nC)
    jst = dict({k: J(v) for k, v in st.items()}, rng=jax.random.PRNGKey(9))
    tst = dict({k: T(v) for k, v in st.items()}, rng=prng.PRNGKey(9))
    for _ in range(3):
        jst = js.collide(jst, J(vdot), 0.01)
        tst = ts.collide(tst, T(vdot), 0.01)
    for k in ("canCombust", "typeId", "rng"):
        _same(tst[k], jst[k])
    assert (_np(tst["canCombust"]) == -1).any()


# ---------------------------------------------------------------- fvDOM
@pytest.mark.parametrize("model,n_bands", (("greyMean", 1), ("wsggBand", 1), ("wsggBand", 2)))
def test_fvdom_spray_terms(model, n_bands, tmp_path):
    """One fvDOM calculate() with the spray's radiation fields (aDisp,
    sigmap, Ep and the anisotropic in-scatter): the same bands as fvDOM's,
    or fewer (lumped to grey and split equally); I and G to 1e-10."""
    from test_torch_radiation import _models, _rad_pair, _state, cases as cases_fixture

    cases = cases_fixture.__wrapped__(type("F", (), {"mktemp": lambda self, n: tmp_path})())
    jm, tm = _models(cases, model)
    js, ts = _state(cases, 9)
    jrad, trad = _rad_pair(jm, tm, 10)
    rng = np.random.default_rng(n_bands)
    nC = cases["tg"].n_cells
    sig = rng.uniform(0.0, 2.0, (n_bands, nC))
    cr = {"ap": rng.uniform(0.0, 1.5, (n_bands, nC)), "sigmap": sig,
          "asy": sig * rng.uniform(-0.6, 1.2, (n_bands, nC)),
          "Ep": rng.uniform(0.0, 5e4, (n_bands, nC))}
    js["cloud_rad"] = {k: J(v) for k, v in cr.items()}
    ts["cloud_rad"] = {k: T(v) for k, v in cr.items()}
    jout = jm._solve_rays(jrad, js, cases["jgas"])
    tout = tm._solve_rays(trad, ts, cases["tgas"])
    for k in ("I", "G"):
        _same(tout[k], jout[k])
    assert tm.n_lambda == (1 if model == "greyMean" else 4)  # wsggBand: the lumped path
