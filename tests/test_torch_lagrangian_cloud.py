"""The port's ReactingCloud against the JAX package's on the CPU in float64:
10 `evolve` calls from `initial_state(seed)` on a fixed, seeded gas context,
with `alive` and `cell` equal and every parcel field, injector, collector
and cloud-function state and every gas-side source within 1e-9, in three
configurations on the spray fire case of
firefoam_torch.utils.synthcase at (6, 5, 6):

  * the case's own cloud: the detailed sprinkler, the collector, the
    cloud's radiation (fvDOM's G_bands in the context);
  * a cone injector with a two-liquid mixture (H2O + n-heptane, a made-up
    heptane vapour species in the gas thermo: per-component evaporation
    and the "Yl" lanes), the analytical U scheme, Euler T, every cloud
    function object and a concentric-circle collector;
  * the lookup-table sprinkler with SuppressionCollision driven by a
    swept-volume field.

Also: each of the spray's stock submodels (devolatilisation with the
multiphase ledger, MPPIC's isotropy and packing, DEM pair collision, a gas
phase in the parcels, manual injection) selected in the case's cloud
dictionary builds in both packages' solvers, and one cloud step through the
solver agrees.
"""

import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.io import Case as JCase
from firefoam_tpu.io.foamdict import parse_file as jparse_file
from firefoam_tpu.lagrangian.cloud import ReactingCloud as JCloud
from firefoam_tpu.lagrangian.tracking import WalkMesh as JWalk
from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_tpu.thermo import GasThermo as JGas
from firefoam_torch.io import Case as TCase
from firefoam_torch.io.foamdict import parse_file as tparse_file
from firefoam_torch.lagrangian.cloud import ReactingCloud as TCloud
from firefoam_torch.lagrangian.tracking import WalkMesh as TWalk
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.thermo import GasThermo as TGas
from firefoam_torch.utils.synthcase import write_spray_fire_case

from test_torch_lagrangian_sprinklers import _write_lookup_tables

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
N = (6, 5, 6)
TOL = 1e-9
N_EVOLVE = 10
DT = 0.004
CAP = 4096


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(ours, ref, where=""):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), (where, set(ours) ^ set(ref))
        for k in ref:
            _same(ours[k], ref[k], f"{where}/{k}")
        return
    if isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            _same(a, b, f"{where}[{i}]")
        return
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape, (where, a.shape, b.shape)
    if where.endswith("/rows"):
        # patchPostProcessing: the scratch row past maxStoredParcels holds
        # whatever overflowed (the JAX package's scatter picks one writer)
        a, b = a[:-1], b[:-1]
    if b.dtype.kind in "biu":
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), where
    else:
        err = np.max(np.abs(a - b), initial=0.0) / max(np.max(np.abs(b), initial=0.0), 1e-300)
        assert err <= TOL, (where, err)


# the second configuration's cloud dictionary (edits of the case's own)
_CONE = ("type coneInjection; SOI 0; duration 1; massTotal 0.05; parcelsPerSecond 3000; "
         "positionAxis ( ((0.5 0.9 0.5) (0 -1 0)) ((0.3 0.8 0.4) (0.2 -1 0.1)) ); "
         "flowRateProfile constant 1; Umag constant 6; thetaInner constant 0; "
         "thetaOuter constant 35; sizeDistribution { type RosinRammler; "
         "RosinRammlerDistribution { minValue 1e-4; maxValue 1e-3; d 4e-4; n 3; } }")
_FUNCTIONS = ("cloudFunctions\n{\n"
              "    ring { type particleCollectorFmg; mode concentricCircle; origin (0.5 0.4 0.5); "
              "normal (0 -1 0); radius (0.15 0.3 0.6); nSector 4; removeCollected no; }\n"
              "    vf { type voidFraction; }\n    er { type particleErosion; patches (base); }\n"
              "    tk { type particleTracks; trackInterval 2; maxSamples 4; }\n"
              "    pp { type patchPostProcessing; patches (base sides); maxStoredParcels 40; }\n}\n")


def _configure(root, kind):
    path = os.path.join(root, "constant", "reactingCloud1Properties")
    with open(path) as f:
        txt = f.read()
    if kind == "mixture":
        txt = re.sub(r"injectionModels \{ model1 \{.*\} \}\n",
                     "injectionModels { model1 { " + _CONE + " } }\n", txt)
        txt = txt.replace("singlePhaseMixtureCoeffs { phases ( liquid { H2O 1; } ); }",
                          "singleMixtureFractionCoeffs { phases ( liquid { H2O 0.7; C7H16 0.3; } ); }")
        txt = txt.replace("integrationSchemes { U Euler; T analytical; }",
                          "integrationSchemes { U analytical; T Euler; }")
        txt = txt[:txt.index("cloudFunctions")] + _FUNCTIONS
        # n-heptane vapour for the gas: a made-up species, C3H8's janaf data
        # under another name and weight
        with open(os.path.join(root, "constant", "thermo.gas")) as f:
            thermo = f.read()
        c3 = thermo[thermo.index("C3H8 {"):thermo.index("CO2 {")]
        thermo += c3.replace("C3H8 {", "C7H16 {").replace("molWeight 44.0962", "molWeight 100.204")
        with open(os.path.join(root, "constant", "thermo.gas"), "w") as f:
            f.write(thermo)
    elif kind == "lookup":
        _write_lookup_tables(root)
        txt = re.sub(
            r"injectionModels \{ model1 \{.*\} \}\n",
            "injectionModels { model1 { type lookupTableSprinklerInjection; SOI 0; duration 100; "
            "parcelsPerSecond 9000; radiusToSprinkler 0.2; positionList ( (0.5 0.85 0.5) ); "
            "direction (0 -1 0); armDirection (1 0 0); lookupTableCoeffs { tableDirectory "
            "sprTables; sampleSize 12; } rtiCoeffs { active false; } } }\n"
            "    stochasticCollisionModel SuppressionCollision;\n"
            "    SuppressionCollisionCoeffs { suppressionCloud other; suppressedParcelType 4; }\n",
            txt)
        txt = txt.replace("    stochasticCollisionModel none;\n", "")
    with open(path, "w") as f:
        f.write(txt)


def _build(root, species):
    jm, tm = j_build(root).mesh, t_build(root).mesh
    jg = JGeom.from_polymesh(jm)
    tg = TGeom.from_polymesh(tm, dtype=torch.float64, device="cpu")
    th = os.path.join(root, "constant", "thermo.gas")
    jgas = JGas.from_dict(jparse_file(th), species)
    tgas = TGas.from_dict(tparse_file(th), species)
    jp = JCase(root).constant("reactingCloud1Properties")
    tp = TCase(root).constant("reactingCloud1Properties")
    g = (0.0, -9.81, 0.0)
    jc = JCloud("reactingCloud1", jp, JWalk.from_polymesh(jm), jg, JCase(root), jgas, g, 0.01,
                dtype=jnp.float64, capacity=CAP)
    tc = TCloud("reactingCloud1", tp, TWalk.from_polymesh(tm), tg, TCase(root), tgas, g, 0.01,
                dtype=torch.float64, capacity=CAP)
    return jc, tc, jgas


def _gas_context(jc, tc, jgas, seed):
    rng = np.random.default_rng(seed)
    nC = tc.geom.n_cells
    T = 300.0 + 500.0 * rng.uniform(size=nC) ** 3
    Y = rng.dirichlet(np.ones(jgas.n_species), nC) * 0.2
    Y[:, jgas.index("N2")] += 0.8
    g = {
        "rho": 101325.0 / (287.0 * T), "U": rng.normal(0.0, 1.0, (nC, 3)), "T": T,
        "p": 101325.0 + rng.normal(0.0, 10.0, nC), "mu": 1.8e-5 * (T / 300.0) ** 0.7,
        "kappa": 0.026 * (T / 300.0) ** 0.8, "cp": 1005.0 + 0.1 * (T - 300.0),
        "Yv": Y[:, jc.vapour_index], "W": 28.0 + rng.uniform(-1.0, 1.0, nC),
        "G_bands": rng.uniform(0.0, 2e4, (max(tc.cfg.n_bands, 1), nC)),
        "vDotSweep_sup": rng.uniform(0.0, 30.0, nC),
    }
    if tc.multi_liq:
        g["YvC"] = Y[:, list(jc.vapour_indices)]
    return g


def _evolve_both(jc, tc, jgas):
    g = _gas_context(jc, tc, jgas, 1)
    jst, tst = jc.initial_state(seed=3), tc.initial_state(seed=3)
    _same(tst, jst, "initial")
    j_evolve = jax.jit(jc.evolve)  # as the JAX package's step runs it
    for i in range(N_EVOLVE):
        t = i * DT
        jg = dict({k: jnp.asarray(v) for k, v in g.items()}, t=jnp.asarray(t))
        tg = dict({k: torch.as_tensor(v) for k, v in g.items()},
                  t=torch.tensor(t, dtype=torch.float64))
        jst, jsrc = j_evolve(jst, jg, jnp.asarray(DT))
        tst, tsrc = tc.evolve(tst, tg, torch.tensor(DT, dtype=torch.float64))
        _same(tst, jst, f"evolve {i}")
        _same({k: tsrc[k] for k in jsrc}, jsrc, f"sources {i}")
        ji, ti = jc.info(jst), tc.info(tst)
        _same(ti, ji, f"info {i}")
    return tst, tsrc


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tmp_path_factory.mktemp("cloud")


def test_case_cloud(base):
    root = write_spray_fire_case(str(base / "case"), n=N)
    jc, tc, jgas = _build(root, ["O2", "H2O", "C3H8", "CO2", "N2"])
    assert (tc.cfg.n_sub, tc.cfg.walk_steps, tc.cfg.radiation) == (
        jc.cfg.n_sub, jc.cfg.walk_steps, jc.cfg.radiation)
    st, src = _evolve_both(jc, tc, jgas)
    assert int(st["alive"].sum()) > 0 and "cloud_rad" in src
    assert float(src["rhoTrans"].sum()) > 0.0


def test_mixture_cone_and_functions(base):
    root = write_spray_fire_case(str(base / "mix"), n=N, injector="cone", radiation=False)
    _configure(root, "mixture")
    jc, tc, jgas = _build(root, ["O2", "H2O", "C3H8", "CO2", "N2", "C7H16"])
    assert tc.multi_liq and jc.multi_liq and tc.vapour_fracs == pytest.approx(jc.vapour_fracs)
    assert [type(f).__name__ for f in tc.cloud_functions] == [
        "VoidFraction", "ParticleErosion", "ParticleTracks", "PatchPostProcessing"]
    st, src = _evolve_both(jc, tc, jgas)
    assert float(src["pcTrans"].sum()) > 0.0


def test_lookup_sprinkler_with_suppression(base):
    root = write_spray_fire_case(str(base / "lookup"), n=N, collector=False)
    _configure(root, "lookup")
    jc, tc, jgas = _build(root, ["O2", "H2O", "C3H8", "CO2", "N2"])
    assert tc.suppression is not None
    st, _ = _evolve_both(jc, tc, jgas)
    assert (st["canCombust"] == -1).any()


# each selects one of the spray's stock submodels (ROADMAP P12b) in the spray
# fire case's reactingCloud1Properties: (old, new) text; _COEFFS adds the
# coefficients a model needs (the DEM case is cut to 512 slots)
_WAITS = (
    ("devolatilisationModel none;", "devolatilisationModel constantRateDevolatilisation;", "P12b"),
    ("stochasticCollisionModel none;", "stochasticCollisionModel none;\n    "
     "isotropyModel stochastic;", "P12b"),
    ("stochasticCollisionModel none;", "stochasticCollisionModel none;\n    "
     "collisionModel pairCollision;", "P12b"),
    ("stochasticCollisionModel none;", "stochasticCollisionModel none;\n    "
     "packingModel explicit;", "P12b"),
    ("singlePhaseMixtureCoeffs { phases ( liquid { H2O 1; } ); }",
     "singlePhaseMixtureCoeffs { phases ( gas { CH4 0.2; } liquid { H2O 0.8; } ); }", "P12b"),
    ("type detailedSprinklerInjection;", "type manualInjection; positionsFile x;", "P12b"),
)
_COEFFS = {
    0: (("devolatilisationModel constantRateDevolatilisation;",
         "devolatilisationModel constantRateDevolatilisation;\n    "
         "constantRateDevolatilisationCoeffs { volatileData ( (C3H8 12) ); residualCoeff 0.01; }"),
        ("singlePhaseMixtureCoeffs { phases ( liquid { H2O 1; } ); }",
         "singlePhaseMixtureCoeffs { phases ( gas { C3H8 0.2; } liquid { H2O 0.8; } ); }")),
    5: (("positionsFile x;", "positionsFile x; U0 (0 -1 0); massTotal 1e-3; "
         "sizeDistribution { type fixedValue; fixedValueDistribution { value 1e-3; } }"),),
}


def _cut_capacity(mp, cap):
    """Both packages' clouds built with `cap` slots (the JAX package's dense
    DEM pair matrix at its rule's 4096 slots takes gigabytes in float64)."""
    import firefoam_torch.lagrangian.cloud as tcl
    import firefoam_tpu.lagrangian.cloud as jcl

    for mod in (jcl, tcl):
        init = mod.ReactingCloud.__init__

        def cut(self, *a, _init=init, **k):
            k["capacity"] = cap
            _init(self, *a, **k)

        mp.setattr(mod.ReactingCloud, "__init__", cut)


@pytest.mark.parametrize("old,new,item", _WAITS)
def test_waiting_submodels_raise(base, old, new, item):
    """A case that selects one of the stock submodels, which waited for
    ROADMAP P12b and raised (the name is kept from then), builds in both
    packages' solvers, and one step of the cloud through the solver
    (`_evolve_cloud` from the initial state: injection, the substeps, the
    submodel and the gas-side sources) agrees: every cloud leaf and source
    within 1e-9, masks equal."""
    from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
    from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
    from firefoam_torch.models.firefoam import state_from_numpy

    case = _WAITS.index((old, new, item))
    root = write_spray_fire_case(str(base / f"wait_{case}"), n=N)
    path = os.path.join(root, "constant", "reactingCloud1Properties")
    with open(path) as f:
        txt = f.read()
    assert old in txt and item == "P12b"
    for a, b in ((old, new),) + _COEFFS.get(case, ()):
        txt = txt.replace(a, b, 1)
    with open(path, "w") as f:
        f.write(txt)
    with open(os.path.join(root, "constant", "x"), "w") as f:
        f.write("2\n(\n(0.5 0.8 0.5)\n(0.45 0.7 0.55)\n)\n")
    with pytest.MonkeyPatch.context() as mp:
        for k in ("EXACT_SOLVERS", "AMG", "GMG", "PALLAS"):
            mp.setenv(f"FIREFOAM_TPU_{k}", "0")
        mp.setenv("FIREFOAM_TPU_DTYPE", "float64")
        if "pairCollision" in txt:
            _cut_capacity(mp, 512)
        js = JSolver(root)
        ts = TSolver(root, device="cpu", dtype=torch.float64, exact_solvers=False, gmg=False,
                     amg=False)
        st0 = js.initial_state()

        def one(s):
            log = {}
            s, out = js._evolve_cloud(s, log)
            return s["cloud"], out, log

        jcl, jout, jlog = jax.device_get(jax.jit(one)(st0))
    tlog = {}
    tst, tout = ts._evolve_cloud(state_from_numpy(jax.device_get(st0), device="cpu",
                                                  dtype=torch.float64), tlog)
    cl = ts.cloud
    assert (cl.devol is None, cl.mppic is None, cl.pair_collision is None, cl.ledger is None) == (
        js.cloud.devol is None, js.cloud.mppic is None, js.cloud.pair_collision is None,
        js.cloud.ledger is None)
    assert any(m is not None for m in (cl.devol, cl.mppic, cl.pair_collision, cl.ledger)) or \
        type(cl.injectors[0]).__name__ == "ManualInjection"
    _same(tst["cloud"], jcl, f"case {case} cloud")
    _same({k: tout[k] for k in jout if k in ("Srho", "SU", "SYv", "Sh", "SY")},
          {k: v for k, v in jout.items() if k in ("Srho", "SU", "SYv", "Sh", "SY")},
          f"case {case} sources")
    _same({k: tlog[k] for k in jlog}, jlog, f"case {case} log")
    assert int(tst["cloud"]["alive"].sum()) > 0
