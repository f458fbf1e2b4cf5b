"""The port's radiation family against the JAX package, module by module, on
CPU in float64 with the same seeded inputs (rel 1e-10 unless a test says
otherwise): the blackbody fractions, every band model's eval, the grey
WSGG models, the grey-mean absorption with and without its ft table, the
spSoot flamelet table, mixtureFractionSoot, one fvDOM ray solve per model
family (the K1 twin's iteration counts equal), P1's G solve, viewFactor's F
and radiosity solve, opaqueSolid, the boundary fluxes, the model selection,
and the parts that wait for other slices (they raise naming the item).

Cases come from firefoam_torch.utils.synthcase.write_radiation_fire_case on a
(6, 5, 6) lattice; both packages read the same files.
"""

import contextlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import firefoam_tpu.radiation.fvdom as jfvdom
import firefoam_tpu.radiation.p1 as jp1
from firefoam_tpu.io import Case as JCase
from firefoam_tpu.io import parse_string as jparse_string
from firefoam_tpu.io.foamdict import parse_file as jparse
from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_tpu.ops import SurfaceField as JSF
from firefoam_tpu.ops import VolField as JVF
from firefoam_tpu.radiation import make_radiation as j_make
from firefoam_tpu.radiation import make_soot_model as j_soot
from firefoam_tpu.radiation import spectral as jspec
from firefoam_tpu.radiation import wsggm as jwsggm
from firefoam_tpu.radiation.spsoot import SpSootRadFrac as JSp
from firefoam_tpu.radiation.viewfactor import OpaqueSolid as JOpaque
from firefoam_tpu.thermo import GasThermo as JGas
from firefoam_tpu.thermo import SingleStepReaction as JRx
from firefoam_torch.io import Case as TCase
from firefoam_torch.io import parse_string as tparse_string
from firefoam_torch.io.foamdict import parse_file as tparse
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.ops import SurfaceField as TSF
from firefoam_torch.ops import VolField as TVF
from firefoam_torch.radiation import FvDOM as TDOM
from firefoam_torch.radiation import P1 as TP1
from firefoam_torch.radiation import make_radiation as t_make
from firefoam_torch.radiation import make_soot_model as t_soot
from firefoam_torch.radiation import spectral as tspec
from firefoam_torch.radiation import wsggm as twsggm
from firefoam_torch.radiation.fvdom import grey_absorption as t_grey
from firefoam_torch.radiation.fvdom import interp
from firefoam_torch.radiation.spsoot import SpSootRadFrac as TSp
from firefoam_torch.radiation.viewfactor import OpaqueSolid as TOpaque
from firefoam_torch.radiation.viewfactor import ViewFactorRadiation as TVFac
from firefoam_torch.thermo import GasThermo as TGas
from firefoam_torch.thermo import SingleStepReaction as TRx
from firefoam_torch.utils.synthcase import RADIATION_MODELS, write_radiation_fire_case

torch.set_num_threads(1)
TOL = 1e-10
N = (6, 5, 6)
SPECIES = ["O2", "H2O", "C3H8", "CO2", "N2"]


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rel(a, b, floor=1e-300):
    a, b = np.asarray(_np(a), np.float64), np.asarray(_np(b), np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), floor))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """One case per radiation model (same mesh, gas and reaction), and both
    packages' geometry, gas and reaction."""
    base = tmp_path_factory.mktemp("rad")
    roots = {m: write_radiation_fire_case(str(base / m), n=N, model=m, n_bands=3)
             for m in RADIATION_MODELS}
    root = roots["greyMean"]
    th = os.path.join(root, "constant", "thermo.gas")
    rx = os.path.join(root, "constant", "reactions")
    jgas = JGas.from_dict(jparse(th, case_dir=root), SPECIES)
    tgas = TGas.from_dict(tparse(th, case_dir=root), SPECIES)
    vf = roots["viewFactor"]  # the same mesh with the top and sides made walls
    return dict(
        roots=roots,
        jg=JGeom.from_polymesh(j_build(root).mesh, dtype=jnp.float64),
        tg=TGeom.from_polymesh(t_build(root).mesh, dtype=torch.float64, device="cpu"),
        vf_jg=JGeom.from_polymesh(j_build(vf).mesh, dtype=jnp.float64),
        vf_tg=TGeom.from_polymesh(t_build(vf).mesh, dtype=torch.float64, device="cpu"),
        jgas=jgas, tgas=tgas,
        jrx=JRx.from_case(jparse(rx, case_dir=root), jgas, "C3H8", "N2"),
        trx=TRx.from_case(tparse(rx, case_dir=root), tgas, "C3H8", "N2"),
    )


def _models(cases, model, rp_text=None):
    """(JAX model, port model) built from `model`'s case (or from the
    radiationProperties text `rp_text`), with the solver's hooks."""
    root = cases["roots"][model]
    if rp_text is None:
        path = os.path.join(root, "constant", "radiationProperties")
        jrp, trp = jparse(path), tparse(path)
    else:
        jrp, trp = jparse_string(rp_text), tparse_string(rp_text)
    pre = "vf_" if model == "viewFactor" else ""
    jm = j_make(jrp, cases[pre + "jg"], JCase(root))
    tm = t_make(trp, cases[pre + "tg"], TCase(root))
    if hasattr(jm, "ae_model"):
        jm.reaction, tm.reaction = cases["jrx"], cases["trx"]
        jm.epsilon_fn = lambda st: st["eps"]
        tm.epsilon_fn = lambda st: st["eps"]
    return jm, tm


def _state(cases, seed, rad=None, T_wall=None):
    """Seeded gas state on cells and boundary faces, for both packages."""
    jg = cases["jg"]
    nC, nB, nI = jg.n_cells, jg.n_boundary, jg.n_internal
    rng = np.random.RandomState(seed)
    Y = rng.rand(nC, len(SPECIES))
    Y[:, 2] *= 0.3  # leaner in fuel: the mixture fraction spans the table
    Y /= Y.sum(1, keepdims=True)
    Yb = rng.rand(nB, len(SPECIES))
    Yb /= Yb.sum(1, keepdims=True)
    arrs = dict(
        T=(300.0 + 1500.0 * rng.rand(nC),
           rng.choice([250.0, 350.0, 2450.0, 2600.0], nB) if T_wall is None
           else np.full(nB, T_wall)),
        Y=(Y, Yb),
        p=(101325.0 + 50.0 * rng.randn(nC), 101325.0 + 50.0 * rng.randn(nB)),
        rho=(0.3 + rng.rand(nC), 0.3 + rng.rand(nB)),
        mu=(1.5e-5 + 3e-5 * rng.rand(nC), 1.5e-5 + 3e-5 * rng.rand(nB)),
        hs=(1e6 * rng.randn(nC), 1e6 * rng.randn(nB)),
    )
    flat = dict(Qdot=1e6 * rng.rand(nC), eps=10.0 ** rng.uniform(-3, 3, nC),
                localRadFrac=0.1 + 0.3 * rng.rand(nC))
    phi = (np.zeros(nI), 1e-3 * rng.randn(nB))

    def build(VF, SF, arr):
        st = {k: VF(arr(a), arr(b)) for k, (a, b) in arrs.items()}
        st.update({k: arr(v) for k, v in flat.items()})
        st["phi"] = SF(arr(phi[0]), arr(phi[1]))
        return st

    return build(JVF, JSF, jnp.asarray), build(TVF, TSF, torch.as_tensor)


@contextlib.contextmanager
def _jax_iterations(module):
    """The iteration counts of every bicgstab solve the JAX `module` runs:
    one list per solve call (per sweep under vmap), in the order JAX
    reports them."""
    got, orig = [], module.bicgstab

    def wrapped(*a, **k):
        res = orig(*a, **k)
        jax.debug.callback(lambda n: got.append(int(n)), res.n_iterations)
        return res

    module.bicgstab = wrapped
    try:
        yield got
    finally:
        module.bicgstab = orig
    jax.effects_barrier()


# ------------------------------------------------------------ spectral.py
def test_blackbody_fraction_and_band_fractions():
    lamT = np.concatenate([[0.0, 1e-3], np.logspace(1, 7, 97)])
    assert _rel(tspec.blackbody_fraction(torch.as_tensor(lamT)),
                jspec.blackbody_fraction(jnp.asarray(lamT))) <= TOL
    assert float(tspec.blackbody_fraction(1e9)) == pytest.approx(1.0, abs=1e-9)
    T = np.linspace(250.0, 3000.0, 23)
    bands = ((1e-7, 2.63e-6), (2.63e-6, 4.13e-6), (4.13e-6, 1e-3), (1.0, 1.0))
    assert _rel(tspec.band_fractions(bands, torch.as_tensor(T)),
                jspec.band_fractions(bands, jnp.asarray(T))) <= TOL


_JOHANSSON = """
    band0 { species { mix { Tcommon 1200; Tlow 300; Thigh 2500; invTemp false;
        loTcoeffs (0.055 0.012 0.358 0.0731 -0.0466 0.392 -0.212 0.0404 -0.0831 0.0552 -0.0103);
        hiTcoeffs (0.06 0.01 0.3 0.07 -0.04 0.4 -0.2 0.04 -0.08 0.05 -0.01); } } }
    band1 { species { mix { Tcommon 1200; Tlow 300; Thigh 2500; invTemp false;
        loTcoeffs (0.88 -0.119 0.392 -0.249 0.0466 0.131 0.0268 -0.0285 -0.0327 0.0155 -0.0024);
        hiTcoeffs (0.9 -0.1 0.4 -0.25 0.05 0.13 0.03 -0.03 -0.03 0.015 -0.002); } } }
    band2 { species { mix { Tcommon 1200; Tlow 300; Thigh 2500; invTemp false;
        loTcoeffs (10.0 0.0 0.142 0.0469 -0.0192 0.0382 -0.0215 0.0056 0.0052 -0.0043 0.0008);
        hiTcoeffs (10.0 0.0 0.14 0.05 -0.02 0.04 -0.02 0.006 0.005 -0.004 0.001); } } }
"""


def _band_model_coeffs(cases, name):
    """(model class name, coeffs text, variant) of each band model."""
    rp = lambda m: open(os.path.join(cases["roots"][m], "constant", "radiationProperties")).read()
    body = lambda txt, key: txt[txt.index(key + "Coeffs"):]
    wide = body(rp("wideBand"), "wideBandAbsorptionEmission")
    smith = body(rp("wsggBand"), "wsggmAbsorptionEmissionSmithBand")
    inner = lambda txt: txt[txt.index("{") + 1: txt.rindex("}", 0, txt.index("scatterModel"))]
    return {
        "wideBand": ("WideBandAE", inner(wide), None),
        "smith": ("WSGGBandAE", inner(smith), "smith"),
        "cassol": ("WSGGBandAE", inner(smith), "cassol"),
        "johansson": ("WSGGBandAE", _JOHANSSON, "johansson"),
        "constRadFracWideBand": ("ConstRadFracWideBandAE",
                                 "EhrrCoeff 0.3; radTemp 1300; band0 { bandLimits (1.0e-6 4.0e-6); }"
                                 " band1 { bandLimits (4.0e-6 1.0e-5); }"
                                 " band2 { bandLimits (1.0e-5 200e-6); }", None),
    }[name]


def _build_band_model(mod, parse, cls_name, text, variant):
    cls = getattr(mod, cls_name)
    d = parse(text)
    return cls.from_coeffs(d, variant) if variant else cls.from_coeffs(d)


@pytest.mark.parametrize("name", ["wideBand", "smith", "cassol", "johansson",
                                  "constRadFracWideBand", "binary"])
def test_band_model_eval(cases, name):
    """Each band model's (a, a_b, E, enFrac, enFrac_b) on the same seeded
    temperatures, compositions, pressures and heat release."""
    js, ts = _state(cases, 1)
    models = []
    for part in (("wideBand", "constRadFracWideBand") if name == "binary" else (name,)):
        cls_name, text, variant = _band_model_coeffs(cases, part)
        models.append((_build_band_model(jspec, jparse_string, cls_name, text, variant),
                       _build_band_model(tspec, tparse_string, cls_name, text, variant)))
    if name == "binary":
        jm, tm = jspec.BinaryAE(*[m[0] for m in models]), tspec.BinaryAE(*[m[1] for m in models])
    else:
        jm, tm = models[0]
    assert tm.n_lambda == jm.n_lambda >= 2
    args = lambda st, gas, chi: (st["T"].i, st["T"].b, st["Y"].i, st["Y"].b, st["p"].i,
                                 st["p"].b, gas, st["Qdot"], chi)
    jout = jm.eval(*args(js, cases["jgas"], jnp.asarray(0.25)))
    tout = tm.eval(*args(ts, cases["tgas"], torch.tensor(0.25, dtype=torch.float64)))
    assert set(tout) == set(jout)
    for k in jout:
        assert _rel(tout[k], jout[k], floor=1e-30) <= TOL, k


def test_grey_mean_solid():
    text = "wood { absorptivity 0.7; emissivity 0.8; } char { absorptivity 0.9; emissivity 0.85; } gas { }"
    jm = jspec.GreyMeanSolidAE.from_coeffs(jparse_string(text))
    tm = tspec.GreyMeanSolidAE.from_coeffs(tparse_string(text))
    assert (tm.names, tm.absorptivity, tm.emissivity) == (jm.names, jm.absorptivity, jm.emissivity)
    X = np.random.RandomState(2).rand(2, 40)
    jx = {"wood": jnp.asarray(X[0]), "char": jnp.asarray(X[1])}
    tx = {"wood": torch.as_tensor(X[0]), "char": torch.as_tensor(X[1])}
    assert _rel(tm.a_of(tx), jm.a_of(jx)) <= TOL
    assert _rel(tm.e_of(tx), jm.e_of(jx)) <= TOL
    assert tm.a_of({}) is None and jm.a_of({}) is None


# --------------------------------------------------------------- wsggm.py
@pytest.mark.parametrize("model,ratio", [("Smith", 2), ("Smith", 1), ("Smith", 0.001),
                                         ("Smith", 1000), ("Smith", 10), ("Cassol", 2),
                                         ("Cassol", 1), ("Cassol", 0)])
def test_wsggm_grey(cases, model, ratio):
    """a(T, Y, p, gas, fv) over temperatures that reach every band of the
    fits (up to 3200 K), with a soot volume fraction."""
    text = f"pathLength pathLength [0 1 0 0 0] 0.7; Pw_div_Pc {ratio}; Csoot 1.5e3;"
    jm = getattr(jwsggm, f"WSGGMGrey{model}").from_coeffs(jparse_string(text))
    tm = getattr(twsggm, f"WSGGMGrey{model}").from_coeffs(tparse_string(text))
    assert (tm.path_length, tm.regime, tm.c_soot) == (jm.path_length, jm.regime, jm.c_soot)
    rng = np.random.RandomState(3)
    n = 64
    T = np.linspace(300.0, 3200.0, n)
    Y = rng.rand(n, len(SPECIES))
    Y /= Y.sum(1, keepdims=True)
    p = 101325.0 * (0.8 + 0.4 * rng.rand(n))
    fv = 1e-6 * rng.rand(n)
    J = lambda *a: [jnp.asarray(x) for x in a]
    Tt = lambda *a: [torch.as_tensor(x) for x in a]
    for with_fv in (False, True):
        ja = jm.a(*J(T, Y, p), cases["jgas"], fv=jnp.asarray(fv) if with_fv else None)
        ta = tm.a(*Tt(T, Y, p), cases["tgas"], fv=torch.as_tensor(fv) if with_fv else None)
        assert _rel(ta, ja) <= TOL


# ------------------------------------------------------ grey absorption
@pytest.mark.parametrize("table", [True, False])
def test_grey_absorption(cases, table):
    """greyMeanAbsorptionEmission: CO2 and H2O from the transported mass
    fractions; CO and soot from the ft table (linear interpolation over the
    mixture fraction), or skipped without it."""
    jm, tm = _models(cases, "greyMean")
    assert tm.ft_table is not None and set(tm.ft_table[1]) == {"CO", "soot"}
    js, ts = _state(cases, 4)
    jtab, ttab = (jm.ft_table, tm.ft_table) if table else (None, None)
    ja = jfvdom.grey_absorption(jm.grey_species, 0.0, jm.ae_model, cases["jg"], js,
                                cases["jgas"], ft_table=jtab, reaction=cases["jrx"])
    ta = t_grey(tm.grey_species, 0.0, tm.ae_model, cases["tg"], ts, cases["tgas"],
                ft_table=ttab, reaction=cases["trx"])
    for a, b in zip(ta, ja):
        assert _rel(a, b) <= TOL
    assert float(ta[0].max()) > 0.0
    # the table adds absorption: CO and soot have no transported fraction
    other = t_grey(tm.grey_species, 0.0, tm.ae_model, cases["tg"], ts, cases["tgas"],
                   ft_table=None if table else tm.ft_table, reaction=cases["trx"])
    assert (float((ta[0] - other[0]).abs().max()) > 0.0)


def test_ft_table_interpolation_in_float32(cases):
    """The ft-table interpolation in float32 (the card's dtype) against
    float64: within float32 round-off of the table's values."""
    _, tm = _models(cases, "greyMean")
    grid, cols = tm.ft_table
    ft = torch.as_tensor(np.random.RandomState(5).rand(1000))
    for col in cols.values():
        f64 = interp(ft, torch.as_tensor(grid), torch.as_tensor(col))
        f32 = interp(ft.float(), torch.as_tensor(grid, dtype=torch.float32),
                     torch.as_tensor(col, dtype=torch.float32))
        assert _rel(f32.double(), f64) <= 1e-6
        assert _rel(f64, np.interp(ft.numpy(), grid, col)) <= 1e-14


# --------------------------------------------------------------- spsoot.py
class _JGasLike:
    """The spSoot test gas of the JAX package's own tests, both packages'
    hc_species conventions."""

    species = ["O2", "H2O", "C3H8", "CO2", "N2"]
    hc = np.array([0.0, -1.3e7, 4.64e7, -8.9e6, 0.0])

    def index(self, n):
        return self.species.index(n)


class _JGasSp(_JGasLike):
    def hc_species(self, dtype=None):
        return jnp.asarray(self.hc)


class _TGasSp(_JGasLike):
    def hc_species(self, like):
        return torch.as_tensor(self.hc, dtype=like.dtype)


class _Rx:
    fuel_index = 2
    s = 3.63


@pytest.mark.parametrize("global_yo2", [True, False])
def test_spsoot_psi_r(cases, global_yo2):
    """PsiR from the case's flamelet table (clamped bilinear in strain rate
    and prior loss, blended between the oxidiser tables) and from a table
    that the oxidiser fraction leaves (globalYO2 off: the local Y_O2)."""
    jm, tm = _models(cases, "spSoot")
    js, ts = _state(cases, 6)
    ja = jm.spsoot.psi_r(js, cases["jgas"], cases["jrx"], js["eps"])
    ta = tm.spsoot.psi_r(ts, cases["tgas"], cases["trx"], ts["eps"])
    assert _rel(ta, ja) <= TOL and 0.0 < float(ta.max()) <= 1.0
    sr, hp = [10.0, 100.0, 1000.0], [0.0, 0.5, 1.0]
    tabs = [np.linspace(0.1, 0.5, 9), np.linspace(0.05, 0.2, 9)]
    kw = dict(fuel="C3H8", ceta=0.04, yo2_inf=0.20, global_yo2=global_yo2)
    jsp, tsp = JSp(sr, hp, [0.233, 0.1], tabs, **kw), TSp(sr, hp, [0.233, 0.1], tabs, **kw)
    rng = np.random.RandomState(7)
    n = 50
    Y = rng.rand(n, 5)
    Y[:, 0] = np.linspace(0.0, 0.3, n)  # O2 across and beyond the tables
    st = {"Y": Y, "T": 300 + 1500 * rng.rand(n), "rho": 0.3 + rng.rand(n),
          "mu": 1.8e-5 * (1 + rng.rand(n)), "hs": 1e6 * rng.randn(n)}
    eps = 10.0 ** rng.uniform(-2, 6, n)
    jst = {k: JVF(jnp.asarray(v), None) for k, v in st.items()}
    tst = {k: TVF(torch.as_tensor(v), None) for k, v in st.items()}
    assert _rel(tsp.psi_r(tst, _TGasSp(), _Rx(), torch.as_tensor(eps)),
                jsp.psi_r(jst, _JGasSp(), _Rx(), jnp.asarray(eps))) <= TOL


# ----------------------------------------------------------------- soot.py
def test_mixture_fraction_soot(cases):
    path = os.path.join(cases["roots"]["greyMean"], "constant", "radiationProperties")
    jm, tm = j_soot(jparse(path), cases["jrx"]), t_soot(tparse(path), cases["trx"])
    assert (tm.map_index, tm.map_max) == (jm.map_index, jm.map_max)
    assert tm.soot_max == pytest.approx(jm.soot_max, rel=1e-15)
    Y = np.random.RandomState(8).rand(30, len(SPECIES))
    assert _rel(tm.soot(torch.as_tensor(Y)), jm.soot(jnp.asarray(Y))) <= TOL
    # the default mapping field (CO2 among the products) and 'none'
    text = "sootModel mixtureFractionSoot<gasHThermoPhysics>; mixtureFractionSootCoeffs { nuSoot 0.03; }"
    jd, td = j_soot(jparse_string(text), cases["jrx"]), t_soot(tparse_string(text), cases["trx"])
    assert (td.map_index, td.soot_max) == (jd.map_index, pytest.approx(jd.soot_max, rel=1e-15))
    assert t_soot(tparse_string("sootModel none;"), cases["trx"]) is None


# ------------------------------------------------------------ fvDOM solve
def _rad_pair(jm, tm, seed):
    """Both packages' radiation state with the same seeded intensities."""
    jrad, trad = jm.initial_state(), tm.initial_state()
    assert tuple(trad["I"].shape) == tuple(jrad["I"].shape)
    I0 = 50.0 * np.random.RandomState(seed).rand(*jrad["I"].shape)
    return dict(jrad, I=jnp.asarray(I0)), dict(trad, I=torch.as_tensor(I0))


@pytest.mark.parametrize("model", ["greyMean", "wideBand", "wsggBand", "spSoot",
                                   "localFuelRadFraction", "constantAbsorption"])
def test_solve_rays(cases, model):
    """One fvDOM calculate() from the same intensities, temperatures,
    compositions and heat release: I, G, E, a, aG, aEn, chi to 1e-10 and
    the K1 twin's iteration counts of every (ray × band) row equal, sweep
    by sweep (grey-mean: maxIter 3 with convergence 1e-3); then Sh."""
    rp = None
    base = {"localFuelRadFraction": "spSoot", "constantAbsorption": "greyMean"}.get(model, model)
    if model == "localFuelRadFraction":
        rp = ("radiation on; radiationModel fvDOM; fvDOMCoeffs { nPhi 1; nTheta 2; maxIter 1; }"
              " solverFreq 1; absorptionEmissionModel localFuelRadFractionEmission;"
              " localFuelRadFractionEmissionCoeffs { EhrrCoeff 0.3; } scatterModel none;")
    elif model == "constantAbsorption":
        rp = ("radiation on; radiationModel fvDOM; fvDOMCoeffs { nPhi 1; nTheta 2; maxIter 2;"
              " convergence 1e-12; } solverFreq 1; absorptionEmissionModel"
              " constantAbsorptionEmission; constantAbsorptionEmissionCoeffs { a 0.4; }"
              " scatterModel constantScatter; constantScatterCoeffs"
              " { sigma sigma [0 -1 0 0 0 0 0] 0.2; C C [0 0 0 0 0 0 0] 0.5; }")
    jm, tm = _models(cases, base, rp)
    assert (tm.n_rays, tm.n_lambda, tm.max_iter) == (jm.n_rays, jm.n_lambda, jm.max_iter)
    js, ts = _state(cases, 9)
    jrad, trad = _rad_pair(jm, tm, 10)
    tm.sweeps = 0
    its = []
    with _jax_iterations(jfvdom) as got:
        jout = jm._solve_rays(jrad, js, cases["jgas"])
        jax.block_until_ready(jout["I"])
    orig_sweep = tm._sweep

    def sweep(*a):
        out = orig_sweep(*a)
        its.append(tm.last_iters.tolist())
        return out

    tm._sweep = sweep
    tout = tm._solve_rays(trad, ts, cases["tgas"])
    B = tm.n_rays * tm.n_lambda
    assert len(got) == B * tm.sweeps and tm.sweeps == len(its) >= 1
    if tm.max_iter > 1:
        assert tm.sweeps > 1
    for s, mine in enumerate(its):
        # vmap reports its rows in order; inside the while loop of maxIter > 1
        # in an order of its own: compare each sweep's counts as a multiset
        ref = got[s * B:(s + 1) * B]
        assert (mine == ref) if tm.max_iter <= 1 else (sorted(mine) == sorted(ref)), s
    for k in ("I", "G", "E", "a", "aG", "aEn", "chi"):
        assert _rel(tout[k], jout[k], floor=1e-30) <= TOL, k
    assert int(tout["count"]) == int(jout["count"]) == 1
    js["rad"], ts["rad"] = jout, tout
    assert _rel(tm.Sh(ts, cases["tgas"]), jm.Sh(js, cases["jgas"])) <= TOL
    for fn in ("qr_boundary", "qin_boundary", "G_bands"):
        assert _rel(getattr(tm, fn)(tout), getattr(jm, fn)(jout)) <= TOL, fn


def test_maybe_correct_gating_and_sweeps(cases):
    """radiationModel::correct gating (the first call, then every
    solverFreq-th) with the (state, gas) signature; the sweep count the
    port keeps outside the state."""
    _, tm = _models(cases, "greyMean")
    _, ts = _state(cases, 11)
    tm.sweeps = 0
    rad = tm.initial_state()
    solved = []
    for _ in range(12):
        ts["rad"] = rad
        before = tm.sweeps
        new = tm.maybe_correct(ts, cases["tgas"])
        solved.append(tm.sweeps > before)
        assert (new["I"] is not rad["I"]) == solved[-1]
        rad = new
    assert solved == [True] + [False] * 9 + [True, False]
    assert 2 <= tm.sweeps <= 2 * tm.max_iter
    assert "sweeps" not in rad


# -------------------------------------------------------------------- P1
@pytest.mark.parametrize("model", ["constant", "greyMean", "wsggm"])
def test_p1_solve_G(cases, model):
    """P1's G solve (Marshak walls, one K1-twin row) from the same state:
    G, G_b, gamma_b, E, a, e to 1e-10, equal iteration counts; Sh, qr, qin."""
    ae = {
        "constant": ("constantAbsorptionEmission",
                     "constantAbsorptionEmissionCoeffs { a 0.3; e 0.2; EhrrCoeff 0.25; }"),
        "greyMean": ("greyMeanAbsorptionEmission", None),
        "wsggm": ("wsggmAbsorptionEmissionGreySmith",
                  "wsggmAbsorptionEmissionGreySmithCoeffs { pathLength pathLength "
                  "[0 1 0 0 0] 0.5; Pw_div_Pc 2; Csoot 0; }"),
    }[model]
    coeffs = ae[1]
    if coeffs is None:
        txt = open(os.path.join(cases["roots"]["greyMean"], "constant",
                                "radiationProperties")).read()
        coeffs = txt[txt.index("greyMeanAbsorptionEmissionCoeffs"):txt.index("scatterModel")]
    rp = (f"radiation on; radiationModel P1; solverFreq 1; absorptionEmissionModel {ae[0]};"
          f" {coeffs} scatterModel constantScatter; constantScatterCoeffs {{ sigma 0.1; }}")
    jm, tm = _models(cases, "P1", rp)
    assert isinstance(tm, TP1)
    # hot gas: the grey-mean absorption is positive in every cell
    js, ts = _state(cases, 12)
    jrad, trad = jm.initial_state(), tm.initial_state()
    with _jax_iterations(jp1) as got:
        jout = jm._solve_G(jrad, js, cases["jgas"])
        jax.block_until_ready(jout["G"])
    tout = tm._solve_G(trad, ts, cases["tgas"])
    assert got == [int(tm.last_iters)] and tm.solves == 1
    for k in jout:
        assert _rel(tout[k], jout[k], floor=1e-30) <= TOL, k
    js["rad"], ts["rad"] = jout, tout
    assert _rel(tm.Sh(ts, cases["tgas"]), jm.Sh(js, cases["jgas"])) <= TOL
    assert _rel(tm.qr_boundary(tout), jm.qr_boundary(jout)) <= TOL
    assert _rel(tm.qin_boundary(tout), jm.qin_boundary(jout)) <= TOL


# ------------------------------------------------------------ viewFactor
def test_view_factor(cases):
    """The host-built F (orientation-only visibility, 50 scaling passes) to
    1e-12, the 30-sweep radiosity solve and the gating; an isothermal
    enclosure exchanges nothing."""
    jm, tm = _models(cases, "viewFactor")
    assert isinstance(tm, TVFac) and tm.solver_freq == jm.solver_freq
    np.testing.assert_array_equal(_np(tm.sel), _np(jm.sel))
    assert len(_np(tm.sel)) > 0
    assert _rel(tm.F, jm.F) <= 1e-12
    assert _rel(tm.F.sum(1), np.ones(len(_np(tm.sel)))) <= 1e-6
    js, ts = _state(cases, 13)
    for a, b in zip(tm._solve(ts["T"].b), jm._solve(js["T"].b)):
        assert _rel(a, b) <= TOL
    q_iso, _ = tm._solve(torch.full_like(ts["T"].b, 600.0))
    assert float(q_iso.abs().max()) <= 1e-6 * 5.670367e-8 * 600.0**4
    jrad, trad = jm.initial_state(), tm.initial_state()
    for _ in range(tm.solver_freq + 1):
        js["rad"], ts["rad"] = jrad, trad
        jrad, trad = jm.maybe_correct(js, cases["jgas"]), tm.maybe_correct(ts, cases["tgas"])
        for k in jrad:
            assert _rel(trad[k], jrad[k], floor=1.0) <= TOL, k
        assert _rel(tm.qr_boundary(trad), jm.qr_boundary(jrad), floor=1.0) <= TOL
        assert _rel(tm.qin_boundary(trad), jm.qin_boundary(jrad), floor=1.0) <= TOL
    assert float(trad["qin_b"].abs().max()) > 0.0
    assert float(tm.Sh(ts, cases["tgas"]).abs().max()) == 0.0
    assert tuple(tm.G_bands(trad).shape) == (1, cases["tg"].n_cells)


def test_opaque_solid(cases):
    rp = ("radiation on; radiationModel opaqueSolid; absorptionEmissionModel"
          " constantAbsorptionEmission; constantAbsorptionEmissionCoeffs { a 0.6; e 0.4; }")
    jm, tm = _models(cases, "viewFactor", rp)
    assert isinstance(tm, TOpaque) and isinstance(jm, JOpaque)
    assert (tm.absorptivity, tm.emissivity) == (jm.absorptivity, jm.emissivity) == (0.6, 0.4)
    _, ts = _state(cases, 14)
    ts["rad"] = tm.initial_state()
    assert tm.maybe_correct(ts, None) is ts["rad"]
    for x in (tm.Sh(ts, None), tm.qr_boundary(ts["rad"]), tm.qin_boundary(ts["rad"]),
              tm.G_bands(ts["rad"])):
        assert float(x.abs().max()) == 0.0


# ------------------------------------------------------------- selection
def test_make_radiation_selects_every_model(cases):
    """Every branch of radiationModel::New, each fvDOM absorption-emission
    model with its band count, maxIter > 1, the absorptivity lookup wall
    and 'none'/'radiation off'."""
    for model in RADIATION_MODELS:
        jm, tm = _models(cases, model)
        assert type(tm).__name__ == type(jm).__name__, model
        if isinstance(tm, TDOM):
            assert (tm.ae_model, tm.n_lambda, tm.max_iter, tm.convergence) == (
                jm.ae_model, jm.n_lambda, jm.max_iter, jm.convergence)
            assert (tm.sigma_s, tm.scatter_C) == (jm.sigma_s, jm.scatter_C)
            assert _rel(tm.emissivity, jm.emissivity) == 0.0
            assert _rel(tm.absorptivity, jm.absorptivity) == 0.0
            # the base wall: ε 0.9, absorptivity 0.7 (lookup)
            assert sorted(set(_np(tm.absorptivity).tolist())) == [0.7, 1.0]
    for text in ("radiation off; radiationModel fvDOM;", "radiation on; radiationModel none;"):
        assert t_make(tparse_string(text), cases["tg"], None) is None
    # every absorptionEmissionModel of the JAX package's fvDOM
    for aem, coeffs in (
        ("wsggmAbsorptionEmissionGreySmith", "pathLength 1; Pw_div_Pc 2;"),
        ("wsggmAbsorptionEmissionGreyCassol", "pathLength 1; Pw_div_Pc 1;"),
        ("wsggmAbsorptionEmissionCassolBand", _band_model_coeffs(cases, "cassol")[1]),
        ("wsggmAbsorptionEmissionJohanssonBand", _JOHANSSON),
        ("constRadFracWideBandEmission", _band_model_coeffs(cases, "constRadFracWideBand")[1]),
        ("binaryAbsorptionEmission",
         "model1 wideBandAbsorptionEmission; model2 cloudAbsorptionEmission;"
         " wideBandAbsorptionEmissionCoeffs { " + _band_model_coeffs(cases, "wideBand")[1] + " }"),
    ):
        rp = (f"radiation on; radiationModel fvDOM; fvDOMCoeffs {{ nPhi 1; nTheta 1; }}"
              f" absorptionEmissionModel {aem}; {aem}Coeffs {{ {coeffs} }}")
        jm, tm = _models(cases, "greyMean", rp)
        assert tm.n_lambda == jm.n_lambda, aem
        assert type(tm.spectral).__name__ == type(jm.spectral).__name__, aem
        assert type(tm.wsggm).__name__ == type(jm.wsggm).__name__, aem
        assert tm._e_qdot_coeff() == pytest.approx(jm._e_qdot_coeff(), rel=1e-14), aem


def test_deferred_parts_raise_naming_their_item(cases, tmp_path):
    """The solid-coupled wall modes (ported with the region models): each
    builds the solid masks the JAX package builds (absorptivityMode
    'emissivity' mirrors the emissivity's mask). The spray terms no longer
    wait (the cloud is ported): zero spray fields give the solve without
    them."""
    root = write_radiation_fire_case(str(tmp_path / "solid"), n=(4, 4, 4), model="greyMean")
    path = os.path.join(root, "0", "IDefault")
    txt = open(path).read()
    for old, new in (("emissivityMode lookup;\n        emissivity uniform 0.9;",
                      "emissivityMode solidRadiation;\n        emissivity uniform 0.9;"),
                     ("absorptivityMode lookup;", "absorptivityMode pyrolysisModel;")):
        assert old in txt
        with open(path, "w") as f:
            f.write(txt.replace(old, new))
        g = TGeom.from_polymesh(t_build(root).mesh, dtype=torch.float64, device="cpu")
        rp = tparse(os.path.join(root, "constant", "radiationProperties"))
        tm = t_make(rp, g, TCase(root))
        jm = j_make(jparse(os.path.join(root, "constant", "radiationProperties")),
                    JGeom.from_polymesh(j_build(root).mesh), JCase(root))
        assert tm.solid_eps_mask.any() or tm.solid_abs_mask.any()
        for m in ("solid_eps_mask", "solid_abs_mask"):
            assert np.array_equal(getattr(tm, m), np.asarray(getattr(jm, m))), m
        for a in ("emissivity", "absorptivity"):
            assert np.array_equal(getattr(tm, a).numpy(), np.asarray(getattr(jm, a))), a
    _, tm = _models(cases, "greyMean")
    _, ts = _state(cases, 15)
    plain = tm._solve_rays(tm.initial_state(), ts, cases["tgas"])
    z = torch.zeros((1, cases["tg"].n_cells), dtype=torch.float64)
    ts["cloud_rad"] = {"ap": z, "sigmap": z, "asy": z, "Ep": z}
    spray = tm._solve_rays(tm.initial_state(), ts, cases["tgas"])
    assert torch.equal(spray["I"], plain["I"]) and torch.equal(spray["G"], plain["G"])


def test_try_from_case_and_the_deferred_model(cases):
    """FvDOM.try_from_case: None where the case runs no fvDOM, a deferred
    model before the geometry exists, which bind(geom) builds as
    make_radiation does."""
    from firefoam_tpu.radiation.fvdom import FvDOM as JDOM

    root = cases["roots"]["wideBand"]
    assert TDOM.try_from_case(cases["roots"]["P1"]) is None
    assert JDOM.try_from_case(cases["roots"]["P1"]) is None
    deferred = TDOM.try_from_case(root)
    assert type(deferred).__name__ == type(JDOM.try_from_case(root)).__name__ == "_DeferredFvDOM"
    bound = deferred.bind(cases["tg"])
    _, tm = _models(cases, "wideBand")
    assert (bound.ae_model, bound.n_rays, bound.n_lambda) == (tm.ae_model, tm.n_rays, tm.n_lambda)
    assert torch.equal(bound.phi_ray_b, tm.phi_ray_b)
    direct = TDOM.try_from_case(root, cases["tg"])
    assert isinstance(direct, TDOM) and direct.max_iter == tm.max_iter
