"""The port's injectors against the JAX package's on the CPU in float64, from
the same keys (the port's generator reproduces jax.random, so the candidate
parcels agree): ConeInjection with each size distribution, the detailed
sprinkler v1 (the spray fire case's table) and v2 (a bin-edge table written
here) with their RTI links, PatchInjection, the analytic sprinkler (K205
single head and K162 multi-head, coefficient dicts written here) and the
lookup.foam.* family (tables written here). Candidates and injector states
within 1e-10 (cells, counts and validity equal) over several steps. Also
the injectors that wait for other slices raise, naming the item.
"""

import os
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.io import Case as JCase
from firefoam_tpu.io import parse_string as jparse
from firefoam_tpu.lagrangian import injection as jinj
from firefoam_tpu.lagrangian.tracking import WalkMesh as JWalk
from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_torch.io import Case as TCase
from firefoam_torch.io import parse_string as tparse
from firefoam_torch.lagrangian import injection as tinj
from firefoam_torch.lagrangian import prng
from firefoam_torch.lagrangian.tracking import WalkMesh as TWalk
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.utils.synthcase import write_spray_fire_case

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
TOL = 1e-10


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(ours, ref, tol=TOL):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), (set(ours), set(ref))
        for k in ref:
            _same(ours[k], ref[k], tol)
        return
    a, b = _np(ours).astype(np.float64), _np(ref).astype(np.float64)
    assert a.shape == b.shape
    if _np(ref).dtype.kind in "biu":
        assert np.array_equal(a, b)
    else:
        assert np.max(np.abs(a - b), initial=0.0) <= tol * max(np.max(np.abs(b), initial=0.0),
                                                                1e-300)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("inj") / "c")
    write_spray_fire_case(root, n=(6, 5, 6))
    _write_v2_table(root)
    _write_lookup_tables(root)
    jm, tm = j_build(root).mesh, t_build(root).mesh
    return {
        "root": root, "jc": JCase(root), "tc": TCase(root),
        "jw": JWalk.from_polymesh(jm), "tw": TWalk.from_polymesh(tm),
        "jg": JGeom.from_polymesh(jm),
        "tg": TGeom.from_polymesh(tm, dtype=torch.float64, device="cpu"),
    }


def _write_v2_table(root):
    with open(os.path.join(root, "constant", "v2table"), "w") as f:
        f.write(textwrap.dedent("""
            kFactor 16.8; radius 0.762; nEle 2; nAzi 3;
            phiMinMax ( 0 30 60 90 );
            thetaMinMax ( 0 45 90 );
            pressures
            {
                p5 { pressure 5.0; velocityCorrection 0.5; volFlux ( 1 2 3 4 5 6 );
                     dv50 ( 1 1.2 0.8 1 0.9 1.1 ); velMag ( 10 9 8 10 11 12 ); }
                p9 { pressure 9.0; velocityCorrection 0.7; volFlux ( 2 2 3 5 5 7 );
                     dv50 ( 0.9 1.1 0.7 0.9 0.8 1.0 ); velMag ( 12 11 10 12 13 14 ); }
            }
        """))


_LOOKUP = dict(nEle=4, nAzi=6)


def _write_lookup_tables(root):
    """constant/sprTables/lookup.foam.{header,avgFlux,dv50,area,avgVelMag,ele,azi}
    (made-up values on a 4 × 6 grid)."""
    d = os.path.join(root, "constant", "sprTables")
    os.makedirs(d, exist_ok=True)
    ne, na = _LOOKUP["nEle"], _LOOKUP["nAzi"]
    rng = np.random.default_rng(8)
    ele = np.tile(np.linspace(0.0, 90.0, ne), na)
    azi = np.repeat(np.arange(na) * 360.0 / na, ne)
    cols = {"avgFlux": rng.uniform(0.5, 3.0, ne * na), "dv50": rng.uniform(4e-4, 1.5e-3, ne * na),
            "area": rng.uniform(0.01, 0.05, ne * na), "avgVelMag": rng.uniform(4.0, 9.0, ne * na),
            "ele": ele, "azi": azi}
    with open(os.path.join(d, "lookup.foam.header"), "w") as f:
        f.write(f"nEle {ne}; nAzi {na}; pressure 1.4; kFactor 162; radius 0.3; dv50 0.0011; "
                "velMag 7.5;\n")
    for k, v in cols.items():
        with open(os.path.join(d, f"lookup.foam.{k}"), "w") as f:
            f.write(f"{k} List<scalar> {v.size} ( " + " ".join(f"{x:.10g}" for x in v) + " );\n")


def _analytic_dict(k_factor, multi):
    """A SprinklerInjection / MultiSprinklerInjection dict with made-up
    five-coefficient fits over 3 fit azimuths and 24 spray cells."""
    rng = np.random.default_rng(k_factor)
    e1 = np.tile([0.0, 30.0, 60.0], 8)
    e2 = e1 + 30.0
    a1 = np.repeat(np.arange(8) * 45.0, 3)
    a2 = a1 + 45.0
    L = lambda v: "( " + " ".join(f"{x:.10g}" for x in np.ravel(v)) + " )"  # noqa: E731

    def fit(lo, hi):
        return rng.uniform(lo, hi, (3, 5))

    lines = [
        f"kFactor {k_factor}; operatingPressure 2.5; radiusToSprinkler 0.2; duration 100;",
        "parcelsPerSecond 60000; direction (0 -1 0); armDirection (1 0 0);",
        "flowRateProfile constant 0.002;",
        "rtiCoeffs { active true; RTI 1; C 0.5; initialTemperature 298; "
        "activationTemperature 298.5; }",
        f"cellEleAngle1 {L(e1)}; cellEleAngle2 {L(e2)};",
        f"cellAziAngle1 {L(a1)}; cellAziAngle2 {L(a2)};",
        "fitPressureRange ( 1 4 ); fitVelocityStdevRange ( 0.5 1.5 );",
        "fitAzimuthalAngle ( 0 45 90 );",
    ]
    for name, lo, hi in (("Flux", 0.5, 4.0), ("Dv50", 0.3, 0.9), ("Sigma", 0.3, 0.8),
                         ("Gamma", 1.5, 3.0), ("Velocity", 2.0, 6.0)):
        lines.append(f"fitCoe{name}LowPres {L(fit(lo, hi))}; "
                     f"fitCoe{name}HighPres {L(fit(lo, hi) * 1.2)};")
    if multi:
        lines.append("positionList ( (0.3 0.8 0.3) (0.7 0.85 0.6) );")
    else:
        lines.append("position (0.5 0.8 0.5);")
    return "\n".join(lines)


_CONE = ("SOI 0; duration 1; massTotal 0.2; parcelsPerSecond 4000; "
         "positionAxis ( ((0.5 0.8 0.5) (0 -1 0)) ((0.3 0.7 0.4) (0.3 -1 0)) ); "
         "flowRateProfile constant 1; Umag constant 6; thetaInner constant 5; "
         "thetaOuter constant 40; ")
_SIZES = {
    "uniform": "sizeDistribution { type uniform; uniformDistribution { minValue 1e-4; "
               "maxValue 1e-3; } }",
    "fixedValue": "sizeDistribution { type fixedValue; fixedValueDistribution { value 5e-4; } }",
    "normal": "sizeDistribution { type normal; normalDistribution { expectation 5e-4; "
              "variance 1e-8; minValue 1e-4; maxValue 1e-3; } }",
    "RosinRammler": "sizeDistribution { type RosinRammler; RosinRammlerDistribution { "
                    "minValue 1e-4; maxValue 1e-3; d 4e-4; n 3; } }",
}
_DETAILED = {
    "v1": "type detailedSprinklerInjection; SOI 0; duration 100; parcelsPerSecond 2500; "
          "positionList ( (0.5 0.9 0.5) (0.3 0.85 0.6) ); direction (0 -1 0); "
          "armDirection (1 0 0); radiusToSprinkler 0.02; reductionFactor 0.2; "
          "lookupTableCoeffs { tableName sprinklerTable; operatingPressure 10; } "
          "rtiCoeffs { active true; RTI 5; C 0.4; initialTemperature 298.15; "
          "activationTemperature 298.5; }",
    "v2": "type detailedSprinklerInjection2; SOI 0; duration 100; parcelsPerSecond 1500; "
          "positionList ( (0.5 0.9 0.5) ); direction (0 -1 0); armDirection (1 0 0); "
          "radiusToSprinkler 0.05; lookupTableCoeffs { tableName v2table; "
          "operatingPressure 6.5; } rtiCoeffs { active true; RTI 5; RTI_deflector 8; "
          "C 0.2; initialTemperature 298.15; activationTemperature 298.5; }",
}
_LOOKUP_KINDS = ("lookupTableSprinklerInjection", "lookupTableVolumeFluxSprinklerInjection",
                 "uniformSamplingSprinklerInjection")


def _gas(case, seed=0):
    n = case["tg"].n_cells
    rng = np.random.default_rng(seed)
    return {"T": 300.0 + 400.0 * rng.uniform(size=n), "U": rng.normal(0.0, 2.0, (n, 3))}


def _run(case, spec, steps=6, dt=0.004, cap_dt=0.01, patch=None):
    """Build the injector in both packages and inject `steps` times from the
    same keys; compare every candidate and state. `patch(ti, ji)` may wrap
    the injectors' methods first."""
    ji = jinj.make_injector("i", jparse(spec), case["jw"], case["jc"], jnp.float64,
                            geom=case["jg"])
    ti = tinj.make_injector("i", tparse(spec), case["tw"], case["tc"], torch.float64,
                            geom=case["tg"])
    if patch is not None:
        patch(ti, ji)
    assert type(ti).__name__ == type(ji).__name__
    ji.max_per_step = ji.capacity_for_dt(cap_dt)
    ti.max_per_step = ti.capacity_for_dt(cap_dt)
    assert ti.max_per_step == ji.max_per_step
    jst, tst = ji.init_state(), ti.init_state()
    _same(tst, jst)
    g = _gas(case)
    jgas = {k: jnp.asarray(v) for k, v in g.items()}
    tgas = {k: torch.as_tensor(v) for k, v in g.items()}
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    n_valid = 0
    for s in range(steps):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk, 2)
        t = s * dt
        jst, jc = ji.inject(jst, jsub, jnp.asarray(t), jnp.asarray(dt), jgas)
        tst, tc = ti.inject(tst, tsub, torch.tensor(t, dtype=torch.float64),
                            torch.tensor(dt, dtype=torch.float64), tgas)
        _same(tst, jst)
        _same(tc, jc)
        n_valid += int(_np(tc["valid"]).sum())
    assert n_valid > 0
    return ti, ji, tst


@pytest.mark.parametrize("size", sorted(_SIZES))
def test_cone_injection(case, size):
    _run(case, "type coneInjection; " + _CONE + _SIZES[size])


def test_patch_injection(case):
    _run(case, "type patchInjection; patchName top; SOI 0; duration 1; massTotal 0.5; "
               "parcelsPerSecond 3000; U0 (0 -3 0); " + _SIZES["RosinRammler"])


@pytest.mark.parametrize("version", ("v1", "v2"))
def test_detailed_sprinkler(case, version):
    ti, ji, st = _run(case, _DETAILED[version], steps=8)
    for k in ("Q", "bin_p", "dv50_tab", "vel_tab", "phi_tab", "theta_tab"):
        _same(getattr(ti, k), getattr(ji, k), 1e-14)
    assert (_np(st["t_act"]) >= 0.0).any()  # the hot gas set a link off


def _quantised_dv50(ti, ji):
    """The analytic sampler's drop-size bins end at i·dmax/60 with dmax =
    4·dv50, so the edge of bin 15 equals dv50 in exact arithmetic: whether
    that bin counts as above dv50 (and takes the cvfCorrect rescaling) is
    decided by rounding, and dv50's last bit differs between the packages
    (XLA's exp against torch's in the fits). Both samplers get dv50 rounded
    to the same 2^-52 grid here, so the tie falls alike (ROADMAP R9)."""
    t_orig, j_orig = ti._sample_diameter, ji._sample_diameter
    ti._sample_diameter = lambda key, dv50, s, g: t_orig(
        key, torch.round(dv50 * 2.0**52) / 2.0**52, s, g)
    ji._sample_diameter = lambda key, dv50, s, g: j_orig(
        key, jnp.round(dv50 * 2.0**52) / 2.0**52, s, g)


@pytest.mark.parametrize("k_factor,multi", ((205, False), (162, True)))
def test_analytic_sprinkler(case, k_factor, multi):
    kind = "multiSprinklerInjection" if multi else "sprinklerInjection"
    ti, ji, st = _run(case, f"type {kind}; " + _analytic_dict(k_factor, multi), steps=8,
                      patch=_quantised_dv50)
    for k in ("Q", "flow_cell", "vol_frac", "n_parcels_cell", "slot_cell", "vel_stdev"):
        _same(getattr(ti, k), getattr(ji, k), 1e-14)
    assert ti.n_spr == (2 if multi else 1)


@pytest.mark.parametrize("kind", _LOOKUP_KINDS)
def test_lookup_table_sprinklers(case, kind):
    spec = (f"type {kind}; SOI 0; duration 100; parcelsPerSecond 6000; radiusToSprinkler 0.2; "
            "positionList ( (0.5 0.85 0.5) (0.2 0.8 0.7) ); direction (0 -1 0); "
            "armDirection (1 0 0); lookupTableCoeffs { tableDirectory sprTables; "
            "sampleSize 12; } rtiCoeffs { active false; }")
    ti, ji, _ = _run(case, spec, steps=8)
    assert ti.ideal_flow == pytest.approx(ji.ideal_flow, rel=1e-15)


_FIXED = "sizeDistribution { type fixedValue; fixedValueDistribution { value 1e-3; } }"
_STOCK = {
    "manualInjection": f"SOI 0; massTotal 0.3; positionsFile \"pos\"; U0 (0 -1 0); {_FIXED}",
    "cellZoneInjection": f"SOI 0; cellZone z1; numberDensity 900; massTotal 0.05; U0 (0 0 0); "
                         f"{_FIXED}",
    "coneNozzleInjection": "SOI 0; duration 1; massTotal 0.1; parcelsPerSecond 100; "
                           "position (0.5 0.9 0.5); direction (0 -1 0); outerDiameter 0.2; "
                           "innerDiameter 0.05; Umag constant 4; thetaInner constant 0; "
                           f"thetaOuter constant 30; flowRateProfile constant 1; {_FIXED}",
    "kinematicLookupTableInjection": "SOI 0; duration 1; parcelsPerSecond 20; "
                                     "inputFile \"kinTab\";",
    "inflationInjection": "SOI 0; duration 1; cellZone z1; flowRate constant 1e-5; "
                          "growthRate constant 5e-3; dSeed 1e-4; parcelsPerSecond 50; "
                          f"rhoInjection 1000; {_FIXED}",
}


@pytest.mark.parametrize("kind", tuple(_STOCK))
def test_stock_injectors_wait_for_p12b(case, kind):
    """The stock injectors, which waited for ROADMAP P12b and raised (the
    name is kept from then), come out of make_injector as the JAX package's
    do, and their first injection from one key agrees
    (tests/test_torch_injection_stock.py drives all 11 kinds over several
    steps)."""
    with open(os.path.join(case["root"], "constant", "pos"), "w") as f:
        f.write("2\n(\n(0.2 0.3 0.4)\n(0.6 0.5 0.5)\n)\n")
    with open(os.path.join(case["root"], "constant", "kinTab"), "w") as f:
        f.write("(\n((0.2 0.2 0.2) (0 -1 0) 1e-3 1000 0.02)\n)\n")
    zones = {"z1": np.arange(0, case["tg"].n_cells, 4)}
    txt = f"type {kind}; {_STOCK[kind]}"
    ji = jinj.make_injector("i", jparse(txt), case["jw"], case["jc"], jnp.float64,
                            geom=case["jg"], cell_zones=zones)
    ti = tinj.make_injector("i", tparse(txt), case["tw"], case["tc"], torch.float64,
                            geom=case["tg"], cell_zones=zones)
    assert type(ti).__name__ == type(ji).__name__
    ji.max_per_step = ti.max_per_step = ji.capacity_for_dt(0.1)
    _, jc = ji.inject(ji.init_state(), jax.random.PRNGKey(5), jnp.asarray(0.0),
                      jnp.asarray(0.1), {})
    _, tc = ti.inject(ti.init_state(), prng.PRNGKey(5), torch.tensor(0.0, dtype=torch.float64),
                      torch.tensor(0.1, dtype=torch.float64), {})
    assert np.asarray(jc["valid"]).any()
    for k in jc:
        a, b = tc[k].numpy(), np.asarray(jc[k])
        if b.dtype.kind in "biu":
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), k
        else:
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=0.0, err_msg=k)


def test_film_drip_injection(case):
    """FilmDripInjection against the JAX package's: the film's drip flux on
    the base's faces (none first, then some) from the same keys gives the
    same release faces, sizes, parcel count and owed mass."""
    base = case["tg"].patch("base")
    bidx = np.arange(base.start, base.start + base.n)
    args = ("drip", None, bidx, 1e-3, 2e-3, 100.0, (0.0, -9.81, 0.0))
    ji = jinj.FilmDripInjection(*args[:1], case["jg"], *args[2:], dtype=jnp.float64)
    ti = tinj.FilmDripInjection(*args[:1], case["tg"], *args[2:], dtype=torch.float64)
    js, ts = ji.init_state(), ti.init_state()
    rng = np.random.default_rng(4)
    nB = case["tg"].n_boundary
    for k, scale in enumerate((0.0, 0.5, 2.0)):
        drip = np.zeros(nB)
        drip[bidx] = scale * rng.uniform(0.0, 1.0, bidx.size)
        fu = rng.normal(size=(nB, 3))
        jgas = {"film_drip_b": jnp.asarray(drip), "film_U_b": jnp.asarray(fu)}
        tgas = {"film_drip_b": torch.as_tensor(drip), "film_U_b": torch.as_tensor(fu)}
        key = jax.random.PRNGKey(k)
        js, jc = ji.inject(js, key, 0.0, 0.01, jgas)
        ts, tc = ti.inject(ts, prng.PRNGKey(k), torch.tensor(0.0, dtype=torch.float64),
                           torch.tensor(0.01, dtype=torch.float64), tgas)
        for name in ("x", "U", "d", "cell", "valid", "mass"):
            a, b = tc[name].numpy(), np.asarray(jc[name])
            assert np.allclose(a, b, rtol=1e-12, atol=0.0), (k, name)
        assert int(ts["n_inj"]) == int(js["n_inj"])
        assert abs(float(ts["m_owed"]) - float(js["m_owed"])) <= 1e-12 * max(
            abs(float(js["m_owed"])), 1e-30)
    assert int(ts["n_inj"]) > 0
