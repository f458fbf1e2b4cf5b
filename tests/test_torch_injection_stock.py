"""The port's stock injectors (lagrangian/injection_stock.py, built through
make_injector) against the JAX package's on the CPU in float64: all 11
kinds (manual, cellZone, fieldActivated, the kinematic/thermo/reacting/
reactingMultiphase lookup tables, coneNozzle with a set Umag and with the
flow-rate velocity, inflation, none and noInjection), each driven over 6
steps with the same key chain: every candidate field (positions,
velocities, diameters, masses, T, cp, the phase splits) within 1e-10
relative, cells and validity masks equal, the injector state (counts, owed
mass, fired flags) equal. The mesh is the spray fire case's
(firefoam_torch.utils.synthcase at (6, 5, 6)); both packages read its files
and the tables written beside them. Also the table parsers, and the thermo
and reacting tables through the cloud (their T and cp seeding the parcels'
lanes), as tests/test_lookup_injection.py checks the JAX package.
"""

import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.io import Case as JCase
from firefoam_tpu.io import parse_string as jparse
from firefoam_tpu.lagrangian.injection import make_injector as j_make
from firefoam_tpu.lagrangian.injection_stock import read_vector_field_file as j_read
from firefoam_tpu.lagrangian.tracking import WalkMesh as JWalk
from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_torch.io import Case as TCase
from firefoam_torch.io import parse_string as tparse
from firefoam_torch.lagrangian import prng
from firefoam_torch.lagrangian.injection import STOCK_KINDS
from firefoam_torch.lagrangian.injection import make_injector as t_make
from firefoam_torch.lagrangian.injection_stock import (ReactingMultiphaseLookupTableInjection,
                                                       read_vector_field_file as t_read)
from firefoam_torch.lagrangian.tracking import WalkMesh as TWalk
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.utils.synthcase import write_spray_fire_case

from test_torch_lagrangian_cloud import N, _build, _evolve_both

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
TOL = 1e-10
DT = 0.05
N_STEPS = 6

_FILES = {
    "positions": "FoamFile { version 2.0; format ascii; class vectorField; }\n"
                 "4\n(\n(0.1 0.1 0.1)\n(0.5 0.5 0.5)\n(0.9 0.85 0.9)\n(2.0 0.5 0.5)\n)\n",
    "parcelData": "(\n((0.2 0.2 0.2) (0 -1 0) 1e-3 1000 0.02)\n"
                  "((0.6 0.6 0.6) (0 -2 0) 2e-3 1000 0.04)\n)\n",
    "thermoTab": "FoamFile { version 2.0; format ascii; class thermoParcelInjectionDataIOList; }\n"
                 "2\n(\n    ((0.5 0.9 0.5) (0 -1 0) 0.0010 1000 0.05 342.0 4100.0)\n"
                 "    ((0.4 0.8 0.4) (0 -1 0) 0.0008 1000 0.03 361.0 4200.0)\n)\n",
    "reactTab": "1\n(\n    ((0.5 0.9 0.5) (0 -1 0) 0.0010 1000 0.05 350.0 4100.0 (1.0))\n)\n",
    "multiTab": "FoamFile { version 2.0; format ascii;\n"
                "    class reactingMultiphaseParcelInjectionDataIOList; }\n1\n(\n"
                "    ((0.5 0.9 0.5) (0 -1 0) 0.0010 1000 0.05 335.0 4100.0\n"
                "     (0.25 0.55 0.20) (1.0) (1.0) (1.0))\n)\n",
}
_SIZES = "sizeDistribution { type fixedValue; fixedValueDistribution { value 1e-3; } }"
_RR = ("sizeDistribution { type RosinRammler; RosinRammlerDistribution { minValue 1e-4; "
       "maxValue 1e-3; d 4e-4; n 3; } }")
_CONE = ("type coneNozzleInjection; SOI 0; duration 1; massTotal 0.1; parcelsPerSecond 100; "
         "position (0.5 0.9 0.5); direction (0.1 -1 0); outerDiameter 0.2; innerDiameter 0.05; "
         "Cd constant 0.9; thetaInner constant 0; thetaOuter constant 30; "
         "flowRateProfile constant 1; rhoInjection 1000; " + _RR)
_KINDS = {
    "manualInjection": "type manualInjection; SOI 0.05; massTotal 0.3; parcelBasisType mass; "
                       f"positionsFile \"positions\"; U0 (0 -1 0); {_RR}",
    "cellZoneInjection": "type cellZoneInjection; SOI 0; cellZone z1; numberDensity 1500; "
                         f"massTotal 0.05; U0 (0 0.5 0); {_RR}",
    "fieldActivatedInjection": "type fieldActivatedInjection; SOI 0; massTotal 0.06; factor 1.0; "
                               "referenceField p; thresholdField pMin; nParcelsPerInjector 2; "
                               f"positionsFile \"positions\"; U0 (0 0 0); {_RR}",
    "kinematicLookupTableInjection": "type kinematicLookupTableInjection; SOI 0; duration 1; "
                                     "parcelsPerSecond 20; inputFile \"parcelData\";",
    "thermoLookupTableInjection": "type thermoLookupTableInjection; SOI 0.0; duration 5.0; "
                                  "parcelsPerSecond 70; inputFile \"thermoTab\";",
    "reactingLookupTableInjection": "type reactingLookupTableInjection; SOI 0; duration 5; "
                                    "parcelsPerSecond 70; inputFile \"reactTab\";",
    "reactingMultiphaseLookupTableInjection": "type reactingMultiphaseLookupTableInjection; "
                                              "SOI 0; duration 5; parcelsPerSecond 70; "
                                              "inputFile \"multiTab\";",
    "coneNozzleInjection": _CONE,
    "none": "type none;",
    "noInjection": "type noInjection;",
    "inflationInjection": "type inflationInjection; SOI 0; duration 1; cellZone z1; "
                          "flowRate constant 1e-5; growthRate constant 5e-3; dSeed 1e-4; "
                          f"parcelsPerSecond 50; rhoInjection 1000; {_SIZES}",
}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(ours, ref, where):
    assert set(ours) == set(ref), (where, set(ours) ^ set(ref))
    for k in ref:
        a, b = _np(ours[k]), _np(ref[k])
        assert a.shape == b.shape, (where, k, a.shape, b.shape)
        if b.dtype.kind in "biu":
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), (where, k)
        else:
            err = np.max(np.abs(a - b), initial=0.0) / max(np.max(np.abs(b), initial=0.0), 1e-300)
            assert err <= TOL, (where, k, err)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = write_spray_fire_case(str(tmp_path_factory.mktemp("stock") / "c"), n=N)
    for name, txt in _FILES.items():
        with open(os.path.join(root, "constant", name), "w") as f:
            f.write(txt)
    jm, tm = j_build(root).mesh, t_build(root).mesh
    return {
        "root": root, "jw": JWalk.from_polymesh(jm), "tw": TWalk.from_polymesh(tm),
        "jg": JGeom.from_polymesh(jm),
        "tg": TGeom.from_polymesh(tm, dtype=torch.float64, device="cpu"),
        "zones": {"z1": np.arange(0, tm.n_cells, 3)},
    }


def test_read_vector_field_file(setup):
    path = os.path.join(setup["root"], "constant", "positions")
    np.testing.assert_array_equal(t_read(path), j_read(path))
    assert t_read(path).shape == (4, 3)


def test_every_stock_kind_is_built():
    assert set(_KINDS) == set(STOCK_KINDS)


@pytest.mark.parametrize("kind", tuple(_KINDS))
def test_injector(setup, kind):
    s = setup
    ji = j_make("inj", jparse(_KINDS[kind]), s["jw"], JCase(s["root"]), jnp.float64,
                geom=s["jg"], cell_zones=s["zones"])
    ti = t_make("inj", tparse(_KINDS[kind]), s["tw"], TCase(s["root"]), torch.float64,
                geom=s["tg"], cell_zones=s["zones"])
    assert type(ti).__name__ == type(ji).__name__
    ji.max_per_step = ji.capacity_for_dt(0.1)
    ti.max_per_step = ti.capacity_for_dt(0.1)
    assert ti.max_per_step == ji.max_per_step
    nC = s["tg"].n_cells
    rng = np.random.default_rng(7)
    jst, tst = ji.init_state(), ti.init_state()
    _same(tst, jst, "init")
    jkey, tkey = jax.random.PRNGKey(11), prng.PRNGKey(11)
    n_valid = 0
    for i in range(N_STEPS):
        # the fieldActivated gate: closed, then open in some cells
        p = np.full(nC, 1e5) + (2e5 * (rng.uniform(size=nC) < 0.5) if i >= 2 else 0.0)
        gas = {"p": p, "pMin": np.full(nC, 2e5)}
        jkey, jk = jax.random.split(jkey)
        tkey, tk = prng.split(tkey)
        t = i * DT
        jst, jc = ji.inject(jst, jk, jnp.asarray(t), jnp.asarray(DT),
                            {k: jnp.asarray(v) for k, v in gas.items()})
        tst, tc = ti.inject(tst, tk, torch.tensor(t, dtype=torch.float64),
                            torch.tensor(DT, dtype=torch.float64),
                            {k: torch.as_tensor(v) for k, v in gas.items()})
        _same(tc, jc, f"{kind} candidates {i}")
        _same(tst, jst, f"{kind} state {i}")
        n_valid += int(np.asarray(jc["valid"]).sum())
    assert (n_valid > 0) == (kind not in ("none", "noInjection"))


def test_cone_nozzle_flow_rate_velocity(setup):
    """Without Umag the nozzle's speed is ṁ/(ρ·Cd·A) in both packages."""
    s = setup
    txt = _CONE
    ji = j_make("cn", jparse(txt), s["jw"], JCase(s["root"]), jnp.float64)
    ti = t_make("cn", tparse(txt), s["tw"], TCase(s["root"]), torch.float64)
    A = np.pi / 4 * (0.2 ** 2 - 0.05 ** 2)
    assert ti.umag == ji.umag == pytest.approx(0.1 / (1000 * 0.9 * A), rel=1e-12)


def test_multiphase_table_rows(setup):
    path = os.path.join(setup["root"], "constant", "multiTab")
    rows = ReactingMultiphaseLookupTableInjection._read_table(path)
    assert rows[0][7] == [0.25, 0.55, 0.20] and rows[0][5:7] == (335.0, 4100.0)


@pytest.mark.parametrize("kind,table", (("thermoLookupTableInjection", "thermoTab"),
                                        ("reactingLookupTableInjection", "reactTab")))
def test_lookup_tables_through_the_cloud(tmp_path, kind, table):
    root = write_spray_fire_case(str(tmp_path / "c"), n=N, collector=False)
    with open(os.path.join(root, "constant", table), "w") as f:
        f.write(_FILES[table])
    path = os.path.join(root, "constant", "reactingCloud1Properties")
    with open(path) as f:
        txt = f.read()
    txt = re.sub(r"injectionModels \{ model1 \{.*\} \}\n",
                 f"injectionModels {{ model1 {{ {_KINDS[kind]} }} }}\n", txt)
    with open(path, "w") as f:
        f.write(txt)
    jc, tc, jgas = _build(root, ["O2", "H2O", "C3H8", "CO2", "N2"])
    st, _ = _evolve_both(jc, tc, jgas)
    a = st["alive"].numpy()
    assert a.any()
    if kind.startswith("thermo"):  # every parcel carries a table row's cp
        assert set(np.round(st["cp0"].numpy()[a], 3)) <= {4100.0, 4200.0}
