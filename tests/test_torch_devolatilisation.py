"""The port's devolatilisation and n-phase parcel ledger
(lagrangian/devolatilisation.py and the cloud's ledger branches) against the
JAX package's on the CPU in float64, on the same seeded inputs:

  * parse_phases and PhaseLedger on gas/liquid/solid compositions (and the
    bare liquid dict);
  * Devolatilisation.from_dict and calculate, constantRate and
    singleKineticRate, with the TDevol gate, suppressed parcels
    (canCombust −1) and parcels that run out of volatiles (canCombust → 1):
    dmv within 1e-10 relative, canCombust equal;
  * the cloud: 10 `evolve` calls of the multiphase spray fire's cloud
    (write_multiphase_spray_fire_case at (6, 5, 6): coneNozzle, the
    C3H8/H2O/ash ledger, singleKineticRate with LDevol, MPPIC) and of a
    constantRate cloud fed by the reactingMultiphase lookup table (the
    Yphase/YGas split), every parcel lane (mv, mv0, ms included), source
    (dvTrans included) and the random key within 1e-9, masks equal;
  * the port's volatile ledger over its own run: injected = held by the
    parcels + devolatilised + carried out, to 1e-12 of the injected.
"""

import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.io import parse_string as jparse
from firefoam_tpu.lagrangian import devolatilisation as jd
from firefoam_torch.io import parse_string as tparse
from firefoam_torch.lagrangian import devolatilisation as td
from firefoam_torch.utils.synthcase import write_multiphase_spray_fire_case

from test_torch_lagrangian_cloud import N, _build, _evolve_both

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
TOL = 1e-10
SPECIES = ["O2", "H2O", "C3H8", "CO2", "N2"]


class _Gas:
    species = SPECIES

    def index(self, n):
        return SPECIES.index(n)


_COMPOSITIONS = (
    "phases ( gas { C3H8 0.1; CO2 0.05; } liquid { H2O 0.8; } solid { ash 0.05; } );",
    "phases ( gas { C3H8 1; } solid { ash 3; } );",
    "phases ( { H2O 1; } );",
    "phases ( liquid { H2O 0.7; C3H8 0.3; } );",
)


@pytest.mark.parametrize("comp", _COMPOSITIONS)
def test_phases_and_ledger(comp):
    a, b = td.parse_phases(tparse(comp)), jd.parse_phases(jparse(comp))
    assert a == b
    la, lb = td.PhaseLedger.from_phases(a), jd.PhaseLedger.from_phases(b)
    assert (la is None) == (lb is None)
    if la is not None:
        assert (la.gas_names, la.liquid_frac, la.solid_frac) == (lb.gas_names, lb.liquid_frac,
                                                                 lb.solid_frac)
        np.testing.assert_array_equal(la.gas_fracs, lb.gas_fracs)


_MODELS = {
    "constantRate": "devolatilisationModel constantRateDevolatilisation; "
                    "constantRateDevolatilisationCoeffs { volatileData ( (C3H8 12) (CO2 40) ); "
                    "residualCoeff 0.01; }",
    "singleKineticRate": "devolatilisationModel singleKineticRateDevolatilisation; "
                         "singleKineticRateDevolatilisationCoeffs { volatileData "
                         "( (C3H8 2e3 2.5e7) (CO2 50 8e6) ); residualCoeff 0.001; }",
}


@pytest.mark.parametrize("kind", tuple(_MODELS))
def test_calculate(kind):
    cp = "TDevol 320; LDevol 2e5;"
    a = td.Devolatilisation.from_dict(tparse(_MODELS[kind]), tparse(cp), _Gas())
    b = jd.Devolatilisation.from_dict(jparse(_MODELS[kind]), jparse(cp), _Gas())
    assert (a.kind, a.names, a.gas_indices, a.residual_coeff, a.T_devol, a.L_devol) == (
        b.kind, b.names, b.gas_indices, b.residual_coeff, b.T_devol, b.L_devol)
    rng = np.random.default_rng(5)
    n = 400
    mv0 = rng.uniform(0.0, 1e-9, (n, 2))
    mv = mv0 * rng.uniform(0.0, 1.0, (n, 2))
    mv[:40] = mv0[:40] * 1e-4  # about to run out: canCombust flips to 1
    T = rng.uniform(280.0, 900.0, n)
    can = rng.choice(np.array([-1, 0, 1], np.int32), n)
    gate = rng.uniform(size=n) < 0.85
    for dt in (1e-4, 1e-2, 1.0):
        da, ca = a.calculate(dt, *map(torch.as_tensor, (T, mv, mv0, can, gate)))
        db, cb = b.calculate(dt, *map(jnp.asarray, (T, mv, mv0, can, gate)))
        err = float(np.max(np.abs(da.numpy() - np.asarray(db)))) / float(np.max(np.asarray(db)))
        assert err <= TOL, (dt, err)
        assert np.array_equal(ca.numpy(), np.asarray(cb)), dt
    assert (cb == 1).sum() > (can == 1).sum()  # some parcels became combustion-ready
    assert td.Devolatilisation.from_dict(tparse("devolatilisationModel none;"), tparse(""),
                                         _Gas()) is None


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tmp_path_factory.mktemp("devol")


def test_multiphase_cloud(base):
    root = write_multiphase_spray_fire_case(str(base / "multi"), n=N, pps=3000.0)
    jc, tc, jgas = _build(root, SPECIES)
    assert tc.devol is not None and tc.mppic is not None and tc.ledger is not None
    st, src = _evolve_both(jc, tc, jgas)
    assert float(src["dvTrans"].sum()) > 0.0 and float(st["ms"].sum()) > 0.0


_TABLE = """FoamFile { version 2.0; format ascii; class reactingMultiphaseParcelInjectionDataIOList; }
2
(
    ((0.5 0.85 0.5) (0 -1 0) 0.0010 1000 0.05 335.0 4100.0 (0.25 0.55 0.20) (0.6 0.4) (1.0) (1.0))
    ((0.4 0.8 0.45) (0.3 -1 0) 0.0008 1000 0.03 350.0 4000.0 (0.1 0.8 0.1) (0.2 0.8) (1.0) (1.0))
)
"""


def test_constant_rate_cloud_from_the_multiphase_table(base):
    """constantRate with LDevol and no heat transfer (the cp0 lane's branch),
    fed by reactingMultiphaseLookupTableInjection: the Yphase/YGas split."""
    root = write_multiphase_spray_fire_case(str(base / "table"), n=N, pps=3000.0)
    with open(os.path.join(root, "constant", "multiTab"), "w") as f:
        f.write(_TABLE)
    path = os.path.join(root, "constant", "reactingCloud1Properties")
    with open(path) as f:
        txt = f.read()
    txt = re.sub(r"injectionModels \{ model1 \{.*\} \}\n",
                 "injectionModels { model1 { type reactingMultiphaseLookupTableInjection; SOI 0; "
                 "duration 5; parcelsPerSecond 2000; inputFile \"multiTab\"; } }\n", txt)
    txt = txt.replace("phases ( gas { C3H8 0.1; }", "phases ( gas { C3H8 0.06; CO2 0.04; }")
    txt = re.sub(r"devolatilisationModel .*?residualCoeff 0.001; \}",
                 _MODELS["constantRate"], txt, flags=re.S)
    txt = txt.replace("heatTransferModel RanzMarshall;", "heatTransferModel none;")
    with open(path, "w") as f:
        f.write(txt)
    jc, tc, jgas = _build(root, SPECIES)
    assert tc.devol.kind == "constantRate" and tc.devol.n_vol == 2
    st, src = _evolve_both(jc, tc, jgas)
    assert float(src["dvTrans"].sum()) > 0.0


def test_volatile_ledger_closes(base):
    """The port's own run: Σ injected = held by the alive parcels +
    devolatilised + carried out by parcels that left (here: caught by the
    collector or escaped), over 10 evolves."""
    root = write_multiphase_spray_fire_case(str(base / "ledger"), n=N, pps=3000.0)
    _, tc, jgas = _build(root, SPECIES)
    rng = np.random.default_rng(1)
    nC = tc.geom.n_cells
    T = 320.0 + 800.0 * rng.uniform(size=nC) ** 2
    Y = rng.dirichlet(np.ones(5), nC) * 0.2
    Y[:, 4] += 0.8
    g = {"rho": 101325.0 / (287.0 * T), "U": rng.normal(0.0, 3.0, (nC, 3)), "T": T,
         "p": np.full(nC, 101325.0), "mu": 1.8e-5 * (T / 300.0) ** 0.7,
         "kappa": 0.026 * (T / 300.0) ** 0.8, "cp": 1005.0 + 0.1 * (T - 300.0),
         "Yv": Y[:, 1], "W": np.full(nC, 28.0), "G_bands": rng.uniform(0.0, 2e4, (1, nC))}
    st = tc.initial_state()
    inj = dev = lost = 0.0
    for i in range(10):
        gc = dict({k: torch.as_tensor(v) for k, v in g.items()},
                  t=torch.tensor(i * 0.02, dtype=torch.float64))
        st, src = tc.evolve(st, gc, torch.tensor(0.02, dtype=torch.float64))
        inj += float(src["volatileInjected"])
        dev += float(src["dvTrans"].sum())
        lost += float(src["volatileLost"])
    held = float(torch.where(st["alive"], tc._volatiles(st), 0.0).sum())
    assert inj > 0.0 and dev > 0.0
    assert abs(inj - held - dev - lost) <= 1e-12 * inj, (inj, held, dev, lost)
