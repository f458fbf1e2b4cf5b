"""The port's EDM family (combustion/edm.py, combustion/edm_ext.py) against
the JAX package on CPU in float64 with the same seeded inputs (rel 1e-10).

The gas is the box fire's with an Fstar specie whose thermo entry is a
clone of C3H8's (the way tests/test_edm_ext.py builds it), parsed from the
port's utils/synthcase thermo text by each package's own parser. For every
variant of the JAX selection rule the models are built by from_case from
the same dictionary, and `rates`, `R` for every specie and `qdot` are held
against each other over cold and burning cells, with and without spray,
near-wall cells, before and after ExtinctionStart:

  * eddyDissipationModel, Limit, NoneStiff (→ Limit), infinitelyFastChemistry,
    Diffusion, DiffusionNoneStiff (→ Diffusion);
  * eddyDissipationBertExtModel (default, radiativeHeatLoss,
    nearWallExtinction) and eddyDissipationFRVModel: their flame
    temperatures (Tad, Textinction, TadMixed) come from a fixed number of
    secant and Newton steps (5 and 10, never cut short), so equal Tad to
    1e-10 means equal steps;
  * eddyDissipationIgnModel with a pilot field, across its time ramp;
  * eddyDissMultiFuelStreamModel with two fuel streams and localRadFrac;
  * an unknown name (the base model, silently), and BertExt without an
    Fstar specie (the base model, with the JAX package's warning)."""

import os
import warnings

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from firefoam_tpu.combustion.edm import EddyDissipationModel as JEDM
from firefoam_tpu.io.foamdict import parse_file as jparse_file
from firefoam_tpu.io.foamdict import parse_string as jparse
from firefoam_tpu.thermo import GasThermo as JGas
from firefoam_tpu.thermo import SingleStepReaction as JRx
from firefoam_torch.combustion.edm import EddyDissipationModel as TEDM
from firefoam_torch.io.foamdict import parse_file as tparse_file
from firefoam_torch.io.foamdict import parse_string as tparse
from firefoam_torch.thermo import GasThermo as TGas
from firefoam_torch.thermo import SingleStepReaction as TRx
from firefoam_torch.utils import synthcase

torch.set_num_threads(1)
TOL = 1e-10
SPECIES = ["O2", "H2O", "C3H8", "CO2", "N2", "Fstar"]
N = 240
_RX = """species ( O2 H2O C3H8 CO2 N2 Fstar );
reactions { propaneReaction { type irreversibleinfiniteReaction;
    reaction "C3H8 + 5O2 + 18.8N2 = 3CO2 + 4H2O + 18.8N2"; } }
"""


def _rel(a, b):
    a = np.asarray(a.numpy() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def chem(tmp_path_factory):
    d = tmp_path_factory.mktemp("chem")
    th = os.path.join(d, "thermo.gas")
    with open(th, "w") as f:
        f.write(synthcase._THERMO_GAS)
    out = {}
    for tag, parse_file, parse, Gas, Rx in (("j", jparse_file, jparse, JGas, JRx),
                                           ("t", tparse_file, tparse, TGas, TRx)):
        td = parse_file(th)
        td["Fstar"] = td.get_dict("C3H8")  # the quenched-fuel surrogate's thermo
        gas = Gas.from_dict(td, SPECIES)
        rx = Rx.from_case(parse(_RX), gas, "C3H8", "N2")
        plain = Gas.from_dict(parse_file(th), SPECIES[:-1])
        rx_plain = Rx.from_case(parse(_RX.replace(" Fstar", "")), plain, "C3H8", "N2")
        out[tag] = (parse, rx, rx_plain)
    return out


def _comb(model, coeffs=""):
    return (f"combustionModel {model}<psiThermoCombustion,gasHThermoPhysics>;\n"
            f"{model}Coeffs {{ semiImplicit no; C_EDC 4.0; C_Diff 0.5; C_Stiff 1; active on; "
            f"C 5; {coeffs} }}\n")


def _inputs(seed, n=N, n_species=6):
    """Cold, warm and burning cells; fuel-rich, lean, quenched-fuel ones."""
    rng = np.random.RandomState(seed)
    Y = rng.rand(n, n_species) * np.array([0.25, 0.08, 0.1, 0.1, 0.7, 0.06][:n_species])
    Y[: n // 6, 2] = 0.0  # no fuel
    Y[n // 6: n // 3, 0] = 1e-5  # no oxygen
    Y /= Y.sum(1, keepdims=True)
    return dict(
        rho=0.3 + rng.rand(n), Y=Y, k=1e-4 + 0.2 * rng.rand(n), eps=3.0 * rng.rand(n),
        alpha=1e-5 * (1 + rng.rand(n)), delta=0.01 + 0.02 * rng.rand(n),
        T=np.concatenate([300 + 80 * rng.rand(n // 3), 300 + 2000 * rng.rand(n - n // 3)]),
        p=101325.0 + 100 * rng.randn(n), spray=rng.rand(n) * (rng.rand(n) > 0.7),
        near_wall=rng.rand(n) > 0.8, nu=1.5e-5 * (1 + rng.rand(n)), nut=1e-4 * rng.rand(n),
    )


def _rates(m, x, t, dt, arr, as_bool, spray=True):
    return m.rates(arr(x["rho"]), arr(x["Y"]), arr(x["k"]), arr(x["eps"]), arr(x["alpha"]),
                   arr(x["delta"]), dt, T=arr(x["T"]), p=arr(x["p"]),
                   spray_rho=arr(x["spray"]) if spray else None,
                   near_wall=as_bool(x["near_wall"]), t=arr(np.float64(t)),
                   nu=arr(x["nu"]), nut=arr(x["nut"]))


def _compare(jm, tm, x, t, dt=0.013, spray=True):
    jr = _rates(jm, x, t, dt, jnp.asarray, jnp.asarray, spray)
    tr = _rates(tm, x, t, dt, torch.as_tensor, torch.as_tensor, spray)
    assert set(tr) == set(jr)
    for key in jr:
        assert _rel(tr[key], jr[key]) <= TOL, key
    for s in range(tr["Y"].shape[1] if "Y" in tr else x["Y"].shape[1]):
        assert _rel(tm.R(tr, s), jm.R(jr, s)) <= TOL, s
    assert _rel(tm.qdot(tr), jm.qdot(jr)) <= TOL
    return tr


def _models(chem, model, coeffs="", plain=False):
    jparse_, jrx, jplain = chem["j"]
    tparse_, trx, tplain = chem["t"]
    jm = JEDM.from_case(jparse_(_comb(model, coeffs)), jplain if plain else jrx)
    tm = TEDM.from_case(tparse_(_comb(model, coeffs)), tplain if plain else trx)
    assert (tm.variant, tm.fstar_index, tm.fuel_indices, tm.stream_rad_fracs, tm.ign_times,
            tm.C_ifc) == (jm.variant, jm.fstar_index, jm.fuel_indices, jm.stream_rad_fracs,
                          jm.ign_times, jm.C_ifc)
    return jm, tm


@pytest.mark.parametrize("model,variant", [
    ("eddyDissipationModel", "eddyDissipationModel"),
    ("eddyDissipationLimitModel", "eddyDissipationLimitModel"),
    ("eddyDissipationNoneStiffModel", "eddyDissipationLimitModel"),
    ("infinitelyFastChemistry", "infinitelyFastChemistry"),
    ("eddyDissipationDiffusionModel", "eddyDissipationDiffusionModel"),
    ("eddyDissipationDiffusionNoneStiffModel", "eddyDissipationDiffusionModel"),
    ("someOtherCombustionModel", "eddyDissipationModel"),
])
def test_base_variants_match(chem, model, variant):
    jm, tm = _models(chem, model)
    assert tm.variant == variant
    _compare(jm, tm, _inputs(1), t=0.5)


@pytest.mark.parametrize("coeffs", [
    "ExtinctionStart 0.2;",
    "ExtinctionStart 0.2; radiativeHeatLoss true; XrExtinction 0.3;",
    "ExtinctionStart 0.2; nearWallExtinction true; FuelExtTemp 600; FuelStarExtTemp 900;",
], ids=["default", "radiative-loss", "near-wall"])
@pytest.mark.parametrize("t", [0.1, 0.5])
def test_bert_ext_matches(chem, coeffs, t):
    jm, tm = _models(chem, "eddyDissipationBertExtModel", coeffs)
    assert tm.variant == "eddyDissipationBertExtModel" and tm.fstar_index == 5
    r = _compare(jm, tm, _inputs(2), t=t)
    _compare(jm, tm, _inputs(3), t=t, spray=False)
    if t > 0.2:  # after ExtinctionStart: some cells extinguish, some reignite
        assert 0.0 < float(r["FEF"].mean()) < 1.0 and float(r["FIF"].max()) == 1.0
    else:
        assert float(r["FEF"].max()) == 0.0


@pytest.mark.parametrize("t", [0.1, 0.5])
def test_frv_matches(chem, t):
    jm, tm = _models(chem, "eddyDissipationFRVModel",
                     "ExtinctionStart 0.2; ZN 9; cKa 1.2; TFuel 300;")
    r = _compare(jm, tm, _inputs(4), t=t)
    if t > 0.2:
        assert 0.0 < float(r["FRV"].mean()) < 1.0


def test_ign_matches_across_its_ramp(chem):
    jm, tm = _models(chem, "eddyDissipationIgnModel",
                     "tIgnBegin 0.1; tIgnRampUp 0.2; tIgnRampDown 0.4; tIgnEnd 0.6;")
    dqi = np.where(np.arange(N) % 5 == 0, 3e5, 0.0)
    jm.ign_dQI = dqi
    tm.ign_dQI = torch.as_tensor(dqi)
    for t in (0.05, 0.1, 0.15, 0.2, 0.3, 0.45, 0.6, 0.7):
        r = _compare(jm, tm, _inputs(5), t=t)
        assert (float(r["w_ign"].max()) > 0.0) == (0.1 < t < 0.6)


def test_multi_fuel_stream_matches(chem):
    coeffs = ("fuelSpecies (C3H8 Fstar); fuelStreams (C3H8 Fstar); "
              "fuelStreamsRadFracs (0.3 0.15);")
    jm, tm = _models(chem, "eddyDissMultiFuelStreamModel", coeffs)
    assert tm.variant == "eddyDissMultiFuelStreamModel" and tm.fuel_indices == (2, 5)
    r = _compare(jm, tm, _inputs(6), t=0.3)
    assert "localRadFrac" in r
    # float32, cells without either fuel: the pool's floor must not
    # underflow to 0 (a share of 0/0)
    x = _inputs(6)
    x["Y"][: N // 6, [2, 5]] = 0.0
    r32 = _rates(tm, x, 0.3, 0.013, lambda a: torch.as_tensor(a, dtype=torch.float32),
                 torch.as_tensor)
    outs = [tm.R(r32, s) for s in range(x["Y"].shape[1])] + [tm.qdot(r32), r32["localRadFrac"]]
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    # without fuels the model is the base one
    jm, tm = _models(chem, "eddyDissMultiFuelStreamModel", "fuelSpecies (CH4);")
    assert tm.variant == "eddyDissipationModel"


def test_extinction_variants_without_fstar_fall_back_with_a_warning(chem):
    for model in ("eddyDissipationBertExtModel", "eddyDissipationFRVModel"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            jm, tm = _models(chem, model, plain=True)
        assert tm.variant == "eddyDissipationModel" and tm.fstar_index is None
        assert sum("Fstar" in str(w.message) for w in caught) == 2
        _compare(jm, tm, _inputs(7, n_species=5), t=0.5)


def test_ign_pilot_field_is_read_from_the_case_and_masked_to_the_igniter(tmp_path):
    """The port reads 0/dQI and masks it to the 'igniter' cellZone, as the
    JAX constructor means to (firefoam_tpu/models/firefoam.py:149-163). The
    JAX constructor reads it before it knows the start time, so its pilot
    stays unset (a fault of the reference, ROADMAP Queue 3): held here so
    that the difference stays visible."""
    from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
    from firefoam_torch.models.firefoam import FireFoamSolver as TSolver

    root = synthcase.write_box_fire_case(str(tmp_path / "ign"), n=(6, 5, 4))
    with open(os.path.join(root, "constant", "combustionProperties"), "w") as f:
        f.write("FoamFile { version 2.0; format ascii; class dictionary; "
                "object combustionProperties; }\n"
                + _comb("eddyDissipationIgnModel", "tIgnBegin 0; tIgnRampUp 0.1; "
                        "tIgnRampDown 1; tIgnEnd 2;"))
    with open(os.path.join(root, "0", "Ydefault")) as f:
        text = f.read()
    with open(os.path.join(root, "0", "dQI"), "w") as f:
        f.write(text.replace("object Ydefault", "object dQI")
                .replace("internalField uniform 0", "internalField uniform 1e5"))
    with open(os.path.join(root, "system", "topoSetDictIgn"), "w") as f:
        f.write("FoamFile { version 2.0; format ascii; class dictionary; object topoSetDict; }\n"
                "actions ( { name ign; type cellSet; action new; source boxToCell; "
                "sourceInfo { box (0.3 0 0.3) (0.7 0.3 0.7); } }\n"
                "{ name igniter; type cellZoneSet; action new; source setToCellZone; "
                "sourceInfo { set ign; } } );\n")
    with open(os.path.join(root, "mesh.sh"), "a") as f:
        f.write("runApplication topoSet -dict system/topoSetDictIgn\n")
    ts, js = TSolver(root, device="cpu"), JSolver(root)
    assert ts.combustion.variant == js.combustion.variant == "eddyDissipationIgnModel"
    zone = np.asarray(ts.cm.sets.cell_zones["igniter"])
    want = np.zeros(ts.geom.n_cells)
    want[zone] = 1e5
    assert 0 < zone.size < ts.geom.n_cells
    assert np.array_equal(ts.combustion.ign_dQI.numpy(), want)
    assert js.combustion.ign_dQI is None
