"""The port's gas physics against the JAX package, module by module, on CPU
in float64 with the same seeded inputs (rel 1e-10): GasThermo,
SingleStepReaction, the EDM combustion rate, KEqnLES.correct and one fvDOM
ray sweep on the box-fire case (write_box_fire_case, n=(6,6,6))."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from firefoam_tpu.combustion.edm import EddyDissipationModel as JEDM
from firefoam_tpu.io import Case as JCase
from firefoam_tpu.io.foamdict import parse_file as jparse
from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_tpu.ops import SurfaceField as JSF
from firefoam_tpu.ops import VolField as JVF
from firefoam_tpu.ops import bcs as jbcs
from firefoam_tpu.radiation.fvdom import FvDOM as JDOM
from firefoam_tpu.thermo import GasThermo as JGas
from firefoam_tpu.thermo import SingleStepReaction as JRx
from firefoam_tpu.turbulence.kEqn import KEqnLES as JK
from firefoam_tpu.utils.synthcase import write_box_fire_case
from firefoam_torch.combustion.edm import EddyDissipationModel as TEDM
from firefoam_torch.io import Case as TCase
from firefoam_torch.io.foamdict import parse_file as tparse
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.ops import SurfaceField as TSF
from firefoam_torch.ops import VolField as TVF
from firefoam_torch.ops import bcs as tbcs
from firefoam_torch.radiation.fvdom import FvDOM as TDOM
from firefoam_torch.thermo import GasThermo as TGas
from firefoam_torch.thermo import SingleStepReaction as TRx
from firefoam_torch.turbulence.kEqn import KEqnLES as TK

torch.set_num_threads(1)
TOL = 1e-10
SPECIES = ["O2", "H2O", "C3H8", "CO2", "N2"]


def _rel(a, b):
    a = np.asarray(a.numpy() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def case():
    with pytest.MonkeyPatch.context() as mp:
        # the JAX solver selection this comparison is held to
        for k in ("EXACT_SOLVERS", "AMG", "GMG", "PALLAS"):
            mp.setenv(f"FIREFOAM_TPU_{k}", "0")
        import tempfile

        with tempfile.TemporaryDirectory() as root:
            write_box_fire_case(root, n=(6, 6, 6))
            jg = JGeom.from_polymesh(j_build(root).mesh, dtype=jnp.float64)
            tg = TGeom.from_polymesh(t_build(root).mesh, dtype=torch.float64, device="cpu")
            jcase, tcase = JCase(root), TCase(root)
            th = os.path.join(root, "constant", "thermo.gas")
            rx = os.path.join(root, "constant", "reactions")
            jgas = JGas.from_dict(jparse(th, case_dir=root), SPECIES)
            tgas = TGas.from_dict(tparse(th, case_dir=root), SPECIES)
            jrx = JRx.from_case(jparse(rx, case_dir=root), jgas, "C3H8", "N2")
            trx = TRx.from_case(tparse(rx, case_dir=root), tgas, "C3H8", "N2")
            yield dict(root=root, jg=jg, tg=tg, jcase=jcase, tcase=tcase,
                       jgas=jgas, tgas=tgas, jrx=jrx, trx=trx)


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    T = 250.0 + 2250.0 * rng.rand(n)
    Y = rng.rand(n, len(SPECIES))
    Y /= Y.sum(1, keepdims=True)
    return T, Y


def test_gas_thermo_matches(case):
    jgas, tgas = case["jgas"], case["tgas"]
    T, Y = _inputs(500, 0)
    jT, jY, tT, tY = jnp.asarray(T), jnp.asarray(Y), torch.as_tensor(T), torch.as_tensor(Y)
    for name in ("cp", "hs", "ha", "psi", "mu", "kappa", "alpha"):
        assert _rel(getattr(tgas, name)(tT, tY), getattr(jgas, name)(jT, jY)) <= TOL, name
    assert _rel(tgas.R(tY), jgas.R(jY)) <= TOL
    assert _rel(tgas.cp_species(tT), jgas.cp_species(jT)) <= TOL
    hs = jgas.hs(jT, jY)
    guess = T * (1.0 + 0.05 * np.random.RandomState(1).randn(500))
    assert _rel(tgas.T_from_hs(torch.as_tensor(np.array(hs)), tY, torch.as_tensor(guess)),
                jgas.T_from_hs(hs, jY, jnp.asarray(guess))) <= TOL


def test_single_step_reaction_matches(case):
    jrx, trx = case["jrx"], case["trx"]
    for name in ("s", "stoic_ratio", "ft_stoich", "fuel_index", "o2_index", "inert_index"):
        assert getattr(trx, name) == pytest.approx(getattr(jrx, name), rel=1e-14), name
    assert trx.q_fuel() == pytest.approx(jrx.q_fuel(), rel=1e-14)
    np.testing.assert_allclose(trx.mass_stoich_coeffs, jrx.mass_stoich_coeffs, rtol=1e-14)


def test_edm_rates_match(case):
    jd = jparse(os.path.join(case["root"], "constant", "combustionProperties"))
    td = tparse(os.path.join(case["root"], "constant", "combustionProperties"))
    jm, tm = JEDM.from_case(jd, case["jrx"]), TEDM.from_case(td, case["trx"])
    rng = np.random.RandomState(2)
    n = 400
    _, Y = _inputs(n, 3)
    rho = 0.3 + rng.rand(n)
    k = 1e-4 + rng.rand(n) * 0.1
    eps = rng.rand(n)
    alpha = 1e-5 * (1 + rng.rand(n))
    delta = 0.01 + 0.01 * rng.rand(n)
    dt = 0.013
    jr = jm.rates(*(jnp.asarray(a) for a in (rho, Y, k, eps, alpha, delta)), dt)
    tr = tm.rates(*(torch.as_tensor(a) for a in (rho, Y, k, eps, alpha, delta)), dt)
    assert _rel(tr["w_fuel"], jr["w_fuel"]) <= TOL
    assert _rel(tm.qdot(tr), jm.qdot(jr)) <= TOL
    for s in range(len(SPECIES)):
        assert _rel(tm.R(tr, s), jm.R(jr, s)) <= TOL


def test_keqn_correct_matches(case):
    jg, tg = case["jg"], case["tg"]
    turb = jparse(os.path.join(case["root"], "constant", "turbulenceProperties"))
    jk = JK.from_case(jg, turb)
    tk = TK.from_case(tg, tparse(os.path.join(case["root"], "constant", "turbulenceProperties")))
    assert (tk.Ck, tk.Ce, tk.Prt) == (jk.Ck, jk.Ce, jk.Prt)
    assert _rel(tk.delta, jk.delta) <= 1e-14
    rng = np.random.RandomState(5)
    nC, nB, nI = jg.n_cells, jg.n_boundary, jg.n_internal
    mask = np.asarray(jg.face_mask)
    arrs = dict(
        k=(1e-4 + 1e-3 * rng.rand(nC), 1e-4 + 1e-3 * rng.rand(nB)),
        U=(0.1 * rng.randn(nC, 3), 0.1 * rng.randn(nB, 3)),
        rho=(1.0 + 0.2 * rng.rand(nC), 1.0 + 0.2 * rng.rand(nB)),
        mu=(1.8e-5 * (1 + rng.rand(nC)), 1.8e-5 * (1 + rng.rand(nB))),
        phi=(1e-3 * rng.randn(nI) * mask, 1e-3 * rng.randn(nB)),
    )
    rho_old = 1.0 + 0.2 * rng.rand(nC)
    dt = 0.01
    ctl = {"solver": "PBiCGStab", "tolerance": 1e-8, "relTol": 0.0, "maxIter": 50}
    jkb = jbcs.make_field_bcs(case["jcase"].field("k"), jg)
    tkb = tbcs.make_field_bcs(case["tcase"].field("k"), tg)

    def fields(mod_v, mod_s, arr):
        f = {n: mod_v(arr(a), arr(b)) for n, (a, b) in arrs.items() if n != "phi"}
        f["phi"] = mod_s(arr(arrs["phi"][0]), arr(arrs["phi"][1]))
        return f

    jf = fields(JVF, JSF, jnp.asarray)
    tf = fields(TVF, TSF, torch.as_tensor)
    jctx = {"phi": jf["phi"], "rho": jf["rho"], "U": jf["U"], "overrides": {}}
    tctx = {"phi": tf["phi"], "rho": tf["rho"], "U": tf["U"], "overrides": {}}
    jnew, jnut, jres = jk.correct(jf["k"], jkb, jf["U"], jf["rho"], jnp.asarray(rho_old),
                                  jf["phi"], jf["mu"], dt, jctx, ctl)
    tnew, tnut, tres = tk.correct(tf["k"], tkb, tf["U"], tf["rho"], torch.as_tensor(rho_old),
                                  tf["phi"], tf["mu"], dt, tctx, ctl)
    assert int(tres.n_iterations) == int(jres.n_iterations)
    assert _rel(tnew.i, jnew.i) <= TOL and _rel(tnew.b, jnew.b) <= TOL
    assert _rel(tnut, jnut) <= TOL
    gradU = np.random.RandomState(6).randn(nC, 3, 3)
    assert _rel(tk.div_dev_rho_reff(tf["U"], tf["mu"], torch.as_tensor(gradU)),
                jk.div_dev_rho_reff(jf["U"], jf["mu"], jnp.asarray(gradU))) <= TOL


def test_fvdom_ray_sweep_matches(case):
    """One fvDOM solve (16 rays, grey, constRadFractionEmission) from the
    same intensity field, wall temperatures and heat release."""
    jg, tg = case["jg"], case["tg"]
    rp_path = os.path.join(case["root"], "constant", "radiationProperties")
    jdom = JDOM.from_case_dict(jparse(rp_path), jg, case["jcase"])
    tdom = TDOM.from_case_dict(tparse(rp_path), tg, case["tcase"])
    assert tdom.n_rays == jdom.n_rays == 16
    for name in ("d_ave", "omega", "phi_ray", "phi_ray_b", "emissivity"):
        assert _rel(getattr(tdom, name), getattr(jdom, name)) <= 1e-14, name
    rng = np.random.RandomState(7)
    nC, nB = jg.n_cells, jg.n_boundary
    T = (300 + 900 * rng.rand(nC), 300 + 200 * rng.rand(nB))
    Y = (np.tile([0.23, 0.0, 0.0, 0.0, 0.77], (nC, 1)), np.tile([0.23, 0.0, 0.0, 0.0, 0.77], (nB, 1)))
    Qdot = 1e5 * rng.rand(nC)
    I0 = 100.0 * rng.rand(16, 1, nC)
    phi_b = rng.randn(nB)

    def state(mod_v, mod_s, arr, rad):
        return {
            "T": mod_v(arr(T[0]), arr(T[1])),
            "Y": mod_v(arr(Y[0]), arr(Y[1])),
            "p": mod_v(arr(np.full(nC, 101325.0)), arr(np.full(nB, 101325.0))),
            "Qdot": arr(Qdot),
            "phi": mod_s(arr(np.zeros(jg.n_internal)), arr(phi_b)),
            "rad": rad,
        }

    jrad = dict(jdom.initial_state(), I=jnp.asarray(I0))
    trad = dict(tdom.initial_state(), I=torch.as_tensor(I0))
    jst = state(JVF, JSF, jnp.asarray, jrad)
    tst = state(TVF, TSF, torch.as_tensor, trad)
    jout = jdom._solve_rays(jrad, jst, case["jgas"])
    tout = tdom._solve_rays(trad, tst, case["tgas"])
    for name in ("I", "G", "E", "aG", "aEn"):
        assert _rel(tout[name], jout[name]) <= TOL, name
    assert int(tout["count"]) == int(jout["count"]) == 1
    jst["rad"], tst["rad"] = jout, tout
    assert _rel(tdom.Sh(tst, case["tgas"]), jdom.Sh(jst, case["jgas"])) <= TOL
    # gating: solve on the first call, then every solverFreq calls
    counts = []
    rad = tdom.initial_state()
    for _ in range(12):
        tst["rad"] = rad
        new = tdom.maybe_correct(tst, case["tgas"])
        counts.append(new["I"] is not rad["I"])
        rad = new
    assert counts == [True] + [False] * 9 + [True, False]
