"""The pyrolysing panel fire and the solid-only case, end to end: the port's
FireFoamSolver against the JAX package's on the CPU in float64, through the
normal entry points.

Cases: firefoam_torch.utils.synthcase.write_panel_fire_case at (8, 6, 7) (the
box fire with a reactingOneDim21 panel of 28 columns × 20 layers on the
x = 0 wall, coupled to the gas through turbulentTemperatureRadiationQin-
CoupledMixed, flowRateInletVelocityPyrolysisCoupled and fvDOM's wall mode
pyrolysisModel; the panel outgasses from the first step) and
write_pyrolysis_1d_case (the panel alone under a fixed incident flux,
solvePrimaryRegion false). Both sides run the flat Krylov solvers (the twins
of K1/K2), pinned as in tests/test_torch_step.py. Tolerances: initial_state
1e-12; one step from the same state at steps 1, 6 and 11 and 5 chained steps
after 10 warm-up steps 1e-9 for T, U, p_rgh, Y, k, dt and every leaf of
the solid's state, 1e-8 for the radiation state (RAD_TOL), with equal
iteration counts. Also: the
solid's mass ledger (the mass the solid lost = the pyrolysate it sent out),
the checkpoint of a panel state across the two packages, and run_case with
a checkpoint resume against the uninterrupted run and the JAX run_case.
"""

import os
import shutil

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.io.checkpoint import load_checkpoint as j_load
from firefoam_tpu.io.checkpoint import save_checkpoint as j_save
from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_tpu.models.run import run_case as j_run_case
from firefoam_torch.io.checkpoint import load_checkpoint as t_load
from firefoam_torch.io.checkpoint import save_checkpoint as t_save
from firefoam_torch.models import run as trun
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy, state_to_numpy
from firefoam_torch.utils.synthcase import write_panel_fire_case, write_pyrolysis_1d_case

torch.set_num_threads(1)
N = (8, 6, 7)
N_STEPS = 5
WARMUP = 10
FIELDS = ("T", "U", "p_rgh", "Y", "k", "dt")
PINS = dict(exact_solvers=False, gmg=False, amg=False)
REGION_KEYS = ("rad", "pyro")
# the radiation state (I, G, ...): the fvDOM ray solves stop at a residual of
# 1e-4, and where they stop moves with the last bit of the panel's surface T
# (the solid's Arrhenius exp is XLA's in the JAX package, PyTorch's here):
# measured 3.5e-9 in I at the first solve (the step from t = 0), 0 from
# step 5, 4.2e-15 from step 10 and throughout the chain after it, with the
# 1500 K strip below the panel; every other leaf and field is held to 1e-9
RAD_TOL = 1e-8


def _rel(a, b, floor=1.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b), initial=0.0) / max(np.max(np.abs(b), initial=0.0), floor))


def _np(x):
    x = getattr(x, "i", x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _leaves(d, prefix=""):
    items = d.items() if isinstance(d, dict) else enumerate(d)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}/")
        elif isinstance(v, tuple):
            yield f"{prefix}{k}.i", v.i
            yield f"{prefix}{k}.b", v.b
        else:
            yield f"{prefix}{k}", v


def _pin_jax(mp):
    for k in ("EXACT_SOLVERS", "AMG", "GMG", "PALLAS"):
        mp.setenv(f"FIREFOAM_TPU_{k}", "0")
    mp.setenv("FIREFOAM_TPU_DTYPE", "float64")


def trajectory(root, n_steps):
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        js = JSolver(root)
        st = js.initial_state()
        step = js.make_step()
        states, logs = [jax.device_get(st)], []
        for _ in range(n_steps):
            st, log = step(st)
            states.append(jax.device_get(st))
            logs.append(jax.device_get(log))
    return states, logs, TSolver(root, device="cpu", dtype=torch.float64, **PINS)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    root = write_panel_fire_case(str(tmp_path_factory.mktemp("panel") / "case"), n=N)
    return (root,) + trajectory(root, WARMUP + N_STEPS)


@pytest.fixture(scope="module")
def solid(tmp_path_factory):
    root = write_pyrolysis_1d_case(str(tmp_path_factory.mktemp("p1d") / "case"), n=(4, 4, 4))
    return (root,) + trajectory(root, WARMUP + N_STEPS)


def check_regions(ours, ref, what, fields=FIELDS):
    for f in fields:
        assert _rel(_np(ours[f]), _np(ref[f])) <= 1e-9, (what, f)
    mine = dict(_leaves(state_to_numpy({k: ours[k] for k in REGION_KEYS if k in ours})))
    theirs = dict(_leaves({k: ref[k] for k in REGION_KEYS if k in ref}))
    assert set(mine) == set(theirs), (what, set(mine) ^ set(theirs))
    for k, v in theirs.items():
        a, b = np.asarray(mine[k]), np.asarray(v)
        if b.dtype.kind in "biu":
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), (what, k)
        else:
            tol = RAD_TOL if k.startswith("rad/") else 1e-9
            assert _rel(a, b, floor=1e-300) <= tol, (what, k, _rel(a, b, floor=1e-300))


def check_log(log, ref_log, what):
    for k in ref_log:
        if k.endswith("_iters") or "iters_" in k:
            assert int(log[k]) == int(ref_log[k]), (what, k)
        if k.startswith("pyro_"):
            assert _rel(_np(log[k]), np.asarray(ref_log[k]), floor=1e-300) <= 1e-9, (what, k)


def test_initial_state_matches(panel):
    _, states, _, ts = panel
    ours = dict(_leaves(state_to_numpy(ts.initial_state())))
    ref = dict(_leaves(states[0]))
    assert set(ours) == set(ref)
    for name, b in ref.items():
        floor = 1e3 if name.startswith("hs.") else 1.0
        assert _rel(ours[name], b, floor=floor) <= 1e-12, name
    z = ts.pyrolysis.zones[0]
    assert (z.region.n_faces, z.region.n_layers) == (28, 20)
    assert ts.radiation.solid_eps_fn is not None


@pytest.mark.parametrize("n", (0, 5, WARMUP))
def test_step_from_the_same_state(panel, n):
    _, states, logs, ts = panel
    ours, log = ts.make_step()(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
    check_regions(ours, states[n + 1], n)
    check_log(log, logs[n], n)


def test_five_chained_steps(panel):
    _, states, logs, ts = panel
    st = state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    step = ts.make_step()
    for n in range(WARMUP, WARMUP + N_STEPS):
        st, log = step(st)
        check_regions(st, states[n + 1], n)
        check_log(log, logs[n], n)
    # the pyrolysate flows through the coupled inlet into the gas
    assert float(log["pyro_panelRegion_mlr"]) > 0.0
    p = ts.geom.patch("region0_to_panelRegion_panel")
    assert float(-st["phi"].b[p.slice].sum()) > 0.0


def test_solid_mass_ledger(panel):
    """The port's run from t = 0: the mass the solid lost equals the
    pyrolysate it sent out (Σ phiGas·dt) and its own tally, within 1e-12;
    the gas takes the fuel-equivalent share of it through the panel."""
    _, _, _, ts = panel
    st = ts.initial_state()
    step = ts.make_step()
    rho0 = sum(float((z["rho"] * torch.as_tensor(zz.region.dx)[None, :]
                      * torch.as_tensor(zz.region.area)[:, None]).sum())
               for z, zz in zip(st["pyro"], ts.pyrolysis.zones))
    sent = 0.0
    for _ in range(WARMUP):
        dt = float(st["dt"])
        st, log = step(st)
        sent += float(log["pyro_panelRegion_mlr"]) * dt
    z, zz = st["pyro"][0], ts.pyrolysis.zones[0]
    mass = float((z["rho"] * torch.as_tensor(zz.region.dx)[None, :]
                  * torch.as_tensor(zz.region.area)[:, None]).sum())
    assert sent > 0.0
    assert abs((rho0 - mass) - sent) <= 1e-12 * rho0
    assert abs(float(z["lostSolidMass"]) - sent) <= 1e-12 * rho0


def test_solid_only_steps(solid):
    """solvePrimaryRegion false: a step evolves the solid alone, the gas
    stays as it was; one step from the same state and a 5-step chain."""
    _, states, logs, ts = solid
    assert ts.solve_primary is False
    fields = ("T", "U", "p_rgh", "dt")
    for n in (0, WARMUP):
        ours, log = ts.make_step()(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
        check_regions(ours, states[n + 1], n, fields)
        check_log(log, logs[n], n)
    st = state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    for n in range(WARMUP, WARMUP + N_STEPS):
        st, log = ts.step(st)
        check_regions(st, states[n + 1], n, fields)
    assert _rel(_np(st["T"]), _np(states[0]["T"])) == 0.0  # the gas never steps
    assert float(log["pyro_panelRegion_T_max"]) > 298.15


def test_checkpoint_resumes_across_packages(panel, tmp_path):
    _, states, logs, ts = panel
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        jpath = j_save(str(tmp_path / "jax.npz"), states[WARMUP])
    st = t_load(jpath, ts.initial_state())
    st, log = ts.make_step()(st)
    check_regions(st, states[WARMUP + 1], WARMUP)
    mine = t_save(str(tmp_path / "port.npz"), st)
    with np.load(jpath) as a, np.load(mine) as b:
        assert set(a.files) == set(b.files)
        assert "['pyro'][0]['Ys0']" in b.files
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        back = j_load(mine, states[0])
    theirs = dict(_leaves(back))
    for k, v in _leaves(state_to_numpy(st)):
        np.testing.assert_array_equal(np.asarray(theirs[k]).astype(np.float64),
                                      np.asarray(v).astype(np.float64), err_msg=k)


def test_run_case_resume(panel, solid, tmp_path):
    """run_case for 6 steps writing at step 3 (a time directory and a
    checkpoint), then a resume from that checkpoint for 3 steps: equal to
    the uninterrupted run bit for bit, and to the JAX run_case within 1e-9;
    the CLI runs the solid-only case and prints its region log."""
    root = str(tmp_path / "case")
    shutil.copytree(panel[0], root)
    ctl = os.path.join(root, "system", "controlDict")
    with open(ctl) as f:
        txt = f.read()
    with open(ctl, "w") as f:
        f.write(txt.replace("writeControl adjustableRunTime; writeInterval 1;",
                            "writeControl runTime; writeInterval 0.05;"))
    out = str(tmp_path / "port")
    ts, full, logs = trun.run_case(root, max_steps=6, verbose=False, device="cpu",
                                   output_dir=out, write_fields=True, **PINS)
    ckpts = sorted(os.listdir(os.path.join(out, "checkpoints")))
    assert ckpts
    ck = os.path.join(out, "checkpoints", ckpts[0])
    t_ck = float(t_load(ck, ts.initial_state())["t"])
    n_before = 1 + next(i for i, lg in enumerate(logs) if float(lg["t"]) == t_ck)
    assert 0 < n_before < 6
    _, resumed, _ = trun.run_case(root, max_steps=6 - n_before, verbose=False, device="cpu",
                                  resume=ck, **PINS)
    mine = dict(_leaves(state_to_numpy(resumed)))
    for k, v in _leaves(state_to_numpy(full)):
        np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(v), err_msg=k)
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        _, jst, _ = j_run_case(root, max_steps=6, verbose=False)
    check_regions(full, jax.device_get(jst), "run_case")
    assert trun.main(["--case", solid[0], "--cpu", "--max-steps", "2", "--output",
                      str(tmp_path / "cli")]) == 0


def test_r14_qin_sums_the_rays_leaving_the_wall(panel):
    """ROADMAP R14, a fault of the JAX package that the port keeps for
    parity: fvDOM's qin (the wall reflection's and qin_boundary, which the
    pyrolysis BC absorbs) sums the owner cells' intensity over the rays with
    d·Sf < 0, those leaving the wall into the gas, where greyDiffusiveRadiation
    sums the rays arriving at it (d·n > 0). On the panel after the first
    solve the rays arriving there come from the cold open side and carry
    σ·(298.15 K)⁴ = 448 W/m²; the JAX package's qin reads the 1500 K strip
    below the panel through the leaving rays' cell values, up to 3.8e4 W/m²
    on the panel (the strip and the panel are coplanar: none of its emission
    can reach the panel)."""
    _, states, _, ts = panel
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        js = JSolver(panel[0])
        j_qin = np.asarray(js.radiation.qin_boundary(states[1]["rad"]))
    rad = state_from_numpy({"rad": states[1]["rad"]}, device="cpu", dtype=torch.float64)["rad"]
    g, fv = ts.geom, ts.radiation
    qin = fv.qin_boundary(rad).numpy()
    assert _rel(qin, j_qin, floor=1e-300) <= 1e-12
    arriving = torch.einsum("rlb,rb->b", rad["I"].index_select(2, g.b_own),
                            torch.clamp(fv.phi_ray_b, min=0.0) / g.b_magSf).numpy()
    p = g.patch("region0_to_panelRegion_panel")
    assert np.allclose(arriving[p.slice], 5.670374419e-8 * 298.15 ** 4, rtol=1e-3)
    assert np.min(qin[p.slice]) > 5.0 * np.max(arriving[p.slice])
