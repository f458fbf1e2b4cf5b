"""The sprinkler fire step, end to end: the port's FireFoamSolver against the
JAX package's on CPU in float64, through the normal entry points, on
firefoam_torch.utils.synthcase.write_spray_fire_case at (8, 6, 7) (the box
fire with a detailed-sprinkler head above the burner, a collector, and the
cloud's radiation in fvDOM: the spray's aDisp, sigmap, Ep and anisotropic
in-scatter; 1000 parcels/s, maxDeltaT 0.005, so 12,288 parcel slots).

Both sides run the flat Krylov solvers (the twins of K1/K2), pinned as in
tests/test_torch_step.py. Radiation solves on steps 1 and 11. Tolerances:
initial_state 1e-12; one step from the same state at steps 1, 6 and 11 and
5 chained steps after 10 warm-up steps 1e-9 for T, U, p_rgh, Y, k, dt, the
radiation state, the spray's radiation fields and every leaf of the cloud
(parcel fields, alive and cell equal, injector and collector states, the
random key), with equal iteration counts. Also: the checkpoint of a
sprinkler state (the cloud's SoA, lists and key) resumes across the two
packages, the run surface (run_case, the collector and sprinkler logs,
the written VFSpray) agrees with the JAX run_case's, and the port's mass
bookkeeping closes over its own run from t = 0 (1e-12 of the injected mass).
"""

import os

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.io.checkpoint import load_checkpoint as j_load
from firefoam_tpu.io.checkpoint import save_checkpoint as j_save
from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_tpu.models.run import run_case as j_run_case
from firefoam_torch.io import read_field_file
from firefoam_torch.io.checkpoint import load_checkpoint as t_load
from firefoam_torch.io.checkpoint import save_checkpoint as t_save
from firefoam_torch.models import run as trun
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy, state_to_numpy
from firefoam_torch.utils.synthcase import write_spray_fire_case

torch.set_num_threads(1)
N = (8, 6, 7)
N_STEPS = 5
WARMUP = 10
FIELDS = ("T", "U", "p_rgh", "Y", "k", "dt")
PINS = dict(exact_solvers=False, gmg=False, amg=False)
CASE_KW = dict(n=N, pps=1000.0, max_dt=0.005, end_time=100.0)
RADIATION = True  # the spray's terms in fvDOM (test_torch_spray_step_norad.py: off)


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


def trajectory(base, radiation):
    """(case root, the JAX package's states and logs over WARMUP + N_STEPS
    steps, the port's solver)."""
    root = write_spray_fire_case(str(base / "case"), radiation=radiation, **CASE_KW)
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        js = JSolver(root)
        st = js.initial_state()
        step = js.make_step()
        states, logs = [jax.device_get(st)], []
        for _ in range(WARMUP + N_STEPS):
            st, log = step(st)
            states.append(jax.device_get(st))
            logs.append(jax.device_get(log))
    ts = TSolver(root, device="cpu", dtype=torch.float64, **PINS)
    return root, states, logs, ts


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return trajectory(tmp_path_factory.mktemp("spray"), RADIATION)


def check_step(ours, log, ref, ref_log, what):
    for f in FIELDS:
        assert _rel(_np(ours[f]), _np(ref[f])) <= 1e-9, (what, f)
    mine = dict(_leaves(state_to_numpy({k: ours[k] for k in ("rad", "cloud", "cloud_rad")
                                        if k in ours})))
    theirs = dict(_leaves({k: ref[k] for k in ("rad", "cloud", "cloud_rad") if k in ref}))
    assert set(mine) == set(theirs), (what, set(mine) ^ set(theirs))
    for k, v in theirs.items():
        a, b = np.asarray(mine[k]), np.asarray(v)
        if b.dtype.kind in "biu":
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), (what, k)
        else:
            assert _rel(a, b, floor=1e-300) <= 1e-9, (what, k, _rel(a, b, floor=1e-300))
    for k in ref_log:
        if k.endswith("_iters") or "iters_" in k:
            assert int(log[k]) == int(ref_log[k]), (what, k)
    for k in ("cloud_nParcels", "cloud_mass"):
        assert _rel(_np(log[k]), np.asarray(ref_log[k]), floor=1e-300) <= 1e-9, (what, k)


def test_initial_state_matches(run):
    _, states, _, ts = run
    ours = dict(_leaves(state_to_numpy(ts.initial_state())))
    ref = dict(_leaves(states[0]))
    assert set(ours) == set(ref)
    for name, b in ref.items():
        floor = 1e3 if name.startswith("hs.") else 1.0
        assert _rel(ours[name], b, floor=floor) <= 1e-12, name
    assert ts.cloud.cfg.capacity == 12288 and ("cloud_rad" in states[0]) == RADIATION


@pytest.mark.parametrize("n", (0, 5, WARMUP))
def test_step_from_the_same_state(run, n):
    _, states, logs, ts = run
    before = ts.radiation.sweeps
    ours, log = ts.make_step()(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
    check_step(ours, log, states[n + 1], logs[n], n)
    # fvDOM solves on steps 1 and 11, with the spray's terms when they are on
    assert ts.radiation.sweeps - before == (1 if n in (0, WARMUP) else 0)


def test_five_chained_steps(run):
    _, states, logs, ts = run
    st = state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    step = ts.make_step()
    for n in range(WARMUP, WARMUP + N_STEPS):
        st, log = step(st)
        check_step(st, log, states[n + 1], logs[n], n)
    assert int(st["cloud"]["alive"].sum()) > 0


def test_checkpoint_resumes_across_packages(run, tmp_path):
    """The JAX package's checkpoint of a sprinkler state (step WARMUP) loads
    into the port and steps on as the JAX run did; the port's has the same
    keys (the key as uint32) and loads into the JAX package bit for bit."""
    _, states, logs, ts = run
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        jpath = j_save(str(tmp_path / "jax.npz"), states[WARMUP])
    st = t_load(jpath, ts.initial_state())
    step = ts.make_step()
    for n in range(WARMUP, WARMUP + 2):
        st, log = step(st)
        check_step(st, log, states[n + 1], logs[n], n)
    mine = t_save(str(tmp_path / "port.npz"), st)
    with np.load(jpath) as a, np.load(mine) as b:
        assert set(a.files) == set(b.files)
        assert b["['cloud']['rng']"].dtype == np.uint32
        assert "['cloud']['inj'][0]['m_owed']" in b.files
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        back = j_load(mine, states[0])
    theirs = dict(_leaves(back))
    for k, v in _leaves(state_to_numpy(st)):
        np.testing.assert_array_equal(np.asarray(theirs[k]).astype(np.float64),
                                      np.asarray(v).astype(np.float64), err_msg=k)


def _read_dat(path):
    return np.loadtxt(path, comments="#", ndmin=2)


@pytest.mark.skipif(not RADIATION, reason="the run surface is checked once")
def test_run_surface_against_jax_run_case(run, tmp_path):
    """run_case on both sides for 6 steps, writing at the end: the collector
    and sprinkler logs and the written VFSpray/rhoSpray agree."""
    import shutil

    root = str(tmp_path / "case")
    shutil.copytree(run[0], root)
    ctl = os.path.join(root, "system", "controlDict")
    with open(ctl) as f:
        txt = f.read()
    with open(ctl, "w") as f:  # one write, at step 5 (t = 0.025)
        f.write(txt.replace("writeControl adjustableRunTime; writeInterval 1;",
                            "writeControl runTime; writeInterval 0.0225;"))
    n_steps = 6
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        js, jst, _ = j_run_case(root, max_steps=n_steps, verbose=False,
                                output_dir=str(tmp_path / "jax"), write_fields=True)
        js.cloud.write_collectors(jst["cloud"], str(tmp_path / "jax_pp"))
        js.cloud.write_sprinkler_logs(jst["cloud"], str(tmp_path / "jax_pp"))
    ts, tst, _ = trun.run_case(root, max_steps=n_steps, verbose=False, device="cpu",
                               output_dir=str(tmp_path / "port"), write_fields=True, **PINS)
    ts.cloud.write_collectors(tst["cloud"], str(tmp_path / "port_pp"))
    ts.cloud.write_sprinkler_logs(tst["cloud"], str(tmp_path / "port_pp"))
    for sub in (os.path.join("collector1", "collector.dat"),
                os.path.join("sprinklers", "model1.dat")):
        a = _read_dat(str(tmp_path / "port_pp" / sub))
        b = _read_dat(str(tmp_path / "jax_pp" / sub))
        assert _rel(a, b, floor=1e-300) <= 1e-7, sub  # 6-8 printed digits
    times = sorted(d for d in os.listdir(tmp_path / "jax") if d[0].isdigit() and d != "0")
    assert times and times == sorted(d for d in os.listdir(tmp_path / "port")
                                     if d[0].isdigit() and d != "0")
    nC = int(np.prod(N))
    for f in ("VFSpray", "rhoSpray"):
        a = read_field_file(str(tmp_path / "port" / times[-1] / f)).internal_array(nC)
        b = read_field_file(str(tmp_path / "jax" / times[-1] / f)).internal_array(nC)
        assert np.max(b) > 0.0
        assert _rel(a, b, floor=1e-300) <= 1e-7, f
    # the port's CLI main writes the same logs
    out = tmp_path / "cli"
    assert trun.main(["--case", root, "--cpu", "--max-steps", "2", "--quiet", "--output",
                      str(out)]) == 0
    pp = [os.path.join(dp, f) for d in (out, root) for dp, _, fs in os.walk(d) for f in fs
          if f.endswith(".dat")]
    assert any(p.endswith(os.path.join("sprinklers", "model1.dat")) for p in pp)
    assert any(p.endswith(os.path.join("collector1", "collector.dat")) for p in pp)


def test_mass_bookkeeping_closes(run):
    """The port's run from t = 0 over WARMUP + N_STEPS steps: the mass the
    head released (its K-factor flow since t = 0, less what it still owes) +
    the expansion term = in the parcels + evaporated + escaped + collected +
    dropped at minParticleMass, within 1e-12 of the injected mass. The
    expansion term (a parcel's diameter is sized at its old temperature's
    density, so its mass follows ρ(T)) is not negligible."""
    _, _, _, ts = run
    st = ts.initial_state()
    step = ts.make_step()
    total = dict.fromkeys(("Evaporated", "Escaped", "Dropped", "Expansion"), 0.0)
    elapsed = 0.0
    for _ in range(WARMUP + N_STEPS):
        st, log = step(st)
        elapsed += float(log["dt"])
        for k in total:
            total[k] += float(log[f"cloud_mass{k}"])
    injected = sum(inj.n_spr * inj.Q * 1000.0 * elapsed - float(ist["m_owed"].sum())
                   for inj, ist in zip(ts.cloud.injectors, st["cloud"]["inj"]))
    collected = sum(float(c["mass"].sum()) for c in st["cloud"]["coll"])
    out = (float(log["cloud_mass"]) + total["Evaporated"] + total["Escaped"] + collected
           + total["Dropped"])
    assert abs(injected + total["Expansion"] - out) <= 1e-12 * injected
    assert abs(total["Expansion"]) > 1e-6 * injected
