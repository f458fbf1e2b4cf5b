"""The wetted panel fire (the singleBox family) end to end: the port's
FireFoamSolver against the JAX package's on the CPU in float64.

Case: firefoam_torch.utils.synthcase.write_wetted_panel_fire_case at
(8, 6, 7) in a 1 × 0.5 × 1 m box (so that the sprinkler's drops reach the
floor film within 22 steps), 1000 parcels/s, maxDeltaT 0.005, no collector:
the sprinkler fire with the reactingOneDim21 panel split in panelLow
(filmPyrolysisVelocityCoupled) and panelHigh (the pyrolysate inlet), both
under filmPyrolysisTemperatureCoupled, a thermoSingleLayer film over the floor
and the panel fed along the panel's top rim, the cloud's splashBai handoff
and the film's drip injection. Both sides run the flat Krylov solvers, pinned
as in tests/test_torch_step.py. Tolerances: one step from the same state at
steps 1, 11 and 26, and 5 chained steps after 10 warm-up steps and after 22
(when the spray strikes the film), 1e-9 for T, U, p_rgh, Y, k, dt, the
radiation state and every leaf of the cloud, the solid and the film (parcel
fields, alive and cell equal, the random key), with equal iteration counts
and parcel counts. Also: the film's mass ledger over the port's run from
t = 0 (impinged + inlet = film + evaporated + dripped + removed, 2e-3)."""

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy, state_to_numpy
from firefoam_torch.utils.synthcase import write_wetted_panel_fire_case

torch.set_num_threads(1)
N = (8, 6, 7)
N_STEPS = 5
WARMUP = 10
STRIKE = 22  # the spray strikes the film from about this step on
FIELDS = ("T", "U", "p_rgh", "Y", "k", "dt")
PINS = dict(exact_solvers=False, gmg=False, amg=False)
KEYS = ("rad", "cloud", "cloud_rad", "pyro", "film", "film_drip_b", "film_U_b")
CASE_KW = dict(n=N, pps=1000.0, max_dt=0.005, end_time=100.0, size=(1.0, 0.5, 1.0),
               collector=False)


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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = write_wetted_panel_fire_case(str(tmp_path_factory.mktemp("wet") / "case"), **CASE_KW)
    with pytest.MonkeyPatch.context() as mp:
        for k in ("EXACT_SOLVERS", "AMG", "GMG", "PALLAS"):
            mp.setenv(f"FIREFOAM_TPU_{k}", "0")
        mp.setenv("FIREFOAM_TPU_DTYPE", "float64")
        js = JSolver(root)
        st = js.initial_state()
        step = js.make_step()
        states, logs = [jax.device_get(st)], []
        for _ in range(STRIKE + N_STEPS):
            st, log = step(st)
            states.append(jax.device_get(st))
            logs.append(jax.device_get(log))
    return root, states, logs, TSolver(root, device="cpu", dtype=torch.float64, **PINS)


def check_step(ours, log, ref, ref_log, what):
    for f in FIELDS:
        assert _rel(_np(ours[f]), _np(ref[f])) <= 1e-9, (what, f)
    mine = dict(_leaves(state_to_numpy({k: ours[k] for k in KEYS if k in ours})))
    theirs = dict(_leaves({k: ref[k] for k in KEYS if k in ref}))
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
        if k.startswith(("pyro_", "film_", "cloud_")):
            assert _rel(_np(log[k]), np.asarray(ref_log[k]), floor=1e-300) <= 1e-9, (what, k)


def test_initial_state_matches(run):
    _, states, _, ts = run
    ours = dict(_leaves(state_to_numpy(ts.initial_state())))
    ref = dict(_leaves(states[0]))
    assert set(ours) == set(ref)
    for name, b in ref.items():
        floor = 1e3 if name.startswith("hs.") else 1.0
        assert _rel(ours[name], b, floor=floor) <= 1e-12, name
    assert ts.film.fm.n_faces == 44 + 28 and len(ts.cloud.injectors) == 2
    assert [p for p in ts.pyrolysis.zones[0].region.zones] == ["panelLow", "panelHigh"]


@pytest.mark.parametrize("n", (0, WARMUP, STRIKE + 3))
def test_step_from_the_same_state(run, n):
    _, states, logs, ts = run
    ours, log = ts.make_step()(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
    check_step(ours, log, states[n + 1], logs[n], n)


@pytest.mark.parametrize("start", (WARMUP, STRIKE))
def test_five_chained_steps(run, start):
    _, states, logs, ts = run
    st = state_from_numpy(states[start], device="cpu", dtype=torch.float64)
    step = ts.make_step()
    for n in range(start, start + N_STEPS):
        st, log = step(st)
        check_step(st, log, states[n + 1], logs[n], n)
    assert float(log["film_mass"]) > 0.0 and float(log["pyro_panelRegion_mlr"]) > 0.0
    if start == STRIKE:  # the spray has wetted the floor (the inlet feeds the panel only)
        base = ts.geom.patch("base")
        bidx = ts.film.fm.prim_bidx
        floor = (bidx >= base.start) & (bidx < base.start + base.n)
        assert float(st["film"]["delta"][torch.as_tensor(floor)].max()) > 0.0


def test_film_mass_ledger(run):
    """The port's run from t = 0 to the strike window's end: the water the
    inlet fed and the spray handed over = the film's mass + evaporated +
    dripped + removed, within 2e-3 of the water fed. The ledger is not
    exact: a substep adds the water's volume at the film's density at the
    gas pressure and its old T, and the film's mass is weighed at 1 atm and
    its new T (measured: at most 8e-4 over 40 steps)."""
    _, _, _, ts = run
    st = ts.initial_state()
    step = ts.make_step()
    inlet = ts.film.inlets[0]
    fed = imp = 0.0
    handed = {}
    orig = ts._evolve_film

    def spy(state, srcs, log):
        handed["m"] = float(srcs["filmMass"].sum()) if "filmMass" in srcs else 0.0
        return orig(state, srcs, log)

    ts._evolve_film = spy
    try:
        for _ in range(STRIKE + N_STEPS):
            dt = float(st["dt"])
            st, log = step(st)
            fed += inlet.gamma * inlet.width * dt
            imp += handed["m"]
    finally:
        del ts._evolve_film
    f = st["film"]
    out = float(log["film_mass"]) + float(f["evaporatedMass"]) + float(f["drippedMass"]) \
        + float(f["removedMass"])
    assert imp > 0.0
    assert abs(fed + imp - out) <= 2e-3 * (fed + imp)
