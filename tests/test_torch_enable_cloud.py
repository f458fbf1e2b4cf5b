"""ROADMAP P17 on the CPU in float64: the solver's `enable_cloud` switch and
the checkpoint aliases of utils/checkpoint.py, against the JAX package.

  * The spray fire (write_spray_fire_case at (6, 5, 6)) with enable_cloud
    False builds no cloud in either package and their initial states agree
    (the same keys, no "cloud"; 1e-12); with the switch on (the default)
    the cloud is there. A step without the cloud is held to the JAX one on
    the wetted panel fire below.
  * save_state/load_state round-trip a state bit for bit in the port, and
    the port's file loads into the JAX package's load_state.
  * ROADMAP R17 (reference side, kept by the port): a film without a cloud
    breaks species continuity. The wetted panel fire
    (write_wetted_panel_fire_case at (8, 6, 7), 1 x 0.5 x 1 m) with
    enable_cloud False, 6 steps in the JAX package: the port's step from
    the JAX state after 5 steps agrees with the JAX step (1e-9), so both
    route the film's evaporation the same way. The film's evaporation adds
    to continuity (Srho) and to SYv, but SYv reaches the H2O equation only
    through the cloud's vapour species: a twin of the port's solver that
    routes SYv to H2O without a cloud gains, in that step, the film's
    evaporated mass more H2O than the solver as it is (0.8-1.2 of it).
"""

import types

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_tpu.utils.checkpoint import load_state as j_load_state
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy, state_to_numpy
from firefoam_torch.utils.checkpoint import load_state, save_state
from firefoam_torch.utils.synthcase import write_spray_fire_case, write_wetted_panel_fire_case

torch.set_num_threads(1)
PINS = dict(exact_solvers=False, gmg=False, amg=False)
FIELDS = ("T", "U", "p_rgh", "Y", "k", "dt")
WET_STEPS = 6


def _pin_jax(mp):
    for k in ("EXACT_SOLVERS", "AMG", "GMG", "PALLAS"):
        mp.setenv(f"FIREFOAM_TPU_{k}", "0")
    mp.setenv("FIREFOAM_TPU_DTYPE", "float64")


def _rel(a, b):
    a = np.asarray(getattr(a, "i", a).detach().cpu() if torch.is_tensor(getattr(a, "i", a))
                   else getattr(a, "i", a), np.float64)
    b = np.asarray(getattr(b, "i", b), np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b), initial=0.0) / max(np.max(np.abs(b), initial=0.0), 1.0))


def _check(ours, log, ref, ref_log, what):
    for f in FIELDS:
        assert _rel(ours[f], ref[f]) <= 1e-9, (what, f)
    for k in ref_log:
        if k.endswith("_iters") or "iters_" in k:
            assert int(log[k]) == int(ref_log[k]), (what, k)


@pytest.fixture(scope="module")
def spray(tmp_path_factory):
    return write_spray_fire_case(str(tmp_path_factory.mktemp("nocloud") / "c"), n=(6, 5, 6),
                                 pps=1000.0, max_dt=0.005, end_time=100.0)


def test_spray_fire_without_its_cloud(spray):
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        js = JSolver(spray, enable_cloud=False)
        st0 = jax.device_get(js.initial_state())
    ts = TSolver(spray, device="cpu", dtype=torch.float64, enable_cloud=False, **PINS)
    assert js.cloud is None and ts.cloud is None
    mine = ts.initial_state()
    assert set(mine) == set(st0) and "cloud" not in mine and "cloud_rad" not in mine
    for f in FIELDS:
        assert _rel(mine[f], st0[f]) <= 1e-12, f
    _, tlog = ts.make_step()(mine)
    assert not any(k.startswith("cloud_") for k in tlog)
    assert TSolver(spray, device="cpu", dtype=torch.float64, **PINS).cloud is not None


def test_checkpoint_aliases(spray, tmp_path):
    ts = TSolver(spray, device="cpu", dtype=torch.float64, **PINS)
    st, _ = ts.make_step()(ts.initial_state())
    path = save_state(str(tmp_path / "s.npz"), st)
    back = load_state(path, ts.initial_state())
    a, b = state_to_numpy(st), state_to_numpy(back)
    flat = lambda s: dict(jax.tree_util.tree_flatten_with_path(s)[0])  # noqa: E731
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=str(k))
    # the JAX package's alias reads the port's file
    theirs = flat(j_load_state(path, a))
    for k in fa:
        np.testing.assert_array_equal(np.asarray(theirs[k]).astype(np.float64),
                                      np.asarray(fa[k]).astype(np.float64), err_msg=str(k))


def _h2o(state, solver):
    """Σ ρ·Y_H2O·V over the cells [kg]."""
    i = solver.gas.index("H2O")
    return float(torch.sum(state["rho"].i * state["Y"].i[:, i] * solver.geom.V))


def test_r17_a_film_without_a_cloud_loses_its_vapour(tmp_path):
    root = write_wetted_panel_fire_case(str(tmp_path / "wet"), n=(8, 6, 7), pps=1000.0,
                                        max_dt=0.005, end_time=100.0, size=(1.0, 0.5, 1.0),
                                        collector=False)
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        js = JSolver(root, enable_cloud=False)
        st = js.initial_state()
        step = js.make_step()
        states, logs = [jax.device_get(st)], []
        for _ in range(WET_STEPS):
            st, log = step(st)
            states.append(jax.device_get(st))
            logs.append(jax.device_get(log))
    assert js.cloud is None and js.film is not None
    ts = TSolver(root, device="cpu", dtype=torch.float64, enable_cloud=False, **PINS)
    n = WET_STEPS - 1
    start = state_from_numpy(states[n], device="cpu", dtype=torch.float64)
    ours, log = ts.make_step()(start)
    _check(ours, log, states[n + 1], logs[n], "wetted, no cloud")
    evaporated = float(log["film_evap"]) - float(logs[n - 1]["film_evap"])
    assert evaporated > 0.0
    # the twin: SYv routed to H2O as a cloud's vapour species would route it
    twin = TSolver(root, device="cpu", dtype=torch.float64, enable_cloud=False, **PINS)
    twin.cloud = types.SimpleNamespace(vapour_indices=(twin.gas.index("H2O"),),
                                       vapour_fracs=(1.0,), film=None)
    twin._evolve_cloud = ts._evolve_cloud  # no cloud to evolve: zero sources
    fixed, _ = twin.make_step()(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
    h0 = _h2o(start, ts)
    missing = (_h2o(fixed, twin) - h0) - (_h2o(ours, ts) - h0)
    print(f"R17: the step's H2O short by {missing:.4e} kg, the film evaporated "
          f"{evaporated:.4e} kg (ratio {missing / evaporated:.5f})")
    assert 0.8 <= missing / evaporated <= 1.2, (missing, evaporated)
