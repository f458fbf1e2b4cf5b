"""The spray's stock submodels in the solver step, end to end: the port's
FireFoamSolver against the JAX package's on the CPU in float64, both pinned
to the flat Krylov solvers as in tests/test_torch_step.py.

  * The multiphase spray fire (write_multiphase_spray_fire_case at (8, 6, 7),
    1000 parcels/s, maxDeltaT 0.005: a coneNozzle of C3H8/H2O/ash parcels,
    singleKineticRate devolatilisation of the C3H8 into the gas, MPPIC
    packing, damping and isotropy; 12,288 slots): the initial state (1e-12),
    one step from the same state at steps 1 and 11, and 5 chained steps
    after 10 warm-up steps, T, U, p_rgh, Y, k, dt, the radiation state and
    every cloud leaf (mv, mv0, ms, the key) within 1e-9, alive, cell and
    canCombust equal, iteration counts equal; the devolatilised mass reaches
    Srho and the C3H8 equation (the port's log equals the SY source's sum).
  * The DEM spray (write_dem_spray_fire_case at (8, 6, 7): two 4 mm drops
    thrown at each other, pairCollision with 20 sub-cycles; the cloud cut to
    256 slots in both packages, as the dense pair matrix of the JAX rule's
    4096 would take gigabytes here): one step from the initial state and one
    from the JAX states after 3 and 5 steps (the drops meet at about
    step 4), the pair records (omega, rec_id,
    rec_t, wrec_t) included.
  * The checkpoint of either state (the ledger lanes and the nested "pc"
    dict) loads back bit for bit and into the JAX package.
"""

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.io.checkpoint import load_checkpoint as j_load
from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_torch.io.checkpoint import load_checkpoint as t_load
from firefoam_torch.io.checkpoint import save_checkpoint as t_save
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy, state_to_numpy
from firefoam_torch.utils.synthcase import (write_dem_spray_fire_case,
                                            write_multiphase_spray_fire_case)

from test_torch_lagrangian_cloud import _cut_capacity
from test_torch_spray_step import PINS, _leaves, _pin_jax, check_step

torch.set_num_threads(1)
N = (8, 6, 7)
N_STEPS = 5
WARMUP = 10
DEM_STEPS = 6
DEM_CAPACITY = 256
CASE_KW = dict(n=N, max_dt=0.005, end_time=100.0)


def _trajectory(root, n_steps):
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
    return js, states, logs


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    root = write_multiphase_spray_fire_case(str(tmp_path_factory.mktemp("multi") / "c"),
                                            pps=1000.0, **CASE_KW)
    js, states, logs = _trajectory(root, WARMUP + N_STEPS)
    return root, states, logs, TSolver(root, device="cpu", dtype=torch.float64, **PINS)


@pytest.fixture(scope="module")
def dem(tmp_path_factory):
    root = write_dem_spray_fire_case(str(tmp_path_factory.mktemp("dem") / "c"), **CASE_KW)
    with pytest.MonkeyPatch.context() as mp:
        _cut_capacity(mp, DEM_CAPACITY)
        js, states, logs = _trajectory(root, DEM_STEPS)
        ts = TSolver(root, device="cpu", dtype=torch.float64, **PINS)
    return root, states, logs, ts


def test_multiphase_initial_state(multi):
    _, states, _, ts = multi
    assert ts.cloud.cfg.capacity == 12288 and ts.cloud.devol is not None
    assert ts.cloud.mppic is not None and ts.cloud.ledger is not None
    ours = dict(_leaves(state_to_numpy(ts.initial_state())))
    ref = dict(_leaves(states[0]))
    assert set(ours) == set(ref) and "cloud/mv" in ref and "cloud/ms" in ref
    for name, b in ref.items():
        a = np.asarray(ours[name], np.float64)
        b = np.asarray(b, np.float64)
        scale = max(np.max(np.abs(b), initial=0.0), 1e3 if name.startswith("hs.") else 1.0)
        assert np.max(np.abs(a - b), initial=0.0) / scale <= 1e-12, name


@pytest.mark.parametrize("n", (0, WARMUP))
def test_multiphase_step_from_the_same_state(multi, n):
    _, states, logs, ts = multi
    ours, log = ts.make_step()(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
    check_step(ours, log, states[n + 1], logs[n], n)
    if n:
        # the devolatilised C3H8 reaches the species equation whole
        srcs_state, out = ts._evolve_cloud(
            state_from_numpy(states[n], device="cpu", dtype=torch.float64), {})
        i = ts.gas.index("C3H8")
        gained = float(torch.sum(out["SY"][i] * ts.geom.V) * float(states[n]["dt"]))
        assert gained > 0.0
        assert abs(gained - float(log["cloud_massDevolatilised"])) <= 1e-12 * gained


def test_multiphase_five_chained_steps(multi):
    _, states, logs, ts = multi
    st = state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    step = ts.make_step()
    for n in range(WARMUP, WARMUP + N_STEPS):
        st, log = step(st)
        check_step(st, log, states[n + 1], logs[n], n)
        assert np.array_equal(st["cloud"]["canCombust"].numpy(),
                              np.asarray(states[n + 1]["cloud"]["canCombust"]))
    assert int(st["cloud"]["alive"].sum()) > 0 and float(st["cloud"]["mv"].sum()) > 0.0


@pytest.mark.parametrize("n", (0, 3, DEM_STEPS - 1))
def test_dem_step(dem, n):
    _, states, logs, ts = dem
    assert ts.cloud.cfg.capacity == DEM_CAPACITY and ts.cloud.pair_collision is not None
    ours, log = ts.make_step()(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
    check_step(ours, log, states[n + 1], logs[n], n)
    assert int(ours["cloud"]["alive"].sum()) == 2


def test_dem_drops_collided(dem):
    """The two drops met: their x velocities turned round."""
    _, states, _, _ = dem
    U0, U1 = (np.asarray(states[k]["cloud"]["U"]) for k in (1, DEM_STEPS))
    alive = np.asarray(states[DEM_STEPS]["cloud"]["alive"])
    assert alive.sum() == 2
    assert np.all(np.sign(U1[alive, 0]) == -np.sign(U0[alive, 0]))


@pytest.mark.parametrize("which", ("multi", "dem"))
def test_checkpoint_round_trip(multi, dem, which, tmp_path):
    """The port's checkpoint of a state with the ledger lanes or the pair
    records loads back bit for bit, and into the JAX package."""
    _, states, _, ts = multi if which == "multi" else dem
    st, _ = ts.make_step()(state_from_numpy(states[-2], device="cpu", dtype=torch.float64))
    path = t_save(str(tmp_path / "s.npz"), st)
    with np.load(path) as z:
        keys = set(z.files)
    want = ("['cloud']['mv']", "['cloud']['mv0']", "['cloud']['ms']") if which == "multi" else \
        tuple(f"['cloud']['pc']['{k}']" for k in ("omega", "rec_id", "rec_t", "wrec_t"))
    assert set(want) <= keys
    back = dict(_leaves(state_to_numpy(t_load(path, ts.initial_state()))))
    mine = dict(_leaves(state_to_numpy(st)))
    for k, v in mine.items():
        a, b = np.asarray(back[k]), np.asarray(v)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        theirs = dict(_leaves(j_load(path, states[0])))
    for k, v in mine.items():
        np.testing.assert_array_equal(np.asarray(theirs[k]).astype(np.float64),
                                      np.asarray(v).astype(np.float64), err_msg=k)
