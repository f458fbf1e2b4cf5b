"""The gas-phase variants on the castellated (SEG) mesh: the wall fire of
write_wall_fire_case (unsheared) castellated around the obstruction by
synthcase.castellate_case, the port against the JAX package on the CPU in
float64, with nothing pinned but the JAX side's SEG layout (and its boundary
sums, as in tests/test_torch_seg_step.py).

What the mesh gives a place to:
  * the non-orthogonal correction ('laplacianSchemes default Gauss linear
    limited 0.5') across the 2:1 hanging-node faces, whose correction
    vectors k_f are not zero (the background lattice is orthogonal, so
    every non-zero k_f is a hanging-node face's);
  * the wall functions on the obstruction's `box` wall patch
    (nutUSpaldingWallFunction, compressible::alphatWallFunction,
    kqRWallFunction), beside the fire wall functions on `wall` and
    Spalding on `base`;
  * filteredLinear2V, WALE and BertExt with its Fstar specie, as in the
    lattice wall fire.

The JAX side gets the two test-side repairs of tests/test_torch_wall_fire.py:
the p_rgh flux's non-orthogonal face flux (ROADMAP R3) and the host value
of q_fuel (R5). Tolerances as there: initial state 1e-12; one step from the
same state and each step of a 5-step chain after 10 warm-up steps 1e-9 for
T, U, p_rgh, Y, k, nut, alphat and dt, with equal iteration counts.
"""

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy, state_to_numpy
from firefoam_torch.utils.synthcase import _set_patch, castellate_case, write_wall_fire_case

from test_torch_wall_fire import _SOLVER_ENV, _check, _leaves, _rel, _with_corrected_flux

torch.set_num_threads(1)
N = (8, 6, 8)
N_STEPS = 5
WARMUP = 10
BOX_WALL_FUNCTIONS = {
    "nut": "type nutUSpaldingWallFunction;\n        value uniform 0;",
    "alphat": "type compressible::alphatWallFunction;\n        Prt 1;\n        value uniform 0;",
    "k": "type kqRWallFunction;\n        value uniform 1e-4;",
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = write_wall_fire_case(str(tmp_path_factory.mktemp("segwall")), n=N, shear=0.0)
    castellate_case(root)
    for field, spec in BOX_WALL_FUNCTIONS.items():
        _set_patch(root, field, "box", spec)
    with pytest.MonkeyPatch.context() as mp:
        for k in _SOLVER_ENV:
            mp.delenv(f"FIREFOAM_TPU_{k}", raising=False)
        mp.setenv("FIREFOAM_TPU_DTYPE", "float64")
        mp.setenv("FIREFOAM_TPU_LAYOUT", "seg")
        mp.setenv("FIREFOAM_TPU_LATTICE_BC", "0")
        _with_corrected_flux(mp)
        js = JSolver(root)
        q_fuel = js.reaction.q_fuel()
        js.reaction.q_fuel = lambda: q_fuel
        st = js.initial_state()
        step = js.make_step()
        states, logs = [jax.device_get(st)], []
        for _ in range(WARMUP + N_STEPS):
            st, log = step(st)
            states.append(jax.device_get(st))
            logs.append(jax.device_get(log))
    ts = TSolver(root, device="cpu")
    return js, ts, states, logs


def test_the_case_runs_the_variants_it_names(run):
    js, ts, states, _ = run
    g = ts.geom
    assert g.layout == js.geom.layout == "seg" and ts._ldu is not None
    assert ts.lap_limiter == js.lap_limiter == 0.5
    assert ts.u_div_scheme == ("filteredLinear2", 0.2, 0.05)
    assert ts.combustion.variant == "eddyDissipationBertExtModel"
    # hanging-node faces: non-zero correction vectors, equal to the JAX ones
    k = g.kvec().numpy()
    assert float(np.max(np.linalg.norm(k, axis=1))) > 0.1
    np.testing.assert_allclose(k, np.asarray(js.geom.kvec()), rtol=0, atol=1e-12)
    assert np.array_equal(g.nodc.numpy(), np.asarray(js.geom.nodc))
    # the obstruction's wall functions acted
    box = g.patch("box").slice
    assert float(np.max(np.abs(states[-1]["nut"].b[box]))) > 0.0
    assert float(np.max(np.abs(states[-1]["alphat"].b[box]))) > 0.0


def test_initial_state_matches(run):
    _, ts, states, _ = run
    ours = dict(_leaves(state_to_numpy(ts.initial_state())))
    ref = dict(_leaves(states[0]))
    assert set(ours) == set(ref)
    for name, b in ref.items():
        floor = 1e3 if name.startswith("hs.") else 1.0
        assert _rel(ours[name], b, floor=floor) <= 1e-12, name


def test_one_step_from_the_same_state(run):
    _, ts, states, logs = run
    for n in (0, WARMUP):
        ours, log = ts.make_step()(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
        _check(ours, log, n, states, logs)


def test_five_chained_steps(run):
    _, ts, states, logs = run
    st = state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    step = ts.make_step()
    for n in range(WARMUP, WARMUP + N_STEPS):
        st, log = step(st)
        _check(st, log, n, states, logs)
