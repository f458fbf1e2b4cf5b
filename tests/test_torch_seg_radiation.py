"""The radiation family on the castellated (SEG) mesh: one fire step each of
grey-mean fvDOM, P1 and viewFactor, the port against the JAX package on the
CPU in float64.

The cases are write_radiation_fire_case's at n=(8,6,8), castellated by
synthcase.castellate_case around the obstruction (its faces a `box` wall
patch, grey diffusive for the rays, Marshak for P1, one of the walls of
viewFactor's enclosure). Both sides run the flat Krylov solvers, pinned as
in tests/test_torch_radiation_step.py, and the JAX side the SEG layout
(FIREFOAM_TPU_LAYOUT=seg, with FIREFOAM_TPU_LATTICE_BC=0 as in
tests/test_torch_seg_step.py). The first step solves the radiation in every
model (grey-mean: three sweeps of 16 rays; P1: the G system; viewFactor:
the radiosity, solverFreq 1).

Tolerances as in tests/test_torch_radiation_step.py: initial_state 1e-12;
the first step from the same state 1e-9 for T, U, p_rgh, Y, k, dt and
every leaf of the radiation state, with equal iteration counts; viewFactor's
wall qr on walls at 300-1200 K 1e-9 of its largest value.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy
from firefoam_torch.utils.synthcase import castellate_case, write_radiation_fire_case

from test_torch_radiation_step import PINS, _check_step, _initial_state_matches, _pin_jax

torch.set_num_threads(1)
N = (8, 6, 8)
MODELS = ("greyMean", "P1", "viewFactor")


@pytest.fixture(scope="module", params=MODELS)
def run(request, tmp_path_factory):
    """(model, the JAX solver, its states and logs over one step, the port's
    solver) on the castellated radiation case."""
    model = request.param
    kw = dict(solver_freq=1) if model == "viewFactor" else {}
    root = write_radiation_fire_case(str(tmp_path_factory.mktemp(model)), n=N, model=model, **kw)
    castellate_case(root)
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        mp.setenv("FIREFOAM_TPU_LAYOUT", "seg")
        mp.setenv("FIREFOAM_TPU_LATTICE_BC", "0")
        js = JSolver(root)
        st = js.initial_state()
        states = [jax.device_get(st)]
        st, log = js.make_step()(st)
        states.append(jax.device_get(st))
    ts = TSolver(root, device="cpu", dtype=torch.float64, **PINS)
    return model, js, states, [jax.device_get(log)], ts


def test_initial_state_matches(run):
    _, js, states, _, ts = run
    assert ts.geom.layout == js.geom.layout == "seg"
    assert "box" in [p.name for p in ts.geom.patches]
    _initial_state_matches(ts, states)


def test_radiation_step_from_the_same_state(run):
    model, js, states, logs, ts = run
    ours, log = ts.make_step()(state_from_numpy(states[0], device="cpu", dtype=torch.float64))
    _check_step(ours, log, states[1], logs[0], model)
    if model != "viewFactor":
        assert float(ours["rad"]["G"].abs().max()) > 0.0


@pytest.mark.parametrize("run", ["viewFactor"], indirect=True)
def test_view_factor_qr_with_the_obstruction_among_the_walls(run):
    """The radiosity solve on walls at 300-1200 K (in the step the walls are
    isothermal and qr is round-off): the obstruction's faces take part and
    exchange heat, and qr agrees to 1e-9 of the largest |qr|."""
    _, js, _, _, ts = run
    box = ts.geom.patch("box").slice
    sel = ts.radiation.sel.numpy()
    assert np.isin(np.arange(box.start, box.stop), sel).all()
    T_b = 300.0 + 900.0 * np.random.default_rng(0).random(ts.geom.n_boundary)
    q, _ = ts.radiation._solve(torch.as_tensor(T_b))
    q_ref, _ = js.radiation._solve(jnp.asarray(T_b))
    q, q_ref = q.numpy(), np.asarray(q_ref)
    on_box = np.isin(sel, np.arange(box.start, box.stop))
    assert float(np.min(np.abs(q_ref[on_box]))) > 0.0
    assert float(np.max(np.abs(q - q_ref))) <= 1e-9 * float(np.max(np.abs(q_ref)))
