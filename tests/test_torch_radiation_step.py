"""The fire step with each fvDOM radiation model, end to end: the port's
FireFoamSolver against the JAX package's on CPU in float64, through the
normal entry points (initial_state, make_step), on the cases of
firefoam_torch.utils.synthcase.write_radiation_fire_case at (8, 6, 7):

  * greyMean: greyMeanAbsorptionEmission with the ft table (CO and soot),
    constantScatter, maxIter 3 with convergence 1e-3, an absorptivityMode
    lookup wall, mixtureFractionSoot;
  * wideBand: 16 rays × 3 wideBand bands (one K1-twin batch of 48 rows);
  * wsggBand: wsggmAbsorptionEmissionSmithBand, 4 bands;
  * spSoot: spSootRadFracEmission and its flamelet table.

Both sides run the flat Krylov solvers (the twins of K1/K2), pinned as in
tests/test_torch_step.py. Radiation solves on steps 1 and 11 (solverFreq
10). Tolerances: initial_state 1e-12; the step from the same state at
steps 1 and 11 (both radiation steps) and 5 chained steps after 10
warm-up steps 1e-9 for T, U, p_rgh, Y, k, dt and the radiation state, with
equal iteration counts. Also: a checkpoint of the banded case resumes
across the two packages.
"""

import os

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.io.checkpoint import load_checkpoint as j_load
from firefoam_tpu.io.checkpoint import save_checkpoint as j_save
from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_torch.io.checkpoint import load_checkpoint as t_load
from firefoam_torch.io.checkpoint import save_checkpoint as t_save
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy, state_to_numpy
from firefoam_torch.utils.synthcase import write_radiation_fire_case

torch.set_num_threads(1)
N = (8, 6, 7)
N_STEPS = 5
WARMUP = 10
FIELDS = ("T", "U", "p_rgh", "Y", "k", "dt")
MODELS = ("greyMean", "wideBand", "wsggBand", "spSoot")
PINS = dict(exact_solvers=False, gmg=False, amg=False)


def _rel(a, b, floor=1.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), floor))


def _np(x):
    x = getattr(x, "i", x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif isinstance(v, tuple):
            yield f"{prefix}{k}.i", v.i
            yield f"{prefix}{k}.b", v.b
        else:
            yield prefix + k, v


def _pin_jax(mp):
    for k in ("EXACT_SOLVERS", "AMG", "GMG", "PALLAS"):
        mp.setenv(f"FIREFOAM_TPU_{k}", "0")
    mp.setenv("FIREFOAM_TPU_DTYPE", "float64")


def _trajectory(base, model, **kw):
    """(case root, the JAX package's states and logs over WARMUP + N_STEPS
    steps, the port's solver)."""
    root = write_radiation_fire_case(str(base / model), n=N, model=model, n_bands=3, **kw)
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
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("radstep")
    cache = {}

    def get(model):
        if model not in cache:
            cache[model] = _trajectory(base, model)
        return cache[model]

    return get


def _check_step(ours, log, ref, ref_log, what):
    for f in FIELDS:
        assert _rel(_np(ours[f]), _np(ref[f])) <= 1e-9, (what, f)
    mine = dict(_leaves(state_to_numpy(ours["rad"])))
    for k, v in _leaves(ref["rad"]):
        assert _rel(mine[k], v) <= 1e-9, (what, "rad", k)
    for k in ref_log:
        if k.endswith("_iters") or "iters_" in k:
            assert int(log[k]) == int(ref_log[k]), (what, k)


def _initial_state_matches(ts, states):
    ours = dict(_leaves(state_to_numpy(ts.initial_state())))
    ref = dict(_leaves(states[0]))
    assert set(ours) == set(ref)
    for name, b in ref.items():
        floor = 1e3 if name.startswith("hs.") else 1.0
        assert _rel(ours[name], b, floor=floor) <= 1e-12, name


def _radiation_steps_match(ts, states, logs):
    step = ts.make_step()
    for n in (0, WARMUP):
        assert int(states[n]["rad"]["count"]) % ts.radiation.solver_freq == 0
        ours, log = step(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
        _check_step(ours, log, states[n + 1], logs[n], n)


def _chain_matches(ts, states, logs):
    st = state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    step = ts.make_step()
    for n in range(WARMUP, WARMUP + N_STEPS):
        st, log = step(st)
        _check_step(st, log, states[n + 1], logs[n], n)


@pytest.mark.parametrize("model", MODELS)
def test_initial_state_matches(runs, model):
    _, states, _, ts = runs(model)
    _initial_state_matches(ts, states)
    if model == "wideBand":
        assert tuple(ts.initial_state()["rad"]["I"].shape) == (16, 3, int(np.prod(N)))


@pytest.mark.parametrize("model", MODELS)
def test_radiation_steps_from_the_same_state(runs, model):
    """Steps 1 and 11, each with a radiation solve, from the JAX state."""
    _, states, logs, ts = runs(model)
    before = ts.radiation.sweeps
    _radiation_steps_match(ts, states, logs)
    # grey-mean: maxIter 3, so a solve may sweep more than once
    assert 2 <= ts.radiation.sweeps - before <= 2 * ts.radiation.max_iter


@pytest.mark.parametrize("model", MODELS)
def test_five_chained_steps(runs, model):
    _, states, logs, ts = runs(model)
    _chain_matches(ts, states, logs)


def test_banded_checkpoint_resumes_across_packages(runs, tmp_path):
    """The banded case's state at step WARMUP (I of [nR, nL, nC]): the JAX
    package's checkpoint loads into the port and steps on as the JAX run
    did; the port's checkpoint has the same keys and loads into the JAX
    package bit for bit."""
    _, states, logs, ts = runs("wideBand")
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        jpath = j_save(str(tmp_path / "jax.npz"), states[WARMUP])
    st = t_load(jpath, ts.initial_state())
    step = ts.make_step()
    for n in range(WARMUP, WARMUP + 2):
        st, log = step(st)
        _check_step(st, log, states[n + 1], logs[n], n)
    mine = t_save(str(tmp_path / "port.npz"), st)
    with np.load(jpath) as a, np.load(mine) as b:
        assert set(a.files) == set(b.files)
        assert "['rad']['I']" in b.files and b["['rad']['I']"].shape[1] == 3
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        back = j_load(mine, states[0])
    for k, v in _leaves(state_to_numpy(st)):
        np.testing.assert_array_equal(np.asarray(dict(_leaves(back))[k]), v, err_msg=k)
