"""The fire step with P1 and with viewFactor radiation, the soot field the
writer writes, and a P1 checkpoint across the two packages: the port
against the JAX package on CPU in float64, as tests/test_torch_radiation_step.py
holds the fvDOM models (same cases, tolerances and pins).

  * P1: constantAbsorptionEmission, Marshak walls, the G solve one K1-twin
    row on steps 1 and 11;
  * viewFactor: the box fire with its top and sides made walls, the
    radiosity solved every step (solverFreq 1);
  * the soot field: a case with `sootModel mixtureFractionSoot` and
    `radiation off` writes `soot` in both packages (the port used to build
    no soot model and write no soot field), and the values agree;
  * a viewFactor case's time directory: the port writes it without `G`
    (the model has none); the JAX writer raises there (ROADMAP R6).
"""

import os
import re

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.io.writer import write_time_dir as j_write
from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_torch.io.writer import write_time_dir as t_write
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy
from firefoam_torch.utils.synthcase import write_radiation_fire_case

from test_torch_radiation_step import (PINS, WARMUP, _chain_matches, _check_step,
                                       _initial_state_matches, _pin_jax, _trajectory)

torch.set_num_threads(1)
MODELS = ("P1", "viewFactor")
_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("radp1vf")
    cache = {}

    def get(model):
        if model not in cache:
            kw = dict(solver_freq=1) if model == "viewFactor" else {}
            cache[model] = _trajectory(base, model, **kw)
        return cache[model]

    return get


@pytest.mark.parametrize("model", MODELS)
def test_initial_state_matches(runs, model):
    _, states, _, ts = runs(model)
    _initial_state_matches(ts, states)


@pytest.mark.parametrize("model", MODELS)
def test_radiation_steps_from_the_same_state(runs, model):
    """Steps 1 and 11 from the JAX state: P1 solves G on both, viewFactor
    its radiosity on every step."""
    _, states, logs, ts = runs(model)
    step = ts.make_step()
    solves = getattr(ts.radiation, "solves", None)
    for n in (0, WARMUP):
        ours, log = step(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
        _check_step(ours, log, states[n + 1], logs[n], n)
        q = ts.radiation.qin_boundary(ours["rad"])
        assert float(q.abs().max()) > 0.0
    if solves is not None:
        assert ts.radiation.solves - solves == 2


@pytest.mark.parametrize("model", MODELS)
def test_five_chained_steps(runs, model):
    _, states, logs, ts = runs(model)
    _chain_matches(ts, states, logs)


def test_p1_checkpoint_resumes_across_packages(runs, tmp_path):
    """P1's radiation state (G, G_b, gamma_b, E, a, e, count, chi) goes
    through both packages' checkpoints unchanged, and the port steps on
    from the JAX package's."""
    from firefoam_tpu.io.checkpoint import load_checkpoint as j_load
    from firefoam_tpu.io.checkpoint import save_checkpoint as j_save
    from firefoam_torch.io.checkpoint import load_checkpoint as t_load
    from firefoam_torch.io.checkpoint import save_checkpoint as t_save

    _, states, logs, ts = runs("P1")
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        jpath = j_save(str(tmp_path / "jax.npz"), states[WARMUP])
    st = t_load(jpath, ts.initial_state())
    assert set(st["rad"]) == {"G", "G_b", "gamma_b", "E", "a", "e", "count", "chi"}
    st, log = ts.make_step()(st)
    _check_step(st, log, states[WARMUP + 1], logs[WARMUP], WARMUP)
    mine = t_save(str(tmp_path / "port.npz"), st)
    with np.load(jpath) as a, np.load(mine) as b:
        assert set(a.files) == set(b.files)
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        back = j_load(mine, states[0])
    for k, v in st["rad"].items():
        np.testing.assert_array_equal(np.asarray(back["rad"][k]), v.numpy(), err_msg=k)


def _numbers(path):
    with open(path) as f:
        return np.array([float(x) for x in _NUM.findall(f.read().split("dimensions", 1)[1])])


def test_soot_field_is_written_with_radiation_off(tmp_path):
    """A case with mixtureFractionSoot and `radiation off`: the JAX solver
    builds the soot model anyway and its writer writes `soot`. Without a
    soot model (as the port was) the port's time directory lacks it; with
    the model it has the same files and the same soot values."""
    root = write_radiation_fire_case(str(tmp_path / "case"), n=(6, 5, 6), model="greyMean")
    rp = os.path.join(root, "constant", "radiationProperties")
    with open(rp) as f:
        txt = f.read()
    with open(rp, "w") as f:
        f.write(txt.replace("radiation on;", "radiation off;"))
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        js = JSolver(root)
        assert js.radiation is None and js.soot is not None
        jst = js.initial_state()
        step = js.make_step()
        for _ in range(4):
            jst, _ = step(jst)
        jst = jax.device_get(jst)
        jdir = j_write(str(tmp_path / "jax"), 1.0, js, jst)
    ts = TSolver(root, device="cpu", dtype=torch.float64, **PINS)
    assert ts.radiation is None and ts.soot is not None
    tst = state_from_numpy(jst, device="cpu", dtype=torch.float64)
    jfiles = sorted(os.listdir(jdir))
    assert "soot" in jfiles
    soot, ts.soot = ts.soot, None
    before = t_write(str(tmp_path / "before"), 1.0, ts, tst)
    assert sorted(os.listdir(before)) == [f for f in jfiles if f != "soot"]
    ts.soot = soot
    tdir = t_write(str(tmp_path / "port"), 1.0, ts, tst)
    assert sorted(os.listdir(tdir)) == jfiles
    a, b = _numbers(os.path.join(tdir, "soot")), _numbers(os.path.join(jdir, "soot"))
    assert a.shape == b.shape and float(np.max(b)) > 0.0
    np.testing.assert_allclose(a, b, rtol=2e-8, atol=1e-9 * float(np.max(np.abs(b))))


def test_view_factor_time_dir(runs, tmp_path):
    """viewFactor carries no G: the port writes the time directory without
    it; the JAX writer reads state['rad']['G'] and raises (ROADMAP R6)."""
    root, states, _, ts = runs("viewFactor")
    tdir = t_write(str(tmp_path / "port"), 1.0, ts,
                   state_from_numpy(states[2], device="cpu", dtype=torch.float64))
    files = os.listdir(tdir)
    assert "T" in files and "soot" in files and "G" not in files
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        js = JSolver(root)
        with pytest.raises(KeyError):
            j_write(str(tmp_path / "jax"), 1.0, js, states[2])
