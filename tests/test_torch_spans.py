"""The spans at the step's phases (firefoam_torch/utils/spans.py) on the CPU.

Two steps of a small box fire with fvDOM (solverFreq 10: the first step
solves the rays, the second does not), and of the P1 fire, under
torch.profiler with CPU activity:
  * one ff.step a step, every other ff.* span inside one, the phases in the
    step's order (the Courant log, the cloud, UEqn, YEqn, radiation, EEqn,
    two pEqn correctors, kEqn, the end-of-step log);
  * ff.radiation.solve once, inside the first step's ff.radiation;
  * every ff.* event a plain operator event (cpu_op), never a user
    annotation, which the profiler would copy onto the device's timeline;
  * the state and the logs bitwise those of the same steps run with no
    profiler.
"""

import numpy as np
import pytest
import torch

from firefoam_torch.models.firefoam import FireFoamSolver
from firefoam_torch.utils.synthcase import write_box_fire_case, write_radiation_fire_case

torch.set_num_threads(1)

N = (4, 4, 4)
PHASES = ["ff.log", "ff.lagrangian", "ff.UEqn", "ff.YEqn", "ff.radiation", "ff.EEqn",
          "ff.pEqn", "ff.pEqn", "ff.kEqn", "ff.log"]


def _leaves(x, path=""):
    """(path, tensor) of every tensor in a nested state or log."""
    if isinstance(x, torch.Tensor):
        yield path, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(x, (list, tuple)):
        for k, v in enumerate(x):
            yield from _leaves(v, f"{path}/{k}")


def _run(solver, state, steps):
    logs = []
    for _ in range(steps):
        state, log = solver.step(state)
        logs.append(log)
    return state, logs


def _spans(prof):
    """(name, start ns, end ns, activity type) of the ff.* events, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), str(e.activity_type()))
           for e in prof.profiler.kineto_results.events() if e.name().startswith("ff.")]
    return sorted(out, key=lambda x: (x[1], -x[2]))


@pytest.mark.parametrize("model", ["fvDOM", "P1"])
def test_spans_at_the_phases_leave_the_step_bitwise(tmp_path, model):
    root = str(tmp_path / "case")
    if model == "fvDOM":
        case = write_box_fire_case(root, n=N)
    else:
        case = write_radiation_fire_case(root, n=N, model="P1")
    solver = FireFoamSolver(case, device="cpu", dtype=torch.float64)
    state0 = solver.initial_state()
    ref_state, ref_logs = _run(solver, state0, 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state, logs = _run(solver, state0, 2)

    got, want = dict(_leaves((state, logs))), dict(_leaves((ref_state, ref_logs)))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k

    spans = _spans(prof)
    assert {a for *_, a in spans} == {"cpu_op"}
    steps = [(s, e) for n, s, e, _ in spans if n == "ff.step"]
    assert len(steps) == 2
    inner = [x for x in spans if x[0] != "ff.step"]
    for n, s, e, _ in inner:
        assert sum(a <= s and e <= b for a, b in steps) == 1, n
    solves = [x for x in inner if x[0] == "ff.radiation.solve"]
    assert len(solves) == 1 and steps[0][0] <= solves[0][1] <= steps[0][1]
    rad = [x for x in inner if x[0] == "ff.radiation"]
    assert len(rad) == 2 and rad[0][1] <= solves[0][1] and solves[0][2] <= rad[0][2]
    for a, b in steps:
        phases = [n for n, s, e, _ in inner if a <= s and e <= b and n != "ff.radiation.solve"]
        assert phases == PHASES
        # the phases follow one another: none holds another
        iv = [(s, e) for n, s, e, _ in inner if a <= s and e <= b and n != "ff.radiation.solve"]
        assert all(e0 <= s1 for (_, e0), (s1, _) in zip(iv, iv[1:]))
    assert np.isfinite(float(logs[-1]["T_max"]))
