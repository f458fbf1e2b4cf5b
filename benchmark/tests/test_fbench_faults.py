"""`correct` against faults, at a size a test run holds: the harness's run
(its look for a card skipped, the CPU in its place) with the program's step
broken underneath comes out not correct, as does the control (the reference
with its state held in bfloat16) put in the program's place."""

import pytest
import torch

from fbench import harness
from fbench.check import Reference
from fbench.harness import Cell

# the room at the steckler demo's own 0.2 m: 9,000 cells
H = 0.2
WARMUP = 6


def _cell(name="steckler_72k.chunk20"):
    cell = Cell(name)
    cell.config["case"]["h"] = H
    cell.config["warmup_steps"] = WARMUP
    return cell


def _run(cell, tmp_path):
    return harness.run(cell, 2**33 + 99, 0.0, False, 0.0, device="cpu", tmp_root=str(tmp_path))


def _break_after_warmup(monkeypatch, fault):
    """Let set-up warm up with the sound step, then `fault` the step."""
    from firefoam_torch.models.firefoam import FireFoamSolver

    sound, calls = FireFoamSolver.step, {"n": 0}

    def step(self, state):
        calls["n"] += 1
        new, log = sound(self, state)
        return (fault(state, new), log) if calls["n"] > WARMUP else (new, log)

    monkeypatch.setattr(FireFoamSolver, "step", step)


def _unchanged(old, new):
    out = dict(new)
    for f in ("T", "U", "p_rgh", "hs", "k", "Y", "rad"):
        out[f] = old[f]
    return out


def _altered(old, new):
    """The flame's temperature (the hottest 1 % of cells) off by a tenth of
    the field's range where the step produces it."""
    out = dict(new)
    T = new["T"]
    i = T.i.clone()
    hot = torch.topk(i, max(1, i.numel() // 100)).indices
    i[hot] += 0.1 * float(i.max() - i.min())
    out["T"] = type(T)(i, T.b)
    return out


@pytest.mark.parametrize("fault", [None, _unchanged, _altered],
                         ids=["sound", "state_unchanged", "T_altered"])
def test_a_broken_step_is_not_correct(monkeypatch, tmp_path, fault):
    if fault is not None:
        _break_after_warmup(monkeypatch, fault)
    res = _run(_cell(), tmp_path)
    bad = [k for k, c in res["checks"].items() if not c["value"] <= c["limit"]]
    assert res["correct"] is (fault is None), res["checks"]
    assert bool(bad) is (fault is not None)


def test_the_control_is_not_correct(tmp_path):
    """The control (the reference with its state held in bfloat16) in the
    program's place fails the limits, by at least three times every number
    the float32 program reads on the same seed."""
    from fbench.check import judge
    from fbench.harness import Output, compare, make_segment, warm_up, write_case
    from firefoam_torch.models.firefoam import FireFoamSolver

    cell = _cell()
    steps = int(cell.traffic["segment_steps"])
    case = write_case(cell.config, str(tmp_path / "case"))
    solver = FireFoamSolver(case, device="cpu", dtype=torch.float32)
    inputs, start, warm = warm_up(solver, cell.config, cell.traffic, 2**33 + 99)
    out, _ = make_segment(solver, cell.traffic)(warm)
    prog = Output.of_program(solver, start, warm, out)
    ref = Output.of_reference(Reference(case, "cpu"), inputs, prog, steps)
    ctl = Output.of_reference(Reference(case, "cpu", bf16_state=True), inputs, prog, steps)
    sound, control = compare(prog, ref), compare(ctl, ref)
    assert judge(control, cell.config["limits"])[0] is False
    for k, v in sound.items():
        assert control[k] >= 3 * v, (k, v, control[k])
