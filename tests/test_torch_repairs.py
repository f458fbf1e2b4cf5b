"""Two repairs of the port, each against the JAX package's behaviour:

  * constant/additionalControls is read as the JAX constructor reads it:
    with `solvePyrolysisRegion false` a constant/pyrolysisZones file is
    skipped (the port raised on any such file before), with it true the
    pyrolysis regions still raise, and `solvePrimaryRegion false` (the
    solid-only step) raises naming the region-model item of the roadmap;
  * p_rgh's maxIter: on the card K2 is launched with the dictionary's
    maxIter (as the JAX package's fused kernel takes c0["maxIter"]), also
    for the float64 solve of `p_rgh_f64`; on the CPU the Jacobi-CG twin
    keeps 1000 (as the JAX package's flat CG does). Read from the launch
    arguments, with the recorder of tests/test_torch_grid_plan.py standing
    in for the library."""

import os

import pytest
import torch

from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.solvers import dia_krylov
from firefoam_torch.utils.synthcase import write_box_fire_case

from test_torch_grid_plan import _FakeCard

torch.set_num_threads(1)
N = (6, 5, 4)
_PYRO_ZONES = "FoamFile { version 2.0; format ascii; class dictionary; object pyrolysisZones; }\n" \
              "( pyrolysis { active true; pyrolysisModel none; regionName panelRegion; } )\n"


def _controls(root, primary, pyrolysis):
    with open(os.path.join(root, "constant", "additionalControls"), "w") as f:
        f.write("FoamFile { version 2.0; format ascii; class dictionary; "
                "object additionalControls; }\n"
                f"solvePrimaryRegion {'true' if primary else 'false'};\n"
                f"solvePyrolysisRegion {'true' if pyrolysis else 'false'};\n")
    with open(os.path.join(root, "constant", "pyrolysisZones"), "w") as f:
        f.write(_PYRO_ZONES)


def test_additional_controls_skip_pyrolysis_zones(tmp_path):
    from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver

    root = write_box_fire_case(str(tmp_path / "box"), n=N)
    _controls(root, primary=True, pyrolysis=False)
    js = JSolver(root)
    ts = TSolver(root, device="cpu")
    assert (ts.solve_primary, ts.solve_pyrolysis) == (js.solve_primary, js.solve_pyrolysis) \
        == (True, False)
    assert js.pyrolysis is None
    state, log = ts.make_step()(ts.initial_state())
    assert bool(torch.isfinite(state["T"].i).all()) and int(log["p_rgh_iters_1"]) > 0


def test_additional_controls_still_refuse_what_the_port_lacks(tmp_path):
    from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver

    root = write_box_fire_case(str(tmp_path / "box"), n=N)
    _controls(root, primary=True, pyrolysis=True)
    with pytest.raises(NotImplementedError, match="pyrolysis regions"):
        TSolver(root, device="cpu")
    _controls(root, primary=False, pyrolysis=False)
    js = JSolver(root)
    assert js.solve_primary is False  # the JAX package steps the solid only
    with pytest.raises(NotImplementedError, match="P13"):
        TSolver(root, device="cpu")


def _with_max_iter(root, max_iter):
    path = os.path.join(root, "system", "fvSolution")
    with open(path) as f:
        text = f.read()
    old = "p_rgh { solver PCG; preconditioner DIC; tolerance 1e-6; relTol 0.01; }"
    assert old in text
    with open(path, "w") as f:
        f.write(text.replace(old, old[:-1] + f"maxIter {max_iter}; }}"))


@pytest.mark.parametrize("p_rgh_f64", [False, True])
def test_k2_takes_the_dictionary_max_iter_on_the_card_only(tmp_path, monkeypatch, p_rgh_f64):
    root = write_box_fire_case(str(tmp_path / "box"), n=N)
    _with_max_iter(root, 37)
    dtype = torch.float32 if p_rgh_f64 else torch.float64
    ts = TSolver(root, device="cpu", dtype=dtype, exact_solvers=False, gmg=False, amg=False,
                 p_rgh_f64=p_rgh_f64)
    # one p_rgh system of a step, and the CPU twin's max_iter on it
    got, twin_max_iter, orig_solve = [], [], ts._solve_p_rgh
    monkeypatch.setattr(ts, "_solve_p_rgh", lambda *a: got.append(a) or orig_solve(*a))
    orig_plain = dia_krylov.plain

    def plain(fn, *a, **k):
        if fn is dia_krylov.linear.pcg:
            twin_max_iter.append(a[-1])
        return orig_plain(fn, *a, **k)

    monkeypatch.setattr(dia_krylov, "plain", plain)
    ts.make_step()(ts.initial_state())
    assert len(got) == 2 and set(twin_max_iter) == {1000}
    # the same solve as the card makes it: every wrapper launches (the
    # recorder stands in for the library) and the solver believes it is on
    # the card
    card = _FakeCard(monkeypatch)
    monkeypatch.setattr(dia_krylov, "_dispatch",
                        lambda name, twin, *a: dia_krylov._launch(name, *a))
    ts.device = torch.device("cuda")
    m, x0, final = got[-1]
    ts._solve_p_rgh(m, x0, final)
    (fn_name, args), = card.calls
    assert fn_name.startswith("ffk_pcg_")
    assert fn_name.endswith("f64") == (p_rgh_f64 or dtype == torch.float64)
    assert args[20] == 37  # max_iter, after tol, rel_tol and the float32 floor
