"""Two repairs of the port, each against the JAX package's behaviour:

  * constant/additionalControls is read as the JAX constructor reads it:
    with `solvePyrolysisRegion false` a constant/pyrolysisZones file is
    skipped, with it true the zones are built as the JAX package builds them
    (none for 'pyrolysisModel none'), and `solvePrimaryRegion false` steps
    the regions alone, as in the JAX package;
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
from firefoam_torch.utils.synthcase import write_box_fire_case, write_pyrolysis_1d_case

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


def test_additional_controls_build_the_regions_as_jax_does(tmp_path):
    """With solvePyrolysisRegion true both packages read
    constant/pyrolysisZones: 'pyrolysisModel none' builds no zone in either;
    with solvePrimaryRegion false both step the regions alone (the time
    advances, the gas stays), and a solid-only case steps its solid alike."""
    from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver

    root = write_box_fire_case(str(tmp_path / "box"), n=N)
    _controls(root, primary=True, pyrolysis=True)
    js, ts = JSolver(root), TSolver(root, device="cpu")
    assert js.pyrolysis is None and ts.pyrolysis is None and ts.solve_pyrolysis
    _controls(root, primary=False, pyrolysis=False)
    js, ts = JSolver(root), TSolver(root, device="cpu")
    assert js.solve_primary is False and ts.solve_primary is False
    st0 = ts.initial_state()
    st, log = ts.make_step()(st0)
    assert float(st["t"]) > float(st0["t"]) and torch.equal(st["T"].i, st0["T"].i)
    solid = write_pyrolysis_1d_case(str(tmp_path / "p1d"), n=(4, 4, 4))
    js, ts = JSolver(solid), TSolver(solid, device="cpu")
    jst, jlog = js.make_step()(js.initial_state())
    st, log = ts.make_step()(ts.initial_state())
    assert [z.model for z in ts.pyrolysis.zones] == [z.model for z in js.pyrolysis.zones]
    for k in ("pyro_panelRegion_T_max", "pyro_panelRegion_mlr"):
        assert abs(float(log[k]) - float(jlog[k])) <= 1e-9 * max(abs(float(jlog[k])), 1.0), k
    assert abs(float(st["dt"]) - float(jst["dt"])) <= 1e-12


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
