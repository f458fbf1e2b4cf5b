"""The step with the solvers each package picks by itself, and with the
multigrids forced on both sides: the port's FireFoamSolver against the JAX
package's on the CPU, through initial_state and make_step.

Configurations (small meshes: the JAX side unrolls every wavefront level
when it traces the step):
  * box / smooth, float64, NOTHING pinned on either side: the automatic
    rule builds the wavefront LDU schedule, so p_rgh and the hydrostatic
    init run the OpenFOAM-exact DIC-PCG (box fire: `PCG` + `DIC`) and Yi, h
    and k of the smoothSolver case run symGaussSeidel (`nSweeps 1`);
  * box with the lattice multigrid forced (FIREFOAM_TPU_GMG=1 / gmg=True)
    and with AMG forced (FIREFOAM_TPU_AMG=1 / amg=True), the exact solvers
    off on both sides as in tests/test_gmg.py;
  * box in float32 with the p_rgh solve in float64
    (FIREFOAM_TPU_P64_PRGH=1 / p_rgh_f64=True).

Tolerances (max-norm of the difference over the field's max-abs), float64:
initial_state 1e-12 (floors as in tests/test_torch_step.py); one step from
the same state and each step of a 5-step chain after 10 warm-up steps 1e-9
for T, U, p_rgh, Y, k and dt, with equal iteration counts for every logged
solve. float32 (p_rgh_f64): one step from the same developed state (after
10 and 12 steps) to 2e-5 (measured 7e-6 in U, 1e-6 in the others): the two
packages round float32 sums in different orders, and over the first steps U
(mm/s) and the p_rgh perturbation are themselves near the float32 noise, so
only the iteration counts are compared there. The p_rgh counts, which the
float64 solve sets, are equal on every step.
"""

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_torch.utils.synthcase import write_box_fire_case, write_smooth_fire_case
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy, state_to_numpy

torch.set_num_threads(1)
N = (8, 6, 7)
N_STEPS = 5
WARMUP = 10
FIELDS = ("T", "U", "p_rgh", "Y", "k", "dt")
ITERS = ("Ux_iters", "Uy_iters", "Uz_iters", "p_rgh_iters_0", "p_rgh_iters_1", "k_iters",
         "h_iters", "O2_iters", "C3H8_iters", "H2O_iters", "CO2_iters")

# name → (case writer, JAX environment, the port's arguments)
CONFIGS = {
    "box": (write_box_fire_case, {}, {}),
    "smooth": (write_smooth_fire_case, {}, {}),
    "box-gmg": (write_box_fire_case,
                {"FIREFOAM_TPU_GMG": "1", "FIREFOAM_TPU_EXACT_SOLVERS": "0"},
                {"gmg": True, "exact_solvers": False}),
    "box-amg": (write_box_fire_case,
                {"FIREFOAM_TPU_AMG": "1", "FIREFOAM_TPU_EXACT_SOLVERS": "0"},
                {"amg": True, "exact_solvers": False}),
}
_SOLVER_ENV = ("EXACT_SOLVERS", "AMG", "GMG", "GMG_COARSEST", "PALLAS", "P64_PRGH", "PAIRMG")


def _rel(a, b, floor=0.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), floor, 1e-300))


def _cells(x):
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


def _jax_env(mp, env, dtype="float64"):
    """Only `env` steers the JAX package's solver choice."""
    for k in _SOLVER_ENV:
        mp.delenv(f"FIREFOAM_TPU_{k}", raising=False)
    for k, v in env.items():
        mp.setenv(k, v)
    mp.setenv("FIREFOAM_TPU_DTYPE", dtype)


def _same_picks(js, ts):
    return ((js._ldu is None) == (ts._ldu is None) and (js.gmg is None) == (ts.gmg is None)
            and (js.amg is None) == (ts.amg is None))


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request, tmp_path_factory):
    """The JAX trajectory (computed once per configuration) and the port's
    solver on the same case."""
    write, env, kwargs = CONFIGS[request.param]
    root = write(str(tmp_path_factory.mktemp(request.param)), n=N)
    with pytest.MonkeyPatch.context() as mp:
        _jax_env(mp, env)
        js = JSolver(root)
        st = js.initial_state()
        step = js.make_step()
        states, logs = [jax.device_get(st)], []
        for _ in range(WARMUP + N_STEPS):
            st, log = step(st)
            states.append(jax.device_get(st))
            logs.append(jax.device_get(log))
    ts = TSolver(root, device="cpu", **kwargs)
    assert ts.dtype == torch.float64
    return request.param, js, ts, states, logs


def test_the_configuration_runs_the_solvers_it_names(run):
    name, js, ts, _, logs = run
    assert _same_picks(js, ts)
    if name in ("box", "smooth"):
        assert ts._ldu is not None and ts.gmg is None and ts.amg is None
    if name == "smooth":
        # symGaussSeidel counts sweeps one by one; the damped Jacobi of the
        # pinned tests counts in rounds of 4
        assert any(int(lg["h_iters"]) % 4 for lg in logs)
    if name == "box-gmg":
        assert ts._ldu is None and ts.gmg is not None and ts.amg is None
    if name == "box-amg":
        assert ts._ldu is None and ts.gmg is None and ts.amg is not None


def test_initial_state_matches(run):
    _, _, ts, states, _ = run
    ours = dict(_leaves(state_to_numpy(ts.initial_state())))
    ref = dict(_leaves(states[0]))
    assert set(ours) == set(ref)
    for name, b in ref.items():
        floor = 1e3 if name.startswith("hs.") else 1.0
        assert _rel(ours[name], b, floor=floor) <= 1e-12, name


def _check(ours, log, n, states, logs):
    for f in FIELDS:
        assert _rel(_cells(ours[f]), _cells(states[n + 1][f])) <= 1e-9, (n, f)
    for k in ITERS:
        assert int(log[k]) == int(logs[n][k]), (n, k, int(log[k]), int(logs[n][k]))


def test_one_step_from_the_same_state(run):
    _, _, ts, states, logs = run
    for n in (0, 1):
        ours, log = ts.make_step()(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
        _check(ours, log, n, states, logs)


def test_five_chained_steps(run):
    _, _, ts, states, logs = run
    st = state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    step = ts.make_step()
    for n in range(WARMUP, WARMUP + N_STEPS):
        st, log = step(st)
        _check(st, log, n, states, logs)


def test_p_rgh_in_float64_inside_a_float32_step(tmp_path):
    root = write_box_fire_case(str(tmp_path / "box"), n=N)
    with pytest.MonkeyPatch.context() as mp:
        _jax_env(mp, {"FIREFOAM_TPU_P64_PRGH": "1"}, dtype="float32")
        js = JSolver(root)
        st = js.initial_state()
        step = js.make_step()
        states, logs = [jax.device_get(st)], []
        for _ in range(13):
            st, log = step(st)
            states.append(jax.device_get(st))
            logs.append(jax.device_get(log))
    ts = TSolver(root, device="cpu", dtype=torch.float32, p_rgh_f64=True)
    assert _same_picks(js, ts) and ts._ldu is None
    for n in (0, 2, 10, 12):
        ours, log = ts.make_step()(state_from_numpy(states[n], device="cpu", dtype=torch.float32))
        assert ours["p_rgh"].i.dtype == torch.float32
        for f in FIELDS if n >= 10 else ():
            assert _rel(_cells(ours[f]), _cells(states[n + 1][f])) <= 2e-5, (n, f)
        for c in (0, 1):
            assert int(log[f"p_rgh_iters_{c}"]) == int(logs[n][f"p_rgh_iters_{c}"]), (n, c)
    # the float64 solve is not the float32 one: without it the solve stops
    # at the float32 floor of 100·eps and takes fewer iterations
    plain = TSolver(root, device="cpu", dtype=torch.float32)
    _, log32 = plain.make_step()(state_from_numpy(states[2], device="cpu", dtype=torch.float32))
    _, log64 = ts.make_step()(state_from_numpy(states[2], device="cpu", dtype=torch.float32))
    assert int(log32["p_rgh_iters_1"]) != int(log64["p_rgh_iters_1"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["box", "smooth", "gamg"])
def test_automatic_rule_picks_what_the_jax_constructor_picks(tmp_path, dtype, case):
    """Nothing pinned: schedule, lattice multigrid and AMG are set or None
    alike in both constructors ("gamg": the box fire with `solver GAMG` for
    p_rgh)."""
    write = write_smooth_fire_case if case == "smooth" else write_box_fire_case
    root = write(str(tmp_path / case), n=(6, 5, 4))
    if case == "gamg":
        path = f"{root}/system/fvSolution"
        with open(path) as f:
            text = f.read()
        assert "solver          PCG;" in text or "solver PCG;" in text
        with open(path, "w") as f:
            f.write(text.replace("solver          PCG;", "solver          GAMG;")
                    .replace("solver PCG;", "solver GAMG;"))
    with pytest.MonkeyPatch.context() as mp:
        _jax_env(mp, {}, dtype=dtype)
        js = JSolver(root)
    ts = TSolver(root, device="cpu", dtype=getattr(torch, dtype))
    assert _same_picks(js, ts), (js._ldu is None, js.gmg is None, js.amg is None,
                                 ts._ldu is None, ts.gmg is None, ts.amg is None)
    assert (ts._ldu is not None) == (dtype == "float64")
    assert ts.gmg is None  # a DIA mesh below the CPU's 50000 cells
    assert (ts.amg is not None) == (dtype == "float32" or case == "gamg")


def test_run_case_and_cli_pass_the_solver_choice_through(tmp_path, capsys):
    from firefoam_torch.models import run as trun

    root = write_box_fire_case(str(tmp_path / "box"), n=(6, 5, 4))
    solver, _, logs = trun.run_case(root, max_steps=1, verbose=False, device="cpu", gmg=True,
                                    gmg_coarsest=16, exact_solvers=False)
    assert solver.gmg is not None and solver.gmg.n_coarsest_max == 16 and solver._ldu is None
    assert solver.amg is None and len(logs) == 1
    solver, _, _ = trun.run_case(root, max_steps=1, verbose=False, device="cpu", amg=True,
                                 exact_solvers=False, p_rgh_f64=True)
    assert solver.amg is not None and solver.gmg is None and solver.p_rgh_f64
    flat = ["--exact-solvers", "0", "--gmg", "0", "--amg", "0"]
    counts = {}
    for name, flags in (("auto", []), ("flat", flat), ("gmg", ["--gmg", "1", "--exact-solvers", "0"])):
        assert trun.main(["--case", root, "--cpu", "--max-steps", "1"] + flags) == 0
        out = capsys.readouterr().out
        counts[name] = [int(ln.rsplit("iters", 1)[1]) for ln in out.splitlines()
                        if ln.startswith("p_rgh corrector")]
        assert len(counts[name]) == 2
    # DIC-PCG (auto in float64), the Jacobi-CG and the multigrid-CG differ
    assert counts["gmg"][1] < counts["auto"][1] < counts["flat"][1]
    with pytest.raises(SystemExit):
        trun.main(["--case", root, "--cpu", "--gmg", "yes"])
