"""The gas-phase slice end to end: the port's FireFoamSolver on the box fire
(write_box_fire_case, n=(6,6,6)) against the JAX package's, on CPU in
float64, through the normal entry points (initial_state, make_step,
make_chunk). Radiation is on, so step 1 runs the fvDOM ray solve.

Both sides are pinned to the flat Krylov solvers (the twins of the kernels
K1 and K2), which this file is about: on the JAX side
FIREFOAM_TPU_EXACT_SOLVERS=0 (no wavefront DIC-PCG), FIREFOAM_TPU_AMG=0
(AMG is otherwise switched on because the DIC schedule is off),
FIREFOAM_TPU_GMG=0 and FIREFOAM_TPU_PALLAS=0; on the port's side
exact_solvers=False, gmg=False, amg=False. tests/test_torch_step_default.py
holds the two packages against each other with nothing pinned.

Tolerances (max-norm of the difference over the field's max-abs):
  * initial_state, hydrostatic init included: 1e-12 (denominator floored
    at 1.0, and for hs at 1e3 J/kg ≈ cp·1 K: hs is roundoff around 0 at
    T_std);
  * each of the first 5 steps, from the same state: 1e-9 for T, U, p_rgh,
    Y, k and dt, with equal per-step iteration counts;
  * 5 chained steps from the same state after 10 warm-up steps (the first
    of them runs the fvDOM ray solve): the same 1e-9 and equal counts.
The chain starts after the warm-up because the start-up window amplifies
roundoff in the reference itself: a 1e-13 relative perturbation of its own
initial p_rgh grows to ~2e-9 in U within 5 steps (measured), as boundary
fluxes near zero switch the inletOutlet conditions. From step 10 on, the
two packages' last-bit differences stay near 1e-13 over the chain.
"""

import subprocess
import sys
import os

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_tpu.utils.synthcase import write_box_fire_case
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy, state_to_numpy

torch.set_num_threads(1)
N_STEPS = 5
WARMUP = 10
FIELDS = ("T", "U", "p_rgh", "Y", "k", "dt")
ITERS = ("Ux_iters", "Uy_iters", "Uz_iters", "p_rgh_iters_0", "p_rgh_iters_1", "k_iters",
         "h_iters", "O2_iters", "C3H8_iters", "H2O_iters", "CO2_iters")


def _rel(a, b, floor=0.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), floor, 1e-300))


def _cells(x):
    x = getattr(x, "i", x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX reference trajectory (computed once) and the port's solver."""
    root = str(tmp_path_factory.mktemp("box"))
    write_box_fire_case(root, n=(6, 6, 6))
    with pytest.MonkeyPatch.context() as mp:
        for k in ("EXACT_SOLVERS", "AMG", "GMG", "PALLAS"):
            mp.setenv(f"FIREFOAM_TPU_{k}", "0")
        mp.setenv("FIREFOAM_TPU_DTYPE", "float64")
        js = JSolver(root)
        assert js._ldu is None and js.amg is None and js.gmg is None
        st = js.initial_state()
        step = js.make_step()
        states, logs = [jax.device_get(st)], []
        for _ in range(WARMUP + N_STEPS):
            st, log = step(st)
            states.append(jax.device_get(st))
            logs.append(jax.device_get(log))
    ts = TSolver(root, device="cpu", dtype=torch.float64, exact_solvers=False, gmg=False,
                 amg=False)
    assert ts._ldu is None and ts.amg is None and ts.gmg is None
    return ts, states, logs


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif isinstance(v, tuple):
            yield f"{prefix}{k}.i", v.i
            yield f"{prefix}{k}.b", v.b
        else:
            yield prefix + k, v


def test_initial_state_matches(run):
    ts, states, _ = run
    ours = dict(_leaves(state_to_numpy(ts.initial_state())))
    ref = dict(_leaves(states[0]))
    assert set(ours) == set(ref)
    for name, b in ref.items():
        floor = 1e3 if name.startswith("hs.") else 1.0
        assert _rel(ours[name], b, floor=floor) <= 1e-12, name


def test_state_round_trip(run):
    _, states, _ = run
    st = state_from_numpy(states[1], device="cpu", dtype=torch.float64)
    back = dict(_leaves(state_to_numpy(st)))
    for name, b in _leaves(states[1]):
        np.testing.assert_array_equal(back[name], np.asarray(b), err_msg=name)
    assert st["rad"]["count"].dtype == torch.int32


def test_each_step_from_the_same_state(run):
    ts, states, logs = run
    step = ts.make_step()
    for n in range(N_STEPS):
        ours, log = step(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
        for f in FIELDS:
            assert _rel(_cells(ours[f]), _cells(states[n + 1][f])) <= 1e-9, (n, f)
        for k in ITERS:
            assert int(log[k]) == int(logs[n][k]), (n, k)
        if n == 0:
            # radiation on: fvDOM solved its 16 rays on the first step
            assert int(ours["rad"]["count"]) == 1
            assert float(ours["rad"]["G"].abs().max()) > 0.0


def test_five_chained_steps(run):
    ts, states, logs = run
    start = state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    # the first chained step is a radiation step (solverFreq 10)
    assert int(start["rad"]["count"]) % 10 == 0
    step = ts.make_step()
    st = start
    for n in range(WARMUP, WARMUP + N_STEPS):
        st, log = step(st)
        for f in FIELDS:
            assert _rel(_cells(st[f]), _cells(states[n + 1][f])) <= 1e-9, (n, f)
        for k in ITERS:
            assert int(log[k]) == int(logs[n][k]), (n, k)
        assert _rel(st["rad"]["G"].numpy(), states[n + 1]["rad"]["G"]) <= 1e-9
    # make_chunk is the same n steps, with every step's log stacked
    state, chunk_logs = ts.make_chunk(N_STEPS)(
        state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    )
    for f in FIELDS:
        np.testing.assert_array_equal(_cells(state[f]), _cells(st[f]))
    for n in range(N_STEPS):
        for k in ITERS:
            assert int(chunk_logs[k][n]) == int(logs[WARMUP + n][k]), (n, k)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports neither JAX nor
    the JAX package."""
    code = (
        "import importlib, pkgutil, sys, firefoam_torch; "
        "mods = [m.name for m in pkgutil.walk_packages(firefoam_torch.__path__, 'firefoam_torch.')]; "
        "assert len(mods) >= 88 and 'firefoam_torch.parallel.spmd_step' in mods, mods; "
        "[importlib.import_module(m) for m in mods]; "
        "import chip_smoke; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert not any(m.startswith('firefoam_tpu') for m in sys.modules), 'firefoam_tpu imported'"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_names_no_jax_module_in_a_string():
    """No string of the port's sources or chip_smoke.py other than a
    docstring names a module of the JAX package: a module path imported at
    run time (`__import__("firefoam_tpu.parallel.partition")`) escapes the
    import walk above. File paths ("firefoam_tpu/...:line", the kernels'
    `replaces` entries) are not module names."""
    import ast
    import re

    module = re.compile(r"\bfirefoam_tpu(\.|$)")

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for dp, _, names in os.walk(os.path.join(root, "firefoam_torch")):
        files += [os.path.join(dp, f) for f in names if f.endswith(".py")]
    assert len(files) > 88
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        docs = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
                body = node.body
                if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                    docs.add(id(body[0].value))
        bad += [(path, n.lineno) for n in ast.walk(tree)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
                and id(n) not in docs and module.search(n.value)]
    assert not bad, bad
