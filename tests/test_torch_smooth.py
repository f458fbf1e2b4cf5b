"""K3, the port's damped-Jacobi smoother (dia_smooth), and the smoothSolver
fire step, against the JAX package on CPU in float64.

* dia_smooth's CPU path (the plain twin) against the Pallas `_smooth_kernel`
  in interpret mode (one system: equal sweep counts, x to 1e-12) and
  against jax.vmap over firefoam_tpu/solvers/linear.py:jacobi_smooth
  (batches with shared and per-row matrices: equal per-row sweep counts, x
  to 1e-12), on the random DIA systems of tests/test_torch_dia_krylov.py.
* The box fire with fvSolution's "(Yi|h|k).*" entry on smoothSolver
  (write_smooth_fire_case): one step, and a 5-step chain after 10 warm-up
  steps, against the JAX step pinned to its flat solvers as in
  tests/test_torch_step.py. Fields to 1e-9 with equal h, k, species, U and
  p_rgh iteration counts.
The kernel itself is tested on the card in tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_tpu.solvers import linear as jlinear
from firefoam_tpu.solvers import pallas_cg
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy
from firefoam_torch.solvers import dia_krylov
from firefoam_torch.utils.synthcase import write_smooth_fire_case

from test_torch_dia_krylov import N, OFFS, _dia_system, _jmv, _t

torch.set_num_threads(1)

# callers pass max(maxIter, 200)·4 sweeps; 50 rounds keep these tests short
SWEEPS = 200


@pytest.mark.parametrize("x0_zero", [True, False])
def test_dia_smooth_matches_pallas(x0_zero):
    d, up, lo, b, x0 = _dia_system(seed=5, asym=0.2, shift=1.0)
    if x0_zero:
        x0 = np.zeros(N)
    pal = pallas_cg.dia_smooth(*(jnp.asarray(a) for a in (d, up, lo, b, x0)), OFFS, N,
                               tol=1e-10, max_iter=SWEEPS, interpret=True)
    got = dia_krylov.dia_smooth(*(_t(a) for a in (d, up, lo, b, x0)), OFFS,
                                tol=1e-10, max_iter=SWEEPS)
    assert int(got.n_iterations) == int(pal.n_iterations)
    assert int(got.n_iterations) % 4 == 0 and 0 < int(got.n_iterations) < SWEEPS
    np.testing.assert_allclose(got.x.numpy(), np.asarray(pal.x), rtol=0, atol=1e-12)
    assert np.isclose(float(got.initial_residual), float(pal.initial_residual), rtol=1e-12)
    assert float(got.final_residual) <= 1e-10


def test_dia_smooth_sweep_budget_matches_pallas():
    """A budget that is not a multiple of 4 sweeps: the kernel starts a
    round while it < max_iter, so 10 sweeps run 3 rounds (12 sweeps)."""
    d, up, lo, b, x0 = _dia_system(seed=6, asym=0.2, shift=0.1)
    pal = pallas_cg.dia_smooth(*(jnp.asarray(a) for a in (d, up, lo, b, x0)), OFFS, N,
                               tol=1e-12, max_iter=10, interpret=True)
    got = dia_krylov.dia_smooth(*(_t(a) for a in (d, up, lo, b, x0)), OFFS,
                                tol=1e-12, max_iter=10)
    assert int(got.n_iterations) == int(pal.n_iterations) == 12
    np.testing.assert_allclose(got.x.numpy(), np.asarray(pal.x), rtol=0, atol=1e-12)


@pytest.mark.parametrize("shared", [True, False])
def test_dia_smooth_matches_vmapped_jacobi_smooth(shared):
    """A batch: each row freezes at its own stop (jax.vmap semantics) and
    keeps its own sweep count; relTol makes the rows stop apart."""
    d, up, lo, b, x0 = _dia_system(seed=21, asym=0.3, rows=4, shift=0.5)
    b = b * np.array([1.0, 1e2, 1e-2, 3.0])[:, None]
    if shared:
        up, lo = up[0], lo[0]
        d = d[0][None] * (1.0 + 0.05 * np.arange(4))[:, None]

    def one(dd, uu, ll, bb, xx):
        return jlinear.jacobi_smooth(_jmv(dd, uu, ll), xx, bb, dd, tol=1e-9, rel_tol=1e-3,
                                     max_iter=SWEEPS // 4)

    axes = (0, None if shared else 0, None if shared else 0, 0, 0)
    ref = jax.vmap(one, in_axes=axes)(*(jnp.asarray(a) for a in (d, up, lo, b, x0)))
    got = dia_krylov.dia_smooth(*(_t(a) for a in (d, up, lo, b, x0)), OFFS,
                                tol=1e-9, rel_tol=1e-3, max_iter=SWEEPS)
    assert got.n_iterations.tolist() == np.asarray(ref.n_iterations).tolist()
    assert len(set(got.n_iterations.tolist())) > 1
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.final_residual.numpy(), np.asarray(ref.final_residual),
                               rtol=1e-10)


def test_dia_smooth_stagnation_exit():
    """Tolerance below the f64 roundoff floor: the solve stops where a round
    fails to drop the residual by 1e-4, before the sweep budget, as the JAX
    smoother does."""
    d, up, lo, b, x0 = _dia_system(seed=8, asym=0.1, shift=1.0)
    ref = jlinear.jacobi_smooth(_jmv(*(jnp.asarray(a) for a in (d, up, lo))), jnp.asarray(x0),
                                jnp.asarray(b), jnp.asarray(d), tol=1e-300, max_iter=2000)
    got = dia_krylov.dia_smooth(*(_t(a) for a in (d, up, lo, b, x0)), OFFS,
                                tol=1e-300, max_iter=8000)
    assert int(got.n_iterations) == int(ref.n_iterations) < 8000
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-12)


# ------------------------------------------------------- the fire step
N_STEPS = 5
WARMUP = 10
FIELDS = ("T", "U", "p_rgh", "Y", "k", "dt")
ITERS = ("Ux_iters", "Uy_iters", "Uz_iters", "p_rgh_iters_0", "p_rgh_iters_1", "k_iters",
         "h_iters", "O2_iters", "C3H8_iters", "H2O_iters", "CO2_iters")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _cells(x):
    x = getattr(x, "i", x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX reference trajectory on the smoothSolver box fire, and the
    port's solver on the same case."""
    root = write_smooth_fire_case(str(tmp_path_factory.mktemp("smooth")), n=(6, 6, 6))
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
    # the port pinned alike: K3's twin, not the symGaussSeidel of the schedule
    ts = TSolver(root, device="cpu", dtype=torch.float64, exact_solvers=False, gmg=False,
                 amg=False)
    return ts, states, logs


def _check_step(ours, log, n, states, logs):
    for f in FIELDS:
        assert _rel(_cells(ours[f]), _cells(states[n + 1][f])) <= 1e-9, (n, f)
    for k in ITERS:
        assert int(log[k]) == int(logs[n][k]), (n, k, int(log[k]), int(logs[n][k]))
    # the run features: function-object reductions, RTI probe and link states
    fo = {k for k in logs[n] if k.startswith("fo_")}
    assert len(fo) == 6 and {k for k in log if k.startswith("fo_")} == fo
    for k in fo:
        assert _rel(log[k].numpy(), logs[n][k]) <= 1e-9, (n, k)
    for sub in ("rtis", "rti_links"):
        for k, v in states[n + 1][sub].items():
            assert _rel(ours[sub][k].numpy(), v) <= 1e-9, (n, sub, k)


def test_smooth_solver_step(run):
    ts, states, logs = run
    assert int(logs[0]["h_iters"]) % 4 == 0 and int(logs[0]["h_iters"]) > 0
    ours, log = ts.make_step()(state_from_numpy(states[0], device="cpu", dtype=torch.float64))
    _check_step(ours, log, 0, states, logs)


def test_smooth_solver_chain(run):
    ts, states, logs = run
    st = state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    step = ts.make_step()
    for n in range(WARMUP, WARMUP + N_STEPS):
        st, log = step(st)
        _check_step(st, log, n, states, logs)
