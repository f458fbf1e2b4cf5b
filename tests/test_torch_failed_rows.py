"""Rows a BiCGStab solve leaves unsolved, and the fire step's count of them.

A row whose step is not finite (α, ω, t·s or t·t) stops and returns x0 and
its initial residual (firefoam_torch/solvers/linear.py:bicgstab; the JAX
solver returns NaN there). `linear.failed_rows` finds those rows, and the
fvDOM counts them over a step's ray sweeps: the step's log carries the count
as `rad_failedRows` (ROADMAP R18).
"""

import numpy as np

import jax.numpy as jnp
import torch

from firefoam_tpu.solvers import linear as jlinear
from firefoam_torch.models.firefoam import FireFoamSolver
from firefoam_torch.radiation import fvdom
from firefoam_torch.solvers import dia_krylov, linear
from firefoam_torch.solvers.linear import SolverResult
from firefoam_torch.utils.synthcase import write_radiation_fire_case

torch.set_num_threads(1)

# the 5-cell upwind chain x_c + l_{c-1}·x_{c-1} = b_c
LOWER = np.array([2.0, 1.0, -1.0, 1.0, 0.0])
PINS = dict(dtype=torch.float64, exact_solvers=False, gmg=False, amg=False)


def _chain_rows(dtype):
    """Three right-hand sides: one so large that r·r overflows float32, one
    that starts converged (b = A·x0), one ordinary."""
    n = LOWER.size
    A = np.eye(n)
    A[np.arange(1, n), np.arange(n - 1)] = LOWER[:-1]
    x0 = np.stack([np.zeros(n), np.linspace(1.0, 2.0, n), np.zeros(n)])
    b = np.stack([1e20 * np.array([1.0, 3.0, 3.0, 2.0, 0.1]), A @ x0[1],
                  np.array([1.0, 0.5, 0.25, -1.0, 2.0])])
    ops = (np.ones(n), np.zeros(n), LOWER, b, x0)
    return [torch.as_tensor(a, dtype=dtype) for a in ops]


def test_failed_rows_are_the_rows_the_jax_solver_leaves_nan():
    """float32: the overflowing row is failed (x0, res0 kept, above its
    stop); the converged row (0 iterations, res0 at its stop or below) and
    the ordinary row are not. The JAX solver's NaN rows are the same ones."""
    d, up, lo, b, x0 = _chain_rows(torch.float32)
    got = dia_krylov.dia_bicgstab(d, up, lo, b, x0, (1,), tol=1e-6, max_iter=50)
    failed = linear.failed_rows(got, 1e-6)
    assert failed.tolist() == [True, False, False]
    assert got.n_iterations.tolist()[1] == 0 and got.n_iterations.tolist()[2] > 0

    def jmv(v):
        return v + jnp.concatenate([jnp.zeros(1, jnp.float32),
                                    jnp.asarray(LOWER[:-1], jnp.float32) * v[:-1]])

    nan = [not np.all(np.isfinite(np.asarray(jlinear.bicgstab(
        jmv, jnp.asarray(x0[i].numpy()), jnp.asarray(b[i].numpy()), jnp.ones(5, jnp.float32),
        tol=1e-6, max_iter=50).x))) for i in range(3)]
    assert nan == failed.tolist()


def test_failed_rows_honours_the_relative_tolerance():
    """A row left at res0 is not failed when res0 is within its stop, which
    relTol sets: with relTol 1 every row stops at once."""
    d, up, lo, b, x0 = _chain_rows(torch.float64)
    got = dia_krylov.dia_bicgstab(d, up, lo, b, x0, (1,), tol=1e-12, rel_tol=1.0, max_iter=50)
    assert got.n_iterations.tolist() == [0, 0, 0]
    assert not bool(linear.failed_rows(got, 1e-12, rel_tol=1.0).any())


def _step_logs(tmp_path, n_steps):
    root = write_radiation_fire_case(str(tmp_path / "grey"), n=(6, 5, 6), model="greyMean")
    solver = FireFoamSolver(root, device="cpu", **PINS)
    state, logs, sweeps = solver.initial_state(), [], []
    for _ in range(n_steps):
        before = solver.radiation.sweeps
        state, log = solver.step(state)
        logs.append(log)
        sweeps.append(solver.radiation.sweeps - before)
    return logs, sweeps


def test_step_logs_no_failed_rows_on_a_solved_step(tmp_path):
    """The box fire with greyMean fvDOM on the CPU in float64: the first
    step solves the rays (some sweeps), the second does not; both log
    rad_failedRows, an int32 count, 0."""
    logs, sweeps = _step_logs(tmp_path, 2)
    assert sweeps[0] > 0 and sweeps[1] == 0
    for log in logs:
        assert log["rad_failedRows"].dtype == torch.int32
        assert int(log["rad_failedRows"]) == 0


def test_step_logs_the_rows_its_ray_sweeps_failed(tmp_path, monkeypatch):
    """Each ray solve's result with one row marked failed (final residual =
    initial residual above the tolerance): the step logs one failed row a
    sweep, and a step without a ray solve logs 0."""
    orig = fvdom.solve_ldu

    def one_failed(*a, **k):
        r = orig(*a, **k)
        res0 = r.initial_residual.clone()
        res0[0] = 1.0
        res = r.final_residual.clone()
        res[0] = 1.0
        return SolverResult(r.x, res0, res, r.n_iterations)

    monkeypatch.setattr(fvdom, "solve_ldu", one_failed)
    logs, sweeps = _step_logs(tmp_path, 2)
    assert sweeps[0] > 0
    assert [int(log["rad_failedRows"]) for log in logs] == [sweeps[0], 0]
