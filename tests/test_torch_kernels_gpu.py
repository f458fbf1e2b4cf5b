"""The port's hand-written CUDA kernels on the card (marker `gpu`).

These need a CUDA card and nvcc: the kernels have no CPU mode, so each test
skips itself where torch.cuda.is_available() is false. The file imports no
JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

* K1/K2/K3 against their plain PyTorch versions on the same operands
  (f64: equal iteration counts, x to 1e-9 relative; f32: K1/K2 counts
  within ±2, K3 sweeps within ±4 — one round of its residual check, where
  the f32 stagnation exit can fire a round apart — x to 1e-4 relative),
  with the launch counter checked.
* K1 on a system where BiCGStab breaks down (rhat·v = 0 in float64): it
  restarts as the twin does.
* One box-fire step on CUDA against the same step on the CPU in float64
  (the kernels against the CPU twins inside the real step), with the
  PBiCGStab and with the smoothSolver fvSolution.
"""

import numpy as np
import pytest
import torch

from firefoam_torch.models.firefoam import FireFoamSolver, state_from_numpy, state_to_numpy
from firefoam_torch.solvers import dia_krylov, linear
from firefoam_torch.utils.synthcase import write_box_fire_case, write_smooth_fire_case

pytestmark = pytest.mark.gpu

NXYZ = (12, 10, 8)
OFFS = (1, 12, 120)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _system(seed, B, sym, shared, dtype, dev):
    """B random diagonally dominant DIA systems on the lattice stencil;
    `shared`: one off-diagonal set for every row (the U solve's shape)."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = NXYZ
    n = nx * ny * nz
    c = np.arange(n)
    exists = [c % nx + 1 < nx, (c // nx) % ny + 1 < ny, c // (nx * ny) + 1 < nz]
    R = 1 if shared else B
    up = np.zeros((R, 3, n))
    lo = np.zeros((R, 3, n))
    for k in range(3):
        v = -(0.5 + rng.rand(R, n)) * exists[k]
        up[:, k] = v
        lo[:, k] = v if sym else v * (1.0 + 0.3 * rng.rand(R, n))
    d = 0.5 + 0.1 * rng.rand(B, n)
    for k, o in enumerate(OFFS):
        d[:, : n - o] -= up[:, k, : n - o]
        d[:, o:] -= lo[:, k, : n - o]
    up, lo = up.reshape(R, -1), lo.reshape(R, -1)
    if shared:
        up, lo = up[0], lo[0]
    arrs = (d, up, lo, rng.randn(B, n), 0.1 * rng.randn(B, n))
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrs]


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["pcg", "bicgstab", "smooth"])
def test_kernel_matches_plain_version(name, dtype, shared):
    _need_cuda()
    ops = _system(41, 4, name == "pcg", shared, dtype, torch.device("cuda"))
    before = dia_krylov.LAUNCHES[name]
    # K3's budget counts sweeps: 800 is the fire step's max(maxIter, 200)·4
    mx = 800 if name == "smooth" else 500
    got = getattr(dia_krylov, f"dia_{name}")(*ops, OFFS, tol=1e-8, max_iter=mx)
    torch.cuda.synchronize()
    assert dia_krylov.LAUNCHES[name] == before + 1
    if name == "smooth":
        ref = dia_krylov.plain_smooth(*ops, OFFS, tol=1e-8, max_iter=mx)
    else:
        ref = dia_krylov.plain(getattr(linear, name), *ops, OFFS, tol=1e-8, max_iter=mx)
    slack, xtol = (0, 1e-9) if dtype == torch.float64 else (4 if name == "smooth" else 2, 1e-4)
    its = (got.n_iterations.cpu().numpy(), ref.n_iterations.cpu().numpy())
    assert np.all(np.abs(its[0] - its[1]) <= slack), its
    rel = float((got.x - ref.x).abs().max() / ref.x.abs().max())
    assert rel <= xtol, rel


def test_bicgstab_kernel_restarts_on_breakdown():
    """A 5-cell upwind chain whose rhat·v is exactly 0 at BiCGStab's second
    step in float64: the kernel restarts as the twin does and solves it,
    with the same per-row counts (a second row never breaks down). In
    float32 rounding leaves rhat·v ≈ 1e-6 there instead of 0, which neither
    solver (nor the JAX one) treats as a breakdown, so float32 is no case
    of it."""
    _need_cuda()
    dev = torch.device("cuda")
    n = 5
    lower = np.array([2.0, 1.0, -1.0, 1.0, 0.0])
    b = np.array([[1.0, -2.0, 2.0, -1.0, 0.0], [1.0, 0.5, 0.25, -1.0, 2.0]])
    ops = [torch.as_tensor(a, dtype=torch.float64, device=dev)
           for a in (np.ones(n), np.zeros(n), lower, b, np.zeros((2, n)))]
    got = dia_krylov.dia_bicgstab(*ops, (1,), tol=1e-12, max_iter=50)
    ref = dia_krylov.plain(linear.bicgstab, *ops, (1,), tol=1e-12, max_iter=50)
    A = np.eye(n)
    A[np.arange(1, n), np.arange(n - 1)] = lower[:-1]
    x = np.linalg.solve(A, b.T).T
    assert bool(torch.isfinite(got.x).all())
    np.testing.assert_allclose(got.x.cpu().numpy(), x, rtol=0, atol=1e-12)
    assert got.n_iterations.tolist() == ref.n_iterations.tolist()


def test_kernel_rejects_bad_operands():
    _need_cuda()
    d, up, lo, b, x0 = _system(3, 2, True, False, torch.float32, torch.device("cuda"))
    with pytest.raises(TypeError):
        dia_krylov.dia_pcg(d.double(), up, lo, b, x0, OFFS)
    with pytest.raises(ValueError):
        dia_krylov.dia_pcg(d, up[:, :-1].contiguous(), lo, b, x0, OFFS)
    with pytest.raises(ValueError):
        dia_krylov.dia_pcg(d, up, lo, b, x0.t().contiguous().t(), OFFS)


@pytest.mark.parametrize("smooth", [False, True])
def test_box_fire_step_on_cuda_matches_cpu(tmp_path, smooth):
    """The main path on the card in float64: every solve goes through K1/K2
    and, with the smoothSolver fvSolution (and the run features), K3.
    The initial state (hydrostatic init: three PCG solves at relTol 0.01,
    whose reductions sum in another order on the card) matches the CPU's to
    1e-10, and one step (with its fvDOM solve) from the same state to 1e-9
    with equal iteration counts."""
    _need_cuda()
    write = write_smooth_fire_case if smooth else write_box_fire_case
    root = write(str(tmp_path / "box"), n=(8, 8, 8))
    cpu = FireFoamSolver(root, device="cpu", dtype=torch.float64)
    gpu = FireFoamSolver(root, device="cuda", dtype=torch.float64)
    st_c, st_g = cpu.initial_state(), gpu.initial_state()
    for f in ("p_rgh", "rho"):
        a, b = st_g[f].i.cpu().numpy(), st_c[f].i.numpy()
        rel = np.max(np.abs(a - b)) / np.max(np.abs(b))
        assert rel <= 1e-10, (f, rel)
    st_g = state_from_numpy(state_to_numpy(st_c), device="cuda", dtype=torch.float64)
    dia_krylov.reset_counts()
    st_c, log_c = cpu.step(st_c)
    st_g, log_g = gpu.step(st_g)
    torch.cuda.synchronize()
    assert dia_krylov.LAUNCHES["pcg"] == 2  # two p_rgh correctors
    # U and the fvDOM rays; Yi, h and k on K1 (PBiCGStab) or K3 (smoothSolver)
    assert dia_krylov.LAUNCHES["bicgstab"] == (2 if smooth else 5)
    assert dia_krylov.LAUNCHES["smooth"] == (3 if smooth else 0)
    for k in log_c:
        if k.endswith("_iters") or "iters_" in k:
            assert int(log_g[k]) == int(log_c[k]), (k, int(log_g[k]), int(log_c[k]))
    for f in ("T", "U", "p_rgh", "Y", "k"):
        a, b = st_g[f].i.cpu().numpy(), st_c[f].i.numpy()
        rel = np.max(np.abs(a - b)) / np.max(np.abs(b))
        assert rel <= 1e-9, (f, rel)


def test_step_is_reproducible_on_cuda(tmp_path):
    """Two float32 runs of the smoothSolver case from t = 0 (hydrostatic
    init, 5 steps with an fvDOM solve) give bitwise equal states: the
    boundary sums' index_add_ groups never collide, so the card's atomics
    add in a fixed order."""
    _need_cuda()
    root = write_smooth_fire_case(str(tmp_path / "box"), n=(8, 8, 8))
    solver = FireFoamSolver(root, device="cuda", dtype=torch.float32)
    runs = []
    for _ in range(2):
        st = solver.initial_state()
        st, _ = solver.make_chunk(5)(st)
        runs.append(state_to_numpy(st))
    for f in ("T", "U", "p_rgh", "Y", "k"):
        np.testing.assert_array_equal(runs[0][f].i, runs[1][f].i, err_msg=f)
