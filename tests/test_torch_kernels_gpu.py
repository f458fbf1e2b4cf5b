"""The port's hand-written CUDA kernels on the card (marker `gpu`).

These need a CUDA card and nvcc: the kernels have no CPU mode, so each test
skips itself where torch.cuda.is_available() is false. The file imports no
JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q

* K1/K2/K3 against their plain PyTorch versions on the same operands
  (f64: equal iteration counts, x to 1e-9 relative; f32: K1/K2 counts
  within ±2, K3 sweeps within ±4 — one round of its residual check, where
  the f32 stagnation exit can fire a round apart — x to 1e-4 relative),
  with the launch counter checked: on a 960-cell lattice (one block a row),
  at 9k and 100k cells (grid-wide over many blocks a row) and with
  more rows than the card has blocks (the one-block-per-row kernels).
* The grid-wide K1/K2/K3: rows that stop at different iterations,
  max_iter = 0, an x0 that has converged already, two launches of one solve
  giving bit-equal x and equal counts, and slices streamed from L2 against
  slices resident in shared memory.
* K3 grid-wide against K3 one block per row, for a fixed number of sweeps:
  bit-equal x (a Jacobi sweep computes a cell with the same expression
  whichever thread owns it).
* K1 on a system where BiCGStab breaks down (rhat·v = 0 in float64): it
  restarts as the twin does.
* One box-fire step on CUDA against the same step on the CPU in float64
  (the kernels against the CPU twins inside the real step), with the
  PBiCGStab and with the smoothSolver fvSolution.
* The p_rgh solver family (gmg_pcg, amg_pcg, dic_pcg, sgs_solve: plain
  PyTorch ops) on the card against the CPU run of the same function, two
  solves on the card bitwise equal, and three steps of the fire with each of
  them on against the CPU's.
* K1 at the banded fvDOM's shapes, 128 and 160 rows of 100k cells with a
  matrix each (the many-rows kernel), against its plain version; the
  banded (ray × band) ray solve, P1's G solve and one step of each
  radiation case (write_radiation_fire_case) on the card in float64
  against the CPU.
* K1's many-rows kernel (`bicgstab_rows_kernel`) against its plain version
  in float64 and float32, with shared and per-row operands, at 16, 128 and
  160 rows of 100k cells and 200 rows of 9k: rows that stop far apart
  (0 to some 18 iterations), the restart on a breakdown, two launches bit
  equal, its reduction and walk options bit equal, and the rule's layout.
* Each K1 kernel on a float32 row whose step overflows: it fails that row
  (x0 and its initial residual), as the plain version does.
* The SEG layout (castellated meshes, no kernel): its face→cell sums
  bitwise repeatable on the card, its matvec within 1e-12 of the CPU's in
  float64, and three castellated steps on the card against the CPU.
* K1/K2/K3 at 9, 12 and 16 offsets (the DIA layout's cap; the hybrid
  layout's lanes reach them) and at 17, 34 and 64 (the banded layout's)
  against their plain versions in float32 and float64 (K1 on one row, 3
  shared rows and 6 per-row rows: its grid-wide and many-rows kernels),
  the launcher's refusal of a 65th offset, the banded layout's sums
  bitwise repeatable on the card, and one step of the banded castellated
  column (34 offsets) on the card against the CPU's.
* The hybrid layout (no kernel): its face→cell sums and its product
  bitwise repeatable on the card, and one castellated step on the card
  with PairMG on p_rgh against the CPU's.
* K1 (B = 1, 3) and K2 above 3 offsets (the split kernels: the window, the
  residency split, the unrolled stencil) at 12, 34 and 62 offsets on 100k
  cells in float32 and float64: bitwise the window=0 path's x, residuals
  and counts, and the plain version's within the tolerances above; the
  shaft's 800-cell blocks at 34 offsets keeping most slices resident; the
  far offsets of OFFS_12 read from L2 (bitwise a window serving all of
  them); the 64-offset maximum.
* K3 above 3 offsets (its split kernel: the window of the iterate, the
  residency split, the unrolled stencil) at 12, 34 and 62 offsets on 100k
  cells, one row and the Yi batch's 4 rows, float32 and float64: bitwise its
  window=0 and all-streamed runs, the plain version's within the
  tolerances above (float64: equal sweep counts); and at a fixed number of
  sweeps on the shaft's blocks bitwise the one-block-per-row kernel's x.
* K1's many-rows kernel above 8 offsets (a window of the exchanged vector
  per warp, the unrolled stencil) at 9, 12, 16, 17, 34, 62 and 64 offsets,
  float32 and float64, shared and per-row operators, 5, 16 and 128 rows of
  20k cells: bitwise its window=0 run, the plain version's within the
  tolerances above; at 34 offsets a float32 row whose step overflows fails
  to x0 and is counted by linear.failed_rows (R18).
"""

import types

import numpy as np
import pytest
import torch

from firefoam_torch.models.firefoam import FireFoamSolver, state_from_numpy, state_to_numpy
from firefoam_torch.solvers import dia_krylov, linear
from firefoam_torch.utils.synthcase import (RADIATION_MODELS, write_box_fire_case,
                                             write_radiation_fire_case, write_smooth_fire_case,
                                             write_wall_fire_case)

pytestmark = pytest.mark.gpu

NXYZ = (12, 10, 8)
OFFS = (1, 12, 120)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


# (lattice, rows): one block a row; grid-wide at 9k cells (B = 1 and a
# batch) and at 100k cells; more rows than blocks
SHAPES = {
    "960x4": (NXYZ, 4),
    "9k": ((30, 15, 20), 1),
    "9kx3": ((30, 15, 20), 3),
    "100k": ((50, 40, 50), 1),
    "100kx5": ((50, 40, 50), 5),  # the Yi batch with an Fstar specie
    "960x150": (NXYZ, 150),
}


def _offs(nxyz):
    return (1, nxyz[0], nxyz[0] * nxyz[1])


def _system(seed, B, sym, shared, dtype, dev, nxyz=NXYZ, shift=0.5):
    """B random diagonally dominant DIA systems on the lattice stencil;
    `shared`: one off-diagonal set for every row (the U solve's shape);
    `shift`: the least excess of the diagonal over its row's off-diagonals."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = nxyz
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
    d = shift + 0.1 * rng.rand(B, n)
    for k, o in enumerate(_offs(nxyz)):
        d[:, : n - o] -= up[:, k, : n - o]
        d[:, o:] -= lo[:, k, : n - o]
    up, lo = up.reshape(R, -1), lo.reshape(R, -1)
    if shared:
        up, lo = up[0], lo[0]
    arrs = (d, up, lo, rng.randn(B, n), 0.1 * rng.randn(B, n))
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrs]


NAMES = ["pcg", "bicgstab", "smooth"]


def _plain(name, *ops, **kw):
    if name == "smooth":
        return dia_krylov.plain_smooth(*ops, **kw)
    return dia_krylov.plain(getattr(linear, name), *ops, **kw)


def _tolerances(name, dtype):
    """(iteration slack, x relative): f64 equal counts; f32 K1/K2 within 2
    iterations, K3 within one round of 4 sweeps."""
    if dtype == torch.float64:
        return 0, 1e-9
    return (4 if name == "smooth" else 2), 1e-4


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["pcg", "bicgstab", "smooth"])
def test_kernel_matches_plain_version(name, dtype, shared, shape):
    _need_cuda()
    nxyz, B = SHAPES[shape]
    offs = _offs(nxyz)
    # the shapes added with the grid-wide kernels are better conditioned: with
    # more cells and more rows, two BiCGStab runs that differ in the order of
    # their sums stay within the tolerances below only on such systems
    shift = 0.5 if shape == "960x4" else 1.0
    ops = _system(41, B, name == "pcg", shared, dtype, torch.device("cuda"), nxyz, shift)
    before = dia_krylov.LAUNCHES[name]
    # K3's budget counts sweeps: 800 is the fire step's max(maxIter, 200)·4
    mx = 800 if name == "smooth" else 500
    got = getattr(dia_krylov, f"dia_{name}")(*ops, offs, tol=1e-8, max_iter=mx)
    torch.cuda.synchronize()
    assert dia_krylov.LAUNCHES[name] == before + 1
    ref = _plain(name, *ops, offs, tol=1e-8, max_iter=mx)
    slack, xtol = _tolerances(name, dtype)
    its = (got.n_iterations.cpu().numpy(), ref.n_iterations.cpu().numpy())
    assert np.all(np.abs(its[0] - its[1]) <= slack), its
    rel = float((got.x - ref.x).abs().max() / ref.x.abs().max())
    assert rel <= xtol, rel


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", NAMES)
def test_grid_rows_stop_at_their_own_iteration(name, dtype):
    """relTol and right-hand sides of very different size make the rows of
    one grid-wide launch stop at different iterations: every row keeps its
    own count and its x, as the plain version's rows do."""
    _need_cuda()
    nxyz = (30, 15, 20)
    d, up, lo, b, x0 = _system(43, 4, name == "pcg", False, dtype, torch.device("cuda"), nxyz, 1.0)
    b = (b * torch.tensor([1.0, 1e3, 1e-3, 30.0], dtype=dtype, device=b.device)[:, None])
    b = b.contiguous()
    kw = dict(tol=1e-6, rel_tol=0.05, max_iter=300)
    if name == "smooth":
        # Jacobi's rate follows the diagonal's dominance: rows with a heavier
        # diagonal reach one absolute tolerance rounds sooner (44, 36, 20 and
        # 12 sweeps in the plain version)
        d = d + torch.tensor([0.0, 0.5, 2.0, 8.0], dtype=dtype, device=d.device)[:, None]
        kw = dict(tol=1e-4, rel_tol=0.0, max_iter=800)
    got = getattr(dia_krylov, f"dia_{name}")(d, up, lo, b, x0, _offs(nxyz), **kw)
    ref = _plain(name, d, up, lo, b, x0, _offs(nxyz), **kw)
    its = (got.n_iterations.cpu().numpy(), ref.n_iterations.cpu().numpy())
    assert len(set(its[1].tolist())) > (3 if name == "smooth" else 1), its
    slack, xtol = _tolerances(name, dtype)
    assert np.all(np.abs(its[0] - its[1]) <= slack), its
    rel = (got.x - ref.x).abs().amax(dim=1) / ref.x.abs().amax(dim=1)
    assert float(rel.max()) <= xtol, rel


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", NAMES)
def test_grid_kernel_leaves_x0_when_there_is_nothing_to_do(name, dtype):
    """max_iter = 0, and an x0 that meets the tolerance already (the
    solution of a first solve): 0 iterations and x = x0 bitwise."""
    _need_cuda()
    nxyz = (30, 15, 20)
    d, up, lo, b, x0 = _system(47, 2, name == "pcg", False, dtype, torch.device("cuda"), nxyz, 1.0)
    fn = getattr(dia_krylov, f"dia_{name}")
    none = fn(d, up, lo, b, x0, _offs(nxyz), tol=1e-8, max_iter=0)
    assert none.n_iterations.tolist() == [0, 0]
    assert torch.equal(none.x, x0)
    assert torch.equal(none.final_residual, none.initial_residual)
    first = fn(d, up, lo, b, x0, _offs(nxyz), tol=1e-6, max_iter=800)
    assert min(first.n_iterations.tolist()) > 0
    again = fn(d, up, lo, b, first.x, _offs(nxyz), tol=1e-3, max_iter=800)
    assert again.n_iterations.tolist() == [0, 0]
    assert torch.equal(again.x, first.x)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", NAMES)
def test_grid_kernel_is_bit_reproducible(name, dtype):
    """Two launches of one solve: bit-equal x and residuals, equal counts
    (the partial sums of a row's blocks are added in a fixed order)."""
    _need_cuda()
    nxyz = (50, 40, 50)
    ops = _system(53, 3, name == "pcg", True, dtype, torch.device("cuda"), nxyz, 1.0)
    fn = getattr(dia_krylov, f"dia_{name}")
    a = fn(*ops, _offs(nxyz), tol=1e-8, max_iter=500)
    b = fn(*ops, _offs(nxyz), tol=1e-8, max_iter=500)
    assert a.n_iterations.tolist() == b.n_iterations.tolist()
    assert torch.equal(a.x, b.x)
    assert torch.equal(a.final_residual, b.final_residual)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", NAMES)
def test_streamed_slices_equal_resident_ones(name, dtype):
    """A block's slices kept in shared memory or streamed from L2 (what a
    launch whose slices do not fit does): the same plan and the same
    arithmetic, so bit-equal results."""
    _need_cuda()
    nxyz = (30, 15, 20)
    ops = _system(59, 3, name == "pcg", False, dtype, torch.device("cuda"), nxyz, 1.0)
    plan, split = dia_krylov._grid_launch_plan(name, dtype, 3, 9000, _offs(nxyz),
                                               ops[0].element_size())
    assert plan.grid_wide and split.bytes > 0
    extra = (0.8, 4) if name == "smooth" else ()
    a, b = (dia_krylov._launch(name, *ops, _offs(nxyz), 1e-8, 0.0, 500, extra=extra,
                               resident=res) for res in (True, False))
    assert min(a.n_iterations.tolist()) > 0
    assert a.n_iterations.tolist() == b.n_iterations.tolist()
    assert torch.equal(a.x, b.x)
    assert torch.equal(a.final_residual, b.final_residual)


@pytest.mark.parametrize("sweeps", [40, 3])
@pytest.mark.parametrize("shape", ["9kx3", "100k", "100kx4"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_smooth_grid_kernel_equals_one_block_per_row_bitwise(dtype, shape, sweeps):
    """The same number of sweeps (tol 0 leaves only the 100·eps floor, far
    below what 40 sweeps reach, and the residual still drops by a tenth a
    sweep, so neither the stop nor the stagnation exit cuts the budget
    short; a budget of 3 runs one round of 4) through both K3 kernels: the
    same x bitwise, resident or streamed. The residuals may differ in the
    last bits: their sums are added in another order."""
    _need_cuda()
    nxyz, B = {**SHAPES, "100kx4": ((50, 40, 50), 4)}[shape]
    ops = _system(61, B, False, False, dtype, torch.device("cuda"), nxyz, 1.0)
    runs = [dia_krylov._launch("smooth", *ops, _offs(nxyz), 0.0, 0.0, sweeps, extra=(0.8, 4),
                               **kw)
            for kw in (dict(), dict(resident=False), dict(grid_wide=False))]
    done = -(-sweeps // 4) * 4
    for r in runs:
        assert r.n_iterations.tolist() == [done] * B
    assert torch.equal(runs[0].x, runs[2].x)
    assert torch.equal(runs[1].x, runs[2].x)
    rel = (runs[0].final_residual - runs[2].final_residual).abs() / runs[2].final_residual
    assert float(rel.max()) <= 1e3 * torch.finfo(dtype).eps


def test_launch_picks_the_kernel_by_rows_and_blocks():
    """B <= G: grid-wide (a plan of several blocks a row at 9k cells);
    B > G: one block per row. G comes from the occupancy query."""
    _need_cuda()
    G, max_smem = dia_krylov._coop_blocks("pcg", torch.float32, 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert G >= sms and G % sms == 0 and max_smem > 48 * 1024
    lattice = (1, 30, 450)
    plan, split = dia_krylov._grid_launch_plan("pcg", torch.float32, 1, 9000, lattice, 4)
    assert plan.grid_wide and plan.blocks_per_row > 1 and split.bytes > 0
    plan, split = dia_krylov._grid_launch_plan("pcg", torch.float32, G + 1, 9000, lattice, 4)
    assert not plan.grid_wide and split.bytes == 0
    assert dia_krylov.grid_sync_seconds(G, 200) > 0.0
    # K3 keeps fewer vectors resident, so at one plan it asks for less
    assert dia_krylov._coop_blocks("smooth", torch.float32, 0)[0] == G
    for B in (1, 4):
        plan3, split3 = dia_krylov._grid_launch_plan("smooth", torch.float32, B, 100_000,
                                                     (1, 50, 2000), 4)
        plan2, split2 = dia_krylov._grid_launch_plan("pcg", torch.float32, B, 100_000,
                                                     (1, 50, 2000), 4)
        assert plan3 == plan2 and plan3.grid_wide
        assert 0 < split3.bytes == split2.bytes * 9 // 11
    plan, split = dia_krylov._grid_launch_plan("smooth", torch.float64, G + 1, 9000, lattice, 8)
    assert not plan.grid_wide and split.bytes == 0


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
    # K1 and K2 in float64: not the exact solvers that float64 picks by itself
    cpu = FireFoamSolver(root, device="cpu", dtype=torch.float64, exact_solvers=False, amg=False)
    gpu = FireFoamSolver(root, device="cuda", dtype=torch.float64, exact_solvers=False)
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


@pytest.mark.parametrize("baffle", [False, True])
def test_wall_fire_step_on_cuda_matches_cpu(tmp_path, baffle):
    """The wall-fire case (non-orthogonal correction, filteredLinear2V,
    WALE, BertExt with Fstar, the wall functions; with the ceiling baffle)
    on the card in float64 through K1/K2 against the CPU twins: one step
    from the same state to 1e-9 with equal iteration counts, the species
    batch a K1 launch of 5 rows."""
    _need_cuda()
    root = write_wall_fire_case(str(tmp_path / "wall"), n=(10, 8, 10), baffle=baffle)
    cpu = FireFoamSolver(root, device="cpu", dtype=torch.float64, exact_solvers=False, amg=False)
    gpu = FireFoamSolver(root, device="cuda", dtype=torch.float64, exact_solvers=False)
    st_c, _ = cpu.make_chunk(12)(cpu.initial_state())
    st_g = state_from_numpy(state_to_numpy(st_c), device="cuda", dtype=torch.float64)
    dia_krylov.reset_counts()
    st_c, log_c = cpu.step(st_c)
    st_g, log_g = gpu.step(st_g)
    torch.cuda.synchronize()
    assert dia_krylov.LAUNCHES["pcg"] == 2 and dia_krylov.LAUNCHES["bicgstab"] >= 4
    for k in log_c:
        if k.endswith("_iters") or "iters_" in k:
            assert int(log_g[k]) == int(log_c[k]), (k, int(log_g[k]), int(log_c[k]))
    for f in ("T", "U", "p_rgh", "Y", "k", "nut", "alphat"):
        a, b = st_g[f].b.cpu().numpy(), st_c[f].b.numpy()
        assert np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300) <= 1e-9, (f, "b")
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


# ------------------------------------------------------------------------
# The p_rgh solver family (plain PyTorch ops: no kernel of their own) on the
# card against the CPU run of the same function, and twice on the card
# ------------------------------------------------------------------------
FAMILY = ["gmg_pcg", "amg_pcg", "dic_pcg", "sgs_solve"]
FAMILY_LATTICE = (15, 9, 7)  # odd extents: the multigrid pads every level


def _family_solve(name, dtype, dev):
    """One solve of `name` on a symmetric (sgs_solve: asymmetric) lattice
    system, everything on `dev`."""
    from firefoam_torch.solvers import amg, dic, gmg

    nxyz = FAMILY_LATTICE
    offs, n = _offs(nxyz), int(np.prod(nxyz))
    d, up, lo, b, x0 = (a[0] if a.ndim == 2 else a for a in _system(
        11, 1, name != "sgs_solve", True, dtype, dev, nxyz=nxyz,
        shift=3.0 if name == "sgs_solve" else 0.05))
    tol = 1e-9 if dtype == torch.float64 else 1e-6
    if name == "gmg_pcg":
        return gmg.gmg_pcg(gmg.LatticeMG.build(offs, n), d, lo, up, b, x0, tol=tol)
    c = np.arange(n)
    own, nei = np.tile(c, 3), np.concatenate([np.where(  # the port's padded DIA face layout
        e, c + o, c) for o, e in zip(offs, (c % nxyz[0] + 1 < nxyz[0],
                                            (c // nxyz[0]) % nxyz[1] + 1 < nxyz[1],
                                            c // (nxyz[0] * nxyz[1]) + 1 < nxyz[2]))])
    if name == "amg_pcg":
        hier = amg.AMGHierarchy.build(own, nei, (own != nei).astype(float), n, device=dev)
        return amg.amg_pcg(hier, d, lo, up, b, x0, tol=tol)
    real = own != nei
    sch = dic.build_schedule(own[real], nei[real], n, perm=np.nonzero(real)[0])
    mv = lambda v: dia_krylov.dia_matvec(d, up, lo, offs, v)
    if name == "dic_pcg":
        return dic.dic_pcg(sch, mv, d, up, b, x0, tol=tol)
    return dic.sgs_solve(sch, mv, d, lo, up, b, x0, tol=tol, max_iter=200, n_sweeps=2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", FAMILY)
def test_solver_family_on_cuda_matches_cpu(name, dtype):
    """float64: x to 1e-9 relative and equal iteration counts; float32: x to
    1e-3 relative (both stop on a float32 residual) and counts within 2
    (sgs_solve: within one round of 2 sweeps more)."""
    _need_cuda()
    gpu, cpu = _family_solve(name, dtype, "cuda"), _family_solve(name, dtype, "cpu")
    assert gpu.x.is_cuda and gpu.x.dtype == dtype
    rel = float((gpu.x.cpu() - cpu.x).abs().max() / cpu.x.abs().max())
    slack, xtol = (0, 1e-9) if dtype == torch.float64 else (4 if name == "sgs_solve" else 2, 1e-3)
    assert int(cpu.n_iterations) > 0
    assert abs(int(gpu.n_iterations) - int(cpu.n_iterations)) <= slack
    assert rel <= xtol, rel


@pytest.mark.parametrize("name", FAMILY)
def test_solver_family_is_bitwise_repeatable_on_cuda(name):
    """Two solves on the card give the same bits: no sum of the family adds
    into colliding indices."""
    _need_cuda()
    a, b = _family_solve(name, torch.float32, "cuda"), _family_solve(name, torch.float32, "cuda")
    assert torch.equal(a.x, b.x) and int(a.n_iterations) == int(b.n_iterations)
    assert torch.equal(a.final_residual, b.final_residual)


@pytest.mark.parametrize("config", ["gmg", "amg", "exact-box", "exact-smooth"])
def test_step_with_the_solver_family_on_cuda(tmp_path, config):
    """Three steps from t = 0 in float64 on the card against the CPU's, with
    the lattice multigrid, AMG, DIC-PCG (box fire) or symGaussSeidel
    (smoothSolver case) on: equal iteration counts, fields to 1e-9 relative;
    a second run on the card is bitwise equal. K2 is launched by the
    hydrostatic init only (never with the exact solvers)."""
    _need_cuda()
    write = write_smooth_fire_case if config == "exact-smooth" else write_box_fire_case
    root = write(str(tmp_path / "box"), n=(8, 8, 8))
    kw = {"gmg": dict(gmg=True, exact_solvers=False), "amg": dict(amg=True, exact_solvers=False),
          "exact-box": dict(exact_solvers=True), "exact-smooth": dict(exact_solvers=True)}[config]
    runs = {}
    for run, dev in (("cpu", "cpu"), ("gpu", "cuda"), ("again", "cuda")):
        dia_krylov.reset_counts()
        solver = FireFoamSolver(root, device=dev, dtype=torch.float64, **kw)
        st = solver.initial_state()
        init_k2 = dia_krylov.LAUNCHES["pcg"]
        st, logs = solver.make_chunk(3)(st)
        if dev == "cuda":
            assert dia_krylov.LAUNCHES["pcg"] == init_k2
            assert (init_k2 == 0) == config.startswith("exact")
            assert dia_krylov.LAUNCHES["smooth"] == 0
        runs[run] = (state_to_numpy(st), {k: v.cpu().numpy() for k, v in logs.items()})
    for k, v in runs["cpu"][1].items():
        if k.endswith("_iters") or "iters_" in k:
            np.testing.assert_array_equal(runs["gpu"][1][k], v, err_msg=k)
    for f in ("T", "U", "p_rgh", "Y", "k"):
        a, b = runs["gpu"][0][f].i, runs["cpu"][0][f].i
        assert np.max(np.abs(a - b)) / np.max(np.abs(b)) <= 1e-9, f
        np.testing.assert_array_equal(runs["again"][0][f].i, a, err_msg=f)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows", [128, 160])
def test_bicgstab_at_the_banded_shapes(rows, dtype):
    """K1 on 128 and 160 per-row systems of 100k cells, the banded fvDOM's
    batches (the many-rows kernel, whatever G), against its plain
    version."""
    _need_cuda()
    nxyz = (50, 40, 50)
    offs = _offs(nxyz)
    ops = _system(43, rows, False, False, dtype, torch.device("cuda"), nxyz, 1.0)
    plan, _ = dia_krylov._grid_launch_plan("bicgstab", dtype, rows, ops[0].shape[-1], offs,
                                           ops[0].element_size())
    assert plan.rows == (dia_krylov.ROWS_MIN <= rows <= dia_krylov.ROWS_MAX) and plan.grid_wide
    before = dia_krylov.LAUNCHES["bicgstab"]
    got = dia_krylov.dia_bicgstab(*ops, offs, tol=1e-8, max_iter=500)
    torch.cuda.synchronize()
    assert dia_krylov.LAUNCHES["bicgstab"] == before + 1
    ref = _plain("bicgstab", *ops, offs, tol=1e-8, max_iter=500)
    slack, xtol = _tolerances("bicgstab", dtype)
    its = (got.n_iterations.cpu().numpy(), ref.n_iterations.cpu().numpy())
    assert np.all(np.abs(its[0] - its[1]) <= slack), its
    rel = float((got.x - ref.x).abs().max() / ref.x.abs().max())
    assert rel <= xtol, rel


ROWS_SHAPES = {"100kx16": ((50, 40, 50), 16), "100kx128": ((50, 40, 50), 128),
               "100kx160": ((50, 40, 50), 160), "9kx200": ((30, 15, 20), 200)}


def _rows_check(got, ref, dtype):
    slack, xtol = _tolerances("bicgstab", dtype)
    its = (got.n_iterations.cpu().numpy(), ref.n_iterations.cpu().numpy())
    assert np.all(np.abs(its[0] - its[1]) <= slack), its
    rel = (got.x - ref.x).abs().amax(dim=-1) / ref.x.abs().amax(dim=-1)
    assert float(rel.max()) <= xtol, rel
    return its[1]


@pytest.mark.parametrize("shape", list(ROWS_SHAPES))
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rows_kernel_matches_plain_version(dtype, shared, shape):
    """The many-rows kernel through the wrapper's rule (which takes it at
    these sizes) against the plain version; a second launch bit-equal."""
    _need_cuda()
    nxyz, B = ROWS_SHAPES[shape]
    ops = _system(71, B, False, shared, dtype, torch.device("cuda"), nxyz, 1.0)
    dia_krylov.reset_counts()
    got = dia_krylov.dia_bicgstab(*ops, _offs(nxyz), tol=1e-8, max_iter=500)
    torch.cuda.synchronize()
    assert dia_krylov.DEVICE_LAUNCHES["bicgstab_rows"] == 1
    _rows_check(got, _plain("bicgstab", *ops, _offs(nxyz), tol=1e-8, max_iter=500), dtype)
    again = dia_krylov._launch("bicgstab", *ops, _offs(nxyz), 1e-8, 0.0, 500, rows=True)
    assert torch.equal(again.x, got.x)
    assert torch.equal(again.final_residual, got.final_residual)
    assert again.n_iterations.tolist() == got.n_iterations.tolist()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rows_kernel_rows_stop_far_apart(dtype):
    """128 rows of 100k cells: heavier diagonals converge sooner, right-hand
    sides over six decades, and 8 rows start converged (b = A·x0, 0
    iterations). Every row stops at its own count, as the plain version's
    rows do; the stopped rows keep their x."""
    _need_cuda()
    dev = torch.device("cuda")
    nxyz, B = (50, 40, 50), 128
    d, up, lo, b, x0 = _system(73, B, False, False, dtype, dev, nxyz, 1.0)
    d = (d + torch.linspace(0, 6, B, dtype=dtype, device=dev)[:, None] ** 2).contiguous()
    b = (b * (10.0 ** torch.linspace(-3, 3, B, dtype=dtype, device=dev))[:, None]).contiguous()
    b[:8] = dia_krylov.dia_matvec(d, up, lo, _offs(nxyz), x0)[:8]
    got = dia_krylov.dia_bicgstab(d, up, lo, b, x0, _offs(nxyz), tol=1e-7, max_iter=500)
    ref = _plain("bicgstab", d, up, lo, b, x0, _offs(nxyz), tol=1e-7, max_iter=500)
    its = _rows_check(got, ref, dtype)
    assert (its[:8] == 0).all() and len(set(its.tolist())) > 8, its
    assert torch.equal(got.x[:8], x0[:8])


def test_rows_kernel_restarts_on_breakdown():
    """The 5-cell upwind chain whose rhat·v is exactly 0 at BiCGStab's second
    step in float64 (test_bicgstab_kernel_restarts_on_breakdown), 16 rows of
    it beside rows that never break down: the many-rows kernel restarts as
    the twin does, with the same per-row counts."""
    _need_cuda()
    dev = torch.device("cuda")
    n = 5
    lower = np.array([2.0, 1.0, -1.0, 1.0, 0.0])
    b = np.array([[1.0, -2.0, 2.0, -1.0, 0.0], [1.0, 0.5, 0.25, -1.0, 2.0]] * 8)
    ops = [torch.as_tensor(a, dtype=torch.float64, device=dev)
           for a in (np.ones(n), np.zeros(n), lower, b, np.zeros((16, n)))]
    assert dia_krylov._grid_launch_plan("bicgstab", torch.float64, 16, n, (1,), 8)[0].rows
    got = dia_krylov.dia_bicgstab(*ops, (1,), tol=1e-12, max_iter=50)
    ref = dia_krylov.plain(linear.bicgstab, *ops, (1,), tol=1e-12, max_iter=50)
    A = np.eye(n)
    A[np.arange(1, n), np.arange(n - 1)] = lower[:-1]
    x = np.linalg.solve(A, b.T).T
    assert bool(torch.isfinite(got.x).all())
    np.testing.assert_allclose(got.x.cpu().numpy(), x, rtol=0, atol=1e-12)
    assert got.n_iterations.tolist() == ref.n_iterations.tolist()


@pytest.mark.parametrize("layout", [dict(rows=True), dict(rows=False),
                                    dict(grid_wide=False)])
def test_bicgstab_kernels_stop_a_row_whose_step_overflows(layout):
    """float32, a right-hand side of 1e20 (r·r overflows): each K1 kernel
    fails that row as the plain version does (x0, its initial residual, 0
    iterations), and the other row solves as there."""
    _need_cuda()
    dev = torch.device("cuda")
    n = 5
    lower = np.array([2.0, 1.0, -1.0, 1.0, 0.0])
    b = np.array([[1e20, 3e20, 3e20, 2e20, 1e19], [1.0, 0.5, 0.25, -1.0, 2.0]])
    ops = [torch.as_tensor(a, dtype=torch.float32, device=dev)
           for a in (np.ones(n), np.zeros(n), lower, b, np.zeros((2, n)))]
    got = dia_krylov._launch("bicgstab", *ops, (1,), 1e-6, 0.0, 50, **layout)
    ref = dia_krylov.plain(linear.bicgstab, *ops, (1,), tol=1e-6, max_iter=50)
    assert bool(torch.isfinite(got.x).all()) and bool(torch.isfinite(ref.x).all())
    assert torch.equal(got.x[0], ops[4][0])
    assert torch.equal(got.final_residual[0], got.initial_residual[0])
    assert got.n_iterations.tolist() == ref.n_iterations.tolist()
    assert got.n_iterations.tolist()[0] == 0
    _, xtol = _tolerances("bicgstab", torch.float32)
    rel = float((got.x[1] - ref.x[1]).abs().max() / ref.x[1].abs().max())
    assert rel <= xtol, rel


def test_rows_kernel_at_the_row_cap():
    """ROWS_MAX rows of a 960-cell lattice in float64 (the kernel's largest
    shared memory) against the plain version; one row more goes to the
    one-block-per-row kernel."""
    _need_cuda()
    B = dia_krylov.ROWS_MAX
    ops = _system(79, B, False, True, torch.float64, torch.device("cuda"), NXYZ, 1.0)
    smem = dia_krylov.rows_smem(B, torch.float64)
    plan = dia_krylov._grid_launch_plan("bicgstab", torch.float64, B, 960, OFFS, 8)[0]
    assert plan.rows and dia_krylov._coop_blocks("bicgstab_rows", torch.float64, smem)[0] >= (
        plan.blocks_per_row)
    got = dia_krylov.dia_bicgstab(*ops, OFFS, tol=1e-8, max_iter=500)
    _rows_check(got, _plain("bicgstab", *ops, OFFS, tol=1e-8, max_iter=500), torch.float64)
    assert not dia_krylov._grid_launch_plan("bicgstab", torch.float64, B + 1, 960, OFFS,
                                            8)[0].rows


@pytest.mark.parametrize("model", RADIATION_MODELS)
def test_radiation_step_on_cuda_matches_cpu(tmp_path, model):
    """One step with a radiation solve of each radiation case on the card in
    float64 against the CPU, from the same developed state: the fields and
    the radiation state to 1e-9, equal iteration counts; the fvDOM (ray ×
    band) solves are K1 launches of nR·nL rows, P1's one of one row."""
    _need_cuda()
    root = write_radiation_fire_case(str(tmp_path / model), n=(10, 8, 10), model=model,
                                     n_theta=2, n_phi=1, n_bands=3, solver_freq=1)
    kw = dict(dtype=torch.float64, exact_solvers=False, gmg=False, amg=False)
    cpu = FireFoamSolver(root, device="cpu", **kw)
    gpu = FireFoamSolver(root, device="cuda", **kw)
    st_c, _ = cpu.make_chunk(12)(cpu.initial_state())
    st_g = state_from_numpy(state_to_numpy(st_c), device="cuda", dtype=torch.float64)
    rows, launch = [], dia_krylov._launch

    def recording(name, diag, upper, lower, b, x0, *a, **k):
        rows.append((name, x0.shape[0] if x0.ndim == 2 else 1))
        return launch(name, diag, upper, lower, b, x0, *a, **k)

    dia_krylov._launch = recording
    try:
        st_c, log_c = cpu.step(st_c)
        st_g, log_g = gpu.step(st_g)
        torch.cuda.synchronize()
    finally:
        dia_krylov._launch = launch
    rad = gpu.radiation
    if hasattr(rad, "n_lambda"):
        batch = rad.n_rays * rad.n_lambda
        assert sum(1 for nm, B in rows if nm == "bicgstab" and B == batch) == rad.sweeps >= 1
        assert torch.equal(rad.last_iters.cpu(), cpu.radiation.last_iters)
    for k in log_c:
        if k.endswith("_iters") or "iters_" in k:
            assert int(log_g[k]) == int(log_c[k]), (k, int(log_g[k]), int(log_c[k]))
    for f in ("T", "U", "p_rgh", "Y", "k"):
        a, b = st_g[f].i.cpu().numpy(), st_c[f].i.numpy()
        assert np.max(np.abs(a - b)) / np.max(np.abs(b)) <= 1e-9, f
    # P1's G solve is chaotic on this system: a 1e-16 relative perturbation
    # of its right-hand side takes BiCGStab from 45 to 47..53 iterations and
    # moves G by 1.3e-7 (measured on the CPU), so G and its boundary values
    # are held to ten times the solve's tolerance, and the iteration count
    # is not compared
    p1 = model == "P1"
    for k, v in st_c["rad"].items():
        a, b = st_g["rad"][k].cpu().numpy(), v.numpy()
        tol = 1e-5 if p1 and k in ("G", "G_b") else 1e-9
        assert np.max(np.abs(a - b)) <= tol * max(np.max(np.abs(b)), 1.0), k



# ------------------------------------------------------------------------
# The SEG layout on the card (plain PyTorch ops: no kernel serves it)
# ------------------------------------------------------------------------
def _castellated_geoms(tmp_path, n=(16, 12, 16)):
    from firefoam_torch.mesh import build_case_mesh
    from firefoam_torch.ops import MeshGeometry
    from firefoam_torch.utils.synthcase import write_castellated_fire_case

    mesh = build_case_mesh(write_castellated_fire_case(str(tmp_path / "castel"), n=n)).mesh
    return tuple(MeshGeometry.from_polymesh(mesh, dtype=torch.float64, device=d)
                 for d in ("cuda", "cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seg_sums_are_bitwise_repeatable_on_cuda(tmp_path, dtype):
    """The SEG face→cell sums go through host-sorted tables, not atomics:
    repeats on the card are bitwise equal; index_add_ is timed beside them
    in chip_smoke.py, not used."""
    _need_cuda()
    g, _ = _castellated_geoms(tmp_path)
    assert g.layout == "seg"
    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape in ((g.n_internal,), (g.n_internal, 3)):
        a = torch.randn(shape, generator=gen, device="cuda", dtype=dtype) * 1e3
        b = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
        first = (g.face_to_own_sum(a), g.face_to_nei_sum(b), g.face_to_both_sum(a, b))
        for _ in range(5):
            again = (g.face_to_own_sum(a), g.face_to_nei_sum(b), g.face_to_both_sum(a, b))
            assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_seg_matvec_on_cuda_matches_cpu(tmp_path):
    """The SEG product of raw (diag, upper, lower), shared and per row, on
    the card within 1e-12 of the CPU's in float64, and no K1-K3 launch."""
    _need_cuda()
    gg, gc = _castellated_geoms(tmp_path)
    rng = np.random.RandomState(4)
    dia_krylov.reset_counts()
    for rows in (None, 4):
        sf = (gc.n_internal,) if rows is None else (rows, gc.n_internal)
        sc = (gc.n_cells,) if rows is None else (rows, gc.n_cells)
        ops = [rng.rand(*sc) + 6.0, -rng.rand(*sf), -rng.rand(*sf), rng.randn(*sc)]
        on = lambda d: [torch.as_tensor(a, device=d) for a in ops]
        dg, ug, lg, xg = on("cuda")
        dc, uc, lc, xc = on("cpu")
        yg = linear.ldu_matvec(gg, dg, ug, lg)(xg).cpu().numpy()
        yc = linear.ldu_matvec(gc, dc, uc, lc)(xc).numpy()
        assert np.max(np.abs(yg - yc)) <= 1e-12 * np.max(np.abs(yc))
    assert sum(dia_krylov.LAUNCHES.values()) == 0


def test_castellated_step_on_cuda_matches_cpu(tmp_path):
    """One castellated step (the automatic rule: the exact solvers in
    float64) on the card from the CPU's state after 10 steps, against the
    CPU's step: 1e-9, equal counts, no K1-K3 launch. (From t = 0 the first
    solves sit at their tolerance and a count may part.)"""
    _need_cuda()
    from firefoam_torch.utils.synthcase import write_castellated_fire_case

    root = write_castellated_fire_case(str(tmp_path / "castel"), n=(10, 8, 10))
    cpu = FireFoamSolver(root, device="cpu", dtype=torch.float64)
    card = FireFoamSolver(root, device="cuda", dtype=torch.float64)
    assert cpu.geom.layout == card.geom.layout == "seg"
    state, _ = cpu.make_chunk(10)(cpu.initial_state())
    st_c, log_c = cpu.step(state)
    dia_krylov.reset_counts()
    st_g, log_g = card.step(state_from_numpy(state_to_numpy(state), device="cuda",
                                             dtype=torch.float64))
    assert sum(dia_krylov.LAUNCHES.values()) == 0
    for k in log_c:
        if k.endswith("_iters") or "iters_" in k:
            assert int(log_g[k]) == int(log_c[k]), (k, int(log_g[k]), int(log_c[k]))
    for f in ("T", "U", "p_rgh", "Y", "k"):
        a, b = st_g[f].i.cpu().numpy(), st_c[f].i.numpy()
        rel = np.max(np.abs(a - b)) / np.max(np.abs(b))
        assert rel <= 1e-9, (f, rel)


# ------------------------------------------------------------------------
# 9-16 offsets (the DIA layout's cap; the hybrid layout's lane counts)
# ------------------------------------------------------------------------
def _system_k(seed, B, sym, shared, dtype, offs, n=20000, excess=None):
    """B random diagonally dominant DIA systems on n cells with the stencil
    `offs` (a face where the neighbour exists). `excess`: the diagonal's
    excess over the off-diagonals, 1 + 0.1·U(0, 1) times this (None: K/3)."""
    rng = np.random.RandomState(seed)
    K = len(offs)
    R = 1 if shared else B
    up = np.zeros((R, K, n))
    lo = np.zeros((R, K, n))
    # by default the diagonal's excess grows with K as the off-diagonals do:
    # as well conditioned as the lattice systems
    d = (K / 3.0 if excess is None else excess) * (1.0 + 0.1 * rng.rand(B, n))
    for k, o in enumerate(offs):
        v = -(0.5 + rng.rand(R, n - o))
        up[:, k, : n - o] = v
        lo[:, k, : n - o] = v if sym else v * (1.0 + 0.3 * rng.rand(R, n - o))
        d[:, : n - o] -= up[:, k, : n - o]
        d[:, o:] -= lo[:, k, : n - o]
    up, lo = up.reshape(R, -1), lo.reshape(R, -1)
    if shared:
        up, lo = up[0], lo[0]
    arrs = (d, up, lo, rng.randn(B, n), 0.1 * rng.randn(B, n))
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in arrs]


OFFSETS_K = {
    9: (1, 2, 40, 41, 42, 1600, 1640, 1641, 3200),
    12: (1, 2, 39, 40, 41, 80, 1560, 1599, 1600, 1601, 1640, 3200),
    16: (1, 2, 3, 38, 39, 40, 41, 42, 80, 1560, 1599, 1600, 1601, 1640, 3200, 4800),
}


@pytest.mark.parametrize("rows", [(1, True), (3, True), (6, False)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K", sorted(OFFSETS_K))
@pytest.mark.parametrize("name", NAMES)
def test_kernels_at_9_to_16_offsets(name, K, dtype, rows):
    _need_cuda()
    B, shared = rows
    if name != "bicgstab" and B == 6:
        B, shared = 2, False
    offs = OFFSETS_K[K]
    ops = _system_k(K + B, B, name == "pcg", shared, dtype, offs)
    mx = 800 if name == "smooth" else 500
    before = dia_krylov.LAUNCHES[name]
    got = getattr(dia_krylov, f"dia_{name}")(*ops, offs, tol=1e-8, max_iter=mx)
    torch.cuda.synchronize()
    assert dia_krylov.LAUNCHES[name] == before + 1
    ref = _plain(name, *ops, offs, tol=1e-8, max_iter=mx)
    slack, xtol = _tolerances(name, dtype)
    its = (got.n_iterations.cpu().numpy(), ref.n_iterations.cpu().numpy())
    assert np.all(np.abs(its[0] - its[1]) <= slack), its
    assert np.all(its[1] > 0)
    rel = float((got.x - ref.x).abs().max() / ref.x.abs().max())
    assert rel <= xtol, rel


def test_k1_at_12_offsets_poorly_conditioned_by_residual():
    """With the lattice's diagonal excess (1, not K/3) a one-ulp move of b
    moves the plain version's x by more than the 1e-9 that x is held to
    elsewhere; the kernel is held to the plain version by the true residual
    Σ|b − A·x| / normFactor, recomputed in float64."""
    _need_cuda()
    offs = OFFSETS_K[12]
    d, up, lo, b, x0 = _system_k(12, 1, False, True, torch.float64, offs, excess=1.0)
    kw = dict(tol=1e-8, rel_tol=0.0, max_iter=1000)
    got = dia_krylov.dia_bicgstab(d, up, lo, b, x0, offs, **kw)
    ref = _plain("bicgstab", d, up, lo, b, x0, offs, **kw)

    def residual(x):
        mv = lambda v: dia_krylov.dia_matvec(d, up, lo, offs, v)
        _, norm = linear._norm_factor(mv, x0, b)
        return float(torch.sum(torch.abs(b - mv(x))) / norm)

    assert bool(torch.isfinite(got.x).all())
    assert int(ref.n_iterations[0]) > 0
    assert residual(got.x) <= 10.0 * max(residual(ref.x), kw["tol"])


def test_profile_raw_events_match_the_event_tree():
    """profile_step.device_events reads the profiler's raw events; on a
    window of launches, copies and host reads its counts and busy time are
    those of key_averages() and events()."""
    _need_cuda()
    from firefoam_torch.profile_step import busy_us, device_events, kernel_launches

    offs = OFFSETS_K[12]
    ops = _system_k(5, 1, True, True, torch.float32, offs)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        dia_krylov.dia_pcg(*ops, offs, tol=1e-8, max_iter=500)
        for _ in range(20):
            float((ops[3] * 2.0 + 1.0).sum())
        ops[3].cpu()
        torch.cuda.synchronize()
    dev, reads = device_events(prof)
    avgs = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    assert kernel_launches(dev) == sum(
        e.count for e in avgs
        if e.device_type == cuda and not e.key.lower().startswith(("memcpy", "memset")))
    assert reads == sum(e.count for e in avgs if e.key == "aten::_local_scalar_dense") >= 20
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    union, end = 0.0, None
    for a, b in spans:
        union += max(0.0, b - max(a, end)) if end is not None else b - a
        end = b if end is None else max(end, b)
    assert kernel_launches(dev) > 20
    assert busy_us(dev) == pytest.approx(union, rel=1e-6, abs=1e-3)


def test_kernels_refuse_17_offsets():
    """The kernels take 1..64 offsets (the banded layout's budget; 16
    before it): a 65th is refused before anything is launched."""
    _need_cuda()
    offs = OFFSETS_BANDED[64] + (6400,)
    ops = _system_k(3, 1, True, True, torch.float64, offs)
    before = dict(dia_krylov.LAUNCHES)
    for name in NAMES:
        with pytest.raises(ValueError, match="65 offsets"):
            getattr(dia_krylov, f"dia_{name}")(*ops, offs)
    assert dia_krylov.LAUNCHES == before


# ------------------------------------------------------------------------
# 17-64 offsets (the banded layout: a slender castellation in its own
# numbering, or one renumbered by mesh/renumber.py)
# ------------------------------------------------------------------------
# the 104k-cell shaft's 34 offsets (write_castellated_fire_case
# n=(8,8,1500)), the first 17 of them, and 64 spread over two bands
OFFS_SHAFT = (1, 2, 3, 4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 21, 64, 66, 68, 69,
              71, 72, 73, 74, 76, 77, 78, 79, 81, 82, 84, 86, 87)
OFFSETS_BANDED = {
    17: OFFS_SHAFT[:17],
    34: OFFS_SHAFT,
    64: tuple(range(1, 33)) + tuple(range(2001, 2033)),
}


@pytest.mark.parametrize("rows", [(1, True), (3, True), (6, False)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K", sorted(OFFSETS_BANDED))
@pytest.mark.parametrize("name", NAMES)
def test_kernels_at_17_to_64_offsets(name, K, dtype, rows):
    """K1 (grid-wide and many-rows kernels), K2 and K3 against their plain
    versions at 17, 34 and 64 offsets, one launch each."""
    _need_cuda()
    B, shared = rows
    if name != "bicgstab" and B == 6:
        B, shared = 2, False
    offs = OFFSETS_BANDED[K]
    ops = _system_k(K + B, B, name == "pcg", shared, dtype, offs)
    mx = 800 if name == "smooth" else 500
    before = dia_krylov.LAUNCHES[name]
    got = getattr(dia_krylov, f"dia_{name}")(*ops, offs, tol=1e-8, max_iter=mx)
    torch.cuda.synchronize()
    assert dia_krylov.LAUNCHES[name] == before + 1
    ref = _plain(name, *ops, offs, tol=1e-8, max_iter=mx)
    slack, xtol = _tolerances(name, dtype)
    its = (got.n_iterations.cpu().numpy(), ref.n_iterations.cpu().numpy())
    assert np.all(np.abs(its[0] - its[1]) <= slack), its
    assert np.all(its[1] > 0)
    rel = float((got.x - ref.x).abs().max() / ref.x.abs().max())
    assert rel <= xtol, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_sums_are_bitwise_repeatable_on_cuda(tmp_path, dtype):
    """Above 3 offsets the DIA face motion is the lanes' gather and ordered
    sum: repeats on the card are bitwise equal, and the gather equals the
    rolls' concatenation."""
    _need_cuda()
    from firefoam_torch.mesh import build_case_mesh
    from firefoam_torch.ops import MeshGeometry
    from firefoam_torch.utils.synthcase import write_castellated_fire_case

    root = write_castellated_fire_case(str(tmp_path / "column"), n=(4, 4, 60),
                                       size=(0.2, 0.2, 3.0))
    g = MeshGeometry.from_polymesh(build_case_mesh(root).mesh, dtype=dtype, device="cuda",
                                   layout="banded")
    assert g.layout == "dia" and len(g.offsets) == 34 and g.lane_shift is not None
    gen = torch.Generator(device="cuda").manual_seed(6)
    mask = g.face_mask.to(dtype)
    for shape in ((g.n_internal,), (g.n_internal, 3)):
        m = mask if len(shape) == 1 else mask[:, None]
        a = torch.randn(shape, generator=gen, device="cuda", dtype=dtype) * m * 1e3
        b = torch.randn(shape, generator=gen, device="cuda", dtype=dtype) * m
        first = (g.face_to_own_sum(a), g.face_to_nei_sum(b), g.face_to_both_sum(a, b))
        for _ in range(5):
            again = (g.face_to_own_sum(a), g.face_to_nei_sum(b), g.face_to_both_sum(a, b))
            assert all(torch.equal(x, y) for x, y in zip(first, again))
        x = torch.randn((g.n_cells,) + shape[1:], generator=gen, device="cuda", dtype=dtype)
        rolls = torch.cat([torch.roll(x, -o, dims=0) for o in g.offsets], dim=0)
        assert torch.equal(g.gather_nei(x), rolls)


def test_banded_column_step_on_cuda_matches_cpu(tmp_path):
    """One step of the slender castellated column (4,4,60) on the banded
    layout (34 offsets: K1 and K2 serve it), on the card from the CPU's
    state after 10 steps, against the CPU's step in float64: 1e-9, equal
    counts."""
    _need_cuda()
    from firefoam_torch.utils.synthcase import write_castellated_fire_case

    root = write_castellated_fire_case(str(tmp_path / "column"), n=(4, 4, 60),
                                       size=(0.2, 0.2, 3.0))
    kw = dict(dtype=torch.float64, layout="banded", exact_solvers=False, gmg=False, amg=False)
    cpu = FireFoamSolver(root, device="cpu", **kw)
    card = FireFoamSolver(root, device="cuda", **kw)
    assert cpu.geom.layout == card.geom.layout == "dia" and len(card.geom.offsets) == 34
    state, _ = cpu.make_chunk(10)(cpu.initial_state())
    st_c, log_c = cpu.step(state)
    dia_krylov.reset_counts()
    st_g, log_g = card.step(state_from_numpy(state_to_numpy(state), device="cuda",
                                             dtype=torch.float64))
    assert dia_krylov.LAUNCHES["bicgstab"] > 0 and dia_krylov.LAUNCHES["pcg"] > 0
    for k in log_c:
        if k.endswith("_iters") or "iters_" in k:
            assert int(log_g[k]) == int(log_c[k]), (k, int(log_g[k]), int(log_c[k]))
    for f in ("T", "U", "p_rgh", "Y", "k", "phi"):
        a, b = st_g[f].i.cpu().numpy(), st_c[f].i.numpy()
        rel = np.max(np.abs(a - b)) / np.max(np.abs(b))
        assert rel <= 1e-9, (f, rel)


# ------------------------------------------------------------------------
# The hybrid layout on the card (plain PyTorch ops: no kernel serves it)
# ------------------------------------------------------------------------
def _hybrid_geom(tmp_path, device, n=(16, 12, 16)):
    from firefoam_torch.mesh import build_case_mesh
    from firefoam_torch.ops import MeshGeometry
    from firefoam_torch.utils.synthcase import write_castellated_fire_case

    mesh = build_case_mesh(write_castellated_fire_case(str(tmp_path / "castel"), n=n)).mesh
    return MeshGeometry.from_polymesh(mesh, dtype=torch.float64, device=device, layout="hybrid")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hybrid_sums_are_bitwise_repeatable_on_cuda(tmp_path, dtype):
    """The lanes are rolls and shifts and the rest tail sums through
    host-sorted tables: repeats on the card are bitwise equal, and so is
    the product of a batch of rows."""
    _need_cuda()
    g = _hybrid_geom(tmp_path, "cuda")
    assert g.layout == "hybrid" and len(g.offsets) == 14
    gen = torch.Generator(device="cuda").manual_seed(5)
    mask = g.face_mask.to(dtype)
    for shape in ((g.n_internal,), (g.n_internal, 3)):
        m = mask if len(shape) == 1 else mask[:, None]
        a = torch.randn(shape, generator=gen, device="cuda", dtype=dtype) * m * 1e3
        b = torch.randn(shape, generator=gen, device="cuda", dtype=dtype) * m
        first = (g.face_to_own_sum(a), g.face_to_nei_sum(b), g.face_to_both_sum(a, b))
        for _ in range(5):
            again = (g.face_to_own_sum(a), g.face_to_nei_sum(b), g.face_to_both_sum(a, b))
            assert all(torch.equal(x, y) for x, y in zip(first, again))
    up = -torch.rand((4, g.n_internal), generator=gen, device="cuda", dtype=dtype) * mask
    d = 6.0 + torch.rand((4, g.n_cells), generator=gen, device="cuda", dtype=dtype)
    x = torch.randn((4, g.n_cells), generator=gen, device="cuda", dtype=dtype)
    mv = linear.ldu_matvec(g, d, up, up)
    y = mv(x)
    assert all(torch.equal(mv(x), y) for _ in range(5))


def test_hybrid_castellated_step_on_cuda_matches_cpu(tmp_path):
    """One step of the castellated fire at (8,6,8) on the hybrid layout
    with PairMG on p_rgh (the DIC schedule off), on the card from the CPU's
    state after 10 steps, against the CPU's step in float64: 1e-9, equal
    counts, no K1-K3 launch."""
    _need_cuda()
    from firefoam_torch.utils.synthcase import write_castellated_fire_case

    root = write_castellated_fire_case(str(tmp_path / "castel"), n=(8, 6, 8))
    kw = dict(dtype=torch.float64, layout="hybrid", pairmg=True, exact_solvers=False)
    cpu = FireFoamSolver(root, device="cpu", **kw)
    card = FireFoamSolver(root, device="cuda", **kw)
    assert cpu.geom.layout == card.geom.layout == "hybrid"
    assert cpu.pairmg is not None and card.pairmg is not None
    state, _ = cpu.make_chunk(10)(cpu.initial_state())
    st_c, log_c = cpu.step(state)
    dia_krylov.reset_counts()
    st_g, log_g = card.step(state_from_numpy(state_to_numpy(state), device="cuda",
                                             dtype=torch.float64))
    assert sum(dia_krylov.LAUNCHES.values()) == 0
    for k in log_c:
        if k.endswith("_iters") or "iters_" in k:
            assert int(log_g[k]) == int(log_c[k]), (k, int(log_g[k]), int(log_c[k]))
    for f in ("T", "U", "p_rgh", "Y", "k", "phi"):
        a, b = st_g[f].i.cpu().numpy(), st_c[f].i.numpy()
        rel = np.max(np.abs(a - b)) / np.max(np.abs(b))
        assert rel <= 1e-9, (f, rel)


# ------------------------------------------------------------------------
# K1 and K2 above 3 offsets: the window of the exchanged vector, the
# residency split and the unrolled stencil (bit for bit the L2 path's sums)
# ------------------------------------------------------------------------
# phase 3's systems of chip_smoke.py on 100k cells: 12 offsets with a far
# band beyond the window's reach, the shaft's 34, the renumbered box's 62
OFFS_12_MAIN = (1, 2, 49, 50, 51, 100, 1950, 1999, 2000, 2001, 2050, 4000)
SPLIT_OFFSETS = {12: OFFS_12_MAIN, 34: OFFS_SHAFT, 62: tuple(range(1, 63)),
                 64: tuple(range(1, 65))}


def _same_solve(a, b):
    return (a.n_iterations.tolist() == b.n_iterations.tolist() and torch.equal(a.x, b.x)
            and torch.equal(a.final_residual, b.final_residual)
            and torch.equal(a.initial_residual, b.initial_residual))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K", [12, 34, 62])
@pytest.mark.parametrize("name,B", [("bicgstab", 1), ("bicgstab", 3), ("pcg", 1)])
def test_window_path_equals_l2_path_bitwise(name, B, K, dtype):
    """K1 (B = 1, 3 shared) and K2 on 100k cells at 12, 34 and 62 offsets:
    the window path against window=0 (every offset from L2 through the same
    unrolled stencil) bitwise in x, residuals and counts; both against the
    plain version with the file's tolerances (float64: equal counts)."""
    _need_cuda()
    offs = SPLIT_OFFSETS[K]
    n = 100_000
    ops = _system_k(K + 7 * B, B, name == "pcg", True, dtype, offs, n=n)
    plan, split = dia_krylov._grid_launch_plan(name, dtype, B, n, offs, ops[0].element_size())
    assert plan.grid_wide and not plan.rows and 0 < split.window <= 100
    kw = dict(tol=1e-8, rel_tol=0.0, max_iter=500)
    before = dict(dia_krylov.DEVICE_LAUNCHES)
    got = dia_krylov._launch(name, *ops, offs, kw["tol"], 0.0, kw["max_iter"])
    l2 = dia_krylov._launch(name, *ops, offs, kw["tol"], 0.0, kw["max_iter"], window=0)
    torch.cuda.synchronize()
    assert dia_krylov.DEVICE_LAUNCHES[f"{name}_grid"] == before[f"{name}_grid"] + 2
    assert _same_solve(got, l2)
    ref = _plain(name, *ops, offs, **kw)
    slack, xtol = _tolerances(name, dtype)
    its = (got.n_iterations.cpu().numpy(), ref.n_iterations.cpu().numpy())
    assert np.all(np.abs(its[0] - its[1]) <= slack), its
    assert np.all(its[1] > 0)
    rel = float((got.x - ref.x).abs().max() / ref.x.abs().max())
    assert rel <= xtol, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shaft_blocks_keep_most_slices_resident(dtype):
    """K2 on the banded shaft's shape (104,280 cells, 34 offsets: 131 blocks
    of 800 cells), whose 5 + 2K slices are 1,152 B over a block's shared
    memory in float32: the split keeps the window, the Krylov slices, the
    diagonal and most pairs resident, and solves as window=0 and the plain
    version do."""
    _need_cuda()
    n = 104_280
    ops = _system_k(3, 1, True, True, dtype, OFFS_SHAFT, n=n)
    plan, split = dia_krylov._grid_launch_plan("pcg", dtype, 1, n, OFFS_SHAFT,
                                               ops[0].element_size())
    assert (plan.blocks_per_row, plan.cells_per_block) == (131, 800)
    assert split.window == 87 and split.krylov == 4 and split.diag == 1
    assert split.pairs >= (30 if dtype == torch.float32 else 12)
    kw = dict(tol=1e-8, rel_tol=0.0, max_iter=500)
    got = dia_krylov.dia_pcg(*ops, OFFS_SHAFT, **kw)
    l2 = dia_krylov._launch("pcg", *ops, OFFS_SHAFT, kw["tol"], 0.0, kw["max_iter"], window=0)
    streamed = dia_krylov._launch("pcg", *ops, OFFS_SHAFT, kw["tol"], 0.0, kw["max_iter"],
                                  resident=False)
    assert _same_solve(got, l2) and _same_solve(got, streamed)
    ref = _plain("pcg", *ops, OFFS_SHAFT, **kw)
    slack, xtol = _tolerances("pcg", dtype)
    assert abs(int(got.n_iterations) - int(ref.n_iterations)) <= slack
    assert float((got.x - ref.x).abs().max() / ref.x.abs().max()) <= xtol


@pytest.mark.parametrize("name", ["pcg", "bicgstab"])
def test_offsets_beyond_the_window_come_from_l2(name):
    """OFFS_12 at 768 cells a block: the window serves 1-100 and the far
    band (1,950-4,000) is read from L2; the same solve with a window that
    serves every offset (W = 4000) and with none is bit-equal."""
    _need_cuda()
    n = 100_000
    ops = _system_k(21, 1, name == "pcg", True, torch.float64, OFFS_12_MAIN, n=n)
    _, split = dia_krylov._grid_launch_plan(name, torch.float64, 1, n, OFFS_12_MAIN, 8)
    assert split.window == 100 < max(OFFS_12_MAIN)
    runs = [dia_krylov._launch(name, *ops, OFFS_12_MAIN, 1e-8, 0.0, 500, window=w)
            for w in (None, 4000, 0)]
    assert int(runs[0].n_iterations) > 0
    assert _same_solve(runs[0], runs[1]) and _same_solve(runs[0], runs[2])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_window_path_at_64_offsets(dtype):
    """The 64-offset maximum (1-64: every offset in the window) through K1
    and K2 on 20k cells: bitwise the L2 path's solve, near the plain
    version; a 65th offset is refused as before
    (test_kernels_refuse_17_offsets)."""
    _need_cuda()
    offs = SPLIT_OFFSETS[64]
    for name in ("pcg", "bicgstab"):
        ops = _system_k(64, 1, name == "pcg", True, dtype, offs)
        _, split = dia_krylov._grid_launch_plan(name, dtype, 1, 20_000, offs,
                                                ops[0].element_size())
        assert split.window == 64
        got = dia_krylov._launch(name, *ops, offs, 1e-8, 0.0, 500)
        assert _same_solve(got, dia_krylov._launch(name, *ops, offs, 1e-8, 0.0, 500, window=0))
        ref = _plain(name, *ops, offs, tol=1e-8, max_iter=500)
        slack, xtol = _tolerances(name, dtype)
        assert abs(int(got.n_iterations) - int(ref.n_iterations)) <= slack
        assert float((got.x - ref.x).abs().max() / ref.x.abs().max()) <= xtol


# ------------------------------------------------------------------------
# K3 above 3 offsets: the split kernel (window of the iterate, residency by
# operand, unrolled stencil), bit for bit its window=0 run
# ------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K", [12, 34, 62])
@pytest.mark.parametrize("B", [1, 4])
def test_smooth_window_path_equals_l2_path_bitwise(B, K, dtype):
    """K3 on 100k cells at 12, 34 and 62 offsets, one row (h, k) and the Yi
    batch's 4 rows (a matrix each, as the step stacks them): the split kernel against
    window=0 (every neighbour from L2 through the same stencil) and against
    every slice streamed, bitwise in x, residuals and sweep counts; against
    plain_smooth with the file's tolerances (float64: equal counts)."""
    _need_cuda()
    offs = SPLIT_OFFSETS[K]
    n, mx, extra = 100_000, 800, (0.8, 4)
    ops = _system_k(K + 11 * B, B, False, B == 1, dtype, offs, n=n)
    plan, split = dia_krylov._grid_launch_plan("smooth", dtype, B, n, offs,
                                               ops[0].element_size())
    assert plan.grid_wide and 0 < split.window <= 100 and split.krylov == 2 and split.diag
    before = dia_krylov.DEVICE_LAUNCHES["smooth_grid"]
    got = dia_krylov.dia_smooth(*ops, offs, tol=1e-8, max_iter=mx)
    l2 = dia_krylov._launch("smooth", *ops, offs, 1e-8, 0.0, mx, extra=extra, window=0)
    streamed = dia_krylov._launch("smooth", *ops, offs, 1e-8, 0.0, mx, extra=extra,
                                  resident=False)
    torch.cuda.synchronize()
    assert dia_krylov.DEVICE_LAUNCHES["smooth_grid"] == before + 3
    assert _same_solve(got, l2) and _same_solve(got, streamed)
    ref = dia_krylov.plain_smooth(*ops, offs, tol=1e-8, max_iter=mx)
    slack, xtol = _tolerances("smooth", dtype)
    its = (got.n_iterations.cpu().numpy(), ref.n_iterations.cpu().numpy())
    assert np.all(np.abs(its[0] - its[1]) <= slack), its
    assert np.all(its[1] > 0)
    rel = float((got.x - ref.x).abs().max() / ref.x.abs().max())
    assert rel <= xtol, rel


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K", [34, 62])
def test_smooth_split_kernel_equals_one_block_per_row_bitwise(K, dtype):
    """A fixed budget of sweeps (tol 0, as in
    test_smooth_grid_kernel_equals_one_block_per_row_bitwise) through the
    split K3 and through smooth_kernel, which reads its stencil in a loop
    from global memory: the same x bitwise, on the banded shaft's 104,280
    cells in its 800-cell blocks."""
    _need_cuda()
    offs = SPLIT_OFFSETS[K]
    n = 104_280
    ops = _system_k(K + 5, 1, False, True, dtype, offs, n=n)
    plan, split = dia_krylov._grid_launch_plan("smooth", dtype, 1, n, offs,
                                               ops[0].element_size())
    assert plan.cells_per_block == 800 and split.window == max(o for o in offs if o <= 400)
    runs = [dia_krylov._launch("smooth", *ops, offs, 0.0, 0.0, 32, extra=(0.8, 4), **kw)
            for kw in (dict(), dict(grid_wide=False))]
    assert [int(r.n_iterations) for r in runs] == [32, 32]
    assert torch.equal(runs[0].x, runs[1].x)


# ------------------------------------------------------------------------
# K1's many-rows kernel above 8 offsets: a window of the exchanged vector
# per warp, the unrolled stencil, more cells of a lane in flight (bit for bit
# the L2 path's sums, which are the looped stencil's)
# ------------------------------------------------------------------------
ROWS_OFFSETS = {9: OFFSETS_K[9], 12: OFFSETS_K[12], 16: OFFSETS_K[16], 17: OFFSETS_BANDED[17],
                34: OFFS_SHAFT, 62: tuple(range(1, 63)), 64: OFFSETS_BANDED[64]}


@pytest.mark.parametrize("B", [5, 16, 128])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K", sorted(ROWS_OFFSETS))
def test_rows_window_path_equals_l2_path_bitwise(K, dtype, shared, B):
    """K1's many-rows kernel on B rows of 20k cells at 9-64 offsets, with
    shared and per-row operators: the windows (the rule's W) against
    window=0 (every neighbour from L2 through the same unrolled stencil),
    bitwise in x, residuals and counts; against the plain version with the
    file's tolerances (float64: equal counts)."""
    _need_cuda()
    offs = ROWS_OFFSETS[K]
    n = 20_000
    ops = _system_k(K + B, B, False, shared, dtype, offs, n=n)
    plan, split = dia_krylov._grid_launch_plan("bicgstab", dtype, B, n, offs,
                                               ops[0].element_size())
    near = max(o for o in offs if o <= dia_krylov.ROWS_CHUNK)
    assert plan.rows and split.window == near
    kw = dict(tol=1e-8, rel_tol=0.0, max_iter=500)
    before = dia_krylov.DEVICE_LAUNCHES["bicgstab_rows"]
    got = dia_krylov.dia_bicgstab(*ops, offs, **kw)
    l2 = dia_krylov._launch("bicgstab", *ops, offs, kw["tol"], 0.0, kw["max_iter"], window=0)
    torch.cuda.synchronize()
    assert dia_krylov.DEVICE_LAUNCHES["bicgstab_rows"] == before + 2
    assert _same_solve(got, l2)
    ref = _plain("bicgstab", *ops, offs, **kw)
    its = _rows_check(got, ref, dtype)
    assert np.all(its > 0)


def test_rows_window_path_fails_a_row_whose_step_overflows():
    """float32 at 34 offsets, 16 rows of which row 3's right-hand side is
    1e20 (r·r overflows): the many-rows kernel with its windows fails that
    row to x0 and its initial residual, as window=0 and the plain version
    do, and linear.failed_rows counts it (R18); the other rows solve as the
    plain version's."""
    _need_cuda()
    d, up, lo, b, x0 = _system_k(83, 16, False, False, torch.float32, OFFS_SHAFT, n=20_000)
    b[3] *= 1e20
    kw = dict(tol=1e-6, rel_tol=0.0, max_iter=500)
    _, split = dia_krylov._grid_launch_plan("bicgstab", torch.float32, 16, 20_000, OFFS_SHAFT, 4)
    assert split.window == 87
    got = dia_krylov.dia_bicgstab(d, up, lo, b, x0, OFFS_SHAFT, **kw)
    l2 = dia_krylov._launch("bicgstab", d, up, lo, b, x0, OFFS_SHAFT, kw["tol"], 0.0,
                            kw["max_iter"], window=0)
    ref = _plain("bicgstab", d, up, lo, b, x0, OFFS_SHAFT, **kw)
    assert _same_solve(got, l2)
    assert bool(torch.isfinite(got.x).all())
    assert torch.equal(got.x[3], x0[3])
    assert torch.equal(got.final_residual[3], got.initial_residual[3])
    failed = linear.failed_rows(got, kw["tol"])
    assert failed.tolist() == [q == 3 for q in range(16)]
    assert failed.tolist() == linear.failed_rows(ref, kw["tol"]).tolist()
    assert got.n_iterations.tolist()[3] == ref.n_iterations.tolist()[3]
    keep = [q for q in range(16) if q != 3]
    _rows_check(types.SimpleNamespace(x=got.x[keep], n_iterations=got.n_iterations[keep]),
                types.SimpleNamespace(x=ref.x[keep], n_iterations=ref.n_iterations[keep]),
                torch.float32)
