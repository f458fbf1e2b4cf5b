"""The port's whole-solve Krylov path (firefoam_torch/solvers/dia_krylov.py)
against the JAX package, on CPU in float64.

* The plain batched twins (the CPU path of dia_pcg / dia_bicgstab) against
  the JAX Pallas kernels run in interpret mode, on the random DIA box
  systems of tests/test_pallas_solvers.py.
* The same twins against jax.vmap over firefoam_tpu/solvers/linear.py:
  equal per-row iteration counts and x within 1e-12, for shared-matrix and
  per-row-matrix batches.
The kernels themselves are tested on the card in
tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.solvers import linear as jlinear
from firefoam_tpu.solvers import pallas_cg
from firefoam_torch.solvers import dia_krylov, linear

torch.set_num_threads(1)

NX, NY, NZ = 6, 5, 4
N = NX * NY * NZ
OFFS = (1, NX, NX * NY)


def _dia_system(seed=0, asym=0.0, rows=None, shift=0.1):
    """Random SPD (or mildly asymmetric) DIA system(s) on the box stencil,
    as numpy: (diag, upper, lower, b, x0); `rows` stacks that many
    independent systems; `shift` is the diagonal excess over the row's
    off-diagonal sum."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(rows or 1):
        K = len(OFFS)
        up = np.zeros(K * N)
        lo = np.zeros(K * N)
        for k, o in enumerate(OFFS):
            for c in range(N):
                i, j, kk = c % NX, (c // NX) % NY, c // (NX * NY)
                exists = (
                    (i + 1 < NX) if o == 1 else ((j + 1 < NY) if o == NX else (kk + 1 < NZ))
                )
                if exists:
                    v = -(0.5 + rng.rand())
                    up[k * N + c] = v
                    lo[k * N + c] = v * (1.0 + asym * rng.rand())
        diag = np.full(N, shift)
        for k, o in enumerate(OFFS):
            for c in range(N - o):
                diag[c] -= up[k * N + c]
                diag[c + o] -= lo[k * N + c]
        out.append((diag, up, lo, rng.randn(N), 0.1 * rng.randn(N)))
    if rows is None:
        return out[0]
    return tuple(np.stack(a) for a in zip(*out))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _jmv(diag, up, lo):
    """JAX DIA matvec identical to FvMatrix.matvec on this layout."""

    def mv(x):
        y = diag * x
        for k, o in enumerate(OFFS):
            u = up[k * N: (k + 1) * N]
            l_ = lo[k * N: (k + 1) * N]
            y = y + u * jnp.concatenate([x[o:], jnp.zeros(o, x.dtype)])
            lx = l_ * x
            y = y + jnp.concatenate([jnp.zeros(o, x.dtype), lx[: N - o]])
        return y

    return mv


def test_dia_matvec_matches_jax():
    d, up, lo, b, x0 = _dia_system(seed=7, asym=0.4)
    ref = np.asarray(_jmv(jnp.asarray(d), jnp.asarray(up), jnp.asarray(lo))(jnp.asarray(b)))
    got = dia_krylov.dia_matvec(_t(d), _t(up), _t(lo), OFFS, _t(b)[None])[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13)


# ------------------------------------------------- twins vs Pallas interpret
@pytest.mark.parametrize("x0_zero", [True, False])
def test_pcg_twin_matches_pallas(x0_zero):
    d, up, _, b, x0 = _dia_system(seed=1)
    if x0_zero:
        x0 = np.zeros(N)
    pal = pallas_cg.dia_pcg(
        jnp.asarray(d), jnp.asarray(up), jnp.asarray(up), jnp.asarray(b), jnp.asarray(x0),
        OFFS, N, tol=1e-10, max_iter=500, interpret=True,
    )
    got = dia_krylov.dia_pcg(_t(d), _t(up), _t(up), _t(b), _t(x0), OFFS, tol=1e-10, max_iter=500)
    assert float(np.max(np.abs(got.x.numpy() - np.asarray(pal.x)))) < 1e-8
    assert np.isclose(float(got.initial_residual), float(pal.initial_residual), rtol=1e-10)
    assert abs(int(got.n_iterations) - int(pal.n_iterations)) <= 2
    assert float(got.final_residual) < 1e-9


def test_bicgstab_twin_matches_pallas():
    d, up, lo, b, x0 = _dia_system(seed=4, asym=0.3)
    pal = pallas_cg.dia_bicgstab(
        jnp.asarray(d), jnp.asarray(up), jnp.asarray(lo), jnp.asarray(b), jnp.asarray(x0),
        OFFS, N, tol=1e-10, max_iter=500, interpret=True,
    )
    got = dia_krylov.dia_bicgstab(_t(d), _t(up), _t(lo), _t(b), _t(x0), OFFS, tol=1e-10, max_iter=500)
    assert float(np.max(np.abs(got.x.numpy() - np.asarray(pal.x)))) < 1e-8
    assert np.isclose(float(got.initial_residual), float(pal.initial_residual), rtol=1e-10)
    assert abs(int(got.n_iterations) - int(pal.n_iterations)) <= 2
    assert float(got.final_residual) < 1e-9


@pytest.mark.parametrize("name", ["pcg", "bicgstab"])
def test_batched_twin_matches_pallas(name):
    """A per-row batch: the Pallas kernel iterates until every row has
    converged and reports that max; the port freezes each row at its own
    stop and reports per-row counts (their max is compared)."""
    d, up, lo, b, x0 = _dia_system(seed=11, asym=0.0 if name == "pcg" else 0.3, rows=4)
    if name == "pcg":
        lo = up
    kern = getattr(pallas_cg, f"dia_{name}")
    pal = kern(*(jnp.asarray(a) for a in (d, up, lo, b, x0)), OFFS, N,
               tol=1e-10, max_iter=500, interpret=True)
    got = getattr(dia_krylov, f"dia_{name}")(*(_t(a) for a in (d, up, lo, b, x0)), OFFS,
                                             tol=1e-10, max_iter=500)
    assert float(np.max(np.abs(got.x.numpy() - np.asarray(pal.x)))) < 1e-8
    np.testing.assert_allclose(got.initial_residual.numpy(), np.asarray(pal.initial_residual),
                               rtol=1e-10)
    assert abs(int(got.n_iterations.max()) - int(pal.n_iterations)) <= 2


# ---------------------------------------------------- twins vs vmap(linear)
@pytest.mark.parametrize("name", ["pcg", "bicgstab"])
@pytest.mark.parametrize("shared", [True, False])
def test_batched_twin_matches_vmapped_linear(name, shared):
    """jax.vmap of linear.py's solvers freezes each row at its own stop:
    the port's twins must give the same per-row counts and solutions."""
    asym = 0.0 if name == "pcg" else 0.3
    # a well-conditioned system: x agrees to 1e-12, so roundoff in the
    # reductions (summed in another order than XLA's) must not be amplified
    d, up, lo, b, x0 = _dia_system(seed=21, asym=asym, rows=3, shift=1.0)
    if name == "pcg":
        lo = up
    if shared:
        # U-like batch: one off-diagonal set, a diagonal and RHS per row
        up, lo = up[0], lo[0]
        d = d[0][None] * (1.0 + 0.05 * np.arange(3))[:, None]
    jfn = getattr(jlinear, name)

    def one(dd, uu, ll, bb, xx):
        return jfn(_jmv(dd, uu, ll), xx, bb, dd, tol=1e-9, rel_tol=0.0, max_iter=300)

    axes = (0, None if shared else 0, None if shared else 0, 0, 0)
    ref = jax.vmap(one, in_axes=axes)(*(jnp.asarray(a) for a in (d, up, lo, b, x0)))
    got = getattr(dia_krylov, f"dia_{name}")(*(_t(a) for a in (d, up, lo, b, x0)), OFFS,
                                             tol=1e-9, max_iter=300)
    assert got.n_iterations.tolist() == np.asarray(ref.n_iterations).tolist()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.initial_residual.numpy(), np.asarray(ref.initial_residual),
                               rtol=1e-12)


def test_rows_freeze_at_their_own_stop():
    """relTol makes rows stop at different iterations: each keeps its own
    count, and its x equals that row solved alone."""
    d, up, lo, b, x0 = _dia_system(seed=31, asym=0.3, rows=3)
    b = b * np.array([1.0, 1e3, 1e-3])[:, None]
    got = dia_krylov.dia_bicgstab(*(_t(a) for a in (d, up, lo, b, x0)), OFFS,
                                  tol=1e-6, rel_tol=0.05, max_iter=200)
    for r in range(3):
        one = dia_krylov.dia_bicgstab(*(_t(a[r]) for a in (d, up, lo, b, x0)), OFFS,
                                      tol=1e-6, rel_tol=0.05, max_iter=200)
        assert int(one.n_iterations) == int(got.n_iterations[r])
        np.testing.assert_array_equal(one.x.numpy(), got.x[r].numpy())


# A 5-cell upwind chain (unit diagonal, A[c+1, c] = lower[c]) on which
# BiCGStab's rhat·v is exactly 0 at its second step, after no restart.
CHAIN_LOWER = np.array([2.0, 1.0, -1.0, 1.0, 0.0])
CHAIN_B = np.array([1.0, -2.0, 2.0, -1.0, 0.0])


def test_bicgstab_restarts_where_jax_breaks_down():
    """The JAX solver divides by the clamped rhat·v there and returns NaN;
    the port drops that step, restarts and solves the chain exactly. A
    second row that never breaks down keeps its own count."""
    n = CHAIN_B.size
    A = np.eye(n)
    A[np.arange(1, n), np.arange(n - 1)] = CHAIN_LOWER[:-1]
    ref = jlinear.bicgstab(lambda v: jnp.asarray(A) @ v, jnp.zeros(n), jnp.asarray(CHAIN_B),
                           jnp.ones(n), tol=1e-12, max_iter=50)
    assert not np.all(np.isfinite(np.asarray(ref.x)))
    b = np.stack([CHAIN_B, np.array([1.0, 0.5, 0.25, -1.0, 2.0])])
    got = dia_krylov.dia_bicgstab(_t(np.ones(n)), _t(np.zeros(n)), _t(CHAIN_LOWER), _t(b),
                                  _t(np.zeros((2, n))), (1,), tol=1e-12, max_iter=50)
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(A, b.T).T, rtol=0, atol=1e-12)
    assert float(got.final_residual.max()) < 1e-12
    one = dia_krylov.dia_bicgstab(*(_t(a) for a in (np.ones(n), np.zeros(n), CHAIN_LOWER, b[1],
                                                    np.zeros(n))), (1,), tol=1e-12, max_iter=50)
    assert int(one.n_iterations) == int(got.n_iterations[1])


def test_bicgstab_stops_a_row_whose_step_overflows():
    """float32, a right-hand side of 1e20: r·r overflows, so the first
    step's α is not finite. The JAX solver returns NaN; the port fails that
    row: it returns x0 and its initial residual, after 0 iterations, and
    the other row solves as it does alone."""
    n = CHAIN_B.size
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    b = np.stack([1e20 * np.abs(CHAIN_B) + 1e19, np.array([1.0, 0.5, 0.25, -1.0, 2.0])])
    ops = (np.ones(n), np.zeros(n), CHAIN_LOWER)
    ref = jlinear.bicgstab(lambda v: v + jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.asarray(
        CHAIN_LOWER[:-1], jnp.float32) * v[:-1]]), jnp.zeros(n, jnp.float32),
        jnp.asarray(b[0], jnp.float32), jnp.ones(n, jnp.float32), tol=1e-6, max_iter=50)
    assert not np.all(np.isfinite(np.asarray(ref.x)))
    got = dia_krylov.dia_bicgstab(*(f32(a) for a in ops), f32(b), f32(np.zeros((2, n))), (1,),
                                  tol=1e-6, max_iter=50)
    assert bool(torch.isfinite(got.x).all())
    assert torch.equal(got.x[0], torch.zeros(n)) and int(got.n_iterations[0]) == 0
    assert torch.equal(got.final_residual[0], got.initial_residual[0])
    one = dia_krylov.dia_bicgstab(*(f32(a) for a in ops), f32(b[1]), f32(np.zeros(n)), (1,),
                                  tol=1e-6, max_iter=50)
    assert torch.equal(got.x[1], one.x)
    assert int(got.n_iterations[1]) == int(one.n_iterations) > 0


def test_jacobi_smooth_matches_jax():
    d, up, lo, b, x0 = _dia_system(seed=5, asym=0.2)
    ref = jlinear.jacobi_smooth(_jmv(*(jnp.asarray(a) for a in (d, up, lo))),
                                jnp.asarray(x0), jnp.asarray(b), jnp.asarray(d),
                                tol=1e-8, max_iter=2000)
    got = linear.jacobi_smooth(
        lambda v: dia_krylov.dia_matvec(_t(d), _t(up), _t(lo), OFFS, v),
        _t(x0), _t(b), _t(d), tol=1e-8, max_iter=2000,
    )
    assert int(got.n_iterations) == int(ref.n_iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-12)


def test_non_cpu_non_cuda_tensor_raises():
    d, up, lo, b, x0 = (_t(a).to("meta") for a in _dia_system(seed=1))
    with pytest.raises(NotImplementedError):
        dia_krylov.dia_pcg(d, up, up, b, x0, OFFS)


# ------------------------------------------------------- 9-16 offsets
# a stencil of 12 offsets (the hybrid layout's lanes reach 9-16 on the
# castellated meshes), on 700 cells; a face where the neighbour exists
OFFS12 = (1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233)
N12 = 700


def _dia_system12(seed, asym):
    rng = np.random.RandomState(seed)
    K = len(OFFS12)
    up = np.zeros((K, N12))
    lo = np.zeros((K, N12))
    diag = np.full(N12, 0.1)
    for k, o in enumerate(OFFS12):
        v = -(0.5 + rng.rand(N12 - o))
        up[k, : N12 - o] = v
        lo[k, : N12 - o] = v * (1.0 + asym * rng.rand(N12 - o))
        diag[: N12 - o] -= up[k, : N12 - o]
        diag[o:] -= lo[k, : N12 - o]
    return diag, up.reshape(-1), lo.reshape(-1), rng.randn(N12), 0.1 * rng.randn(N12)


def _jmv12(diag, up, lo):
    """FvMatrix.matvec's DIA product on the 12 offsets, in JAX."""

    def mv(x):
        y = diag * x
        for k, o in enumerate(OFFS12):
            y = y + up[k * N12:(k + 1) * N12] * jnp.concatenate([x[o:], jnp.zeros(o, x.dtype)])
            lx = lo[k * N12:(k + 1) * N12] * x
            y = y + jnp.concatenate([jnp.zeros(o, x.dtype), lx[: N12 - o]])
        return y

    return mv


@pytest.mark.parametrize("name", ["pcg", "bicgstab", "smooth"])
def test_twins_take_12_offsets_and_match_jax(name):
    """dia_pcg/dia_bicgstab/dia_smooth on CPU tensors (their twins) accept
    a 12-offset stencil and match firefoam_tpu/solvers/linear.py's solvers
    with the same product: equal iterations, x within 1e-12."""
    d, up, lo, b, x0 = _dia_system12(seed=12, asym=0.0 if name == "pcg" else 0.3)
    jd, jup, jlo, jb, jx0 = (jnp.asarray(a) for a in (d, up, lo, b, x0))
    got = dia_krylov.dia_matvec(_t(d), _t(up), _t(lo), OFFS12, _t(b)[None])[0].numpy()
    np.testing.assert_allclose(got, np.asarray(_jmv12(jd, jup, jlo)(jb)), rtol=1e-13, atol=1e-13)
    if name == "smooth":
        # K3 counts sweeps: 800 sweeps are linear.jacobi_smooth's 200 rounds of 4
        ref = jlinear.jacobi_smooth(_jmv12(jd, jup, jlo), jx0, jb, jd, tol=1e-8, max_iter=200)
        res = dia_krylov.dia_smooth(*(_t(a) for a in (d, up, lo, b, x0)), OFFS12, tol=1e-8,
                                    max_iter=800)
    else:
        fn = getattr(jlinear, name)
        ref = fn(_jmv12(jd, jup, jlo), jx0, jb, jd, tol=1e-10, max_iter=1000)
        res = getattr(dia_krylov, f"dia_{name}")(*(_t(a) for a in (d, up, lo, b, x0)), OFFS12,
                                                 tol=1e-10, max_iter=1000)
    assert int(res.n_iterations) == int(ref.n_iterations) > 0
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-12)


def test_the_launcher_refuses_more_than_16_offsets():
    """The kernels take 1..64 offsets (kMaxOffsets, the banded layout's
    budget; 16 before it); the launcher refuses a 65th before it reaches
    the library."""
    offs = tuple(range(1, 66))
    n = N12
    ops = [torch.ones(n), torch.zeros(65 * n), torch.zeros(65 * n), torch.ones(n),
           torch.zeros(n)]
    with pytest.raises(ValueError, match=r"65 offsets \(1..64 supported\)"):
        dia_krylov._launch("pcg", *ops, offs, 1e-6, 0.0, 10)
