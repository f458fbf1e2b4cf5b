"""The lattice multigrid of the port (firefoam_torch/solvers/gmg.py) against
the JAX package's (firefoam_tpu/solvers/gmg.py): the same numpy inputs, made
from a seed, through both, on the CPU.

float64 tolerances (max-norm of the difference over the reference's
max-abs): every level's matrices, eigenvalue bound and the coarsest inverse
of `prepare` 1e-12; one V-cycle 1e-12; `gmg_pcg`'s x 1e-10 with equal
iteration counts, on the four lattices of tests/test_gmg.py (even, odd, 2-D,
1-D). float32: equal iteration counts within 1 and x to 1e-4 (both floor the
tolerance at 100·eps and stop on a float32 residual).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from firefoam_tpu.solvers import gmg as jgmg
from firefoam_torch.solvers import gmg as tgmg

torch.set_num_threads(1)
LATTICES = [(16, 12, 8), (15, 9, 7), (64, 64, 1), (257, 1, 1)]


def _poisson(nx, ny, nz, seed=0, shift=0.05):
    """Random-coefficient lattice Poisson + ddt-like shift (the p_rgh matrix
    shape: SPD, diagonally dominant), flat DIA arrays; lower is upper scaled
    face by face, so that a swap of the two would show."""
    rng = np.random.RandomState(seed)
    nC = nx * ny * nz
    n_off = 3 if nz > 1 else (2 if ny > 1 else 1)
    offs = (1, nx, nx * ny)[:n_off]
    u = np.zeros((n_off, nC))
    idx = np.arange(nC)
    i, j, k = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    masks = [(i < nx - 1), (j < ny - 1), (k < nz - 1)]
    for s in range(n_off):
        u[s] = -(1.0 + 0.2 * rng.rand(nC)) * masks[s]
    d = np.zeros(nC)
    for s, off in enumerate(offs):
        d -= u[s]
        d[off:] -= u[s][:-off]
    d += shift + 0.1 * rng.rand(nC)
    return d, u.reshape(-1), offs, nC


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def test_lattice_dims():
    for offs, n in [((1, 30, 600), 9000), ((1, 30), 600), ((1,), 64), ((2, 30, 600), 9000),
                    ((1, 30, 599), 9000), ((1, 30, 600), 9001), ((), 10), ((1, 7, 21, 63), 126)]:
        assert tgmg.lattice_dims(offs, n) == jgmg.lattice_dims(offs, n), (offs, n)
    assert tgmg.lattice_dims((1, 30, 600), 9000) == (30, 20, 15)
    assert tgmg.lattice_dims((1, 30, 599), 9000) is None


@pytest.mark.parametrize("dims", LATTICES + [(50, 40, 50)])
def test_hierarchy_plan(dims):
    nC = dims[0] * dims[1] * dims[2]
    offs = (1, dims[0], dims[0] * dims[1])[: 3 if dims[2] > 1 else (2 if dims[1] > 1 else 1)]
    for n_coarsest in (64, 512):
        jm = jgmg.LatticeMG.build(offs, nC, n_coarsest)
        tm = tgmg.LatticeMG.build(offs, nC, n_coarsest)
        assert (tm is None) == (jm is None) == (nC <= n_coarsest)
        if tm is not None:
            assert (tm.dims, tm.shapes, tm.axes, tm.n_cells, tm.n_coarsest_max) == \
                (jm.dims, jm.shapes, jm.axes, jm.n_cells, jm.n_coarsest_max)
    assert tgmg.LatticeMG.build(offs, nC, nC) is None  # nothing to coarsen


@pytest.mark.parametrize("dims", LATTICES)
def test_prepare_and_vcycle(dims):
    d, u, offs, nC = _poisson(*dims)
    l = u * (1.0 + 0.05 * np.random.RandomState(7).rand(len(u)))
    jm = jgmg.LatticeMG.build(offs, nC, 64)
    tm = tgmg.LatticeMG.build(offs, nC, 64)
    jmats, jsm, jA = jm.prepare(jnp.asarray(d), jnp.asarray(u), jnp.asarray(l))
    tmats, tsm, tA = tm.prepare(_t(d), _t(u), _t(l))
    assert len(tmats) == len(jmats) == len(tm.shapes)
    for lev, ((jd, jod), (td, tod)) in enumerate(zip(jmats, tmats)):
        assert tuple(td.shape) == tuple(jd.shape) == tm.shapes[lev]
        assert _rel(td.numpy(), jd) <= 1e-12, lev
        for key in jod:
            assert _rel(tod[key].numpy(), jod[key]) <= 1e-12, (lev, key)
    for lev, (js, ts) in enumerate(zip(jsm, tsm)):
        assert _rel(ts.lmax.numpy(), js.lmax) <= 1e-12, lev
    assert _rel(tA.numpy(), jA) <= 1e-12
    # the inverse is one: A·A⁻¹ = I on the coarsest level
    r3 = np.random.RandomState(2).randn(*tm.shapes[0])
    jz = jm.vcycle(jmats, jsm, jA, jnp.asarray(r3))
    tz = tm.vcycle(tmats, tsm, tA, _t(r3))
    assert tuple(tz.shape) == tm.shapes[0]
    assert _rel(tz.numpy(), jz) <= 1e-12


@pytest.mark.parametrize("dims", LATTICES)
def test_gmg_pcg_matches_jax(dims):
    d, u, offs, nC = _poisson(*dims)
    b = np.random.RandomState(1).randn(nC)
    x0 = 0.1 * np.random.RandomState(3).randn(nC)
    jm = jgmg.LatticeMG.build(offs, nC, 64)
    tm = tgmg.LatticeMG.build(offs, nC, 64)
    for tol, rel_tol in ((1e-6, 0.01), (1e-10, 0.0)):
        jr = jgmg.gmg_pcg(jm, jnp.asarray(d), jnp.asarray(u), jnp.asarray(u), jnp.asarray(b),
                          jnp.asarray(x0), tol=tol, rel_tol=rel_tol)
        tr = tgmg.gmg_pcg(tm, _t(d), _t(u), _t(u), _t(b), _t(x0), tol=tol, rel_tol=rel_tol)
        assert int(tr.n_iterations) == int(jr.n_iterations) > 0
        assert tr.n_iterations.dtype == torch.int32
        assert _rel(tr.x.numpy(), jr.x) <= 1e-10
        assert _rel(tr.initial_residual.numpy(), jr.initial_residual) <= 1e-10
        assert _rel(tr.final_residual.numpy(), jr.final_residual) <= 1e-6
    # max_iter caps the count; a converged start takes no iteration
    capped = tgmg.gmg_pcg(tm, _t(d), _t(u), _t(u), _t(b), _t(x0), tol=1e-10, max_iter=3)
    assert int(capped.n_iterations) == 3
    again = tgmg.gmg_pcg(tm, _t(d), _t(u), _t(u), _t(b), tr.x, tol=1e-3)
    assert int(again.n_iterations) == 0 and torch.equal(again.x, tr.x)


def test_gmg_pcg_float32():
    d, u, offs, nC = _poisson(32, 24, 16)
    b = np.random.RandomState(3).randn(nC)
    f = jnp.float32
    jm = jgmg.LatticeMG.build(offs, nC, 64)
    tm = tgmg.LatticeMG.build(offs, nC, 64)
    jr = jgmg.gmg_pcg(jm, jnp.asarray(d, f), jnp.asarray(u, f), jnp.asarray(u, f),
                      jnp.asarray(b, f), jnp.zeros(nC, f), tol=1e-9)
    t32 = torch.float32
    tr = tgmg.gmg_pcg(tm, _t(d, t32), _t(u, t32), _t(u, t32), _t(b, t32),
                      torch.zeros(nC, dtype=t32), tol=1e-9)
    assert tr.x.dtype == t32 and tr.final_residual.dtype == t32
    # tol 1e-9 is below the float32 floor of 100·eps: both stop there
    assert abs(int(tr.n_iterations) - int(jr.n_iterations)) <= 1
    assert int(tr.n_iterations) <= 30
    assert _rel(tr.x.numpy(), jr.x) <= 1e-4
