"""The agglomeration multigrid of the port (firefoam_torch/solvers/amg.py)
against the JAX package's (firefoam_tpu/solvers/amg.py): the same numpy
inputs, made from a seed, through both, on the CPU in float64.

Tolerances (max-norm of the difference over the reference's max-abs): the
hierarchy's index maps equal; `_coarsen` and `prepare` (every level's diag,
lower, upper and eigenvalue bound, the dense coarsest matrix) 1e-12; one
V-cycle 1e-12; `amg_pcg`'s x 1e-10 with equal iteration counts. The meshes
are a lattice in LDU order and the same lattice in the port's padded DIA
face layout (pad slots are self-loops of weight 0, which the agglomeration
skips).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from firefoam_tpu.solvers import amg as jamg
from firefoam_torch.solvers import amg as tamg

torch.set_num_threads(1)


def _lattice(nx, ny, nz, seed=0, padded=False):
    rng = np.random.RandomState(seed)
    nC = nx * ny * nz
    idx = np.arange(nC)
    i, j, k = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    own, nei, real = [], [], []
    for off, mask in ((1, i < nx - 1), (nx, j < ny - 1), (nx * ny, k < nz - 1)):
        if padded:  # slot (o, c): the face c → c + off, or a self-loop
            own.append(idx)
            nei.append(np.where(mask, idx + off, idx))
            real.append(mask)
        else:
            own.append(idx[mask])
            nei.append(idx[mask] + off)
            real.append(np.ones(int(mask.sum()), bool))
    own, nei, real = np.concatenate(own), np.concatenate(nei), np.concatenate(real)
    area = (0.5 + rng.rand(len(own))) * real
    up = -(1.0 + 0.2 * rng.rand(len(own))) * real
    lo = up * (1.0 + 0.05 * rng.rand(len(own)))
    diag = np.full(nC, 0.05)
    np.add.at(diag, own, -up)
    np.add.at(diag, nei, -up)
    return own, nei, area, diag, lo, up, rng.randn(nC), nC


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module", params=["ldu", "padded-dia"])
def both(request):
    own, nei, area, diag, lo, up, b, nC = _lattice(12, 10, 8, padded=request.param == "padded-dia")
    jh = jamg.AMGHierarchy.build(own, nei, area, nC)
    th = tamg.AMGHierarchy.build(own, nei, area, nC)
    return jh, th, diag, lo, up, b, nC


def test_hierarchy_maps_equal(both):
    jh, th = both[:2]
    assert len(th.levels) == len(jh.levels) >= 4
    assert (th.n_cells0, th.n_coarsest) == (jh.n_cells0, jh.n_coarsest)
    np.testing.assert_array_equal(th.own0.numpy(), np.asarray(jh.own0))
    np.testing.assert_array_equal(th.nei0.numpy(), np.asarray(jh.nei0))
    for jl, tl in zip(jh.levels, th.levels):
        assert (tl.n_fine, tl.n_coarse, tl.n_cfaces) == (jl.n_fine, jl.n_coarse, jl.n_cfaces)
        for name in ("restrict", "face_coarse", "face_flip", "face_diag", "c_own", "c_nei"):
            np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
                                          err_msg=name)


def test_coarsen_and_prepare(both):
    jh, th, diag, lo, up, _, _ = both
    jmats, jA = jh.prepare(jnp.asarray(diag), jnp.asarray(lo), jnp.asarray(up))
    tmats, tA = th.prepare(_t(diag), _t(lo), _t(up))
    assert len(tmats) == len(jmats) == len(th.levels) + 1
    for lev, (jm, tm) in enumerate(zip(jmats, tmats)):
        for k in range(3):  # diag, lower, upper
            assert _rel(tm[k].numpy(), jm[k]) <= 1e-12, (lev, k)
        assert _rel(tm[4].numpy(), jm[5]) <= 1e-12, lev  # the eigenvalue bound
        np.testing.assert_array_equal(tm[3].own.numpy(), np.asarray(jm[3]))
        np.testing.assert_array_equal(tm[3].nei.numpy(), np.asarray(jm[4]))
    assert _rel(tA.numpy(), jA) <= 1e-12
    # one level on its own, from its fine coefficients
    jh.levels[0]._own_fine = jh.own0
    jd, jl, ju = jh._coarsen(jh.levels[0], jnp.asarray(diag), jnp.asarray(lo), jnp.asarray(up))
    td, tl, tu = th._coarsen(th.levels[0], _t(diag), _t(lo), _t(up))
    for a, b in ((td, jd), (tl, jl), (tu, ju)):
        assert _rel(a.numpy(), b) <= 1e-12
    # Galerkin: the coarse matvec of ones is the restricted fine matvec of ones
    d0, l0, u0, g0, _ = tmats[0]
    d1, l1, u1, g1, _ = tmats[1]
    fine = th._matvec(d0, l0, u0, g0, torch.ones_like(d0))
    coarse = th._matvec(d1, l1, u1, g1, torch.ones_like(d1))
    assert _rel(coarse.numpy(), th.levels[0].sum_cells(fine).numpy()) <= 1e-12


@pytest.mark.parametrize("smoother", ["chebyshev", "jacobi"])
def test_vcycle(both, smoother):
    jh, th, diag, lo, up, b, _ = both
    jh.smoother = th.smoother = smoother
    try:
        jmats, jA = jh.prepare(jnp.asarray(diag), jnp.asarray(lo), jnp.asarray(up))
        tmats, tA = th.prepare(_t(diag), _t(lo), _t(up))
        jz = jh.vcycle(jmats, jA, jnp.asarray(b))
        tz = th.vcycle(tmats, tA, _t(b))
        assert _rel(tz.numpy(), jz) <= 1e-12
        # factored once, as amg_pcg does: the same cycle
        tz2 = th.vcycle(tmats, th.factor(tA), _t(b))
        assert _rel(tz2.numpy(), jz) <= 1e-12
    finally:
        jh.smoother = th.smoother = "chebyshev"


def test_amg_pcg_matches_jax(both):
    jh, th, diag, lo, up, b, nC = both
    x0 = 0.1 * np.random.RandomState(4).randn(nC)
    for tol, rel_tol in ((1e-9, 0.0), (1e-6, 0.01)):
        jr = jamg.amg_pcg(jh, jnp.asarray(diag), jnp.asarray(up), jnp.asarray(up), jnp.asarray(b),
                          jnp.asarray(x0), tol=tol, rel_tol=rel_tol)
        tr = tamg.amg_pcg(th, _t(diag), _t(up), _t(up), _t(b), _t(x0), tol=tol, rel_tol=rel_tol)
        assert int(tr.n_iterations) == int(jr.n_iterations) > 0
        assert tr.n_iterations.dtype == torch.int32
        assert _rel(tr.x.numpy(), jr.x) <= 1e-10
        assert _rel(tr.initial_residual.numpy(), jr.initial_residual) <= 1e-10
    capped = tamg.amg_pcg(th, _t(diag), _t(up), _t(up), _t(b), _t(x0), tol=1e-12, max_iter=2)
    assert int(capped.n_iterations) == 2


def test_amg_float32_keeps_its_dtype():
    """The host-built float64 masks are cast at the point of use: a float32
    system stays float32 through the hierarchy, and the solve floors its
    tolerance at 100·eps."""
    own, nei, area, diag, lo, up, b, nC = _lattice(10, 8, 6, seed=2)
    th = tamg.AMGHierarchy.build(own, nei, area, nC)
    f = torch.float32
    mats, A = th.prepare(_t(diag).to(f), _t(up).to(f), _t(up).to(f))
    assert A.dtype == f and all(m[k].dtype == f for m in mats for k in (0, 1, 2, 4))
    r = tamg.amg_pcg(th, _t(diag).to(f), _t(up).to(f), _t(up).to(f), _t(b).to(f),
                     torch.zeros(nC, dtype=f), tol=1e-12)
    assert r.x.dtype == f and 0 < int(r.n_iterations) < 40
    r64 = tamg.amg_pcg(th, _t(diag), _t(up), _t(up), _t(b), torch.zeros(nC, dtype=torch.float64),
                       tol=1e-12)
    assert _rel(r.x.numpy(), r64.x.numpy()) <= 1e-3


def test_small_mesh_has_no_levels():
    """At most n_coarsest cells: no level, the V-cycle is the smoother."""
    own, nei, area, diag, lo, up, b, nC = _lattice(3, 3, 2, seed=3)
    jh = jamg.AMGHierarchy.build(own, nei, area, nC)
    th = tamg.AMGHierarchy.build(own, nei, area, nC)
    assert len(th.levels) == len(jh.levels) == 0 and th.n_coarsest == nC
    jr = jamg.amg_pcg(jh, jnp.asarray(diag), jnp.asarray(up), jnp.asarray(up), jnp.asarray(b),
                      jnp.zeros(nC), tol=1e-10)
    tr = tamg.amg_pcg(th, _t(diag), _t(up), _t(up), _t(b), torch.zeros(nC, dtype=torch.float64),
                      tol=1e-10)
    assert int(tr.n_iterations) == int(jr.n_iterations)
    assert _rel(tr.x.numpy(), jr.x) <= 1e-10
