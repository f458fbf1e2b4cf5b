"""The OpenFOAM-exact solvers of the port (firefoam_torch/solvers/dic.py)
against the JAX package's (firefoam_tpu/solvers/dic.py): the same numpy
inputs, made from a seed, through both, on the CPU in float64.

Tolerances (max-norm of the difference over the reference's max-abs): the
schedule's arrays equal; `_calc_reciprocal_d`, `_dic_precondition`,
`_sgs_sweep` 1e-12; `dic_pcg` and `sgs_solve` x 1e-10 with equal iteration
counts, for nSweeps 1 and 2, through a storage permutation (`perm`), with
reversed faces (`swap`), and in a batch whose rows stop apart (the JAX side
as a `jax.vmap` of the solver).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.solvers import dic as jdic
from firefoam_torch.solvers import dic as tdic

torch.set_num_threads(1)


def _box_ldu(nx=6, ny=5, nz=4, seed=0):
    """Diffusion-like LDU system on a structured box (own < nei), faces in
    OpenFOAM's cell-by-cell order; lower differs from upper."""
    rng = np.random.RandomState(seed)
    n = nx * ny * nz
    cid = lambda i, j, k: (k * ny + j) * nx + i
    own, nei = [], []
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                for di, dj, dk in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
                    if i + di < nx and j + dj < ny and k + dk < nz:
                        own.append(cid(i, j, k))
                        nei.append(cid(i + di, j + dj, k + dk))
    own, nei = np.asarray(own, np.int32), np.asarray(nei, np.int32)
    up = -(0.5 + rng.rand(len(own)))
    lo = up * (1.0 + 0.1 * rng.rand(len(own)))
    diag = np.full(n, 0.1)
    np.add.at(diag, own, -up)
    np.add.at(diag, nei, -up)
    return own, nei, diag, lo, up, rng.randn(n), n


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _t(a):
    return torch.as_tensor(np.array(a))


def _jmv(own, nei, d, lo, up):
    oj, nj = jnp.asarray(own), jnp.asarray(nei)
    return lambda x: (d * x + jnp.zeros_like(x).at[oj].add(up * x[nj])
                      + jnp.zeros_like(x).at[nj].add(lo * x[oj]))


def _tmv(own, nei, d, lo, up):
    ot, nt = _t(own).long(), _t(nei).long()

    def mv(x):
        y = d * x
        y = y + torch.zeros_like(x).index_add_(-1, ot, up * x[..., nt])
        return y + torch.zeros_like(x).index_add_(-1, nt, lo * x[..., ot])

    return mv


def _schedules(own, nei, n, perm=None):
    return jdic.build_schedule(own, nei, n, perm=perm), tdic.build_schedule(own, nei, n, perm=perm)


@pytest.mark.parametrize("reverse", [False, True])
def test_build_schedule_arrays_equal(reverse):
    own, nei, _, _, _, _, n = _box_ldu()
    perm = np.random.RandomState(1).permutation(len(own))
    if reverse:  # some faces stored nei-first: the swap branch
        flip = np.random.RandomState(2).rand(len(own)) < 0.3
        own, nei = np.where(flip, nei, own), np.where(flip, own, nei)
    js, ts = _schedules(own, nei, n, perm)
    for name in ("own", "nei", "perm", "swap"):
        a, b = getattr(js, name), getattr(ts, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (ts.swap is not None) == reverse and ts.n_cells == js.n_cells == n
    for name in ("fwd_faces", "fwd_cells", "bwd_faces", "bwd_cells"):
        a, b = getattr(js, name), getattr(ts, name)
        assert len(a) == len(b) == 6 + 5 + 4 - 2, name  # nx + ny + nz − 2 levels
        for L, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(x, y, err_msg=f"{name}[{L}]")


def test_real_coeffs_perm_and_swap():
    own, nei, _, lo, up, _, n = _box_ldu(seed=3)
    flip = np.random.RandomState(2).rand(len(own)) < 0.3
    own2, nei2 = np.where(flip, nei, own), np.where(flip, own, nei)
    perm = np.random.RandomState(1).permutation(len(own))
    js, ts = _schedules(own2, nei2, n, perm)
    sl, su = np.zeros(len(own)), np.zeros(len(own))
    sl[perm], su[perm] = lo, up  # storage layout
    jl, ju = jdic.real_coeffs(js, jnp.asarray(sl), jnp.asarray(su))
    tl, tu = tdic.real_coeffs(ts, _t(sl), _t(su))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tu.numpy(), np.where(flip, lo, up))


def test_reciprocal_d_precondition_and_sweep():
    own, nei, diag, lo, up, b, n = _box_ldu(seed=1)
    js, ts = _schedules(own, nei, n)
    jrD = jdic._calc_reciprocal_d(js, jnp.asarray(diag), jnp.asarray(up))
    trD = tdic._calc_reciprocal_d(ts, _t(diag), _t(up))
    assert _rel(trD.numpy(), jrD) <= 1e-12
    r = np.random.RandomState(2).randn(n)
    jw = jdic._dic_precondition(js, jrD, jnp.asarray(up), jnp.asarray(r))
    tw = tdic._dic_precondition(ts, trD, _t(up), _t(r))
    assert _rel(tw.numpy(), jw) <= 1e-12
    jx = jdic._sgs_sweep(js, jnp.asarray(diag), jnp.asarray(lo), jnp.asarray(up),
                         jnp.asarray(b), jnp.asarray(r))
    tx = tdic._sgs_sweep(ts, _t(diag), _t(lo), _t(up), _t(b), _t(r))
    assert _rel(tx.numpy(), jx) <= 1e-12
    # a batch of rows with a matrix each equals the rows one by one
    ds = np.stack([diag, diag + 1.0])
    ups = np.stack([up, 0.5 * up])
    rs = np.stack([r, r[::-1]])
    tb = tdic._dic_precondition(ts, tdic._calc_reciprocal_d(ts, _t(ds), _t(ups)), _t(ups), _t(rs))
    for k in range(2):
        one = tdic._dic_precondition(
            ts, tdic._calc_reciprocal_d(ts, _t(ds[k]), _t(ups[k])), _t(ups[k]), _t(rs[k]))
        torch.testing.assert_close(tb[k], one, rtol=0, atol=0)


@pytest.mark.parametrize("stored", ["schedule-order", "permuted"])
def test_dic_pcg_matches_jax(stored):
    own, nei, diag, _, up, b, n = _box_ldu(seed=5)
    perm = np.random.RandomState(1).permutation(len(own)) if stored == "permuted" else None
    js, ts = _schedules(own, nei, n, perm)
    su = up.copy()
    if perm is not None:
        su = np.zeros(len(own))
        su[perm] = up
    x0 = 0.1 * np.random.RandomState(6).randn(n)
    for tol, rel_tol in ((1e-12, 0.0), (1e-6, 0.01)):
        jr = jdic.dic_pcg(js, _jmv(own, nei, jnp.asarray(diag), jnp.asarray(up), jnp.asarray(up)),
                          jnp.asarray(diag), jnp.asarray(su), jnp.asarray(b), jnp.asarray(x0),
                          tol=tol, rel_tol=rel_tol)
        tr = tdic.dic_pcg(ts, _tmv(own, nei, _t(diag), _t(up), _t(up)), _t(diag), _t(su), _t(b),
                          _t(x0), tol=tol, rel_tol=rel_tol)
        assert int(tr.n_iterations) == int(jr.n_iterations) > 0
        assert tr.x.shape == (n,) and tr.n_iterations.dtype == torch.int32
        assert _rel(tr.x.numpy(), jr.x) <= 1e-10
        assert _rel(tr.initial_residual.numpy(), jr.initial_residual) <= 1e-10
    capped = tdic.dic_pcg(ts, _tmv(own, nei, _t(diag), _t(up), _t(up)), _t(diag), _t(su), _t(b),
                          _t(x0), tol=1e-12, max_iter=4)
    assert int(capped.n_iterations) == 4


@pytest.mark.parametrize("n_sweeps", [1, 2])
def test_sgs_solve_matches_jax(n_sweeps):
    own, nei, diag, lo, up, b, n = _box_ldu(seed=6)
    diag = diag + 3.0  # ddt-dominated, like the Yi, h and k systems
    js, ts = _schedules(own, nei, n)
    for max_iter in (100, 5):
        jr = jdic.sgs_solve(js, _jmv(own, nei, jnp.asarray(diag), jnp.asarray(lo), jnp.asarray(up)),
                            jnp.asarray(diag), jnp.asarray(lo), jnp.asarray(up), jnp.asarray(b),
                            jnp.zeros(n), tol=1e-9, max_iter=max_iter, n_sweeps=n_sweeps)
        tr = tdic.sgs_solve(ts, _tmv(own, nei, _t(diag), _t(lo), _t(up)), _t(diag), _t(lo), _t(up),
                            _t(b), torch.zeros(n, dtype=torch.float64), tol=1e-9,
                            max_iter=max_iter, n_sweeps=n_sweeps)
        # counts sweeps; maxIter is the dictionary's own (the last round may
        # pass it by n_sweeps − 1)
        assert int(tr.n_iterations) == int(jr.n_iterations)
        assert int(tr.n_iterations) % n_sweeps == 0
        assert _rel(tr.x.numpy(), jr.x) <= 1e-10
        assert _rel(tr.final_residual.numpy(), jr.final_residual) <= 1e-6


@pytest.mark.parametrize("solver", ["sgs", "dic"])
def test_batch_rows_stop_apart(solver):
    """[B, nC] rows with a matrix each: every row stops at its own rule, as
    a jax.vmap of the JAX solver does."""
    own, nei, diag, lo, up, b, n = _box_ldu(seed=8)
    js, ts = _schedules(own, nei, n)
    ds = np.stack([diag + s for s in (0.5, 3.0, 30.0)])
    bs = np.stack([b, 2.0 * b, b[::-1]])
    if solver == "sgs":
        los, ups = np.stack([lo, 0.9 * lo, lo]), np.stack([up, 0.9 * up, up])
        jfn = lambda d, l, u, bb: jdic.sgs_solve(
            js, _jmv(own, nei, d, l, u), d, l, u, bb, jnp.zeros(n), tol=1e-9, max_iter=100)
        tr = tdic.sgs_solve(ts, _tmv(own, nei, _t(ds), _t(los), _t(ups)), _t(ds), _t(los), _t(ups),
                            _t(bs), torch.zeros((3, n), dtype=torch.float64), tol=1e-9,
                            max_iter=100)
    else:
        los = ups = np.stack([up, 0.9 * up, up])
        jfn = lambda d, l, u, bb: jdic.dic_pcg(
            js, _jmv(own, nei, d, u, u), d, u, bb, jnp.zeros(n), tol=1e-10)
        tr = tdic.dic_pcg(ts, _tmv(own, nei, _t(ds), _t(ups), _t(ups)), _t(ds), _t(ups), _t(bs),
                          torch.zeros((3, n), dtype=torch.float64), tol=1e-10)
    jr = jax.vmap(jfn)(jnp.asarray(ds), jnp.asarray(los), jnp.asarray(ups), jnp.asarray(bs))
    np.testing.assert_array_equal(tr.n_iterations.numpy(), np.asarray(jr.n_iterations))
    assert len(set(tr.n_iterations.tolist())) == 3  # the rows did stop apart
    assert tr.x.shape == (3, n)
    assert _rel(tr.x.numpy(), jr.x) <= 1e-10
    # one shared matrix, several right-hand sides (the U solve's shape)
    if solver == "sgs":
        sh = tdic.sgs_solve(ts, _tmv(own, nei, _t(ds[1]), _t(lo), _t(up)), _t(ds[1]), _t(lo),
                            _t(up), _t(bs), torch.zeros((3, n), dtype=torch.float64), tol=1e-9,
                            max_iter=100)
        one = tdic.sgs_solve(ts, _tmv(own, nei, _t(ds[1]), _t(lo), _t(up)), _t(ds[1]), _t(lo),
                             _t(up), _t(bs[2]), torch.zeros(n, dtype=torch.float64), tol=1e-9,
                             max_iter=100)
        assert int(sh.n_iterations[2]) == int(one.n_iterations)
        torch.testing.assert_close(sh.x[2], one.x, rtol=0, atol=1e-14)
