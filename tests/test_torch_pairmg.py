"""The index-pair multigrid (solvers/pairmg.py) against the JAX package's,
on the CPU in float64.

The graph is a near-lattice index graph (a 12 x 10 x 9 lattice with 3 % of
its faces dropped and 60 random long-range extras, a stand-in for a
castellated mesh's face graph), built here as tests/test_pairmg.py builds
it. Checked:
  * the static hierarchy (levels, lane offsets and valid slots, rest faces,
    every transition's plan) equal to JAX's PairMG.from_graph, and
    from_geom on the castellated fire's hybrid geometry equal to JAX's;
  * the Galerkin coarse operators against the dense PᵀAP (1e-12) and
    against JAX's prepare_parts (1e-12);
  * pairmg_pcg against JAX's: x within 1e-10 and equal iterations, with the
    smoothers' lumped level operator and without;
  * fewer iterations than the flat Jacobi-CG twin on the same system.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_torch.solvers.linear import pcg as t_pcg
from firefoam_torch.solvers.pairmg import PairMG as TPairMG
from firefoam_torch.solvers.pairmg import pairmg_pcg as t_pairmg_pcg
from firefoam_tpu.solvers.pairmg import PairMG as JPairMG
from firefoam_tpu.solvers.pairmg import pairmg_pcg as j_pairmg_pcg

torch.set_num_threads(1)
N_COARSEST = 64


def _near_lattice_graph(nx=12, ny=10, nz=9, seed=0, drop=0.03, extra=60):
    """Lattice faces with a few dropped and random long-range extras."""
    rng = np.random.RandomState(seed)
    n = nx * ny * nz
    own, nei = [], []
    for o in (1, nx, nx * ny):
        c = np.arange(n - o)
        if o == 1:
            c = c[(c + 1) % nx != 0]
        elif o == nx:
            c = c[(c // nx + 1) % ny != 0]
        keep = rng.rand(len(c)) > drop
        own.append(c[keep])
        nei.append(c[keep] + o)
    a = rng.randint(0, n - 1, extra)
    b = np.minimum(a + rng.randint(2, nx * ny + 7, extra), n - 1)
    ok = b > a
    own.append(a[ok])
    nei.append(b[ok])
    own = np.concatenate(own)
    nei = np.concatenate(nei)
    _, ix = np.unique(own * n + nei, return_index=True)
    return own[ix], nei[ix], n


def _dense(own, nei, w, diag, n):
    A = np.zeros((n, n))
    A[np.arange(n), np.arange(n)] = diag
    np.add.at(A, (own, nei), w)
    np.add.at(A, (nei, own), w)
    return A


def _pack(level0, own, nei, w, n):
    """Per-face weights in the level-0 (lanes, rest) layout."""
    d = nei - own
    lanes, used = [], np.zeros(len(own), bool)
    for o in level0.offsets:
        m = d == o
        arr = np.zeros(n)
        arr[own[m]] = w[m]
        lanes.append(arr)
        used |= m
    order = {(int(a), int(b)): i for i, (a, b) in enumerate(zip(level0.own_r, level0.nei_r))}
    rest = np.zeros(len(level0.own_r))
    for i in np.flatnonzero(~used):
        rest[order[(int(own[i]), int(nei[i]))]] = w[i]
    return lanes, rest


@pytest.fixture(scope="module")
def system():
    own, nei, n = _near_lattice_graph()
    rng = np.random.RandomState(1)
    w = -(0.5 + rng.rand(len(own)))
    diag = np.zeros(n)
    np.add.at(diag, own, -w)
    np.add.at(diag, nei, -w)
    diag += 0.05 + 0.1 * rng.rand(n)
    jm = JPairMG.from_graph(own, nei, n, n_coarsest=N_COARSEST)
    tm = TPairMG.from_graph(own, nei, n, n_coarsest=N_COARSEST)
    lanes, rest = _pack(tm.levels[0], own, nei, w, n)
    return dict(own=own, nei=nei, w=w, diag=diag, n=n, jm=jm, tm=tm, lanes=lanes, rest=rest)


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _hierarchies_equal(tm, jm):
    assert len(tm.levels) == len(jm.levels) and len(tm.transitions) == len(jm.transitions)
    for tl, jl in zip(tm.levels, jm.levels):
        assert tl.n == jl.n and tl.offsets == jl.offsets
        np.testing.assert_array_equal(tl.own_r, jl.own_r)
        np.testing.assert_array_equal(tl.nei_r, jl.nei_r)
        assert set(tl.lane_valid) == set(jl._lane_valid)
        for o, v in tl.lane_valid.items():
            np.testing.assert_array_equal(v, jl._lane_valid[o])
    for tt, jt in zip(tm.transitions, jm.transitions):
        assert (tt.op, tt.n, tt.n_pad, tt.nb, tt.nc, tt.n_cr) == \
            (jt.op, jt.n, jt.n_pad, jt.nb, jt.nc, jt.n_cr)
        assert tt.pieces == jt.pieces
        assert [k for k, _ in tt.gathers] == [k for k, _ in jt.gathers]
        for (_, a), (_, b) in zip(tt.gathers, jt.gathers):
            np.testing.assert_array_equal(_np(a), _np(b))
        for a, b in ((tt.src_d, jt.src_d), (tt.tgt_d, jt.tgt_d), (tt.src_r, jt.src_r),
                     (tt.inv_r, jt.inv_r)):
            np.testing.assert_array_equal(_np(a).reshape(-1), _np(b).reshape(-1))
        assert len(tt.lane_routes) == len(jt.lane_routes)
        for (s1, t1), (s2, t2) in zip(tt.lane_routes, jt.lane_routes):
            np.testing.assert_array_equal(_np(s1), _np(s2))
            np.testing.assert_array_equal(_np(t1), _np(t2))


def test_hierarchy_matches_jax(system):
    tm, jm = system["tm"], system["jm"]
    assert tm is not None and len(tm.transitions) >= 2
    _hierarchies_equal(tm, jm)
    # every lane's valid slots lie inside the level and hold a real coupling
    for lvl in tm.levels:
        for o, v in lvl.lane_valid.items():
            assert v.size and v.min() >= 0 and v.max() + o < lvl.n


def test_from_geom_matches_jax_on_the_castellated_mesh(tmp_path, monkeypatch):
    from firefoam_torch.mesh.case_mesh import build_case_mesh as t_mesh
    from firefoam_torch.ops.geometry import MeshGeometry as TGeom
    from firefoam_torch.utils.synthcase import write_castellated_fire_case
    from firefoam_tpu.mesh.case_mesh import build_case_mesh as j_mesh
    from firefoam_tpu.ops.geometry import MeshGeometry as JGeom

    monkeypatch.setenv("FIREFOAM_TPU_LATTICE_BC", "0")
    root = write_castellated_fire_case(str(tmp_path / "castel"), n=(16, 12, 16))
    tg = TGeom.from_polymesh(t_mesh(root).mesh, dtype=torch.float64, device="cpu",
                             layout="hybrid")
    jg = JGeom.from_polymesh(j_mesh(root).mesh, dtype=jnp.float64, layout="hybrid")
    tm, jm = TPairMG.from_geom(tg), JPairMG.from_geom(jg, n_coarsest=512)
    assert tm is not None and len(tm.levels) >= 3
    _hierarchies_equal(tm, jm)


def test_galerkin_coarse_operators(system):
    """Each coarse level equals the dense PᵀAP of the level above it (the
    index-pair aggregation, identity-padded) and JAX's prepare_parts."""
    s = system
    tm, jm, n = s["tm"], s["jm"], s["n"]
    mats, _, _ = tm.prepare_parts(torch.as_tensor(s["diag"]),
                                  [torch.as_tensor(v) for v in s["lanes"]],
                                  torch.as_tensor(s["rest"]))
    jmats, _, _ = jm.prepare_parts(jnp.asarray(s["diag"]), [jnp.asarray(v) for v in s["lanes"]],
                                   jnp.asarray(s["rest"]))
    for (d, lw, rw), (jd, jlw, jrw) in zip(mats, jmats):
        scale = max(np.abs(np.asarray(jd)).max(), 1.0)
        assert np.abs(d.numpy() - np.asarray(jd)).max() <= 1e-12 * scale
        for a, b in zip(lw, jlw):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-12 * scale
        assert np.abs(rw.numpy() - np.asarray(jrw)).max(initial=0.0) <= 1e-12 * scale
    A = _dense(s["own"], s["nei"], s["w"], s["diag"], n)
    for li, tr in enumerate(tm.transitions):
        c = np.arange(tr.n_pad)
        g = (c // (2 * tr.op)) * tr.op + (c % (2 * tr.op)) % tr.op
        P = np.zeros((tr.n_pad, tr.nc))
        P[c, g] = 1.0
        Ap = np.eye(tr.n_pad)
        Ap[: tr.n, : tr.n] = A
        ref = P.T @ Ap @ P
        d_c, lw_c, rw_c = (v.numpy() if torch.is_tensor(v) else [x.numpy() for x in v]
                           for v in mats[li + 1])
        lvl = tm.levels[li + 1]
        Ac = _dense(lvl.own_r, lvl.nei_r, rw_c, d_c, lvl.n)
        for wv, o in zip(lw_c, lvl.offsets):
            idx = np.arange(lvl.n - o)
            Ac[idx, idx + o] += wv[: lvl.n - o]
            Ac[idx + o, idx] += wv[: lvl.n - o]
        assert np.abs(Ac - ref).max() <= 1e-12 * np.abs(ref).max(), li
        A = ref


@pytest.mark.parametrize("lump", [True, False])
def test_pairmg_pcg_matches_jax(system, lump, monkeypatch):
    s = system
    n = s["n"]
    monkeypatch.setenv("FIREFOAM_TPU_PAIRMG_LUMP", "1" if lump else "0")
    tm = TPairMG.from_graph(s["own"], s["nei"], n, n_coarsest=N_COARSEST, lump=lump)
    b = np.random.RandomState(2).randn(n)
    A = _dense(s["own"], s["nei"], s["w"], s["diag"], n)
    upper = np.concatenate(s["lanes"] + [s["rest"]])
    At = torch.as_tensor(A)
    Aj = jnp.asarray(A)
    ours = t_pairmg_pcg(tm, lambda x: At @ x, torch.as_tensor(s["diag"]), torch.as_tensor(upper),
                        torch.as_tensor(b), torch.zeros(n, dtype=torch.float64), tol=1e-9,
                        max_iter=300)
    ref = j_pairmg_pcg(s["jm"], lambda x: Aj @ x, jnp.asarray(s["diag"]), jnp.asarray(upper),
                       jnp.asarray(b), jnp.zeros(n), tol=1e-9, max_iter=300)
    assert int(ours.n_iterations) == int(ref.n_iterations) > 0
    x, xr = ours.x.numpy(), np.asarray(ref.x)
    assert np.abs(x - xr).max() <= 1e-10 * np.abs(xr).max()
    assert abs(float(ours.final_residual) - float(ref.final_residual)) <= \
        1e-8 * float(ref.final_residual)


def test_pairmg_takes_fewer_iterations_than_the_flat_twin(system):
    s = system
    n = s["n"]
    A = torch.as_tensor(_dense(s["own"], s["nei"], s["w"], s["diag"], n))
    diag = torch.as_tensor(s["diag"])
    b = torch.as_tensor(np.random.RandomState(3).randn(n))
    x0 = torch.zeros(n, dtype=torch.float64)
    upper = torch.as_tensor(np.concatenate(s["lanes"] + [s["rest"]]))
    mg = t_pairmg_pcg(s["tm"], lambda x: A @ x, diag, upper, b, x0, tol=1e-9, max_iter=300)
    flat = t_pcg(lambda x: x @ A.T, x0, b, diag, tol=1e-9, max_iter=2000)
    assert 0 < 2 * int(mg.n_iterations) <= int(flat.n_iterations)
    rel = float((mg.x - flat.x).abs().max() / flat.x.abs().max())
    assert rel <= 1e-6
