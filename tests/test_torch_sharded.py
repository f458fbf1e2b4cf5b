"""The port's rank-side partition primitives against the JAX package's, on
the CPU in float64 over gloo (firefoam_torch/parallel/sharded.py,
sharded_gmg.py, parcels.py; one process per rank through
parallel.comm.launch, with a deadline).

The JAX side runs under shard_map on the test process's 8 virtual CPU
devices (tests/conftest.py). Held:

  * the halo values at P = 8 (tests/test_parallel.py::test_halo_exchange_values);
  * sharded_pcg at P ∈ {2, 4, 8} against the JAX make_sharded_solver on
    the same system: x to 1e-12 of its largest entry and equal iterations
    (test_parallel.py:75-103), and both against a dense solve;
  * partition-count invariance (test_parallel.py:105);
  * the parcel exchange conserving count, mass and tags, every moved parcel
    on its destination rank (test_parallel.py:170), and the JAX exchange's
    slots bit for bit;
  * _matvec3_slab rebuilding the global matvec from the SEG-local faces
    through the slab maps (test_spmd_gmg.py::test_slab_face_maps_rebuild_matvec);
  * sharded_gmg_pcg against the JAX one on test_sharded_gmg.py's dims: x to
    1e-12 of its largest entry and equal iterations.

Each P runs its cases in ONE launch (parallel.comm.rank_calls).
"""

import numpy as np
import pytest
import torch

from firefoam_torch.parallel import comm as tcomm
from firefoam_torch.parallel import parcels as tparcels
from firefoam_torch.parallel import sharded as tsharded
from firefoam_torch.parallel import sharded_gmg as tsgmg
from firefoam_torch.parallel.partition import MeshPartition

torch.set_num_threads(1)
DEADLINE = 120.0
GMG_DIMS = [(24, 16, 16), (20, 12, 8)]


def _box_graph(nx, ny, nz):
    """Structured box: centroids, owner/neighbour, boundary owner cells
    (tests/test_parallel.py's _box_graph)."""
    idx = lambda i, j, k: (k * ny + j) * nx + i  # noqa: E731
    C = np.array([[i + 0.5, j + 0.5, k + 0.5]
                  for k in range(nz) for j in range(ny) for i in range(nx)])
    own, nei = [], []
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                c = idx(i, j, k)
                if i + 1 < nx:
                    own.append(c)
                    nei.append(idx(i + 1, j, k))
                if j + 1 < ny:
                    own.append(c)
                    nei.append(idx(i, j + 1, k))
                if k + 1 < nz:
                    own.append(c)
                    nei.append(idx(i, j, k + 1))
    b_own = []
    for k in range(nz):
        for j in range(ny):
            b_own += [idx(0, j, k), idx(nx - 1, j, k)]
    return C, np.array(own), np.array(nei), np.array(b_own)


def _spd_system(own, nei, nC, seed=0):
    rng = np.random.RandomState(seed)
    w = -(0.5 + rng.rand(len(own)))
    diag = -(np.bincount(own, w, minlength=nC) + np.bincount(nei, w, minlength=nC)) \
        + 0.05 * (1 + rng.rand(nC))
    return diag, w, w, rng.randn(nC)


def _poisson3(nx, ny, nz, seed=0, shift=0.03):
    rng = np.random.RandomState(seed)
    nC = nx * ny * nz
    u = np.zeros((3, nC))
    idx = np.arange(nC)
    i, j, k = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    for s, msk in enumerate([(i < nx - 1), (j < ny - 1), (k < nz - 1)]):
        u[s] = -(1.0 + 0.2 * rng.rand(nC)) * msk
    d = np.zeros(nC)
    for s, off in enumerate((1, nx, nx * ny)):
        d -= u[s]
        d[off:] -= u[s][:-off]
    d += shift + 0.1 * rng.rand(nC)
    return d, u


SOLVE = _box_graph(8, 6, 5)
INVAR = _box_graph(6, 5, 4)
HALO = _box_graph(6, 6, 3)


def _parcels(n_parts=8, cap=32):
    rng = np.random.RandomState(1)
    alive = rng.rand(n_parts, cap) < 0.5
    dest = np.where(rng.rand(n_parts, cap) < 0.4, rng.randint(0, n_parts, (n_parts, cap)), -1)
    dest = np.where(alive, dest, -1).astype(np.int32)
    mass = rng.rand(n_parts, cap) * alive
    tag = ((np.arange(n_parts)[:, None] * cap + np.arange(cap)[None, :]) * alive).astype(np.float64)
    return alive, dest, mass, tag


def _slab_case(tmp):
    from firefoam_torch.mesh import build_case_mesh
    from firefoam_torch.ops.geometry import MeshGeometry
    from firefoam_torch.parallel.localize import Localizer
    from firefoam_torch.utils.synthcase import write_box_fire_case

    cm = build_case_mesh(write_box_fire_case(str(tmp), n=(20, 12, 16)))
    gg = MeshGeometry.from_polymesh(cm.mesh, dtype=torch.float64, device="cpu", layout="seg")
    lz = Localizer.build(gg, cm, 8, method="slab")
    nI = cm.mesh.n_internal_faces
    own, nei = np.asarray(cm.mesh.owner[:nI]), np.asarray(cm.mesh.neighbour)
    rng = np.random.RandomState(0)
    up, lo = rng.rand(nI) - 2.0, rng.rand(nI) - 2.0
    dg, x = 6.0 + rng.rand(cm.mesh.n_cells), rng.randn(cm.mesh.n_cells)
    y_ref = dg * x
    np.add.at(y_ref, own, up * x[nei])
    np.add.at(y_ref, nei, lo * x[own])
    ixs, ups, los = [], [], []
    for p in range(8):
        maps = lz.slab_face_maps(p, own, nei)
        ixs.append(np.stack([maps[0], maps[1], maps[2]]))
        ups.append(np.concatenate([lz.ifaces(up)[p], [0.0]]))
        los.append(np.concatenate([lz.ifaces(lo)[p], [0.0]]))
    return lz, (np.stack(ixs), np.stack(ups), np.stack(los), dg, x, lz.slab_dims), y_ref


def _gmg_system(dims):
    d, u = _poisson3(*dims)
    b = np.random.RandomState(1).randn(d.shape[0])
    return d, u, b


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank-side case, one launch per P."""
    out = {}
    C, own, nei, b_own = SOLVE
    diag, lower, upper, b = _spd_system(own, nei, C.shape[0])
    Ci, owni, neii, b_owni = INVAR
    di, li, ui, bi = _spd_system(owni, neii, Ci.shape[0], seed=3)
    for P in (2, 4, 8):
        mp = MeshPartition.build(C, own, nei, P, b_own=b_own)
        mpi = MeshPartition.build(Ci, owni, neii, P, b_own=b_owni)
        calls = [(tsharded.rank_solve, (mp, diag, lower, upper, b, 1e-12, 2000)),
                 (tsharded.rank_solve, (mpi, di, li, ui, bi, 1e-13, 3000))]
        extra = {}
        if P == 8:
            Ch, ownh, neih, b_ownh = HALO
            mph = MeshPartition.build(Ch, ownh, neih, 8, b_own=b_ownh)
            xh = np.arange(Ch.shape[0], dtype=np.float64) + 7.0
            alive, dest, mass, tag = _parcels()
            lz, slab_args, y_ref = _slab_case(tmp_path_factory.mktemp("slab"))
            calls += [(tsharded.rank_halo, (mph, xh)),
                      (tparcels.rank_exchange, ({"mass": mass, "tag": tag}, alive, dest, 16)),
                      (tsgmg.rank_slab_matvec, slab_args)]
            for dims in GMG_DIMS:
                d, u, bg = _gmg_system(dims)
                calls.append((tsgmg.rank_gmg_solve, (dims, d, u, bg, 1e-10, 200)))
            extra = {"mph": mph, "xh": xh, "parcels": (alive, dest, mass, tag),
                     "slab_lz": lz, "y_ref": y_ref}
        res = tcomm.launch(tcomm.rank_calls, P, "gloo", "cpu", DEADLINE, (calls,))
        out[P] = {"mp": mp, "mpi": mpi, "res": res, **extra}
    return out


def _jax_solve(mp, diag, lower, upper, b, tol, max_iter):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from firefoam_tpu.parallel.sharded import make_sharded_solver

    mesh = Mesh(np.array(jax.devices()[:mp.n_parts]), ("cells",))
    solve = make_sharded_solver(mp, mesh, tol=tol, max_iter=max_iter)
    x_l, _, iters = solve(
        jnp.asarray(mp.scatter_cells(diag, pad=1.0)), jnp.asarray(mp.scatter_faces(lower)),
        jnp.asarray(mp.scatter_faces(upper)), jnp.asarray(mp.scatter_cells(b)),
        jnp.asarray(mp.scatter_cells(np.zeros(len(diag)))))
    return mp.gather_cells(np.asarray(x_l)), int(iters)


def _gathered(mp, res, k):
    return mp.gather_cells(np.stack([r[k][0] for r in res]))


def test_halo_exchange_values(runs):
    r = runs[8]
    mph, xh = r["mph"], r["xh"]
    for p in range(8):
        halo = r["res"][p][2]
        assert halo.shape == (mph.h_max,)
        for s, g in enumerate(mph.halo_g[p]):
            if g >= 0:
                assert halo[s] == xh[g], (p, s, g)


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_sharded_pcg_matches_jax(runs, n_parts):
    r = runs[n_parts]
    C, own, nei, _ = SOLVE
    nC = C.shape[0]
    diag, lower, upper, b = _spd_system(own, nei, nC)
    A = np.diag(diag)
    A[own, nei] += upper
    A[nei, own] += lower
    x_ref = np.linalg.solve(A, b)
    x = _gathered(r["mp"], r["res"], 0)
    iters = {res[0][2] for res in r["res"]}
    assert len(iters) == 1  # every rank stopped at the same iteration
    assert np.abs(x - x_ref).max() < 1e-8
    x_j, it_j = _jax_solve(r["mp"], diag, lower, upper, b, 1e-12, 2000)
    assert iters == {it_j}
    assert np.abs(x - x_j).max() <= 1e-12 * np.abs(x_j).max()
    rep = r["res"][0][0][3]["counts"]
    # one halo refresh per matvec (one ppermute per ring offset), three
    # psums per CG iteration (two dots and the residual sum)
    assert rep["ppermute"]["calls"] == (it_j + 2) * len(r["mp"].steps)
    assert rep["psum"]["calls"] == 3 * it_j + 4


def test_partition_count_invariance(runs):
    sols = [_gathered(runs[P]["mpi"], runs[P]["res"], 1) for P in (2, 4, 8)]
    for s in sols[1:]:
        assert np.allclose(sols[0], s, atol=1e-9)


def test_parcel_exchange_conserves(runs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as Ps

    from firefoam_tpu.parallel import exchange_parcels as j_exchange
    from firefoam_tpu.parallel.sharded import shard_map_compat

    r = runs[8]
    alive, dest, mass, tag = r["parcels"]
    n_parts, cap = alive.shape
    soa = [res[3][0] for res in r["res"]]
    out_alive = np.stack([res[3][1] for res in r["res"]])
    out_mass = np.stack([s["mass"] for s in soa])
    tags_out = np.stack([s["tag"] for s in soa])
    assert all(res[3][2] == 0 for res in r["res"])  # no overflow at cap_send 16
    assert out_alive.sum() == alive.sum()
    assert np.isclose((out_mass * out_alive).sum(), (mass * alive).sum())
    for p in range(n_parts):
        for s in range(cap):
            if out_alive[p, s] and tags_out[p, s] > 0:
                p0, s0 = divmod(int(round(tags_out[p, s])), cap)
                want = dest[p0, s0]
                if want >= 0 and want != p0:
                    assert p == want, (p, p0, s0, want)
    # the JAX exchange on the same parcels: the same slots, bit for bit
    mesh = Mesh(np.array(jax.devices()[:n_parts]), ("p",))

    def body(soa_j, a, d):
        s, a2, n_over = j_exchange({k: v[0] for k, v in soa_j.items()}, a[0], d[0],
                                   n_parts, 16, "p")
        return {k: v[None] for k, v in s.items()}, a2[None], n_over[None]

    spec = {"mass": Ps("p"), "tag": Ps("p")}
    js, ja, _ = jax.jit(shard_map_compat(body, mesh=mesh, in_specs=(spec, Ps("p"), Ps("p")),
                                         out_specs=(spec, Ps("p"), Ps())))(
        {"mass": jnp.asarray(mass), "tag": jnp.asarray(tag)}, jnp.asarray(alive),
        jnp.asarray(dest))
    assert np.array_equal(np.asarray(ja), out_alive)
    live = out_alive
    assert np.array_equal(np.asarray(js["tag"])[live], tags_out[live])
    assert np.array_equal(np.asarray(js["mass"])[live], out_mass[live])


def test_slab_matvec_rebuilds_global(runs):
    r = runs[8]
    y = np.concatenate([res[4].reshape(-1) for res in r["res"]])
    y_ref = r["y_ref"]
    assert np.abs(y - y_ref).max() < 1e-11 * np.abs(y_ref).max()


@pytest.mark.parametrize("k", range(len(GMG_DIMS)), ids=[str(d) for d in GMG_DIMS])
def test_sharded_gmg_matches_jax(runs, k):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as Ps

    from firefoam_tpu.parallel.sharded import shard_map_compat
    from firefoam_tpu.parallel.sharded_gmg import ShardedLatticeMG, sharded_gmg_pcg

    dims = GMG_DIMS[k]
    nx, ny, nz = dims
    d, u, b = _gmg_system(dims)
    res = [rr[5 + k] for rr in runs[8]["res"]]
    x = np.concatenate([r[0].reshape(-1) for r in res])
    iters = {r[2] for r in res}
    assert len(iters) == 1
    assert max(r[1] for r in res) < 1e-9

    mg = ShardedLatticeMG.build(dims, 8, axis_name="cells", n_coarsest_xy=16)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("cells",))
    to3 = lambda a: jnp.asarray(a).reshape(nz, ny, nx)  # noqa: E731

    def _solve(d3, ux, uy, uz, b3, x03):
        offd = {"u2": ux, "u1": uy, "u0": uz, "l2": ux, "l1": uy, "l0": uz}
        r = sharded_gmg_pcg(mg, d3, offd, b3, x03, tol=1e-10, max_iter=200)
        return r.x, r.n_iterations

    xj, itj = jax.jit(shard_map_compat(_solve, mesh=mesh, in_specs=(Ps("cells"),) * 6,
                                       out_specs=(Ps("cells"), Ps())))(
        to3(d), to3(u[0]), to3(u[1]), to3(u[2]), to3(b), jnp.zeros((nz, ny, nx)))
    xj = np.asarray(xj).reshape(-1)
    assert iters == {int(itj)}
    assert np.abs(x - xj).max() <= 1e-12 * np.abs(xj).max()
    rep = res[0][3]["counts"]
    assert rep["all_gather"]["calls"] > 0  # the coarsest level's gather


def test_nccl_needs_a_card_per_rank():
    with pytest.raises(ValueError, match="needs CUDA devices|one card per rank"):
        tcomm.launch(tcomm.rank_calls, 2, "nccl", "cpu", 10.0, ([],))
    with pytest.raises(ValueError, match="backend"):
        tcomm.launch(tcomm.rank_calls, 2, "mpi", "cpu", 10.0, ([],))


def test_a_failing_rank_fails_the_launch():
    assert tcomm.launch(tcomm.rank_probe, 3, "gloo", "cpu", DEADLINE) == [3, 3, 3]
    with pytest.raises(RuntimeError, match="(?s)failed.*rank 1 fails on purpose"):
        tcomm.launch(tcomm.rank_probe, 2, "gloo", "cpu", DEADLINE, (1, None))


def test_a_hanging_rank_fails_the_launch():
    with pytest.raises(TimeoutError, match="still running"):
        tcomm.launch(tcomm.rank_probe, 2, "gloo", "cpu", 8.0, (None, 1))


def test_partitioned_entry_points_take_the_card_by_default(monkeypatch):
    """Without a card the partitioned step and the contexts raise unless
    the caller names the CPU; launch has no default device."""
    from firefoam_torch.parallel.localize import LocalContext
    from firefoam_torch.parallel.spmd_step import SpmdFireFoam

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpmdFireFoam("no-case", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalContext.build_all(None, 2)
    with pytest.raises(TypeError, match="device"):
        tcomm.launch(tcomm.rank_probe, 2, "gloo")
