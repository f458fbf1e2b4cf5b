"""The SEG layout of the port's geometry (firefoam_torch/ops/geometry.py)
and the layout-aware solves (solvers/linear.py `ldu_matvec`, `solve_ldu`),
on the CPU in float64:

  * on the castellated fire's mesh (write_castellated_fire_case at
    n=(8,6,8): cells with up to 9 faces) against the JAX package's SEG
    geometry (layout="seg"): the arrays, every primitive on seeded inputs,
    the fvc/fvm operators of tests/test_torch_ops.py (grad, div with
    limitedLinear and LUST, the matrix pieces, the boundary conditions)
    and the non-orthogonal ones of tests/test_torch_nonorth.py (the
    corrected and limited laplacian and snGrad across the hanging-node
    faces), to 1e-12; the flat solvers on a SEG system with equal
    iteration counts;
  * the order-fixed sum tables: every face once, in ascending face order;
  * a DIA kernel given a SEG system raises;
  * on the box-fire lattice, the port's SEG geometry against its DIA
    geometry (after face_perm) to 1e-12, and the SEG step against the DIA
    step to 1e-9 with equal iteration counts.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_tpu.solvers import linear as jlin
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.solvers import dia_krylov
from firefoam_torch.solvers import linear as tlin
from firefoam_torch.utils.synthcase import write_box_fire_case, write_castellated_fire_case

# the operator tests of the lattice files, collected here on the SEG mesh
from test_torch_nonorth import (  # noqa: F401
    test_add_sp_residual_norm_and_ddt_scalar_match,
    test_corrected_laplacian_matrix_matches,
    test_flux_balances_the_corrected_laplacian_with_the_face_correction,
    test_kvec_and_delta_coefficients_match,
    test_non_orth_correction_and_corrected_sn_grad_match,
)
from test_torch_ops import (  # noqa: F401
    test_boundary_conditions_match,
    test_boundary_sum_groups_are_collision_free,
    test_fvc_operators_match,
    test_fvm_operators_and_matrix_match,
    test_geometry_primitives_match,
)

torch.set_num_threads(1)
TOL = 1e-12
N = (8, 6, 8)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)) if b.size else 0.0


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """(case root, JAX SEG geometry, the port's geometry) on the castellated
    mesh: the fixture tests/test_torch_ops.py's tests take."""
    root = write_castellated_fire_case(str(tmp_path_factory.mktemp("castel")), n=N)
    jg = JGeom.from_polymesh(j_build(root).mesh, dtype=jnp.float64, layout="seg")
    tg = TGeom.from_polymesh(t_build(root).mesh, dtype=torch.float64, device="cpu")
    return root, jg, tg


@pytest.fixture(scope="module")
def geoms(env):
    """The fixture tests/test_torch_nonorth.py's tests take: (non-orthogonal,
    JAX geometry, port geometry)."""
    return True, env[1], env[2]


def test_seg_geometry_arrays_match(env):
    _, jg, tg = env
    assert tg.layout == jg.layout == "seg"
    assert tg.offsets == jg.offsets == ()
    mesh = t_build(env[0]).mesh
    assert (tg.n_cells, tg.n_internal, tg.n_boundary) == (jg.n_cells, jg.n_internal, jg.n_boundary)
    assert tg.n_internal == mesh.n_internal_faces  # unpadded
    assert [(p.name, p.ptype, p.start, p.n) for p in tg.patches] == \
        [(p.name, p.ptype, p.start, p.n) for p in jg.patches]
    for name in ("own", "nei", "b_own"):
        np.testing.assert_array_equal(_np(getattr(tg, name)), np.asarray(getattr(jg, name)))
    for name in ("w", "Sf", "magSf", "dc", "nodc", "Cf", "face_mask", "V", "C", "b_Sf",
                 "b_magSf", "b_dc", "b_nodc", "b_Cf", "C_own_f", "C_nei_f", "d_face"):
        assert _rel(_np(getattr(tg, name)), getattr(jg, name)) == 0.0, name
    assert _rel(_np(tg.recon_inv), jg.recon_inv) <= TOL
    np.testing.assert_array_equal(tg.face_perm, np.arange(mesh.n_internal_faces))
    np.testing.assert_array_equal(tg.face_perm, jg.face_perm)
    faces = np.bincount(mesh.owner, minlength=mesh.n_cells) + np.bincount(
        mesh.neighbour, minlength=mesh.n_cells)
    assert faces.max() > 6


def test_seg_sum_tables_are_order_fixed(env):
    """Row c of each table lists the faces of cell c once each, in
    ascending face order, then the zero slot; the both-table lists the
    owned faces, then the neighbouring ones (offset by nI)."""
    _, _, tg = env
    nI = tg.n_internal
    own, nei = tg.own.numpy(), tg.nei.numpy()
    for table, ids, pad in ((tg.seg_own, own, nI), (tg.seg_nei, nei, nI),
                            (tg.seg_both, np.concatenate([own, nei]), 2 * nI)):
        t = table.table.numpy()
        assert t.shape[0] == tg.n_cells
        real = t[t != pad]
        assert sorted(real.tolist()) == list(range(len(ids)))
        for c in range(tg.n_cells):
            row = t[c][t[c] != pad]
            assert (np.diff(row) > 0).all() and (ids[row] == c).all()
            assert (t[c][len(row):] == pad).all()
    # the both-sum is the own-sum plus the nei-sum
    rng = np.random.RandomState(7)
    a, b = (torch.as_tensor(rng.randn(nI, 3)) for _ in range(2))
    both = tg.face_to_both_sum(a, b)
    assert torch.allclose(both, tg.face_to_own_sum(a) + tg.face_to_nei_sum(b), rtol=0,
                          atol=1e-13)


def _system(g, rng, rows=None):
    """A diagonally dominant asymmetric system on g's faces; rows: per-row
    coefficients [B, nI] and right-hand sides [B, nC]."""
    shape_f = (g.n_internal,) if rows is None else (rows, g.n_internal)
    shape_c = (g.n_cells,) if rows is None else (rows, g.n_cells)
    up = -rng.rand(*shape_f)
    lo = -rng.rand(*shape_f)
    own, nei = _np(g.own), _np(g.nei)
    s = np.zeros(shape_c)
    for a in (up, lo):
        for idx in (own, nei):
            np.add.at(s, (..., idx), np.abs(a))
    d = s + 0.1 + rng.rand(*shape_c)
    return d, up, lo, rng.randn(*shape_c), np.zeros(shape_c)


def test_ldu_matvec_matches_jax(env):
    """The SEG product of raw (diag, upper, lower), shared and per row,
    against the JAX package's segment-sum product."""
    _, jg, tg = env
    rng = np.random.RandomState(8)
    d, up, lo, _, _ = _system(tg, rng)
    x = rng.randn(tg.n_cells)

    def jmv(d, up, lo, x):
        return d * x + jg.face_to_both_sum(up * jg.gather_nei(x), lo * jg.gather_own(x))

    ref = jmv(*(jnp.asarray(a) for a in (d, up, lo, x)))
    got = tlin.ldu_matvec(tg, *(torch.as_tensor(a) for a in (d, up, lo)))(torch.as_tensor(x))
    assert _rel(got, ref) <= TOL
    # per-row coefficients and rows of x, as the fvDOM ray batch gives them
    d, up, lo, _, _ = _system(tg, rng, rows=3)
    X = rng.randn(3, tg.n_cells)
    got = tlin.ldu_matvec(tg, *(torch.as_tensor(a) for a in (d, up, lo)))(torch.as_tensor(X))
    for r in range(3):
        assert _rel(got[r], jmv(*(jnp.asarray(a[r]) for a in (d, up, lo, X)))) <= TOL


@pytest.mark.parametrize("solver", ["PCG", "PBiCGStab", "smoothSolver"])
def test_solve_ldu_on_seg_matches_the_flat_jax_solvers(env, solver):
    """solve_ldu on a SEG system runs the twin with the SEG product and the
    JAX package's flat budget (smoothSolver: max(maxIter, 200) rounds)."""
    _, jg, tg = env
    rng = np.random.RandomState(9)
    d, up, lo, b, x0 = _system(tg, rng)
    if solver == "PCG":
        lo = up  # symmetric
    jd, jup, jlo, jb, jx0 = (jnp.asarray(a) for a in (d, up, lo, b, x0))

    def jmv(x):
        return jd * x + jg.face_to_both_sum(jup * jg.gather_nei(x), jlo * jg.gather_own(x))

    # (the JAX function, its budget, the dictionary's maxIter given to solve_ldu)
    fn, mx, dict_mx = {"PCG": (jlin.pcg, 1000, 1000), "PBiCGStab": (jlin.bicgstab, 1000, 1000),
                       "smoothSolver": (jlin.jacobi_smooth, 200, 10)}[solver]
    ref = fn(jmv, jx0, jb, jd, tol=1e-9, rel_tol=0.0, max_iter=mx)
    got = tlin.solve_ldu(tg, solver, *(torch.as_tensor(a) for a in (d, up, lo, b, x0)),
                         tol=1e-9, rel_tol=0.0, max_iter=dict_mx)
    assert int(got.n_iterations) == int(ref.n_iterations) > 0
    assert _rel(got.x, ref.x) <= 1e-11
    assert abs(float(got.final_residual) - float(ref.final_residual)) <= 1e-12


def test_dia_kernels_refuse_a_seg_system(env):
    _, _, tg = env
    d, up, lo, b, x0 = (torch.as_tensor(a) for a in _system(tg, np.random.RandomState(10)))
    for fn in (dia_krylov.dia_pcg, dia_krylov.dia_bicgstab, dia_krylov.dia_smooth):
        with pytest.raises(ValueError, match="not a DIA system"):
            fn(d, up, lo, b, x0, tg.offsets)
    with pytest.raises(ValueError, match="not a DIA system"):
        dia_krylov.dia_matvec(d, up, lo, tg.offsets, x0)
    with pytest.raises(ValueError):
        TGeom.from_polymesh(t_build(env[0]).mesh, dtype=torch.float64, device="cpu",
                            layout="dia")


# ------------------------------------------------- SEG against DIA, lattice
@pytest.fixture(scope="module")
def lattice(tmp_path_factory):
    root = write_box_fire_case(str(tmp_path_factory.mktemp("box")), n=(6, 5, 7))
    mesh = t_build(root).mesh
    kw = dict(dtype=torch.float64, device="cpu")
    return root, TGeom.from_polymesh(mesh, **kw), TGeom.from_polymesh(mesh, layout="seg", **kw)


def test_seg_equals_dia_on_the_lattice(lattice):
    _, gd, gs = lattice
    assert gd.layout == "dia" and gs.layout == "seg"
    perm = torch.as_tensor(gd.face_perm)
    for name in ("own", "nei", "w", "Sf", "magSf", "dc", "nodc", "Cf", "C_own_f", "C_nei_f",
                 "d_face"):
        assert torch.equal(getattr(gd, name)[perm], getattr(gs, name)), name
    assert _rel(gd.recon_inv, gs.recon_inv) <= TOL
    rng = np.random.RandomState(11)
    for shape in ((gs.n_cells,), (gs.n_cells, 3)):
        x = torch.as_tensor(rng.randn(*shape))
        assert torch.equal(gd.gather_own(x)[perm], gs.gather_own(x))
        assert torch.equal(gd.gather_nei(x)[perm], gs.gather_nei(x))
        fv = torch.as_tensor(rng.randn(gs.n_internal, *shape[1:]))
        fd = torch.zeros((gd.n_internal,) + shape[1:], dtype=fv.dtype).index_copy(0, perm, fv)
        assert _rel(gs.face_to_own_sum(fv), gd.face_to_own_sum(fd)) <= TOL
        assert _rel(gs.face_to_nei_sum(fv), gd.face_to_nei_sum(fd)) <= TOL
        assert _rel(gs.cell_sum_internal(fv), gd.cell_sum_internal(fd)) <= TOL
    d, up, lo, _, _ = _system(gs, rng, rows=2)
    upd = np.zeros((2, gd.n_internal))
    lod = np.zeros((2, gd.n_internal))
    upd[:, gd.face_perm], lod[:, gd.face_perm] = up, lo
    X = torch.as_tensor(rng.randn(2, gs.n_cells))
    ys = tlin.ldu_matvec(gs, *(torch.as_tensor(a) for a in (d, up, lo)))(X)
    yd = tlin.ldu_matvec(gd, *(torch.as_tensor(a) for a in (d, upd, lod)))(X)
    assert _rel(ys, yd) <= TOL


@pytest.mark.parametrize("pins", [{}, dict(exact_solvers=False, gmg=False, amg=False)],
                         ids=["unpinned", "flat"])
def test_seg_step_equals_dia_step_on_the_lattice(lattice, pins):
    """Four steps from t = 0 (the first a radiation step): unpinned, the
    DIC-PCG on p_rgh; flat, the whole-solve kernels' twins on DIA against
    the same twins with the SEG product."""
    root = lattice[0]
    out = {}
    for layout in ("dia", "seg"):
        s = TSolver(root, device="cpu", dtype=torch.float64, layout=layout, **pins)
        assert s.geom.layout == layout
        st, logs = s.make_chunk(4)(s.initial_state())
        out[layout] = (s, st, logs)
    (sd, std, ld), (ss, sts, ls) = out["dia"], out["seg"]
    perm = torch.as_tensor(sd.geom.face_perm)
    for f in ("T", "U", "p_rgh", "Y", "k"):
        assert _rel(sts[f].i, std[f].i) <= 1e-9, f
    assert _rel(sts["phi"].i, std["phi"].i[perm]) <= 1e-9
    for k in ld:
        if k.endswith("_iters") or "iters_" in k:
            assert torch.equal(ls[k], ld[k]), k
