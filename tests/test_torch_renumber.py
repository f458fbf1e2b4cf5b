"""RCM renumbering (firefoam_torch/mesh/renumber.py) and the banded DIA
layout of a renumbered castellated box, against the JAX package on the
CPU in float64.

The boxes are write_castellated_fire_case at n=(8,6,6) (378 cells: 68
offsets in its own numbering, too many for `banded`; 62 after RCM, the
shape of the reference singleBox: 83 offsets, 63 after RCM) and n=(4,4,6)
(134 cells: 31 offsets, 28 after RCM). Checked:
  * renumber_mesh's permutation, owners, neighbours and face vertices
    equal to the JAX package's, bit for bit;
  * the geometry assertions of tests/test_banded.py on the renumbered
    mesh: volumes permuted, owner < neighbour, Sf pointing owner→neighbour;
  * the raw (8,6,6) box refused under `banded` by both packages with the
    same message, and the renumbered one taken (reported as "dia");
  * the renumbered box's banded geometry equal to the JAX package's
    (offsets, face permutation, padded faces);
  * the Jacobi-CG twin (dia_krylov.dia_pcg on CPU tensors) on the
    renumbered box's diffusion system against the JAX package's fused
    whole-solve CG (pallas_cg.dia_pcg, interpret mode) and its flat CG on
    the SEG layout of the raw box, through the permutation: equal
    iterations (the inputs of tests/test_banded.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.mesh.renumber import rcm_order as j_rcm
from firefoam_tpu.mesh.renumber import renumber_mesh as j_renumber
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_tpu.ops import SurfaceField as JSF
from firefoam_tpu.ops import VolField as JVF
from firefoam_tpu.ops import fvm as jfvm
from firefoam_tpu.solvers import linear as jlin
from firefoam_tpu.solvers import pallas_cg
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.mesh.renumber import rcm_order as t_rcm
from firefoam_torch.mesh.renumber import renumber_mesh as t_renumber
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.ops import SurfaceField as TSF
from firefoam_torch.ops import VolField as TVF
from firefoam_torch.ops import fvm as tfvm
from firefoam_torch.solvers import dia_krylov
from firefoam_torch.utils.synthcase import write_castellated_fire_case

torch.set_num_threads(1)
# (n, offsets in the mesh's own numbering, after RCM)
BOXES = {"8x6x6": ((8, 6, 6), 68, 62), "4x4x6": ((4, 4, 6), 31, 28)}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _n_offsets(mesh):
    nI = mesh.n_internal_faces
    return len(np.unique(np.asarray(mesh.neighbour) - np.asarray(mesh.owner[:nI])))


@pytest.fixture(scope="module", params=list(BOXES))
def box(request, tmp_path_factory):
    n, raw, rcm = BOXES[request.param]
    root = write_castellated_fire_case(str(tmp_path_factory.mktemp(request.param)), n=n)
    return root, raw, rcm


@pytest.fixture(scope="module")
def big_box(tmp_path_factory):
    """The (8,6,6) box: raw and renumbered meshes of both packages."""
    root = write_castellated_fire_case(str(tmp_path_factory.mktemp("box")), n=BOXES["8x6x6"][0])
    tm, jm = t_build(root).mesh, j_build(root).mesh
    return tm, jm, t_renumber(tm), j_renumber(jm)


def test_renumber_matches_jax_bitwise(box):
    root, raw, rcm = box
    tm, jm = t_build(root).mesh, j_build(root).mesh
    nI = tm.n_internal_faces
    assert _n_offsets(tm) == _n_offsets(jm) == raw
    own, nei = np.asarray(tm.owner[:nI]), np.asarray(tm.neighbour)
    np.testing.assert_array_equal(t_rcm(own, nei, tm.n_cells), j_rcm(own, nei, jm.n_cells))
    (t2, tp), (j2, jp) = t_renumber(tm), j_renumber(jm)
    np.testing.assert_array_equal(tp, jp)
    for name in ("owner", "neighbour", "face_verts", "face_offsets", "points"):
        np.testing.assert_array_equal(np.asarray(getattr(t2, name)),
                                      np.asarray(getattr(j2, name)), err_msg=name)
    assert t2.n_cells == j2.n_cells == tm.n_cells
    assert [(p.name, p.start, p.n_faces) for p in t2.patches] == \
        [(p.name, p.start, p.n_faces) for p in j2.patches]
    assert _n_offsets(t2) == rcm
    # the renumbered geometry: the same cell volumes, centres and face areas
    for name in ("V", "C", "Sf"):
        np.testing.assert_array_equal(np.asarray(getattr(t2, name)),
                                      np.asarray(getattr(j2, name)), err_msg=name)


def test_renumber_preserves_geometry(big_box):
    """tests/test_banded.py's assertions on the port's renumbered mesh."""
    pm, _, (pm2, perm), _ = big_box
    V1, V2 = np.asarray(pm.V), np.asarray(pm2.V)
    np.testing.assert_allclose(np.sort(V1), np.sort(V2), rtol=1e-12)
    np.testing.assert_allclose(V1[perm], V2, rtol=1e-12)
    nI = pm2.n_internal_faces
    assert (np.asarray(pm2.owner[:nI]) < np.asarray(pm2.neighbour)).all()
    d = pm2.C[np.asarray(pm2.neighbour)] - pm2.C[np.asarray(pm2.owner[:nI])]
    assert (np.einsum("ij,ij->i", np.asarray(pm2.Sf[:nI]), d) > 0).all()
    # a face whose owner changed sides runs its vertices the other way round
    flipped = perm[np.asarray(pm2.owner[:nI])] != np.asarray(pm.owner[:nI])
    assert 0 < flipped.sum() < nI
    fo = np.asarray(pm.face_offsets)
    for f in np.nonzero(flipped)[0][:50]:
        s, e = fo[f], fo[f + 1]
        np.testing.assert_array_equal(pm2.face_verts[s:e], pm.face_verts[s:e][::-1])


def test_raw_box_refused_and_renumbered_box_taken(big_box):
    tm, jm, (t2, _), (j2, _) = big_box
    msg = "mesh is not DIA-compatible (offset stencil) — renumber first (mesh/renumber.py)"
    with pytest.raises(ValueError) as te:
        TGeom.from_polymesh(tm, dtype=torch.float64, device="cpu", layout="banded")
    with pytest.raises(ValueError) as je:
        JGeom.from_polymesh(jm, dtype=jnp.float64, layout="banded")
    assert str(te.value) == str(je.value) == msg
    tg = TGeom.from_polymesh(t2, dtype=torch.float64, device="cpu", layout="banded")
    jg = JGeom.from_polymesh(j2, dtype=jnp.float64, layout="banded")
    assert tg.layout == jg.layout == "dia"
    assert 3 < len(tg.offsets) == len(jg.offsets) == 62 <= 64
    # `dia` and `auto` keep the 16-offset cap in both packages
    with pytest.raises(ValueError, match="not DIA-compatible"):
        TGeom.from_polymesh(t2, dtype=torch.float64, device="cpu", layout="dia")
    with pytest.raises(ValueError, match="not DIA-compatible"):
        JGeom.from_polymesh(j2, dtype=jnp.float64, layout="dia")
    assert TGeom.from_polymesh(t2, dtype=torch.float64, device="cpu").layout == "seg"


def test_renumbered_banded_geometry_matches_jax(big_box):
    _, _, (t2, _), (j2, _) = big_box
    tg = TGeom.from_polymesh(t2, dtype=torch.float64, device="cpu", layout="banded")
    jg = JGeom.from_polymesh(j2, dtype=jnp.float64, layout="banded")
    assert tg.offsets == tuple(int(o) for o in jg.offsets)
    assert (tg.n_cells, tg.n_internal, tg.n_boundary) == (jg.n_cells, jg.n_internal,
                                                           jg.n_boundary)
    np.testing.assert_array_equal(tg.face_perm, np.asarray(jg.face_perm))
    for name in ("own", "nei", "b_own"):
        np.testing.assert_array_equal(_np(getattr(tg, name)), np.asarray(getattr(jg, name)))
    for name in ("face_mask", "w", "Sf", "magSf", "dc", "nodc", "Cf", "V", "C", "b_Sf",
                 "b_magSf", "b_dc", "b_nodc", "b_Cf"):
        np.testing.assert_array_equal(_np(getattr(tg, name)), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    # the lanes' gathers against the JAX package's rolls and shifts
    rng = np.random.RandomState(4)
    for shape in ((tg.n_cells,), (tg.n_cells, 3)):
        x = rng.randn(*shape)
        np.testing.assert_array_equal(_np(tg.gather_nei(torch.as_tensor(x))),
                                      np.asarray(jax.jit(jg.gather_nei)(jnp.asarray(x))))
        fv = rng.randn(tg.n_internal, *shape[1:]) * (
            _np(tg.face_mask) if len(shape) == 1 else _np(tg.face_mask)[:, None])
        for name in ("face_to_own_sum", "face_to_nei_sum"):
            got = _np(getattr(tg, name)(torch.as_tensor(fv)))
            ref = jax.jit(getattr(jg, name))(jnp.asarray(fv))
            np.testing.assert_allclose(got, np.asarray(ref),
                                       rtol=0, atol=1e-13, err_msg=name)


def _diffusion(g, fvm, SF, VF, xp, src):
    """tests/test_banded.py's system: unit-diffusivity Laplacian, Dirichlet-0
    walls, a source src·V; (diag, upper, lower, b)."""
    nC = g.n_cells
    kw = dict(dtype=g.dtype) if xp is jnp else dict(dtype=g.dtype, device="cpu")
    gamma = SF(xp.ones(g.n_internal, **kw) * g.face_mask, xp.ones(g.n_boundary, **kw))
    psi = VF(xp.zeros(nC, **kw), xp.zeros(g.n_boundary, **kw))
    m = fvm.laplacian(g, gamma, psi, -g.b_dc, xp.zeros_like(g.b_dc))
    diag = m.diag_total()
    return diag, m.upper, m.lower, m.rhs_total() + xp.asarray(src, **kw) * g.V


def test_banded_cg_twin_matches_jax_fused_and_seg(big_box):
    """The port's CG twin on the renumbered box's banded system against the
    JAX package's fused CG on the same system (interpret mode) and its flat
    CG on the raw box's SEG system: equal iterations, the solutions equal
    through the permutation."""
    tm, jm, (t2, perm), (j2, _) = big_box
    tg = TGeom.from_polymesh(t2, dtype=torch.float64, device="cpu", layout="banded")
    jb = JGeom.from_polymesh(j2, dtype=jnp.float64, layout="banded")
    js = JGeom.from_polymesh(jm, dtype=jnp.float64, layout="seg")
    nC = tg.n_cells
    src = np.random.RandomState(3).randn(nC)
    dT, uT, lT, bT = _diffusion(tg, tfvm, TSF, TVF, torch, src[perm])
    dB, uB, lB, bB = _diffusion(jb, jfvm, JSF, JVF, jnp, src[perm])
    dS, uS, lS, bS = _diffusion(js, jfvm, JSF, JVF, jnp, src)
    for a, b in ((dT, dB), (uT, uB), (lT, lB), (bT, bB)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-14, atol=1e-14)

    def mv_seg(x):
        return (dS * x + js.face_to_own_sum(uS * js.gather_nei(x))
                + js.face_to_nei_sum(lS * js.gather_own(x)))

    kw = dict(tol=1e-10, max_iter=2000)
    ref = jlin.pcg(mv_seg, jnp.zeros(nC), bS, dS, **kw)
    pal = pallas_cg.dia_pcg(dB, uB, lB, bB, jnp.zeros(nC), jb.offsets, nC, interpret=True, **kw)
    got = dia_krylov.dia_pcg(dT, uT, lT, bT, torch.zeros(nC, dtype=torch.float64),
                             tg.offsets, **kw)
    assert int(got.n_iterations) == int(pal.n_iterations) == int(ref.n_iterations) > 0
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x)[perm], rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(got.x), np.asarray(pal.x), rtol=0, atol=1e-10)
    assert float(got.initial_residual) == pytest.approx(float(ref.initial_residual), rel=1e-10)
