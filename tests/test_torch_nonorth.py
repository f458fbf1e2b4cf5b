"""The port's non-orthogonal geometry and operators against the JAX package
on the sheared cube of tests/test_nonorth.py (x += s·y: a skew-free lattice,
so still the DIA layout, but non-orthogonal), on CPU in float64 with the
same seeded fields given to both (rel 1e-12):

  * MeshGeometry.kvec and the stabilised delta coefficients nodc;
  * fvc.non_orth_correction (scalar and vector ψ, corrected and limited 0.5),
    fvc.sn_grad_corrected and fvc.dot_sf;
  * fvm.laplacian with the deferred correction (corr=) and its matrix;
  * FvMatrix.add_sp, residual_norm and fvm.ddt_scalar.

A linear field's corrected snGrad is exact on the sheared mesh, in the port
as in the JAX package. And the divergence of a corrected laplacian's flux
balances its matrix only with the correction's face flux added, as the
port's p_rgh flux adds it and the JAX package's does not (ROADMAP R3)."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from firefoam_tpu.io import parse_string as jparse
from firefoam_tpu.mesh import block_mesh as jblock
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_tpu.ops import SurfaceField as JSF
from firefoam_tpu.ops import VolField as JVF
from firefoam_tpu.ops import fvc as jfvc
from firefoam_tpu.ops import fvm as jfvm
from firefoam_torch.io import parse_string as tparse
from firefoam_torch.mesh import block_mesh as tblock
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.ops import SurfaceField as TSF
from firefoam_torch.ops import VolField as TVF
from firefoam_torch.ops import fvc as tfvc
from firefoam_torch.ops import fvm as tfvm

torch.set_num_threads(1)
TOL = 1e-12
N = (6, 6, 6)
SHEAR = 0.3
_DICT = f"""
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0)
           (0 0 1) (1 0 1) (1 1 1) (0 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) ({N[0]} {N[1]} {N[2]}) simpleGrading (1 1 1) );
edges ();
boundary (
    left  {{ type patch; faces ( (0 4 7 3) ); }}
    right {{ type patch; faces ( (1 2 6 5) ); }}
    walls {{ type wall; faces ( (0 1 5 4) (3 7 6 2) (0 3 2 1) (4 5 6 7) ); }}
);
"""


def _sheared(parse, block, shear):
    mesh = block(parse(_DICT))
    if shear:
        pts = np.array(mesh.points)
        pts[:, 0] += shear * pts[:, 1]
        mesh = dataclasses.replace(mesh, points=pts, _geom=None)
    return mesh


def _rel(a, b):
    a = np.asarray(a.numpy() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)) if b.size else 0.0


@pytest.fixture(scope="module", params=[0.0, SHEAR], ids=["orthogonal", "sheared"])
def geoms(request):
    jg = JGeom.from_polymesh(_sheared(jparse, jblock, request.param), dtype=jnp.float64)
    tg = TGeom.from_polymesh(_sheared(tparse, tblock, request.param), dtype=torch.float64,
                             device="cpu")
    return request.param, jg, tg


def _fields(g, seed):
    rng = np.random.RandomState(seed)
    nC, nB, nI = g.n_cells, g.n_boundary, g.n_internal
    mask = np.asarray(g.face_mask)
    return dict(
        s=(rng.rand(nC) + 0.5, rng.rand(nB) + 0.5),
        u=(rng.randn(nC, 3), rng.randn(nB, 3)),
        gam=(rng.rand(nI) * mask + 0.1, rng.rand(nB) + 0.1),
        gic=-rng.rand(nB), gbc=rng.randn(nB), gic3=-rng.rand(nB, 3), gbc3=rng.randn(nB, 3),
        sp=rng.rand(nC), sv=(rng.randn(nI, 3) * mask[:, None], rng.randn(nB, 3)),
    )


def _both(pair):
    return (JVF(jnp.asarray(pair[0]), jnp.asarray(pair[1])),
            TVF(torch.as_tensor(pair[0]), torch.as_tensor(pair[1])))


def test_kvec_and_delta_coefficients_match(geoms):
    shear, jg, tg = geoms
    assert tg.offsets == jg.offsets
    assert _rel(tg.nodc, jg.nodc) <= TOL and _rel(tg.b_nodc, jg.b_nodc) <= TOL
    k = tg.kvec().numpy()
    assert np.max(np.abs(k - np.asarray(jg.kvec()))) <= 1e-14
    if shear:
        assert np.max(np.abs(k)) > 0.1  # non-orthogonal faces
    else:
        assert np.max(np.abs(k)) < 1e-12


@pytest.mark.parametrize("limiter", [None, 0.5])
def test_non_orth_correction_and_corrected_sn_grad_match(geoms, limiter):
    _, jg, tg = geoms
    f = _fields(jg, 1)
    for key in ("s", "u"):
        jpsi, tpsi = _both(f[key])
        jc = jfvc.non_orth_correction(jg, jpsi, limiter=limiter)
        tc = tfvc.non_orth_correction(tg, tpsi, limiter=limiter)
        assert _rel(tc, jc) <= TOL or float(np.max(np.abs(np.asarray(jc)))) < 1e-14, key
        jsg = jfvc.sn_grad_corrected(jg, jpsi, limiter=limiter)
        tsg = tfvc.sn_grad_corrected(tg, tpsi, limiter=limiter)
        assert _rel(tsg.i, jsg.i) <= TOL and _rel(tsg.b, jsg.b) <= TOL, key
    jsv = JSF(*(jnp.asarray(a) for a in f["sv"]))
    tsv = TSF(*(torch.as_tensor(a) for a in f["sv"]))
    jd, td = jfvc.dot_sf(jg, jsv), tfvc.dot_sf(tg, tsv)
    assert _rel(td.i, jd.i) <= TOL and _rel(td.b, jd.b) <= TOL


def test_corrected_sn_grad_of_a_linear_field_is_exact(geoms):
    shear, _, tg = geoms
    a = torch.tensor([1.0, 2.0, -0.5], dtype=torch.float64)
    psi = TVF(tg.C @ a, tg.b_Cf @ a)
    sg = tfvc.sn_grad_corrected(tg, psi).i
    exact = (tg.Sf @ a) / torch.clamp(tg.magSf, min=1e-300)
    real = tg.face_mask > 0
    assert float(torch.max(torch.abs(sg - exact)[real])) < 1e-10
    uncorrected = tfvc.sn_grad(tg, psi).i
    if shear:
        assert float(torch.max(torch.abs(uncorrected - exact)[real])) > 1e-2


@pytest.mark.parametrize("limiter", [None, 0.5])
def test_corrected_laplacian_matrix_matches(geoms, limiter):
    _, jg, tg = geoms
    f = _fields(jg, 2)
    jgam = JSF(*(jnp.asarray(a) for a in f["gam"]))
    tgam = TSF(*(torch.as_tensor(a) for a in f["gam"]))
    for key, gic, gbc in (("s", "gic", "gbc"), ("u", "gic3", "gbc3")):
        jpsi, tpsi = _both(f[key])
        jm = jfvm.laplacian(jg, jgam, jpsi, jnp.asarray(f[gic]), jnp.asarray(f[gbc]),
                            corr=jfvc.non_orth_correction(jg, jpsi, limiter=limiter))
        tm = tfvm.laplacian(tg, tgam, tpsi, torch.as_tensor(f[gic]), torch.as_tensor(f[gbc]),
                            corr=tfvc.non_orth_correction(tg, tpsi, limiter=limiter))
        for name in ("diag", "lower", "upper", "source", "internal_coeffs", "boundary_coeffs"):
            assert _rel(getattr(tm, name), getattr(jm, name)) <= TOL, (key, name)
        # the uncorrected laplacian takes deltaCoeffs, the corrected nodc
        tu = tfvm.laplacian(tg, tgam, tpsi, torch.as_tensor(f[gic]), torch.as_tensor(f[gbc]))
        assert _rel(tu.upper, jfvm.laplacian(jg, jgam, jpsi, jnp.asarray(f[gic]),
                                             jnp.asarray(f[gbc])).upper) <= TOL


def test_add_sp_residual_norm_and_ddt_scalar_match(geoms):
    _, jg, tg = geoms
    f = _fields(jg, 3)
    jpsi, tpsi = _both(f["s"])
    jgam = JSF(*(jnp.asarray(a) for a in f["gam"]))
    tgam = TSF(*(torch.as_tensor(a) for a in f["gam"]))
    jm = (jfvm.ddt_scalar(jg, jpsi, jpsi.i * 0.9, 0.01)
          - jfvm.laplacian(jg, jgam, jpsi, jnp.asarray(f["gic"]), jnp.asarray(f["gbc"])))
    tm = (tfvm.ddt_scalar(tg, tpsi, tpsi.i * 0.9, 0.01)
          - tfvm.laplacian(tg, tgam, tpsi, torch.as_tensor(f["gic"]), torch.as_tensor(f["gbc"])))
    jm = jm.add_sp(jnp.asarray(f["sp"]))
    tm = tm.add_sp(torch.as_tensor(f["sp"]))
    for name in ("diag", "source"):
        assert _rel(getattr(tm, name), getattr(jm, name)) <= TOL, name
    x = np.random.RandomState(4).rand(jg.n_cells)
    assert _rel(tm.residual_norm(torch.as_tensor(x)), jm.residual_norm(jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("limiter", [None, 0.5])
def test_flux_balances_the_corrected_laplacian_with_the_face_correction(geoms, limiter):
    """Reference fault R3: the divergence of a laplacian matrix's flux must
    equal the matrix's residual A·ψ − b, which is what makes the p_rgh
    flux conservative. FvMatrix.flux() alone (the JAX package's p_rgh flux)
    misses the deferred correction on a non-orthogonal mesh; with Γ_f|Sf|·corr
    added, as the port's p_rgh flux is built, the balance holds."""
    shear, jg, tg = geoms
    f = _fields(jg, 5)
    jpsi, tpsi = _both(f["s"])
    jgam = JSF(*(jnp.asarray(a) for a in f["gam"]))
    tgam = TSF(*(torch.as_tensor(a) for a in f["gam"]))
    tc = tfvc.non_orth_correction(tg, tpsi, limiter=limiter)
    tm = tfvm.laplacian(tg, tgam, tpsi, torch.as_tensor(f["gic"]), torch.as_tensor(f["gbc"]),
                        corr=tc)
    jm = jfvm.laplacian(jg, jgam, jpsi, jnp.asarray(f["gic"]), jnp.asarray(f["gbc"]),
                        corr=jfvc.non_orth_correction(jg, jpsi, limiter=limiter))
    residual = tm.matvec(tpsi.i, tm.diag_total()) - tm.rhs_total()
    jflux = jm.flux()
    bare = tg.surface_sum(torch.as_tensor(np.asarray(jflux.i)), torch.as_tensor(np.asarray(jflux.b)))
    flux = tm.flux()
    full = tg.surface_sum(flux.i + tgam.i * tg.magSf * tc, flux.b)
    scale = float(torch.max(torch.abs(residual)))
    assert float(torch.max(torch.abs(full - residual))) <= 1e-12 * scale
    if shear:
        assert float(torch.max(torch.abs(bare - residual))) > 1e-2 * scale
    else:
        assert float(torch.max(torch.abs(bare - residual))) <= 1e-12 * scale
