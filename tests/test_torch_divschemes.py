"""The port's filteredLinear2 / filteredLinear2V limiter and the div-scheme
selection against the JAX package, on CPU in float64 (rel 1e-12).

The limiter runs on the cases of tests/test_divschemes.py (a linear field,
k = 0, a staggered mode, a tent extremum) and on seeded random scalar and
vector fields, on the orthogonal and the sheared cube; the solvers of both
packages parse `div(phi,U) Gauss filteredLinear2V 0.2 0.05` (the wall-fire
case, as the pyrolysis1D and wallFireSpread2D reference cases write it)
into the same scheme and the same face weights."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from firefoam_tpu.io import parse_string as jparse
from firefoam_tpu.mesh import block_mesh as jblock
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_tpu.ops import VolField as JVF
from firefoam_tpu.ops import fvm as jfvm
from firefoam_torch.io import parse_string as tparse
from firefoam_torch.mesh import block_mesh as tblock
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.ops import VolField as TVF
from firefoam_torch.ops import fvm as tfvm
from firefoam_torch.utils.synthcase import write_wall_fire_case

torch.set_num_threads(1)
TOL = 1e-12


def _dict(n):
    return f"""
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0)
           (0 0 1) (1 0 1) (1 1 1) (0 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) ({n[0]} {n[1]} {n[2]}) simpleGrading (1 1 1) );
edges ();
boundary (
    left  {{ type patch; faces ( (0 4 7 3) ); }}
    right {{ type patch; faces ( (1 2 6 5) ); }}
    walls {{ type wall; faces ( (0 1 5 4) (3 7 6 2) (0 3 2 1) (4 5 6 7) ); }}
);
"""


def _geoms(n, shear):
    out = []
    for parse, block, G, kw in ((jparse, jblock, JGeom, dict(dtype=jnp.float64)),
                                (tparse, tblock, TGeom, dict(dtype=torch.float64, device="cpu"))):
        mesh = block(parse(_dict(n)))
        if shear:
            pts = np.array(mesh.points)
            pts[:, 0] += shear * pts[:, 1]
            mesh = dataclasses.replace(mesh, points=pts, _geom=None)
        out.append(G.from_polymesh(mesh, **kw))
    return out


def _rel(a, b):
    a = np.asarray(a.numpy() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _fields(case, C, b_Cf, rng):
    """(ψ cells, ψ boundary) of a named test field."""
    x = C[:, 0]
    if case == "linear":
        fn = lambda X: 2.0 * X[:, 0] + 3.0 * X[:, 1]
        return fn(C), fn(b_Cf)
    if case == "staggered":
        i = np.rint(x * 8 - 0.5).astype(int)
        return np.where(i % 2 == 0, 1.0, -1.0), np.zeros(len(b_Cf))
    if case == "tent":
        return 1.0 - np.abs(x - 0.5), np.zeros(len(b_Cf))
    if case == "random":
        return rng.randn(len(C)), rng.randn(len(b_Cf))
    return rng.randn(len(C), 3), rng.randn(len(b_Cf), 3)  # "vector"


@pytest.mark.parametrize("shear", [0.0, 0.3], ids=["orthogonal", "sheared"])
@pytest.mark.parametrize("case,k,l", [
    ("linear", 0.2, 0.05), ("random", 0.0, 0.0), ("staggered", 0.2, 0.05),
    ("tent", 1.0, 0.0), ("random", 0.2, 0.05), ("vector", 0.2, 0.05),
])
def test_filtered_linear2_limiter_matches(case, k, l, shear):
    jg, tg = _geoms((8, 4, 4), shear)
    rng = np.random.RandomState(7)
    psi_i, psi_b = _fields(case, np.asarray(jg.C), np.asarray(jg.b_Cf), rng)
    jl = jfvm.filtered_linear2_limiter(jg, JVF(jnp.asarray(psi_i), jnp.asarray(psi_b)), None, k=k, l=l)
    tl = tfvm.filtered_linear2_limiter(tg, TVF(torch.as_tensor(psi_i), torch.as_tensor(psi_b)),
                                       None, k=k, l=l)
    real = np.asarray(jg.face_mask) > 0
    # pad slots hold no face: the JAX package wraps a neighbour there
    assert _rel(tl.numpy()[real], np.asarray(jl)[real]) <= TOL
    if k == 0.0:
        assert bool((tl == 1.0).all())
    if case == "tent":
        assert float(tl.numpy()[real].min()) < 0.05
    if case == "staggered" and not shear:
        d = tg.d_face.numpy()
        assert np.isclose(np.median(tl.numpy()[np.abs(d[:, 0]) > 1e-9]), 1.0 + l - k, atol=0.05)


@pytest.mark.parametrize("baffle", [False, True], ids=["wall-fire", "baffled"])
def test_solvers_parse_filtered_linear2v_alike(tmp_path, baffle):
    from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
    from firefoam_torch.models.firefoam import FireFoamSolver as TSolver

    root = write_wall_fire_case(str(tmp_path / "wall"), n=(6, 5, 5), baffle=baffle)
    js, ts = JSolver(root), TSolver(root, device="cpu")
    assert ts.u_div_scheme == js.u_div_scheme == ("filteredLinear2", 0.2, 0.05)
    assert ts.turb.div_scheme == js.turb.div_scheme
    assert ts.lap_limiter == js.lap_limiter == 0.5 == ts.turb.lap_limiter
    rng = np.random.RandomState(8)
    g = js.geom
    phi = rng.randn(g.n_internal) * np.asarray(g.face_mask)
    U = (rng.randn(g.n_cells, 3), rng.randn(g.n_boundary, 3))
    from firefoam_tpu.ops import SurfaceField as JSF
    from firefoam_tpu.ops import fvc as jfvc
    from firefoam_torch.ops import SurfaceField as TSF
    from firefoam_torch.ops import fvc as tfvc

    jU, tU = JVF(*(jnp.asarray(a) for a in U)), TVF(*(torch.as_tensor(a) for a in U))
    jphi = JSF(jnp.asarray(phi), jnp.zeros(g.n_boundary))
    tphi = TSF(torch.as_tensor(phi), torch.zeros(g.n_boundary, dtype=torch.float64))
    jw = js._div_weights(js.u_div_scheme, jphi, jU, jfvc.grad(g, jU))
    tw = ts._div_weights(ts.u_div_scheme, tphi, tU, tfvc.grad(ts.geom, tU))
    real = np.asarray(g.face_mask) > 0
    assert _rel(tw.numpy()[real], np.asarray(jw)[real]) <= TOL
