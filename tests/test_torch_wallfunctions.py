"""The port's wall functions against the JAX package on CPU in float64 with
the same seeded inputs (rel 1e-10):

  * spalding_utau on seeded wall velocities, distances and viscosities;
  * FireFoamSolver._apply_wall_functions (alphatFireWallFunction, both
    branches of the QcWallFunction correlation) and _nut_wall_functions
    (nutFireWallFunction, nutUSpaldingWallFunction, and nutkWallFunction
    and nutUSpaldingBlowingWallFunction re-typed onto the open patches) on
    a seeded state, with the solvers of both packages built on the same
    wall-fire case (write_wall_fire_case);
  * InfoFields._convective_flux_L_boundary on that state.

In float32 the port's spalding_utau stays finite where |ΔU| = 0 (the JAX
package's guard squares to 0 there and divides 0 by 0)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from firefoam_tpu.functionobjects.infofields import InfoFields as JInfo
from firefoam_tpu.models import firefoam as jff
from firefoam_tpu.ops import SurfaceField as JSF
from firefoam_tpu.ops import VolField as JVF
from firefoam_torch.functionobjects.infofields import InfoFields as TInfo
from firefoam_torch.models import firefoam as tff
from firefoam_torch.ops import SurfaceField as TSF
from firefoam_torch.ops import VolField as TVF
from firefoam_torch.utils.synthcase import _set_patch, write_wall_fire_case

torch.set_num_threads(1)
TOL = 1e-10


def _rel(a, b):
    a = np.asarray(a.numpy() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_spalding_utau_matches():
    rng = np.random.RandomState(0)
    n = 500
    mag_up = 10.0 ** rng.uniform(-6, 1, n)
    y = 10.0 ** rng.uniform(-4, -1, n)
    nuw = 1.5e-5 * (1 + 3 * rng.rand(n))
    args = (mag_up, mag_up / y, nuw, y)
    got = tff.spalding_utau(*(torch.as_tensor(a) for a in args))
    want = jff.spalding_utau(*(jnp.asarray(a) for a in args))
    assert _rel(got, want) <= TOL
    assert bool(torch.isfinite(got).all())


def test_spalding_utau_float32_stays_finite_at_rest():
    z = torch.zeros(4, dtype=torch.float32)
    y = torch.full((4,), 0.01, dtype=torch.float32)
    nuw = torch.full((4,), 1.5e-5, dtype=torch.float32)
    ut = tff.spalding_utau(z, z, nuw, y)
    assert bool(torch.isfinite(ut).all()) and float(ut.abs().max()) < 1e-15


@pytest.fixture(scope="module")
def solvers(tmp_path_factory):
    from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
    from firefoam_torch.models.firefoam import FireFoamSolver as TSolver

    root = write_wall_fire_case(str(tmp_path_factory.mktemp("wall")), n=(6, 5, 5))
    _set_patch(root, "nut", "sides", "type nutkWallFunction;\n        value uniform 0;")
    _set_patch(root, "nut", "top", "type nutUSpaldingBlowingWallFunction;\n"
               "        hOCp 12;\n        rPhi 2.5;\n        value uniform 0;")
    js, ts = JSolver(root), TSolver(root, device="cpu")
    kinds = {b.kind for b in ts.nut_bcs.bcs} | {b.kind for b in ts.alphat_bcs.bcs}
    assert {"nutkWallFunction", "nutUSpaldingBlowingWallFunction", "nutFireWallFunction",
            "nutUSpaldingWallFunction", "alphatFireWallFunction"} <= kinds
    return js, ts


def _state(g, n_species, seed):
    """Hot gas over 298 K walls; wall fluxes of both signs and sizes (the
    low- and high-ṁ″ branches of the QcWallFunction correlation)."""
    rng = np.random.RandomState(seed)
    nC, nB, nI = g.n_cells, g.n_boundary, g.n_internal
    Y = rng.rand(nC, n_species)
    Yb = rng.rand(nB, n_species)
    f = dict(
        T=(300.0 + 1200.0 * rng.rand(nC), 298.15 + 5.0 * rng.rand(nB)),
        Y=(Y / Y.sum(1, keepdims=True), Yb / Yb.sum(1, keepdims=True)),
        alpha=(2e-5 * (1 + rng.rand(nC)), 2e-5 * (1 + rng.rand(nB))),
        alphat=(1e-4 * rng.rand(nC), 1e-4 * rng.rand(nB)),
        U=(rng.randn(nC, 3), rng.randn(nB, 3) * (rng.rand(nB, 1) > 0.5)),
        rho=(0.3 + rng.rand(nC), 0.3 + rng.rand(nB)),
        mu=(1.8e-5 * (1 + rng.rand(nC)), 1.8e-5 * (1 + rng.rand(nB))),
        k=(1e-3 * rng.rand(nC), 1e-3 * rng.rand(nB)),
        nut=(1e-4 * rng.rand(nC), 1e-4 * rng.rand(nB)),
    )
    phi = (rng.randn(nI) * np.asarray(g.face_mask) * 1e-3,
           rng.randn(nB) * 10.0 ** rng.uniform(-8, -3, nB))
    return f, phi


def _to(f, phi, V, S, arr):
    st = {k: V(arr(a), arr(b)) for k, (a, b) in f.items()}
    st["phi"] = S(arr(phi[0]), arr(phi[1]))
    return st


def test_wall_function_passes_match(solvers):
    js, ts = solvers
    f, phi = _state(js.geom, len(js.species), 1)
    jst = _to(f, phi, JVF, JSF, jnp.asarray)
    tst = _to(f, phi, TVF, TSF, torch.as_tensor)
    jst = js._apply_wall_functions(jst)
    tst = ts._apply_wall_functions(tst)
    assert _rel(tst["alphat"].b, jst["alphat"].b) <= TOL
    wall = ts.geom.patch("wall").slice
    assert float(tst["alphat"].b[wall].abs().max()) > 0.0  # the fire correlation acted
    jnut = js._nut_wall_functions(jst, jst["k"], jst["nut"].b)
    tnut = ts._nut_wall_functions(tst, tst["k"], tst["nut"].b)
    assert _rel(tnut, jnut) <= TOL
    for p in ts.geom.patches:
        if p.name in ("wall", "base", "sides", "top"):  # every wall-function patch set
            assert not torch.equal(tnut[p.slice], tst["nut"].b[p.slice]), p.name


def test_convective_heat_flux_matches(solvers):
    js, ts = solvers
    f, phi = _state(js.geom, len(js.species), 2)
    jst = _to(f, phi, JVF, JSF, jnp.asarray)
    tst = _to(f, phi, TVF, TSF, torch.as_tensor)
    got = TInfo(ts)._convective_flux_L_boundary(tst)
    want = JInfo(js)._convective_flux_L_boundary(jst)
    assert _rel(got, want) <= TOL
