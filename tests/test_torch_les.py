"""The port's LES models against the JAX package on CPU in float64 with the
same seeded inputs (rel 1e-10): the WALE and σ eddy viscosities
(KEqnLES._nut_wale, _nut_sigma) and KEqnLES.correct for kEqn, WALE, WALE2
and SIGMA2, built by from_case from the same turbulenceProperties, on the
sheared wall-fire mesh (write_wall_fire_case) with the k boundary
conditions of its field file (kqRWallFunction on the walls), uncorrected and
with the 'limited 0.5' non-orthogonal correction, and with div(phi,k)
limitedLinear 1 and filteredLinear2 0.2 0.05. Linear-solver iteration
counts are equal."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from firefoam_tpu.io import Case as JCase
from firefoam_tpu.io import parse_string as jparse
from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_tpu.ops import SurfaceField as JSF
from firefoam_tpu.ops import VolField as JVF
from firefoam_tpu.ops import bcs as jbcs
from firefoam_tpu.turbulence.kEqn import KEqnLES as JK
from firefoam_torch.io import Case as TCase
from firefoam_torch.io import parse_string as tparse
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.ops import SurfaceField as TSF
from firefoam_torch.ops import VolField as TVF
from firefoam_torch.ops import bcs as tbcs
from firefoam_torch.turbulence.kEqn import KEqnLES as TK
from firefoam_torch.utils.synthcase import write_wall_fire_case

torch.set_num_threads(1)
TOL = 1e-10
MODELS = ("kEqn", "WALE", "WALE2", "SIGMA2")


def _turb(model):
    return (f"simulationType LES;\nLES {{ LESModel {model}; delta cubeRootVol;\n"
            f"  {model}Coeffs {{ Ck 0.094; Ce 1.048; cw 0.325; cx 1.5; Prt 0.9; }}\n"
            f"  cubeRootVolCoeffs {{ deltaCoeff 1; }} }}\n")


def _rel(a, b):
    a = np.asarray(a.numpy() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = write_wall_fire_case(str(tmp_path_factory.mktemp("wall")), n=(6, 5, 5))
    jg = JGeom.from_polymesh(j_build(root).mesh, dtype=jnp.float64)
    tg = TGeom.from_polymesh(t_build(root).mesh, dtype=torch.float64, device="cpu")
    jkb = jbcs.make_field_bcs(JCase(root).field("k"), jg)
    tkb = tbcs.make_field_bcs(TCase(root).field("k"), tg)
    return jg, tg, jkb, tkb


def _grad_u(n, seed):
    g = np.random.RandomState(seed).randn(n, 3, 3)
    g[:3] = 0.0  # still fluid: 0/(0 + ε)
    g[3] = np.diag([1.0, -0.5, -0.5])  # pure strain
    return g


@pytest.mark.parametrize("model", MODELS)
def test_from_case_and_eddy_viscosities_match(case, model):
    jg, tg, _, _ = case
    jk = JK.from_case(jg, jparse(_turb(model)))
    tk = TK.from_case(tg, tparse(_turb(model)))
    assert (tk.model, tk.Ck, tk.Ce, tk.Prt, tk.cw, tk.cx) == (jk.model, jk.Ck, jk.Ce, jk.Prt,
                                                              jk.cw, jk.cx)
    gu = _grad_u(jg.n_cells, 3)
    for name in ("_nut_wale", "_nut_sigma"):
        t = getattr(tk, name)(torch.as_tensor(gu))
        j = getattr(jk, name)(jnp.asarray(gu))
        assert _rel(t, j) <= TOL, name
        assert bool(torch.isfinite(t).all()) and float(t[:3].abs().max()) < 1e-60


def test_unknown_model_falls_back_to_keqn(case):
    jg, tg, _, _ = case
    assert TK.from_case(tg, tparse(_turb("Smagorinsky"))).model == "kEqn" == \
        JK.from_case(jg, jparse(_turb("Smagorinsky"))).model


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("lap,div", [(None, ("limitedLinear", 1.0)),
                                     (0.5, ("filteredLinear2", 0.2, 0.05))],
                         ids=["uncorrected", "limited-filtered"])
def test_correct_matches(case, model, lap, div):
    jg, tg, jkb, tkb = case
    jk = JK.from_case(jg, jparse(_turb(model)))
    tk = TK.from_case(tg, tparse(_turb(model)))
    jk.lap_limiter = tk.lap_limiter = lap
    jk.div_scheme = tk.div_scheme = div
    rng = np.random.RandomState(5)
    nC, nB, nI = jg.n_cells, jg.n_boundary, jg.n_internal
    mask = np.asarray(jg.face_mask)
    arrs = dict(
        k=(1e-4 + 1e-3 * rng.rand(nC), 1e-4 + 1e-3 * rng.rand(nB)),
        U=(0.1 * rng.randn(nC, 3), 0.1 * rng.randn(nB, 3)),
        rho=(1.0 + 0.2 * rng.rand(nC), 1.0 + 0.2 * rng.rand(nB)),
        mu=(1.8e-5 * (1 + rng.rand(nC)), 1.8e-5 * (1 + rng.rand(nB))),
        phi=(1e-3 * rng.randn(nI) * mask, 1e-3 * rng.randn(nB)),
    )
    rho_old = 1.0 + 0.2 * rng.rand(nC)
    ctl = {"solver": "PBiCGStab", "tolerance": 1e-8, "relTol": 0.0, "maxIter": 50}

    def fields(mod_v, mod_s, arr):
        f = {n: mod_v(arr(a), arr(b)) for n, (a, b) in arrs.items() if n != "phi"}
        f["phi"] = mod_s(arr(arrs["phi"][0]), arr(arrs["phi"][1]))
        return f

    jf = fields(JVF, JSF, jnp.asarray)
    tf = fields(TVF, TSF, torch.as_tensor)
    jctx = {"phi": jf["phi"], "rho": jf["rho"], "U": jf["U"], "overrides": {}}
    tctx = {"phi": tf["phi"], "rho": tf["rho"], "U": tf["U"], "overrides": {}}
    jnew, jnut, jres = jk.correct(jf["k"], jkb, jf["U"], jf["rho"], jnp.asarray(rho_old),
                                  jf["phi"], jf["mu"], 0.01, jctx, ctl)
    tnew, tnut, tres = tk.correct(tf["k"], tkb, tf["U"], tf["rho"], torch.as_tensor(rho_old),
                                  tf["phi"], tf["mu"], 0.01, tctx, ctl)
    assert int(tres.n_iterations) == int(jres.n_iterations)
    assert (int(tres.n_iterations) == 0) == (model == "SIGMA2")
    assert _rel(tnew.i, jnew.i) <= TOL and _rel(tnew.b, jnew.b) <= TOL
    assert _rel(tnut, jnut) <= TOL
