"""The port's MPPIC models (lagrangian/mppic.py) against the JAX package's on
the CPU in float64, on the same seeded dense parcel populations in the spray
fire case's mesh (firefoam_torch.utils.synthcase at (6, 5, 6), both packages
reading its files): the cell averages (alpha, mean velocity, its variance,
the Sauter radius and the collision frequency), every particle stress
(HarrisCrighton, Lun, exponential) and time scale (equilibrium,
nonEquilibrium, isotropic), the correction limiters (absolute, relative,
none), and `MPPIC.apply` with each model alone and all three together
(damping → packing → isotropy, the isotropy's draws from one key). Fields
within 1e-10 relative. The parcel sums are the port's order-fixed CellSum:
a dead lane adds exact zeros to the JAX package's segment_sum, which the
test shows by holding dead lanes with finite junk values.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.io import parse_string as jparse
from firefoam_tpu.lagrangian import mppic as jm
from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_torch.io import parse_string as tparse
from firefoam_torch.lagrangian import mppic as tm
from firefoam_torch.lagrangian import prng
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.utils.synthcase import write_spray_fire_case

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)
N = (6, 5, 6)
TOL = 1e-10


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b), initial=0.0) / max(np.max(np.abs(b), initial=0.0), 1e-300))


@pytest.fixture(scope="module")
def geoms(tmp_path_factory):
    root = write_spray_fire_case(str(tmp_path_factory.mktemp("mppic") / "c"), n=N)
    jg = JGeom.from_polymesh(j_build(root).mesh)
    tg = TGeom.from_polymesh(t_build(root).mesh, dtype=torch.float64, device="cpu")
    return jg, tg


def _population(n_cells, seed, cap=700):
    """A dense spray: about 3 parcels a cell, alpha up to about 0.4; 10 % dead
    lanes with finite junk in every field."""
    rng = np.random.default_rng(seed)
    return {
        "x": rng.uniform(0.0, 1.0, (cap, 3)),
        "U": rng.normal(0.0, 1.0, (cap, 3)),
        "d": rng.uniform(2e-3, 5e-3, cap),
        "nP": rng.uniform(1e3, 4e4, cap),
        "cell": rng.integers(0, n_cells, cap),
        "alive": rng.uniform(size=cap) < 0.9,
    }


def _both(pop):
    return ({k: jnp.asarray(v) for k, v in pop.items()},
            {k: torch.as_tensor(v) for k, v in pop.items()})


def test_averages(geoms):
    jg, tg = geoms
    js, ts = _both(_population(tg.n_cells, 0))
    a, b = tm.mppic_averages(ts, 1000.0, tg), jm.mppic_averages(js, 1000.0, jg)
    assert set(a) == set(b)
    for k in b:
        assert _rel(a[k], b[k]) <= TOL, k
    assert float(b["alpha"].max()) > 0.1


@pytest.mark.parametrize("kind", ("HarrisCrighton", "Lun", "exponential"))
def test_stress(kind):
    rng = np.random.default_rng(1)
    alpha = rng.uniform(0.0, 0.65, 200)  # beyond close packing too
    u2 = rng.uniform(0.0, 2.0, 200)
    txt = f"type {kind}; alphaPacked 0.6; {kind}Coeffs {{ pSolid 12; beta 2.5; eps 1e-7; e 0.8; }}"
    a = tm.ParticleStress.from_dict(tparse(txt)).tau(torch.as_tensor(alpha), 1000.0,
                                                     torch.as_tensor(u2))
    b = jm.ParticleStress.from_dict(jparse(txt)).tau(jnp.asarray(alpha), 1000.0, jnp.asarray(u2))
    assert _rel(a, b) <= TOL


@pytest.mark.parametrize("kind", ("equilibrium", "nonEquilibrium", "isotropic"))
def test_time_scale(kind):
    rng = np.random.default_rng(2)
    args = [rng.uniform(0.0, 0.5, 200), rng.uniform(1e-4, 3e-3, 200), rng.uniform(0, 2, 200),
            rng.uniform(0.0, 50.0, 200)]
    txt = f"type {kind}; {kind}Coeffs {{ alphaPacked 0.58; e 0.85; }}"
    a = tm.TimeScale.from_dict(tparse(txt)).one_by_tau(*map(torch.as_tensor, args))
    b = jm.TimeScale.from_dict(jparse(txt)).one_by_tau(*map(jnp.asarray, args))
    assert _rel(a, b) <= TOL


@pytest.mark.parametrize("kind", ("absolute", "relative", "none"))
def test_limited_velocity(kind):
    rng = np.random.default_rng(3)
    U, dU, um = (rng.normal(size=(300, 3)) for _ in range(3))
    a = tm.limited_velocity(kind, 0.9, *map(torch.as_tensor, (U, dU, um)))
    b = jm.limited_velocity(kind, 0.9, *map(jnp.asarray, (U, dU, um)))
    assert _rel(a, b) <= TOL


_SUBMODELS = {
    "damping": "dampingModel relaxation; relaxationCoeffs { timeScaleModel "
               "{ type nonEquilibrium; alphaPacked 0.6; e 0.9; } }",
    "packing": "packingModel explicit; explicitCoeffs { particleStressModel { type "
               "HarrisCrighton; alphaPacked 0.6; pSolid 10; beta 2; eps 1e-7; } "
               "correctionLimitingMethod { type absolute; e 0.9; } }",
    "packing_implicit_lun": "packingModel implicit; implicitCoeffs { particleStressModel { type "
                            "Lun; alphaPacked 0.6; LunCoeffs { e 0.8; } } "
                            "correctionLimitingMethod { type relative; e 0.7; } }",
    "isotropy": "isotropyModel stochastic; stochasticCoeffs { timeScaleModel "
                "{ type isotropic; alphaPacked 0.6; e 0.9; } }",
}


@pytest.mark.parametrize("models", ("damping", "packing", "packing_implicit_lun", "isotropy",
                                    "damping packing isotropy"))
def test_apply(geoms, models):
    jg, tg = geoms
    txt = " ".join(_SUBMODELS[m] for m in models.split())
    jmod = jm.MPPIC.from_dict(jparse(txt), 1000.0)
    tmod = tm.MPPIC.from_dict(tparse(txt), 1000.0)
    assert (tmod.packing, tmod.damping, tmod.isotropy) == (jmod.packing, jmod.damping,
                                                          jmod.isotropy)
    js, ts = _both(_population(tg.n_cells, 4))
    for i, dt in enumerate((1e-3, 4e-3, 2e-2)):
        js = jmod.apply(js, jg, dt, jax.random.PRNGKey(i))
        ts = tmod.apply(ts, tg, dt, prng.PRNGKey(i))
        assert _rel(ts["U"], js["U"]) <= TOL, (models, i, _rel(ts["U"], js["U"]))
    assert tm.MPPIC.from_dict(tparse("packingModel none; dampingModel none;"), 1000.0) is None
