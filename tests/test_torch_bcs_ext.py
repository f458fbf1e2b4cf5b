"""The port's region-free boundary-condition kinds against the JAX package
on CPU in float64 (rel 1e-12): bcs.make_field_bcs, resolve, evaluate and
initial_boundary, with the same seeded context built in the test.

The field files are the baffled wall-fire case's (write_wall_fire_case:
the wall functions, kqRWallFunction, compressible::thermalBaffle1D on the
ceiling baffle's two sides), and the same files with patches re-typed to
every other region-free kind of the JAX registry: fixedGradient,
outletInlet, empty, symmetry, symmetryPlane, slip,
nonUniFlowRateAdvectiveDiffusive, fixedEnthalpyFluxTemperature and a tabled
flowRateInletVelocity massFlowRate, held at times inside, before and after
its table. The coupled kinds still raise in the port."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from firefoam_tpu.io import Case as JCase
from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_tpu.ops import SurfaceField as JSF
from firefoam_tpu.ops import VolField as JVF
from firefoam_tpu.ops import bcs as jbcs
from firefoam_torch.io import Case as TCase
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.ops import SurfaceField as TSF
from firefoam_torch.ops import VolField as TVF
from firefoam_torch.ops import bcs as tbcs
from firefoam_torch.utils.synthcase import write_wall_fire_case

torch.set_num_threads(1)
TOL = 1e-12
FIELDS = ("U", "T", "p_rgh", "p", "k", "alphat", "nut", "O2", "C3H8", "Ydefault", "IDefault")
TABLE = ["table", [[0.0, 0.001], [0.05, 0.002], [0.05, 0.003], [1.0, 0.004]]]
# (field, patch) → the entries that re-type it
RETYPED = (
    {("T", "sides"): {"type": "fixedGradient", "gradient": ["uniform", 3.5]},
     ("T", "top"): {"type": "outletInlet", "outletValue": ["uniform", 310.0]},
     ("T", "burner"): {"type": "fixedEnthalpyFluxTemperature", "refValue": ["uniform", 320.0]},
     ("U", "sides"): {"type": "slip"},
     ("U", "top"): {"type": "symmetryPlane"},
     ("U", "burner"): {"type": "flowRateInletVelocity", "massFlowRate": TABLE},
     ("k", "sides"): {"type": "empty"},
     ("O2", "top"): {"type": "symmetry"},
     ("C3H8", "sides"): {"type": "slip"}},
    {("T", "top"): {"type": "symmetry"},
     ("T", "sides"): {"type": "fixedEnthalpyFluxTemperature"},
     ("U", "top"): {"type": "symmetry"},
     ("p_rgh", "sides"): {"type": "fixedGradient", "gradient": ["uniform", -2.0]},
     ("k", "top"): {"type": "outletInlet", "outletValue": ["uniform", 2e-4]}},
)


def _rel(a, b):
    a = np.asarray(a.numpy() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)) if b.size else 0.0


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = write_wall_fire_case(str(tmp_path_factory.mktemp("wall")), n=(6, 5, 5), baffle=True)
    jg = JGeom.from_polymesh(j_build(root).mesh, dtype=jnp.float64)
    tg = TGeom.from_polymesh(t_build(root).mesh, dtype=torch.float64, device="cpu")
    return root, jg, tg


def _ctx(g, seed, t):
    rng = np.random.RandomState(seed)
    nC, nB = g.n_cells, g.n_boundary
    c_np = dict(
        phi=(rng.randn(g.n_internal), rng.randn(nB)),
        rho=(rng.rand(nC) + 0.5, rng.rand(nB) + 0.5),
        U=(rng.randn(nC, 3), rng.randn(nB, 3)),
        alphaEff_b=rng.rand(nB) * 1e-3, kappaEff_b=rng.rand(nB) * 0.05,
        ph_rgh_b=rng.randn(nB), phi_prev_b=rng.randn(nB),
    )
    grad_ov = rng.randn(nB)

    def ctx(mod_v, mod_s, arr):
        c = {"phi": mod_s(*(arr(a) for a in c_np["phi"])),
             "rho": mod_v(*(arr(a) for a in c_np["rho"])),
             "U": mod_v(*(arr(a) for a in c_np["U"])),
             "t": arr(np.float64(t)), "overrides": {}}
        for key in ("alphaEff_b", "kappaEff_b", "ph_rgh_b", "phi_prev_b"):
            c[key] = arr(c_np[key])
        for p in g.patches:
            c["overrides"][("p_rgh", p.name, "gradient")] = arr(grad_ov[p.slice])
        return c

    return ctx(JVF, JSF, jnp.asarray), ctx(TVF, TSF, torch.as_tensor)


def _check_fields(root, jg, tg, retype, t, seed):
    jctx, tctx = _ctx(jg, seed, t)
    rng = np.random.RandomState(seed + 1)
    nC, nB = jg.n_cells, jg.n_boundary
    kinds = set()
    for name in FIELDS:
        jff, tff = JCase(root).field(name), TCase(root).field(name)
        n_o2 = jg.patch("burner").n
        for (field, patch), entries in retype.items():
            if field != name:
                continue
            for ff in (jff, tff):
                pd = ff.boundary.get_dict(patch)
                for k in list(pd.keys()):
                    if k != "value":
                        del pd[k]
                for k, v in entries.items():
                    pd[k] = v
        if name == "O2":  # per-face mass-flux fractions
            frac = ["nonuniform", list(np.linspace(0.1, 0.3, n_o2))]
            for ff in (jff, tff):
                pd = ff.boundary.get_dict("burner")
                pd["type"] = "nonUniFlowRateAdvectiveDiffusive"
                pd["massFluxFraction"] = frac
        jb, tb = jbcs.make_field_bcs(jff, jg), tbcs.make_field_bcs(tff, tg)
        assert [b.kind for b in tb.bcs] == [b.kind for b in jb.bcs], name
        kinds.update(b.kind for b in tb.bcs)
        shape_c, shape_b = ((nC, 3), (nB, 3)) if tff.is_vector else ((nC,), (nB,))
        psi = (300.0 + rng.randn(*shape_c), 300.0 + rng.randn(*shape_b))
        jpsi = JVF(jnp.asarray(psi[0]), jnp.asarray(psi[1]))
        tpsi = TVF(torch.as_tensor(psi[0]), torch.as_tensor(psi[1]))
        for a, b in zip(tbcs.resolve(tb, tg, tpsi, tctx), jbcs.resolve(jb, jg, jpsi, jctx)):
            assert _rel(a, b) <= TOL, name
        assert _rel(tbcs.evaluate(tb, tg, tpsi, tctx).b,
                    jbcs.evaluate(jb, jg, jpsi, jctx).b) <= TOL, name
        assert _rel(tbcs.initial_boundary(tff, tg, torch.float64, "cpu"),
                    jbcs.initial_boundary(jff, jg, jnp.float64)) == 0, name
    return kinds


def test_wall_fire_field_files_match(env):
    root, jg, tg = env
    kinds = _check_fields(root, jg, tg, {}, t=0.1, seed=1)
    assert {"compressible::thermalBaffle1D<hConstSolidThermoPhysics>",
            "compressible::alphatWallFunction", "alphatFireWallFunction",
            "nutFireWallFunction", "nutUSpaldingWallFunction", "kqRWallFunction"} <= kinds


@pytest.mark.parametrize("t", [0.0, 0.02, 0.05, 0.4, 2.0])
@pytest.mark.parametrize("which", [0, 1])
def test_retyped_patches_match(env, which, t):
    root, jg, tg = env
    kinds = _check_fields(root, jg, tg, RETYPED[which], t=t, seed=2 + which)
    assert "nonUniFlowRateAdvectiveDiffusive" in kinds


def test_tabled_mass_flow_rate_matches_jnp_interp():
    bc = tbcs.BC("flowRateInletVelocity", "burner",
                 {"massFlowRate_table": np.asarray(TABLE[1], np.float64)})
    for t in (-1.0, 0.0, 0.02, 0.05, 0.3, 1.0, 3.0):
        got = float(tbcs.mass_flow_rate(bc, torch.tensor(t, dtype=torch.float64)))
        want = float(jbcs._interp_table(np.asarray(TABLE[1], np.float64),
                                        jnp.asarray(t, jnp.float64)))
        assert got == want, t


def test_baffle_sides_are_linked_alike(env):
    root, jg, tg = env
    jb = jbcs.make_field_bcs(JCase(root).field("T"), jg)
    tb = tbcs.make_field_bcs(TCase(root).field("T"), tg)
    for j, t in zip(jb.bcs, tb.bcs):
        if t.kind.startswith("compressible::thermalBaffle1D"):
            assert np.array_equal(t.params["nbr_idx"].numpy(), np.asarray(j.params["nbr_idx"]))
            for key in ("thickness", "Qs", "kappa"):
                assert t.params[key] == j.params[key]


def test_coupled_kinds_still_raise(env):
    """The coupled kinds of the region models build as the JAX package's do
    (turbulentTemperatureRadiationQinCoupledMixed: the stored wall value
    until the solid's surface T arrives as an override); a kind neither
    package knows still raises, naming itself."""
    root, jg, tg = env
    for kind in ("compressible::turbulentTemperatureRadiationQinCoupledMixed",
                 "filmPyrolysisTemperatureCoupled"):
        jff, tff = JCase(root).field("T"), TCase(root).field("T")
        for ff in (jff, tff):
            ff.boundary.get_dict("wall")["type"] = kind
        jb, tb = jbcs.make_field_bcs(jff, jg), tbcs.make_field_bcs(tff, tg)
        assert [b.kind for b in tb.bcs] == [b.kind for b in jb.bcs]
        assert kind in [b.kind for b in tb.bcs]
    ff = TCase(root).field("T")
    ff.boundary.get_dict("wall")["type"] = "compressible::noSuchCoupledMixed"
    with pytest.raises(NotImplementedError, match="noSuchCoupledMixed"):
        tbcs.make_field_bcs(ff, tg)