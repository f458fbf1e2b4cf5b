"""The port's geometry, fvm/fvc operators and boundary conditions against
the JAX package on the box-fire mesh (write_box_fire_case, n=(6,6,6)), on
CPU in float64, with the same seeded fields given to both (rel 1e-12)."""

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
from firefoam_tpu.ops import fvc as jfvc
from firefoam_tpu.ops import fvm as jfvm
from firefoam_tpu.utils.synthcase import write_box_fire_case
from firefoam_torch.io import Case as TCase
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.ops import SurfaceField as TSF
from firefoam_torch.ops import VolField as TVF
from firefoam_torch.ops import bcs as tbcs
from firefoam_torch.ops import fvc as tfvc
from firefoam_torch.ops import fvm as tfvm

torch.set_num_threads(1)
TOL = 1e-12


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)) if b.size else 0.0


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("box"))
    write_box_fire_case(root, n=(6, 6, 6))
    jg = JGeom.from_polymesh(j_build(root).mesh, dtype=jnp.float64)
    tg = TGeom.from_polymesh(t_build(root).mesh, dtype=torch.float64, device="cpu")
    return root, jg, tg


class Fields:
    """Seeded numpy fields handed to both packages."""

    def __init__(self, g, seed=0):
        rng = np.random.RandomState(seed)
        nC, nI, nB = g.n_cells, g.n_internal, g.n_boundary
        mask = np.asarray(g.face_mask)
        self.s = (rng.rand(nC) + 0.5, rng.rand(nB) + 0.5)
        self.u = (rng.randn(nC, 3), rng.randn(nB, 3))
        self.phi = (rng.randn(nI) * mask, rng.randn(nB))
        self.gam = (rng.rand(nI) * mask + 0.1, rng.rand(nB) + 0.1)
        self.y = (rng.rand(nC), rng.rand(nB))  # in [0, 1] for the 01 limiter
        self.f = (rng.rand(nB) > 0.5).astype(float)
        self.rv = rng.randn(nB)
        self.rg = rng.randn(nB)
        self.src = rng.randn(nC)


def _j(pair, cls=JVF):
    return cls(jnp.asarray(pair[0]), jnp.asarray(pair[1]))


def _t(pair, cls=TVF):
    return cls(torch.as_tensor(pair[0]), torch.as_tensor(pair[1]))


def test_geometry_arrays_match(env):
    _, jg, tg = env
    assert tg.layout == jg.layout == "dia"
    assert tg.offsets == jg.offsets
    assert (tg.n_cells, tg.n_internal, tg.n_boundary) == (jg.n_cells, jg.n_internal, jg.n_boundary)
    assert [(p.name, p.ptype, p.start, p.n) for p in tg.patches] == \
        [(p.name, p.ptype, p.start, p.n) for p in jg.patches]
    for name in ("own", "nei", "b_own"):
        np.testing.assert_array_equal(_np(getattr(tg, name)), np.asarray(getattr(jg, name)))
    for name in ("w", "Sf", "magSf", "dc", "nodc", "Cf", "face_mask", "V", "C", "b_Sf",
                 "b_magSf", "b_dc", "b_nodc", "b_Cf", "C_own_f", "C_nei_f", "d_face"):
        assert _rel(_np(getattr(tg, name)), getattr(jg, name)) == 0.0, name
    assert _rel(_np(tg.recon_inv), jg.recon_inv) <= TOL
    np.testing.assert_array_equal(tg.face_perm, jg.face_perm)


def test_geometry_primitives_match(env):
    _, jg, tg = env
    F = Fields(jg, seed=1)
    for x in (F.s[0], F.u[0]):
        assert _rel(_np(tg.gather_own(torch.as_tensor(x))), jg.gather_own(jnp.asarray(x))) == 0
        assert _rel(_np(tg.gather_nei(torch.as_tensor(x))), jg.gather_nei(jnp.asarray(x))) == 0
        assert _rel(_np(tg.cell_to_boundary(torch.as_tensor(x))), jg.cell_to_boundary(jnp.asarray(x))) == 0
    for fv in (F.phi[0], np.stack([F.phi[0], F.gam[0]], 1)):
        assert _rel(_np(tg.face_to_own_sum(torch.as_tensor(fv))), jg.face_to_own_sum(jnp.asarray(fv))) <= TOL
        assert _rel(_np(tg.face_to_nei_sum(torch.as_tensor(fv))), jg.face_to_nei_sum(jnp.asarray(fv))) <= TOL
    for bv in (F.phi[1], F.u[1]):
        assert _rel(_np(tg.boundary_to_cell_sum(torch.as_tensor(bv))),
                    jg.boundary_to_cell_sum(jnp.asarray(bv))) <= TOL
    assert _rel(_np(tg.cell_sum_unsigned(torch.as_tensor(F.phi[0]), torch.as_tensor(F.phi[1]))),
                jg.cell_sum_unsigned(jnp.asarray(F.phi[0]), jnp.asarray(F.phi[1]))) <= TOL


def test_boundary_sum_groups_are_collision_free(env):
    """boundary_to_cell_sum adds in groups whose owner cells are distinct
    (reproducible with the card's atomics) and equals one index_add_ in
    face order bitwise."""
    _, _, tg = env
    faces = torch.cat([f for f, _ in tg.b_groups])
    assert sorted(faces.tolist()) == list(range(tg.n_boundary))
    for f, own in tg.b_groups:
        assert len(set(own.tolist())) == len(own)
        assert torch.equal(own, tg.b_own[f])
    rng = np.random.RandomState(3)
    for shape in ((tg.n_boundary,), (tg.n_boundary, 3)):
        bv = torch.as_tensor(rng.randn(*shape) * 10.0 ** rng.uniform(-8, 8, shape))
        one = torch.zeros((tg.n_cells,) + shape[1:], dtype=bv.dtype).index_add_(0, tg.b_own, bv)
        assert torch.equal(tg.boundary_to_cell_sum(bv), one)


def test_fvc_operators_match(env):
    _, jg, tg = env
    F = Fields(jg, seed=2)
    js, ts = _j(F.s), _t(F.s)
    ju, tu = _j(F.u), _t(F.u)
    jphi, tphi = _j(F.phi, JSF), _t(F.phi, TSF)
    jgam, tgam = _j(F.gam, JSF), _t(F.gam, TSF)
    pairs = [
        (tfvc.interpolate(tg, ts).i, jfvc.interpolate(jg, js).i),
        (tfvc.interpolate(tg, tu).i, jfvc.interpolate(jg, ju).i),
        (tfvc.sn_grad(tg, ts).i, jfvc.sn_grad(jg, js).i),
        (tfvc.sn_grad(tg, ts).b, jfvc.sn_grad(jg, js).b),
        (tfvc.grad(tg, ts), jfvc.grad(jg, js)),
        (tfvc.grad(tg, tu), jfvc.grad(jg, ju)),
        (tfvc.div_flux(tg, tphi), jfvc.div_flux(jg, jphi)),
        (tfvc.div_flux_psi(tg, tphi, tfvc.interpolate(tg, ts)),
         jfvc.div_flux_psi(jg, jphi, jfvc.interpolate(jg, js))),
        (tfvc.laplacian(tg, tgam, ts), jfvc.laplacian(jg, jgam, js)),
        (tfvc.flux(tg, tu).i, jfvc.flux(jg, ju).i),
        (tfvc.flux(tg, tu).b, jfvc.flux(jg, ju).b),
        (tfvc.reconstruct(tg, tphi), jfvc.reconstruct(jg, jphi)),
        (tfvc.surface_sum(tg, tphi), jfvc.surface_sum(jg, jphi)),
        (tfvc.average_to_cells(tg, tgam), jfvc.average_to_cells(jg, jgam)),
        (tfvc.volume_integrate(tg, ts.i), jfvc.volume_integrate(jg, js.i)),
    ]
    for k, (a, b) in enumerate(pairs):
        assert _rel(_np(a), b) <= TOL, k


def _mat_pairs(tm, jm):
    return [(tm.diag, jm.diag), (tm.lower, jm.lower), (tm.upper, jm.upper),
            (tm.source, jm.source), (tm.internal_coeffs, jm.internal_coeffs),
            (tm.boundary_coeffs, jm.boundary_coeffs)]


def test_fvm_operators_and_matrix_match(env):
    _, jg, tg = env
    F = Fields(jg, seed=3)
    js, ts = _j(F.s), _t(F.s)
    ju, tu = _j(F.u), _t(F.u)
    jy, ty = _j(F.y), _t(F.y)
    jphi, tphi = _j(F.phi, JSF), _t(F.phi, TSF)
    jgam, tgam = _j(F.gam, JSF), _t(F.gam, TSF)
    f, rv, rg = F.f, F.rv, F.rg
    jvic, jvbc = jfvm.mixed_value_coeffs(*(jnp.asarray(a) for a in (rv, rg, f)), jg.b_dc)
    tvic, tvbc = tfvm.mixed_value_coeffs(*(torch.as_tensor(a) for a in (rv, rg, f)), tg.b_dc)
    jgic, jgbc = jfvm.mixed_gradient_coeffs(*(jnp.asarray(a) for a in (rv, rg, f)), jg.b_dc)
    tgic, tgbc = tfvm.mixed_gradient_coeffs(*(torch.as_tensor(a) for a in (rv, rg, f)), tg.b_dc)
    for a, b in ((tvic, jvic), (tvbc, jvbc), (tgic, jgic), (tgbc, jgbc)):
        assert _rel(_np(a), b) <= TOL

    # interpolation-scheme weights
    for bound in (False, True):
        assert _rel(_np(tfvm.limited_linear_limiter(tg, tphi.i, ty, k=1.0, bound01=bound)),
                    jfvm.limited_linear_limiter(jg, jphi.i, jy, k=1.0, bound01=bound)) <= TOL
    tw = tfvm.limited_linear_weights(tg, tphi.i, ts, k=1.0)
    jw = jfvm.limited_linear_weights(jg, jphi.i, js, k=1.0)
    assert _rel(_np(tw), jw) <= TOL
    assert _rel(_np(tfvm.upwind_weights(tg, tphi.i)), jfvm.upwind_weights(jg, jphi.i)) == 0

    dt = 0.013
    rho_old = F.y[0] + 0.5
    tm = (tfvm.ddt(tg, ts.i, ts, ts.i, torch.as_tensor(rho_old), dt)
          + tfvm.div(tg, tphi, ts, tw, tvic, tvbc)
          - tfvm.laplacian(tg, tgam, ts, tgic, tgbc)
          + tfvm.Sp(tg, torch.as_tensor(F.src), ts)).add_source(torch.as_tensor(F.src))
    jm = (jfvm.ddt(jg, js.i, js, js.i, jnp.asarray(rho_old), dt)
          + jfvm.div(jg, jphi, js, jw, jvic, jvbc)
          - jfvm.laplacian(jg, jgam, js, jgic, jgbc)
          + jfvm.Sp(jg, jnp.asarray(F.src), js)).add_source(jnp.asarray(F.src))
    for a, b in _mat_pairs(tm, jm):
        assert _rel(_np(a), b) <= TOL
    td, tb = tm.totals()
    jd, jb = jm.totals()
    assert _rel(_np(td), jd) <= TOL and _rel(_np(tb), jb) <= TOL
    assert _rel(_np(tm.matvec(ts.i, td)), jm.matvec(js.i, jd)) <= TOL
    assert _rel(_np(tm.A()), jm.A()) <= TOL
    assert _rel(_np(tm.H()), jm.H()) <= TOL
    assert _rel(_np(tm.flux().i), jm.flux().i) <= TOL
    assert _rel(_np(tm.flux().b), jm.flux().b) <= TOL
    for a, b in _mat_pairs(tm.relax(0.7), jm.relax(0.7)):
        assert _rel(_np(a), b) <= TOL

    # vector LUST convection with its deferred correction
    f3 = np.repeat(f[:, None], 3, 1)
    rv3, rg3 = F.u[1], np.zeros_like(F.u[1])
    jvic3, jvbc3 = jfvm.mixed_value_coeffs(jnp.asarray(rv3), jnp.asarray(rg3), jnp.asarray(f3), jg.b_dc)
    tvic3, tvbc3 = tfvm.mixed_value_coeffs(torch.as_tensor(rv3), torch.as_tensor(rg3),
                                           torch.as_tensor(f3), tg.b_dc)
    tl = tfvm.lust_div(tg, tphi, tu, tvic3, tvbc3, tfvc.grad(tg, tu))
    jl = jfvm.lust_div(jg, jphi, ju, jvic3, jvbc3, jfvc.grad(jg, ju))
    for a, b in _mat_pairs(tl, jl):
        assert _rel(_np(a), b) <= TOL
    assert _rel(_np(tl.H()), jl.H()) <= TOL
    assert _rel(_np(tl.A()), jl.A()) <= TOL


_FIELDS = ("U", "T", "p_rgh", "p", "k", "alphat", "nut", "O2", "C3H8", "Ydefault", "IDefault")


def test_boundary_conditions_match(env):
    """Every BC kind of the box-fire field files, resolved and evaluated
    with the same seeded context in both packages."""
    root, jg, tg = env
    rng = np.random.RandomState(4)
    nC, nB = jg.n_cells, jg.n_boundary
    ctx_np = dict(
        phi=(rng.randn(jg.n_internal), rng.randn(nB)),
        rho=(rng.rand(nC) + 0.5, rng.rand(nB) + 0.5),
        U=(rng.randn(nC, 3), rng.randn(nB, 3)),
        alphaEff_b=rng.rand(nB) * 1e-3,
        ph_rgh_b=rng.randn(nB),
        phi_prev_b=rng.randn(nB),
    )
    grad_ov = rng.randn(nB)

    def ctx(mod_v, mod_s, arr):
        c = {
            "phi": mod_s(*(arr(a) for a in ctx_np["phi"])),
            "rho": mod_v(*(arr(a) for a in ctx_np["rho"])),
            "U": mod_v(*(arr(a) for a in ctx_np["U"])),
            "t": arr(np.float64(0.1)),
            "alphaEff_b": arr(ctx_np["alphaEff_b"]),
            "ph_rgh_b": arr(ctx_np["ph_rgh_b"]),
            "phi_prev_b": arr(ctx_np["phi_prev_b"]),
            "overrides": {},
        }
        for p in jg.patches:
            c["overrides"][("p_rgh", p.name, "gradient")] = arr(grad_ov[p.slice])
        return c

    jctx = ctx(JVF, JSF, jnp.asarray)
    tctx = ctx(TVF, TSF, torch.as_tensor)
    jcase, tcase = JCase(root), TCase(root)
    kinds = set()
    for name in _FIELDS:
        jff, tff = jcase.field(name), tcase.field(name)
        jb = jbcs.make_field_bcs(jff, jg)
        tb = tbcs.make_field_bcs(tff, tg)
        assert [b.kind for b in tb.bcs] == [b.kind for b in jb.bcs]
        kinds.update(b.kind for b in tb.bcs)
        nc = 3 if tff.is_vector else 1
        shape_c = (nC, 3) if nc == 3 else (nC,)
        shape_b = (nB, 3) if nc == 3 else (nB,)
        psi = (rng.randn(*shape_c), rng.randn(*shape_b))
        jpsi, tpsi = _j(psi), _t(psi)
        jr = jbcs.resolve(jb, jg, jpsi, jctx)
        tr = tbcs.resolve(tb, tg, tpsi, tctx)
        for a, b in zip(tr, jr):
            assert _rel(_np(a), b) <= TOL, name
        assert _rel(_np(tbcs.evaluate(tb, tg, tpsi, tctx).b), jbcs.evaluate(jb, jg, jpsi, jctx).b) <= TOL
        jib = jbcs.initial_boundary(jff, jg, jnp.float64)
        tib = tbcs.initial_boundary(tff, tg, torch.float64, "cpu")
        assert _rel(_np(tib), jib) == 0, name
    assert kinds == {
        "pressureInletOutletVelocity", "flowRateInletVelocity", "noSlip", "inletOutlet",
        "fixedValue", "zeroGradient", "calculated", "prghTotalHydrostaticPressure",
        "fixedFluxPressure", "totalFlowRateAdvectiveDiffusive", "greyDiffusiveRadiation",
    }


def test_unported_bc_kind_raises(env, tmp_path):
    root, _, tg = env
    ff = TCase(root).field("T")
    ff.boundary.get_dict("base")["type"] = "noSuchPyrolysisTemperatureCoupled"
    with pytest.raises(NotImplementedError, match="noSuchPyrolysisTemperatureCoupled"):
        tbcs.make_field_bcs(ff, tg)
