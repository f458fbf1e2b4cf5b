"""The hybrid layout (ops/geometry.py: DIA lanes for the dominant offsets,
then the rest tail) and the castellated fire on it, against the JAX
package on the CPU in float64.

The cases are write_castellated_fire_case at n=(8,6,8) (525 cells, 5
lanes) and n=(16,12,16) (3,555 cells, 14 lanes). The JAX side runs its
hybrid layout with FIREFOAM_TPU_LAYOUT=hybrid, FIREFOAM_TPU_PER_OFFSET=0
(its per-offset fast paths are not ported) and FIREFOAM_TPU_LATTICE_BC=0
(see tests/test_torch_seg_step.py). Checked:
  * the geometry (lanes, face_perm, padded own/nei, face_mask and every
    face array) equal to JAX's bitwise at both sizes; the gathers and sums
    against the port's SEG geometry within 1e-13;
  * the fvc/fvm operators of tests/test_torch_ops.py and
    tests/test_torch_nonorth.py, the LDU product and the flat solvers on
    the hybrid mesh against JAX within 1e-12, equal iteration counts;
  * one step from the same state and a 5-step chain after 10 warm-up steps
    (the first a radiation step), fields within 1e-9 and equal iteration
    counts, with the index-pair multigrid on p_rgh forced on
    (FIREFOAM_TPU_PAIRMG=1 / pairmg=True) and off (flat CG), both with the
    DIC schedule off (FIREFOAM_TPU_EXACT_SOLVERS=0 / exact_solvers=False:
    the OpenFOAM-exact DIC-PCG comes first in the p_rgh order);
  * `auto` keeps SEG, and the partitioned path refuses hybrid;
  * AMG is off on hybrid unless forced, and p_rgh goes to PairMG before
    AMG when both are built (the JAX package's dispatch order).
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_tpu.ops import fvm as jfvm
from firefoam_tpu.solvers import linear as jlin
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.solvers import linear as tlin
from firefoam_torch.utils.synthcase import write_castellated_fire_case

# the operator tests of the lattice files, collected here on the hybrid mesh
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
N_STEPS = 5
WARMUP = 10
FIELDS = ("T", "U", "p_rgh", "Y", "k", "dt")
ITERS = ("Ux_iters", "Uy_iters", "Uz_iters", "p_rgh_iters_0", "p_rgh_iters_1", "k_iters",
         "h_iters", "O2_iters", "C3H8_iters", "H2O_iters", "CO2_iters")
_SOLVER_ENV = ("EXACT_SOLVERS", "AMG", "GMG", "GMG_COARSEST", "PALLAS", "P64_PRGH", "PAIRMG",
               "PAIRMG_COARSEST", "PAIRMG_LUMP", "HYBRID")

# name → (JAX environment, the port's arguments)
CONFIGS = {
    "pairmg": ({"FIREFOAM_TPU_EXACT_SOLVERS": "0", "FIREFOAM_TPU_PAIRMG": "1"},
               {"exact_solvers": False, "pairmg": True}),
    "flat": ({"FIREFOAM_TPU_EXACT_SOLVERS": "0", "FIREFOAM_TPU_PAIRMG": "0"},
             {"exact_solvers": False, "pairmg": False}),
}


def _rel(a, b, floor=0.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if not b.size:
        return 0.0
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), floor, 1e-300))


def _np(x):
    x = getattr(x, "i", x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def jax_hybrid_env(mp, env=()):
    """Pin the JAX package to its hybrid layout without the per-offset fast
    paths and with segment-sum boundary sums, float64, and `env`'s solvers."""
    for k in _SOLVER_ENV:
        mp.delenv(f"FIREFOAM_TPU_{k}", raising=False)
    for k, v in dict(env).items():
        mp.setenv(k, v)
    mp.setenv("FIREFOAM_TPU_LAYOUT", "hybrid")
    mp.setenv("FIREFOAM_TPU_PER_OFFSET", "0")
    mp.setenv("FIREFOAM_TPU_LATTICE_BC", "0")
    mp.setenv("FIREFOAM_TPU_DTYPE", "float64")


@pytest.fixture(scope="module", autouse=True)
def _pins():
    with pytest.MonkeyPatch.context() as mp:
        jax_hybrid_env(mp)
        yield


def _geometries(root):
    jg = JGeom.from_polymesh(j_build(root).mesh, dtype=jnp.float64, layout="hybrid")
    tg = TGeom.from_polymesh(t_build(root).mesh, dtype=torch.float64, device="cpu",
                             layout="hybrid")
    return jg, tg


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """(case root, JAX hybrid geometry, the port's): the fixture
    tests/test_torch_ops.py's tests take."""
    root = write_castellated_fire_case(str(tmp_path_factory.mktemp("castel")), n=N)
    return (root,) + _geometries(root)


@pytest.fixture(scope="module")
def geoms(env):
    """The fixture tests/test_torch_nonorth.py's tests take."""
    return True, env[1], env[2]


@pytest.mark.parametrize("n, lanes", [((8, 6, 8), 5), ((16, 12, 16), 14)])
def test_hybrid_geometry_matches_jax_bitwise(tmp_path, n, lanes):
    root = write_castellated_fire_case(str(tmp_path / "castel"), n=n)
    jg, tg = _geometries(root)
    assert tg.layout == jg.layout == "hybrid"
    assert tg.offsets == jg.offsets and len(tg.offsets) == lanes
    assert (tg.n_cells, tg.n_internal, tg.n_boundary) == (jg.n_cells, jg.n_internal, jg.n_boundary)
    np.testing.assert_array_equal(tg.face_perm, np.asarray(jg.face_perm))
    for name in ("own", "nei", "b_own"):
        np.testing.assert_array_equal(_np(getattr(tg, name)), np.asarray(getattr(jg, name)))
    for name in ("face_mask", "w", "Sf", "magSf", "dc", "nodc", "Cf", "V", "C", "b_Sf",
                 "b_magSf", "b_dc", "b_nodc", "b_Cf", "C_own_f", "C_nei_f", "d_face"):
        np.testing.assert_array_equal(_np(getattr(tg, name)), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(_np(tg.own_r), np.asarray(jg._hybrid_rest[4]))
    np.testing.assert_array_equal(_np(tg.nei_r), np.asarray(jg._hybrid_rest[5]))
    x = np.random.RandomState(1).randn(tg.n_cells, 3)
    for a, b in zip(tg.hybrid_rest_gathers(torch.as_tensor(x)),
                    jg.hybrid_rest_gathers(jnp.asarray(x))):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert _rel(_np(tg.recon_inv), jg.recon_inv) <= TOL
    # the lanes hold most faces; the tail is the rest, in mesh order
    nTop = len(tg.offsets) * tg.n_cells
    assert (tg.face_perm < nTop).mean() >= 0.5
    assert (np.diff(tg.face_perm[tg.face_perm >= nTop]) > 0).all()


def test_hybrid_gathers_and_sums_equal_seg(env):
    """As tests/test_hybrid_layout.py holds JAX's layouts to each other."""
    root, _, th = env
    ts = TGeom.from_polymesh(t_build(root).mesh, dtype=torch.float64, device="cpu",
                             layout="seg")
    perm = torch.as_tensor(th.face_perm)
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(ts.n_cells))
    xv = torch.as_tensor(rng.randn(ts.n_cells, 3))
    for v in (x, xv):
        assert torch.equal(th.gather_own(v)[perm], ts.gather_own(v))
        assert torch.equal(th.gather_nei(v)[perm], ts.gather_nei(v))
        assert torch.equal(th.cell_to_boundary(v), ts.cell_to_boundary(v))
    for shape in ((ts.n_internal,), (ts.n_internal, 3)):
        fv = torch.as_tensor(rng.randn(*shape))
        fvh = fv.new_zeros((th.n_internal,) + shape[1:]).index_copy_(0, perm, fv)
        for name in ("face_to_own_sum", "face_to_nei_sum"):
            d = getattr(th, name)(fvh) - getattr(ts, name)(fv)
            assert float(d.abs().max()) <= 1e-13, name
        d = th.face_to_both_sum(fvh, 2 * fvh) - ts.face_to_both_sum(fv, 2 * fv)
        assert float(d.abs().max()) <= 1e-13
    bv = torch.as_tensor(rng.randn(ts.n_boundary))
    assert torch.equal(th.boundary_to_cell_sum(bv), ts.boundary_to_cell_sum(bv))


def _system(g, rng, rows=None):
    """A diagonally dominant asymmetric system on g's face slots (zero at
    the lanes' pad slots); rows: per-row coefficients [B, nI]."""
    shape_f = (g.n_internal,) if rows is None else (rows, g.n_internal)
    shape_c = (g.n_cells,) if rows is None else (rows, g.n_cells)
    mask = _np(g.face_mask)
    up = -rng.rand(*shape_f) * mask
    lo = -rng.rand(*shape_f) * mask
    s = np.zeros(shape_c)
    for a in (up, lo):
        for idx in (_np(g.own), _np(g.nei)):
            np.add.at(s, (..., idx), np.abs(a))
    d = s + 0.1 + rng.rand(*shape_c)
    return d, up, lo, rng.randn(*shape_c), np.zeros(shape_c)


def _jax_mv(jg, d, up, lo):
    """The JAX package's FvMatrix.matvec product on the hybrid layout."""
    m = types.SimpleNamespace(geom=jg, upper=up, lower=lo)
    return lambda x: d * x + jfvm.FvMatrix._H_off(m, x)


def test_ldu_matvec_matches_jax(env):
    _, jg, tg = env
    rng = np.random.RandomState(8)
    d, up, lo, _, _ = _system(tg, rng)
    x = rng.randn(tg.n_cells)
    ref = _jax_mv(jg, *(jnp.asarray(a) for a in (d, up, lo)))(jnp.asarray(x))
    got = tlin.ldu_matvec(tg, *(torch.as_tensor(a) for a in (d, up, lo)))(torch.as_tensor(x))
    assert _rel(got, ref) <= TOL
    # per-row coefficients and rows of x, as the fvDOM ray batch gives them
    d, up, lo, _, _ = _system(tg, rng, rows=3)
    X = rng.randn(3, tg.n_cells)
    got = tlin.ldu_matvec(tg, *(torch.as_tensor(a) for a in (d, up, lo)))(torch.as_tensor(X))
    for r in range(3):
        ref = _jax_mv(jg, *(jnp.asarray(a[r]) for a in (d, up, lo)))(jnp.asarray(X[r]))
        assert _rel(got[r], ref) <= TOL


@pytest.mark.parametrize("solver", ["PCG", "PBiCGStab", "smoothSolver"])
def test_solve_ldu_on_hybrid_matches_the_flat_jax_solvers(env, solver):
    """solve_ldu on a hybrid system runs the twin with the hybrid product
    (no kernel), as the JAX package runs its flat solvers there."""
    _, jg, tg = env
    rng = np.random.RandomState(9)
    d, up, lo, b, x0 = _system(tg, rng)
    if solver == "PCG":
        lo = up  # symmetric
    jd, jup, jlo, jb, jx0 = (jnp.asarray(a) for a in (d, up, lo, b, x0))
    fn, mx, dict_mx = {"PCG": (jlin.pcg, 1000, 1000), "PBiCGStab": (jlin.bicgstab, 1000, 1000),
                       "smoothSolver": (jlin.jacobi_smooth, 200, 10)}[solver]
    ref = fn(_jax_mv(jg, jd, jup, jlo), jx0, jb, jd, tol=1e-9, rel_tol=0.0, max_iter=mx)
    got = tlin.solve_ldu(tg, solver, *(torch.as_tensor(a) for a in (d, up, lo, b, x0)),
                         tol=1e-9, rel_tol=0.0, max_iter=dict_mx)
    assert int(got.n_iterations) == int(ref.n_iterations) > 0
    assert _rel(got.x, ref.x) <= 1e-11


def test_auto_keeps_seg_and_partitions_refuse_hybrid(env):
    root, _, _ = env
    mesh = t_build(root).mesh
    for layout in (None, "auto"):
        g = TGeom.from_polymesh(mesh, dtype=torch.float64, device="cpu", layout=layout)
        assert g.layout == "seg"
    with pytest.raises(ValueError, match="hybrid"):
        TSolver(root, device="cpu", layout="hybrid", local=types.SimpleNamespace())


# ------------------------------------------------------------------ the step
@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request, env):
    """The JAX trajectory (once per configuration) and the port's solver on
    the same castellated case, both on the hybrid layout."""
    jenv, kwargs = CONFIGS[request.param]
    root = env[0]
    with pytest.MonkeyPatch.context() as mp:
        jax_hybrid_env(mp, jenv)
        js = JSolver(root)
        st = js.initial_state()
        step = js.make_step()
        states, logs = [jax.device_get(st)], []
        for _ in range(WARMUP + N_STEPS):
            st, log = step(st)
            states.append(jax.device_get(st))
            logs.append(jax.device_get(log))
    ts = TSolver(root, device="cpu", layout="hybrid", **kwargs)
    return request.param, js, ts, states, logs


def test_both_take_hybrid_and_the_same_solvers(run):
    name, js, ts, _, _ = run
    assert js.geom.layout == ts.geom.layout == "hybrid"
    assert ts.geom.offsets == js.geom.offsets
    assert ts.gmg is None and js.gmg is None and ts._ldu is None and js._ldu is None
    # AMG stays off on hybrid unless forced, in both packages
    assert ts.amg is None and js.amg is None
    assert (ts.pairmg is None) == (js.pairmg is None) == (name == "flat")
    if name == "pairmg":
        assert len(ts.pairmg.levels) == len(js.pairmg.levels) >= 2


def test_one_step_from_the_same_state(run):
    _, _, ts, states, logs = run
    step = ts.make_step()
    for n in (0, WARMUP):
        ours, log = step(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
        for f in FIELDS:
            assert _rel(_np(ours[f]), _np(states[n + 1][f])) <= 1e-9, (n, f)
        for k in ITERS:
            assert int(log[k]) == int(logs[n][k]), (n, k)


def test_five_chained_steps(run):
    _, _, ts, states, logs = run
    st = state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    assert int(st["rad"]["count"]) % 10 == 0  # a radiation step comes first
    step = ts.make_step()
    for n in range(WARMUP, WARMUP + N_STEPS):
        st, log = step(st)
        for f in FIELDS:
            assert _rel(_np(st[f]), _np(states[n + 1][f])) <= 1e-9, (n, f)
        for k in ITERS:
            assert int(log[k]) == int(logs[n][k]), (n, k)
        assert _rel(st["rad"]["G"].numpy(), states[n + 1]["rad"]["G"]) <= 1e-9
        assert _rel(_np(st["phi"]), _np(states[n + 1]["phi"])) <= 1e-9
    assert float(st["T"].i.max()) > 300.0


def test_p_rgh_dispatch_follows_the_jax_order(env, monkeypatch):
    """With PairMG and AMG both built (AMG forced), p_rgh goes to PairMG, as
    the JAX package dispatches (firefoam.py:2171-2183); with PairMG off, to
    AMG."""
    from firefoam_torch.models import firefoam as tff

    root = env[0]
    calls = []
    for name in ("pairmg_pcg", "amg_pcg"):
        orig = getattr(tff, name)
        monkeypatch.setattr(tff, name, lambda *a, _o=orig, _n=name, **k: (calls.append(_n),
                                                                          _o(*a, **k))[1])
    both = TSolver(root, device="cpu", layout="hybrid", exact_solvers=False, pairmg=True,
                   amg=True)
    assert both.pairmg is not None and both.amg is not None
    both.step(both.initial_state())
    assert calls and set(calls) == {"pairmg_pcg"}
    calls.clear()
    amg = TSolver(root, device="cpu", layout="hybrid", exact_solvers=False, pairmg=False,
                  amg=True)
    assert amg.pairmg is None and amg.amg is not None
    amg.step(amg.initial_state())
    assert calls and set(calls) == {"amg_pcg"}
