"""The banded DIA layout (ops/geometry.py, layout="banded": up to 64
offsets) and the fire on it, against the JAX package on the CPU in float64.

The case is a slender castellated column, write_castellated_fire_case at
n=(4,4,60), size (0.2, 0.2, 3.0): 1,240 cells and 34 offsets in its own
numbering (the shape of the 104k-cell shaft (8,8,1500), which has 34 too).
The JAX side runs its banded layout with FIREFOAM_TPU_LAYOUT=banded, the
flat solvers (FIREFOAM_TPU_EXACT_SOLVERS=0, FIREFOAM_TPU_AMG=0,
FIREFOAM_TPU_GMG=0, FIREFOAM_TPU_PALLAS=0), FIREFOAM_TPU_PER_OFFSET=0 and
FIREFOAM_TPU_LATTICE_BC=0 (see tests/test_torch_seg_step.py); the port
runs layout="banded", exact_solvers=False, gmg=False, amg=False. Checked:
  * the geometry equal to JAX's bitwise; its gathers and sums (the lanes'
    one-gather forms) against the port's SEG geometry within 1e-13; `auto`
    and `dia` keep the 16-offset cap; the partitioned path refuses banded;
  * the fvc/fvm operators of tests/test_torch_ops.py and
    tests/test_torch_nonorth.py on the banded mesh against JAX within 1e-12;
  * one step from the same state and a 5-step chain after 10 warm-up steps
    (the first a radiation step), fields within 1e-9 and equal iteration
    counts;
  * the twins of K1-K3 (dia_krylov on CPU tensors) at 34 and 62 offsets
    against the JAX package's linear.py solvers with the same product:
    equal iterations, x within 1e-12;
  * the automatic solver rule on banded as the JAX constructor's;
  * run_case(layout="banded") and the CLI's --layout banded.
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
from firefoam_tpu.solvers import linear as jlin
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy
from firefoam_torch.models.run import main as t_main
from firefoam_torch.models.run import run_case as t_run_case
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.solvers import dia_krylov
from firefoam_torch.utils.synthcase import write_castellated_fire_case

# the operator tests of the lattice files, collected here on the banded mesh
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
N = (4, 4, 60)
SIZE = (0.2, 0.2, 3.0)
K = 34
N_STEPS = 5
WARMUP = 10
FIELDS = ("T", "U", "p_rgh", "Y", "k", "dt")
ITERS = ("Ux_iters", "Uy_iters", "Uz_iters", "p_rgh_iters_0", "p_rgh_iters_1", "k_iters",
         "h_iters", "O2_iters", "C3H8_iters", "H2O_iters", "CO2_iters")
_SOLVER_ENV = ("EXACT_SOLVERS", "AMG", "GMG", "GMG_COARSEST", "PALLAS", "P64_PRGH", "PAIRMG",
               "HYBRID", "BANDED_MAX_OFFSETS")
# the shaft's 34 offsets (write_castellated_fire_case n=(8,8,1500)) and the
# renumbered (8,6,6) box's 62
OFFS = {34: (1, 2, 3, 4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 21, 64, 66, 68, 69,
             71, 72, 73, 74, 76, 77, 78, 79, 81, 82, 84, 86, 87),
        62: tuple(range(1, 63))}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)) if b.size else 0.0


def _np(x):
    x = getattr(x, "i", x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def jax_banded_env(mp):
    """Pin the JAX package to its banded layout and flat solvers, float64."""
    for k in _SOLVER_ENV:
        mp.delenv(f"FIREFOAM_TPU_{k}", raising=False)
    for k in ("EXACT_SOLVERS", "AMG", "GMG", "PALLAS", "PER_OFFSET", "LATTICE_BC"):
        mp.setenv(f"FIREFOAM_TPU_{k}", "0")
    mp.setenv("FIREFOAM_TPU_LAYOUT", "banded")
    mp.setenv("FIREFOAM_TPU_DTYPE", "float64")


PORT = dict(layout="banded", exact_solvers=False, gmg=False, amg=False)


@pytest.fixture(scope="module", autouse=True)
def _pins():
    with pytest.MonkeyPatch.context() as mp:
        jax_banded_env(mp)
        yield


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """(case root, JAX banded geometry, the port's): the fixture
    tests/test_torch_ops.py's tests take."""
    root = write_castellated_fire_case(str(tmp_path_factory.mktemp("column")), n=N, size=SIZE)
    jg = JGeom.from_polymesh(j_build(root).mesh, dtype=jnp.float64, layout="banded")
    tg = TGeom.from_polymesh(t_build(root).mesh, dtype=torch.float64, device="cpu",
                             layout="banded")
    return root, jg, tg


@pytest.fixture(scope="module")
def geoms(env):
    """The fixture tests/test_torch_nonorth.py's tests take."""
    return True, env[1], env[2]


def test_banded_geometry_matches_jax_bitwise(env):
    _, jg, tg = env
    assert tg.layout == jg.layout == "dia"
    assert tg.offsets == tuple(int(o) for o in jg.offsets) and len(tg.offsets) == K
    assert (tg.n_cells, tg.n_internal, tg.n_boundary) == (jg.n_cells, jg.n_internal,
                                                           jg.n_boundary)
    np.testing.assert_array_equal(tg.face_perm, np.asarray(jg.face_perm))
    for name in ("own", "nei", "b_own"):
        np.testing.assert_array_equal(_np(getattr(tg, name)), np.asarray(getattr(jg, name)))
    for name in ("face_mask", "w", "Sf", "magSf", "dc", "nodc", "Cf", "V", "C", "b_Sf",
                 "b_magSf", "b_dc", "b_nodc", "b_Cf"):
        np.testing.assert_array_equal(_np(getattr(tg, name)), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert _rel(_np(tg.recon_inv), jg.recon_inv) <= 1e-12
    # the lanes: 3,186 faces in 34 x 1,240 slots
    assert int(tg.face_mask.sum()) == 3186 and tg.n_internal == K * tg.n_cells


def test_banded_gathers_and_sums_equal_seg(env):
    root, _, tb = env
    ts = TGeom.from_polymesh(t_build(root).mesh, dtype=torch.float64, device="cpu",
                             layout="seg")
    perm = torch.as_tensor(tb.face_perm)
    rng = np.random.RandomState(0)
    for v in (torch.as_tensor(rng.randn(ts.n_cells)), torch.as_tensor(rng.randn(ts.n_cells, 3))):
        assert torch.equal(tb.gather_own(v)[perm], ts.gather_own(v))
        assert torch.equal(tb.gather_nei(v)[perm], ts.gather_nei(v))
        # the lanes' gather is the rolls' concatenation
        rolls = torch.cat([torch.roll(v, -o, dims=0) for o in tb.offsets], dim=0)
        assert torch.equal(tb.gather_nei(v), rolls)
    for shape in ((ts.n_internal,), (ts.n_internal, 3)):
        fv = torch.as_tensor(rng.randn(*shape))
        fvb = fv.new_zeros((tb.n_internal,) + shape[1:]).index_copy_(0, perm, fv)
        for name in ("face_to_own_sum", "face_to_nei_sum"):
            d = getattr(tb, name)(fvb) - getattr(ts, name)(fv)
            assert float(d.abs().max()) <= 1e-13, name
        # the lanes' ordered sum adds as the loop of shifts does, bit for bit
        parts = fvb.reshape((K, tb.n_cells) + shape[1:])
        loop = sum(tb._shift_down(parts[k], o) for k, o in enumerate(tb.offsets))
        assert torch.equal(tb.face_to_nei_sum(fvb), loop)


def test_auto_and_dia_keep_16_offsets_and_partitions_refuse_banded(env):
    root, _, _ = env
    mesh = t_build(root).mesh
    for layout in (None, "auto"):
        assert TGeom.from_polymesh(mesh, dtype=torch.float64, device="cpu",
                                   layout=layout).layout == "seg"
    with pytest.raises(ValueError, match="not DIA-compatible"):
        TGeom.from_polymesh(mesh, dtype=torch.float64, device="cpu", layout="dia")
    with pytest.raises(ValueError, match="banded"):
        TSolver(root, device="cpu", layout="banded", local=types.SimpleNamespace())


# ------------------------------------------------------------------ the step
@pytest.fixture(scope="module")
def run(env):
    """The JAX trajectory and the port's solver on the column, both on the
    banded layout with the flat solvers."""
    root = env[0]
    js = JSolver(root)
    st = js.initial_state()
    step = js.make_step()
    states, logs = [jax.device_get(st)], []
    for _ in range(WARMUP + N_STEPS):
        st, log = step(st)
        states.append(jax.device_get(st))
        logs.append(jax.device_get(log))
    ts = TSolver(root, device="cpu", **PORT)
    return js, ts, states, logs


def test_both_take_banded_and_the_same_solvers(run):
    js, ts, _, _ = run
    assert js.geom.layout == ts.geom.layout == "dia"
    assert ts.geom.offsets == tuple(int(o) for o in js.geom.offsets)
    assert ts.gmg is None and js.gmg is None and ts._ldu is None and js._ldu is None
    assert ts.amg is None and js.amg is None


def test_lattice_multigrid_is_never_built_on_banded(env):
    """LatticeMG.build returns None on a castellation's offsets, as the JAX
    package's does: gmg=True leaves p_rgh to the flat CG."""
    from firefoam_torch.solvers.gmg import LatticeMG

    _, jg, tg = env
    from firefoam_tpu.solvers.gmg import LatticeMG as JLatticeMG

    assert LatticeMG.build(tg.offsets, tg.n_cells) is None
    assert JLatticeMG.build(tuple(int(o) for o in jg.offsets), jg.n_cells) is None
    s = TSolver(env[0], device="cpu", layout="banded", exact_solvers=False, gmg=True, amg=False)
    assert s.gmg is None and s.amg is None


def test_the_automatic_rule_picks_as_jax_on_banded(env, monkeypatch):
    """Nothing pinned but the layout, float64 on the CPU: both packages
    build the DIC schedule and no multigrid at 1,240 cells (AMG comes from
    50,000 cells, or with the schedule off)."""
    root = env[0]
    for k in ("EXACT_SOLVERS", "AMG", "GMG", "PALLAS"):
        monkeypatch.delenv(f"FIREFOAM_TPU_{k}", raising=False)
    js = JSolver(root)
    ts = TSolver(root, device="cpu", layout="banded")
    assert js.geom.layout == ts.geom.layout == "dia"
    assert (js._ldu is None) == (ts._ldu is None) is False
    assert js.gmg is None and ts.gmg is None and js.amg is None and ts.amg is None
    off = TSolver(root, device="cpu", layout="banded", exact_solvers=False)
    monkeypatch.setenv("FIREFOAM_TPU_EXACT_SOLVERS", "0")
    joff = JSolver(root)
    assert off._ldu is None and joff._ldu is None
    assert (off.amg is None) == (joff.amg is None) is False


def test_one_step_from_the_same_state(run):
    _, ts, states, logs = run
    step = ts.make_step()
    for n in (0, WARMUP):
        ours, log = step(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
        for f in FIELDS:
            assert _rel(_np(ours[f]), _np(states[n + 1][f])) <= 1e-9, (n, f)
        for k in ITERS:
            assert int(log[k]) == int(logs[n][k]), (n, k)


def test_five_chained_steps(run):
    _, ts, states, logs = run
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


# ------------------------------------------------------ the kernels' twins
def _dia_system(offs, n, seed, asym):
    rng = np.random.RandomState(seed)
    nK = len(offs)
    up = np.zeros((nK, n))
    lo = np.zeros((nK, n))
    diag = nK / 3.0 * (1.0 + 0.1 * rng.rand(n))
    for k, o in enumerate(offs):
        v = -(0.5 + rng.rand(n - o))
        up[k, : n - o] = v
        lo[k, : n - o] = v * (1.0 + asym * rng.rand(n - o))
        diag[: n - o] -= up[k, : n - o]
        diag[o:] -= lo[k, : n - o]
    return diag, up.reshape(-1), lo.reshape(-1), rng.randn(n), 0.1 * rng.randn(n)


def _jmv(offs, n, diag, up, lo):
    """The DIA product in JAX, summed in FvMatrix.matvec's order: the owned
    faces' terms, then the neighbouring faces', then the diagonal."""

    def mv(x):
        own = sum(up[k * n:(k + 1) * n] * jnp.roll(x, -o) for k, o in enumerate(offs))
        nei = sum(jnp.concatenate([jnp.zeros(o, x.dtype), (lo[k * n:(k + 1) * n] * x)[: n - o]])
                  for k, o in enumerate(offs))
        return diag * x + (own + nei)

    return jax.jit(mv)


@pytest.mark.parametrize("nK", sorted(OFFS))
@pytest.mark.parametrize("name", ["pcg", "bicgstab", "smooth"])
def test_twins_at_34_and_62_offsets_match_jax(name, nK):
    offs, n = OFFS[nK], 600
    d, up, lo, b, x0 = _dia_system(offs, n, seed=nK, asym=0.0 if name == "pcg" else 0.3)
    jmv = _jmv(offs, n, *(jnp.asarray(a) for a in (d, up, lo)))
    t = lambda a: torch.as_tensor(a)
    got = dia_krylov.dia_matvec(t(d), t(up), t(lo), offs, t(b)[None])[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jmv(jnp.asarray(b))), rtol=1e-13, atol=1e-13)
    jx0, jb, jd = (jnp.asarray(a) for a in (x0, b, d))
    if name == "smooth":
        # K3 counts sweeps: 800 sweeps are linear.jacobi_smooth's 200 rounds of 4
        ref = jlin.jacobi_smooth(jmv, jx0, jb, jd, tol=1e-8, max_iter=200)
        res = dia_krylov.dia_smooth(*(t(a) for a in (d, up, lo, b, x0)), offs, tol=1e-8,
                                    max_iter=800)
    else:
        ref = getattr(jlin, name)(jmv, jx0, jb, jd, tol=1e-10, max_iter=1000)
        res = getattr(dia_krylov, f"dia_{name}")(*(t(a) for a in (d, up, lo, b, x0)), offs,
                                                 tol=1e-10, max_iter=1000)
    assert int(res.n_iterations) == int(ref.n_iterations) > 0
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-12)


# ------------------------------------------------------------ run surface
def test_run_case_and_cli_take_banded(env, tmp_path, capsys):
    root = env[0]
    solver, state, logs = t_run_case(root, max_steps=2, device="cpu", verbose=False,
                                     layout="banded", exact_solvers=False, amg=False)
    assert solver.geom.layout == "dia" and len(solver.geom.offsets) == K
    assert len(logs) == 2 and np.isfinite(_np(state["T"])).all()
    t_main(["--case", root, "--cpu", "--max-steps", "1", "--layout", "banded", "--amg", "0",
            "--exact-solvers", "0", "--quiet"])
