"""The explicitly partitioned fire step of the port (firefoam_torch/parallel/
spmd_step.py: one FireFoamSolver(local=...) per rank, gloo on the CPU, in
float64) against the JAX package's single-device step with the same
numerics, as the JAX package holds its own partitioned step
(tests/test_spmd_full.py:35-62).

Cases and tolerances (max-norm of the difference over the field's
max-abs):

  * the box fire at (10, 8, 12), 960 cells, RCB into P = 2 and 4: one step
    from the state after 10 steps (the JAX package's, the 11th step solves
    the fvDOM rays) against the JAX step of that state with SEG, no exact
    solvers, no AMG, no GMG: T, U, p_rgh, rho, k, Y, hs to 1e-10 and equal
    iteration counts for every logged solve; and a 3-step chain to 1e-8;
  * the same box in two z-slabs with gmg=True: the sharded lattice
    multigrid against the port's single-device DIA lattice multigrid over 3
    steps from t = 0, with tests/test_spmd_gmg.py:183-194's bounds (T 1e-6,
    p_rgh 1e-4, U 1e-5; p_rgh iterations ≤ 25 and ≤ the single run's + 15);
  * the sprinkler fire (write_spray_fire_case) at (10, 8, 12), RCB into
    P = 4, with 120 parcels seeded across the partitions as
    tests/test_spmd_cloud.py seeds them: equal parcel counts and spray
    mass (to 1e-12) each step against the port's single-device SEG step,
    parcels migrating and alive on every rank; and again with a send
    capacity of one parcel a round, which holds parcels back for a later
    round: the same counts and mass, fields to 1e-10, positions and cells;
  * scatter_state/gather_state round trips, bitwise;
  * pyrolysis, the film and fvOptions zones raise under `local` in both
    packages.

The slow-marked test holds the partitioned step against the JAX package's
SpmdFireFoam at the same P.
"""

import os

import numpy as np
import pytest
import torch

import jax

from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy, state_to_numpy
from firefoam_torch.parallel.spmd_step import SpmdFireFoam
from firefoam_torch.utils.synthcase import write_box_fire_case, write_spray_fire_case

torch.set_num_threads(1)
N = (10, 8, 12)
WARMUP = 10
CHAIN = 3
DEADLINE = 240.0
FIELDS = ("T", "U", "p_rgh", "rho", "k", "Y", "hs")
ITERS = ("Ux_iters", "Uy_iters", "Uz_iters", "p_rgh_iters_0", "p_rgh_iters_1", "k_iters",
         "h_iters", "O2_iters", "C3H8_iters", "H2O_iters", "CO2_iters")
_SOLVER_ENV = ("EXACT_SOLVERS", "AMG", "GMG", "GMG_COARSEST", "PALLAS", "P64_PRGH", "PAIRMG",
               "HYBRID", "PER_OFFSET", "LAYOUT", "LATTICE_BC")


def _rel(a, b):
    a = np.asarray(getattr(a, "i", a), np.float64)
    b = np.asarray(getattr(b, "i", b), np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def jax_flat_seg_env(mp):
    """The JAX package on the partitioned path's numerics: SEG layout with
    segment-sum boundary sums, the flat Krylov solvers, float64."""
    for k in _SOLVER_ENV:
        mp.delenv(f"FIREFOAM_TPU_{k}", raising=False)
    mp.setenv("FIREFOAM_TPU_LAYOUT", "seg")
    mp.setenv("FIREFOAM_TPU_LATTICE_BC", "0")
    mp.setenv("FIREFOAM_TPU_EXACT_SOLVERS", "0")
    mp.setenv("FIREFOAM_TPU_AMG", "0")
    mp.setenv("FIREFOAM_TPU_GMG", "0")
    mp.setenv("FIREFOAM_TPU_PALLAS", "0")
    mp.setenv("FIREFOAM_TPU_DTYPE", "float64")


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    return write_box_fire_case(str(tmp_path_factory.mktemp("spmdbox")), n=N)


@pytest.fixture(scope="module")
def jax_run(box):
    """The JAX single-device trajectory: WARMUP steps, then CHAIN more."""
    from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver

    with pytest.MonkeyPatch.context() as mp:
        jax_flat_seg_env(mp)
        js = JSolver(box)
        assert js.geom.layout == "seg" and js._ldu is None and js.amg is None
        st = js.initial_state()
        step = js.make_step()
        states, logs = [], []
        for _ in range(WARMUP + CHAIN):
            st, log = step(st)
            states.append(jax.device_get(st))
            logs.append(jax.device_get(log))
    return states, logs


@pytest.fixture(scope="module", params=[2, 4])
def rcb_run(request, box, jax_run):
    states, _ = jax_run
    sp = SpmdFireFoam(box, request.param, device="cpu", partition="rcb")
    warm = state_from_numpy(states[WARMUP - 1], device="cpu", dtype=torch.float64)
    out = sp.run(warm, CHAIN, deadline_s=DEADLINE, every_step=True)
    return sp, out


def test_partitions_take_the_flat_solvers(rcb_run):
    sp, out = rcb_run
    assert sp.partition == "rcb" and out["p_solver"] == "flat"
    assert sp.ref.geom.layout == "seg" and sp.ref.amg is None and sp.ref._ldu is None
    # the ranks passed the lockstep check after every step; halo traffic
    # and reductions were counted
    rep = out["comm"][0][0]["counts"]
    assert rep["ppermute"]["calls"] > 100 and rep["psum"]["calls"] > 100
    assert rep["pmax"]["calls"] > 0 and rep["pmin"]["calls"] > 0


def test_one_step_matches_jax_single_device(rcb_run, jax_run):
    sp, out = rcb_run
    states, logs = jax_run
    got, ref, log_r = out["states"][0], states[WARMUP], logs[WARMUP]
    for f in FIELDS:
        assert _rel(got[f], ref[f]) < 1e-10, (f, _rel(got[f], ref[f]))
    for k in ITERS:
        assert int(out["logs"][0][k]) == int(log_r[k]), k
    assert out["logs"][0]["T_max"] == pytest.approx(float(log_r["T_max"]), rel=1e-12)
    assert float(got["dt"]) == pytest.approx(float(ref["dt"]), rel=1e-12)


def test_chain_matches_jax_single_device(rcb_run, jax_run):
    sp, out = rcb_run
    states, logs = jax_run
    for k in range(CHAIN):
        got, ref = out["states"][k], states[WARMUP + k]
        for f in FIELDS:
            assert _rel(got[f], ref[f]) < 1e-8, (k, f, _rel(got[f], ref[f]))
        for it in ITERS:
            assert int(out["logs"][k][it]) == int(logs[WARMUP + k][it]), (k, it)


def _leaves(x, prefix=""):
    if isinstance(x, tuple):
        yield prefix + ".i", x.i
        yield prefix + ".b", x.b
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, x


def test_scatter_gather_round_trip(rcb_run, jax_run):
    sp, _ = rcb_run
    st = state_from_numpy(jax_run[0][WARMUP - 1], device="cpu", dtype=torch.float64)
    ref = dict(_leaves(state_to_numpy(st)))
    got = dict(_leaves(sp.gather_state(sp.scatter_state(st))))
    assert sorted(ref) == sorted(got)
    for k, v in ref.items():
        assert np.array_equal(np.asarray(v), np.asarray(got[k])), k


def test_slab_gmg_matches_single_device_gmg(box):
    sp = SpmdFireFoam(box, 2, device="cpu", partition="slab", gmg=True)
    assert sp.partition == "slab" and sp.lz.slab_dims == N
    s1 = TSolver(box, device="cpu", layout="dia", gmg=True)
    assert s1.gmg is not None
    out = sp.run(sp.ref.initial_state(), 3, deadline_s=DEADLINE)
    assert out["p_solver"] == "sharded_gmg"
    st1 = s1.initial_state()
    for k in range(3):
        st1, log1 = s1.step(st1)
        for key in ("p_rgh_iters_0", "p_rgh_iters_1"):
            it_s, it_1 = int(out["logs"][k][key]), int(log1[key])
            assert it_s <= 25, (k, key, it_s)
            assert it_s <= it_1 + 15, (k, key, it_s, it_1)
    g, n1 = out["state"], state_to_numpy(st1)
    for f, tol in (("T", 1e-6), ("p_rgh", 1e-4), ("U", 1e-5)):
        assert np.abs(g[f].i - n1[f].i).max() < tol, f
    rep = out["comm"][0][-1]["counts"]
    assert rep["all_gather"]["calls"] > 0  # the multigrid's coarsest level


def _seeded(sp, st0, n=120):
    """120 parcels across the domain with velocities that cross partition
    boundaries (tests/test_spmd_cloud.py's seeding)."""
    cst = dict(st0["cloud"])
    rng = np.random.RandomState(3)
    C = sp.gg.C.numpy()
    cells = rng.choice(len(C), n, replace=False)
    U = np.zeros((n, 3))
    U[:, 0] = 1.5 * np.sign(rng.randn(n))
    U[:, 2] = 1.0 * np.sign(rng.randn(n))

    def setcap(a, v):
        a = a.clone()
        a[:n] = torch.as_tensor(np.asarray(v), dtype=a.dtype)
        return a

    cst.update(x=setcap(cst["x"], C[cells]), U=setcap(cst["U"], U), d=setcap(cst["d"], 5e-4),
               nP=setcap(cst["nP"], 10.0), T=setcap(cst["T"], 310.0),
               cell=setcap(cst["cell"], cells), alive=setcap(cst["alive"], True))
    st0 = dict(st0)
    st0["cloud"] = cst
    return st0


def test_spray_fire_keeps_parcels_and_mass(tmp_path_factory):
    case = write_spray_fire_case(str(tmp_path_factory.mktemp("spmdspray")), n=N,
                                 collector=False, max_dt=0.002)
    sp = SpmdFireFoam(case, 4, device="cpu", partition="rcb")
    st = _seeded(sp, sp.ref.initial_state())
    rt = sp.gather_state(sp.scatter_state(st))
    alive = st["cloud"]["alive"].numpy()
    assert rt["cloud"]["alive"].sum() == alive.sum()
    n_steps = 3
    out = sp.run(st, n_steps, deadline_s=DEADLINE)
    migrated = 0
    for k in range(n_steps):
        st, log = sp.ref.step(st)
        got = out["logs"][k]
        assert int(got["cloud_nParcels"]) == int(log["cloud_nParcels"]), k
        assert got["cloud_mass"] == pytest.approx(float(log["cloud_mass"]), rel=1e-12), k
        assert int(got["cloud_migrOverflow"]) == 0
        migrated += int(got["cloud_migrated"])
    assert migrated > 0
    assert min(out["alive_per_rank"]) > 0
    g = out["state"]
    ga, ra = g["cloud"]["alive"], st["cloud"]["alive"].numpy()
    assert ga.sum() == ra.sum()
    xs = np.sort(g["cloud"]["x"][ga], axis=0)
    xr = np.sort(st["cloud"]["x"].numpy()[ra], axis=0)
    assert np.abs(xs - xr).max() < 1e-9


def test_spray_fire_parcels_held_back_go_later(tmp_path_factory):
    """A send capacity of one parcel a round holds parcels back; they keep
    their halo cell and go in a later round of the same substep, so the
    partitioned spray fire stays the single-device one: parcel counts and
    spray mass each step, the gas fields to 1e-10, and every parcel's
    position and cell."""
    case = write_spray_fire_case(str(tmp_path_factory.mktemp("spmdover")), n=N,
                                 collector=False, max_dt=0.002)
    sp = SpmdFireFoam(case, 4, device="cpu", partition="rcb", cap_send=1)
    st = _seeded(sp, sp.ref.initial_state())
    n_steps = 3
    out = sp.run(st, n_steps, deadline_s=DEADLINE)
    held = 0
    for k in range(n_steps):
        st, log = sp.ref.step(st)
        got = out["logs"][k]
        assert int(got["cloud_nParcels"]) == int(log["cloud_nParcels"]), k
        assert got["cloud_mass"] == pytest.approx(float(log["cloud_mass"]), rel=1e-12), k
        held += int(got["cloud_migrOverflow"])
    assert held > 0
    g = out["state"]
    for f in ("T", "U", "p_rgh"):
        assert _rel(g[f], st[f]) < 1e-10, f
    ga, ra = g["cloud"]["alive"], st["cloud"]["alive"].numpy()
    got = sorted(zip(map(tuple, g["cloud"]["x"][ga]), g["cloud"]["cell"][ga]))
    want = sorted(zip(map(tuple, st["cloud"]["x"].numpy()[ra]), st["cloud"]["cell"].numpy()[ra]))
    assert len(got) == len(want)
    for (xa, ca), (xb, cb) in zip(got, want):
        assert np.abs(np.subtract(xa, xb)).max() < 1e-9 and ca == cb


def _no_cloud_film_case(root):
    from firefoam_torch.utils.synthcase import write_wetted_panel_fire_case

    case = write_wetted_panel_fire_case(root, n=(8, 6, 8))
    with open(os.path.join(case, "constant", "additionalControls"), "w") as f:
        f.write("FoamFile { version 2.0; format ascii; class dictionary; "
                "object additionalControls; }\nsolvePrimaryRegion true;\n"
                "solvePyrolysisRegion false;\n")
    return case


@pytest.mark.parametrize("what", ["pyrolysis", "film", "fvOptions"])
def test_regions_raise_under_local(tmp_path_factory, what):
    from firefoam_torch.mesh import build_case_mesh as t_build
    from firefoam_torch.parallel.localize import LocalContext as TCtx
    from firefoam_torch.utils.synthcase import write_panel_fire_case, write_smooth_fire_case
    from firefoam_tpu.mesh import build_case_mesh as j_build
    from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
    from firefoam_tpu.parallel.localize import LocalContext as JCtx

    root = str(tmp_path_factory.mktemp(what))
    case = {"pyrolysis": lambda: write_panel_fire_case(root, n=(8, 6, 8)),
            "film": lambda: _no_cloud_film_case(root),
            "fvOptions": lambda: write_smooth_fire_case(root, n=(8, 6, 8))}[what]()
    match = {"pyrolysis": "pyrolysis", "film": "film", "fvOptions": "fvOptions"}[what]
    _, _, tctx = TCtx.build_all(t_build(case), 2, device="cpu", parts=[0])
    with pytest.raises(NotImplementedError, match=match):
        TSolver(case, local=tctx[0], enable_cloud=False)
    with pytest.MonkeyPatch.context() as mp:
        jax_flat_seg_env(mp)
        _, _, jctx = JCtx.build_all(j_build(case), 2)
        with pytest.raises(NotImplementedError, match=match):
            JSolver(case, local=jctx[0], enable_cloud=False)


@pytest.mark.slow
def test_partitioned_step_matches_jax_spmd(box):
    """The port's partitioned step against the JAX package's SpmdFireFoam
    (which traces one step program per partition) at P = 4 on the same box
    and state: one step, fields to 1e-10 and equal iteration counts."""
    from firefoam_tpu.parallel.spmd_step import SpmdFireFoam as JSpmd

    with pytest.MonkeyPatch.context() as mp:
        jax_flat_seg_env(mp)
        jsp = JSpmd(box, 4, partition="rcb")
        st0 = jsp.ref.initial_state()
        jstep = jsp.build_step(st0)
        stl, jlog = jstep(jsp.scatter_state(st0))
        jg = jsp.gather_state(jax.device_get(stl))
        jlog = jax.device_get(jlog)
    sp = SpmdFireFoam(box, 4, device="cpu", partition="rcb")
    assert np.array_equal(sp.lz.mp.part_of_cell, jsp.lz.mp.part_of_cell)
    out = sp.run(state_from_numpy(jax.device_get(st0), device="cpu", dtype=torch.float64), 1,
                 deadline_s=DEADLINE)
    for f in ("T", "U", "p_rgh", "rho", "k"):
        assert _rel(out["state"][f], jg[f]) < 1e-10, f
    for k in ITERS:
        assert int(out["logs"][0][k]) == int(jlog[k]), k
