"""The castellated fire on the SEG layout: the port's FireFoamSolver against
the JAX package's on the CPU in float64, through initial_state and
make_step.

The case is write_castellated_fire_case at n=(8,6,8): the box fire's
background lattice refined to level 1 around a searchableBox obstruction,
525 cells, 1,456 internal faces, cells with up to 9 faces (2:1 hanging
nodes), the obstruction's faces a `box` wall patch. No DIA stencil fits,
so both packages take the SEG layout (the JAX side is pinned to it with
FIREFOAM_TPU_LAYOUT=seg; it would pick it by itself off a TPU). The JAX
side also runs with FIREFOAM_TPU_LATTICE_BC=0: its lattice boundary-slab
scatter (a TPU fast path, not ported) finds blocks in this mesh's boundary
and takes minutes to trace; off, its boundary sums are segment_sums, the
sums the port's collision-free groups make.

Configurations:
  * unpinned: float64's automatic rule on both sides, the OpenFOAM-exact
    DIC-PCG on p_rgh and the hydrostatic init, PBiCGStab's flat twin on U,
    Yi, h, k and the fvDOM rays;
  * flat: port exact_solvers=False, JAX FIREFOAM_TPU_EXACT_SOLVERS=0: with
    the DIC schedule off both packages put AMG on p_rgh.

Tolerances (max-norm of the difference over the field's max-abs), as in
tests/test_torch_step.py: initial_state 1e-12; one step from the same
state and every step of a 5-step chain after 10 warm-up steps (the first of
them a radiation step) 1e-9 for T, U, p_rgh, Y, k and dt, with equal
iteration counts for every logged solve.
"""

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy, state_to_numpy
from firefoam_torch.utils.synthcase import write_castellated_fire_case

torch.set_num_threads(1)
N = (8, 6, 8)
N_STEPS = 5
WARMUP = 10
FIELDS = ("T", "U", "p_rgh", "Y", "k", "dt")
ITERS = ("Ux_iters", "Uy_iters", "Uz_iters", "p_rgh_iters_0", "p_rgh_iters_1", "k_iters",
         "h_iters", "O2_iters", "C3H8_iters", "H2O_iters", "CO2_iters")
_SOLVER_ENV = ("EXACT_SOLVERS", "AMG", "GMG", "GMG_COARSEST", "PALLAS", "P64_PRGH", "PAIRMG",
               "HYBRID", "PER_OFFSET")

# name → (JAX environment, the port's arguments)
CONFIGS = {
    "unpinned": ({}, {}),
    "flat": ({"FIREFOAM_TPU_EXACT_SOLVERS": "0"}, {"exact_solvers": False}),
}


def _rel(a, b, floor=0.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), floor, 1e-300))


def _cells(x):
    x = getattr(x, "i", x)
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif isinstance(v, tuple):
            yield f"{prefix}{k}.i", v.i
            yield f"{prefix}{k}.b", v.b
        else:
            yield prefix + k, v


def jax_seg_env(mp, env):
    """Pin the JAX package to the SEG layout with segment-sum boundary sums,
    float64, and `env`'s solvers."""
    for k in _SOLVER_ENV:
        mp.delenv(f"FIREFOAM_TPU_{k}", raising=False)
    for k, v in env.items():
        mp.setenv(k, v)
    mp.setenv("FIREFOAM_TPU_LAYOUT", "seg")
    mp.setenv("FIREFOAM_TPU_LATTICE_BC", "0")
    mp.setenv("FIREFOAM_TPU_DTYPE", "float64")


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request, tmp_path_factory):
    """The JAX trajectory (computed once per configuration) and the port's
    solver on the same castellated case."""
    env, kwargs = CONFIGS[request.param]
    root = write_castellated_fire_case(str(tmp_path_factory.mktemp("castel")), n=N)
    with pytest.MonkeyPatch.context() as mp:
        jax_seg_env(mp, env)
        js = JSolver(root)
        st = js.initial_state()
        step = js.make_step()
        states, logs = [jax.device_get(st)], []
        for _ in range(WARMUP + N_STEPS):
            st, log = step(st)
            states.append(jax.device_get(st))
            logs.append(jax.device_get(log))
    ts = TSolver(root, device="cpu", **kwargs)
    return request.param, js, ts, states, logs


def test_both_take_seg_and_the_same_solvers(run):
    name, js, ts, _, _ = run
    assert js.geom.layout == "seg" and ts.geom.layout == "seg"
    assert ts.geom.n_internal == js.geom.n_internal == ts.cm.mesh.n_internal_faces
    assert ts.gmg is None and js.gmg is None
    assert (ts._ldu is None) == (js._ldu is None) == (name == "flat")
    assert (ts.amg is None) == (js.amg is None) == (name == "unpinned")
    # the castellation has cells with more than 6 faces
    m = ts.cm.mesh
    faces = np.bincount(m.owner, minlength=m.n_cells) + np.bincount(m.neighbour,
                                                                   minlength=m.n_cells)
    assert faces.max() > 6


def test_initial_state_matches(run):
    _, _, ts, states, _ = run
    ours = dict(_leaves(state_to_numpy(ts.initial_state())))
    ref = dict(_leaves(states[0]))
    assert set(ours) == set(ref)
    for name, b in ref.items():
        floor = 1e3 if name.startswith("hs.") else 1.0
        assert _rel(ours[name], b, floor=floor) <= 1e-12, name


def test_one_step_from_the_same_state(run):
    _, _, ts, states, logs = run
    step = ts.make_step()
    for n in (0, WARMUP):
        ours, log = step(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
        for f in FIELDS:
            assert _rel(_cells(ours[f]), _cells(states[n + 1][f])) <= 1e-9, (n, f)
        for k in ITERS:
            assert int(log[k]) == int(logs[n][k]), (n, k)


def test_five_chained_steps(run):
    _, _, ts, states, logs = run
    start = state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    assert int(start["rad"]["count"]) % 10 == 0  # a radiation step comes first
    step = ts.make_step()
    st = start
    for n in range(WARMUP, WARMUP + N_STEPS):
        st, log = step(st)
        for f in FIELDS:
            assert _rel(_cells(st[f]), _cells(states[n + 1][f])) <= 1e-9, (n, f)
        for k in ITERS:
            assert int(log[k]) == int(logs[n][k]), (n, k)
        assert _rel(st["rad"]["G"].numpy(), states[n + 1]["rad"]["G"]) <= 1e-9
    # the gas burns: T has risen above ambient
    assert float(st["T"].i.max()) > 300.0
