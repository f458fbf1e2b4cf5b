"""The wall-fire step (write_wall_fire_case) of the port against the JAX
package on CPU in float64, with nothing pinned on either side (the
automatic rule: DIC-PCG on p_rgh and the hydrostatic init, the Krylov
twins elsewhere), through initial_state and make_step; the template is
tests/test_torch_step_default.py.

The case runs the gas-phase variants this slice ports, all at once: a
sheared (non-orthogonal) lattice with 'laplacianSchemes default Gauss
linear limited 0.5', div(phi,U) filteredLinear2V 0.2 0.05, LESModel WALE,
eddyDissipationBertExtModel with an Fstar specie (extinction from 0.3 s,
so the chain after 10 warm-up steps extinguishes and reignites), the fire
wall functions on the `wall` patch and nutUSpalding/alphatWallFunction on
`base`. tests/test_torch_wall_fire_baffle.py runs the same tests on the
baffled configuration (a ceiling baffle with compressible::thermalBaffle1D
on T).

The JAX package's BertExt model cannot run inside its jitted step as it
stands (SingleStepReaction.q_fuel builds a jnp array and converts it to
numpy, which fails on a tracer), so the test gives the JAX solver's
reaction its own host value of q_fuel before tracing; nothing else is
touched but the p_rgh flux below.

The port's p_rgh flux carries the deferred non-orthogonal correction's face
flux, as OpenFOAM's fvMatrix::flux() does; the JAX package's leaves it out,
and on this sheared mesh its phi then breaks continuity and the fire
diverges within a few steps (ROADMAP, reference fault R3). So the test adds
that face flux to the JAX solver's p_rgh flux too (`_with_corrected_flux`):
the p_rgh laplacian's matrix is the only one whose flux() is taken, and the
addition is the port's, operation for operation.
test_reference_flux_breaks_continuity shows the fault itself.

Tolerances (max-norm of the difference over the field's max-abs): the
initial state 1e-12 (hs over a floor of 1e3, as in the template); one step
from the same state and each step of a 5-step chain after 10 warm-up steps
1e-9 for T, U, p_rgh, Y, k, nut, alphat and dt, with equal iteration counts
for every logged solve."""

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy, state_to_numpy
from firefoam_torch.utils.synthcase import write_wall_fire_case

torch.set_num_threads(1)
N = (10, 8, 10)
N_STEPS = 5
WARMUP = 10
FIELDS = ("T", "U", "p_rgh", "Y", "k", "nut", "alphat", "dt")
_SOLVER_ENV = ("EXACT_SOLVERS", "AMG", "GMG", "GMG_COARSEST", "PALLAS", "P64_PRGH", "PAIRMG")


def _rel(a, b, floor=0.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), floor, 1e-300))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _with_corrected_flux(mp):
    """Add Γ_f|Sf|·corr to the flux() of every JAX laplacian matrix built
    with a scalar correction (the p_rgh equation's)."""
    from firefoam_tpu.ops import fvm as jfvm

    made, laplacian, flux = [], jfvm.laplacian, jfvm.FvMatrix.flux

    def corrected_laplacian(geom, gamma, psi, gic, gbc, corr=None):
        m = laplacian(geom, gamma, psi, gic, gbc, corr=corr)
        if corr is not None and corr.ndim == 1:
            made.append((m.source, gamma.i * geom.magSf * corr))
        return m

    def corrected_flux(self):
        out = flux(self)
        for source, add in made:
            if self.source is source:
                return type(out)(out.i + add, out.b)
        return out

    mp.setattr(jfvm, "laplacian", corrected_laplacian)
    mp.setattr(jfvm.FvMatrix, "flux", corrected_flux)


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif isinstance(v, tuple):
            yield f"{prefix}{k}.i", v.i
            yield f"{prefix}{k}.b", v.b
        else:
            yield prefix + k, v


def run_both(baffle, tmp_path_factory):
    """(baffle, JAX solver, port solver, the JAX run's states and logs)."""
    root = write_wall_fire_case(str(tmp_path_factory.mktemp("wall")), n=N, baffle=baffle)
    with pytest.MonkeyPatch.context() as mp:
        for k in _SOLVER_ENV:
            mp.delenv(f"FIREFOAM_TPU_{k}", raising=False)
        mp.setenv("FIREFOAM_TPU_DTYPE", "float64")
        _with_corrected_flux(mp)
        js = JSolver(root)
        q_fuel = js.reaction.q_fuel()
        js.reaction.q_fuel = lambda: q_fuel
        st = js.initial_state()
        step = js.make_step()
        states, logs = [jax.device_get(st)], []
        for _ in range(WARMUP + N_STEPS):
            st, log = step(st)
            states.append(jax.device_get(st))
            logs.append(jax.device_get(log))
    ts = TSolver(root, device="cpu")
    return baffle, js, ts, states, logs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_both(False, tmp_path_factory)


def test_the_case_runs_the_variants_it_names(run):
    baffle, js, ts, states, _ = run
    assert ts.dtype == torch.float64 and ts._ldu is not None and js._ldu is not None
    assert ts.lap_limiter == js.lap_limiter == 0.5
    assert ts.u_div_scheme == js.u_div_scheme == ("filteredLinear2", 0.2, 0.05)
    assert ts.turb.model == js.turb.model == "WALE"
    assert ts.combustion.variant == js.combustion.variant == "eddyDissipationBertExtModel"
    assert ts.combustion.fstar_index == js.combustion.fstar_index == 5
    assert np.array_equal(_np(ts._near_wall_mask), np.asarray(js._near_wall_mask))
    assert [p.name for p in ts.geom.patches] == [p.name for p in js.geom.patches]
    assert ("baffle_master" in [p.name for p in ts.geom.patches]) == baffle
    end = states[-1]
    wall = ts.geom.patch("wall").slice
    assert float(np.max(np.abs(end["alphat"].b[wall]))) > 0.0  # the fire wall function acted
    assert float(np.max(end["Y"].i[:, 5])) > 1e-4  # fuel was quenched into Fstar
    assert float(end["t"]) > 0.3  # the chain runs after ExtinctionStart


def test_initial_state_matches(run):
    _, _, ts, states, _ = run
    ours = dict(_leaves(state_to_numpy(ts.initial_state())))
    ref = dict(_leaves(states[0]))
    assert set(ours) == set(ref)
    for name, b in ref.items():
        floor = 1e3 if name.startswith("hs.") else 1.0
        assert _rel(ours[name], b, floor=floor) <= 1e-12, name


def _check(ours, log, n, states, logs):
    for f in FIELDS:
        assert _rel(_np(getattr(ours[f], "i", ours[f])),
                    np.asarray(getattr(states[n + 1][f], "i", states[n + 1][f]))) <= 1e-9, (n, f)
    for f in ("nut", "alphat"):
        assert _rel(_np(ours[f].b), np.asarray(states[n + 1][f].b)) <= 1e-9, (n, f)
    its = [k for k in logs[n] if k.endswith("_iters") or "_iters_" in k]
    assert "Fstar_iters" in its and len(its) == 12
    for k in its:
        assert int(log[k]) == int(logs[n][k]), (n, k, int(log[k]), int(logs[n][k]))


def test_one_step_from_the_same_state(run):
    _, _, ts, states, logs = run
    for n in (0, 1):
        ours, log = ts.make_step()(state_from_numpy(states[n], device="cpu", dtype=torch.float64))
        _check(ours, log, n, states, logs)


def test_five_chained_steps(run):
    _, _, ts, states, logs = run
    st = state_from_numpy(states[WARMUP], device="cpu", dtype=torch.float64)
    step = ts.make_step()
    for n in range(WARMUP, WARMUP + N_STEPS):
        st, log = step(st)
        _check(st, log, n, states, logs)
