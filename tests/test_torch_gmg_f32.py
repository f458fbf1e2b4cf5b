"""Fault F4 of the roadmap, told apart: in float32, does the port's lattice
multigrid on p_rgh leave its Jacobi-CG run as the JAX package's does?

Both packages run the box fire on the CPU in float32 from one developed
state (the JAX package's own, after WARMUP steps with the CG), then STEPS
more steps with the multigrid off and on: JAX with FIREFOAM_TPU_GMG=0/1,
the port with gmg=False/True (AMG and the exact solvers off on both sides).
Printed: the max |dT| and |dU| of multigrid against CG in each package, and
of each port run against the JAX run with the same solver.

As a test (a small lattice): both packages' departures stay inside
tests/test_gmg.py's 0.5 K, and the port's lies within a factor of 4 of the
reference's either way. As a script, at any lattice:

    JAX_PLATFORMS=cpu python tests/test_torch_gmg_f32.py 50,40,50 15
"""

import json
import os
import sys
import tempfile

import numpy as np
import torch

N = (12, 8, 10)
WARMUP = 10
STEPS = 5
_ENV = {"FIREFOAM_TPU_DTYPE": "float32", "FIREFOAM_TPU_PALLAS": "0",
        "FIREFOAM_TPU_EXACT_SOLVERS": "0", "FIREFOAM_TPU_AMG": "0"}
_SOLVER_ENV = ("GMG_COARSEST", "P64_PRGH", "PAIRMG")


def departures(root, warmup, steps, setenv):
    """The departures described in the module docstring, for the case at
    `root`; `setenv(name, value)` sets an environment variable for the JAX
    solvers' constructors."""
    import jax
    from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
    from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
    from firefoam_torch.models.firefoam import state_from_numpy

    for k, v in _ENV.items():
        setenv(k, v)

    def jax_run(gmg, state, n):
        setenv("FIREFOAM_TPU_GMG", "1" if gmg else "0")
        js = JSolver(root)
        assert (js.gmg is not None) == gmg and js.amg is None and js._ldu is None
        step = js.make_step()
        state = js.initial_state() if state is None else state
        for _ in range(n):
            state, _ = step(state)
        return jax.device_get(state)

    start = jax_run(False, None, warmup)
    ref = {gmg: jax_run(gmg, start, steps) for gmg in (False, True)}
    ours = {}
    for gmg in (False, True):
        ts = TSolver(root, device="cpu", dtype=torch.float32, gmg=gmg, amg=False,
                     exact_solvers=False)
        assert (ts.gmg is not None) == gmg
        st = state_from_numpy(start, device="cpu", dtype=torch.float32)
        ours[gmg], _ = ts.make_chunk(steps)(st)

    def field(s, f):
        x = s[f].i
        return np.asarray(x.numpy() if torch.is_tensor(x) else x, np.float64)

    def dep(a, b):
        return {f"d{f}": float(np.max(np.abs(field(a, f) - field(b, f)))) for f in ("T", "U")}

    return {
        "jax_gmg_vs_cg": dep(ref[True], ref[False]),
        "port_gmg_vs_cg": dep(ours[True], ours[False]),
        "port_cg_vs_jax_cg": dep(ours[False], ref[False]),
        "port_gmg_vs_jax_gmg": dep(ours[True], ref[True]),
        "T_max_start": float(np.max(start["T"].i)),
        "t_start": float(start["t"]),
    }


def test_the_port_departs_as_the_reference_does(tmp_path, monkeypatch):
    from firefoam_torch.utils.synthcase import write_box_fire_case

    torch.set_num_threads(1)
    for k in _SOLVER_ENV:
        monkeypatch.delenv(f"FIREFOAM_TPU_{k}", raising=False)
    root = write_box_fire_case(str(tmp_path / "box"), n=N)
    out = departures(root, WARMUP, STEPS, monkeypatch.setenv)
    print(json.dumps(out))
    assert out["T_max_start"] > 330.0  # the fire has heated the gas (298.15 K at t = 0)
    ref, ours = out["jax_gmg_vs_cg"]["dT"], out["port_gmg_vs_cg"]["dT"]
    assert max(ref, ours) < 0.5
    assert 0.25 * ref <= ours <= 4.0 * ref


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from firefoam_torch.utils.synthcase import write_box_fire_case

    for k in _SOLVER_ENV:
        os.environ.pop(f"FIREFOAM_TPU_{k}", None)
    n = tuple(int(v) for v in sys.argv[1].split(",")) if len(sys.argv) > 1 else N
    warmup = int(sys.argv[2]) if len(sys.argv) > 2 else WARMUP
    with tempfile.TemporaryDirectory() as tmp:
        case = write_box_fire_case(os.path.join(tmp, "box"), n=n)
        print(json.dumps(departures(case, warmup, STEPS, os.environ.__setitem__), indent=1))
