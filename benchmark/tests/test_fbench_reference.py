"""The plain reference (plainfire) against the port's CPU path with the
same plain solvers, on the room fire at the steckler demo's 0.2 m, for a
few steps (the first solves the rays): bitwise equal in float64 and in
float32. So the copy is the port's step as it stood when the benchmark was
made; a later change to the port shows against it."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from fbench.check import snapshot
from fbench.inputs import apply_inputs, draw_inputs
from firefoam_torch.models.firefoam import FireFoamSolver as Port
from plainfire.models.firefoam import FireFoamSolver as Plain

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
# the port on the plain solvers the copy keeps (its float64 default on the
# CPU is the OpenFOAM-exact DIC schedule)
PORT_SOLVERS = dict(exact_solvers=False, gmg=False, amg=False)


def _leaves(d, pre=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{pre}{k}.")
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from _leaves(v, f"{pre}{i}.")
    else:
        yield pre, np.asarray(d)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "steckler_room", os.path.join(BENCH, "cases", "steckler_room.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.write(str(tmp_path_factory.mktemp("room") / "case"), h=0.2,
                     control_dict={"writeControl": "timeStep", "writeInterval": 1000000})


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reference_follows_the_port(case, dtype):
    out = []
    for make in (lambda: Port(case, device="cpu", dtype=dtype, **PORT_SOLVERS),
                 lambda: Plain(case, device="cpu", dtype=dtype)):
        s = make()
        st = apply_inputs(s.initial_state(),
                          draw_inputs(2**33 + 7, s.geom.n_cells, {"u_amplitude": 0.01}))
        for _ in range(STEPS):
            st, _ = s.step(st)
        out.append(dict(_leaves(snapshot(st))))
    a, b = out
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def test_reference_refuses_what_it_leaves_out(case, tmp_path):
    import shutil

    other = str(tmp_path / "spray")
    shutil.copytree(case, other)
    with open(os.path.join(other, "constant", "reactingCloud1Properties"), "w") as f:
        f.write("FoamFile { version 2.0; format ascii; class dictionary; }\n")
    with pytest.raises(NotImplementedError):
        Plain(other, device="cpu", dtype=torch.float64)
