"""The run CLI on the hybrid layout: `python -m firefoam_torch.models.run
--cpu --layout hybrid` writes the same time directories and function-object
rows as `--layout seg`, on the CPU in float64.

The case is write_smooth_fire_case at n=(8,6,8) castellated around the
obstruction (synthcase.castellate_case; 525 cells, 5 lanes), writing at
runTime intervals of 0.05 s, with a faceZonesIntegration of phi over the
burner's face zone added to its function objects. The surface fields the
writer emits and the zone sums reach the face slots through `face_perm`,
which differs between the layouts.
  * `--pairmg 0`: both layouts run the same solvers (the OpenFOAM-exact
    DIC-PCG on p_rgh in float64), so every number of every written file and
    every dat row agrees to print precision (2e-8 of the value plus 1e-9 of
    the file's largest), as tests/test_torch_run.py holds the port to JAX;
  * `--pairmg 1 --exact-solvers 0` (the index-pair multigrid on p_rgh)
    against `--layout seg --exact-solvers 0 --amg 0` (the Jacobi-CG): two
    solvers that stop at the same dictionary tolerances, so the files agree
    to STOP_TOL of the file's largest value.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from firefoam_torch.models import run as trun
from firefoam_torch.utils.synthcase import castellate_case, write_smooth_fire_case

torch.set_num_threads(1)
N = (8, 6, 8)
STEPS = 8
WRITE = 0.05
# two p_rgh solvers stopping at the dictionary's tolerances (1e-6 on the
# normalised residual, relTol 0.01 before the final corrector) leave the
# fields apart by this share of the largest
STOP_TOL = 1e-4
_NUM = re.compile(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?")

RUNS = {
    "seg": ["--layout", "seg"],
    "hybrid": ["--layout", "hybrid", "--pairmg", "0"],
    "seg_cg": ["--layout", "seg", "--exact-solvers", "0", "--amg", "0"],
    "hybrid_pairmg": ["--layout", "hybrid", "--pairmg", "1", "--exact-solvers", "0"],
}


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    base = tmp_path_factory.mktemp("hybrun")
    src = write_smooth_fire_case(str(base / "case"), n=N, end_time=5.0,
                                 write_control="runTime", write_interval=WRITE)
    castellate_case(src)
    cd = os.path.join(src, "system", "controlDict")
    with open(cd) as f:
        text = f.read()
    with open(cd, "w") as f:
        f.write(text.replace(
            "functions\n{", "functions\n{\n    burnerFlux { type faceZonesIntegration; "
                            "faceZones (burner); fields (phi); }", 1))
    out = {}
    for name, flags in RUNS.items():
        root = str(base / name)
        shutil.copytree(src, root)
        out[name] = str(base / f"out_{name}")
        assert trun.main(["--case", root, "--cpu", "--quiet", "--max-steps", str(STEPS),
                          "--output", out[name]] + flags) == 0
        shutil.copytree(os.path.join(root, "postProcessing"),
                        os.path.join(out[name], "postProcessing"))
    return out


def _numbers(path):
    with open(path) as f:
        text = f.read()
    if "dimensions" in text:
        text = text.split("dimensions", 1)[1]
    return np.array([float(x) for x in _NUM.findall(text)])


def _files(root):
    """Every written file under an output root (time directories and the
    function objects' dat files), by relative path."""
    found = {}
    for d, _, names in os.walk(root):
        for nm in names:
            if nm.endswith(".npz"):
                continue
            p = os.path.join(d, nm)
            found[os.path.relpath(p, root)] = p
    return found


def _compare(a_root, b_root, rel, abs_of_max):
    fa, fb = _files(a_root), _files(b_root)
    assert sorted(fa) == sorted(fb)
    times = {p.split(os.sep)[0] for p in fa if p.split(os.sep)[0][0].isdigit()}
    assert len(times) >= 2, times
    for name in fa:
        a, b = _numbers(fa[name]), _numbers(fb[name])
        assert a.shape == b.shape, name
        tol = rel * np.abs(b) + abs_of_max * np.max(np.abs(b), initial=0.0)
        assert np.all(np.abs(a - b) <= tol), (name, float(np.max(np.abs(a - b) - tol)))
    return fa


def test_hybrid_writes_what_seg_writes(outs):
    files = _compare(outs["hybrid"], outs["seg"], 2e-8, 1e-9)
    assert any(os.path.basename(p).startswith("phi") for p in files)  # surface fields
    dats = [p for p in files if "burnerFlux" in p]
    assert dats
    rows = _numbers(files[dats[0]])
    assert rows.size and np.abs(rows).max() > 0.0


def test_pairmg_run_writes_what_the_flat_run_writes(outs):
    _compare(outs["hybrid_pairmg"], outs["seg_cg"], 0.0, STOP_TOL)
