"""The run CLI on the banded layout with smoothSolver: the port's run_case
against the JAX package's on the CPU in float64.

The case is write_smooth_fire_case castellated around the obstruction
(synthcase.castellate_case) into the smallest slender column that takes
layout="banded" with more than 16 offsets: n=(2,3,6) at 5 cm cells, 58
cells and 18 offsets in its own numbering. Yi, h and k are on smoothSolver
+ symGaussSeidel, with the function objects (volFieldValue, fieldMinMax,
probes), fvOptions, RTI probes and links. Both sides are pinned to the flat
solvers, so that Yi, h and k run the damped Jacobi smoother (K3's twin on
the CPU, dia_krylov.dia_smooth), as the card runs them: the JAX package
with tests/test_torch_banded_step.py's jax_banded_env and
FIREFOAM_TPU_EXACT_SOLVERS=0, the port with layout="banded",
exact_solvers=False, gmg=False, amg=False. The checks of
tests/test_torch_run.py, on this mesh:
  * the time directory both packages wrote at step 10 from t = 0 agrees to
    print precision (2e-8 of each value plus 1e-9 of the file's largest);
  * resumed from the JAX package's checkpoint of step 10, the port's
    function-object and rtis rows and state agree with the JAX run's last
    steps to 1e-9, with equal iteration counts;
  * the port's own resume is bit-exact: 4 steps in chunks of 2 against 2
    steps, checkpoint, resume and 2 more;
and the smoothSolver systems of a step (the Yi batch, h and k) go to
dia_krylov.dia_smooth with the banded offsets.
"""

import os
import shutil

import numpy as np
import pytest

import jax
import torch

from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_tpu.models.run import run_case as j_run_case
from firefoam_torch.io.checkpoint import latest_checkpoint
from firefoam_torch.models import run as trun
from firefoam_torch.models.firefoam import state_from_numpy
from firefoam_torch.solvers import dia_krylov
from firefoam_torch.utils.synthcase import castellate_case, write_smooth_fire_case

from test_torch_banded_step import jax_banded_env
from test_torch_run import _np, _rel, test_resume_is_bit_exact  # noqa: F401
from test_torch_run import test_written_time_dirs_match_jax  # noqa: F401

torch.set_num_threads(1)

N = (2, 3, 6)
SIZE = (0.1, 0.15, 0.3)
WARMUP, STEPS = 10, 6  # the values tests/test_torch_run.py's tests read
# runTime writes: t after steps 9, 10 and 16 is 0.234, 0.249 and 0.336, so one write,
# at step 10
WRITE = 0.24
PORT = dict(layout="banded", exact_solvers=False, gmg=False, amg=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run_case over WARMUP + STEPS steps writing at step WARMUP; the
    port's from t = 0 over the same steps (run A); the port's resumed from
    the JAX checkpoint of step WARMUP (run B). The names are those
    tests/test_torch_run.py's tests take."""
    base = tmp_path_factory.mktemp("bandedrun")
    src = write_smooth_fire_case(str(base / "case"), n=N, size=SIZE, end_time=5.0,
                                 write_control="runTime", write_interval=WRITE)
    castellate_case(src, size=SIZE)
    roots = {k: str(base / k) for k in ("jax", "a", "b")}
    for r in roots.values():
        shutil.copytree(src, r)
    out = {k: str(base / f"out_{k}") for k in roots}
    with pytest.MonkeyPatch.context() as mp:
        jax_banded_env(mp)
        js, jstate, jlogs = j_run_case(roots["jax"], max_steps=WARMUP + STEPS, verbose=False,
                                       solver=JSolver(roots["jax"]), output_dir=out["jax"],
                                       write_fields=True)
        js.function_objects.write()
        js.rtis.write(js.function_objects.out_dir)
        jstate = jax.device_get(jstate)
    ta, _, _ = trun.run_case(roots["a"], max_steps=WARMUP + STEPS, verbose=False, device="cpu",
                             output_dir=out["a"], write_fields=True, **PORT)
    jckpt = latest_checkpoint(out["jax"])
    tb, tstate, tlogs = trun.run_case(roots["b"], max_steps=STEPS, verbose=False, device="cpu",
                                      resume=jckpt, **PORT)
    tb.function_objects.write()
    tb.rtis.write(tb.function_objects.out_dir)
    return dict(base=base, roots=roots, out=out, js=js, jstate=jstate, jlogs=jlogs, ta=ta,
                tb=tb, tstate=tstate, tlogs=tlogs, jckpt=jckpt)


def test_both_run_banded_with_the_flat_solvers(runs):
    js, ta, tb = runs["js"], runs["ta"], runs["tb"]
    assert js.geom.layout == ta.geom.layout == tb.geom.layout == "dia"
    offs = tuple(int(o) for o in js.geom.offsets)
    assert ta.geom.offsets == tb.geom.offsets == offs and len(offs) > 16
    for s in (js, ta, tb):
        assert s._ldu is None and s.gmg is None and s.amg is None


def test_jax_checkpoint_resumes_in_port(runs):
    js, tb = runs["js"], runs["tb"]
    assert len(runs["tlogs"]) == STEPS
    for jf, tf in zip(js.function_objects.fos, tb.function_objects.fos):
        assert tf.name == jf.name
        assert len(tf.rows) == STEPS and len(tf.rows[0]) == len(jf.rows[0]) > 1, tf.name
        assert _rel(tf.rows, jf.rows[WARMUP:]) <= 1e-9, tf.name
    assert _rel(tb.rtis.rows, js.rtis.rows[WARMUP:]) <= 1e-9
    for f in ("T", "U", "p_rgh", "Y", "k"):
        assert _rel(_np(runs["tstate"][f].i), runs["jstate"][f].i) <= 1e-9, f
    assert _rel(_np(runs["tstate"]["phi"].i), runs["jstate"]["phi"].i) <= 1e-9
    n = 0
    for log, ref in zip(runs["tlogs"], runs["jlogs"][WARMUP:]):
        for k in ref:
            if k.endswith("_iters") or "iters_" in k:
                assert int(log[k]) == int(ref[k]), k
                n += 1
    assert n > 0
    for sub in ("HRR/0/volFieldValue.dat", "plume/0/probes.dat", "rtis/0/rtis.dat"):
        a = np.loadtxt(os.path.join(runs["roots"]["b"], "postProcessing", sub))
        b = np.loadtxt(os.path.join(runs["roots"]["jax"], "postProcessing", sub))
        np.testing.assert_allclose(a, b[WARMUP:], rtol=2e-8, atol=0, err_msg=sub)


def test_smooth_solver_systems_route_to_k3(runs, monkeypatch):
    """One step of run A's solver from the JAX state of step WARMUP: the
    Yi batch, h and k reach dia_krylov.dia_smooth (K3; its twin on the CPU)
    with the banded offsets, p_rgh dia_pcg and U dia_bicgstab."""
    ts = runs["ta"]
    calls = {"dia_smooth": [], "dia_pcg": [], "dia_bicgstab": []}
    for name, got in calls.items():
        orig = getattr(dia_krylov, name)

        def shim(*a, _orig=orig, _got=got, **k):
            _got.append(a)
            return _orig(*a, **k)

        monkeypatch.setattr(dia_krylov, name, shim)
    state = state_from_numpy(jax.device_get(runs["jstate"]), device="cpu", dtype=torch.float64)
    _, log = ts.step(state)
    smooth = calls["dia_smooth"]
    assert len(smooth) == 3 and all(a[5] == ts.geom.offsets for a in smooth)
    rows = sorted(a[4].shape[0] if a[4].ndim == 2 else 1 for a in smooth)
    solved = sum(f"{s}_iters" in log for s in ts.species)  # all but the inert specie
    assert rows == [1, 1, solved] and solved == len(ts.species) - 1 > 1
    assert len(calls["dia_pcg"]) == 2 and len(calls["dia_bicgstab"]) >= 1
    assert all(a[5] == ts.geom.offsets for v in calls.values() for a in v)
