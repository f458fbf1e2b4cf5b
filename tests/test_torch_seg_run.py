"""The run CLI on a castellated case (SEG layout): the port's run_case
against the JAX package's on the CPU in float64, with nothing pinned but
the JAX side's layout (FIREFOAM_TPU_LAYOUT=seg, FIREFOAM_TPU_LATTICE_BC=0 as
in tests/test_torch_seg_step.py).

The case is write_smooth_fire_case at n=(6,5,6) castellated around the
obstruction (synthcase.castellate_case; 237 cells): smoothSolver +
symGaussSeidel on Yi, h and k, the function objects (volFieldValue,
fieldMinMax, probes), fvOptions, RTI probes and links. The checks of
tests/test_torch_run.py, on this mesh:
  * the time directory both packages wrote at step 10 from t = 0 agrees to
    print precision (2e-8 of each value plus 1e-9 of the file's largest);
    its surface fields are in the mesh's own face order (face_perm is the
    identity on SEG);
  * resumed from the JAX package's checkpoint of step 10, the port's
    function-object and rtis rows and state agree with the JAX run's last
    steps to 1e-9;
  * the port's own resume is bit-exact: 4 steps in chunks of 2 against 2
    steps, checkpoint, resume and 2 more.
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
from firefoam_torch.utils.synthcase import castellate_case, write_smooth_fire_case

from test_torch_run import _np, _rel, test_resume_is_bit_exact  # noqa: F401
from test_torch_run import test_written_time_dirs_match_jax  # noqa: F401

torch.set_num_threads(1)

N = (6, 5, 6)
WARMUP, STEPS = 10, 6  # the values tests/test_torch_run.py's tests read
# runTime writes: t after steps 9 and 10 is 0.559 and 0.659, so one write,
# at step 10 (as in tests/test_torch_run.py)
WRITE = 0.64


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run_case over WARMUP + STEPS steps writing at step WARMUP; the
    port's from t = 0 over the same steps (run A); the port's resumed from
    the JAX checkpoint of step WARMUP (run B). The names are those
    tests/test_torch_run.py's tests take."""
    base = tmp_path_factory.mktemp("segrun")
    src = write_smooth_fire_case(str(base / "case"), n=N, end_time=5.0, write_control="runTime",
                                 write_interval=WRITE)
    castellate_case(src)
    roots = {k: str(base / k) for k in ("jax", "a", "b")}
    for r in roots.values():
        shutil.copytree(src, r)
    out = {k: str(base / f"out_{k}") for k in roots}
    with pytest.MonkeyPatch.context() as mp:
        for k in ("EXACT_SOLVERS", "AMG", "GMG", "PALLAS", "HYBRID"):
            mp.delenv(f"FIREFOAM_TPU_{k}", raising=False)
        mp.setenv("FIREFOAM_TPU_DTYPE", "float64")
        mp.setenv("FIREFOAM_TPU_LAYOUT", "seg")
        mp.setenv("FIREFOAM_TPU_LATTICE_BC", "0")
        js, jstate, jlogs = j_run_case(roots["jax"], max_steps=WARMUP + STEPS, verbose=False,
                                       solver=JSolver(roots["jax"]), output_dir=out["jax"],
                                       write_fields=True)
        js.function_objects.write()
        js.rtis.write(js.function_objects.out_dir)
        jstate = jax.device_get(jstate)
    ta, _, _ = trun.run_case(roots["a"], max_steps=WARMUP + STEPS, verbose=False, device="cpu",
                             output_dir=out["a"], write_fields=True, layout="seg")
    jckpt = latest_checkpoint(out["jax"])
    tb, tstate, tlogs = trun.run_case(roots["b"], max_steps=STEPS, verbose=False, device="cpu",
                                      resume=jckpt)
    tb.function_objects.write()
    tb.rtis.write(tb.function_objects.out_dir)
    return dict(base=base, roots=roots, out=out, js=js, jstate=jstate, jlogs=jlogs, ta=ta,
                tb=tb, tstate=tstate, tlogs=tlogs, jckpt=jckpt)


def test_both_run_seg_with_the_exact_solvers(runs):
    js, ta, tb = runs["js"], runs["ta"], runs["tb"]
    assert js.geom.layout == ta.geom.layout == tb.geom.layout == "seg"
    assert js._ldu is not None and tb._ldu is not None and tb.amg is None
    np.testing.assert_array_equal(tb.geom.face_perm, np.arange(tb.cm.mesh.n_internal_faces))


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
    for log, ref in zip(runs["tlogs"], runs["jlogs"][WARMUP:]):
        for k in ref:
            if k.endswith("_iters") or "iters_" in k:
                assert int(log[k]) == int(ref[k]), k
    for sub in ("HRR/0/volFieldValue.dat", "plume/0/probes.dat", "rtis/0/rtis.dat"):
        a = np.loadtxt(os.path.join(runs["roots"]["b"], "postProcessing", sub))
        b = np.loadtxt(os.path.join(runs["roots"]["jax"], "postProcessing", sub))
        np.testing.assert_allclose(a, b[WARMUP:], rtol=2e-8, atol=0, err_msg=sub)
