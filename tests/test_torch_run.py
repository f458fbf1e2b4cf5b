"""The run surface of the port (firefoam_torch.models.run and what it
drives: fvOptions, function objects, RTI probes and links, the writer, the
checkpoint) against the JAX package's, on CPU in float64.

On a small box fire with every run feature (write_smooth_fire_case), the
JAX run_case and the port's run_case run the same steps and must agree on:
  * the function-object rows, the rtis rows, the RTI-link fields and the
    state, to 1e-9 relative, where the port resumes from the checkpoint the
    JAX run wrote at step 10 (a developed state);
  * the time directory both wrote at step 10 from t = 0, every number
    parsed back, to print precision (8 significant digits: 2e-8 of the
    value plus 1e-9 of the file's largest value, for last-digit rounding of
    values computed in another order);
  * the key sets of the two packages' checkpoints, each loading into the
    other.
Also: fvOptions sources against the JAX FvOptions on the fixture of
tests/test_fvoptions.py, a bit-exact resume in the port, `main --cpu`, and
that the port asks for a card unless the caller passes device="cpu".
"""

import os
import re
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from firefoam_tpu.io.checkpoint import load_checkpoint as j_load_checkpoint
from firefoam_tpu.models.firefoam import FireFoamSolver as JSolver
from firefoam_tpu.models.fvoptions import FvOptions as JFvOptions
from firefoam_tpu.models.run import run_case as j_run_case
from firefoam_tpu.ops import MeshGeometry as JGeom
from firefoam_torch.io import parse_string, read_field_file
from firefoam_torch.io.checkpoint import (checkpoint_path, latest_checkpoint, load_checkpoint,
                                          save_checkpoint)
from firefoam_torch.mesh.blockmesh import block_mesh
from firefoam_torch.models import run as trun
from firefoam_torch.models.firefoam import FireFoamSolver as TSolver
from firefoam_torch.models.firefoam import state_from_numpy
from firefoam_torch.models.fvoptions import FvOptions as TFvOptions
from firefoam_torch.ops import MeshGeometry as TGeom
from firefoam_torch.utils.synthcase import write_smooth_fire_case

from test_fvoptions import case  # noqa: F401  (the fvOptions fixture)
from test_lagrangian import small_mesh

torch.set_num_threads(1)

N = (5, 5, 5)
WARMUP, STEPS = 10, 6
# runTime writes (dt is not adjusted to land on them). The case's t after
# steps 9, 10 and 16 is 0.559, 0.659 and 1.259, so one write: at step 10
WRITE = 0.64
_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pin_jax(mp):
    """The JAX package on the flat solvers the port carries, in float64
    (as in tests/test_torch_step.py)."""
    for k in ("EXACT_SOLVERS", "AMG", "GMG", "PALLAS"):
        mp.setenv(f"FIREFOAM_TPU_{k}", "0")
    mp.setenv("FIREFOAM_TPU_DTYPE", "float64")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run_case over WARMUP + STEPS steps (writing at step WARMUP);
    the port's run_case from t = 0 over the same steps (run A, writing at
    the same time); and the port's run_case resumed from the JAX package's
    checkpoint at step WARMUP (run B). Each run has its own copy of the
    case: every run writes <case>/postProcessing."""
    base = tmp_path_factory.mktemp("run")
    src = write_smooth_fire_case(str(base / "case"), n=N, end_time=5.0, write_control="runTime",
                                 write_interval=WRITE)
    roots = {k: str(base / k) for k in ("jax", "a", "b")}
    for r in roots.values():
        shutil.copytree(src, r)
    out = {k: str(base / f"out_{k}") for k in roots}
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        js, jstate, jlogs = j_run_case(roots["jax"], max_steps=WARMUP + STEPS, verbose=False,
                                       solver=JSolver(roots["jax"]), output_dir=out["jax"],
                                       write_fields=True)
        js.function_objects.write()
        js.rtis.write(js.function_objects.out_dir)
        jstate = jax.device_get(jstate)
    # the port pinned as the JAX package is
    pins = dict(exact_solvers=False, gmg=False, amg=False)
    ta, _, _ = trun.run_case(roots["a"], max_steps=WARMUP + STEPS, verbose=False, device="cpu",
                             output_dir=out["a"], write_fields=True, **pins)
    jckpt = latest_checkpoint(out["jax"])
    tb, tstate, tlogs = trun.run_case(roots["b"], max_steps=STEPS, verbose=False, device="cpu",
                                      resume=jckpt, **pins)
    tb.function_objects.write()
    tb.rtis.write(tb.function_objects.out_dir)
    return dict(base=base, roots=roots, out=out, js=js, jstate=jstate, jlogs=jlogs, ta=ta,
                tb=tb, tstate=tstate, tlogs=tlogs, jckpt=jckpt)


def test_jax_checkpoint_resumes_in_port(runs):
    """Run B, from the JAX package's checkpoint of step WARMUP, against the
    JAX run's last STEPS steps (a developed state: a chain from t = 0
    amplifies last-bit differences to ~1e-9, tests/test_torch_step.py):
    function-object and rtis rows, RTI-link fields and the state to 1e-9."""
    js, tb = runs["js"], runs["tb"]
    assert float(np.load(runs["jckpt"])["['t']"]) == pytest.approx(
        float(runs["jlogs"][WARMUP - 1]["t"]), rel=1e-15)
    assert len(runs["tlogs"]) == STEPS
    assert [fo.name for fo in tb.function_objects.fos] == [fo.name for fo in js.function_objects.fos]
    for jf, tf in zip(js.function_objects.fos, tb.function_objects.fos):
        assert len(tf.rows) == STEPS and len(tf.rows[0]) == len(jf.rows[0]) > 1, tf.name
        assert _rel(tf.rows, jf.rows[WARMUP:]) <= 1e-9, tf.name
    assert len(tb.rtis.rows) == STEPS
    assert _rel(tb.rtis.rows, js.rtis.rows[WARMUP:]) <= 1e-9
    for k in ("dTe", "tAct"):
        assert _rel(_np(runs["tstate"]["rti_links"][k]), runs["jstate"]["rti_links"][k]) <= 1e-9
    for f in ("T", "U", "p_rgh", "Y", "k"):
        assert _rel(_np(runs["tstate"][f].i), runs["jstate"][f].i) <= 1e-9, f
    # the .dat files hold the same rows, to print precision
    for sub in ("HRR/0/volFieldValue.dat", "minMaxTU/0/fieldMinMax.dat", "plume/0/probes.dat",
                "rtis/0/rtis.dat"):
        a = np.loadtxt(os.path.join(runs["roots"]["b"], "postProcessing", sub))
        b = np.loadtxt(os.path.join(runs["roots"]["jax"], "postProcessing", sub))
        assert a.shape[0] == STEPS and b.shape[0] == WARMUP + STEPS, sub
        np.testing.assert_allclose(a, b[WARMUP:], rtol=2e-8, atol=0, err_msg=sub)
    # both packages' checkpoints carry the same keys, and the port's loads
    # into the JAX package
    with np.load(runs["jckpt"]) as z:
        jkeys = set(z.files)
    mine = save_checkpoint(str(runs["base"] / "end.npz"), runs["tstate"])
    with np.load(mine) as z:
        assert set(z.files) == jkeys
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        back = j_load_checkpoint(mine, js.initial_state())
    np.testing.assert_array_equal(np.asarray(back["T"].i), _np(runs["tstate"]["T"].i))
    np.testing.assert_array_equal(np.asarray(back["rti_links"]["tAct"]),
                                  _np(runs["tstate"]["rti_links"]["tAct"]))


def test_written_time_dirs_match_jax(runs):
    """Run A and the JAX run wrote the same time directory at step WARMUP;
    every number in every file agrees to print precision."""
    jout, tout = runs["out"]["jax"], runs["out"]["a"]
    times = sorted(d for d in os.listdir(jout) if d[0].isdigit())
    assert len(times) == 1 and times == sorted(d for d in os.listdir(tout) if d[0].isdigit())
    files = sorted(os.listdir(os.path.join(jout, times[0])))
    assert {"T", "U", "G", "Tlink1", "tAct5", "HRR_fu", "B"} <= set(files)
    assert sorted(os.listdir(os.path.join(tout, times[0]))) == files
    for name in files:
        with open(os.path.join(jout, times[0], name)) as f:
            b = np.array([float(x) for x in _NUM.findall(f.read().split("dimensions", 1)[1])])
        with open(os.path.join(tout, times[0], name)) as f:
            a = np.array([float(x) for x in _NUM.findall(f.read().split("dimensions", 1)[1])])
        assert a.shape == b.shape, name
        tol = 2e-8 * np.abs(b) + 1e-9 * np.max(np.abs(b))
        assert np.all(np.abs(a - b) <= tol), (name, float(np.max(np.abs(a - b) - tol)))
    # T and U read back with io/fields equal the state checkpointed with them
    with np.load(latest_checkpoint(tout)) as z:
        for f in ("T", "U"):
            ff = read_field_file(os.path.join(tout, times[0], f))
            got = ff.internal_array(runs["ta"].geom.n_cells)
            np.testing.assert_allclose(got, z[f"['{f}'].i"], rtol=1e-7, atol=0)
    with open(os.path.join(tout, f"outFlameHeight_{runs['ta'].t0:.6g}")) as f:
        assert len(f.read().splitlines()) == WARMUP + STEPS


def test_resume_is_bit_exact(runs, tmp_path):
    """4 steps in chunks of 2, against 2 steps + checkpoint + resume + 2."""
    ts, root = runs["ta"], runs["roots"]["a"]
    _, full, _ = trun.run_case(root, max_steps=4, verbose=False, solver=ts, chunk=2)
    _, half, _ = trun.run_case(root, max_steps=2, verbose=False, solver=ts, chunk=2)
    p = save_checkpoint(checkpoint_path(str(tmp_path), float(half["t"])), half)
    assert latest_checkpoint(str(tmp_path)) == p
    restored = load_checkpoint(p, ts.initial_state())
    _, resumed, _ = trun.run_case(root, max_steps=2, verbose=False, solver=ts, chunk=2,
                                  resume=p)
    flat = dict(_flat(full))
    for k, v in _flat(restored):
        assert torch.equal(v, dict(_flat(half))[k]), k
    for k, v in _flat(resumed):
        assert torch.equal(v, flat[k]), k


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        elif isinstance(v, tuple):
            yield f"{prefix}{k}.i", v.i
            yield f"{prefix}{k}.b", v.b
        else:
            yield prefix + k, v


def test_main_cpu_exits_zero(tmp_path, capsys):
    root = write_smooth_fire_case(str(tmp_path / "case"), n=(4, 4, 4), write_control="runTime",
                                  write_interval=0.01)
    out = str(tmp_path / "out")
    assert trun.main(["--case", root, "--cpu", "--max-steps", "2", "--chunk", "2", "--quiet",
                      "--output", out]) == 0
    assert "End: t = " in capsys.readouterr().out
    assert latest_checkpoint(out) is not None
    assert os.path.isfile(os.path.join(root, "postProcessing", "rtis", "0", "rtis.dat"))
    assert trun.main(["--case", root, "--cpu", "--max-steps", "1", "--quiet", "--output", out,
                      "--resume", latest_checkpoint(out), "--profile", str(tmp_path / "prof")]) == 0
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


@pytest.mark.parametrize("zones", [False, True])
def test_fvoptions_sources_match_jax(case, zones):  # noqa: F811
    """Without zones the cellZone entries are skipped quietly by both."""
    jg = JGeom.from_polymesh(small_mesh())
    tg = TGeom.from_polymesh(block_mesh(parse_string(_SMALL_MESH)), dtype=torch.float64,
                             device="cpu")
    z = {"hot": np.arange(8)} if zones else None
    jo, to = JFvOptions(case, jg, z), TFvOptions(case, tg, z)
    assert len(to.semi) == len(jo.semi) == (2 if zones else 1)
    assert to.radiation and jo.radiation
    for name, psi in (("h", np.zeros(tg.n_cells)), ("U", np.zeros((tg.n_cells, 3)))):
        jsu, jsp = jo.source(name, jnp.asarray(psi), jnp.float64)
        tsu, tsp = to.source(name, torch.as_tensor(psi), torch.float64)
        np.testing.assert_allclose(tsu.numpy(), np.asarray(jsu), rtol=1e-14, atol=0)
        np.testing.assert_allclose(tsp.numpy(), np.asarray(jsp), rtol=1e-14, atol=0)
    T = np.linspace(290.0, 310.0, tg.n_cells)
    np.testing.assert_array_equal(to.constrain_T(torch.as_tensor(T)).numpy(),
                                  np.asarray(jo.constrain_T(jnp.asarray(T))))


_SMALL_MESH = """
convertToMeters 1;
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0) (0 0 1) (1 0 1) (1 1 1) (0 1 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (4 4 4) simpleGrading (1 1 1) );
edges ();
boundary (
    top   { type patch; faces ( (3 7 6 2) ); }
    base  { type wall;  faces ( (0 1 5 4) ); }
    sides { type wall;  faces ( (0 4 7 3) (1 2 6 5) (0 3 2 1) (4 5 6 7) ); }
);
"""


def test_device_defaults_to_the_card(tmp_path, monkeypatch):
    """Without a card the port refuses to pick the CPU by itself."""
    root = write_smooth_fire_case(str(tmp_path / "case"), n=(4, 4, 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSolver(root)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--case", root, "--max-steps", "1", "--quiet"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy({"t": np.zeros(())})
    solver = TSolver(root, device="cpu")
    assert solver.dtype == torch.float64 and solver.geom.V.device.type == "cpu"
