"""Time-loop driver and CLI: `python -m firefoam_torch.models.run --case <dir>`.

The port of firefoam_tpu/models/run.py. It runs on the CUDA card; `--cpu`
is the only way to the CPU (float64 there, float32 on the card). Per step
it prints the reference's log (residuals, species min/ave/max, min/max(T),
continuity errors, Courant number — solver/fireFoam.C:76-141, YEEqn.H:72-77),
or one line per chunk with `--chunk N`; it records the function objects and
RTI probes of every step, writes OpenFOAM time directories and an npz
checkpoint at each writeInterval (`--write`/`--output`), resumes from a
checkpoint (`--resume`) and writes the postProcessing files at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import __version__
from ..io.checkpoint import checkpoint_path, latest_checkpoint, load_checkpoint, save_checkpoint
from ..io.master import is_master
from ..io.writer import write_time_dir
from .firefoam import FireFoamSolver

__all__ = ["run_case", "main"]


def _fmt(x) -> str:
    return f"{float(x):.8g}"


def _print_step(solver, log):
    if not solver.solve_primary:
        # solid-only cases (pyrolysis1D): the region log only
        print(f"Time = {_fmt(log['t'])}")
        for k, v in log.items():
            if k.startswith("pyro_"):
                print(f"{k} = {_fmt(v)}")
        return
    """The reference's per-step log lines."""
    print(f"Courant Number max: {_fmt(log['CoNum'])}")
    print(f"deltaT = {_fmt(log['dt'])}")
    print(f"Time = {_fmt(log['t'])}\n")
    for c in "xyz":
        print(f"solve U{c}: initial residual = {_fmt(log[f'U{c}_res0'])}, "
              f"iters {int(log[f'U{c}_iters'])}")
    for sp in solver.species:
        print(f"{sp:>8s}\tmin/ave/max  =\t{float(log[f'Y_{sp}_min']):12.6g}\t"
              f"{float(log[f'Y_{sp}_ave']):12.6g}\t{float(log[f'Y_{sp}_max']):12.6g}")
    print(f"min/max(T) = {_fmt(log['T_min'])}, {_fmt(log['T_max'])}")
    for c in range(solver.ctl.n_correctors):
        print(f"p_rgh corrector {c}: initial residual = {_fmt(log[f'p_rgh_res0_{c}'])}, "
              f"iters {int(log[f'p_rgh_iters_{c}'])}")
        print(f"time step continuity errors : sum local = {_fmt(log[f'cont_local_{c}'])}, "
              f"global = {_fmt(log[f'cont_global_{c}'])}")
    print(f"Qdot volIntegrate = {_fmt(log['Qdot_total'])} W")


def run_case(
    case_dir: str,
    end_time: Optional[float] = None,
    max_steps: int = 100000,
    verbose: bool = True,
    radiation: bool = True,
    solver: Optional[FireFoamSolver] = None,
    output_dir: Optional[str] = None,
    write_fields: bool = False,
    resume: Optional[str] = None,
    chunk: int = 1,
    device=None,
    stats: Optional[Dict[str, float]] = None,
    exact_solvers: Optional[bool] = None,
    gmg: Optional[bool] = None,
    gmg_coarsest: int = 64,
    amg: Optional[bool] = None,
    p_rgh_f64: bool = False,
    layout: Optional[str] = None,
    pairmg: Optional[bool] = None,
):
    """Run a case to end_time (or max_steps); returns (solver, final_state,
    step_logs), the logs as numpy. A non-finite number in a step's log
    raises FloatingPointError.

    resume: a checkpoint path, or "auto" for the latest one under
    output_dir (else the case) when controlDict says 'startFrom latestTime'.
    chunk > 1 runs `chunk` steps per make_chunk call and replays their logs
    on the host after it, so the function objects and probes see every
    step; writes are checked after each call. `stats`, if given, receives
    the step seconds (host clock around the step calls and the host copy of
    their logs, which waits for the device), the steps and the write
    seconds. exact_solvers, gmg, gmg_coarsest, amg, pairmg and p_rgh_f64
    choose the linear solvers (FireFoamSolver's arguments; None: its
    automatic rule); layout the mesh layout (None/"auto", "dia", "banded",
    "seg" or "hybrid").
    """
    if verbose:
        print(f"firefoam_torch {__version__}")
    if solver is None:
        solver = FireFoamSolver(
            case_dir, device=device, radiation=radiation, exact_solvers=exact_solvers,
            gmg=gmg, gmg_coarsest=gmg_coarsest, amg=amg, p_rgh_f64=p_rgh_f64,
            layout=layout, pairmg=pairmg,
        )
    state = solver.initial_state()
    if resume:
        ckpt = resume
        if resume == "auto":
            mode = str(solver.case.control_dict.lookup("startFrom", "startTime"))
            ckpt = latest_checkpoint(output_dir or case_dir) if mode == "latestTime" else None
        if ckpt:
            state = load_checkpoint(ckpt, state)
            if verbose:
                print(f"Resumed from {ckpt} at t = {float(state['t']):.6g}")
    end = end_time if end_time is not None else solver.ctl.end_time
    wi = solver.ctl.write_interval
    next_write = None
    if write_fields:
        output_dir = output_dir or case_dir
        # the first write lands on the next interval past the start time
        next_write = (math.floor(float(state["t"]) / wi + 1e-9) + 1) * wi
    step_fn = solver.make_chunk(int(chunk)) if chunk > 1 else None

    logs: List[Dict[str, np.ndarray]] = []
    n = 0
    step_s = write_s = 0.0
    t_start = time.time()
    while float(state["t"]) < end - 1e-12 and n < max_steps:
        t0 = time.perf_counter()
        if step_fn is not None:
            state, slog = step_fn(state)
            stacked = {k: v.detach().cpu().numpy() for k, v in slog.items()}
            new = [{k: v[i] for k, v in stacked.items()} for i in range(int(chunk))]
        else:
            state, log = solver.step(state)
            new = [{k: v.detach().cpu().numpy() for k, v in log.items()}]
        step_s += time.perf_counter() - t0
        bad = sorted({k for lg in new for k, v in lg.items() if not np.all(np.isfinite(v))})
        if bad:
            # the reference aborts on a floating-point exception (sigFpe)
            raise FloatingPointError(f"non-finite step-log entries before t = "
                                     f"{float(state['t']):.6g}: {bad}")
        n += len(new)
        for log in new:
            logs.append(log)
            t = float(log["t"])
            solver.function_objects.record(t, log)
            if solver.rtis is not None and "rtis_Te" in log:
                solver.rtis.record(t, {"Te": log["rtis_Te"], "t_act": log["rtis_t_act"]})
            if write_fields and "flameHeight" in log and is_master():
                # outFlameHeight_<startTime>: t, flameHeight, flameHeight2 per
                # step (infoFieldsOutput.H:18 / infoOutput.H:52-57)
                os.makedirs(output_dir, exist_ok=True)
                with open(os.path.join(output_dir, f"outFlameHeight_{solver.t0:.6g}"), "a") as f:
                    f.write(f"{t}  {float(log['flameHeight'])}  {float(log['flameHeight2'])}  \n")
            if verbose and step_fn is None:
                _print_step(solver, log)
                print(f"ExecutionTime = {time.time() - t_start:.2f} s\n")
        if verbose and step_fn is not None:
            if solver.solve_primary:
                print(f"Time = {_fmt(state['t'])}  (chunk of {chunk} steps, "
                      f"Co {_fmt(logs[-1]['CoNum'])}, T_max {_fmt(logs[-1]['T_max'])})")
            else:
                _print_step(solver, logs[-1])
        if write_fields and float(state["t"]) + 1e-9 >= next_write:
            t0 = time.perf_counter()
            tw = float(state["t"])
            write_time_dir(output_dir, tw, solver, state)
            save_checkpoint(checkpoint_path(output_dir, tw), state)
            write_s += time.perf_counter() - t0
            next_write += wi
    if stats is not None:
        stats.update(step_seconds=step_s, steps=n, write_seconds=write_s)
    return solver, state, logs


_TRISTATE = {"0": False, "1": True, "auto": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="fireFoam on PyTorch/CUDA")
    ap.add_argument("--case", required=True)
    ap.add_argument("--end-time", type=float, default=None)
    ap.add_argument("--max-steps", type=int, default=100000)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (float64)")
    ap.add_argument("--no-radiation", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--write", action="store_true", help="write field time dirs")
    ap.add_argument("--output", default=None, help="output case root for writes")
    ap.add_argument(
        "--resume", nargs="?", const="auto", default=None,
        help="resume from a state checkpoint ('auto': latest under the output root "
             "when controlDict has startFrom latestTime)",
    )
    ap.add_argument("--chunk", type=int, default=1,
                    help="run N steps per call; per-step logs are replayed after each chunk")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="record a torch.profiler trace of the run into DIR/trace.json "
                         "(Chrome trace format)")
    for flag, what in (
        ("--exact-solvers", "the OpenFOAM-exact DIC-PCG and symGaussSeidel where fvSolution "
                            "names them (auto: in float64)"),
        ("--gmg", "the lattice multigrid on p_rgh (auto: from the device's measured size)"),
        ("--amg", "the agglomeration multigrid on p_rgh (auto: the CPU's rule; on the card "
                  "only on a SEG mesh; never on hybrid)"),
        ("--pairmg", "the index-pair multigrid on p_rgh (hybrid only; auto: from 50,000 "
                     "cells)"),
    ):
        ap.add_argument(flag, choices=sorted(_TRISTATE), default="auto",
                        help=f"{what}; 1 forces, 0 forbids")
    ap.add_argument("--gmg-coarsest", type=int, default=64,
                    help="the lattice multigrid stops coarsening at this many cells")
    ap.add_argument("--p-rgh-f64", choices=("0", "1"), default="0",
                    help="solve p_rgh in float64 inside a float32 step")
    ap.add_argument("--layout", choices=("auto", "dia", "banded", "seg", "hybrid"),
                    default="auto",
                    help="the mesh layout: DIA where the mesh fits and SEG otherwise (auto), "
                         "or forced (banded: DIA with up to 64 offsets; hybrid: DIA lanes for "
                         "the dominant offsets and the rest)")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else None
    prof = contextlib.nullcontext()
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if not args.cpu:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    stats: Dict[str, float] = {}
    with prof:
        solver, state, logs = run_case(
            args.case, end_time=args.end_time, max_steps=args.max_steps,
            verbose=not args.quiet, radiation=not args.no_radiation,
            output_dir=args.output, write_fields=args.write or args.output is not None,
            resume=args.resume, chunk=args.chunk, device=device, stats=stats,
            exact_solvers=_TRISTATE[args.exact_solvers], gmg=_TRISTATE[args.gmg],
            gmg_coarsest=args.gmg_coarsest, amg=_TRISTATE[args.amg],
            p_rgh_f64=args.p_rgh_f64 == "1", layout=args.layout,
            pairmg=_TRISTATE[args.pairmg],
        )
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    solver.function_objects.write()
    if solver.rtis is not None:
        solver.rtis.write(solver.function_objects.out_dir)
    if solver.cloud is not None and "cloud" in state:
        # the collectors' dat files and the per-sprinkler activation/flow
        # logs (DetailedSprinklerInjection's master-only filePtr_ logs)
        solver.cloud.write_collectors(state["cloud"], solver.function_objects.out_dir)
        solver.cloud.write_sprinkler_logs(state["cloud"], solver.function_objects.out_dir)
    ms = 1e3 * stats["step_seconds"] / max(stats["steps"], 1)
    print(f"End: t = {float(state['t']):.6g}, steps = {len(logs)}, {ms:.3f} ms/step, "
          f"writing {stats['write_seconds']:.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
