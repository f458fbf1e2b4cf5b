"""Time the port's grid-wide K1/K2/K3 and the banded shaft's steps for one
checkout of firefoam_torch, so that two checkouts can be compared in one
call on one card (run it for each, in turns: A, B, B, A).

    python tools/kernel_ab.py --root <directory holding firefoam_torch> [--out file.json]
        [--rows-only]

Prints one JSON line (and writes it to --out):
  * "build_s": the seconds the kernels took to build and load;
  * "solves": float32 solves on random diagonally dominant systems of 100k
    cells (numpy, seed 0): K1 (B = 1 and 3 shared rows), K2 and K3 (B = 1) on
    the (50, 40, 50) lattice's 3 offsets and on the banded shaft's 34 and
    the renumbered box's 62: ms a solve (CUDA events over 20 launches after
    one), iterations and the first 16 hex digits of the SHA-256 of x's bytes
    (two checkouts whose kernels add in the same order print the same);
  * "rows": K1 on 16 rows with a matrix each (the fvDOM rays' shape: the
    many-rows kernel; drawn on the card, torch seed K) at the lattice's 3,
    phase 3's 12 (OFFS_12), 34 and 62 offsets, float32 and float64 ("_f64"):
    the same, with the windows' W and the window=0 solve's ms and bitwise
    equality where the checkout has them (alone with --rows-only);
  * "shaft": the 104,280-cell castellated shaft on layout="banded" in
    float32 (write_castellated_fire_case n=(8, 8, 1500), size (0.4, 0.4,
    75)): ms/step of make_chunk(6) from t = 0 (host clock), then one
    radiation step (its counter set so that the step solves the 16 rays:
    the many-rows kernel at 34 offsets) under torch.profiler: device-busy
    ms, launches, and each of the port's kernels' ms a launch;
  * "smooth_shaft": the smoothSolver fire (write_smooth_fire_case, Yi, h and
    k on K3) castellated into the same shaft (its mesh reused), through the
    run CLI's engine (run_case, layout "banded", chunks of 4): ms/step over
    8 steps from t = 0, then one step from there profiled as above.
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

OFFS_34 = (1, 2, 3, 4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 21, 64, 66, 68, 69, 71,
           72, 73, 74, 76, 77, 78, 79, 81, 82, 84, 86, 87)
OFFS_62 = tuple(range(1, 63))
OFFS_12 = (1, 2, 49, 50, 51, 100, 1950, 1999, 2000, 2001, 2050, 4000)
LATTICE = (50, 40, 50)


def system(rng, n, offs, B, sym):
    """diag [B, n], shared upper/lower [K·n], b and x0 [B, n] (float64
    numpy): off-diagonals -U(0.5, 1.5) where the neighbour exists, the
    diagonal their sum plus K/3·(1 + 0.1·U(0, 1))."""
    K = len(offs)
    c = np.arange(n)
    up = np.zeros((K, n))
    lo = np.zeros((K, n))
    d = (K / 3.0) * (1.0 + 0.1 * rng.rand(B, n))
    for k, o in enumerate(offs):
        v = -(0.5 + rng.rand(n)) * (c + o < n)
        up[k] = v
        lo[k] = v if sym else v * (1.0 + 0.3 * rng.rand(n))
        d[:, : n - o] -= up[k, : n - o]
        d[:, o:] -= lo[k, : n - o]
    return d, up.reshape(-1), lo.reshape(-1), rng.randn(B, n), 0.1 * rng.randn(B, n)


def rows_system(torch, gen, n, offs, B, dtype):
    """As `system` with a matrix for each of the B rows, drawn on the card
    from `gen` in float64 and rounded to `dtype`."""
    f8 = dict(dtype=torch.float64, device="cuda")
    K = len(offs)
    c = torch.arange(n, device="cuda")
    rand = lambda *shape: torch.rand(shape, generator=gen, **f8)
    up = torch.zeros((B, K, n), **f8)
    lo = torch.zeros((B, K, n), **f8)
    d = (K / 3.0) * (1.0 + 0.1 * rand(B, n))
    for k, o in enumerate(offs):
        v = -(0.5 + rand(B, n)) * (c + o < n)
        up[:, k] = v
        lo[:, k] = v * (1.0 + 0.3 * rand(B, n))
        d[:, : n - o] -= up[:, k, : n - o]
        d[:, o:] -= lo[:, k, : n - o]
    ops = (d, up.reshape(B, K * n), lo.reshape(B, K * n), torch.randn((B, n), generator=gen, **f8),
           0.1 * torch.randn((B, n), generator=gen, **f8))
    return [a.to(dtype).contiguous() for a in ops]


def time_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def solves(torch, dk):
    rng = np.random.RandomState(0)
    n = int(np.prod(LATTICE))
    lattice = (1, LATTICE[0], LATTICE[0] * LATTICE[1])
    out = {}
    for offs in (lattice, OFFS_34, OFFS_62):
        for name, B in (("bicgstab", 1), ("bicgstab", 3), ("pcg", 1), ("smooth", 1)):
            ops = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
                   for a in system(rng, n, offs, B, name == "pcg")]
            kw = dict(tol=1e-8, rel_tol=0.0, max_iter=60 if name == "smooth" else 1000)
            fn = getattr(dk, f"dia_{name}")
            run = lambda: fn(*ops, offs, **kw)
            res = run()
            torch.cuda.synchronize()
            sha = hashlib.sha256(res.x.cpu().numpy().tobytes()).hexdigest()[:16]
            out[f"{name}_B{B}_k{len(offs)}"] = {"ms": time_ms(torch, run),
                                                "iterations": int(res.n_iterations.max()),
                                                "x_sha256": sha}
    return out


def rows_solves(torch, dk):
    """K1 on 16 rows of 100k cells with a matrix each (the many-rows kernel)
    at 3, 12, 34 and 62 offsets, float32 and float64: ms, iterations, the
    SHA-256 of x and, where the checkout's many-rows kernel has windows,
    their W and the same solve with window=0 (ms; x, residuals and counts
    bitwise equal or not)."""
    n = int(np.prod(LATTICE))
    lattice = (1, LATTICE[0], LATTICE[0] * LATTICE[1])
    out = {}
    for offs in (lattice, OFFS_12, OFFS_34, OFFS_62):
        for dtype in (torch.float32, torch.float64):
            gen = torch.Generator(device="cuda").manual_seed(len(offs))
            ops = rows_system(torch, gen, n, offs, 16, dtype)
            run = lambda: dk.dia_bicgstab(*ops, offs, tol=1e-8, rel_tol=0.0, max_iter=1000)
            res = run()
            torch.cuda.synchronize()
            row = {"ms": time_ms(torch, run), "iterations": res.n_iterations.tolist(),
                   "x_sha256": hashlib.sha256(res.x.cpu().numpy().tobytes()).hexdigest()[:16]}
            if hasattr(dk, "rows_window"):
                _, split = dk._grid_launch_plan("bicgstab", dtype, 16, n, offs,
                                                ops[0].element_size())
                run0 = lambda: dk._launch("bicgstab", *ops, offs, 1e-8, 0.0, 1000, window=0)
                r0 = run0()
                row.update(window=split.window, window0_ms=time_ms(torch, run0),
                           window0_bitwise=bool(
                               torch.equal(r0.x, res.x) and torch.equal(r0.n_iterations,
                                                                        res.n_iterations)
                               and torch.equal(r0.final_residual, res.final_residual)))
                del r0
            suffix = "" if dtype == torch.float32 else "_f64"
            out[f"bicgstab_B16_rows_k{len(offs)}{suffix}"] = row
            del ops, res
    return out


def kernel_key(name: str) -> str:
    key = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", key)[0]


def profile_one(torch, solver, state):
    """One step from `state` under torch.profiler: device-busy ms, launches
    and each of the port's grid-wide and many-rows kernels' ms a launch."""
    from firefoam_torch.profile_step import busy_us, device_events, kernel_launches

    step = solver.make_step()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(state)
        torch.cuda.synchronize()
    dev, _ = device_events(prof)
    mine = {}
    for name, s, e in dev:
        key = kernel_key(name)
        if key.endswith("_kernel") and ("grid" in key or "rows" in key):
            ms, count = mine.get(key, (0.0, 0))
            mine[key] = (ms + (e - s) / 1e6, count + 1)
    return {"device_busy_ms": busy_us(dev) / 1e3, "launches": kernel_launches(dev),
            "kernels": {k: {"ms_per_launch": v[0] / v[1], "launches": v[1]}
                        for k, v in mine.items()}}


def shafts(torch):
    import firefoam_torch.models.firefoam as firefoam_mod
    from firefoam_torch.models import run as run_cli
    from firefoam_torch.models.firefoam import FireFoamSolver
    from firefoam_torch.utils.synthcase import (castellate_case, write_castellated_fire_case,
                                                write_smooth_fire_case)

    size = (0.4, 0.4, 75.0)
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        case = write_castellated_fire_case(os.path.join(tmp, "shaft"), n=(8, 8, 1500),
                                           size=size)
        solver = FireFoamSolver(case, device="cuda", layout="banded")
        chunk = solver.make_chunk(6)
        state0 = solver.initial_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = chunk(state0)
        torch.cuda.synchronize()
        ms_step = 1e3 * (time.perf_counter() - t0) / 6
        # the next step with the radiation counter at 0, so that it solves the rays
        due = dict(state, rad=dict(state["rad"], count=torch.zeros_like(state["rad"]["count"])))
        out = {"shaft": {"cells": solver.geom.n_cells, "offsets": len(solver.geom.offsets),
                         "ms_per_step": ms_step, **profile_one(torch, solver, due)}}
        cm = solver.cm
        del solver, state, state0, chunk

        smooth = write_smooth_fire_case(os.path.join(tmp, "smooth_shaft"), n=(8, 8, 1500),
                                        size=size, end_time=100.0, write_control="runTime",
                                        write_interval=1e3)
        castellate_case(smooth, size=size)
        orig = firefoam_mod.build_case_mesh
        firefoam_mod.build_case_mesh = lambda case_dir: cm  # the same castellation
        try:
            stats = {}
            solver, state, _ = run_cli.run_case(smooth, max_steps=8, verbose=False, chunk=4,
                                                layout="banded", stats=stats)
        finally:
            firefoam_mod.build_case_mesh = orig
        out["smooth_shaft"] = {
            "offsets": len(solver.geom.offsets),
            "ms_per_step": 1e3 * stats["step_seconds"] / stats["steps"],
            **profile_one(torch, solver, state)}
        return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out")
    ap.add_argument("--rows-only", action="store_true",
                    help="only the many-rows kernel's solves (rows_solves)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    from firefoam_torch.solvers import dia_krylov as dk

    out = {"root": args.root, "card": torch.cuda.get_device_name(0),
           "build_s": dk.build_seconds()}
    if args.rows_only:
        out["rows"] = rows_solves(torch, dk)
    else:
        out.update(solves=solves(torch, dk), rows=rows_solves(torch, dk), **shafts(torch))
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
