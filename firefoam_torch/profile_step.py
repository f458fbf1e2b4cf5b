"""Profile the port's box-fire step on a CUDA card with torch.profiler.

    python -m firefoam_torch.profile_step [--n 50 40 50] [--steps 3] [--smooth | --wall]
        [--gmg]

Builds write_box_fire_case(n) (with --smooth, write_smooth_fire_case(n):
smoothSolver for Yi, h and k, and the run features; with --wall,
write_wall_fire_case(n): the gas-phase variants, the non-orthogonal
correction, WALE, BertExt with Fstar and the wall functions; with --gmg the
lattice multigrid solves p_rgh instead of K2), runs initial_state()
and 12 warm-up steps, then profiles `--steps` steps. Prints their solver
iterations, the device time per kernel (top 25), the port's own CUDA
kernels (csrc/) whatever their rank, and the device-busy share of the
window's wall time (the profiler itself slows the host, so the idle
share it reads is an upper bound). Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import torch

from .models.firefoam import FireFoamSolver
from .utils.synthcase import write_box_fire_case, write_smooth_fire_case, write_wall_fire_case

# the box fire ignites around step 3 and solves its fvDOM rays on steps 1,
# 11, 21, ...: steps 13-20 are a burning fire between two ray solves
WARMUP = 12


def device_events(prof):
    """([(name, start ns, end ns)] of the device's kernels, copies and sets,
    host reads of a device scalar) of a finished torch.profiler window, from
    its raw events: prof.events() and key_averages() first build an event
    tree in Python, which takes tens of seconds for a step of 40,000
    launches."""
    dev, reads = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s = e.start_ns()
            dev.append((e.name(), s, s + e.duration_ns()))
        elif e.name() == "aten::_local_scalar_dense":
            reads += 1
    return dev, reads


def kernel_launches(dev) -> int:
    """Device kernels among device_events' events (no copy or set)."""
    return sum(1 for name, _, _ in dev if not name.lower().startswith(("memcpy", "memset")))


def _busy_us(prof) -> float:
    """Union of the device events' [start, end) intervals, in µs."""
    return busy_us(device_events(prof)[0])


def busy_us(dev) -> float:
    """Union of the [start, end) intervals of device_events' events, in µs."""
    spans = sorted((s, e) for _, s, e in dev)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs=3, default=(50, 40, 50))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--smooth", action="store_true",
                    help="the smoothSolver case with the run features")
    ap.add_argument("--wall", action="store_true",
                    help="the wall-fire case with the gas-phase variants")
    ap.add_argument("--gmg", action="store_true",
                    help="p_rgh through the lattice multigrid (gmg=True)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    with tempfile.TemporaryDirectory(prefix="firefoam_prof_") as tmp:
        write = (write_smooth_fire_case if args.smooth
                 else write_wall_fire_case if args.wall else write_box_fire_case)
        case = write(tmp, n=tuple(args.n))
        solver = FireFoamSolver(case, device="cuda", gmg=True if args.gmg else None)
        state = solver.initial_state()
        step = solver.make_step()
        for _ in range(WARMUP):
            state, _ = step(state)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logs = []
            for _ in range(args.steps):
                state, log = step(state)
                logs.append(log)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    n = solver.geom.n_cells
    for i, log in enumerate(logs):
        its = {k: int(v) for k, v in sorted(log.items()) if k.endswith("_iters") or "iters_" in k}
        print(f"step {WARMUP + i + 1} solver iterations: {its}")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    for e in prof.key_averages():
        # nvcc names a kernel of csrc/'s unnamed namespace so; PyTorch's own
        # kernels carry the words only inside their template arguments
        if e.key.startswith("void (anonymous namespace)::") and e.self_device_time_total > 0:
            kernel = e.key.split("::", 1)[1].split("(", 1)[0]
            print(f"{kernel}: {e.count} launches, {e.self_device_time_total / e.count / 1e3:.4f} "
                  f"ms each, {e.self_device_time_total / args.steps / 1e3:.4f} ms/step")
    dev, reads = device_events(prof)
    kernels = kernel_launches(dev)
    print(f"{kernels / args.steps:.0f} kernel launches and {reads / args.steps:.1f} host reads "
          f"of a device scalar per step")
    busy = busy_us(dev)
    print(f"{n} cells, {args.steps} steps: wall {wall_us / args.steps / 1e3:.3f} ms/step, "
          f"device busy {busy / args.steps / 1e3:.3f} ms/step "
          f"({100.0 * busy / wall_us:.1f}% of wall; idle {100.0 - 100.0 * busy / wall_us:.1f}%)")


if __name__ == "__main__":
    main()
