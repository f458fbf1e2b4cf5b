"""The readings the limits of `correct` are set from, for one cell on one
CUDA card, many seeds in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 [--control]
        [--out readings.json]

For each seed the program runs the cell's set-up and one segment through
the cell's entry, as a run of benchmark/run.py does, and its output is held
on the host. Then the plain reference (float64) judges every seed's output;
with --control it judges the control's too: the reference with its state
held in bfloat16 between steps, put in the program's place (from the same
inputs and the program's warm state). Prints each seed's
numbers and, per number, the largest reading of the program and the
smallest of the control. The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from fbench.harness import Cell, Output, compare, make_segment, warm_up, write_case  # noqa: E402


def readings(cell: Cell, seeds, control: bool, device: str = "cuda") -> dict:
    """{"program": {seed: numbers}, "control": {seed: numbers}}."""
    import tempfile

    import torch

    from fbench.check import Reference
    from firefoam_torch.models.firefoam import FireFoamSolver

    with tempfile.TemporaryDirectory(prefix="fbench_readings_") as tmp:
        case = write_case(cell.config, os.path.join(tmp, "case"))
        solver = FireFoamSolver(case, device=device, dtype=torch.float32)
        seg = make_segment(solver, cell.traffic)
        outs = {}
        for seed in seeds:
            inputs, start, warm = warm_up(solver, cell.config, cell.traffic, seed)
            out, _ = seg(warm)
            outs[seed] = (inputs, Output.of_program(solver, start, warm, out))
            del warm, out
        del solver, seg
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        steps = int(cell.traffic["segment_steps"])

        def outputs(ref):
            return {s: Output.of_reference(ref, inp, prog, steps) for s, (inp, prog) in outs.items()}

        refs = outputs(Reference(case, device))
        gc.collect()
        res = {"program": {s: compare(prog, refs[s]) for s, (_, prog) in outs.items()}}
        if control:
            ctl = outputs(Reference(case, device, bf16_state=True))
            res["control"] = {s: compare(ctl[s], refs[s]) for s in outs}
        return res


def limits(res: dict) -> dict:
    """{number: (lower, upper, limit)}: the lower reading is the program's
    largest, the upper the control's smallest, and the limit lies between
    them with more room above the lower (lower^0.4 · upper^0.6, two
    significant digits); nan where the upper is under three times the
    lower (no upper reading) or there is no control."""
    import math

    out = {}
    for k in next(iter(res["program"].values())):
        lo = max(n[k] for n in res["program"].values())
        up = min(n[k] for n in res["control"].values()) if "control" in res else float("nan")
        lim = float("nan")
        if up >= 3 * lo:
            lim = float(f"{lo ** 0.4 * up ** 0.6:.2g}")
        out[k] = (lo, up, lim)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("readings.py: no CUDA card")
    cell = Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    res = readings(cell, seeds, args.control)
    for kind, by_seed in res.items():
        for s, nums in by_seed.items():
            print(f"{args.workload} {kind} seed {s}: "
                  + " ".join(f"{k}={v:.6e}" for k, v in nums.items()))
    for k, (lo, up, lim) in limits(res).items():
        print(f"{args.workload} {k}: program max {lo:.6e}, control min {up:.6e}, "
              f"ratio {up / lo if lo > 0 else float('inf'):.3g}, limit {lim:.3g}")
    print(f"{args.workload}: {len(seeds)} seeds in {time.perf_counter() - T_START:.1f} s; "
          f"card {torch.cuda.get_device_name(0)}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "readings": res}, f, indent=1)


if __name__ == "__main__":
    main()
