"""One run of one cell of the benchmark (see benchmark/run.py).

The cell's configuration (benchmark/configs/<config>.json: its case writer
benchmark/cases/<writer>.py and the writer's parameters, the warm-up, the
limits of the comparison) and traffic
(benchmark/traffic/<traffic>.json: the segment, the entry and its calls,
what the seed draws, the traced segments) are found by the names in
BENCHMARK.json, and each per-layer metric by its reader
benchmark/metrics/<name>.py. Set-up writes the case, builds the program's
solver, makes the initial state with the seed's inputs, warms up and runs
the segment once; the window then replays the segment from that warm state
until `--seconds` have passed. A traced run profiles `trace_segments`
segments instead of the window. Once the window has closed the program's
output is judged against the plain reference (fbench.check).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
# top-level modules the measured process may not hold: JAX and the JAX
# package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "firefoam_tpu")


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic and the
    metrics it reports."""

    def __init__(self, name: str):
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            man = json.load(f)
        cells = {w["name"]: w for w in man["workloads"]}
        if name not in cells:
            raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.cell = cells[name]
        self.config = _load_json("configs", self.cell["config"])
        self.traffic = _load_json("traffic", self.cell["traffic"])
        self.end_to_end = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in man["per_layer"] if name in m.get("workloads", [name])]


def _load_json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, f"{name}.json")) as f:
        return json.load(f)


def reader(metric: str):
    """The `read(trace)` of benchmark/metrics/<metric>.py."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"fbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def write_case(config: dict, root: str) -> str:
    """The configuration's case, written by its writer
    benchmark/cases/<writer>.py (`write(root, **case)`)."""
    path = os.path.join(BENCH, "cases", f"{config['writer']}.py")
    spec = importlib.util.spec_from_file_location(f"fbench_case_{config['writer']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.write(root, **config["case"])


def make_segment(solver, traffic: dict):
    """seg(state) -> (state, [per-step logs as numpy]): `segment_steps`
    steps through the traffic's entry, each call's logs copied to the host
    as models/run.py's run_case copies them (where the window waits on the
    device)."""
    n, per = int(traffic["segment_steps"]), int(traffic["steps_per_call"])
    if n % per:
        raise SystemExit(f"run.py: a segment of {n} steps is not whole calls of {per}")
    chunk = solver.make_chunk(per) if per > 1 else None

    def seg(state):
        logs = []
        for _ in range(n // per):
            if chunk is not None:
                state, slog = chunk(state)
                stacked = {k: v.detach().cpu().numpy() for k, v in slog.items()}
                logs += [{k: v[i] for k, v in stacked.items()} for i in range(per)]
            else:
                state, log = solver.step(state)
                logs.append({k: v.detach().cpu().numpy() for k, v in log.items()})
        return state, logs

    return seg


def failed_steps(logs) -> int:
    """Steps whose log holds a non-finite entry or unsolved fvDOM rows."""
    return sum(1 for lg in logs
               if not all(np.all(np.isfinite(v)) for v in lg.values())
               or int(np.asarray(lg.get("rad_failedRows", 0))) != 0)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_power_limit() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not read"
    out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def warm_up(solver, config: dict, traffic: dict, seed: int):
    """(inputs, start snapshot, warm state): the seed's inputs on the
    initial state, then the configuration's warm-up steps."""
    from .check import snapshot
    from .inputs import apply_inputs, draw_inputs

    inputs = draw_inputs(seed, solver.geom.n_cells, traffic["seed_draws"])
    state = apply_inputs(solver.initial_state(), inputs)
    start = snapshot(state)
    for _ in range(int(config["warmup_steps"])):
        state, _ = solver.step(state)
    return inputs, start, state


class Output:
    """An output on the host, the program's or a reference's: the start
    (the initial state with the seed's inputs), the warm state the segment
    started from, the segment's end and the walls' qr there."""

    def __init__(self, start, warm, out, qr):
        self.start, self.warm, self.out, self.qr = start, warm, out, qr

    @classmethod
    def of_program(cls, solver, start, warm, out):
        from .check import qr_of, snapshot

        return cls(start, snapshot(warm), snapshot(out), qr_of(solver, out))

    @classmethod
    def of_reference(cls, ref, inputs, prog: "Output", steps: int):
        """`ref` (a check.Reference) from the same inputs and the program's
        warm state."""
        out, qr = ref.segment(prog.warm, steps)
        return cls(ref.start(inputs), prog.warm, out, qr)


def compare(prog: Output, ref: Output) -> dict:
    """The numbers compared (fbench.check) of an output against the
    reference's."""
    from .check import gaps, start_gap

    numbers = {"start": start_gap(prog.start, ref.start)}
    numbers.update(gaps(prog.out, ref.out, prog.qr, ref.qr))
    return numbers


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", tmp_root: str = None) -> dict:
    """One run; returns the result line's object (without printing it)."""
    import torch

    from . import events
    from .check import Reference, judge
    from .layers import Layers

    from firefoam_torch.models.firefoam import FireFoamSolver
    from firefoam_torch.solvers import dia_krylov

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg, trf = cell.config, cell.traffic
    # the configuration's float32 with TF32 off (PyTorch's default, held)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="fbench_case_", dir=tmp_root)
    try:
        case = write_case(cfg, os.path.join(tmp, "case"))
        solver = FireFoamSolver(case, device=device, dtype=torch.float32)
        inputs, start, warm = warm_up(solver, cfg, trf, seed)
        print(f"warm state: t {float(warm['t']):.4f} s, T max {float(warm['T'].i.max()):.1f} K",
              file=sys.stderr)
        seg = make_segment(solver, trf)
        out, logs = seg(warm)  # every shape of the window, built and warmed
        gc.collect()
        sync()
        setup_s = time.perf_counter() - t_start
        result = {"attempted": 0, "failed": 0, "metrics": {}}
        dev_info = {"platform": "gpu" if cuda else "cpu",
                    "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                    "count": 1}
        if trace:
            layers = Layers(solver, dia_krylov)
            layers.install()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            sync()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter_ns()
                for _ in range(int(trf["trace_segments"])):
                    out, logs = seg(warm)
                    result["attempted"] += len(logs)
                    result["failed"] += failed_steps(logs)
                sync()
                wall_ns = time.perf_counter_ns() - t0
            layers.remove()
            tr = events.collect(prof, result["attempted"], wall_ns, layers.attrs)
            del prof
            tr.rad_steps = sum(1 for a in layers.attrs["rad"] if a["solved"])
            tr.solves = layers.solves
            for m in cell.per_layer:
                v = reader(m["name"])(tr)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
            dev_info["busy_s"] = events.busy_us(tr.device) / 1e6
            dev_info["window_s"] = wall_ns / 1e9
            result["breakdown"] = {"device_ops": events.top_device_ops(tr),
                                   "idle_gaps": events.idle_gaps(tr)}
            print(f"traced {result['attempted']} steps ({tr.rad_steps} solved rays), "
                  f"{len(tr.device)} device events, {sum(t is not None for t in tr.launch_ns)} "
                  f"linked to their launch, {len(tr.solves)} Krylov solves; card: "
                  f"{card_power_limit() if cuda else 'cpu'}", file=sys.stderr)
            del tr
        else:
            t0, c0 = time.perf_counter(), time.thread_time()
            seg_s, seg_cpu = [], []
            while True:
                ts, cs = time.perf_counter(), time.thread_time()
                out, logs = seg(warm)
                seg_s.append(time.perf_counter() - ts)
                seg_cpu.append(time.thread_time() - cs)
                result["attempted"] += len(logs)
                result["failed"] += failed_steps(logs)
                if time.perf_counter() - t0 >= seconds:
                    break
            sync()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            values = {"step_ms": 1e3 * wall / result["attempted"],
                      "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
            units = {m["name"]: m["unit"] for m in cell.end_to_end}
            result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()
                                 if k in units}
            cpu = time.thread_time() - c0
            per_step = sorted(1e3 * s / len(logs) for s in seg_s)
            print(f"window {wall:.3f} s, {len(seg_s)} segments of {len(logs)} steps: ms/step "
                  f"min {per_step[0]:.3f} median {statistics.median(per_step):.3f} max "
                  f"{per_step[-1]:.3f}; the main thread's CPU {cpu:.3f} s", file=sys.stderr)
            # the main thread's CPU time beside the wall: the host's share of
            # each segment's spread
            print("segments ms/step (CPU ms/step): " + " ".join(
                f"{1e3 * w / len(logs):.1f}({1e3 * c / len(logs):.1f})"
                for w, c in zip(seg_s, seg_cpu)), file=sys.stderr)
        dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if cuda else 0
        result["device"] = dev_info
        # the program's output, then its state freed before the reference
        prog = Output.of_program(solver, start, warm, out)
        del solver, warm, out, seg
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = Output.of_reference(Reference(case, device), inputs, prog,
                                  int(trf["segment_steps"]))
        numbers = compare(prog, ref)
        print(f"reference {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        result["correct"], result["checks"] = judge(numbers, cfg["limits"])
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the firefoam_torch "
                                             "benchmark on one CUDA card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell.cell["chips"]):
        print(f"run.py: {args.workload} needs {cell.cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    res = run(cell, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"run.py: the measured process holds {found}", file=sys.stderr)
        return 4
    checks = res.pop("checks")
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
