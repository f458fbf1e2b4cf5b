"""The readers of the program's own spans (firefoam_torch/utils/spans.py,
fbench.spans) on a synthetic trace of two steps, the second without a
radiation solve; `collect` keeping a host-side ff.* event among the host
operators; and on the card (marker `gpu`) two steps of the room whose
traces hold no ff.* device event and launch what the same steps launch
with the spans taken out."""

import contextlib
import importlib.util
import os
import sys
import time

import pytest

from fbench import events
from fbench.events import Trace
from fbench.harness import reader

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEP1 = [("ff.step", 0, 1000), ("ff.log", 0, 50), ("ff.lagrangian", 50, 100),
         ("ff.UEqn", 100, 250), ("ff.YEqn", 250, 400), ("ff.radiation", 400, 600),
         ("ff.radiation.solve", 420, 590), ("ff.EEqn", 600, 700), ("ff.pEqn", 700, 760),
         ("ff.pEqn", 760, 820), ("ff.kEqn", 820, 900), ("ff.log", 900, 980)]
# the second step solves no rays
STEP2 = [("ff.step", 1200, 2000), ("ff.log", 1200, 1220), ("ff.lagrangian", 1220, 1250),
         ("ff.UEqn", 1250, 1400), ("ff.YEqn", 1400, 1500), ("ff.radiation", 1500, 1550),
         ("ff.EEqn", 1550, 1650), ("ff.pEqn", 1650, 1700), ("ff.pEqn", 1700, 1760),
         ("ff.kEqn", 1760, 1900), ("ff.log", 1900, 1990)]
# (name, start, end) on the device, and each one's launch on the host
DEVICE = [("k0", 100, 300), ("kr1", 450, 650), ("kr2", 650, 700), ("Memcpy DtoH", 980, 1100),
          ("kr3", 1520, 1600), ("k5", 1900, 2100)]
LAUNCH = [90, 430, 500, 970, 1510, 1300]
NEW = ("step_idle_ms_per_step", "outside_step_ms_per_step", "ueqn_host_ms_per_step",
       "yeqn_host_ms_per_step", "eeqn_host_ms_per_step", "peqn_host_ms_per_step",
       "keqn_host_ms_per_step", "log_host_ms_per_step", "rad_solve_ms_per_rad_step")


def _trace(steps=(STEP1, STEP2)):
    cpu = [op for st in steps for op in st]
    cpu += [("aten::add", 120, 130), ("aten::copy_", 2050, 2400)]
    return Trace(list(DEVICE), list(LAUNCH), 1, {}, cpu, steps=len(steps), wall_ns=2500)


def test_readers_of_the_program_spans():
    r = {m: reader(m)(_trace()) for m in NEW}
    # device busy [100, 300), [450, 700), [980, 1100), [1520, 1600),
    # [1900, 2100): step 1 covers 200 + 250 + 20 of 1000 ns, step 2 80 + 100
    # of 800
    assert r["step_idle_ms_per_step"] == pytest.approx((530 + 620) / 1e6 / 2)
    assert r["outside_step_ms_per_step"] == pytest.approx((2500 - 1800) / 1e6 / 2)
    assert r["ueqn_host_ms_per_step"] == pytest.approx((150 + 150) / 1e6 / 2)
    assert r["yeqn_host_ms_per_step"] == pytest.approx((150 + 100) / 1e6 / 2)
    assert r["eeqn_host_ms_per_step"] == pytest.approx((100 + 100) / 1e6 / 2)
    assert r["peqn_host_ms_per_step"] == pytest.approx((60 + 60 + 50 + 60) / 1e6 / 2)
    assert r["keqn_host_ms_per_step"] == pytest.approx((80 + 140) / 1e6 / 2)
    assert r["log_host_ms_per_step"] == pytest.approx((50 + 80 + 20 + 90) / 1e6 / 2)
    # kr1 and kr2 were launched inside the first step's ff.radiation, which
    # holds the one solve; kr3 inside the second's, which holds none
    assert r["rad_solve_ms_per_rad_step"] == pytest.approx((200 + 50) / 1e6)


def test_a_window_without_a_radiation_solve():
    tr = _trace(steps=(STEP2,))
    assert reader("rad_solve_ms_per_rad_step")(tr) is None
    assert reader("ueqn_host_ms_per_step")(tr) == pytest.approx(150 / 1e6)
    assert reader("step_idle_ms_per_step")(tr) == pytest.approx(620 / 1e6)


def test_a_program_without_spans_leaves_them_unread():
    tr = _trace(steps=())
    tr.cpu_ops = [("aten::add", 120, 130)]
    assert all(reader(m)(tr) is None for m in NEW)
    # a phase the steps never ran reads 0
    tr = _trace()
    tr.cpu_ops = [op for op in tr.cpu_ops if op[0] != "ff.kEqn"]
    assert reader("keqn_host_ms_per_step")(tr) == 0.0


def test_idle_gaps_name_the_innermost_phase():
    tr = _trace()
    tr.device = [("a", 0, 10), ("b", 1270, 1280), ("c", 1380, 1390)]
    tr.launch_ns = [0, 1260, 1370]
    gaps = events.idle_gaps(tr, top=2)
    # [10, 1270) lies in no span; [1280, 1380) inside step 2's ff.UEqn
    assert gaps[0] == ["python after ff.UEqn", pytest.approx(1260e-9)]
    assert gaps[1] == ["ff.UEqn", pytest.approx(100e-9)]


class _Event:
    def __init__(self, name, dev, s, d, c, kind):
        self.n, self.dev, self.s, self.d, self.c, self.kind = name, dev, s, d, c, kind

    def name(self):
        return self.n

    def device_type(self):
        return self.dev

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c

    def activity_type(self):
        return self.kind


def test_collect_keeps_a_program_span_among_the_host_operators():
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = [_Event("ff.step", cpu, 0, 100, 0, "cpu_op"),
           _Event("ff.UEqn", cpu, 5, 50, 0, "cpu_op"),
           _Event("cudaLaunchKernel", cpu, 10, 5, 7, "cuda_runtime"),
           _Event("k", cuda, 30, 10, 7, "kernel")]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return evs

    tr = events.collect(Prof, 1, 200, {})
    assert tr.device == [("k", 30, 40)] and tr.launch_ns == [10]
    assert tr.cpu_ops == [("ff.step", 0, 100), ("ff.UEqn", 5, 55)] and tr.spans == {}
    assert reader("step_idle_ms_per_step")(tr) == pytest.approx(90 / 1e6)


def _profile(solver, state, steps):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter_ns()
        for _ in range(steps):
            state, _ = solver.step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter_ns() - t0
    return events.collect(prof, steps, wall, {})


@pytest.mark.gpu
def test_the_spans_add_nothing_on_the_device(tmp_path, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from firefoam_torch.models import firefoam
    from firefoam_torch.models.firefoam import FireFoamSolver
    from firefoam_torch.radiation import fvdom, p1

    spec = importlib.util.spec_from_file_location(
        "steckler_room", os.path.join(BENCH, "cases", "steckler_room.py"))
    room = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(room)
    solver = FireFoamSolver(room.write(str(tmp_path / "case"), h=0.2), device="cuda",
                            dtype=torch.float32)
    state = warm = solver.initial_state()
    for _ in range(2):  # the first step solves the rays: build and warm both
        warm, _ = solver.step(warm)
    spans = _profile(solver, state, 2)
    names = {n for n, *_ in spans.cpu_ops if n.startswith("ff.")}
    assert {"ff.step", "ff.UEqn", "ff.pEqn", "ff.radiation.solve", "ff.log"} <= names
    assert not [n for n, *_ in spans.device if n.startswith("ff.")]
    assert reader("rad_solve_ms_per_rad_step")(spans) > 0
    for mod in (firefoam, fvdom, p1):
        monkeypatch.setattr(mod, "span", lambda name: contextlib.nullcontext())
    plain = _profile(solver, state, 2)
    assert not [n for n, *_ in plain.cpu_ops if n.startswith("ff.")]
    assert events.kernel_launches(spans.device) == events.kernel_launches(plain.device)
    print(f"2 room steps: {events.kernel_launches(spans.device)} launches with and without "
          f"the spans; card: {torch.cuda.get_device_name(0)}", file=sys.stderr)
