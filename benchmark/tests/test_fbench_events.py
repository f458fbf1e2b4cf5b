"""The traced run's arithmetic on synthetic events: the busy union, the
launch count, spans, idle gaps, the roofline bound and every reader."""

import os

import pytest

from fbench import events, roofline
from fbench.events import Trace
from fbench.harness import reader

K = "void (anonymous namespace)::pcg_grid_kernel<float, false>(Params)"
B = "void (anonymous namespace)::bicgstab_rows_kernel<float, 3>(Params)"


def _trace():
    dev = [("elementwise_kernel", 0, 100), ("Memcpy DtoH", 150, 160), (K, 200, 1200),
           ("gemv", 1100, 1300), (B, 2000, 2500), ("Memset", 3000, 3010)]
    launch = [0, 140, 190, 1000, 1900, None]
    spans = {"rad": [(1800, 1950, {"solved": True}), (2900, 3005, {"solved": False})],
             "other": [(-10, 5, {})]}
    cpu = [("aten::mul", -5, 150), ("aten::item", 1300, 2000)]
    solves = [{"kind": "pcg", "esize": 4, "nbytes": 4e6, "nC": 100000, "B": 1, "K": 3,
               "iters": 18.0},
              {"kind": "bicgstab", "esize": 4, "nbytes": 2.0e7, "nC": 100000, "B": 16, "K": 3,
               "iters": 200.0}]
    return Trace(dev, launch, 3, spans, cpu, steps=2, wall_ns=4000, rad_steps=1, solves=solves)


def test_spans_on_the_device_timeline_are_left_out():
    class E:
        def __init__(self, name, dev, s, d, c):
            self.n, self.dev, self.s, self.d, self.c = name, dev, s, d, c

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

    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = [E("fbench.other", cpu, 0, 100, 1), E("cudaLaunchKernel", cpu, 10, 5, 7),
           E("fbench.other", cuda, 20, 500, 1), E("k", cuda, 30, 10, 7),
           E("aten::_local_scalar_dense", cpu, 50, 5, 9)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return evs

    tr = events.collect(Prof, 1, 1000, {"other": [{}]})
    assert tr.device == [("k", 30, 40)] and tr.launch_ns == [10] and tr.reads == 1
    assert tr.in_spans("other") == [0] and tr.cpu_ops == [("aten::_local_scalar_dense", 50, 55)]


def test_busy_union_and_launches():
    tr = _trace()
    assert events.union(tr.device) == [(0, 100), (150, 160), (200, 1300), (2000, 2500),
                                       (3000, 3010)]
    assert events.busy_us(tr.device) == pytest.approx((100 + 10 + 1100 + 500 + 10) / 1e3)
    assert events.kernel_launches(tr.device) == 4
    assert [i for i, *_ in tr.kernels()] == [0, 2, 3, 4]


def test_spans_take_the_kernels_launched_inside():
    tr = _trace()
    assert tr.in_spans("rad") == [4]
    assert tr.in_spans("rad", where=lambda a: not a["solved"]) == []
    assert tr.in_spans("other") == [0]
    assert tr.in_spans("film") == []


def test_idle_gaps_and_top_ops():
    tr = _trace()
    gaps = events.idle_gaps(tr, top=2)
    assert gaps[0] == ["aten::item", pytest.approx(700e-9)]
    assert gaps[1] == ["python after fbench.rad", pytest.approx(500e-9)]
    top = events.top_device_ops(tr, top=2)
    assert top[0] == [K, pytest.approx(1e-6)]


def test_roofline_bound():
    s, by = roofline.least_seconds("pcg", 4, 4e6, 100000, 1, 3, 18.0)
    flops = 100000 * (40 + 29 * 18.0)
    assert by == "operations" or s == pytest.approx(4e6 / roofline.HBM_BYTES_S)
    assert s == pytest.approx(max(4e6 / 3.35e12, flops / 67e12))
    # each offset beyond 3 adds 4 operations a row: 2 rows a prologue, 1 a CG iteration
    s34, _ = roofline.least_seconds("pcg", 8, 0.0, 1000, 1, 34, 10.0)
    assert s34 == pytest.approx(1000 * (40 + 2 * 124 + (29 + 124) * 10) / 34e12)


def test_readers_on_a_synthetic_trace():
    tr = _trace()
    r = {m: reader(m)(tr) for m in ("launches_per_step", "host_reads_per_step",
                                    "device_idle_pct", "torch_ops_ms_per_step",
                                    "krylov_ms_per_step", "krylov_roofline",
                                    "rad_ms_per_rad_step")}
    assert r["launches_per_step"] == 2.0 and r["host_reads_per_step"] == 1.5
    assert r["device_idle_pct"] == pytest.approx(100 - 100 * 1720 / 4000)
    assert r["torch_ops_ms_per_step"] == pytest.approx((100 + 200) / 1e6 / 2)
    assert r["krylov_ms_per_step"] == pytest.approx(1500 / 1e6 / 2)
    least = sum(roofline.least_seconds(s["kind"], 4, s["nbytes"], s["nC"], s["B"], 3,
                                       s["iters"])[0] for s in tr.solves)
    assert r["krylov_roofline"] == pytest.approx(100 * least / 1500e-9)
    assert r["rad_ms_per_rad_step"] == pytest.approx(500 / 1e6)


def test_readers_find_nothing_to_read():
    empty = Trace([], [], 0, {}, [], steps=2, wall_ns=1000)
    for m in os.listdir(os.path.join(os.path.dirname(os.path.dirname(__file__)), "metrics")):
        assert reader(m[:-3])(empty) is None
    tr = _trace()
    tr.solves = tr.solves[:1]  # a launch the window did not record: no roofline
    assert reader("krylov_roofline")(tr) is None
