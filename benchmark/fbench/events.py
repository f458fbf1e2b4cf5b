"""The profiler-event arithmetic of the benchmark's traced runs.

`kernel_launches` and `busy_us` are frozen copies of
firefoam_torch/profile_step.py's, and `collect` reads the profiler's raw
kineto events as its `device_events` does (prof.events() and
key_averages() first build an event tree in Python, which takes tens of
seconds for a step of 40,000 launches), into a plain `Trace` that the
per-layer readers (benchmark/metrics/) take. Nothing here touches the
measured program.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# the port's own CUDA kernels (csrc/dia_krylov.cu): nvcc names a kernel of
# the file's unnamed namespace "(anonymous namespace)::<name>"
CSRC_KERNEL = re.compile(r"\(anonymous namespace\)::(pcg|bicgstab|smooth)\w*_kernel")
SPAN_PREFIX = "fbench."


def is_copy(name: str) -> bool:
    """A device copy or set, not a kernel."""
    return name.lower().startswith(("memcpy", "memset"))


def kernel_launches(dev) -> int:
    """Device kernels among (name, start, end) device events (no copy or
    set)."""
    return sum(1 for name, _, _ in dev if not is_copy(name))


def busy_us(dev) -> float:
    """Union of the [start, end) intervals of the device events, in µs."""
    return sum(e - s for s, e in union(dev)) / 1e3


def union(dev) -> List[Tuple[int, int]]:
    """The [start, end) intervals (ns) in which some device event ran."""
    out: List[List[int]] = []
    for s, e in sorted((ev[1], ev[2]) for ev in dev):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Trace:
    """One traced window, in plain numbers.

    device: (name, start ns, end ns) of every device kernel, copy and set;
    launch_ns: for each of them the host time of its launch (None where the
    profiler linked none); reads: host reads of a device scalar; spans: the
    benchmark's own spans by name, (start ns, end ns, attributes); cpu_ops:
    (name, start ns, end ns) of the host's operators, for the idle gaps;
    steps, rad_steps: the steps traced and those that solved fvDOM rays;
    wall_ns: the traced window's host-clock length; solves: the Krylov
    solves the window asked for, in call order (fbench.layers)."""

    device: List[Tuple[str, int, int]]
    launch_ns: List[Optional[int]]
    reads: int
    spans: Dict[str, List[Tuple[int, int, dict]]]
    cpu_ops: List[Tuple[str, int, int]]
    steps: int
    wall_ns: int
    rad_steps: int = 0
    solves: List[dict] = field(default_factory=list)

    def kernels(self):
        """(index, name, start, end) of the device kernels (no copy or set)."""
        return [(i, n, s, e) for i, (n, s, e) in enumerate(self.device) if not is_copy(n)]

    def in_spans(self, span: str, where=None) -> List[int]:
        """Indices of the device events launched inside the spans named
        `span` (those whose attributes satisfy `where`, if given)."""
        iv = sorted((s, e) for s, e, a in self.spans.get(span, ()) if where is None or where(a))
        starts = [s for s, _ in iv]
        out = []
        for i, t in enumerate(self.launch_ns):
            k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if k >= 0 and t <= iv[k][1]:
                out.append(i)
        return out


def _is_runtime(e) -> bool:
    """A call of the CUDA API (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...), by its activity type where the profiler gives one
    and by its name otherwise."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type()).lower().startswith("cuda_")
    name = e.name()
    return name.startswith("cu") and "::" not in name


def collect(prof, steps: int, wall_ns: int, span_attrs: Dict[str, List[dict]]) -> Trace:
    """A Trace of a finished torch.profiler window over `steps` steps.
    span_attrs: for each span name, the attributes of its occurrences in
    order (the host's record of what each span did)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, corr, launch_at, reads = [], [], {}, 0
    spans: Dict[str, List[Tuple[int, int, dict]]] = {}
    cpu_ops = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith(SPAN_PREFIX):
                # the profiler's device-side copy of a benchmark span (it
                # covers the span's kernels and the idle time between them)
                continue
            s = e.start_ns()
            dev.append((name, s, s + e.duration_ns()))
            corr.append(e.correlation_id())
            continue
        s = e.start_ns()
        end = s + e.duration_ns()
        if name == "aten::_local_scalar_dense":
            reads += 1
        if name.startswith(SPAN_PREFIX):
            spans.setdefault(name[len(SPAN_PREFIX):], []).append((s, end, {}))
        elif _is_runtime(e):
            # the CUDA API's call (a launch, a copy): its correlation id is
            # that of the device event it started
            launch_at[e.correlation_id()] = s
        else:
            cpu_ops.append((name, s, end))
    for name, occ in spans.items():
        occ.sort(key=lambda x: x[0])
        attrs = span_attrs.get(name, [])
        for k, (s, end, _) in enumerate(occ):
            occ[k] = (s, end, attrs[k] if k < len(attrs) else {})
    launch_ns = [launch_at.get(c) if c else None for c in corr]
    return Trace(dev, launch_ns, reads, spans, cpu_ops, steps, wall_ns)


def idle_gaps(trace: Trace, top: int = 10) -> List[List]:
    """The `top` longest intervals of the traced window in which no device
    event ran, each [label, seconds]: the label is the innermost host
    operator (or benchmark span) that spans the whole gap, or where none
    does, "python after <op>" with the last operator that began before the
    gap ended."""
    iv = union(trace.device)
    if not iv:
        return []
    gaps = sorted(((iv[k + 1][0] - iv[k][1], iv[k][1], iv[k + 1][0]) for k in range(len(iv) - 1)),
                  reverse=True)[:top]
    ops = trace.cpu_ops + [(SPAN_PREFIX + n, s, e) for n, occ in trace.spans.items()
                           for s, e, _ in occ]
    out = []
    for length, s, e in gaps:
        best, last = None, None
        for name, os_, oe in ops:
            if os_ <= s and oe >= e and (best is None or oe - os_ < best[1]):
                best = (name, oe - os_)
            if os_ <= e and (last is None or os_ > last[1]):
                last = (name, os_)
        label = best[0] if best else f"python after {last[0]}" if last else "python"
        out.append([label, length / 1e9])
    return out


def top_device_ops(trace: Trace, top: int = 10) -> List[List]:
    """The `top` device operations by total time, each [name, seconds]."""
    tot: Dict[str, int] = {}
    for name, s, e in trace.device:
        tot[name] = tot.get(name, 0) + (e - s)
    return [[n, t / 1e9] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
