"""The program's own spans in a traced window.

firefoam_torch/utils/spans.py records "ff.<phase>" as plain host operator
events on the profiler's clock, so fbench.events.collect puts them in
`Trace.cpu_ops` beside the aten operators; none reaches `Trace.device`.
A program without them (an older checkout) leaves every reader here with
nothing to read. The prefix is the program's (utils/spans.py PREFIX), not
imported: the benchmark also runs on checkouts that predate the module.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from .events import union

PREFIX = "ff."


def intervals(trace, name: str) -> List[Tuple[int, int]]:
    """The (start ns, end ns) of the program's spans "ff.<name>", in order."""
    full = PREFIX + name
    return sorted((s, e) for n, s, e in trace.cpu_ops if n == full)


def host_ms_per_step(trace, name: str) -> Optional[float]:
    """Host ms a step inside the spans "ff.<name>" (their children
    included), over the ff.step spans; 0 where the steps ran none."""
    steps = intervals(trace, "step")
    if not steps:
        return None
    return sum(e - s for s, e in intervals(trace, name)) / 1e6 / len(steps)


def step_idle_ns(trace) -> Optional[int]:
    """The ff.step spans' ns in which no device event ran."""
    steps = intervals(trace, "step")
    if not steps or not trace.device:
        return None
    busy = union(trace.device)
    starts = [a for a, _ in busy]
    idle = 0
    for s, e in steps:
        idle += e - s
        k = max(bisect.bisect_right(starts, s) - 1, 0)
        while k < len(busy) and busy[k][0] < e:
            idle -= max(0, min(e, busy[k][1]) - max(s, busy[k][0]))
            k += 1
    return idle
