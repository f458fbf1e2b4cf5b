"""Host ms a step inside the program's ff.step spans in which no device
event ran: the device waiting on the host inside the step, which a step
captured as one CUDA graph would remove (fbench.spans)."""

from fbench.spans import intervals, step_idle_ns


def read(trace):
    idle = step_idle_ns(trace)
    if idle is None:
        return None
    return idle / 1e6 / len(intervals(trace, "step"))
