"""100 − the share of the traced window's wall time in which some device
event ran (the union of their intervals, fbench.events.busy_us). An upper
bound of the untraced run's idle share: the profiler slows the host."""

from fbench.events import busy_us


def read(trace):
    if not trace.device or trace.wall_ns <= 0:
        return None
    return 100.0 - 100.0 * busy_us(trace.device) * 1e3 / trace.wall_ns
