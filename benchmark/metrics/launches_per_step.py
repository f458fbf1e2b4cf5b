"""Device kernels a step (no copy or set), from the profiler's raw events
(fbench.events.kernel_launches): the host's dispatch load."""

from fbench.events import kernel_launches


def read(trace):
    if not trace.steps or not trace.device:
        return None
    return kernel_launches(trace.device) / trace.steps
