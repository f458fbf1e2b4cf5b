"""Device ms of the kernels launched inside the benchmark's span around
solver.radiation.maybe_correct (radiation/fvdom.py), over the steps whose
call solved rays."""


def read(trace):
    if not trace.rad_steps:
        return None
    idx = trace.in_spans("rad", where=lambda a: a.get("solved"))
    if not idx:
        return None
    return sum(trace.device[i][2] - trace.device[i][1] for i in idx) / 1e6 / trace.rad_steps
