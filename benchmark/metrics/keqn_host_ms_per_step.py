"""Host ms a step inside the program's ff.kEqn spans, children included:
the turbulence model and the wall functions (turb.correct, alphat, nut)
(fbench.spans)."""

from fbench.spans import host_ms_per_step


def read(trace):
    return host_ms_per_step(trace, "kEqn")
