"""Host ms a step inside the program's ff.log spans, children included: the
step's diagnostics, the Courant numbers at its start and the end-of-step
reductions and function objects (fbench.spans)."""

from fbench.spans import host_ms_per_step


def read(trace):
    return host_ms_per_step(trace, "log")
