"""Host ms a step inside the program's ff.UEqn spans, children included:
the momentum predictor (_u_eqn) (fbench.spans)."""

from fbench.spans import host_ms_per_step


def read(trace):
    return host_ms_per_step(trace, "UEqn")
