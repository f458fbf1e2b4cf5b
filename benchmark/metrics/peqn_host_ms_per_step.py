"""Host ms a step inside the program's ff.pEqn spans, children included:
both PISO correctors (_p_eqn) (fbench.spans)."""

from fbench.spans import host_ms_per_step


def read(trace):
    return host_ms_per_step(trace, "pEqn")
