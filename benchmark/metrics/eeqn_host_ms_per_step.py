"""Host ms a step inside the program's ff.EEqn spans, children included:
the energy equation and the thermo update (_e_eqn) (fbench.spans)."""

from fbench.spans import host_ms_per_step


def read(trace):
    return host_ms_per_step(trace, "EEqn")
