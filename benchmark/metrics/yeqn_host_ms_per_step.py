"""Host ms a step inside the program's ff.YEqn spans, children included:
the species equations and the reaction rate (_multivariate_weights,
_y_eqns) (fbench.spans)."""

from fbench.spans import host_ms_per_step


def read(trace):
    return host_ms_per_step(trace, "YEqn")
