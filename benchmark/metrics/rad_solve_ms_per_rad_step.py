"""Device ms of what was launched inside the program's ff.radiation spans
that hold an ff.radiation.solve (the steps that solved fvDOM's rays or
P1's G), over the number of ff.radiation.solve spans (fbench.spans): the
program's twin of rad_ms_per_rad_step."""

from dataclasses import replace

from fbench.spans import intervals


def read(trace):
    solves = intervals(trace, "radiation.solve")
    if not solves:
        return None
    held = [(s, e, {}) for s, e in intervals(trace, "radiation")
            if any(s <= a and b <= e for a, b in solves)]
    # the launches inside them, as Trace.in_spans finds a benchmark span's
    idx = replace(trace, spans={"held": held}).in_spans("held")
    if not idx:
        return None
    return sum(trace.device[i][2] - trace.device[i][1] for i in idx) / 1e6 / len(solves)
