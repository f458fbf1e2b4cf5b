"""Host ms a step of the traced window outside every ff.step span: the
calls' log copies to the host (which wait on the device), make_chunk's
stacking of the logs and the loop around the steps (fbench.spans)."""

from fbench.spans import intervals


def read(trace):
    steps = intervals(trace, "step")
    if not steps or trace.wall_ns <= 0:
        return None
    return (trace.wall_ns - sum(e - s for s, e in steps)) / 1e6 / len(steps)
