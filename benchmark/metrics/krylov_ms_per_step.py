"""Device ms a step of the port's Krylov kernels K1-K3 (csrc/dia_krylov.cu),
found by name."""

from fbench.events import CSRC_KERNEL


def read(trace):
    ks = [(s, e) for _, n, s, e in trace.kernels() if CSRC_KERNEL.search(n)]
    if not trace.steps or not ks:
        return None
    return sum(e - s for s, e in ks) / 1e6 / trace.steps
