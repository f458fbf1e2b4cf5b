"""Device ms a step of every kernel that is not one of the port's own
(csrc/): the equations and operators in PyTorch's and cuBLAS's kernels."""

from fbench.events import CSRC_KERNEL


def read(trace):
    ks = [(s, e) for _, n, s, e in trace.kernels() if not CSRC_KERNEL.search(n)]
    if not trace.steps or not ks:
        return None
    return sum(e - s for s, e in ks) / 1e6 / trace.steps
