"""The Krylov kernels' share of their roofline: the sum over K1-K3
launches of each solve's least time on the card (fbench.roofline, counted
from the solve's system and iterations), over their device time. The
launches are matched to the solves the window asked for in order; where
the counts differ, nothing is read."""

from fbench.events import CSRC_KERNEL
from fbench.roofline import least_seconds


def read(trace):
    ks = sorted((s, e) for _, n, s, e in trace.kernels() if CSRC_KERNEL.search(n))
    if not ks or len(ks) != len(trace.solves):
        return None
    least = sum(least_seconds(v["kind"], v["esize"], v["nbytes"], v["nC"], v["B"], v["K"],
                              v["iters"])[0] for v in trace.solves)
    return 100.0 * least / (sum(e - s for s, e in ks) / 1e9)
