"""The least time one H100 could take for a Krylov solve: a frozen copy of
chip_smoke.py's `bound()` and the published peaks it reads.

The work is counted from the solve's system alone (cells, offsets, rows,
iterations, the operands' bytes), never from the kernel that served it, so
one solve reads one bound whatever kernel a later change serves it with.
"""

from __future__ import annotations

# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s and non-tensor-core FLOP/s by element size
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}
# floating-point operations per cell, counted from csrc/dia_krylov.cu: the
# prologue (2 rows + norm sums) 40; a CG iteration 29; a BiCGStab
# iteration 58; a Jacobi sweep 18 and its residual check (once per 4
# sweeps) 17
FLOPS_PROLOGUE = 40
FLOPS_ITER = {"pcg": 29, "bicgstab": 58, "smooth": 18 + 17 / 4}
# DIA rows (matvecs) an iteration (sweep) computes: each offset beyond 3
# adds 4 operations a row (a product and a sum on each side); the prologue
# computes 2 rows
ROWS_ITER = {"pcg": 1, "bicgstab": 2, "smooth": 1 + 1 / 4}
ROWS_PROLOGUE = 2


def least_seconds(kind: str, esize: int, nbytes: float, nC: int, B: int, K: int,
                  iters: float):
    """(seconds, "bytes" | "operations"): the larger of the bytes the solve
    must move (each operand read once and x written once, `nbytes`) over
    HBM's rate and the operations its `iters` iterations (summed over its
    B rows) need over the peak rate, for a stencil of K offsets."""
    extra = 4 * (K - 3)
    flops = nC * (B * (FLOPS_PROLOGUE + ROWS_PROLOGUE * extra)
                  + (FLOPS_ITER[kind] + ROWS_ITER[kind] * extra) * float(iters))
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[esize]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def operand_bytes(diag, upper, lower, b, x0) -> int:
    """Each operand read once plus x (the shape of x0) written once."""
    ops = (diag, upper, lower, b, x0)
    return (sum(t.numel() for t in ops) + x0.numel()) * x0.element_size()
