"""plainfire: the benchmark's plain reference of the fire step.

A frozen copy of the measured package's gas step in plain PyTorch
operations, cut to what the benchmark's cases run: its linear solves are
the plain Jacobi-preconditioned CG, BiCGStab and damped Jacobi
(solvers/linear.py) on every device, with none of the measured program's
CUDA kernels. The benchmark runs it in float64 to judge the program's
output, and it imports nothing of the program. Edits to the measured
package do not reach it: it moves only when the benchmark does. Being a
copy, it shares the program's physics as they stood when it was made; it
is no independent check of them.
"""

__version__ = "0.1.0"
