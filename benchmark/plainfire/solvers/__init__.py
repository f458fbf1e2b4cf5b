from .linear import solve_scalar, pcg, bicgstab, jacobi_smooth, SolverResult
