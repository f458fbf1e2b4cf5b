"""Named host spans at the phases of the step, for torch.profiler.

`span(name)` is a context manager that records one operator event named
"ff.<name>" in a running torch.profiler window, on the profiler's host
clock beside the aten operators and the CUDA runtime calls that launch the
step's kernels. With no profiler running it costs well under a
microsecond, so the spans are always in place: there is no switch.

They are `torch._C._profiler._RecordFunctionFast` ranges: a plain
operator event. `torch.profiler.record_function` would record a user
annotation instead, which the profiler also copies onto the device's
timeline when it traces CUDA, where it would read as device work covering
the whole range.

Spans nest by their intervals on the one host thread: a span's parent is
the innermost span that contains it. Every span, where it sits, and the
metric of the benchmark (benchmark/metrics/<name>.py) that reads it:

  ff.step                FireFoamSolver.step, the whole step (also each
                         step of make_chunk): step_idle_ms_per_step,
                         outside_step_ms_per_step; its self time is the
                         rho equation and the time advance
  ff.log                 the Courant numbers at the step's start, and the
                         end-of-step diagnostics from Qdot_total through
                         the function objects: log_host_ms_per_step
  ff.lagrangian          _evolve_cloud (the parcels' sources; zero
                         sources without a cloud)
  ff.surfaceFilm         _evolve_film, where the case has a film
  ff.pyrolysis           _evolve_pyrolysis, where the case has pyrolysis
  ff.UEqn                _u_eqn: ueqn_host_ms_per_step
  ff.YEqn                _multivariate_weights and _y_eqns:
                         yeqn_host_ms_per_step
  ff.radiation           radiation.maybe_correct
  ff.radiation.solve     inside it, the steps that solve: fvDOM's
                         _solve_rays, P1's _solve_G;
                         rad_solve_ms_per_rad_step reads the device time
                         launched in the ff.radiation spans that hold one
  ff.EEqn                _e_eqn and the T_min/T_max log (EEqn.H prints
                         min/max(T)): eeqn_host_ms_per_step
  ff.pEqn                _p_eqn, once per PISO corrector:
                         peqn_host_ms_per_step
  ff.kEqn                turb.correct, alphat and the three wall-function
                         passes: keqn_host_ms_per_step
"""

from __future__ import annotations

import torch

PREFIX = "ff."


def span(name: str):
    """A context manager recording the span "ff.<name>" in a running
    torch.profiler window."""
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)
