"""How `correct` is decided: the program's output against the plain
reference (benchmark/plainfire, float64, its plain Krylov solvers).

The reference is a frozen copy of the program's step as it stood when the
benchmark was made, cut to what the benchmark's cases run, with plain
Jacobi-preconditioned CG and BiCGStab in place of the program's CUDA
kernels. So it judges the program's kernels, its float32 arithmetic and
every later change to the program against that frozen step; it is no
independent check of the physics that the copy shares with the program.

The reference builds its own solver from the case files the benchmark
wrote (mesh, geometry, thermo tables, solver coefficients: nothing the
program derived), makes its own initial state from the seed's inputs and
compares it with the program's (the "start"). It then follows the
program's 20-step segment from the program's warm state, widened to
float64: a fire LES in float32 and in float64 parts within some tens of
steps, so a reference that marched from t = 0 on its own would judge the
chaos of the flow, not the program. The numbers compared, each over the
reference's range of that output (a 2-D output column by column, the
widest column):

  start    the initial state's widest gap (T, U, p, k, Y), over each
           field's magnitude;
  T, U, p_rgh, hs, k, Y    the root mean square gap of the gas fields at
           the segment's end (the solves that K1 and K2 served: U, Yi, h,
           k and p_rgh). Their widest gaps swing from seed to seed by 10x
           where one cell's limiter flips;
  I, qr    the same of the fvDOM intensities and the walls' radiative
           flux.

The control (`bf16_state`) is the same reference with its state held in
bfloat16 between steps, each step computed in float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

GAS_FIELDS = ("T", "U", "p_rgh", "hs", "k", "Y")
START_FIELDS = ("T", "U", "p", "k", "Y")


def _is_field(x) -> bool:
    return isinstance(x, tuple) and getattr(x, "_fields", None) == ("i", "b")


def snapshot(state) -> dict:
    """The state as numpy leaves of their own dtype ((i, b) fields as
    dicts)."""

    def conv(x):
        if _is_field(x):
            return {"i": conv(x.i), "b": conv(x.b)}
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return x.detach().cpu().numpy()

    return {k: conv(v) for k, v in state.items()}


def to_state(snap: dict, like: dict, dtype, device) -> dict:
    """A state of the reference's classes (those of `like`, its own initial
    state) from a snapshot: floating leaves in `dtype` on `device`, integer
    and boolean leaves as they are."""

    def conv(x, ref):
        if _is_field(ref):
            return type(ref)(conv(x["i"], ref.i), conv(x["b"], ref.b))
        if isinstance(ref, dict):
            return {k: conv(x[k], ref.get(k)) for k in x}
        if isinstance(x, list):
            return [conv(v, ref[i] if isinstance(ref, list) and i < len(ref) else None)
                    for i, v in enumerate(x)]
        if isinstance(x, dict) and set(x) == {"i", "b"}:
            from plainfire.ops import VolField

            return VolField(conv(x["i"], None), conv(x["b"], None))
        if isinstance(x, dict):
            return {k: conv(v, None) for k, v in x.items()}
        t = torch.as_tensor(np.asarray(x))
        return t.to(device=device, dtype=dtype) if t.is_floating_point() else t.to(device)

    return {k: conv(v, like.get(k)) for k, v in snap.items()}


def round_bf16(state):
    """Every floating leaf of the state rounded to bfloat16 (and back)."""

    def conv(x):
        if _is_field(x):
            return type(x)(conv(x.i), conv(x.b))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        if torch.is_tensor(x) and x.is_floating_point():
            return x.to(torch.bfloat16).to(x.dtype)
        return x

    return {k: conv(v) for k, v in state.items()}


class Reference:
    """The plain reference of one case on `device`: float64, or with
    `bf16_state` the control (float32 steps, the state in bfloat16)."""

    def __init__(self, case_dir: str, device, bf16_state: bool = False):
        from plainfire.models.firefoam import FireFoamSolver

        self.bf16 = bf16_state
        self.dtype = torch.float32 if bf16_state else torch.float64
        self.device = torch.device(device)
        self.solver = FireFoamSolver(case_dir, device=self.device, dtype=self.dtype)
        self.init = self.solver.initial_state()

    def _hold(self, st):
        return round_bf16(st) if self.bf16 else st

    def start(self, inputs) -> dict:
        """The initial state with the seed's inputs applied."""
        from .inputs import apply_inputs

        return snapshot(self._hold(apply_inputs(self.init, inputs)))

    def segment(self, warm: dict, n_steps: int):
        """(snapshot, qr) after n_steps steps from the program's warm state."""
        st = self._hold(to_state(warm, self.init, self.dtype, self.device))
        for _ in range(n_steps):
            st, _ = self.solver.step(st)
            st = self._hold(st)
        return snapshot(st), qr_of(self.solver, st)


def qr_of(solver, state) -> Optional[np.ndarray]:
    """The walls' net radiative flux of a state, by the solver's own fvDOM."""
    rad = solver.radiation
    if rad is None or not hasattr(rad, "qr_boundary") or "rad" not in state:
        return None
    return rad.qr_boundary(state["rad"]).detach().cpu().numpy()


def _gap(a, b, by_range: bool = True, rms: bool = False) -> float:
    """The widest |a − b| (with `rms` its root mean square) over the
    reference's range, or with by_range False over its largest magnitude,
    per column of a 2-D output (the widest of the columns); a column's
    scale is floored at 1e-6 of the output's largest magnitude."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if b.size == 0:
        return 0.0
    if b.ndim == 1:
        a, b = a[:, None], b[:, None]
    mag = np.abs(b).max(axis=0)
    scale = np.maximum(b.max(axis=0) - b.min(axis=0), 1e-6 * mag) if by_range else mag
    scale = np.maximum(scale, max(1e-6 * float(mag.max()), 1e-300))
    d = np.abs(a - b)
    gap = np.sqrt((d * d).mean(axis=0)) if rms else d.max(axis=0)
    return float((gap / scale).max())


def start_gap(prog: dict, ref: dict) -> float:
    """The initial state's widest gap over each field's magnitude (most of
    it is uniform at t = 0; p in place of p_rgh, which sits at the rounding
    noise of p − ρgh there, and no hs, which is T's and Y's by the thermo
    and about 0 at the initial 298.15 K)."""
    return max(_gap(prog[f]["i"], ref[f]["i"], by_range=False) for f in START_FIELDS)


def gaps(prog: dict, ref: dict, prog_qr, ref_qr) -> Dict[str, float]:
    """The numbers compared at the segment's end (see the module's doc)."""
    out = {f: _gap(prog[f]["i"], ref[f]["i"], rms=True) for f in GAS_FIELDS}
    if "rad" in ref:
        I_p = np.asarray(prog["rad"]["I"], np.float64).reshape(-1)
        I_r = np.asarray(ref["rad"]["I"], np.float64).reshape(-1)
        out["I"] = _gap(I_p, I_r, rms=True)
    if ref_qr is not None:
        out["qr"] = _gap(prog_qr, ref_qr, rms=True)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit; a number without a limit fails."""
    checks, ok = {}, True
    for name, v in numbers.items():
        lim = limits.get(name)
        checks[name] = {"value": v, "limit": lim}
        if lim is None or not np.isfinite(v) or v > lim:
            ok = False
    return ok, checks
