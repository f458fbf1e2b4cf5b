"""The benchmark's own spans and counters around the program's layers, set
in the traced run only by wrapping the entry points from outside:

  * "fbench.rad": `solver.radiation.maybe_correct` (radiation/fvdom.py),
    with whether the call solved rays (the model's host-side sweep count
    moved);
  * the DIA Krylov entry points of solvers/dia_krylov.py (K1-K3): each
    solve's system (kind, element size, operand bytes, cells, rows,
    offsets) and its iteration tensor, read on the host once the window
    has closed.
"""

from __future__ import annotations

from typing import Dict, List


class Layers:
    """Install with `install()`, take off with `remove()`."""

    def __init__(self, solver, dia_krylov):
        self.solver = solver
        self.dk = dia_krylov
        self.attrs: Dict[str, List[dict]] = {"rad": []}
        self.solves: List[dict] = []
        self._undo = []

    def install(self):
        import torch

        from .roofline import operand_bytes

        rec = torch.profiler.record_function
        rad = self.solver.radiation
        if rad is not None:
            orig_rad = rad.maybe_correct

            def maybe_correct(state, gas):
                before = (getattr(rad, "sweeps", None), getattr(rad, "solves", None))
                with rec("fbench.rad"):
                    out = orig_rad(state, gas)
                after = (getattr(rad, "sweeps", None), getattr(rad, "solves", None))
                self.attrs["rad"].append({"solved": after != before})
                return out

            rad.maybe_correct = maybe_correct
            self._undo.append(lambda: delattr(rad, "maybe_correct"))
        for kind in ("pcg", "bicgstab", "smooth"):
            name = f"dia_{kind}"
            orig = getattr(self.dk, name)

            def solve(diag, upper, lower, b, x0, offsets, *a, _orig=orig, _kind=kind, **kw):
                res = _orig(diag, upper, lower, b, x0, offsets, *a, **kw)
                self.solves.append({
                    "kind": _kind, "esize": x0.element_size(),
                    "nbytes": operand_bytes(diag, upper, lower, b, x0),
                    "nC": int(x0.shape[-1]), "B": int(x0.shape[0]) if x0.ndim == 2 else 1,
                    "K": len(offsets), "iters": res.n_iterations})
                return res

            setattr(self.dk, name, solve)
            self._undo.append(lambda _n=name, _o=orig: setattr(self.dk, _n, _o))

    def remove(self):
        """Take every wrapper off and read the solves' iterations."""
        for undo in reversed(self._undo):
            undo()
        self._undo = []
        for s in self.solves:
            s["iters"] = float(s["iters"].double().sum())
