"""How far the (4,4,60) banded columns of chip_smoke.py amplify a last-bit
difference on their own: two float64 CPU chains of one solver from t = 0,
the second with every cell of the initial T moved by one ulp (towards +inf),
stepped side by side.

    python tools/column_witness.py [--steps 10] [--out file.json]

Runs both columns of chip_smoke.py's phases 16 and 17 (layout "banded",
34 offsets, the flat solvers): the castellated fire
(write_castellated_fire_case) and the smoothSolver fire
(write_smooth_fire_case castellated the same way, Yi, h and k on the
Jacobi smoother). Prints, per column and step, the largest difference of
the two chains' T and U relative to the field's largest value, and one JSON
line with the same numbers. A card-vs-CPU chain of the same steps that
parts by about as much owes its gap to the case, not to the card. CPU only;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from firefoam_torch.models.firefoam import FireFoamSolver  # noqa: E402
from firefoam_torch.utils.synthcase import (  # noqa: E402
    castellate_case, write_castellated_fire_case, write_smooth_fire_case)

N_COLUMN = (4, 4, 60)  # chip_smoke.py's N_COLUMN and COLUMN_KW
SIZE = (0.2, 0.2, 3.0)


def witness(case, steps):
    """Per step, {"T": …, "U": …}: the two chains' largest relative gap."""
    solver = FireFoamSolver(case, device="cpu", dtype=torch.float64, layout="banded",
                            exact_solvers=False, gmg=False, amg=False)
    a = solver.initial_state()
    T = a["T"]
    b = dict(a, T=type(T)(torch.nextafter(T.i, torch.full_like(T.i, float("inf"))), T.b))
    gaps = []
    for _ in range(steps):
        a, _ = solver.step(a)
        b, _ = solver.step(b)
        gaps.append({f: float((a[f].i - b[f].i).abs().max() / a[f].i.abs().max())
                     for f in ("T", "U")})
    return solver.geom.n_cells, len(solver.geom.offsets), gaps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = {}
    with tempfile.TemporaryDirectory(prefix="column_witness_") as tmp:
        smooth = write_smooth_fire_case(os.path.join(tmp, "smooth"), n=N_COLUMN, size=SIZE)
        castellate_case(smooth, size=SIZE)
        cases = {"castellated": write_castellated_fire_case(os.path.join(tmp, "castellated"),
                                                            n=N_COLUMN, size=SIZE),
                 "smooth": smooth}
        for name, case in cases.items():
            cells, offsets, gaps = witness(case, args.steps)
            for i, g in enumerate(gaps, 1):
                print(f"{name} column ({cells} cells, {offsets} offsets) step {i}: "
                      f"T {g['T']:.3e}, U {g['U']:.3e}", flush=True)
            out[name] = {"cells": cells, "offsets": offsets, "gaps": gaps}
    line = json.dumps({"column_witness": out})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
