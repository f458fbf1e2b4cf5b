"""Where two runs of the sprinkler fire part, and why.

    python -m firefoam_torch.spray_sensitivity [--cpu] [--n 30 15 20] [--pps 2000]
        [--steps 10]

Builds write_spray_fire_case(n, pps) and runs two studies with the flat
solvers (exact solvers, multigrid and AMG off, as chip_smoke.py's 9k
sprinkler fire runs):

1. The nudge. A float64 run against one whose initial U carries a 1e-14 m/s
   nudge, in lockstep; each step prints their relative T and U gaps. At the
   first step whose T gap grows more than 100-fold, the nudged run's step is
   replayed with the other run's multivariate convection weights (the one
   weight field the species and hs equations share, the minimum of every
   species' and hs's limiter) and that T gap is printed. Then the face whose
   weight change moves a species flux most: its cells and centre, the two
   weights, each run's limiters there and the mass fractions either side.
2. The float32 drift. float32 against float64, each step the largest
   relative T gap, with the float32 run's random draws as the generator
   makes them (its float32 mantissa comes from other bits than float64's)
   and again with the float64 draws rounded to float32.
3. The float32 cube root that sizes a parcel from its mass: x ** (1/3) in
   float32, and taken in float64 (lagrangian/cloud.py's _cbrt), against
   the float64 root over x in [1e-15, 1e-8] (spray diameters 0.01-2 mm):
   the mean and largest relative error of the diameter.

Runs on the CUDA card unless --cpu is given. Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile

import torch

from .lagrangian import prng
from .lagrangian.cloud import _cbrt
from .models.firefoam import FireFoamSolver
from .ops import VolField, fvm
from .utils.synthcase import write_spray_fire_case

NUDGE = 1e-14
JUMP = 100.0


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _solver(case, device, dtype):
    return FireFoamSolver(case, device=device, dtype=dtype, exact_solvers=False, gmg=False,
                          amg=False)


def _spy_weights(solver):
    """Keeps the last (state, weights) of solver._multivariate_weights."""
    seen = {}
    fn = solver._multivariate_weights

    def spy(state):
        # a copy: the step goes on to replace the dict's Y, hs and phi
        seen["state"], seen["w"] = dict(state), fn(state)
        return seen["w"]

    solver._multivariate_weights = spy
    return seen


def _limiters(solver, state, face):
    g = solver.geom
    Y = state["Y"]
    lims = [float(fvm.limited_linear_limiter(g, state["phi"].i, VolField(Y.i[:, s], Y.b[:, s]),
                                             k=1.0, bound01=True)[face])
            for s in range(len(solver.species))]
    return lims, float(fvm.limited_linear_limiter(g, state["phi"].i, state["hs"], k=1.0)[face])


def nudge_study(case, device, steps):
    a, b = (_solver(case, device, torch.float64) for _ in range(2))
    sa, sb = a.initial_state(), b.initial_state()
    gen = torch.Generator().manual_seed(0)
    U0 = sb["U"]
    sb["U"] = type(U0)(U0.i + NUDGE * torch.randn(U0.i.shape, generator=gen,
                                                  dtype=torch.float64).to(U0.i.device), U0.b)
    seen_a, seen_b = _spy_weights(a), _spy_weights(b)
    gap = 0.0
    for n in range(1, steps + 1):
        sb_prev = sb
        sa, _ = a.step(sa)
        sb, _ = b.step(sb)
        new = {f: _rel(sb[f].i, sa[f].i) for f in ("T", "U")}
        print(f"step {n}: nudged vs unperturbed T {new['T']:.3e} U {new['U']:.3e}")
        if gap > 0.0 and new["T"] > JUMP * gap:
            w_a, w_b, st_a, st_b = seen_a["w"], seen_b["w"], seen_a["state"], seen_b["state"]
            spy_b = b._multivariate_weights
            b._multivariate_weights = lambda state: w_a
            replay, _ = b.step(sb_prev)
            b._multivariate_weights = spy_b
            print(f"step {n} replayed with the unperturbed run's convection weights: T "
                  f"{_rel(replay['T'].i, sa['T'].i):.3e}, U {_rel(replay['U'].i, sa['U'].i):.3e}")
            g = a.geom
            Y = st_a["Y"].i
            dflux = (st_a["phi"].i * (w_a - w_b))[:, None] * (Y[g.nei] - Y[g.own])
            face = int(dflux.abs().amax(dim=1).argmax())
            s = int(dflux[face].abs().argmax())
            own, nei = int(g.own[face]), int(g.nei[face])
            print(f"largest flux change: face {face} (cells {own}, {nei}; centre "
                  f"{[round(float(v), 4) for v in g.Cf[face]]}), {a.species[s]} flux moved "
                  f"{float(dflux[face, s]):.3e} kg/s; weight {float(w_a[face]):.6f} unperturbed, "
                  f"{float(w_b[face]):.6f} nudged")
            for run, solver, st in (("unperturbed", a, st_a), ("nudged", b, st_b)):
                lims, lim_h = _limiters(solver, st, face)
                print(f"  {run} limiters: " + ", ".join(
                    f"{sp} {v:.6f}" for sp, v in zip(solver.species, lims)) + f", hs {lim_h:.6f}")
            print("  mass fractions either side: " + ", ".join(
                f"{sp} {float(Y[own, i]):.3e} | {float(Y[nei, i]):.3e}"
                for i, sp in enumerate(a.species)))
        gap = new["T"]


@contextlib.contextmanager
def float64_draws():
    """prng.uniform draws in float64 and rounds to the dtype asked for."""
    plain = prng.uniform

    def uniform(key, shape, dtype=torch.float64, minval=0.0, maxval=1.0, device=None):
        return plain(key, shape, torch.float64, minval, maxval, device).to(dtype)

    prng.uniform = uniform
    try:
        yield
    finally:
        prng.uniform = plain


def drift_study(case, device, steps):
    def run(dtype):
        solver = _solver(case, device, dtype)
        st = solver.initial_state()
        out = []
        for _ in range(steps):
            st, _ = solver.step(st)
            out.append(st["T"].i.double())
        return out, int(st["cloud"]["alive"].sum())

    T64, alive64 = run(torch.float64)
    for what in ("as drawn", "float64 draws rounded"):
        with float64_draws() if what != "as drawn" else contextlib.nullcontext():
            T32, alive32 = run(torch.float32)
        drift = [float(((t32 - t64).abs() / t64.clamp(min=1.0)).max())
                 for t32, t64 in zip(T32, T64)]
        print(f"float32 ({what}) vs float64, parcels alive {alive32} vs {alive64}; largest "
              f"relative T gap by step: " + ", ".join(f"{d:.3e}" for d in drift))


def cbrt_study(device):
    x = torch.logspace(-15, -8, 100001, dtype=torch.float64, device=device).float()
    exact = x.double() ** (1.0 / 3.0)
    for what, d in (("float32 power", x ** (1.0 / 3.0)), ("_cbrt", _cbrt(x))):
        err = d.double() / exact - 1.0
        print(f"cube root, {what}: diameter error mean {float(err.mean()):.3e}, largest "
              f"{float(err.abs().max()):.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs=3, default=(30, 15, 20))
    ap.add_argument("--pps", type=float, default=2000.0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="spray_sensitivity_") as tmp:
        case = write_spray_fire_case(f"{tmp}/case", n=tuple(args.n), pps=args.pps)
        nudge_study(case, device, args.steps)
        drift_study(case, device, args.steps)
    cbrt_study(device)


if __name__ == "__main__":
    main()
