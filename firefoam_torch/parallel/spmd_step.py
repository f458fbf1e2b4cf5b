"""The explicitly partitioned fire step over `torch.distributed`.

The PyTorch port of firefoam_tpu/parallel/spmd_step.py. It runs the
COMPLETE FireFoamSolver.step through the partition path: RCB or z-slab
partitions with replicated cross faces, a ppermute halo refresh inside
every matvec and face→cell sum, psum/pmax for every reduction — the
reference's processor-patch/MPI execution (decomposePar + mpirun).

Mechanics: the caller's process builds the case once on the host — the
global SEG geometry, the Localizer and (optionally) the global reference
solver with the same numerics (SEG, flat Krylov, no AMG; its initial state
is the one scattered) — and hands them to the ranks (parallel/comm.launch)
with each rank's scattered state. Each rank builds ONE
FireFoamSolver(local=ctx) over its partition and steps it; there is no
global solver in any rank. The JAX package traces one instance per
partition and refuses instances whose programs differ; the eager
counterpart here is Comm.verify_lockstep after every step: every rank must
have made the same collectives in the same order.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import default_device
from ..mesh import build_case_mesh
from ..models.firefoam import FireFoamSolver, state_from_numpy, state_to_numpy
from ..ops.geometry import MeshGeometry
from ..solvers import dia_krylov
from . import comm as comm_mod
from .localize import LocalContext, Localizer

__all__ = ["SpmdFireFoam", "run_many"]


def _is_field(x) -> bool:
    return isinstance(x, tuple) and getattr(x, "_fields", None) == ("i", "b")


def _tree_map(fn, x):
    if _is_field(x):
        return type(x)(fn(x.i), fn(x.b))
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree_map(fn, v) for v in x]
    return fn(x)


def _walk_to(walk, device, dtype):
    """The global WalkMesh with its tensors on `device` (the injectors'
    tables live where the rank's parcels do)."""
    from ..lagrangian.tracking import WalkMesh

    def mv(t):
        return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)

    return WalkMesh(max_faces=walk.max_faces, cf_Cf=mv(walk.cf_Cf), cf_n=mv(walk.cf_n),
                    cf_nei=mv(walk.cf_nei), cf_bidx=mv(walk.cf_bidx), tol=mv(walk.tol),
                    C=mv(walk.C), _h_cf_Cf=walk._h_cf_Cf, _h_cf_n=walk._h_cf_n,
                    _h_cf_nei=walk._h_cf_nei, _h_tol=walk._h_tol, _h_C=walk._h_C)


class SpmdFireFoam:
    """Explicitly partitioned fireFoam: one case, n_parts ranks."""

    def __init__(self, case_dir: str, n_parts: int, dtype=torch.float64, device=None,
                 backend: str = "gloo", partition: str = "auto", gmg: Optional[bool] = None,
                 build_ref: bool = True, cap_send: int = 512):
        """device: the ranks' device (default: the card; raises where there
        is none); backend: "gloo" or "nccl" (the
        caller's choice — parallel/comm.py). build_ref: build the global
        reference solver on `device` (SEG, no exact solvers, no GMG, no AMG:
        the same numerics), whose initial_state is the usual state to
        scatter. gmg: the partitioned solver's rule for the sharded lattice
        multigrid (None: from 50000 cells on a slab partition). cap_send:
        the parcels a migration round sends from one rank to another (the
        rest wait for a later round; the logs' cloud_migrOverflow counts
        them)."""
        self.case_dir = case_dir
        self.n_parts = int(n_parts)
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else default_device()
        self.backend = backend
        self.gmg = gmg
        self.cap_send = int(cap_send)
        comm_mod.check_backend(backend, self.device, self.n_parts)
        self.ref = None
        if build_ref:
            self.ref = FireFoamSolver(case_dir, device=self.device, dtype=dtype, layout="seg",
                                      exact_solvers=False, gmg=False, amg=False)
            self.cm = self.ref.cm
        else:
            self.cm = build_case_mesh(case_dir)
        self.gg = MeshGeometry.from_polymesh(self.cm.mesh, dtype=dtype, device="cpu",
                                             layout="seg")
        self.lz = Localizer.build(self.gg, self.cm, self.n_parts, method=partition)
        self.walk_g = None
        has_cloud = (self.ref.cloud is not None) if self.ref is not None else False
        if has_cloud:
            from ..lagrangian.tracking import WalkMesh

            self.walk_g = WalkMesh.from_polymesh(self.cm.mesh, dtype=dtype, device="cpu")
        self._n_c = self.gg.n_cells
        self._n_b = self.gg.n_boundary
        self._n_i = self.gg.n_internal
        assert len({self._n_c, self._n_b, self._n_i}) == 3, (
            "ambiguous state-array classification (nC/nB/nI collide)")

    @property
    def partition(self) -> str:
        return "slab" if self.lz.slab_dims is not None else "rcb"

    # -------------------------------------------------- state scattering
    def _conv(self, x: np.ndarray) -> np.ndarray:
        lz = self.lz
        if x.ndim == 0:
            return np.broadcast_to(x, (self.n_parts,)).copy()
        if x.shape[0] == self._n_c:
            return lz.cells(x)
        if x.shape[0] == self._n_b:
            return lz.bfaces(x)
        if x.shape[0] == self._n_i:
            return lz.ifaces(x)
        if x.ndim >= 2 and x.shape[-1] == self._n_c:
            # e.g. fvDOM I [nRay, nLambda, nCells]: cells on the LAST axis
            lead = x.shape[:-1]
            flat = x.reshape(-1, self._n_c).T  # [nC, prod(lead)]
            sc = lz.cells(flat)  # [P, n_ext, prod(lead)]
            return np.moveaxis(sc, 1, -1).reshape((sc.shape[0],) + lead + (sc.shape[1],))
        # replicated (tables, vectors of another length)
        return np.broadcast_to(x[None], (self.n_parts,) + x.shape).copy()

    def _scatter_cloud(self, cst: Dict) -> Dict:
        """Cloud SoA: every per-parcel array replicates (all partitions
        share the injection key), but `alive` is masked to the owning
        partition and `cell` remapped to the owner-local id."""
        mp = self.lz.mp
        cell_g = np.asarray(cst["cell"])
        alive_g = np.asarray(cst["alive"])
        cc = np.clip(cell_g, 0, mp.n_cells - 1)
        part, loc = mp.part_of_cell[cc], mp.g2l[cc]
        P = self.n_parts
        cells = np.zeros((P,) + cell_g.shape, cell_g.dtype)
        alive = np.zeros((P,) + alive_g.shape, bool)
        for p in range(P):
            mine = alive_g & (part == p)
            cells[p] = np.where(mine, loc, 0)
            alive[p] = mine
        out = {}
        for k, v in cst.items():
            if k == "cell":
                out[k] = cells
            elif k == "alive":
                out[k] = alive
            else:
                out[k] = _tree_map(lambda a: np.broadcast_to(
                    np.asarray(a)[None], (P,) + np.shape(a)).copy(), v)
        return out

    def gather_cloud(self, cst_l: Dict) -> Dict:
        """Stacked local cloud → one global SoA (partition-major order)."""
        mp = self.lz.mp
        alive = np.asarray(cst_l["alive"])  # [P, cap]
        cap = alive.shape[1]
        keys = [k for k, v in cst_l.items()
                if isinstance(v, np.ndarray) and v.ndim >= 2 and v.shape[1] == cap
                and k != "alive"]
        out = {k: np.zeros((cap,) + cst_l[k].shape[2:], cst_l[k].dtype) for k in keys}
        out["alive"] = np.zeros(cap, bool)
        n = 0
        for p in range(alive.shape[0]):
            take = np.nonzero(alive[p])[0][: cap - n]
            sl = slice(n, n + len(take))
            for k in keys:
                v = cst_l[k][p][take]
                if k == "cell":
                    v = mp.l2g[p][np.clip(v, 0, mp.n_loc_max - 1)]
                out[k][sl] = v
            out["alive"][sl] = True
            n += len(take)
        return out

    def scatter_state(self, state: Dict) -> List[Dict]:
        """Global state → one numpy state per rank."""
        st = state_to_numpy(state)
        cloud = st.pop("cloud", None)
        stacked = _tree_map(lambda a: self._conv(np.asarray(a)), st)
        if cloud is not None:
            c = dict(cloud)
            aux = {k: c.pop(k) for k in ("rng", "inj", "coll", "cfo", "pc") if k in c}
            sc = self._scatter_cloud(c)
            sc.update(_tree_map(lambda a: np.broadcast_to(
                np.asarray(a)[None], (self.n_parts,) + np.shape(a)).copy(), aux))
            stacked["cloud"] = sc
        return [_tree_map(lambda a: a[p], stacked) for p in range(self.n_parts)]

    def gather_state(self, states_l: List[Dict]) -> Dict:
        """Per-rank numpy states → the global state (owned cells only)."""
        lz = self.lz
        stacked = _stack(states_l)
        cloud_l = stacked.pop("cloud", None)

        def f(x):
            x = np.asarray(x)
            if x.ndim == 1:  # replicated scalar [P]
                return x[0]
            if x.shape[1] == lz.n_ext:
                return lz.gather_cells(x)
            if x.shape[1] == lz.bmap.shape[1]:
                return lz.gather_bfaces(x, self._n_b)
            if x.shape[1] == lz.mp.n_face_max:
                return lz.gather_ifaces(x, self._n_i)
            if x.ndim >= 3 and x.shape[-1] == lz.n_ext:
                lead = x.shape[1:-1]
                flat = np.moveaxis(x, -1, 1).reshape(x.shape[0], lz.n_ext, -1)
                g = lz.gather_cells(flat)  # [nC, prod(lead)]
                return g.T.reshape(lead + (self._n_c,))
            return x[0]

        out = _tree_map(f, stacked)
        if cloud_l is not None:
            out["cloud"] = self.gather_cloud(cloud_l)
        return out

    # ------------------------------------------------------------- run
    def run(self, state, n_steps: int, deadline_s: float = 300.0, every_step: bool = False,
            profile: bool = False, repeat: bool = False) -> Dict:
        """Run n_steps of the partitioned step from the GLOBAL `state` on
        the ranks. Returns {"state": the gathered final state (numpy),
        "states": the gathered state after every step (every_step),
        "logs": rank 0's log per step (floats), "comm": each rank's
        collective report per step, "seconds": rank 0's wall seconds per
        step (the last one profiled with `profile`), "busy_ms": rank 0's
        device-busy ms of the last step (profile, CUDA), "rank_logs": every
        rank's logs, "repeat_equal": with `repeat`, whether a second run of
        the same steps from the same state gave every rank the same state
        and logs bit for bit, "kernel_launches": the hand-written kernels'
        launches summed over the ranks}."""
        opts = dict(every_step=every_step, profile=profile, repeat=repeat)
        return run_many([(self, state, n_steps, opts)], deadline_s)[0]

    def _payload(self, tmp: str, tag: str, state, n_steps: int, every_step: bool = False,
                 profile: bool = False, repeat: bool = False) -> Dict:
        """One run's payload for rank_steps; each rank's state is written
        to `tmp` (each rank reads only its own)."""
        paths = []
        for p, st in enumerate(self.scatter_state(state)):
            paths.append(os.path.join(tmp, f"state{tag}_{p}.pkl"))
            with open(paths[-1], "wb") as f:
                pickle.dump(st, f, protocol=pickle.HIGHEST_PROTOCOL)
        return {
            "case_dir": self.case_dir, "cm": self.cm, "gg": self.gg, "lz": self.lz,
            "walk_g": self.walk_g, "dtype": str(self.dtype).replace("torch.", ""),
            "gmg": self.gmg, "cap_send": self.cap_send, "n_steps": int(n_steps),
            "every_step": every_step, "profile": profile, "repeat": repeat,
            "states": paths,
        }

    def _result(self, res: List, n_steps: int, every_step: bool = False,
                profile: bool = False, repeat: bool = False) -> Dict:
        """run's result from every rank's rank_steps report."""
        out = {
            "state": self.gather_state([r["state"] for r in res]),
            "logs": res[0]["logs"],
            "rank_logs": [r["logs"] for r in res],
            "comm": [r["comm"] for r in res],
            "seconds": res[0]["seconds"],
            "busy_ms": res[0]["busy_ms"],
            "setup_seconds": res[0]["setup_seconds"],
            "p_solver": res[0]["p_solver"],
            "alive_per_rank": [r["alive"] for r in res],
            "repeat_equal": all(r["repeat_equal"] for r in res) if repeat else None,
            "kernel_launches": {k: sum(r["kernel_launches"][k] for r in res)
                                for k in res[0]["kernel_launches"]},
        }
        if every_step:
            out["states"] = [self.gather_state([r["states"][k] for r in res])
                             for k in range(n_steps)]
        return out


def run_many(jobs: List, deadline_s: float = 300.0) -> List[Dict]:
    """Several partitioned runs in ONE launch of the ranks, one after the
    other in the same rank processes (which start once): jobs are
    (SpmdFireFoam, global state, n_steps, {every_step, profile, repeat}),
    every one with the same number of parts, backend and device. Returns
    each job's result as SpmdFireFoam.run gives it; deadline_s covers the
    whole launch."""
    first = jobs[0][0]
    key = lambda sp: (sp.n_parts, sp.backend, str(sp.device))
    if any(key(sp) != key(first) for sp, _, _, _ in jobs):
        raise ValueError("run_many: every job must have the same parts, backend and device")
    with tempfile.TemporaryDirectory(prefix="ff_states_") as tmp:
        calls = [(rank_steps, (sp._payload(tmp, str(j), state, n, **opts),))
                 for j, (sp, state, n, opts) in enumerate(jobs)]
        res = comm_mod.launch(comm_mod.rank_calls, first.n_parts, first.backend, first.device,
                              deadline_s, (calls,))
    return [sp._result([r[j] for r in res], n, **opts)
            for j, (sp, _, n, opts) in enumerate(jobs)]


def _stack(trees: List):
    t0 = trees[0]
    if _is_field(t0):
        return type(t0)(_stack([t.i for t in trees]), _stack([t.b for t in trees]))
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    if isinstance(t0, list):
        return [_stack([t[i] for t in trees]) for i in range(len(t0))]
    return np.stack([np.asarray(t) for t in trees])


def _log_value(v):
    v = v.detach().cpu() if isinstance(v, torch.Tensor) else v
    return float(v) if np.ndim(v) == 0 else np.asarray(v).tolist()


def rank_steps(comm, payload: Dict) -> Dict:
    """One rank of SpmdFireFoam.run: build the partition's solver, step it
    n_steps times from this rank's scattered state, report."""
    p = comm.rank
    dev = comm.device
    dtype = getattr(torch, payload["dtype"])
    t0 = time.perf_counter()
    lz: Localizer = payload["lz"]
    walk_g = payload["walk_g"]
    ctx = LocalContext(geom=lz.make_geom(payload["gg"], p, comm=comm, device=dev), lz=lz, p=p,
                       cm=payload["cm"], global_geom=payload["gg"],
                       walk_g=_walk_to(walk_g, dev, dtype) if walk_g is not None else None,
                       comm=comm, cap_send=payload["cap_send"])
    solver = FireFoamSolver(payload["case_dir"], local=ctx, gmg=payload["gmg"])
    with open(payload["states"][p], "rb") as f:
        st_np = pickle.load(f)
    st = state_from_numpy(st_np, device=dev, dtype=dtype)
    setup = time.perf_counter() - t0
    comm.verify_lockstep()
    dia_krylov.reset_counts()
    logs, reports, secs, busy, states = [], [], [], [], []
    n = payload["n_steps"]
    for k in range(n):
        comm.reset_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        if payload["profile"] and dev.type == "cuda" and k == n - 1:
            from ..profile_step import _busy_us

            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                st, log = solver.step(st)
                torch.cuda.synchronize(dev)
            busy.append(_busy_us(prof) / 1e3)
        else:
            st, log = solver.step(st)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t1)
        reports.append(comm.report())
        logs.append({k: _log_value(v) for k, v in log.items()})
        comm.verify_lockstep()
        if payload["every_step"]:
            states.append(state_to_numpy(st))
    launches = dict(dia_krylov.LAUNCHES)
    alive = int(st["cloud"]["alive"].sum()) if "cloud" in st else 0
    final = state_to_numpy(st)
    same = None
    if payload["repeat"]:
        st2 = state_from_numpy(st_np, device=dev, dtype=dtype)
        logs2 = []
        for _ in range(n):
            st2, log2 = solver.step(st2)
            logs2.append({k: _log_value(v) for k, v in log2.items()})
        comm.verify_lockstep()
        same = _tree_equal(final, state_to_numpy(st2)) and logs2 == logs
    return {"state": final, "states": states, "logs": logs, "comm": reports,
            "seconds": secs, "busy_ms": busy, "setup_seconds": setup, "alive": alive,
            "p_solver": "sharded_gmg" if solver._sgmg is not None else "flat",
            "repeat_equal": same, "kernel_launches": launches}


def _tree_equal(a, b) -> bool:
    if _is_field(a) or isinstance(a, list):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    # pad boundary slots may hold NaN (sentinel geometry); NaN equals NaN here
    return np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")
