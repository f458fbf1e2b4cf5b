"""Rank-side SPMD primitives: the halo exchange and psum-reduced solves.

The PyTorch port of firefoam_tpu/parallel/sharded.py. The reference hides
every halo exchange behind OpenFOAM processor patches inside `.solve()`
(solver/pEqn.H:39) and every global reduction behind gSum/reduce. Here the
equivalents are explicit, one process per partition (parallel/comm.py):

  * `halo_exchange` — the static schedule of ring steps of the
    MeshPartition plan; halo slots of each partition's extended cell array
    are refreshed in one `ppermute` per neighbour offset.
  * `SpmvLocal` — per-partition sparse matvec on the replicated-cross-face
    layout: gathers from [own ‖ halo], sums only into owned cells, so one
    halo refresh per matvec is the only communication. The face→cell sums
    go through order-fixed tables (ops/geometry.SegSum), so a solve is
    bitwise repeatable on the card.
  * `sharded_pcg` — the Jacobi-CG twin of solvers/linear.py with all
    reductions routed through `psum` (the sum/dot/mean injection points).

All functions run inside one rank; `comm` is that rank's parallel.comm.Comm.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..ops.geometry import SegSum
from .partition import MeshPartition

__all__ = [
    "halo_exchange",
    "SpmvLocal",
    "sharded_pcg",
    "make_sharded_solver",
    "psum_reducers",
    "rank_plan",
]


def halo_exchange(comm, x_loc: torch.Tensor, steps: Sequence, h_max: int) -> torch.Tensor:
    """Halo values [h_max(,k)] of this partition from x_loc [n_loc(,k)], its
    owned cells. steps: this rank's rows of the MeshPartition plan,
    (send_idx [s], send_mask [s], recv_slot [s], perm) per ring offset."""
    halo = x_loc.new_zeros((h_max + 1,) + tuple(x_loc.shape[1:]))
    for send_idx, send_mask, recv_slot, perm in steps:
        buf = x_loc.index_select(0, send_idx)
        m = send_mask if buf.ndim == 1 else send_mask.reshape((-1,) + (1,) * (buf.ndim - 1))
        buf = torch.where(m > 0, buf, torch.zeros_like(buf))
        buf = comm.ppermute(buf, perm)
        # real receive slots are distinct; pads all land in the dump slot
        halo[recv_slot] = buf
    return halo[:-1]


def rank_plan(mp: MeshPartition, p: int, device, dtype) -> Tuple:
    """Partition p's rows of the halo plan as device tensors + perms."""
    P = mp.n_parts
    return tuple(
        (
            torch.as_tensor(st.send_idx[p], dtype=torch.int64, device=device),
            torch.as_tensor(st.send_mask[p], dtype=dtype, device=device),
            torch.as_tensor(st.recv_slot[p], dtype=torch.int64, device=device),
            tuple((q, (q + st.offset) % P) for q in range(P)),
        )
        for st in mp.steps
    )


@dataclass
class SpmvLocal:
    """Per-partition matvec data (this rank's rows of the padded arrays)."""

    diag: torch.Tensor  # [n_loc] (total diagonal, padded rows = 1)
    upper: torch.Tensor  # [nF] face coeff (pad 0)
    lower: torch.Tensor  # [nF]
    face_own: torch.Tensor  # [nF] ext index of owner
    face_nei: torch.Tensor  # [nF] ext index of neighbour
    sum_own: SegSum  # faces whose owner this partition owns → that cell
    sum_nei: SegSum  # faces whose neighbour it owns → that cell
    n_loc: int

    @classmethod
    def build(cls, diag, upper, lower, face_own, face_nei, own_mine, nei_mine, n_loc):
        dev = diag.device
        fo = np.asarray(face_own.cpu(), np.int64)
        fn = np.asarray(face_nei.cpu(), np.int64)
        om = np.asarray(own_mine.cpu()) > 0
        nm = np.asarray(nei_mine.cpu()) > 0
        return cls(diag, upper, lower, face_own, face_nei,
                   SegSum(np.where(om, fo, n_loc), n_loc, dev),
                   SegSum(np.where(nm, fn, n_loc), n_loc, dev), n_loc)

    def __call__(self, x_ext: torch.Tensor) -> torch.Tensor:
        """y = A·x on owned cells; x_ext = [x_own ‖ halo] along the last axis."""
        n = self.n_loc
        y = self.diag * x_ext[..., :n]
        # row own: upper[f]·x[nei]; row nei: lower[f]·x[own] — summed only
        # into cells this partition owns (cross faces exist on both sides)
        y = y + self.sum_own.last(self.upper * x_ext.index_select(-1, self.face_nei))
        y = y + self.sum_nei.last(self.lower * x_ext.index_select(-1, self.face_own))
        return y


def psum_reducers(comm, cell_mask: torch.Tensor):
    """(sum, dot, mean) over the GLOBAL unpadded cell set, reducing the last
    axis (the solver twins' rows keep their leading batch axis)."""

    def _m(v):
        return torch.where(cell_mask > 0, v, torch.zeros_like(v))

    def gsum(v):
        return comm.psum(torch.sum(_m(v), dim=-1))

    def gdot(a, b):
        return comm.psum(torch.sum(_m(a * b), dim=-1))

    def gmean(v):
        s = comm.psum(torch.sum(_m(v), dim=-1))
        n = comm.psum(torch.sum(cell_mask))
        return s / n

    return gsum, gdot, gmean


def sharded_pcg(comm, spmv: SpmvLocal, exchange: Callable, x0, b, cell_mask,
                tol=1e-6, rel_tol=0.0, max_iter=1000):
    """Jacobi-preconditioned CG where the matvec refreshes halos through
    `exchange` and every reduction is a psum."""
    from ..solvers.linear import pcg

    gsum, gdot, gmean = psum_reducers(comm, cell_mask)

    def matvec(x):
        halo = exchange(x.movedim(-1, 0)).movedim(0, -1)
        return spmv(torch.cat([x, halo], dim=-1)) * cell_mask

    # padded rows: diag 1, b 0, x0 0 → stay 0 through the iteration
    return pcg(matvec, x0 * cell_mask, b * cell_mask, spmv.diag, tol=tol, rel_tol=rel_tol,
               max_iter=max_iter, sum_fn=gsum, dot_fn=gdot, mean_fn=gmean)


def make_sharded_solver(mp: MeshPartition, comm, tol: float = 1e-6, rel_tol: float = 0.0,
                        max_iter: int = 1000):
    """This rank's solve(diag_l, lower_l, upper_l, b_l, x0_l) → (x_l, res0,
    iters) for the partitioned arrays of MeshPartition.scatter_* (its own
    rows [n_loc_max] / [n_face_max]): the psum-CG with one ppermute halo
    refresh per matvec."""
    p = comm.rank
    dev = comm.device

    def solve(diag_l, lower_l, upper_l, b_l, x0_l):
        dt = diag_l.dtype
        plan = rank_plan(mp, p, dev, dt)
        cmask = torch.as_tensor(mp.cell_mask[p], dtype=dt, device=dev)
        fo = torch.as_tensor(mp.face_own[p], device=dev)
        fn = torch.as_tensor(mp.face_nei[p], device=dev)
        spmv = SpmvLocal.build(
            torch.where(cmask > 0, diag_l, torch.ones_like(diag_l)), upper_l, lower_l, fo, fn,
            torch.as_tensor(mp.own_mine[p]), torch.as_tensor(mp.nei_mine[p]), mp.n_loc_max)
        res = sharded_pcg(comm, spmv, lambda x: halo_exchange(comm, x, plan, mp.h_max),
                          x0_l, b_l, cmask, tol=tol, rel_tol=rel_tol, max_iter=max_iter)
        return res.x, res.initial_residual, res.n_iterations

    return solve


# ---------------------------------------------------------------------------
# rank functions for parallel.comm.launch (the tests)
# ---------------------------------------------------------------------------
def rank_halo(comm, mp: MeshPartition, x: np.ndarray) -> np.ndarray:
    """This rank's halo values of the global cell array x."""
    p = comm.rank
    xl = torch.as_tensor(mp.scatter_cells(x)[p], device=comm.device)
    plan = rank_plan(mp, p, comm.device, xl.dtype)
    return halo_exchange(comm, xl, plan, mp.h_max).cpu().numpy()


def rank_solve(comm, mp: MeshPartition, diag, lower, upper, b, tol, max_iter, dtype="float64"):
    """The psum-CG on this rank's rows of a global system; returns
    (x_l, res0, iters, comm report) as numpy."""
    p = comm.rank
    dt = getattr(torch, dtype)

    def t(a):
        return torch.as_tensor(np.asarray(a)[p], dtype=dt, device=comm.device)

    solve = make_sharded_solver(mp, comm, tol=tol, max_iter=max_iter)
    x, r0, it = solve(t(mp.scatter_cells(diag, pad=1.0)), t(mp.scatter_faces(lower)),
                      t(mp.scatter_faces(upper)), t(mp.scatter_cells(b)),
                      t(mp.scatter_cells(np.zeros(len(diag)))))
    return (x.cpu().numpy(), float(r0.reshape(-1)[0]), int(it.reshape(-1)[0]), comm.report())
