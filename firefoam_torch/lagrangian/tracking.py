"""Parcel tracking on the unstructured FV mesh: the containment walk.

The port of firefoam_tpu/lagrangian/tracking.py. The reference tracks
parcels face to face with exact intersections inside a per-parcel loop
(KinematicParcel::move, KinematicParcel.C:253-376). Here parcels live in a
fixed-capacity SoA; each substep all parcels move ballistically
(x += U·dt) and are then re-localised by a bounded containment walk: find
the most violated face plane of the current cell, hop to that neighbour
(or apply the wall interaction on a boundary face), repeat W times. Every
parcel does the same gathers and reductions over the maxFaces face slots of
its cell; dead lanes are masked. The W hops are a Python loop of tensor ops
with no host read.

Wall interaction codes follow StandardWallInteraction (stick/escape/
rebound) plus the film-absorb code of the surface-film handoff.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..config import INT_DTYPE
from ..mesh.polymesh import PolyMesh

__all__ = ["WalkMesh", "INTERACT_NONE", "INTERACT_ESCAPE", "INTERACT_STICK",
           "INTERACT_REBOUND", "INTERACT_FILM"]

INTERACT_NONE = 0
INTERACT_ESCAPE = 1
INTERACT_STICK = 2
INTERACT_REBOUND = 3
INTERACT_FILM = 4


@dataclass
class WalkMesh:
    """Per-(cell, face-slot) geometry for the containment walk.

    Pad slots have zero normals and Cf = cell centre, so their plane
    violation is exactly 0: harmless under a positive tolerance."""

    max_faces: int
    cf_Cf: torch.Tensor  # [nC, F, 3] face centres
    cf_n: torch.Tensor  # [nC, F, 3] outward unit normals (0 for pads)
    cf_nei: torch.Tensor  # [nC, F] neighbour cell, -1 if boundary face / pad
    cf_bidx: torch.Tensor  # [nC, F] boundary-local face index, -1 otherwise
    tol: torch.Tensor  # [nC] containment tolerance (relative to cell size)
    C: torch.Tensor  # [nC, 3] cell centres
    # host copies for one-off point location
    _h_cf_Cf: np.ndarray = None
    _h_cf_n: np.ndarray = None
    _h_cf_nei: np.ndarray = None
    _h_tol: np.ndarray = None
    _h_C: np.ndarray = None

    # ---------------------------------------------------------------- build
    @classmethod
    def from_polymesh(cls, mesh: PolyMesh, dtype=torch.float64, device="cpu") -> "WalkMesh":
        nC = mesh.n_cells
        n_int = mesh.n_internal_faces
        nF = mesh.n_faces
        own = mesh.owner
        nei = mesh.neighbour

        # per-cell face lists
        counts = np.zeros(nC, dtype=np.int64)
        np.add.at(counts, own, 1)
        np.add.at(counts, nei, 1)
        max_faces = int(counts.max())

        cell_of = np.concatenate([own, nei])
        face_of = np.concatenate([np.arange(nF), np.arange(n_int)])
        sign = np.concatenate([np.ones(nF), -np.ones(n_int)])  # owner: outward
        order = np.argsort(cell_of, kind="stable")
        cell_sorted = cell_of[order]
        # slot index within each cell group
        starts = np.zeros(nC, dtype=np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        slot = np.arange(len(cell_sorted)) - starts[cell_sorted]

        Cf = mesh.Cf
        Sf = mesh.Sf
        magSf = np.maximum(mesh.magSf, 1e-300)
        nrm = Sf / magSf[:, None]

        cf_Cf = np.repeat(mesh.C[:, None, :], max_faces, axis=1).astype(np.float64)
        cf_n = np.zeros((nC, max_faces, 3))
        cf_nei = -np.ones((nC, max_faces), dtype=np.int64)
        cf_bidx = -np.ones((nC, max_faces), dtype=np.int64)

        f = face_of[order]
        s = sign[order]
        cf_Cf[cell_sorted, slot] = Cf[f]
        cf_n[cell_sorted, slot] = nrm[f] * s[:, None]
        # neighbour across that face (for internal faces)
        other = -np.ones(len(f), dtype=np.int64)
        from_owner = (s > 0) & (f < n_int)
        other[from_owner] = nei[f[from_owner]]
        other[s < 0] = own[f[s < 0]]
        cf_nei[cell_sorted, slot] = other
        is_b = (f >= n_int) & (s > 0)
        cf_bidx[cell_sorted, slot] = np.where(is_b, f - n_int, -1)

        tol = 1e-8 * np.cbrt(mesh.V)

        r = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)
        i = lambda a: torch.as_tensor(a, dtype=INT_DTYPE, device=device)
        return cls(
            max_faces=max_faces,
            cf_Cf=r(cf_Cf),
            cf_n=r(cf_n),
            cf_nei=i(cf_nei),
            cf_bidx=i(cf_bidx),
            tol=r(tol),
            C=r(mesh.C),
            _h_cf_Cf=cf_Cf,
            _h_cf_n=cf_n,
            _h_cf_nei=cf_nei,
            _h_tol=tol,
            _h_C=mesh.C,
        )

    # -------------------------------------------------------- host location
    def find_cell_host(self, p: np.ndarray, max_steps: int = 256) -> int:
        """One-off point location (injector positions): nearest-centre seed
        + host walk. Returns -1 if the point is outside the mesh."""
        p = np.asarray(p, dtype=np.float64)
        c = int(np.argmin(np.sum((self._h_C - p) ** 2, axis=1)))
        for _ in range(max_steps):
            viol = np.einsum("fd,fd->f", p - self._h_cf_Cf[c], self._h_cf_n[c])
            j = int(np.argmax(viol))
            if viol[j] <= self._h_tol[c]:
                return c
            nxt = int(self._h_cf_nei[c, j])
            if nxt < 0:
                return -1
            c = nxt
        return -1

    # ------------------------------------------------------- device walk
    def walk(
        self,
        x: torch.Tensor,  # [N,3]
        U: torch.Tensor,  # [N,3]
        cell: torch.Tensor,  # [N] int
        alive: torch.Tensor,  # [N] bool
        b_code: torch.Tensor,  # [nB] int interaction code per boundary face
        b_e: torch.Tensor,  # [nB] rebound elasticity
        n_steps: int = 6,
    ) -> Tuple[torch.Tensor, ...]:
        """Relocalise parcels after a ballistic move.

        Returns (x, U, cell, alive, hit_bidx, hit_code): hit_bidx is the
        boundary-local face of the first boundary interaction of this walk
        (−1 if none), hit_code its interaction code."""
        hit = torch.full(cell.shape, -1, dtype=INT_DTYPE, device=cell.device)
        hit_code = torch.zeros(cell.shape, dtype=INT_DTYPE, device=cell.device)
        cell = cell.to(INT_DTYPE)
        b_code = b_code.to(INT_DTYPE)
        for _ in range(n_steps):
            Cf = self.cf_Cf[cell]  # [N,F,3]
            n = self.cf_n[cell]  # [N,F,3]
            viol = torch.sum((x[:, None, :] - Cf) * n, dim=2)
            j = torch.argmax(viol, dim=1)[:, None]
            mv = torch.gather(viol, 1, j)[:, 0]
            outside = (mv > self.tol[cell]) & alive

            nei = torch.gather(self.cf_nei[cell], 1, j)[:, 0]
            bidx = torch.gather(self.cf_bidx[cell], 1, j)[:, 0]
            nj = torch.gather(n, 1, j[:, :, None].expand(-1, 1, 3))[:, 0, :]

            is_int = outside & (nei >= 0)
            is_b = outside & (nei < 0) & (bidx >= 0)

            bsafe = torch.clamp(bidx, min=0)
            code = torch.where(is_b, b_code[bsafe], 0)
            # codes are 1-4 on boundary faces and 0 elsewhere, so the
            # comparisons need no is_b; film hits reflect geometrically (the
            # splash model decides absorb/bounce/splash from the record)
            esc = code == INTERACT_ESCAPE
            stick = code == INTERACT_STICK
            reb = is_b & ~esc & ~stick  # rebound, none or film

            cell = torch.where(is_int, nei, cell)
            alive = alive & ~esc
            # record the first boundary interaction of this walk
            first = is_b & (hit < 0)
            hit = torch.where(first, bidx, hit)
            hit_code = torch.where(first, code, hit_code)

            # stick: clamp onto the wall, kill velocity
            push = (mv + 10.0 * self.tol[cell])[:, None] * nj
            x = torch.where(stick[:, None], x - push, x)
            U = torch.where(stick[:, None], 0.0, U)
            # rebound: mirror position and reflect velocity (elastic e; only
            # the rebounding lanes read it)
            e = b_e[bsafe]
            x = torch.where(reb[:, None], x - (2.0 * mv)[:, None] * nj, x)
            Un = torch.sum(U * nj, dim=1)
            U = torch.where(
                reb[:, None], U - ((1.0 + e) * torch.clamp(Un, min=0.0))[:, None] * nj, U
            )
        return x, U, cell, alive, hit, hit_code


# ---------------------------------------------------------------------------
class CellSum:
    """Σ of per-parcel values into n segments (cells, boundary faces,
    collector bins) in a fixed order: a stable sort of the segment ids, then
    a segmented reduction over the sorted runs. No atomics, so a run on the
    card is bitwise reproducible (an index_add_ there is not); parcels of
    one segment keep their slot order, the order of the JAX package's
    segment_sum on the CPU. Parcels outside `keep` (dead lanes, parcels that
    hit nothing) go to a segment past the last one and are left out: their
    values are zeros in the JAX package's sums, and left in they would pile
    into one segment whose serial reduction stalls the card. Build once per
    id array, call for each value array [N] or [N, k]."""

    def __init__(self, idx: torch.Tensor, n: int, keep: torch.Tensor = None):
        idx = idx.to(INT_DTYPE)
        if keep is not None:
            idx = torch.where(keep, idx, n)
        self.order = torch.sort(idx, stable=True).indices
        bounds = torch.arange(n + 1, dtype=INT_DTYPE, device=idx.device)
        self.offsets = torch.searchsorted(idx[self.order], bounds)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(v[self.order], "sum", offsets=self.offsets, axis=0,
                                    unsafe=True)


def cell_sum(v: torch.Tensor, idx: torch.Tensor, n: int, keep: torch.Tensor = None
             ) -> torch.Tensor:
    """One order-fixed segment sum (CellSum)."""
    return CellSum(idx, n, keep)(v)
