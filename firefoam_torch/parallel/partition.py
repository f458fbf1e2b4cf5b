"""Host-side mesh partitioning + halo construction (the decomposePar role).

The PyTorch port of firefoam_tpu/parallel/partition.py (NumPy only, so the
code is the JAX package's line for line). The reference decomposes each
region's mesh across MPI ranks with scotch/hierarchical decomposition
(cases/steckler/system/decomposeParDict:19-21, decompose.sh:2-4) and
exchanges processor-patch halos inside every solve (implicit in
solver/pEqn.H:39). Here: a static recursive coordinate bisection (RCB), or
z-slabs of a cuboid lattice, over the ranks of a process group, with

  * cells renumbered partition-major and padded to a common local size
    [P, n_loc_max];
  * every face incident to a partition replicated into that partition's
    local face list (cross-partition faces appear on BOTH sides, each side
    scattering only into its own cells) — this makes SpMV and all fvc/fvm
    scatters purely local once the halo is fresh;
  * a halo plan: per ordered partition pair (q → p), which of q's local
    cells to send and which halo slots of p they fill, grouped by ring
    offset d = (p − q) mod P so the exchange is a static schedule of
    point-to-point ring steps (parallel/comm.py `ppermute`).

Everything here is NumPy at setup time; the exchange and the solvers live
in parallel/sharded.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["MeshPartition", "rcb_partition", "lattice_from_graph",
           "slab_partition"]


def lattice_from_graph(
    owner: np.ndarray, neighbour: np.ndarray, n_cells: int
) -> Optional[Tuple[int, int, int]]:
    """(nx, ny, nz) if the internal-face graph IS a full cuboid lattice in
    x-fastest raveled numbering (blockMesh single-block order), else None.

    Unlike solvers.gmg.lattice_dims this works from the raw owner/neighbour
    lists (SEG layout — the layout the SPMD partitioner runs over), and it
    VERIFIES the numbering: every face must connect c -> c+off with c not on
    the +off lattice boundary, and the per-axis face counts must match the
    full cuboid exactly."""
    own = np.asarray(owner[: len(neighbour)], np.int64)
    nei = np.asarray(neighbour, np.int64)
    if len(own) == 0:
        return None
    diff = nei - own
    if (diff <= 0).any():
        return None
    offs = tuple(int(o) for o in np.unique(diff))
    from ..solvers.gmg import lattice_dims

    dims = lattice_dims(offs, n_cells)
    if dims is None:
        return None
    nx, ny, nz = dims
    counts = {1: (nx - 1) * ny * nz, nx: nx * (ny - 1) * nz,
              nx * ny: nx * ny * (nz - 1)}
    expect = {o: n for o, n in counts.items() if n > 0}
    if set(offs) != set(expect) or len(own) != sum(expect.values()):
        return None
    for o in offs:
        c = own[diff == o]
        if len(c) != expect[o]:
            return None
        if o == 1:
            bad = (c % nx) == nx - 1
        elif o == nx:
            bad = ((c // nx) % ny) == ny - 1
        else:
            bad = (c // (nx * ny)) == nz - 1
        if bad.any():
            return None
    return dims


def slab_partition(
    dims: Tuple[int, int, int], n_parts: int
) -> Optional[np.ndarray]:
    """Contiguous z-slab part_of_cell over an x-fastest lattice, or None if
    nz doesn't divide. Slab decomposition keeps each partition's owned
    cells a [nz/P, ny, nx] sub-lattice in local-slot order — the layout
    parallel.sharded_gmg's semi-coarsening hierarchy requires."""
    nx, ny, nz = dims
    if nz % n_parts:
        return None
    idx = np.arange(nx * ny * nz, dtype=np.int64)
    return (idx // (nx * ny)) // (nz // n_parts)


def rcb_partition(C: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection of cell centroids into n_parts
    (any count — splits proportionally along the widest extent).
    Returns part id per cell [nC]."""
    C = np.asarray(C, np.float64)
    part = np.zeros(C.shape[0], np.int64)

    def split(idx: np.ndarray, k: int, base: int):
        if k <= 1:
            part[idx] = base
            return
        k1 = k // 2
        frac = k1 / k
        ext = C[idx].max(axis=0) - C[idx].min(axis=0)
        ax = int(np.argmax(ext))
        # stable split: sort by coordinate (tie-break by index for
        # determinism) and cut at the proportional count
        order = idx[np.lexsort((idx, C[idx, ax]))]
        n1 = int(round(len(order) * frac))
        n1 = min(max(n1, 1), len(order) - 1)
        split(order[:n1], k1, base)
        split(order[n1:], k - k1, base + k1)

    split(np.arange(C.shape[0]), n_parts, 0)
    return part


@dataclass
class _HaloStep:
    """One ppermute step of the exchange schedule (ring offset d)."""
    offset: int
    send_idx: np.ndarray  # [P, s_max] local OWN cell index to send (pad 0)
    send_mask: np.ndarray  # [P, s_max] 1 where a real send
    recv_slot: np.ndarray  # [P, s_max] halo slot at the RECEIVER (pad = dump)


@dataclass
class MeshPartition:
    """Static partition + halo plan for an owner/neighbour face graph."""

    n_parts: int
    n_cells: int
    part_of_cell: np.ndarray  # [nC]
    l2g: np.ndarray  # [P, n_loc_max] global cell of each local slot (pad −1)
    g2l: np.ndarray  # [nC] local slot of each global cell
    n_own: np.ndarray  # [P]
    n_loc_max: int
    cell_mask: np.ndarray  # [P, n_loc_max] 1 for real cells
    # local face lists (faces incident to the partition; cross faces on both)
    n_face_max: int
    face_own: np.ndarray  # [P, nF] ext index (own array ‖ halo) of owner
    face_nei: np.ndarray  # [P, nF] ext index of neighbour
    face_gid: np.ndarray  # [P, nF] global face id (pad 0)
    face_valid: np.ndarray  # [P, nF]
    own_mine: np.ndarray  # [P, nF] owner cell belongs to this partition
    nei_mine: np.ndarray  # [P, nF]
    # halo
    h_max: int
    halo_g: np.ndarray  # [P, h_max] global cell ids of halo slots (pad −1)
    steps: List[_HaloStep] = field(default_factory=list)
    # boundary faces (owner side only — boundary owner is always local)
    nb_max: int = 0
    bface_own: Optional[np.ndarray] = None  # [P, nB] local owner index
    bface_gid: Optional[np.ndarray] = None  # [P, nB] global boundary slot
    bface_valid: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        C: np.ndarray,
        owner: np.ndarray,
        neighbour: np.ndarray,
        n_parts: int,
        b_own: Optional[np.ndarray] = None,
        part_of_cell: Optional[np.ndarray] = None,
    ) -> "MeshPartition":
        nC = C.shape[0]
        own = np.asarray(owner[: len(neighbour)], np.int64)
        nei = np.asarray(neighbour, np.int64)
        part = (
            np.asarray(part_of_cell, np.int64)
            if part_of_cell is not None
            else rcb_partition(C, n_parts)
        )
        P = n_parts

        cells_of = [np.nonzero(part == p)[0] for p in range(P)]
        n_own = np.array([len(c) for c in cells_of])
        n_loc = int(n_own.max())
        l2g = np.full((P, n_loc), -1, np.int64)
        g2l = np.zeros(nC, np.int64)
        for p, cs in enumerate(cells_of):
            l2g[p, : len(cs)] = cs
            g2l[cs] = np.arange(len(cs))
        cell_mask = (l2g >= 0).astype(np.float64)

        po, pn = part[own], part[nei]
        # halo cells per partition: remote endpoints of incident faces
        halo_sets: List[np.ndarray] = []
        for p in range(P):
            rem = np.concatenate(
                [nei[(po == p) & (pn != p)], own[(pn == p) & (po != p)]]
            )
            halo_sets.append(np.unique(rem))
        h_max = int(max((len(h) for h in halo_sets), default=0))
        halo_g = np.full((P, h_max), -1, np.int64)
        halo_slot_of: Dict[Tuple[int, int], int] = {}
        for p, h in enumerate(halo_sets):
            halo_g[p, : len(h)] = h
            for s, c in enumerate(h):
                halo_slot_of[(p, int(c))] = s

        # local face lists (cross faces duplicated on both sides)
        face_lists: List[np.ndarray] = [
            np.nonzero((po == p) | (pn == p))[0] for p in range(P)
        ]
        nF = int(max((len(f) for f in face_lists), default=1))
        face_own = np.zeros((P, nF), np.int64)
        face_nei = np.zeros((P, nF), np.int64)
        face_gid = np.zeros((P, nF), np.int64)
        face_valid = np.zeros((P, nF))
        own_mine = np.zeros((P, nF))
        nei_mine = np.zeros((P, nF))
        for p, fl in enumerate(face_lists):
            k = len(fl)
            face_gid[p, :k] = fl
            face_valid[p, :k] = 1.0
            o, n = own[fl], nei[fl]
            om = part[o] == p
            nm = part[n] == p
            own_mine[p, :k] = om
            nei_mine[p, :k] = nm
            face_own[p, :k] = np.where(
                om, g2l[o], n_loc + np.array([halo_slot_of.get((p, int(c)), 0) for c in o])
            )
            face_nei[p, :k] = np.where(
                nm, g2l[n], n_loc + np.array([halo_slot_of.get((p, int(c)), 0) for c in n])
            )

        # exchange schedule grouped by ring offset
        steps: List[_HaloStep] = []
        pair_send: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
        for p in range(P):
            h = halo_sets[p]
            if not len(h):
                continue
            src = part[h]
            for q in np.unique(src):
                sel = h[src == q]
                pair_send[(int(q), p)] = (g2l[sel], np.array(
                    [halo_slot_of[(p, int(c))] for c in sel]
                ))
        for d in range(1, P):
            pairs = {q: pair_send[(q, (q + d) % P)] for q in range(P)
                     if (q, (q + d) % P) in pair_send}
            if not pairs:
                continue
            s_max = max(len(v[0]) for v in pairs.values())
            send_idx = np.zeros((P, s_max), np.int64)
            send_mask = np.zeros((P, s_max))
            recv_slot = np.full((P, s_max), h_max, np.int64)  # pad → dump slot
            for q, (sidx, rslot) in pairs.items():
                k = len(sidx)
                send_idx[q, :k] = sidx
                send_mask[q, :k] = 1.0
                recv_slot[(q + d) % P, :k] = rslot
            steps.append(_HaloStep(d, send_idx, send_mask, recv_slot))

        # boundary faces (owner always local to its partition)
        nb_max = 0
        bface_own = bface_gid = bface_valid = None
        if b_own is not None and len(b_own):
            b_own = np.asarray(b_own, np.int64)
            pb = part[b_own]
            lists = [np.nonzero(pb == p)[0] for p in range(P)]
            nb_max = int(max((len(l) for l in lists), default=1))
            bface_own = np.zeros((P, nb_max), np.int64)
            bface_gid = np.zeros((P, nb_max), np.int64)
            bface_valid = np.zeros((P, nb_max))
            for p, l in enumerate(lists):
                k = len(l)
                bface_gid[p, :k] = l
                bface_own[p, :k] = g2l[b_own[l]]
                bface_valid[p, :k] = 1.0

        return cls(
            n_parts=P,
            n_cells=nC,
            part_of_cell=part,
            l2g=l2g,
            g2l=g2l,
            n_own=n_own,
            n_loc_max=n_loc,
            cell_mask=cell_mask,
            n_face_max=nF,
            face_own=face_own,
            face_nei=face_nei,
            face_gid=face_gid,
            face_valid=face_valid,
            own_mine=own_mine,
            nei_mine=nei_mine,
            h_max=h_max,
            halo_g=halo_g,
            steps=steps,
            nb_max=nb_max,
            bface_own=bface_own,
            bface_gid=bface_gid,
            bface_valid=bface_valid,
        )

    # ------------------------------------------------------------------
    def halo_owner_part(self) -> np.ndarray:
        """[P, h_max] owning part of each halo slot (−1 for pad)."""
        g = np.maximum(self.halo_g, 0)
        return np.where(self.halo_g >= 0, self.part_of_cell[g], -1)

    def halo_remote_local(self) -> np.ndarray:
        """[P, h_max] owner-local cell index of each halo slot."""
        g = np.maximum(self.halo_g, 0)
        return np.where(self.halo_g >= 0, self.g2l[g], 0)

    # ------------------------------------------------------------------
    def scatter_cells(self, x: np.ndarray, pad=0.0) -> np.ndarray:
        """Global cell array [nC(,k)] → partitioned [P, n_loc_max(,k)]."""
        out = np.full((self.n_parts, self.n_loc_max) + x.shape[1:], pad, x.dtype)
        ok = self.l2g >= 0
        out[ok] = x[self.l2g[ok]]
        return out

    def gather_cells(self, xl: np.ndarray) -> np.ndarray:
        """Partitioned [P, n_loc_max(,k)] → global [nC(,k)]."""
        out = np.zeros((self.n_cells,) + xl.shape[2:], xl.dtype)
        ok = self.l2g >= 0
        out[self.l2g[ok]] = xl[ok]
        return out

    def scatter_faces(self, f: np.ndarray, pad=0.0) -> np.ndarray:
        """Global internal-face array [nI(,k)] → [P, n_face_max(,k)]."""
        out = np.full((self.n_parts, self.n_face_max) + f.shape[1:], pad, f.dtype)
        v = self.face_valid > 0
        out[v] = f[self.face_gid[v]]
        return out

    def scatter_bfaces(self, f: np.ndarray, pad=0.0) -> np.ndarray:
        out = np.full((self.n_parts, self.nb_max) + f.shape[1:], pad, f.dtype)
        v = self.bface_valid > 0
        out[v] = f[self.bface_gid[v]]
        return out
