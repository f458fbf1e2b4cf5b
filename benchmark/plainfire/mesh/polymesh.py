"""Unstructured finite-volume mesh core (host-side, numpy).

The TPU framework's mesh representation: flat struct-of-arrays connectivity
(points, flat face-vertex list + offsets, owner, neighbour, patch slices) with
geometry computed by the same algorithms OpenFOAM uses, so cell centres,
volumes and face areas match the reference bit-for-bit on the bundled cases.

Behavioural reference: OpenFOAM primitiveMesh face/cell geometry
(primitiveMeshFaceCentresAndAreas / primitiveMeshCellCentresAndVols), and the
surfaceInterpolation weights/deltaCoeffs used by every fvm/fvc operator in
the reference solver/*.H.

Device code never sees this class: `firefoam_torch.ops.geometry.MeshGeometry`
extracts fixed-shape index/weight arrays for the jit-compiled step.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import small

__all__ = ["Patch", "PolyMesh"]


@dataclass
class Patch:
    name: str
    ptype: str  # patch / wall / empty / processor / mappedWall ...
    start: int
    n_faces: int
    extra: dict = field(default_factory=dict)

    @property
    def slice(self) -> slice:
        return slice(self.start, self.start + self.n_faces)


@dataclass
class PolyMesh:
    """points[nP,3]; faces as flat vertex list + offsets; owner/neighbour."""

    points: np.ndarray  # [nPoints, 3] float64
    face_verts: np.ndarray  # flat int32 vertex indices
    face_offsets: np.ndarray  # [nFaces+1] int64, face f = face_verts[o[f]:o[f+1]]
    owner: np.ndarray  # [nFaces] int32
    neighbour: np.ndarray  # [nInternalFaces] int32
    patches: List[Patch]
    n_cells: int

    # geometry caches (computed lazily)
    _geom: Optional[dict] = None

    # ------------------------------------------------------------------ sizes
    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_faces(self) -> int:
        return self.face_offsets.shape[0] - 1

    @property
    def n_internal_faces(self) -> int:
        return self.neighbour.shape[0]

    @property
    def n_boundary_faces(self) -> int:
        return self.n_faces - self.n_internal_faces

    def patch(self, name: str) -> Patch:
        for p in self.patches:
            if p.name == name:
                return p
        raise KeyError(f"patch '{name}' not found (have {[p.name for p in self.patches]})")

    def face(self, f: int) -> np.ndarray:
        return self.face_verts[self.face_offsets[f] : self.face_offsets[f + 1]]

    def faces_list(self) -> List[np.ndarray]:
        return [self.face(f) for f in range(self.n_faces)]

    # ------------------------------------------------------------- geometry
    def _compute_geometry(self) -> dict:
        pts = self.points
        fo = self.face_offsets
        fv = self.face_verts
        n_faces = self.n_faces

        # --- face centres and area vectors (OpenFOAM fan decomposition) ---
        counts = np.diff(fo)
        # approximate centre: mean of face points
        sums = np.add.reduceat(pts[fv], fo[:-1], axis=0)
        c_est = sums / counts[:, None]

        f_ctr = np.zeros((n_faces, 3))
        f_area = np.zeros((n_faces, 3))

        # vectorized fan: for every (face, corner) pair
        face_of = np.repeat(np.arange(n_faces), counts)
        # next corner index within each face (circular)
        idx_in_face = np.arange(fv.shape[0]) - np.repeat(fo[:-1], counts)
        next_in_face = (idx_in_face + 1) % np.repeat(counts, counts)
        nxt_pos = np.repeat(fo[:-1], counts) + next_in_face
        p = pts[fv]
        p_next = pts[fv[nxt_pos]]
        fc_rep = c_est[face_of]

        c_tri = p + p_next + fc_rep  # 3 * triangle centroid
        e1 = p_next - p
        e2 = fc_rep - p
        n_tri = np.empty_like(e1)
        n_tri[:, 0] = e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1]
        n_tri[:, 1] = e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]
        n_tri[:, 2] = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
        a_tri = np.sqrt(np.einsum("ij,ij->i", n_tri, n_tri))

        # per-face sums over contiguous corner ranges
        sum_n = np.add.reduceat(n_tri, fo[:-1], axis=0)
        sum_a = np.add.reduceat(a_tri, fo[:-1])
        sum_ac = np.add.reduceat(a_tri[:, None] * c_tri, fo[:-1], axis=0)

        ok = sum_a > small(torch.float64)
        f_ctr = np.where(ok[:, None], sum_ac / np.maximum(sum_a, small(torch.float64))[:, None] / 3.0, c_est)
        f_area = 0.5 * sum_n

        # triangles: exact (OpenFOAM special-cases these)
        tri = counts == 3
        if np.any(tri):
            tf = np.where(tri)[0]
            v0 = pts[fv[fo[tf]]]
            v1 = pts[fv[fo[tf] + 1]]
            v2 = pts[fv[fo[tf] + 2]]
            f_ctr[tf] = (v0 + v1 + v2) / 3.0
            f_area[tf] = 0.5 * np.cross(v1 - v0, v2 - v0)

        mag_sf = np.linalg.norm(f_area, axis=1)

        # --- cell centres and volumes (pyramid decomposition) ---
        n_cells = self.n_cells
        own = self.owner
        nei = self.neighbour
        n_int = self.n_internal_faces

        def cell_sum(vals_own, vals_nei):
            """Scatter-sum owner (all faces) + neighbour (internal) into cells."""
            if vals_own.ndim == 1:
                out = np.bincount(own, weights=vals_own, minlength=n_cells)
                out += np.bincount(nei, weights=vals_nei, minlength=n_cells)
                return out
            out = np.empty((n_cells, vals_own.shape[1]))
            for c in range(vals_own.shape[1]):
                out[:, c] = np.bincount(own, weights=vals_own[:, c], minlength=n_cells)
                out[:, c] += np.bincount(nei, weights=vals_nei[:, c], minlength=n_cells)
            return out

        n_cell_faces = cell_sum(np.ones(n_faces), np.ones(n_int))
        c_est_cell = cell_sum(f_ctr, f_ctr[:n_int]) / n_cell_faces[:, None]

        # owner-side pyramids (outward normal w.r.t. owner)
        pyr3_own = np.einsum("ij,ij->i", f_area, f_ctr - c_est_cell[own])
        pc_own = 0.75 * f_ctr + 0.25 * c_est_cell[own]
        # neighbour-side pyramids (inward normal → negative sign)
        pyr3_nei = -np.einsum(
            "ij,ij->i", f_area[:n_int], f_ctr[:n_int] - c_est_cell[nei]
        )
        pc_nei = 0.75 * f_ctr[:n_int] + 0.25 * c_est_cell[nei]

        vol = cell_sum(pyr3_own, pyr3_nei)
        ctr = cell_sum(pyr3_own[:, None] * pc_own, pyr3_nei[:, None] * pc_nei)
        ctr /= np.maximum(vol, small(torch.float64))[:, None]
        vol /= 3.0

        return {
            "Cf": f_ctr,
            "Sf": f_area,
            "magSf": mag_sf,
            "C": ctr,
            "V": vol,
        }

    @property
    def geom(self) -> dict:
        if self._geom is None:
            object.__setattr__(self, "_geom", self._compute_geometry())
        return self._geom

    @property
    def Cf(self) -> np.ndarray:
        return self.geom["Cf"]

    @property
    def Sf(self) -> np.ndarray:
        return self.geom["Sf"]

    @property
    def magSf(self) -> np.ndarray:
        return self.geom["magSf"]

    @property
    def C(self) -> np.ndarray:
        return self.geom["C"]

    @property
    def V(self) -> np.ndarray:
        return self.geom["V"]

    # -- FV interpolation data (surfaceInterpolation) -----------------------
    def weights(self) -> np.ndarray:
        """Linear interpolation weights for internal faces (owner weight)."""
        n_int = self.n_internal_faces
        Sf = self.Sf[:n_int]
        Cf = self.Cf[:n_int]
        d_own = np.abs(np.einsum("ij,ij->i", Sf, Cf - self.C[self.owner[:n_int]]))
        d_nei = np.abs(np.einsum("ij,ij->i", Sf, self.C[self.neighbour] - Cf))
        return d_nei / np.maximum(d_own + d_nei, small(torch.float64))

    def delta_coeffs(self) -> Tuple[np.ndarray, np.ndarray]:
        """(internal 1/|d|, boundary 1/|Cf - C_own|)."""
        n_int = self.n_internal_faces
        d = self.C[self.neighbour] - self.C[self.owner[:n_int]]
        internal = 1.0 / np.linalg.norm(d, axis=1)
        db = self.Cf[n_int:] - self.C[self.owner[n_int:]]
        boundary = 1.0 / np.maximum(np.linalg.norm(db, axis=1), small(torch.float64))
        return internal, boundary

    def non_orth_delta_coeffs(self) -> Tuple[np.ndarray, np.ndarray]:
        """Stabilised deltaCoeffs: 1/max(unit(Sf)&d, 0.05|d|)."""
        n_int = self.n_internal_faces
        d = self.C[self.neighbour] - self.C[self.owner[:n_int]]
        unit_sf = self.Sf[:n_int] / self.magSf[:n_int, None]
        sfd = np.einsum("ij,ij->i", unit_sf, d)
        internal = 1.0 / np.maximum(sfd, 0.05 * np.linalg.norm(d, axis=1))
        db = self.Cf[n_int:] - self.C[self.owner[n_int:]]
        unit_sfb = self.Sf[n_int:] / np.maximum(self.magSf[n_int:, None], small(torch.float64))
        sfdb = np.einsum("ij,ij->i", unit_sfb, db)
        boundary = 1.0 / np.maximum(sfdb, 0.05 * np.linalg.norm(db, axis=1))
        return internal, boundary

    # ------------------------------------------------------------ validation
    def check_closed(self, tol: float = 1e-10) -> float:
        """Max |sum of outward face areas| per cell, normalised by cell area."""
        n_int = self.n_internal_faces
        s = np.zeros((self.n_cells, 3))
        np.add.at(s, self.owner, self.Sf)
        np.add.at(s, self.neighbour, -self.Sf[:n_int])
        a = np.zeros(self.n_cells)
        np.add.at(a, self.owner, self.magSf)
        np.add.at(a, self.neighbour, self.magSf[:n_int])
        return float(np.max(np.linalg.norm(s, axis=1) / np.maximum(a, small(torch.float64))))

    # --------------------------------------------------------------- editing
    def with_patches(self, patches: List[Patch]) -> "PolyMesh":
        return replace(self, patches=patches, _geom=self._geom)

    def reorder_boundary(self, new_patch_id: np.ndarray, patch_defs: List[Tuple[str, str, dict]]):
        """Rebuild the mesh with boundary faces regrouped by `new_patch_id`.

        new_patch_id[i] = target patch index (into patch_defs) for boundary
        face (n_internal + i). Internal faces are untouched. Zero-size patches
        are dropped. Used by createPatch / topoSet-driven repatching.

        Returns (new_mesh, old_to_new) where old_to_new maps old face indices
        to new ones, so face sets/zones can be remapped.
        """
        n_int = self.n_internal_faces
        nb = self.n_boundary_faces
        assert new_patch_id.shape[0] == nb
        order = np.argsort(new_patch_id, kind="stable")
        new_faces_idx = np.concatenate([np.arange(n_int), n_int + order])
        old_to_new = np.empty(self.n_faces, dtype=np.int64)
        old_to_new[new_faces_idx] = np.arange(self.n_faces)
        return self._reindex_faces(new_faces_idx, new_patch_id[order], patch_defs), old_to_new

    def _reindex_faces(self, new_order: np.ndarray, sorted_patch_ids: np.ndarray, patch_defs) -> "PolyMesh":
        faces = self.faces_list()
        new_faces = [faces[f] for f in new_order]
        fv = np.concatenate(new_faces) if new_faces else np.zeros(0, np.int32)
        fo = np.zeros(len(new_faces) + 1, dtype=np.int64)
        fo[1:] = np.cumsum([len(f) for f in new_faces])
        owner = self.owner[new_order]
        n_int = self.n_internal_faces
        patches = []
        start = n_int
        for pid, (name, ptype, extra) in enumerate(patch_defs):
            n = int(np.sum(sorted_patch_ids == pid))
            if n == 0:
                continue
            patches.append(Patch(name, ptype, start, n, dict(extra)))
            start += n
        return PolyMesh(
            points=self.points,
            face_verts=fv.astype(np.int32),
            face_offsets=fo,
            owner=owner.astype(np.int32),
            neighbour=self.neighbour.copy(),
            patches=patches,
            n_cells=self.n_cells,
        )


def build_polymesh(
    points: np.ndarray,
    faces: Sequence[Sequence[int]],
    owner: np.ndarray,
    neighbour: np.ndarray,
    patches: List[Patch],
    n_cells: int,
) -> PolyMesh:
    fv = np.concatenate([np.asarray(f, np.int32) for f in faces]) if len(faces) else np.zeros(0, np.int32)
    fo = np.zeros(len(faces) + 1, dtype=np.int64)
    fo[1:] = np.cumsum([len(f) for f in faces])
    return PolyMesh(
        points=np.asarray(points, np.float64),
        face_verts=fv,
        face_offsets=fo,
        owner=np.asarray(owner, np.int32),
        neighbour=np.asarray(neighbour, np.int32),
        patches=patches,
        n_cells=n_cells,
    )
