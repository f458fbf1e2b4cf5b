"""Surface (film) mesh: a 2-D finite-area mesh over primary wall faces.

The port of firefoam_tpu/regionmodels/surfmesh.py. The film is a dense
per-face batch over the wall faces; the transport stencil is an edge list
(pairs of wall faces sharing a mesh edge), so div/grad are edge gathers and
sums into the faces. Those sums collide (a face has several edges), and an
index_add_ on the card adds colliding values in no fixed order; here every
edge→face sum goes through a host-sorted table (ops.geometry.SegSum), so it
is order-fixed and bitwise repeatable on any device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import INT_DTYPE
from ..ops.geometry import SegSum

__all__ = ["FilmMesh"]


@dataclass
class FilmMesh:
    """Finite-area mesh over a set of primary boundary faces.

    `e_own`/`e_nei` index film faces; `e_m` [nE,3] is the in-surface unit
    vector from own to nei (the edge length is `e_len`)."""

    n_faces: int
    area: torch.Tensor  # [nF]
    C: torch.Tensor  # [nF,3] face centres
    n_hat: torch.Tensor  # [nF,3] outward wall normal (out of the fluid)
    prim_bidx: np.ndarray  # [nF] primary boundary-local face index
    prim_cells: np.ndarray  # [nF] adjacent primary cells
    g_tan: torch.Tensor  # [nF,3] tangential gravity (set by the film model)

    e_own: torch.Tensor  # [nE] int
    e_nei: torch.Tensor  # [nE] int
    e_len: torch.Tensor  # [nE] edge length
    e_m: torch.Tensor  # [nE,3] unit own→nei direction (in-surface)
    e_dc: torch.Tensor  # [nE] 1/|d| between face centres
    e_w: torch.Tensor  # [nE] own interpolation weight

    # boundary edges (film rim): faces and outward in-surface directions
    be_face: torch.Tensor  # [nBE]
    be_len: torch.Tensor  # [nBE]
    be_m: torch.Tensor  # [nBE,3] outward in-surface unit vector
    be_C: torch.Tensor = None  # [nBE,3] rim-edge midpoints (inlet siting)

    @classmethod
    def from_faces(cls, mesh, faces: Sequence[int], dtype=torch.float64,
                   device="cpu") -> "FilmMesh":
        faces = np.asarray(sorted(faces), dtype=np.int64)
        n_int = mesh.n_internal_faces
        nF = len(faces)
        fid = {int(f): i for i, f in enumerate(faces)}
        Cf = mesh.Cf[faces]
        Sf = mesh.Sf[faces]
        magSf = mesh.magSf[faces]
        n_hat = Sf / magSf[:, None]
        tiny = 1e-300

        # edges: (point pair) → faces
        pts = mesh.points
        edge_map: Dict[tuple, List[int]] = {}
        for gi in faces:
            verts = mesh.face(int(gi))
            for k in range(len(verts)):
                a, b = int(verts[k]), int(verts[(k + 1) % len(verts)])
                edge_map.setdefault((min(a, b), max(a, b)), []).append(fid[int(gi)])

        e_own, e_nei, e_len, e_m, e_dc, e_w = [], [], [], [], [], []
        be_face, be_len, be_m, be_C = [], [], [], []
        for key, fs in edge_map.items():
            p0, p1 = pts[key[0]], pts[key[1]]
            ec = 0.5 * (p0 + p1)
            el = float(np.linalg.norm(p1 - p0))
            if len(fs) == 2:
                o, n = fs
                d = Cf[n] - Cf[o]
                dist = float(np.linalg.norm(d))
                e_own.append(o)
                e_nei.append(n)
                e_len.append(el)
                e_m.append(d / max(dist, tiny))
                e_dc.append(1.0 / max(dist, tiny))
                e_w.append(float(np.linalg.norm(Cf[n] - ec) / max(dist, tiny)))
            else:
                f = fs[0]
                d = ec - Cf[f]
                d = d - np.dot(d, n_hat[f]) * n_hat[f]  # into the face plane
                be_face.append(f)
                be_len.append(el)
                be_m.append(d / max(np.linalg.norm(d), tiny))
                be_C.append(ec)

        def r(a, cols=None):
            a = np.asarray(a, np.float64)
            if cols is not None:
                a = a.reshape(-1, cols)
            return torch.as_tensor(a, dtype=dtype, device=device)

        def ix(a):
            return torch.as_tensor(np.asarray(a, np.int64), dtype=INT_DTYPE, device=device)

        fm = cls(
            n_faces=nF,
            area=r(magSf),
            C=r(Cf),
            n_hat=r(n_hat),
            prim_bidx=np.where(faces >= n_int, faces - n_int, -1),
            prim_cells=mesh.owner[faces].copy(),
            g_tan=torch.zeros((nF, 3), dtype=dtype, device=device),
            e_own=ix(e_own),
            e_nei=ix(e_nei),
            e_len=r(e_len),
            e_m=r(e_m, 3),
            e_dc=r(e_dc),
            e_w=r(e_w),
            be_face=ix(be_face),
            be_len=r(be_len),
            be_m=r(be_m, 3),
            be_C=r(be_C, 3),
        )
        fm._build_sums(np.asarray(e_own, np.int64), np.asarray(e_nei, np.int64),
                       np.asarray(be_face, np.int64), device)
        return fm

    def _build_sums(self, e_own, e_nei, be_face, device):
        """The order-fixed edge→face tables (one row per film face)."""
        self.sum_own = SegSum(e_own, self.n_faces, device)
        self.sum_nei = SegSum(e_nei, self.n_faces, device)
        self.sum_rim = SegSum(be_face, self.n_faces, device)

    @property
    def n_edges(self) -> int:
        return int(self.e_own.shape[0])

    # ------------------------------------------------------------- operators
    def edge_upwind(self, flux: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        """Upwind edge value of psi for a signed edge flux (own→nei > 0)."""
        return torch.where(flux > 0.0, psi[self.e_own], psi[self.e_nei])

    def edge_to_face(self, ev: torch.Tensor) -> torch.Tensor:
        """Σ over each face's edges of ev, owner side minus neighbour side
        ([nE(, d)] → [nF(, d)])."""
        return self.sum_own(ev) - self.sum_nei(ev)

    def div_edges(self, edge_vals: torch.Tensor) -> torch.Tensor:
        """Σ_edges signed into face sums / area (surface divergence)."""
        return self.edge_to_face(edge_vals) / self.area

    def grad_edges(self, psi: torch.Tensor) -> torch.Tensor:
        """Surface gradient by Green-Gauss over the edges: [nF,3]."""
        pe = self.e_w * psi[self.e_own] + (1.0 - self.e_w) * psi[self.e_nei]
        ev = pe[:, None] * self.e_m * self.e_len[:, None]
        return self.edge_to_face(ev) / self.area[:, None]
