"""1-D extruded region geometry and the batched tridiagonal solver.

The port of firefoam_tpu/regionmodels/oned.py. The reference builds 3-D
region meshes with extrudeToRegionMesh (oneD: one column of cells per
faceZone face) and solves fvMatrix systems on them. Here a region is a dense
[nFaces, nLayers] batch, and every per-column equation is one batched
Thomas solve: a loop over the layers on [nFaces] tensors, in the order of
the JAX package's scan.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.foamdict import parse_file

__all__ = ["Region1D", "tridiag_solve"]


@dataclass
class Region1D:
    """Column geometry of a oneD extruded region (host arrays).

    Layer 0 sits at the coupled (primary-side) surface, layer nL−1 at the
    far ('<zone>_top') end. All columns share the layer grid (linearNormal
    extrusion)."""

    name: str
    zone: str  # first zone (a region may span several)
    n_faces: int
    n_layers: int
    dx: np.ndarray  # [nL] layer thicknesses
    x: np.ndarray  # [nL] layer-centre depth from the coupled surface
    area: np.ndarray  # [nF] primary face areas
    prim_faces: np.ndarray  # [nF] primary-mesh global face ids
    prim_bidx: np.ndarray  # [nF] primary boundary-local face ids (−1 if internal)
    prim_cells: np.ndarray  # [nF] adjacent primary cell (owner)
    total_thickness: float
    zones: tuple = ()  # all zone names, in face order

    @property
    def coupled_patch(self) -> str:
        return f"region0_to_{self.name}_{self.zone}"

    @property
    def coupled_patches(self) -> list:
        """All gas-side mapped patches of this region, one per faceZone
        (extrudeToRegionMesh adaptMesh: region0_to_<region>_<zone>)."""
        return [f"region0_to_{self.name}_{z}" for z in (self.zones or (self.zone,))]

    @classmethod
    def from_case(cls, case_dir: str, cm, region_name: str) -> "Region1D":
        """cm: the primary region's CaseMesh (faceZones resolved)."""
        d = None
        for ed in getattr(cm, "extrude_dicts", []):
            if ed.get_word("region", "") == region_name:
                d = ed
                break
        if d is None:
            d = parse_file(f"{case_dir}/system/extrudeToRegionMeshDict", case_dir=case_dir)
        zones = [str(z) for z in d.get_list("faceZones")]
        fl, zs = [], []
        for z in zones:
            fz = cm.face_zones.get(z)
            if fz is None:
                continue
            fl.append(np.asarray(fz.faces, dtype=np.int64))
            zs.append(z)
        faces = np.concatenate(fl) if fl else np.zeros(0, np.int64)
        n_layers = d.get_int("nLayers")
        expansion = d.get_scalar("expansionRatio", 1.0)
        thickness = d.get_dict("linearNormalCoeffs").get_scalar("thickness")
        if abs(expansion - 1.0) < 1e-12:
            dx = np.full(n_layers, thickness / n_layers)
        else:
            w = expansion ** np.arange(n_layers)
            dx = thickness * w / w.sum()
        x = np.cumsum(dx) - 0.5 * dx
        mesh = cm.mesh
        n_int = mesh.n_internal_faces
        return cls(
            name=region_name,
            zone=zs[0] if zs else (zones[0] if zones else ""),
            n_faces=len(faces),
            n_layers=n_layers,
            dx=dx,
            x=x,
            area=mesh.magSf[faces].copy(),
            prim_faces=faces,
            prim_bidx=np.where(faces >= n_int, faces - n_int, -1),
            prim_cells=mesh.owner[faces].copy(),
            total_thickness=thickness,
            zones=tuple(zs),
        )


def tridiag_solve(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor
                  ) -> torch.Tensor:
    """Thomas algorithm along the last axis, batched over the leading axes.

    a: sub-diagonal (a[..., 0] ignored), b: diagonal, c: super-diagonal
    (c[..., -1] ignored), d: right-hand side. Returns x with
    b x + a x_prev + c x_next = d."""
    n = b.shape[-1]
    w = b[..., 0]
    cp = [c[..., 0] / w]
    dp = [d[..., 0] / w]
    for i in range(1, n):
        w = b[..., i] - a[..., i] * cp[-1]
        dp.append((d[..., i] - a[..., i] * dp[-1]) / w)
        cp.append(c[..., i] / w)
    xs = [dp[n - 1]]
    for i in range(n - 2, -1, -1):
        xs.append(dp[i] - cp[i] * xs[-1])
    return torch.stack(xs[::-1], dim=-1)
