"""snappyHexMesh — the castellated subset the bundled cases use.

cases/singleBox/system/snappyHexMeshDict runs with `snap false; addLayers
false`: pure castellated meshing of axis-aligned `searchableBox` surfaces
over a single uniform background block (cases/singleBox/constant/polyMesh/
blockMeshDict, 7×5×7 hexes). The algorithm reproduced here (reference:
OpenFOAM meshRefinement / snappyHexMeshDriver castellation):

  1. refine every background cell whose bounding box intersects a
     refinement surface to that surface's level (only levels {0,1} are
     exercised; nCellsBetweenLevels 1 imposes nothing extra with one level);
  2. classify final cells by flood fill from `locationInMesh`, blocking
     cell-centre→cell-centre segments that cross a surface (for a convex
     searchableBox that is exactly the inside/outside indicator change);
     unreachable cells are removed;
  3. exposed faces become a new patch named after the surface (patchInfo);
     refinement-transition faces stay as 2×2 quarter faces against the
     coarse cell (OpenFOAM's hanging-node polyhedra have identical FV
     geometry: same area sums, centres, owner/neighbour pairs).

The resulting PolyMesh feeds the same topoSet/createPatch/extrude pipeline
as blockMesh output (cases/singleBox/mesh.sh:21-41).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..io.foamdict import FoamDict
from .polymesh import Patch, PolyMesh, build_polymesh

__all__ = ["snappy_castellated"]


def _box_bounds(d: FoamDict) -> Tuple[np.ndarray, np.ndarray]:
    lo = np.asarray(d.get_vector("min"), float)
    hi = np.asarray(d.get_vector("max"), float)
    return lo, hi


def snappy_castellated(block_dict: FoamDict, snappy_dict: FoamDict) -> PolyMesh:
    scale = block_dict.get_scalar("convertToMeters", 1.0)
    verts = np.asarray(
        [np.asarray(v, float) for v in block_dict.get_list("vertices")]
    ) * scale
    blocks = block_dict.get_list("blocks")
    # single uniform axis-aligned hex block (the used subset)
    assert str(blocks[0]) == "hex", "snappy subset: single hex block"
    bverts = [int(v) for v in blocks[1]]
    n = tuple(int(v) for v in blocks[2])
    lo = verts[bverts].min(axis=0)
    hi = verts[bverts].max(axis=0)

    # ---- parse snappy controls ----
    geom = snappy_dict.get_dict("geometry")
    boxes: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for name, gd in geom.subdicts():
        if str(gd.lookup("type", "")) == "searchableBox":
            boxes[name] = _box_bounds(gd)
    cc = snappy_dict.get_dict("castellatedMeshControls")
    surfs = []
    for name, sd in cc.get_dict("refinementSurfaces").subdicts():
        lvl = [int(v) for v in sd.get_list("level")]
        pi = sd.get_dict("patchInfo", FoamDict())
        ptype = str(pi.lookup("type", "patch"))
        if name not in boxes:
            continue
        assert max(lvl) <= 1, "snappy subset: surface level ≤ 1"
        surfs.append((name, boxes[name], max(lvl), ptype))
    loc = np.asarray(cc.get_vector("locationInMesh"), float)

    nx, ny, nz = n
    dx = (hi - lo) / np.array([nx, ny, nz], float)

    # ---- 1. refinement flags on the coarse grid ----
    ii, jj, kk = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    c_lo = lo + np.stack([ii, jj, kk], -1) * dx
    c_hi = c_lo + dx
    refine = np.zeros((nx, ny, nz), bool)
    tol = 1e-9 * np.max(hi - lo)
    for _, (blo, bhi), lvl, _ in surfs:
        if lvl < 1:
            continue
        overlap = np.all(c_lo < bhi - tol, -1) & np.all(c_hi > blo + tol, -1)
        inside = np.all(c_lo > blo + tol, -1) & np.all(c_hi < bhi - tol, -1)
        refine |= overlap & ~inside

    # ---- fine lattice (2×) with per-fine-cell final ids ----
    m = 2
    fnx, fny, fnz = m * nx, m * ny, m * nz
    fdx = dx / m
    coarse_of = np.stack(
        np.meshgrid(
            np.arange(fnx) // m, np.arange(fny) // m, np.arange(fnz) // m,
            indexing="ij",
        ),
        -1,
    )
    is_fine = refine[coarse_of[..., 0], coarse_of[..., 1], coarse_of[..., 2]]

    # ---- 2. removal: inside-surface indicator (convex boxes) + flood ----
    fctr = lo + (np.stack(np.meshgrid(
        np.arange(fnx), np.arange(fny), np.arange(fnz), indexing="ij"
    ), -1) + 0.5) * fdx
    # final-cell centres: fine cells use their own centre; coarse cells the
    # parent centre — the indicator is evaluated at the FINAL cell centre
    cctr = lo + (coarse_of + 0.5) * dx
    eval_ctr = np.where(is_fine[..., None], fctr, cctr)
    inside_any = np.zeros((fnx, fny, fnz), bool)
    for _, (blo, bhi), _, _ in surfs:
        inside_any |= np.all(eval_ctr > blo, -1) & np.all(eval_ctr < bhi, -1)
    keep = ~inside_any
    loc_in = np.all(loc[None, None, None] > lo, -1)  # sanity
    assert keep[tuple(((loc - lo) / fdx).astype(int))], "locationInMesh removed"

    # ---- assign final cell ids (coarse cells share one id over 8 slots) ----
    fid = -np.ones((fnx, fny, fnz), np.int64)
    # coarse ids: one per unrefined kept coarse cell
    next_id = 0
    coarse_ids = -np.ones((nx, ny, nz), np.int64)
    # order: coarse-grid i-fastest like blockMesh, fine children after —
    # any deterministic order works (geometry is computed from the mesh)
    for K in range(nz):
        for J in range(ny):
            for I in range(nx):
                sl = (slice(m * I, m * I + m), slice(m * J, m * J + m),
                      slice(m * K, m * K + m))
                if refine[I, J, K]:
                    blk = keep[sl]
                    ids = -np.ones((m, m, m), np.int64)
                    cnt = int(blk.sum())
                    ids[blk] = next_id + np.arange(cnt)
                    fid[sl] = ids
                    next_id += cnt
                elif keep[m * I, m * J, m * K]:
                    fid[sl] = next_id
                    coarse_ids[I, J, K] = next_id
                    next_id += 1
    n_cells = next_id

    is_coarse_slot = ~is_fine

    # ---- 3. faces from fine-lattice interfaces ----
    # quarter faces between distinct kept final cells; merge 2×2 groups
    # where BOTH sides are coarse; boundary faces where one side is removed
    # (→ surface patch) or outside the domain (→ background patch).
    internal: Dict[Tuple[int, int], List[Tuple]] = {}
    boundary: Dict[str, List[Tuple]] = {}

    # background patches: map each domain side to its patch name/type
    side_patch = _side_patches(block_dict, verts, bverts)
    surf_patch = [(s[0], s[3]) for s in surfs]  # (name, type) exposed faces

    pts_idx = {}
    pts_list: List[Tuple[float, float, float]] = []

    def pid(i, j, k):
        key = (i, j, k)
        s = pts_idx.get(key)
        if s is None:
            s = len(pts_list)
            pts_idx[key] = s
            pts_list.append(tuple(lo + np.array([i, j, k]) * fdx))
        return s

    def quad(axis, plane, a, b, sa, sb):
        """Vertex quad of a lattice face at `plane` along `axis`, spanning
        [a, a+sa]×[b, b+sb] in the two other axes, normal +axis."""
        if axis == 0:
            ps = [(plane, a, b), (plane, a + sa, b), (plane, a + sa, b + sb), (plane, a, b + sb)]
        elif axis == 1:
            ps = [(a, plane, b), (a, plane, b + sb), (a + sa, plane, b + sb), (a + sa, plane, b)]
        else:
            ps = [(a, b, plane), (a + sa, b, plane), (a + sa, b + sb, plane), (a, b + sb, plane)]
        return [pid(*p) for p in ps]

    fshape = (fnx, fny, fnz)
    for axis in range(3):
        oa = [x for x in range(3) if x != axis]
        na, nb = fshape[oa[0]], fshape[oa[1]]
        npl = fshape[axis]
        # merged-coarse bookkeeping: visited mask per (plane, A, B)
        for plane in range(npl + 1):
            done = np.zeros((na, nb), bool)
            for A in range(na):
                for B in range(nb):
                    if done[A, B]:
                        continue
                    lo_cell = _cell_at(fid, axis, plane - 1, A, B)
                    hi_cell = _cell_at(fid, axis, plane, A, B)
                    if lo_cell == hi_cell:
                        continue  # same final cell (or both removed/outside)
                    lo_coarse = plane - 1 >= 0 and _slot_coarse(is_coarse_slot, axis, plane - 1, A, B)
                    hi_coarse = plane < npl and _slot_coarse(is_coarse_slot, axis, plane, A, B)
                    # merge when every touched side is coarse (2×2 group
                    # starting at even (A,B) and plane on the coarse lattice)
                    can_merge = (
                        plane % m == 0
                        and A % m == 0
                        and B % m == 0
                        and (plane - 1 < 0 or lo_coarse)
                        and (plane >= npl or hi_coarse)
                    )
                    size = m if can_merge else 1
                    if can_merge:
                        done[A : A + m, B : B + m] = True
                    vq = quad(axis, plane, A, B, size, size)
                    if lo_cell >= 0 and hi_cell >= 0:
                        key = (lo_cell, hi_cell)
                        internal.setdefault(key, []).append((vq, +1))
                    elif lo_cell >= 0 or hi_cell >= 0:
                        ownc = lo_cell if lo_cell >= 0 else hi_cell
                        flip = lo_cell < 0  # owner above → outward is −axis
                        on_domain = plane == 0 or plane == npl
                        if on_domain:
                            pname, ptype = side_patch[(axis, 0 if plane == 0 else 1)]
                        else:
                            pname, ptype = surf_patch[0]
                        boundary.setdefault(pname, []).append(
                            (vq[::-1] if flip else vq, ownc, ptype)
                        )

    # ---- assemble: internal faces sorted upper-triangular ----
    faces: List[List[int]] = []
    owner: List[int] = []
    nbr: List[int] = []
    for (a, b) in sorted(internal.keys(), key=lambda t: (min(t), max(t))):
        for vq, _ in internal[(a, b)]:
            if a < b:
                faces.append(vq)
                owner.append(a)
                nbr.append(b)
            else:
                faces.append(vq[::-1])
                owner.append(b)
                nbr.append(a)
    n_int = len(faces)

    patches: List[Patch] = []
    # background patch order from the blockMeshDict, then surface patches
    order = []
    for pname, _, _, _ in _parse_boundary(block_dict):
        if pname in boundary and pname not in order:
            order.append(pname)
    for pname in boundary:
        if pname not in order:
            order.append(pname)
    start = n_int
    for pname in order:
        entries = boundary[pname]
        ptype = entries[0][2]
        patches.append(Patch(pname, ptype, start, len(entries)))
        for vq, ownc, _ in entries:
            faces.append(vq)
            owner.append(ownc)
        start += len(entries)

    pts = np.asarray(pts_list, float)
    mesh = build_polymesh(pts, faces, np.asarray(owner), np.asarray(nbr), patches, n_cells)
    return mesh


def _cell_at(fid, axis, plane_cell, A, B):
    """Final cell id of the fine cell on one side of a lattice face
    (−2 if outside the domain)."""
    if plane_cell < 0 or plane_cell >= fid.shape[axis]:
        return -2
    if axis == 0:
        return int(fid[plane_cell, A, B])
    if axis == 1:
        return int(fid[A, plane_cell, B])
    return int(fid[A, B, plane_cell])


def _slot_coarse(is_coarse, axis, plane_cell, A, B):
    if axis == 0:
        return bool(is_coarse[plane_cell, A, B])
    if axis == 1:
        return bool(is_coarse[A, plane_cell, B])
    return bool(is_coarse[A, B, plane_cell])


def _parse_boundary(block_dict: FoamDict):
    out = []
    bl = block_dict.get_list("boundary")
    i = 0
    while i + 1 < len(bl):
        name = str(bl[i])
        d = bl[i + 1]
        out.append(
            (
                name,
                str(d.lookup("type", "patch")),
                [ [int(v) for v in q] for q in d.get_list("faces") ],
                {},
            )
        )
        i += 2
    return out


def _side_patches(block_dict, verts, bverts):
    """Map (axis, 0|1) domain side → (patch name, type) from the block
    boundary quads (each quad lies on one constant-coordinate plane)."""
    lo = verts[bverts].min(axis=0)
    hi = verts[bverts].max(axis=0)
    side_patch = {}
    for name, ptype, quads, _ in _parse_boundary(block_dict):
        for q in quads:
            qp = verts[q]
            for axis in range(3):
                if np.allclose(qp[:, axis], lo[axis]):
                    side_patch[(axis, 0)] = (name, ptype)
                elif np.allclose(qp[:, axis], hi[axis]):
                    side_patch[(axis, 1)] = (name, ptype)
    return side_patch
