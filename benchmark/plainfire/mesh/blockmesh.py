"""blockMesh: structured hex-block mesh generation from blockMeshDict.

Re-implements the subset of OpenFOAM blockMesh exercised by the reference
cases (all five use single/multi hex blocks with simpleGrading — e.g.
cases/steckler/constant/polyMesh/blockMeshDict): trilinear hex blocks,
per-axis expansion-ratio grading, point merging across blocks, upper-
triangular internal face ordering, and both old-style `patches` and
new-style `boundary` patch specifications.

Cell numbering matches blockMesh (i fastest, then j, then k, blocks in
order) so golden-log cell references (e.g. "max T in cell 1353") line up.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..io.foamdict import FoamDict
from .polymesh import Patch, PolyMesh

__all__ = ["block_mesh"]

# local hex corner coordinates (OpenFOAM hex ordering)
_HEX_CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    dtype=np.float64,
)

# faces of a hex cell in terms of local corner ids, outward-pointing ordering
# (OpenFOAM cellModel "hex")
_HEX_FACES = {
    "xmin": (0, 4, 7, 3),
    "xmax": (1, 2, 6, 5),
    "ymin": (0, 1, 5, 4),
    "ymax": (3, 7, 6, 2),
    "zmin": (0, 3, 2, 1),
    "zmax": (4, 5, 6, 7),
}


def _grading_positions(n: int, ratio: float) -> np.ndarray:
    """Normalised node positions [0,1] for n cells with expansion ratio
    (last/first cell size) = ratio."""
    if n == 1 or abs(ratio - 1.0) < 1e-12:
        return np.linspace(0.0, 1.0, n + 1)
    r = ratio ** (1.0 / (n - 1))
    sizes = r ** np.arange(n)
    pos = np.zeros(n + 1)
    pos[1:] = np.cumsum(sizes)
    return pos / pos[-1]


def _shape_functions(t: np.ndarray) -> np.ndarray:
    """Trilinear shape functions: t[...,3] in [0,1] → weights [...,8]."""
    x, y, z = t[..., 0], t[..., 1], t[..., 2]
    return np.stack(
        [
            (1 - x) * (1 - y) * (1 - z),
            x * (1 - y) * (1 - z),
            x * y * (1 - z),
            (1 - x) * y * (1 - z),
            (1 - x) * (1 - y) * z,
            x * (1 - y) * z,
            x * y * z,
            (1 - x) * y * z,
        ],
        axis=-1,
    )


class _Block:
    def __init__(self, verts: List[int], n: Tuple[int, int, int], grading):
        self.verts = verts  # 8 global blockMeshDict vertex ids
        self.nx, self.ny, self.nz = n
        self.grading = grading  # (gx, gy, gz)

    def point_local(self, i, j, k):
        return i + (self.nx + 1) * (j + (self.ny + 1) * k)

    def cell_local(self, i, j, k):
        return i + self.nx * (j + self.ny * k)

    def generate_points(self, corner_pts: np.ndarray) -> np.ndarray:
        tx = _grading_positions(self.nx, self.grading[0])
        ty = _grading_positions(self.ny, self.grading[1])
        tz = _grading_positions(self.nz, self.grading[2])
        T = np.stack(
            np.meshgrid(tx, ty, tz, indexing="ij"), axis=-1
        )  # [nx+1,ny+1,nz+1,3]
        # reorder to k-major flattening: index (i,j,k) -> i + (nx+1)(j + (ny+1)k)
        W = _shape_functions(T)  # [nx+1,ny+1,nz+1,8]
        pts = np.einsum("ijkc,cd->ijkd", W, corner_pts)
        return pts.transpose(2, 1, 0, 3).reshape(-1, 3)  # k, j, i → flat idx matches point_local

    def corner_set_of_side(self, side: str) -> frozenset:
        return frozenset(self.verts[c] for c in _HEX_FACES[side])


def _parse_blocks(entry: list) -> List[_Block]:
    blocks = []
    i = 0
    while i < len(entry):
        tok = entry[i]
        if tok != "hex":
            raise NotImplementedError(f"unsupported block shape: {tok}")
        verts = [int(v) for v in entry[i + 1]]
        i += 2
        # optional cellZone name
        if isinstance(entry[i], str):
            i += 1
        counts = tuple(int(v) for v in entry[i])
        i += 1
        grading = (1.0, 1.0, 1.0)
        if i < len(entry) and entry[i] in ("simpleGrading", "edgeGrading"):
            kind = entry[i]
            g = entry[i + 1]
            if kind == "simpleGrading":
                grading = tuple(
                    float(x) if not isinstance(x, list) else float(x[0][-1])
                    for x in g
                )
            else:  # edgeGrading: use first edge of each direction
                grading = (float(g[0]), float(g[4]), float(g[8]))
            i += 2
        blocks.append(_Block(verts, counts, grading))
    return blocks


def _parse_patches(d: FoamDict) -> List[Tuple[str, str, List[List[int]], dict]]:
    """Returns [(name, type, quads, extra)] from `boundary` or `patches`."""
    out = []
    if "boundary" in d:
        b = d["boundary"]
        i = 0
        while i < len(b):
            name = str(b[i])
            pd = b[i + 1]
            quads = [[int(v) for v in q] for q in pd.get_list("faces")]
            extra = {
                k: v for k, v in pd.items() if k not in ("type", "faces")
            }
            out.append((name, pd.get_word("type"), quads, extra))
            i += 2
    elif "patches" in d:
        p = d["patches"]
        i = 0
        while i < len(p):
            ptype = str(p[i])
            name = str(p[i + 1])
            quads = [[int(v) for v in q] for q in p[i + 2]]
            out.append((name, ptype, quads, {}))
            i += 3
    return out


def block_mesh(dict_: FoamDict) -> PolyMesh:
    scale = dict_.get_scalar("convertToMeters", 1.0)
    vertices = np.asarray(dict_.get_list("vertices"), dtype=np.float64) * scale
    blocks = _parse_blocks(dict_.get_list("blocks"))
    patch_specs = _parse_patches(dict_)

    # ---- generate and merge points (vectorized tolerance merge) ----
    bb = np.ptp(vertices, axis=0).max() if len(vertices) else 1.0
    tol = max(bb, 1.0) * 1e-10
    raw_pts = [blk.generate_points(vertices[blk.verts]) for blk in blocks]
    all_pts = np.concatenate(raw_pts, axis=0)
    keys = np.round(all_pts / tol).astype(np.int64)
    _, first_idx, inverse = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    points = all_pts[first_idx]
    block_pt_gid = []
    off = 0
    for pts in raw_pts:
        block_pt_gid.append(inverse[off : off + pts.shape[0]].astype(np.int64))
        off += pts.shape[0]

    # ---- cells and faces ----
    cell_base = []
    n_cells = 0
    for blk in blocks:
        cell_base.append(n_cells)
        n_cells += blk.nx * blk.ny * blk.nz

    # Vectorized per-block face generation.  Block-interior faces are built
    # directly; block-surface faces go through a registry so shared sides of
    # adjacent blocks merge into internal faces.
    int_quads: List[np.ndarray] = []  # each [n,4] with owner-outward ordering
    int_own: List[np.ndarray] = []
    int_nei: List[np.ndarray] = []
    face_reg: Dict[tuple, list] = {}  # surface faces: key → [(cell, quad, bi, side)]

    for bi, blk in enumerate(blocks):
        gids = block_pt_gid[bi]
        base = cell_base[bi]
        nx, ny, nz = blk.nx, blk.ny, blk.nz
        # G[i,j,k] = global point id at grid node (i,j,k)
        G = gids.reshape(nz + 1, ny + 1, nx + 1).transpose(2, 1, 0)
        # cell ids indexed [i,j,k]
        Cid = base + (
            np.arange(nx)[:, None, None]
            + nx * (np.arange(ny)[None, :, None] + ny * np.arange(nz)[None, None, :])
        )

        def quads(v0, v1, v2, v3):
            return np.stack(
                [v0.ravel(), v1.ravel(), v2.ravel(), v3.ravel()], axis=1
            ).astype(np.int64)

        # interior x-faces (between cell i and i+1): xmax face of lower cell
        if nx > 1:
            q = quads(
                G[1:nx, :ny, :nz],
                G[1:nx, 1:, :nz],
                G[1:nx, 1:, 1:],
                G[1:nx, :ny, 1:],
            )
            int_quads.append(q)
            int_own.append(Cid[: nx - 1].ravel())
            int_nei.append(Cid[1:].ravel())
        # interior y-faces: ymax face of lower-j cell: (3,7,6,2)
        if ny > 1:
            q = quads(
                G[:nx, 1:ny, :nz],
                G[:nx, 1:ny, 1:],
                G[1:, 1:ny, 1:],
                G[1:, 1:ny, :nz],
            )
            int_quads.append(q)
            int_own.append(Cid[:, : ny - 1, :].ravel())
            int_nei.append(Cid[:, 1:, :].ravel())
        # interior z-faces: zmax face of lower-k cell: (4,5,6,7)
        if nz > 1:
            q = quads(
                G[:nx, :ny, 1:nz],
                G[1:, :ny, 1:nz],
                G[1:, 1:, 1:nz],
                G[:nx, 1:, 1:nz],
            )
            int_quads.append(q)
            int_own.append(Cid[:, :, : nz - 1].ravel())
            int_nei.append(Cid[:, :, 1:].ravel())

        # block-surface faces, outward orientation
        surf = {
            "xmin": (
                quads(G[0, :ny, :nz], G[0, :ny, 1:], G[0, 1:, 1:], G[0, 1:, :nz]),
                Cid[0].ravel(),
            ),
            "xmax": (
                quads(G[nx, :ny, :nz], G[nx, 1:, :nz], G[nx, 1:, 1:], G[nx, :ny, 1:]),
                Cid[nx - 1].ravel(),
            ),
            "ymin": (
                quads(G[:nx, 0, :nz], G[1:, 0, :nz], G[1:, 0, 1:], G[:nx, 0, 1:]),
                Cid[:, 0, :].ravel(),
            ),
            "ymax": (
                quads(G[:nx, ny, :nz], G[:nx, ny, 1:], G[1:, ny, 1:], G[1:, ny, :nz]),
                Cid[:, ny - 1, :].ravel(),
            ),
            "zmin": (
                quads(G[:nx, :ny, 0], G[:nx, 1:, 0], G[1:, 1:, 0], G[1:, :ny, 0]),
                Cid[:, :, 0].ravel(),
            ),
            "zmax": (
                quads(G[:nx, :ny, nz], G[1:, :ny, nz], G[1:, 1:, nz], G[:nx, 1:, nz]),
                Cid[:, :, nz - 1].ravel(),
            ),
        }
        for side, (q, cells) in surf.items():
            for quad, cell in zip(q, cells):
                tq = tuple(quad)
                key = tuple(sorted(tq))
                face_reg.setdefault(key, []).append((int(cell), tq, bi, side))

    reg_quads, reg_own, reg_nei = [], [], []
    boundary = []  # (owner, verts, block, side)
    for key, users in face_reg.items():
        if len(users) == 2:
            (c1, q1, _, _), (c2, q2, _, _) = users
            if c1 < c2:
                reg_quads.append(q1)
                reg_own.append(c1)
                reg_nei.append(c2)
            else:
                reg_quads.append(q2)
                reg_own.append(c2)
                reg_nei.append(c1)
        elif len(users) == 1:
            c, q, bi, side = users[0]
            boundary.append((c, q, bi, side))
        else:
            raise ValueError("face shared by >2 cells — degenerate block setup")

    if reg_quads:
        int_quads.append(np.asarray(reg_quads, dtype=np.int64))
        int_own.append(np.asarray(reg_own, dtype=np.int64))
        int_nei.append(np.asarray(reg_nei, dtype=np.int64))

    if int_quads:
        all_q = np.concatenate(int_quads, axis=0)
        all_o = np.concatenate(int_own)
        all_n = np.concatenate(int_nei)
    else:
        all_q = np.zeros((0, 4), np.int64)
        all_o = np.zeros(0, np.int64)
        all_n = np.zeros(0, np.int64)
    order = np.lexsort((all_n, all_o))
    all_q, all_o, all_n = all_q[order], all_o[order], all_n[order]

    # ---- assign boundary faces to patches ----
    side_to_patch: Dict[Tuple[int, str], int] = {}
    for pi, (_, _, quads, _) in enumerate(patch_specs):
        for quad in quads:
            qset = frozenset(quad)
            matched = False
            for bi, blk in enumerate(blocks):
                for side in _HEX_FACES:
                    if blk.corner_set_of_side(side) == qset:
                        side_to_patch[(bi, side)] = pi
                        matched = True
            if not matched:
                raise ValueError(f"patch quad {quad} matches no block side")

    default_patch = dict_.get_dict("defaultPatch", FoamDict())
    default_name = str(default_patch.lookup("name", "defaultFaces"))
    default_type = str(default_patch.lookup("type", "empty"))

    n_patches = len(patch_specs)
    bfaces_per_patch: List[list] = [[] for _ in range(n_patches + 1)]
    for c, q, bi, side in boundary:
        pi = side_to_patch.get((bi, side), n_patches)
        bfaces_per_patch[pi].append((c, q))

    n_int = all_q.shape[0]
    bquads, bown = [all_q], [all_o]
    patches: List[Patch] = []
    start = n_int
    names_types = [(n, t, e) for (n, t, _, e) in patch_specs] + [
        (default_name, default_type, {})
    ]
    for pi, bl in enumerate(bfaces_per_patch):
        if not bl:
            continue
        bl.sort(key=lambda t: t[0])
        name, ptype, extra = names_types[pi]
        patches.append(Patch(name, ptype, start, len(bl), dict(extra)))
        bquads.append(np.asarray([q for _, q in bl], dtype=np.int64))
        bown.append(np.asarray([c for c, _ in bl], dtype=np.int64))
        start += len(bl)

    quads = np.concatenate(bquads, axis=0)
    owner = np.concatenate(bown)
    n_faces = quads.shape[0]
    fo = np.arange(n_faces + 1, dtype=np.int64) * 4
    return PolyMesh(
        points=points,
        face_verts=quads.ravel().astype(np.int32),
        face_offsets=fo,
        owner=owner.astype(np.int32),
        neighbour=all_n.astype(np.int32),
        patches=patches,
        n_cells=n_cells,
    )
