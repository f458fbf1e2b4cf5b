"""Bandwidth-minimising cell renumbering (the renumberMesh role).

The whole-solve kernels K1-K3 (solvers/dia_krylov.py, csrc/dia_krylov.cu)
take DIA systems: the matvec is a bounded set of offset diagonals. A
castellated or snapped mesh is no block mesh, but after reverse
Cuthill-McKee ordering its adjacency is banded, so a multi-offset DIA
stencil of up to 64 offsets covers a small one exactly (the reference
singleBox castellation: 83 offsets in its own numbering, 63 after RCM).
MeshGeometry.from_polymesh(layout="banded") takes the renumbered mesh.

RCM itself: scipy's reverse_cuthill_mckee when available, else a plain
BFS-from-min-degree fallback (same O(E) idea, slightly worse bands).

The returned mesh has internal faces flipped where the new numbering
reverses owner<neighbour (winding reversed so Sf still points
owner→neighbour; all derived geometry is recomputed lazily by PolyMesh).
`perm` maps new→old cell ids: cell-indexed data in the ORIGINAL order is
gathered with it (fields[perm]); writers scatter back with the inverse.
Face-indexed initial data (rare: phi) is only reordered within flips.
The same permutation, owners, neighbours and face vertices as the JAX
package's mesh/renumber.py.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .polymesh import PolyMesh

__all__ = ["rcm_order", "renumber_mesh"]


def rcm_order(own: np.ndarray, nei: np.ndarray, n_cells: int) -> np.ndarray:
    """Reverse-Cuthill-McKee permutation (new→old) of the cell adjacency."""
    try:
        import scipy.sparse as sp
        import scipy.sparse.csgraph as csg

        A = sp.coo_matrix(
            (np.ones(len(own)), (own, nei)), shape=(n_cells, n_cells)
        )
        return np.asarray(
            csg.reverse_cuthill_mckee((A + A.T).tocsr()), np.int64
        )
    except ImportError:  # pragma: no cover - scipy is installed where the port runs
        # BFS from a min-degree seed, neighbours in degree order, reversed
        adj = [[] for _ in range(n_cells)]
        for a, b in zip(own, nei):
            adj[a].append(b)
            adj[b].append(a)
        deg = np.asarray([len(a) for a in adj])
        seen = np.zeros(n_cells, bool)
        order = []
        for seed in np.argsort(deg):
            if seen[seed]:
                continue
            q = [int(seed)]
            seen[seed] = True
            while q:
                c = q.pop(0)
                order.append(c)
                for nb in sorted(adj[c], key=lambda x: deg[x]):
                    if not seen[nb]:
                        seen[nb] = True
                        q.append(nb)
        return np.asarray(order[::-1], np.int64)


def renumber_mesh(mesh: PolyMesh) -> Tuple[PolyMesh, np.ndarray]:
    """Renumber cells by RCM. Returns (mesh', perm) with perm new→old."""
    n_int = mesh.n_internal_faces
    own = np.asarray(mesh.owner)
    nei = np.asarray(mesh.neighbour)
    perm = rcm_order(own[:n_int], nei[:n_int], mesh.n_cells)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(mesh.n_cells)

    own2 = inv[own]
    nei2 = inv[nei] if len(nei) else nei
    # flip internal faces whose new owner id exceeds the neighbour's: swap
    # the pair and reverse the vertex winding so Sf keeps pointing
    # owner→neighbour (all derived geometry recomputes from these arrays)
    fo = np.asarray(mesh.face_offsets)
    fv = np.asarray(mesh.face_verts).copy()
    own_new = own2.copy()
    nei_new = nei2.copy()
    for f in np.nonzero(own2[:n_int] > nei2[:n_int])[0]:
        own_new[f], nei_new[f] = nei2[f], own2[f]
        s, e = fo[f], fo[f + 1]
        fv[s:e] = fv[s:e][::-1]
    return (
        PolyMesh(
            points=mesh.points,
            face_verts=fv,
            face_offsets=mesh.face_offsets,
            owner=own_new,
            neighbour=nei_new[:n_int] if len(nei) else nei,
            patches=mesh.patches,
            n_cells=mesh.n_cells,
        ),
        perm,
    )
