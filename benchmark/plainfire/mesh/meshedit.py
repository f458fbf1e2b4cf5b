"""Mesh surgery utilities: createPatch and createBaffles.

createPatch: moves boundary faces (from faceSets or existing patches) into
new patches — used by steckler/singleBox/wallFireSpread2D mesh pipelines to
carve burner/floor patches out of the base wall.

createBaffles: converts the internal faces of a faceZone into paired
master/slave boundary wall faces (the steckler compartment walls,
system/createBafflesDict). The face is duplicated: the master keeps the
owner cell and orientation, the slave gets the neighbour cell with flipped
orientation, and the two cells become disconnected.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

from ..io.foamdict import FoamDict
from .polymesh import Patch, PolyMesh, build_polymesh
from .toposet import TopoSets

__all__ = ["create_patch", "create_baffles"]


def create_patch(mesh: PolyMesh, sets: TopoSets, d: FoamDict) -> PolyMesh:
    n_int = mesh.n_internal_faces
    nb = mesh.n_boundary_faces

    # current patch id per boundary face
    cur = np.zeros(nb, dtype=np.int64)
    patch_defs: List[Tuple[str, str, dict]] = []
    for pi, p in enumerate(mesh.patches):
        cur[p.start - n_int : p.start - n_int + p.n_faces] = pi
        patch_defs.append((p.name, p.ptype, p.extra))

    for entry in d.get_list("patches"):
        if not isinstance(entry, FoamDict):
            continue
        name = entry.get_word("name")
        pinfo = entry.get_dict("patchInfo", FoamDict())
        ptype = str(pinfo.lookup("type", "patch"))
        extra = {k: v for k, v in pinfo.items() if k != "type"}
        new_pid = len(patch_defs)
        patch_defs.append((name, ptype, extra))
        construct = entry.get_word("constructFrom", "patches")
        if construct == "set":
            fset = sets.face_sets[entry.get_word("set")]
            bf = fset[fset >= n_int] - n_int
            cur[bf] = new_pid
        else:
            pats = entry.get_list("patches")
            for pi, p in enumerate(mesh.patches):
                if any(p.name == q or re.fullmatch(str(q), p.name) for q in pats):
                    cur[p.start - n_int : p.start - n_int + p.n_faces] = new_pid

    new_mesh, old_to_new = mesh.reorder_boundary(cur, patch_defs)
    sets.mesh = new_mesh
    _remap_face_sets(sets, old_to_new)
    return new_mesh


def _remap_face_sets(sets: TopoSets, old_to_new: np.ndarray):
    """Remap face sets/zones through a face renumbering (-1 = removed face)."""
    for name, fs in list(sets.face_sets.items()):
        nf = old_to_new[fs]
        sets.face_sets[name] = np.sort(nf[nf >= 0])
    for name, z in list(sets.face_zones.items()):
        nf = old_to_new[z.faces]
        keep = nf >= 0
        order = np.argsort(nf[keep])
        z.faces = nf[keep][order]
        z.flip = z.flip[keep][order]


def create_baffles(mesh: PolyMesh, sets: TopoSets, d: FoamDict) -> PolyMesh:
    """Apply a createBafflesDict. Returns a new mesh; face sets invalidated."""
    zone_entries = []
    for _, bd in d.get_dict("baffles").subdicts():
        if str(bd.lookup("type", "")) != "faceZone":
            raise NotImplementedError("only faceZone baffles supported")
        zname = bd.get_word("zoneName")
        zone = sets.face_zones[zname]
        pdicts = bd.get_dict("patches")
        names = list(pdicts.keys())
        master = pdicts.get_dict(names[0])
        slave = pdicts.get_dict(names[1])
        zone_entries.append((zone, master, slave))

    n_int = mesh.n_internal_faces
    faces = mesh.faces_list()
    owner = mesh.owner
    neighbour = mesh.neighbour

    remove_internal = np.zeros(n_int, bool)
    new_patch_faces = []  # (name, ptype, faces, owners)
    for zone, master, slave in zone_entries:
        zf = zone.faces[zone.faces < n_int]
        zflip = zone.flip[zone.faces < n_int]
        remove_internal[zf] = True
        m_faces, m_own, s_faces, s_own = [], [], [], []
        for f, flip in zip(zf, zflip):
            verts = faces[f]
            if not flip:
                m_faces.append(verts)
                m_own.append(owner[f])
                s_faces.append(verts[::-1].copy())
                s_own.append(neighbour[f])
            else:
                m_faces.append(verts[::-1].copy())
                m_own.append(neighbour[f])
                s_faces.append(verts.copy())
                s_own.append(owner[f])
        new_patch_faces.append(
            (str(master.lookup("name")), str(master.lookup("type", "wall")), m_faces, m_own)
        )
        new_patch_faces.append(
            (str(slave.lookup("name")), str(slave.lookup("type", "wall")), s_faces, s_own)
        )

    keep = ~remove_internal
    new_faces: List[np.ndarray] = [faces[f] for f in range(n_int) if keep[f]]
    new_owner = list(owner[:n_int][keep])
    new_neighbour = list(neighbour[keep])
    n_int_new = len(new_faces)

    # old→new face mapping (baffled internal faces removed; boundary shifted)
    old_to_new = np.full(mesh.n_faces, -1, dtype=np.int64)
    old_to_new[:n_int][keep] = np.arange(n_int_new)
    old_to_new[n_int:] = np.arange(mesh.n_boundary_faces) + n_int_new

    patches: List[Patch] = []
    start = n_int_new
    # existing boundary patches keep their faces
    for p in mesh.patches:
        for f in range(p.start, p.start + p.n_faces):
            new_faces.append(faces[f])
            new_owner.append(owner[f])
        patches.append(Patch(p.name, p.ptype, start, p.n_faces, dict(p.extra)))
        start += p.n_faces
    # new baffle patches
    for name, ptype, bfaces, bowners in new_patch_faces:
        for v, o in zip(bfaces, bowners):
            new_faces.append(np.asarray(v, np.int32))
            new_owner.append(o)
        patches.append(Patch(name, ptype, start, len(bfaces), {}))
        start += len(bfaces)

    new_mesh = build_polymesh(
        points=mesh.points,
        faces=new_faces,
        owner=np.asarray(new_owner),
        neighbour=np.asarray(new_neighbour),
        patches=patches,
        n_cells=mesh.n_cells,
    )
    sets.mesh = new_mesh
    _remap_face_sets(sets, old_to_new)
    return new_mesh
