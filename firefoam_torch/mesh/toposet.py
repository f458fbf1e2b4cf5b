"""topoSet / setSet engine: cell/face/point sets and zones.

Re-implements the set sources the reference mesh pipelines use
(cases/*/mesh.sh: topoSet -dict, setSet -batch, setsToZones):
patchToFace, boxToFace, boxToCell, cellToFace, faceToCell, faceToFace,
cellToCell, labelToFace/Cell, setToFaceZone, setsToFaceZone, plus the
new/add/delete/subset/invert/clear/remove actions.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import small

from ..io.foamdict import FoamDict
from .polymesh import PolyMesh

__all__ = ["TopoSets", "FaceZone", "apply_topo_set_dict", "apply_set_set_batch"]


@dataclass
class FaceZone:
    name: str
    faces: np.ndarray  # face indices
    flip: np.ndarray  # bool per face: True = use reversed orientation


@dataclass
class TopoSets:
    """Holds named sets/zones for one mesh."""

    mesh: PolyMesh
    cell_sets: Dict[str, np.ndarray] = field(default_factory=dict)
    face_sets: Dict[str, np.ndarray] = field(default_factory=dict)
    point_sets: Dict[str, np.ndarray] = field(default_factory=dict)
    face_zones: Dict[str, FaceZone] = field(default_factory=dict)
    cell_zones: Dict[str, np.ndarray] = field(default_factory=dict)

    # ------------------------------------------------------------- sources
    def _source_faces(self, source: str, info: FoamDict, args: List[str]) -> np.ndarray:
        mesh = self.mesh
        if source == "patchToFace":
            pat = str(info.lookup("name")) if info is not None else args[0]
            sel = []
            for p in mesh.patches:
                if p.name == pat or re.fullmatch(pat, p.name):
                    sel.append(np.arange(p.start, p.start + p.n_faces))
            if not sel:
                raise KeyError(f"patchToFace: no patch matches '{pat}'")
            return np.concatenate(sel)
        if source == "boxToFace":
            boxes = _boxes_from(info, args)
            cf = mesh.Cf
            m = np.zeros(mesh.n_faces, bool)
            for lo, hi in boxes:
                m |= np.all((cf >= lo) & (cf <= hi), axis=1)
            return np.where(m)[0]
        if source == "cellToFace":
            set_name = str(info.lookup("set")) if info is not None else args[0]
            option = str(info.lookup("option")) if info is not None else args[1]
            cells = np.zeros(mesh.n_cells, bool)
            cells[self.cell_sets[set_name]] = True
            own_in = cells[mesh.owner]
            nei_in = np.zeros(mesh.n_faces, bool)
            nei_in[: mesh.n_internal_faces] = cells[mesh.neighbour]
            if option == "all":
                return np.where(own_in | nei_in)[0]
            if option == "both":
                return np.where(own_in & nei_in)[0]
            raise NotImplementedError(f"cellToFace option {option}")
        if source == "faceToFace":
            set_name = str(info.lookup("set")) if info is not None else args[0]
            return self.face_sets[set_name].copy()
        if source == "labelToFace":
            vals = info.get_list("value") if info is not None else [int(a) for a in args]
            return np.asarray(vals, dtype=np.int64)
        if source == "zoneToFace":
            zname = str(info.lookup("name")) if info is not None else args[0]
            return self.face_zones[zname].faces.copy()
        if source == "normalToFace":
            # faces whose unit normal matches: |1 − n̂·normal| < tol
            # (OpenFOAM normalToFace.C; cases/singleBox/system/topoSetDict)
            normal = np.asarray(info.get_vector("normal"), float)
            normal = normal / (np.linalg.norm(normal) + small(torch.float64))
            tol = info.get_scalar("cos", 0.01)
            nf = mesh.Sf / np.maximum(mesh.magSf, small(torch.float64))[:, None]
            return np.where(np.abs(1.0 - nf @ normal) < tol)[0]
        raise NotImplementedError(f"face source {source}")

    def _source_cells(self, source: str, info: FoamDict, args: List[str]) -> np.ndarray:
        mesh = self.mesh
        if source == "boxToCell":
            boxes = _boxes_from(info, args)
            c = mesh.C
            m = np.zeros(mesh.n_cells, bool)
            for lo, hi in boxes:
                m |= np.all((c >= lo) & (c <= hi), axis=1)
            return np.where(m)[0]
        if source == "faceToCell":
            set_name = str(info.lookup("set")) if info is not None else args[0]
            option = str(info.lookup("option")) if info is not None else args[1]
            fs = self.face_sets[set_name]
            own = self.mesh.owner[fs]
            internal = fs[fs < mesh.n_internal_faces]
            nei = mesh.neighbour[internal]
            if option == "owner":
                return np.unique(own)
            if option == "neighbour":
                return np.unique(nei)
            if option == "any":
                return np.unique(np.concatenate([own, nei]))
            raise NotImplementedError(f"faceToCell option {option}")
        if source == "cellToCell":
            set_name = str(info.lookup("set")) if info is not None else args[0]
            return self.cell_sets[set_name].copy()
        if source == "cylinderToCell":
            p1 = np.asarray(info.get_list("p1"), float)
            p2 = np.asarray(info.get_list("p2"), float)
            radius = info.get_scalar("radius")
            axis = p2 - p1
            mag2 = float(axis @ axis)
            d = mesh.C - p1
            t = (d @ axis) / mag2
            perp = d - t[:, None] * axis
            m = (t >= 0) & (t <= 1) & (np.einsum("ij,ij->i", perp, perp) <= radius**2)
            return np.where(m)[0]
        if source == "sphereToCell":
            centre = np.asarray(info.get_list("centre"), float)
            radius = info.get_scalar("radius")
            d = mesh.C - centre
            return np.where(np.einsum("ij,ij->i", d, d) <= radius**2)[0]
        if source == "labelToCell":
            vals = info.get_list("value") if info is not None else [int(a) for a in args]
            return np.asarray(vals, dtype=np.int64)
        if source == "zoneToCell":
            zname = str(info.lookup("name")) if info is not None else args[0]
            return self.cell_zones[zname].copy()
        raise NotImplementedError(f"cell source {source}")

    # ------------------------------------------------------------- actions
    def apply(
        self,
        set_type: str,
        name: str,
        action: str,
        source: Optional[str] = None,
        info: Optional[FoamDict] = None,
        args: Optional[List[str]] = None,
    ):
        args = args or []
        if set_type == "faceZoneSet":
            self._apply_face_zone(name, action, source, info, args)
            return
        if set_type == "cellZoneSet":
            if action == "new" and source == "setToCellZone":
                sname = str(info.lookup("set")) if info is not None else args[0]
                self.cell_zones[name] = self.cell_sets[sname].copy()
                return
            raise NotImplementedError(f"cellZoneSet action {action}/{source}")

        store, universe = {
            "cellSet": (self.cell_sets, self.mesh.n_cells),
            "faceSet": (self.face_sets, self.mesh.n_faces),
            "pointSet": (self.point_sets, self.mesh.n_points),
        }[set_type]

        if action == "remove":
            store.pop(name, None)
            return
        if action == "clear":
            store[name] = np.zeros(0, dtype=np.int64)
            return
        if action == "invert":
            cur = np.zeros(universe, bool)
            cur[store.get(name, np.zeros(0, np.int64))] = True
            store[name] = np.where(~cur)[0]
            return

        src = (
            self._source_faces(source, info, args)
            if set_type == "faceSet"
            else self._source_cells(source, info, args)
        )
        if action == "new":
            store[name] = np.unique(src)
        elif action == "add":
            store[name] = np.unique(np.concatenate([store.get(name, np.zeros(0, np.int64)), src]))
        elif action == "delete":
            store[name] = np.setdiff1d(store.get(name, np.zeros(0, np.int64)), src)
        elif action == "subset":
            store[name] = np.intersect1d(store.get(name, np.zeros(0, np.int64)), src)
        else:
            raise NotImplementedError(f"action {action}")

    def _apply_face_zone(self, name, action, source, info, args):
        if action == "remove":
            self.face_zones.pop(name, None)
            return
        if source == "setToFaceZone":
            sname = str(info.lookup("faceSet")) if info is not None else args[0]
            faces = np.sort(self.face_sets[sname])
            self.face_zones[name] = FaceZone(name, faces, np.zeros(faces.shape[0], bool))
            # a faceZoneSet is also usable as a faceSet (OpenFOAM faceZoneSet
            # derives from faceSet; topoSetDictCompartment deletes against it)
            self.face_sets[name] = faces.copy()
            return
        if source == "setsToFaceZone":
            fname = str(info.lookup("faceSet")) if info is not None else args[0]
            cname = str(info.lookup("cellSet")) if info is not None else args[1]
            faces = np.sort(self.face_sets[fname])
            cells = np.zeros(self.mesh.n_cells, bool)
            cells[self.cell_sets[cname]] = True
            # flip so that zone normal points away from the cellSet side
            flip = ~cells[self.mesh.owner[faces]]
            self.face_zones[name] = FaceZone(name, faces, flip)
            self.face_sets[name] = faces.copy()
            return
        raise NotImplementedError(f"faceZoneSet source {source}")


def _boxes_from(info: Optional[FoamDict], args: List) -> List[tuple]:
    if info is not None:
        if info.found("box"):
            b = info.get_list("box")
            return [(np.asarray(b[0], float), np.asarray(b[1], float))]
        if info.found("boxes"):
            bs = info.get_list("boxes")
            return [
                (np.asarray(bs[i], float), np.asarray(bs[i + 1], float))
                for i in range(0, len(bs), 2)
            ]
    # setSet command-line form: two paren lists
    return [(np.asarray(args[0], float), np.asarray(args[1], float))]


def apply_topo_set_dict(sets: TopoSets, d: FoamDict):
    """Apply a topoSetDict's `actions` list."""
    for act in d.get_list("actions"):
        if not isinstance(act, FoamDict):
            continue
        sets.apply(
            set_type=act.get_word("type"),
            name=act.get_word("name"),
            action=act.get_word("action"),
            source=str(act.lookup("source", "")) or None,
            info=act.get_dict("sourceInfo", None) if act.found("sourceInfo") else act,
        )


_SETSET_TOKEN = re.compile(r"\([^)]*\)|\S+")


def apply_set_set_batch(sets: TopoSets, text: str):
    """Apply a setSet -batch script (one command per line)."""
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if not line:
            continue
        toks = _SETSET_TOKEN.findall(line)
        set_type, name, action = toks[0], toks[1], toks[2]
        source = toks[3] if len(toks) > 3 else None
        raw_args = toks[4:]
        args = []
        for a in raw_args:
            if a.startswith("("):
                args.append([float(x) for x in a[1:-1].split()])
            else:
                args.append(a)
        sets.apply(set_type, name, action, source=source, args=args)
