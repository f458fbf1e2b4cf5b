"""Case mesh pipeline.

The reference cases build their meshes with shell scripts (cases/*/mesh.sh)
chaining blockMesh → topoSet/setSet → createPatch → createBaffles →
extrudeToRegionMesh. This module interprets those scripts (the simple
`runApplication <utility> [args]` subset they actually use) and runs the
native mesh utilities, producing the final PolyMesh plus named zones.
"""

from __future__ import annotations

import os
import shlex
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..io.foamdict import FoamDict, parse_file
from .blockmesh import block_mesh
from .meshedit import create_baffles, create_patch
from .polymesh import PolyMesh
from .toposet import FaceZone, TopoSets, apply_set_set_batch, apply_topo_set_dict

__all__ = ["CaseMesh", "build_case_mesh"]


@dataclass
class CaseMesh:
    mesh: PolyMesh
    sets: TopoSets
    extrude_dicts: List[FoamDict] = field(default_factory=list)

    @property
    def face_zones(self) -> Dict[str, FaceZone]:
        return self.sets.face_zones


def _find_dict(case_dir: str, *names: str) -> Optional[str]:
    for name in names:
        for sub in ("system", os.path.join("constant", "polyMesh"), "constant"):
            p = os.path.join(case_dir, sub, name)
            if os.path.isfile(p):
                return p
    return None


def build_case_mesh(case_dir: str, mesh_script: str = "mesh.sh") -> CaseMesh:
    case_dir = os.path.abspath(case_dir)
    script = os.path.join(case_dir, mesh_script)
    state: Optional[CaseMesh] = None

    def ensure_block_mesh() -> CaseMesh:
        nonlocal state
        if state is None:
            state = _run_block_mesh(case_dir)
        return state

    if not os.path.isfile(script):
        return ensure_block_mesh()

    with open(script) as f:
        lines = f.read().splitlines()

    for raw in lines:
        line = raw.split("#")[0].strip()
        if not line or line.startswith((".", "cd ", "exit")):
            continue
        if line.startswith("runApplication"):
            line = line[len("runApplication") :].strip()
        try:
            toks = shlex.split(line)
        except ValueError:
            continue
        if not toks:
            continue
        cmd = os.path.basename(toks[0])
        args = toks[1:]

        if cmd == "blockMesh":
            state = _run_block_mesh(case_dir)
        elif cmd == "topoSet":
            st = ensure_block_mesh()
            dpath = _opt_value(args, "-dict")
            if dpath is None:
                dpath = _find_dict(case_dir, "topoSetDict")
            else:
                dpath = os.path.join(case_dir, dpath)
            apply_topo_set_dict(st.sets, parse_file(dpath, case_dir=case_dir))
        elif cmd == "setSet":
            st = ensure_block_mesh()
            bpath = _opt_value(args, "-batch")
            if bpath is not None:
                p = os.path.join(case_dir, bpath)
                if not os.path.isfile(p):
                    p = os.path.join(case_dir, "system", os.path.basename(bpath))
                if not os.path.isfile(p):
                    # mesh.sh scripts are not `set -e`; the reference run
                    # skips past missing batch files (singleBox references
                    # a createSamplePlane.setSet that is not committed)
                    continue
                with open(p) as f:
                    apply_set_set_batch(st.sets, f.read())
        elif cmd == "setsToZones":
            st = ensure_block_mesh()
            no_flip = "-noFlipMap" in args
            for name, fs in st.sets.face_sets.items():
                faces = np.sort(fs)
                st.sets.face_zones.setdefault(
                    name, FaceZone(name, faces, np.zeros(faces.shape[0], bool))
                )
        elif cmd == "createPatch":
            st = ensure_block_mesh()
            d = parse_file(_find_dict(case_dir, "createPatchDict"), case_dir=case_dir)
            st.mesh = create_patch(st.mesh, st.sets, d)
        elif cmd == "createBaffles":
            st = ensure_block_mesh()
            d = parse_file(_find_dict(case_dir, "createBafflesDict"), case_dir=case_dir)
            st.mesh = create_baffles(st.mesh, st.sets, d)
        elif cmd == "extrudeToRegionMesh":
            st = ensure_block_mesh()
            dpath = _opt_value(args, "-dict")
            dpath = (
                os.path.join(case_dir, dpath)
                if dpath
                else _find_dict(case_dir, "extrudeToRegionMeshDict")
            )
            d = parse_file(dpath, case_dir=case_dir)
            st.extrude_dicts.append(d)
            _extrude_adapt_mesh(st, d)
        elif cmd == "snappyHexMesh":
            from .snappy import snappy_castellated

            bpath = _find_dict(case_dir, "blockMeshDict")
            spath = _find_dict(case_dir, "snappyHexMeshDict")
            mesh = snappy_castellated(
                parse_file(bpath, case_dir=case_dir),
                parse_file(spath, case_dir=case_dir),
            )
            state = CaseMesh(mesh=mesh, sets=TopoSets(mesh))
        else:
            continue  # surfaceTransformPoints, cp, mv, rm, echo, mktemp, ...

    return ensure_block_mesh()


def _extrude_adapt_mesh(st: CaseMesh, d: FoamDict):
    """extrudeToRegionMesh adaptMesh behaviour on the PRIMARY mesh: the
    faceZone's boundary faces are split out of their patches into a new
    mappedWall patch `region0_to_<region>_<zone>` (the coupled patch the
    case's 0/ fields reference — e.g. cases/wallFireSpread2D/0/T)."""
    if not d.get_bool("adaptMesh", True):
        return
    from .meshedit import _remap_face_sets

    region = d.get_word("region")
    zones = [str(z) for z in d.get_list("faceZones")]
    mesh = st.mesh
    n_int = mesh.n_internal_faces
    nb = mesh.n_boundary_faces
    cur = np.zeros(nb, dtype=np.int64)
    patch_defs = []
    for pi, p in enumerate(mesh.patches):
        cur[p.start - n_int : p.start - n_int + p.n_faces] = pi
        patch_defs.append((p.name, p.ptype, p.extra))
    changed = False
    for zone in zones:
        fz = st.face_zones.get(zone)
        if fz is None:
            continue
        name = f"region0_to_{region}_{zone}"
        if any(pd[0] == name for pd in patch_defs):
            continue
        bf = np.asarray(fz.faces)
        bf = bf[bf >= n_int] - n_int
        if bf.size == 0:
            continue
        new_pid = len(patch_defs)
        patch_defs.append((name, "mappedWall", {"sampleRegion": region}))
        cur[bf] = new_pid
        changed = True
    if changed:
        new_mesh, old_to_new = mesh.reorder_boundary(cur, patch_defs)
        st.mesh = new_mesh
        st.sets.mesh = new_mesh
        _remap_face_sets(st.sets, old_to_new)


def _opt_value(args: List[str], flag: str) -> Optional[str]:
    for i, a in enumerate(args):
        if a == flag and i + 1 < len(args):
            return args[i + 1]
    return None


def _run_block_mesh(case_dir: str) -> CaseMesh:
    dpath = _find_dict(case_dir, "blockMeshDict")
    if dpath is None:
        raise FileNotFoundError(f"no blockMeshDict found under {case_dir}")
    mesh = block_mesh(parse_file(dpath, case_dir=case_dir))
    return CaseMesh(mesh=mesh, sets=TopoSets(mesh))
