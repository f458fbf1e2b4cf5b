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
        elif cmd in ("extrudeToRegionMesh", "snappyHexMesh"):
            raise NotImplementedError(f"the benchmark's reference has no {cmd}")
        else:
            continue  # surfaceTransformPoints, cp, mv, rm, echo, mktemp, ...

    return ensure_block_mesh()


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
