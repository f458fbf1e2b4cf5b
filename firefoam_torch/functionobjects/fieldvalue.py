"""Function objects: volFieldValue, fieldMinMax, faceZonesIntegration, probes.

The port of firefoam_tpu/functionobjects/fieldvalue.py: the reference's
runtime post-processing (the controlDict functions block: volFieldValue
volIntegrate, fieldMinMax, lib/functionObjects/faceZonesIntegration, stock
probes/patchProbes). Each object's reductions run on the device inside the
step (`compute`, merged into the step log); `record` and `write` format the
rows and files on the host, master-only.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..io.foamdict import FoamDict
from ..io.master import is_master

__all__ = ["FunctionObjects", "make_function_objects"]

_DAT = {
    "volFieldValue": "volFieldValue.dat",
    "fieldMinMax": "fieldMinMax.dat",
    "probes": "probes.dat",
    "faceZonesIntegration": "faceZonesIntegration.dat",
}


@dataclass
class _FO:
    name: str
    kind: str
    fields: List[str]
    params: dict
    rows: list = field(default_factory=list)


def _volfield(state, solver, name):
    """A named volume field's cell values from the state, or None."""
    if name == "Qdot":
        return state["Qdot"]
    if name in state and hasattr(state[name], "i"):
        return state[name].i
    if name in solver.species:
        return state["Y"].i[:, solver.gas.index(name)]
    return None


class FunctionObjects:
    """All enabled function objects of a case; their files go under
    <case>/postProcessing/<name>/<startTime>/."""

    def __init__(self, solver, fos: List[_FO], out_dir: Optional[str] = None):
        self.solver = solver
        self.fos = fos
        self.out_dir = out_dir or os.path.join(solver.case.root, "postProcessing")
        # device copies of the index/sign arrays, made once
        dev = solver.geom.device
        self._idx = {}
        for fo in fos:
            if fo.kind == "probes":
                self._idx[fo.name] = torch.as_tensor(fo.params["cells"], device=dev)
            elif fo.kind == "faceZonesIntegration":
                self._idx[fo.name] = [
                    tuple(torch.as_tensor(np.asarray(a), device=dev) for a in z[1:])
                    for z in fo.params.get("zone_slots", ())
                ]

    # ------------------------------------------------------- device part
    def compute(self, state) -> Dict[str, torch.Tensor]:
        """The objects' reductions of this state, as step-log entries."""
        out: Dict[str, torch.Tensor] = {}
        g = self.solver.geom
        for fo in self.fos:
            for fname in fo.fields:
                tag = f"fo_{fo.name}_{fname}"
                if fo.kind == "faceZonesIntegration":
                    # per-zone flip-signed integral of the surface field
                    # (faceZonesIntegration.C:258-283 calcFaceZonesIntegral)
                    sv = state.get(fname)
                    if sv is None or not hasattr(sv, "i"):
                        continue
                    zones = fo.params.get("zone_slots", ())
                    for (zname, *_), (slots, signs, bslots, bsigns) in zip(
                            zones, self._idx[fo.name]):
                        tot = torch.sum(sv.i[slots] * signs.to(sv.i.dtype))
                        if len(bslots):
                            tot = tot + torch.sum(sv.b[bslots] * bsigns.to(sv.b.dtype))
                        out[f"{tag}_{zname}"] = tot
                    continue
                v = _volfield(state, self.solver, fname)
                if v is None:
                    continue
                if fo.kind == "volFieldValue":
                    op = fo.params.get("operation", "volIntegrate")
                    if op == "volIntegrate":
                        out[tag] = g.rsum(v * g.V)
                    elif op == "volAverage":
                        out[tag] = g.rsum(v * g.V) / g.rsum(g.V)
                    elif op == "max":
                        out[tag] = g.rmax(v)
                    elif op == "min":
                        out[tag] = g.rmin(v)
                elif fo.kind == "fieldMinMax":
                    m = torch.linalg.norm(v, dim=-1) if v.ndim == 2 else v
                    out[tag + "_min"] = g.rmin(m)
                    out[tag + "_max"] = g.rmax(m)
                elif fo.kind == "probes":
                    out[tag] = v[self._idx[fo.name]]
        return out

    # --------------------------------------------------------- host part
    def record(self, t: float, log: Dict[str, np.ndarray]):
        """Append one row per object from a host (numpy) step log; the
        columns follow the sorted log keys, as in the JAX package, whose
        jitted step returns its log with sorted keys."""
        for fo in self.fos:
            row = [t]
            hit = False
            for k, v in sorted(log.items()):
                if k.startswith(f"fo_{fo.name}_"):
                    row.extend(np.atleast_1d(np.asarray(v)).tolist())
                    hit = True
            if hit:
                fo.rows.append(row)

    def write(self, start_time: str = "0"):
        if not is_master():
            return
        for fo in self.fos:
            if not fo.rows:
                continue
            d = os.path.join(self.out_dir, fo.name, start_time)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, _DAT.get(fo.kind, fo.kind + ".dat")), "w") as f:
                f.write(f"# {fo.kind} {fo.name}: fields {' '.join(fo.fields)}\n")
                for row in fo.rows:
                    f.write("\t".join(f"{x:.8g}" for x in row) + "\n")


def make_function_objects(solver, control_dict: FoamDict) -> FunctionObjects:
    """The enabled function objects of a controlDict; unsupported types are
    skipped, as in the JAX package."""
    fns = control_dict.get_dict("functions", FoamDict())
    fos: List[_FO] = []
    g = solver.geom
    for name, d in fns.subdicts():
        if not isinstance(d, FoamDict) or not d.get_bool("enabled", True):
            continue
        kind = d.get_word("type", "")
        flds = [str(x) for x in d.get_list("fields", [])]
        params: dict = {}
        if kind == "volFieldValue":
            params["operation"] = str(d.lookup("operation", "volIntegrate"))
        elif kind in ("probes", "patchProbes"):
            if d.found("region") and str(d.lookup("region")) != "region0":
                continue  # region probes belong to the region models
            C = solver.geom.C.detach().cpu().numpy().astype(np.float64)
            cells = [int(np.argmin(np.sum((C - np.asarray(p, float)) ** 2, 1)))
                     for p in d.get_list("probeLocations", [])]
            params["cells"] = np.asarray(cells, np.int64)
            kind = "probes"
        elif kind == "faceZonesIntegration":
            zones = [str(z) for z in d.get_list("faceZones", [])]
            params["zones"] = zones
            n_int = solver.cm.mesh.n_internal_faces
            # zone faces on non-empty, non-processor patches count too
            skip = np.zeros(g.n_boundary, bool)
            for p in g.patches:
                if p.ptype in ("empty", "processor"):
                    skip[p.slice] = True
            zone_slots = []
            for z in zones:
                fz = solver.cm.face_zones.get(z)
                if fz is None:
                    continue
                f = np.asarray(fz.faces)
                flip = (np.asarray(fz.flip) if getattr(fz, "flip", None) is not None
                        else np.zeros(f.shape[0], bool))
                signs = np.where(flip, -1.0, 1.0)
                keep = f < n_int
                bf = f[~keep] - n_int
                bsigns = signs[~keep][~skip[bf]]
                bf = bf[~skip[bf]]
                zone_slots.append((z, g.face_perm[f[keep]], signs[keep], bf, bsigns))
            params["zone_slots"] = tuple(zone_slots)
        elif kind != "fieldMinMax":
            continue
        fos.append(_FO(name=name, kind=kind, fields=flds, params=params))
    return FunctionObjects(solver, fos)
