"""OpenFOAM-format field output: time directories a reference user can read.

The port of firefoam_tpu/io/writer.py. The reference writes every
AUTO_WRITE field into `<case>/<time>/` per writeControl; downstream tooling
(paraFoam, sample/probe utilities) reads that layout. This writer emits
ASCII vol*/surfaceScalarField files with the standard FoamFile header, the
internalField as a nonuniform list and per-patch `calculated` boundary
values, master-only. Tensors come to the host once per field.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .master import is_master

__all__ = ["write_time_dir", "write_field", "write_surface_field"]

_DIMS = {
    "T": "[0 0 0 1 0 0 0]",
    "p": "[1 -1 -2 0 0 0 0]",
    "p_rgh": "[1 -1 -2 0 0 0 0]",
    "rho": "[1 -3 0 0 0 0 0]",
    "U": "[0 1 -1 0 0 0 0]",
    "k": "[0 2 -2 0 0 0 0]",
    "hs": "[0 2 -2 0 0 0 0]",
    "Qdot": "[1 -1 -3 0 0 0 0]",
    "alphat": "[1 -1 -1 0 0 0 0]",
    "nut": "[0 2 -1 0 0 0 0]",
    "G": "[1 0 -3 0 0 0 0]",
    "Y": "[0 0 0 0 0 0 0]",
    # infoFieldsOutput diagnostics (solver/include/infoFieldsOutput.H)
    "ft": "[0 0 0 0 0 0 0]",
    "UT": "[0 1 -1 1 0 0 0]",
    "rhoU": "[1 -2 -1 0 0 0 0]",
    "rhoT": "[1 -3 0 1 0 0 0]",
    "rhoFu": "[1 -3 0 0 0 0 0]",
    "d": "[0 2 -1 0 0 0 0]",
    "dSgs": "[0 2 -1 0 0 0 0]",
    "B": "[0 2 -2 0 0 0 0]",
    "QcWallFunction": "[1 0 -3 0 0 0 0]",
    "HRR_fu": "[1 2 -3 0 0 0 0]",
    "phiFt": "[1 0 -1 0 0 0 0]",
    "phiO2": "[1 0 -1 0 0 0 0]",
    "phiCO2": "[1 0 -1 0 0 0 0]",
    "phiHc": "[1 2 -3 0 0 0 0]",
    "phiHs": "[1 2 -3 0 0 0 0]",
    "phiH": "[1 2 -3 0 0 0 0]",
    "momentumX": "[1 1 -2 0 0 0 0]",
    "momentumY": "[1 1 -2 0 0 0 0]",
    "momentumZ": "[1 1 -2 0 0 0 0]",
    "convectiveHeatFlux_L": "[1 0 -3 0 0 0 0]",
    "convectiveHeatFlux_T": "[1 0 -3 0 0 0 0]",
}

_HEADER = """/*--------------------------------*- C++ -*----------------------------------*\\
  generated by firefoam_torch
\\*---------------------------------------------------------------------------*/
FoamFile
{{
    version     2.0;
    format      ascii;
    class       {cls};
    location    "{loc}";
    object      {name};
}}
// * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * //

dimensions      {dims};

internalField   nonuniform List<{vtype}>
{n}
(
{vals}
)
;

boundaryField
{{
{bfield}
}}

// ************************************************************************* //
"""


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _fmt_scalar(v: np.ndarray) -> str:
    return "\n".join(f"{x:.8g}" for x in v)


def _fmt_vector(v: np.ndarray) -> str:
    return "\n".join(f"({x:.8g} {y:.8g} {z:.8g})" for x, y, z in v)


def _fmt_symm(v: np.ndarray) -> str:
    return "\n".join("(" + " ".join(f"{c:.8g}" for c in row) + ")" for row in v)


def _boundary(patches, boundary, vtype, fmt, zero) -> str:
    parts = []
    for p in patches:
        if p.ptype == "empty":
            parts.append(f"    {p.name}\n    {{\n        type            empty;\n    }}")
            continue
        entry = [f"    {p.name}", "    {", "        type            calculated;"]
        if boundary is not None and p.n > 0:
            entry.append(f"        value           nonuniform List<{vtype}>\n{p.n}\n(\n"
                         f"{fmt(boundary[p.slice])}\n)\n;")
        else:
            entry.append(f"        value           uniform {zero};")
        entry.append("    }")
        parts.append("\n".join(entry))
    return "\n".join(parts)


def _write(path, txt):
    if is_master():  # undecomposed output on rank 0 only
        with open(path, "w") as f:
            f.write(txt)


def write_field(path: str, name: str, internal, boundary, patches, time_name: str,
                dims: Optional[str] = None):
    """Write one volume field in OpenFOAM ASCII format."""
    internal = _np(internal)
    boundary = None if boundary is None else _np(boundary)
    is_vec = internal.ndim == 2 and internal.shape[1] == 3
    is_symm = internal.ndim == 2 and internal.shape[1] == 6
    cls = "volSymmTensorField" if is_symm else ("volVectorField" if is_vec else "volScalarField")
    vtype = "symmTensor" if is_symm else ("vector" if is_vec else "scalar")
    fmt = _fmt_symm if is_symm else (_fmt_vector if is_vec else _fmt_scalar)
    zero = "(0 0 0 0 0 0)" if is_symm else ("(0 0 0)" if is_vec else "0")
    dims = dims or _DIMS.get(name, _DIMS.get(name.split(".")[0], "[0 0 0 0 0 0 0]"))
    _write(path, _HEADER.format(
        cls=cls, loc=time_name, name=name, dims=dims, vtype=vtype, n=len(internal),
        vals=fmt(internal), bfield=_boundary(patches, boundary, vtype, fmt, zero),
    ))


def write_surface_field(path: str, name: str, internal_real, boundary, patches,
                        time_name: str, dims: Optional[str] = None):
    """Write a surfaceScalarField (flux diagnostics: HRR_fu, phiFt, …)."""
    internal_real = _np(internal_real)
    boundary = None if boundary is None else _np(boundary)
    _write(path, _HEADER.format(
        cls="surfaceScalarField", loc=time_name, name=name,
        dims=dims or _DIMS.get(name, "[0 0 0 0 0 0 0]"), vtype="scalar",
        n=len(internal_real), vals=_fmt_scalar(internal_real),
        bfield=_boundary(patches, boundary, "scalar", _fmt_scalar, "0"),
    ))


def write_time_dir(out_root: str, time_value: float, solver, state: Dict,
                   fields: Optional[list] = None) -> str:
    """Write the solver's fields for one time (runTime.write()) into
    `<out_root>/<time>/`; returns that directory."""
    from ..functionobjects.infofields import InfoFields
    from ..ops.fields import VolField

    tname = f"{time_value:.6g}"
    d = os.path.join(out_root, tname)
    os.makedirs(d, exist_ok=True)
    g = solver.geom

    def put(name, fld, dims=None):
        if hasattr(fld, "i"):
            write_field(os.path.join(d, name), name, fld.i, fld.b, g.patches, tname, dims)
        else:
            write_field(os.path.join(d, name), name, fld, None, g.patches, tname, dims)

    wanted = fields or ["T", "U", "p", "p_rgh", "rho", "k", "alphat", "Qdot"] + list(solver.species)
    for name in wanted:
        if name in solver.species:
            s = solver.gas.index(name)
            put(name, VolField(state["Y"].i[:, s], state["Y"].b[:, s]), _DIMS["Y"])
        elif name in state:
            put(name, state[name])
    # viewFactor and opaqueSolid carry no G (the JAX writer raises there)
    if solver.radiation is not None and "G" in state.get("rad", {}):
        put("G", state["rad"]["G"])
    if getattr(solver, "soot", None) is not None:
        put("soot", solver.soot.soot(state["Y"].i), "[0 0 0 0 0 0 0]")

    # cell-wise RTI link fields (solver/rti.H / createRTI.H AUTO_WRITE)
    if "rti_links" in state:
        for nm, arr in solver.rti_links.fields(state["rti_links"]).items():
            put(nm, arr, "[0 0 0 1 0 0 0]" if nm.startswith("Tlink") else "[0 0 1 0 0 0 0]")

    # infoFieldsOutput diagnostics, written with every time directory as
    # the reference's AUTO_WRITE members are
    info = InfoFields(solver)
    for nm, f in info.volume_fields(state).items():
        put(nm, f)
    perm = torch.as_tensor(g.face_perm, device=g.device)
    for nm, f in info.surface_fields(state).items():
        write_surface_field(os.path.join(d, nm), nm, f.i[perm], f.b, g.patches, tname)
    return d
