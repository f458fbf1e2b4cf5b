"""Reading and writing OpenFOAM volField files (0/T, 0/U, ...).

Mirrors GeometricField I/O: FoamFile header, dimensions, internalField
(uniform or nonuniform List<scalar|vector>), and per-patch boundaryField
dictionaries. Reference usage: every file under cases/*/0/.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from .foamdict import Dimensions, FoamDict, parse_file

__all__ = ["FieldFile", "read_field_file", "parse_field_value", "write_field_file"]


@dataclass
class FieldFile:
    name: str
    foam_class: str  # volScalarField / volVectorField / surfaceScalarField
    dimensions: Dimensions
    internal_uniform: bool
    internal: Any  # scalar / (3,) vector for uniform; np.ndarray otherwise
    boundary: FoamDict = field(default_factory=FoamDict)
    raw: Optional[FoamDict] = None

    @property
    def is_vector(self) -> bool:
        return "Vector" in self.foam_class

    def internal_array(self, n_cells: int, dtype=np.float64) -> np.ndarray:
        """Expand the internal field to an [nCells(,3)] array."""
        if self.internal_uniform:
            if self.is_vector:
                return np.broadcast_to(
                    np.asarray(self.internal, dtype=dtype), (n_cells, 3)
                ).copy()
            return np.full((n_cells,), float(self.internal), dtype=dtype)
        arr = np.asarray(self.internal, dtype=dtype)
        if arr.shape[0] != n_cells:
            raise ValueError(
                f"field {self.name}: nonuniform size {arr.shape[0]} != nCells {n_cells}"
            )
        return arr


def parse_field_value(v) -> tuple:
    """Interpret a primitive entry as a field value.

    Returns (uniform: bool, value). Handles:
      uniform 300
      uniform (0 0 0)
      nonuniform List<scalar> N ( ... )
      nonuniform List<vector> N ( (..) (..) ... )
      plain scalar/vector (treated as uniform)
    """
    if isinstance(v, (int, float)):
        return True, float(v)
    if isinstance(v, list):
        if v and v[0] == "uniform":
            val = v[1]
            if isinstance(val, list):
                return True, tuple(float(x) for x in val)
            return True, float(val)
        if v and v[0] == "nonuniform":
            data = v[-1]
            if not isinstance(data, list):
                # zero-size field: "nonuniform List<scalar> 0 ()" parses with
                # data possibly missing
                return False, np.zeros((0,))
            arr = np.asarray(data, dtype=np.float64)
            return False, arr
        if all(isinstance(x, (int, float)) for x in v) and len(v) == 3:
            return True, tuple(float(x) for x in v)
    raise ValueError(f"cannot interpret field value: {v!r}")


def read_field_file(path, case_dir: Optional[str] = None) -> FieldFile:
    d = parse_file(path, case_dir=case_dir)
    hdr = d.get_dict("FoamFile", FoamDict())
    name = str(hdr.lookup("object", os.path.basename(os.fspath(path))))
    cls = str(hdr.lookup("class", "volScalarField"))
    dims = d.lookup("dimensions", Dimensions(()))
    if not isinstance(dims, Dimensions):
        # dimensions may parse as a bare list
        dims = Dimensions(tuple(float(x) for x in dims))
    uniform, internal = parse_field_value(d.lookup("internalField"))
    boundary = d.get_dict("boundaryField", FoamDict())
    return FieldFile(
        name=name,
        foam_class=cls,
        dimensions=dims,
        internal_uniform=uniform,
        internal=internal,
        boundary=boundary,
        raw=d,
    )


def _fmt(x, precision=8) -> str:
    return f"{x:.{precision}g}"


def write_field_file(
    path,
    name: str,
    foam_class: str,
    dimensions,
    internal: np.ndarray,
    boundary_entries: dict,
    location: str = "0",
    precision: int = 8,
):
    """Write an OpenFOAM-format field file (ascii) for checkpoint/inspection."""
    dims = dimensions.dims if isinstance(dimensions, Dimensions) else tuple(dimensions)
    lines = []
    lines.append("FoamFile")
    lines.append("{")
    lines.append("    version     2.0;")
    lines.append("    format      ascii;")
    lines.append(f"    class       {foam_class};")
    lines.append(f'    location    "{location}";')
    lines.append(f"    object      {name};")
    lines.append("}")
    lines.append("")
    lines.append("dimensions      [" + " ".join(_fmt(d) for d in dims) + "];")
    lines.append("")
    arr = np.asarray(internal)
    if arr.ndim == 1:
        lines.append(f"internalField   nonuniform List<scalar> {arr.shape[0]}")
        lines.append("(")
        lines.extend(_fmt(x, precision) for x in arr)
        lines.append(");")
    else:
        lines.append(f"internalField   nonuniform List<vector> {arr.shape[0]}")
        lines.append("(")
        lines.extend(
            "(" + " ".join(_fmt(x, precision) for x in row) + ")" for row in arr
        )
        lines.append(");")
    lines.append("")
    lines.append("boundaryField")
    lines.append("{")
    for pname, pd in boundary_entries.items():
        lines.append(f"    {pname}")
        lines.append("    {")
        for k, v in pd.items():
            if isinstance(v, np.ndarray):
                if v.ndim == 1:
                    body = (
                        f"nonuniform List<scalar> {v.shape[0]} ("
                        + " ".join(_fmt(x, precision) for x in v)
                        + ")"
                    )
                else:
                    body = (
                        f"nonuniform List<vector> {v.shape[0]} ("
                        + " ".join(
                            "(" + " ".join(_fmt(x, precision) for x in row) + ")"
                            for row in v
                        )
                        + ")"
                    )
                lines.append(f"        {k}      {body};")
            elif isinstance(v, tuple):
                lines.append(
                    f"        {k}      uniform ("
                    + " ".join(_fmt(x, precision) for x in v)
                    + ");"
                )
            else:
                lines.append(f"        {k}      {v};")
        lines.append("    }")
    lines.append("}")
    os.makedirs(os.path.dirname(os.fspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
