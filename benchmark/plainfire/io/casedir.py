"""OpenFOAM case-directory access.

A `Case` wraps a case directory (system/, constant/, time dirs) and provides
cached dictionary lookup, matching how the reference solver reads its
configuration (solver/fireFoam.C:55-60 createTime/createMesh/createFields).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from .fields import FieldFile, read_field_file
from .foamdict import FoamDict, parse_file

__all__ = ["Case"]


_TIME_RE = re.compile(r"^-?\d+(\.\d*)?([eE][+-]?\d+)?$")


class Case:
    def __init__(self, root: str, region: Optional[str] = None):
        self.root = os.path.abspath(os.fspath(root))
        self.region = region
        self._cache: Dict[str, FoamDict] = {}

    # -- paths ---------------------------------------------------------------
    @property
    def system_dir(self) -> str:
        return os.path.join(self.root, "system")

    @property
    def constant_dir(self) -> str:
        if self.region:
            return os.path.join(self.root, "constant", self.region)
        return os.path.join(self.root, "constant")

    def time_dir(self, time) -> str:
        tname = time if isinstance(time, str) else _time_name(time)
        if self.region:
            return os.path.join(self.root, tname, self.region)
        return os.path.join(self.root, tname)

    def time_names(self) -> List[str]:
        out = []
        for name in os.listdir(self.root):
            if _TIME_RE.match(name) and os.path.isdir(os.path.join(self.root, name)):
                out.append(name)
        return sorted(out, key=float)

    # -- dictionaries ----------------------------------------------------------
    def _load(self, path: str) -> FoamDict:
        if path not in self._cache:
            self._cache[path] = parse_file(path, case_dir=self.root)
        return self._cache[path]

    def system(self, name: str) -> FoamDict:
        # system dicts live in the case-level system dir (optionally region subdir)
        if self.region:
            p = os.path.join(self.system_dir, self.region, name)
            if os.path.isfile(p):
                return self._load(p)
        return self._load(os.path.join(self.system_dir, name))

    def constant(self, name: str) -> FoamDict:
        return self._load(os.path.join(self.constant_dir, name))

    def has_constant(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self.constant_dir, name))

    @property
    def control_dict(self) -> FoamDict:
        return self._load(os.path.join(self.root, "system", "controlDict"))

    @property
    def fv_schemes(self) -> FoamDict:
        return self.system("fvSchemes")

    @property
    def fv_solution(self) -> FoamDict:
        return self.system("fvSolution")

    def start_time(self) -> str:
        """controlDict startFrom: startTime | firstTime | latestTime
        (checkpoint/resume — reference runs resume from the last written
        time directory via 'startFrom latestTime')."""
        cd = self.control_dict
        mode = str(cd.lookup("startFrom", "startTime"))
        names = self.time_names()
        if mode == "latestTime":
            return names[-1] if names else "0"
        if mode == "firstTime":
            return names[0] if names else "0"
        return _time_name(cd.get_scalar("startTime", 0.0))

    # -- fields ---------------------------------------------------------------
    def field(self, name: str, time="0") -> FieldFile:
        tdir = self.time_dir(time)
        p = os.path.join(tdir, name)
        if not os.path.isfile(p):
            raise FileNotFoundError(p)
        return read_field_file(p, case_dir=self.root)

    def has_field(self, name: str, time="0") -> bool:
        return os.path.isfile(os.path.join(self.time_dir(time), name))

    def field_or_default(self, name: str, default_name: str, time="0") -> FieldFile:
        """Read field `name`, falling back to e.g. Ydefault/IDefault files."""
        if self.has_field(name, time):
            return self.field(name, time)
        f = self.field(default_name, time)
        f.name = name
        return f


def _time_name(t: float) -> str:
    if t == int(t):
        return str(int(t))
    return f"{t:.6g}"
