"""fvOptions (finite-volume options) — the used subset.

The port of firefoam_tpu/models/fvoptions.py. OpenFOAM's fv::optionList
hooks into the equations of the solver (UEqn.H:31 fvOptions(rho,U),
YEEqn.H:101 fvOptions(rho,h)); the types relevant to fire modelling are:

  radiation                  fv::radiation: the solver already couples
                             radiation->Sh into the energy equation; the
                             option is parsed and validated only.
  scalarSemiImplicitSource   explicit/implicit volumetric sources Su + Sp·ψ
                             for scalar fields (h, k, species).
  vectorSemiImplicitSource   the same for U.
  fixedTemperatureConstraint parsed into `constrain_T`, which the step does
                             not call (as in the JAX step).

Each option becomes a per-cell 0/1 mask tensor at construction (selectionMode all,
or a cellZone; an entry whose zone the mesh lacks is skipped); applying it
is one multiply-add in the owning equation.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import small
from ..io.foamdict import FoamDict, parse_file

__all__ = ["FvOptions"]


@dataclass
class _SemiImplicitSource:
    name: str
    mask: torch.Tensor  # [nC] 0/1 zone mask, on the mesh's device
    volume_mode: str  # absolute | specific
    zone_volume: float
    # per-field (Su, Sp) pairs
    sources: Dict[str, Tuple[object, float]] = field(default_factory=dict)


@dataclass
class _FixedTemperature:
    name: str
    mask: torch.Tensor
    T_target: float


class FvOptions:
    """Parsed system/fvOptions (or constant/fvOptions); source hooks per
    equation."""

    def __init__(self, case_dir: str, geom, cell_zones=None):
        self.geom = geom
        self.semi: List[_SemiImplicitSource] = []
        self.fixed_T: List[_FixedTemperature] = []
        self.radiation = False
        path = os.path.join(case_dir, "system", "fvOptions")
        if not os.path.isfile(path):
            path = os.path.join(case_dir, "constant", "fvOptions")
        if not os.path.isfile(path):
            return
        d = parse_file(path, case_dir=case_dir)
        zones = cell_zones or {}
        V = geom.V.detach().cpu().numpy().astype(np.float64)
        for name, od in d.subdicts():
            if name == "FoamFile":
                continue
            kind = od.get_word("type", "")
            if kind == "radiation":
                self.radiation = True
                continue
            mask = np.zeros(geom.n_cells)
            if od.get_word("selectionMode", "all") == "cellZone":
                zone = zones.get(str(od.lookup("cellZone", "")))
                if zone is None:
                    continue
                mask[np.asarray(zone)] = 1.0
            else:
                mask[:] = 1.0
            zvol = float((mask * V).sum())
            mask = torch.as_tensor(mask, dtype=geom.dtype, device=geom.device)
            if kind in ("scalarSemiImplicitSource", "vectorSemiImplicitSource"):
                src = _SemiImplicitSource(name, mask, od.get_word("volumeMode", "absolute"), zvol)
                inj = od.get_dict("injectionRateSuSp", FoamDict())
                for fname in inj:
                    v = inj.lookup(fname, None)
                    # entries: field (Su Sp); vector: ((ux uy uz) Sp)
                    if isinstance(v, list) and len(v) >= 2:
                        src.sources[fname] = (v[0], float(v[1]))
                self.semi.append(src)
            elif kind == "fixedTemperatureConstraint":
                self.fixed_T.append(
                    _FixedTemperature(name, mask, od.get_scalar("temperature", 298.15))
                )

    @property
    def active(self) -> bool:
        return bool(self.semi or self.fixed_T or self.radiation)

    def source(self, fname: str, psi_i: torch.Tensor, dtype):
        """(Su, Sp): the explicit and implicit volumetric source pair for
        field `fname`, zeros when no option touches it. volumeMode absolute
        divides the dict rate by the zone volume (fv::SemiImplicitSource)."""
        nC = self.geom.n_cells
        is_vec = psi_i.ndim == 2
        kw = dict(dtype=dtype, device=self.geom.device)
        Su = torch.zeros((nC, 3) if is_vec else (nC,), **kw)
        Sp = torch.zeros(nC, **kw)
        for s in self.semi:
            if fname not in s.sources:
                continue
            su_raw, sp_raw = s.sources[fname]
            scale = (1.0 / max(s.zone_volume, small(torch.float64))
                     if s.volume_mode == "absolute" else 1.0)
            m = s.mask.to(dtype)
            if is_vec:
                su_v = torch.as_tensor(np.asarray(su_raw, np.float64), **kw)
                Su = Su + m[:, None] * su_v[None, :] * scale
            else:
                Su = Su + m * float(su_raw) * scale
            Sp = Sp + m * float(sp_raw) * scale
        return Su, Sp

    def constrain_T(self, T_i: torch.Tensor) -> torch.Tensor:
        """fixedTemperatureConstraint: hard clamp inside the zones."""
        out = T_i
        for c in self.fixed_T:
            m = c.mask.to(T_i.dtype)
            out = out * (1.0 - m) + m * c.T_target
        return out
