"""Cell-wise sprinkler-link RTI fields (solver/rti.H:1-73, createRTI.H).

The port of firefoam_tpu/functionobjects/rtilinks.py. The reference
carries 5 independent link models as volFields: each link's element
temperature responds to the local gas state by

    dTe += sqrt(|U|)/RTI · (ΔTg − (1 + C/(sqrt(|U|)+SMALL))·dTe) · Δt
    Tlink = T0 + dTe

and tAct records the earliest time Tlink crossed the link's activation
temperature (default 1e3 s = never). Parameters come from
constant/rtiProperties (active, RTIn, Cn, Tactn). Here the state is two
[5, nCells] tensors updated by one broadcast per step.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["RTILinks"]

_SMALL = 1e-15
_T0 = 298.15
_NEVER = 1e3


class RTILinks:
    """The 5-link cell-wise RTI model; inactive unless the case has an
    `active true` constant/rtiProperties."""

    n_links = 5

    def __init__(self, case, n_cells: int, dtype, device):
        self.active = False
        self.n_cells = n_cells
        self.dtype = dtype
        self.device = device
        if not case.has_constant("rtiProperties"):
            return
        d = case.constant("rtiProperties")
        self.active = bool(d.get_bool("active", False))
        kw = dict(dtype=dtype, device=device)
        self.rti = torch.as_tensor(
            np.array([d.get_scalar(f"RTI{i}", 1.0) for i in range(1, 6)])[:, None], **kw)
        self.C = torch.as_tensor(
            np.array([d.get_scalar(f"C{i}", 1.0) for i in range(1, 6)])[:, None], **kw)
        self.t_act = torch.as_tensor(
            np.array([d.get_scalar(f"Tact{i}", 298.0) for i in range(1, 6)])[:, None], **kw)

    def initial_state(self) -> Dict[str, torch.Tensor]:
        kw = dict(dtype=self.dtype, device=self.device)
        return {"dTe": torch.zeros((self.n_links, self.n_cells), **kw),
                "tAct": torch.full((self.n_links, self.n_cells), _NEVER, **kw)}

    def advance(self, st: Dict, T_i, U_i, t, dt) -> Dict[str, torch.Tensor]:
        """One rti.H update: all 5 links in a single broadcast."""
        dTg = T_i - _T0
        su = torch.sqrt(torch.linalg.norm(U_i, dim=1))
        dTe = st["dTe"]
        dTe = (su[None] / self.rti * (dTg[None] - (1.0 + self.C / (su[None] + _SMALL)) * dTe) * dt
               + dTe)
        fired = _T0 + dTe >= self.t_act
        tAct = torch.where(fired, torch.minimum(st["tAct"], t), st["tAct"])
        return {"dTe": dTe, "tAct": tAct}

    def fields(self, st: Dict) -> Dict[str, torch.Tensor]:
        """Tlink1..5 / tAct1..5 volFields for the writer."""
        out = {}
        for i in range(self.n_links):
            out[f"Tlink{i + 1}"] = _T0 + st["dTe"][i]
            out[f"tAct{i + 1}"] = st["tAct"][i]
        return out
