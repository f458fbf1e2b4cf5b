"""RTI sprinkler-link probes (reference lib/rtiProbes/rtis.C).

The port of firefoam_tpu/functionobjects/rtis.py. Each probe samples the
gas T and |U| at a fixed point and integrates the RTI/C-factor link ODE
every step (rtis.C:634-637):

    dTe = √|U|/RTI · (ΔT_gas − (1 + C/√|U|)·ΔTe_old) · Δt

recording the activation time when Te crosses activationTemperature. The
probe state lives in the step state and advances on the device
(`advance`); `record` and `write` keep the rows and the rtis.dat file on the
host, master-only (rtis.C:289-349).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..io.foamdict import FoamDict, parse_file
from ..io.master import is_master

__all__ = ["RtiProbes"]


class RtiProbes:
    """All rti probes of a case, from an rtisDict-style dict."""

    def __init__(self, solver, d: FoamDict):
        self.solver = solver
        g = solver.geom
        locs = [np.asarray(p, float) for p in d.get_list("rtiLocations", [])]
        # patchRtis (lib/rtiProbes/patchRtis.H): probes snapped to the
        # nearest face of patchName, sampling the boundary field there
        self.patch_name = str(d.lookup("patchName", "")) if (
            str(d.lookup("type", "rtis")) == "patchRtis" or d.found("patchName")
        ) else ""
        if self.patch_name:
            pch = next((p for p in g.patches if p.name == self.patch_name), None)
            if pch is None:
                raise ValueError(f"patchRtis: patch '{self.patch_name}' not found")
            Cf = g.b_Cf.detach().cpu().numpy().astype(np.float64)[pch.slice]
            self.b_faces = np.asarray(
                [pch.slice.start + int(np.argmin(np.sum((Cf - p) ** 2, axis=1))) for p in locs],
                np.int64,
            )
            self.cells = g.b_own.cpu().numpy()[self.b_faces]
        else:
            self.b_faces = None
            C = g.C.detach().cpu().numpy().astype(np.float64)
            self.cells = np.asarray(
                [int(np.argmin(np.sum((C - p) ** 2, axis=1))) for p in locs], np.int64
            )
        self.n = len(self.cells)
        self.RTI = d.get_scalar("RTI", 200.0)
        self.C = d.get_scalar("C", 0.0)
        self.T0 = d.get_scalar("initialTemperature", 298.0)
        self.T_act = d.get_scalar("activationTemperature", 400.0)
        self.rows: List[list] = []
        self._at = torch.as_tensor(self.b_faces if self.b_faces is not None else self.cells,
                                   device=g.device)

    @classmethod
    def try_from_case(cls, solver, case_dir: str) -> Optional["RtiProbes"]:
        for sub in ("system", "constant"):
            p = os.path.join(case_dir, sub, "rtisDict")
            if os.path.isfile(p):
                return cls(solver, parse_file(p, case_dir=case_dir))
        return None

    # ------------------------------------------------------- device part
    def initial_state(self) -> Dict[str, torch.Tensor]:
        kw = dict(dtype=self.solver.dtype, device=self.solver.device)
        return {"Te": torch.full((self.n,), self.T0, **kw),
                "t_act": torch.full((self.n,), -1.0, **kw)}

    def advance(self, rti_state: Dict, state) -> Dict[str, torch.Tensor]:
        """One step of the link ODE (solver/rti.H:34-47)."""
        if self.b_faces is not None:
            Tg = state["T"].b[self._at]
            Ug = torch.sqrt(torch.sum(state["U"].b[self._at] ** 2, dim=1))
        else:
            Tg = state["T"].i[self._at]
            Ug = torch.sqrt(torch.sum(state["U"].i[self._at] ** 2, dim=1))
        squ = torch.sqrt(torch.clamp(Ug, min=1e-6))
        dTe_old = rti_state["Te"] - self.T0
        dTe = squ / self.RTI * ((Tg - self.T0) - (1.0 + self.C / squ) * dTe_old) * state["dt"]
        Te = rti_state["Te"] + dTe
        newly = (Te >= self.T_act) & (rti_state["t_act"] < 0.0)
        return {"Te": Te, "t_act": torch.where(newly, state["t"], rti_state["t_act"])}

    # --------------------------------------------------------- host part
    def record(self, t: float, rti_state):
        self.rows.append([t] + np.asarray(rti_state["Te"]).tolist()
                         + np.asarray(rti_state["t_act"]).tolist())

    def write(self, out_dir: str, start_time: str = "0"):
        if not self.rows or not is_master():
            return
        d = os.path.join(out_dir, "rtis", start_time)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "rtis.dat"), "w") as f:
            f.write(f"# rtis: RTI={self.RTI} C={self.C} Tact={self.T_act}; "
                    f"columns: t Te[0..{self.n - 1}] tAct[0..{self.n - 1}]\n")
            for row in self.rows:
                f.write("\t".join(f"{x:.8g}" for x in row) + "\n")
