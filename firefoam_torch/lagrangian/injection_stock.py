"""Stock injection submodels beyond the cone/patch/sprinkler families.

The port of firefoam_tpu/lagrangian/injection_stock.py. Reference:
packages/lagrangian/intermediateNew/submodels/Kinematic/InjectionModel/
{ManualInjection,CellZoneInjection,FieldActivatedInjection,
KinematicLookupTableInjection,ConeNozzleInjection,InflationInjection,
NoInjection} and the Thermo/Reacting/ReactingMultiphase lookup-table
variants. Each follows the InjectionModel contract: parcels to inject over
(time0, time1], positions + velocity + diameter per parcel.

One-shot models (Manual/CellZone) burst their whole parcel list in the step
that crosses SOI: their capacity is the list's length and the burst is a
masked write into the parcel pool, the crossing a device mask (no host
read). FieldActivated evaluates its gate per injector position each step,
also as a mask. Random draws come from `prng` (the JAX package's generator
bit for bit), in the JAX package's order; CellZone and Inflation place
their parcels with the host's numpy generator from a fixed seed, as the
JAX package does.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import INT_DTYPE, small
from ..io.foamdict import FoamDict
from . import prng
from .injection import ConeInjection, InjectorBase, _constant_profile, _make_size_sampler

__all__ = [
    "read_vector_field_file", "ManualInjection", "CellZoneInjection",
    "FieldActivatedInjection", "KinematicLookupTableInjection",
    "ThermoLookupTableInjection", "ReactingLookupTableInjection",
    "ReactingMultiphaseLookupTableInjection", "ConeNozzleInjection",
    "InflationInjection", "NoInjection",
]

_PI = math.pi
_SMALL = 1e-300  # the JAX package's guard in its float64 runs


def _strip(txt: str) -> str:
    txt = re.sub(r"/\*.*?\*/", "", txt, flags=re.S)
    txt = re.sub(r"//.*", "", txt)
    return re.sub(r"FoamFile\s*\{[^}]*\}", "", txt)


def read_vector_field_file(path: str) -> np.ndarray:
    """Parse an OpenFOAM vectorField file (positionsFile): a bare list of
    '(x y z)' entries, optionally preceded by a FoamFile header and count."""
    with open(path) as f:
        txt = _strip(f.read())
    vecs = re.findall(r"\(\s*([0-9eE+.\-]+)\s+([0-9eE+.\-]+)\s+([0-9eE+.\-]+)\s*\)", txt)
    return np.asarray(vecs, float)


def _f64(v, like: torch.Tensor) -> torch.Tensor:
    """A float64 scalar tensor on `like`'s device (the JAX package's
    default-dtype masses; two Python numbers in torch.where make float32)."""
    return torch.tensor(float(v), dtype=torch.float64, device=like.device)


class _BurstInjector(InjectorBase):
    """Common one-shot machinery: all parcels fire in the step crossing SOI."""

    def __init__(self, name, soi, positions, cells, U0, mass_total, size_d, dtype, device):
        super().__init__(name, soi, 0.0)
        self.dtype = dtype
        self.device = device
        self.positions = np.asarray(positions, float)
        self.cells = np.asarray(cells, np.int64)
        self.U0 = np.asarray(U0, float)
        self.mass_total = float(mass_total)
        self.size_sampler = _make_size_sampler(size_d)
        self.n = len(self.positions)

    def capacity_for_dt(self, dt_max: float) -> int:
        return max(1, self.n)

    def inject(self, st: Dict, key, t, dt, gas) -> Tuple[Dict, Dict]:
        dtp, dev = self.dtype, self.device
        cap = self.max_per_step
        fire = (st["n_inj"] == 0) & (t + dt > self.soi)
        idx = torch.arange(cap, dtype=INT_DTYPE, device=dev)
        valid = fire & (idx < self.n)
        pos = np.zeros((cap, 3))
        pos[: self.n] = self.positions[:cap]
        cells = np.zeros(cap, np.int64)
        cells[: self.n] = self.cells[:cap]
        dia = self.size_sampler(key, cap, dev).to(dtp)
        mass_per = self.mass_total / max(self.n, 1)
        st = dict(st)
        st["n_inj"] = st["n_inj"] + torch.where(fire, self.n, 0).to(INT_DTYPE)
        cand = {
            "x": self._c("pos", pos, dtp),
            "U": self._c("U0", self.U0, dtp).expand(cap, 3),
            "d": dia,
            "cell": self._c("cells_pad", cells, INT_DTYPE),
            "valid": valid,
            "mass": torch.where(valid, _f64(mass_per, idx), _f64(0.0, idx)),
        }
        return st, cand


class ManualInjection(_BurstInjector):
    """ManualInjection.H:30-38: parcels at positionsFile positions, all at
    SOI, diameters from the size distribution, velocity U0."""

    def __init__(self, name: str, d: FoamDict, walk, case, dtype):
        pf = str(d.lookup("positionsFile"))
        positions = read_vector_field_file(os.path.join(case.root, "constant", pf))
        cells = np.array([walk.find_cell_host(p) for p in positions])
        keep = cells >= 0
        super().__init__(name, d.get_scalar("SOI", 0.0), positions[keep], cells[keep],
                         d.get_vector("U0"), d.get_scalar("massTotal", 0.0),
                         d.get_dict("sizeDistribution"), dtype, walk.C.device)


class CellZoneInjection(_BurstInjector):
    """CellZoneInjection.H:33-40: numberDensity·V(zone) randomly placed
    parcels in the cellZone, all at SOI, velocity U0."""

    def __init__(self, name: str, d: FoamDict, walk, case, geom, cell_zones, dtype, seed=12):
        zone_name = str(d.lookup("cellZone"))
        zone = cell_zones.get(zone_name)
        if zone is None:
            raise ValueError(f"{name}: cellZone '{zone_name}' not found")
        zone = np.asarray(zone)
        V = geom.V.double().cpu().numpy()[zone]
        n = max(1, int(round(d.get_scalar("numberDensity") * V.sum())))
        rng = np.random.default_rng(seed)
        # cells ∝ volume, uniform positions within each cell's box
        # (CellZoneInjection::setPositions samples tets; boxes agree to cell
        # size on hex meshes)
        pick = rng.choice(len(zone), size=n, p=V / V.sum())
        C = geom.C.double().cpu().numpy()[zone[pick]]
        h = (V[pick] ** (1.0 / 3.0))[:, None]
        positions = C + (rng.random((n, 3)) - 0.5) * h * 0.98
        super().__init__(name, d.get_scalar("SOI", 0.0), positions, zone[pick],
                         d.get_vector("U0"), d.get_scalar("massTotal", 0.0),
                         d.get_dict("sizeDistribution"), dtype, walk.C.device)


class FieldActivatedInjection(InjectorBase):
    """FieldActivatedInjection.H:33-43: injects at each positionsFile
    position whenever factor·referenceField[cell] > thresholdField[cell],
    at most nParcelsPerInjector times per position."""

    def __init__(self, name: str, d: FoamDict, walk, case, dtype):
        super().__init__(name, d.get_scalar("SOI", 0.0), 1e30)
        self.dtype = dtype
        self.device = walk.C.device
        pf = str(d.lookup("positionsFile"))
        positions = read_vector_field_file(os.path.join(case.root, "constant", pf))
        cells = np.array([walk.find_cell_host(p) for p in positions])
        keep = cells >= 0
        self.positions = positions[keep]
        self.cells = cells[keep]
        self.n_pos = len(self.positions)
        self.factor = d.get_scalar("factor", 1.0)
        self.ref_field = d.get_word("referenceField", "p")
        self.thr_field = d.get_word("thresholdField", "pMin")
        self.per_injector = d.get_int("nParcelsPerInjector", 1)
        self.U0 = np.asarray(d.get_vector("U0"), float)
        self.mass_total = d.get_scalar("massTotal", 0.0)
        self.size_sampler = _make_size_sampler(d.get_dict("sizeDistribution"))

    def capacity_for_dt(self, dt_max: float) -> int:
        return max(1, self.n_pos)

    def init_state(self) -> Dict:
        st = super().init_state()
        st["fired"] = torch.zeros(self.n_pos, dtype=INT_DTYPE, device=self.device)
        return st

    def inject(self, st: Dict, key, t, dt, gas) -> Tuple[Dict, Dict]:
        dtp, dev = self.dtype, self.device
        cells = self._c("cells", self.cells, INT_DTYPE)
        ref = gas.get(self.ref_field, gas.get("p"))
        thr = gas.get(self.thr_field)
        if thr is None:
            gate = torch.zeros(self.n_pos, dtype=torch.bool, device=dev)
        else:
            gate = self.factor * ref[cells] > thr[cells]
        can = (st["fired"] < self.per_injector) & gate & (t >= self.soi)
        dia = self.size_sampler(key, self.n_pos, dev).to(dtp)
        mass_per = self.mass_total / max(self.n_pos * self.per_injector, 1)
        st = dict(st)
        st["fired"] = st["fired"] + can.to(INT_DTYPE)
        st["n_inj"] = st["n_inj"] + torch.sum(can).to(INT_DTYPE)
        cand = {
            "x": self._c("positions", self.positions, dtp),
            "U": self._c("U0", self.U0, dtp).expand(self.n_pos, 3),
            "d": dia,
            "cell": cells,
            "valid": can,
            "mass": torch.where(can, _f64(mass_per, cells), _f64(0.0, cells)),
        }
        return st, cand


class KinematicLookupTableInjection(InjectorBase):
    """KinematicLookupTableInjection.H:33-45: per-injector (x, U, d, rho,
    mDot) rows from the kinematicParcelInjectionData table in constant/,
    steady injection over the duration."""

    def __init__(self, name: str, d: FoamDict, walk, case, dtype):
        super().__init__(name, d.get_scalar("SOI", 0.0), d.get_scalar("duration"))
        self.dtype = dtype
        self.device = walk.C.device
        rows = self._read_table(os.path.join(case.root, "constant", str(d.lookup("inputFile"))))
        self.positions = np.asarray([r[0] for r in rows])
        self.U_rows = np.asarray([r[1] for r in rows])
        self.d_rows = np.asarray([r[2] for r in rows])
        self.rho_rows = np.asarray([r[3] for r in rows])
        self.mdot_rows = np.asarray([r[4] for r in rows])
        self.cells = np.array([walk.find_cell_host(p) for p in self.positions])
        self.pps = d.get_scalar("parcelsPerSecond")
        self.n_pos = len(rows)

    @staticmethod
    def _read_table(path: str):
        """Rows: ((x y z) (ux uy uz) d rho mDot)."""
        with open(path) as f:
            txt = _strip(f.read())
        num = r"[0-9eE+.\-]+"
        pat = re.compile(
            r"\(\s*\(\s*(%s)\s+(%s)\s+(%s)\s*\)\s*"
            r"\(\s*(%s)\s+(%s)\s+(%s)\s*\)\s*"
            r"(%s)\s+(%s)\s+(%s)\s*\)" % ((num,) * 9)
        )
        rows = []
        for m in pat.finditer(txt):
            v = [float(x) for x in m.groups()]
            rows.append((v[0:3], v[3:6], v[6], v[7], v[8]))
        if not rows:
            raise ValueError(f"no kinematicParcelInjectionData rows in {path}")
        return rows

    def capacity_for_dt(self, dt_max: float) -> int:
        return max(self.n_pos, int(math.ceil(self.pps * dt_max)) + 1)

    def _rows(self, st, valid):
        """The table rows of this step's candidates (the parent advanced
        n_inj by the valid ones)."""
        idx = torch.arange(valid.shape[0], dtype=INT_DTYPE, device=valid.device)
        return (st["n_inj"] - torch.sum(valid.to(INT_DTYPE)) + idx) % self.n_pos

    def inject(self, st: Dict, key, t, dt, gas) -> Tuple[Dict, Dict]:
        dtp, dev = self.dtype, self.device
        cap = self.max_per_step
        el0 = torch.clamp(t - self.soi, 0.0, self.duration)
        el1 = torch.clamp(t + dt - self.soi, 0.0, self.duration)
        want = torch.floor(el1 * self.pps).to(INT_DTYPE) - st["n_inj"]
        n_new = torch.clamp(want, 0, cap)
        idx = torch.arange(cap, dtype=INT_DTYPE, device=dev)
        valid = idx < n_new
        row = (st["n_inj"] + idx) % self.n_pos
        # per-row mass rate share over the firing window
        mdot_rows = self._c("mdot", self.mdot_rows, dtp)
        mdot = mdot_rows[row]
        owed = st["m_owed"] + torch.sum(mdot_rows) * (el1 - el0)
        w = mdot / torch.clamp(torch.sum(torch.where(valid, mdot, torch.zeros_like(mdot))),
                               min=small(dtp))
        st = {
            "n_inj": st["n_inj"] + n_new,
            "m_owed": torch.where(n_new > 0, torch.zeros_like(owed), owed),
        }
        cand = {
            "x": self._c("positions", self.positions, dtp)[row],
            "U": self._c("U_rows", self.U_rows, dtp)[row],
            "d": self._c("d_rows", self.d_rows, dtp)[row],
            "cell": self._c("cells", self.cells, INT_DTYPE)[row],
            "valid": valid,
            "mass": torch.where(valid, owed * w, torch.zeros_like(owed * w)),
        }
        return st, cand


def _parse_nested(path: str):
    """Parse an OpenFOAM parcel-injection-data file into nested float
    lists (comments/FoamFile headers stripped, list-size counts kept as
    numbers, words dropped)."""
    with open(path) as f:
        txt = _strip(f.read())
    stack = [[]]
    for tok in re.findall(r"[()]|[^\s();]+", txt):
        if tok == "(":
            stack.append([])
        elif tok == ")":
            v = stack.pop()
            stack[-1].append(v)
        else:
            try:
                stack[-1].append(float(tok))
            except ValueError:
                pass  # words (class names, identifiers)
    return stack[0]


def _find_rows(tree, min_scalars: int):
    """Injection rows: lists starting with two 3-vectors followed by
    >= min_scalars scalars ((x y z) (ux uy uz) d rho mDot [T cp] ...)."""

    def is_vec3(v):
        return isinstance(v, list) and len(v) == 3 and all(isinstance(e, float) for e in v)

    rows = []

    def visit(node):
        if not isinstance(node, list):
            return
        if (len(node) >= 2 + min_scalars and is_vec3(node[0]) and is_vec3(node[1])
                and all(isinstance(e, float) for e in node[2:2 + min_scalars])):
            rows.append(node)
            return
        for e in node:
            visit(e)

    visit(tree)
    return rows


def _table_rows(path: str, min_len: int, what: str):
    rows = [r for r in _find_rows(_parse_nested(path), 5)
            if len(r) >= min_len and isinstance(r[5], float) and isinstance(r[6], float)]
    if not rows:
        raise ValueError(f"no {what} rows in {path}")
    return rows


class ThermoLookupTableInjection(KinematicLookupTableInjection):
    """ThermoLookupTableInjection.H:33-45: kinematic rows extended with
    per-parcel T and cp (thermoParcelInjectionDataIO.C: ((x) (U) d rho mDot
    T cp)). T and cp seed the parcel temperature and heat capacity
    (setParcelProperties → ThermoParcel T_/Cp_)."""

    @staticmethod
    def _read_table(path: str):
        return [tuple(r[:7]) for r in _table_rows(path, 7, "thermoParcelInjectionData")]

    def __init__(self, name: str, d: FoamDict, walk, case, dtype):
        super().__init__(name, d, walk, case, dtype)
        rows = self._read_table(os.path.join(case.root, "constant", str(d.lookup("inputFile"))))
        self.T_rows = np.asarray([r[5] for r in rows])
        self.cp_rows = np.asarray([r[6] for r in rows])

    def inject(self, st, key, t, dt, gas):
        st, cand = super().inject(st, key, t, dt, gas)
        row = self._rows(st, cand["valid"])
        cand = dict(cand)
        cand["T"] = self._c("T_rows", self.T_rows, self.dtype)[row]
        cand["cp"] = self._c("cp_rows", self.cp_rows, self.dtype)[row]
        return st, cand


class ReactingLookupTableInjection(ThermoLookupTableInjection):
    """ReactingLookupTableInjection.H:33-45: thermo rows + a per-parcel
    composition list (reactingParcelInjectionDataIO.C: ((x) (U) d rho mDot
    T cp (Y...))). Y is the phase-mixture split in the composition dict's
    phase order (gas, liquid, solid, of those present); the cloud seeds the
    parcel's n-phase ledger (mv/ms lanes) from it."""

    @staticmethod
    def _read_table(path: str):
        out = []
        for r in _table_rows(path, 8, "reactingParcelInjectionData"):
            lists = [e for e in r[7:] if isinstance(e, list)]
            out.append(tuple(r[:7]) + (lists[0] if lists else [1.0],))
        return out

    def __init__(self, name: str, d: FoamDict, walk, case, dtype):
        super().__init__(name, d, walk, case, dtype)
        rows = self._read_table(os.path.join(case.root, "constant", str(d.lookup("inputFile"))))
        nY = max(len(r[7]) for r in rows)
        Y = np.zeros((len(rows), nY))
        for i, r in enumerate(rows):
            Y[i, : len(r[7])] = r[7]
        self.Y_rows = Y / np.maximum(Y.sum(1, keepdims=True), 1e-300)

    def inject(self, st, key, t, dt, gas):
        st, cand = super().inject(st, key, t, dt, gas)
        cand = dict(cand)
        cand["Yphase"] = self._c("Y_rows", self.Y_rows, self.dtype)[self._rows(st, cand["valid"])]
        return st, cand


class ReactingMultiphaseLookupTableInjection(ReactingLookupTableInjection):
    """ReactingMultiphaseLookupTableInjection.H:33-45: reacting rows +
    within-phase component splits (reactingMultiphaseParcelInjectionDataIO.C:
    ((x) (U) d rho mDot T cp (Y) (YGas) (YLiquid) (YSolid)))."""

    @staticmethod
    def _read_table(path: str):
        out = []
        for r in _table_rows(path, 8, "reactingMultiphaseParcelInjectionData"):
            lists = [e for e in r[7:] if isinstance(e, list)]
            while len(lists) < 4:
                lists.append([1.0])
            out.append(tuple(r[:7]) + tuple(lists[:4]))
        return out

    def __init__(self, name: str, d: FoamDict, walk, case, dtype):
        super().__init__(name, d, walk, case, dtype)
        rows = self._read_table(os.path.join(case.root, "constant", str(d.lookup("inputFile"))))

        def pack(col):
            nW = max(len(r[col]) for r in rows)
            M = np.zeros((len(rows), nW))
            for i, r in enumerate(rows):
                M[i, : len(r[col])] = r[col]
            return M / np.maximum(M.sum(1, keepdims=True), 1e-300)

        self.Ygas_rows = pack(8)
        self.Yliq_rows = pack(9)
        self.Ysol_rows = pack(10)

    def inject(self, st, key, t, dt, gas):
        st, cand = super().inject(st, key, t, dt, gas)
        row = self._rows(st, cand["valid"])
        cand = dict(cand)
        cand["YGas"] = self._c("Ygas", self.Ygas_rows, self.dtype)[row]
        cand["YLiquid"] = self._c("Yliq", self.Yliq_rows, self.dtype)[row]
        cand["YSolid"] = self._c("Ysol", self.Ysol_rows, self.dtype)[row]
        return st, cand


class ConeNozzleInjection(ConeInjection):
    """ConeNozzleInjection.H:33-57: a cone spray from a disc nozzle — like
    ConeInjection but one position with start points spread over the
    nozzle annulus (outerDiameter/innerDiameter) and, without Umag, the
    flow-rate velocity Umag = ṁ/(ρ·Cd·A) (flowRateAndDischarge)."""

    def __init__(self, name: str, d: FoamDict, walk, dtype):
        dd = FoamDict(d)
        pos = d.get_vector("position")
        axis = d.get_vector("direction")
        dd["positionAxis"] = [[list(pos), list(axis)]]
        if not d.found("Umag"):
            # flowRateAndDischarge: U = ṁ/(ρ·Cd·A_outer)
            do = d.get_scalar("outerDiameter")
            di = d.get_scalar("innerDiameter", 0.0)
            A = _PI / 4.0 * (do ** 2 - di ** 2)
            Cd = _constant_profile(d, "Cd") if d.found("Cd") else 0.9
            rho_l = d.get_scalar("rhoInjection", 1000.0)
            mdot = d.get_scalar("massTotal", 0.0) / max(d.get_scalar("duration"), _SMALL)
            dd["Umag"] = mdot / (rho_l * Cd * A)
        super().__init__(name, dd, walk, dtype)
        self.outer_d = d.get_scalar("outerDiameter")
        self.inner_d = d.get_scalar("innerDiameter", 0.0)

    def inject(self, st, key, t, dt, gas):
        key, kd = prng.split(key)
        st, cand = super().inject(st, key, t, dt, gas)
        # spread the start positions over the nozzle disc
        dtp, dev = self.dtype, self.device
        cap = cand["x"].shape[0]
        k1, k2 = prng.split(kd)
        r = torch.sqrt(prng.uniform(k1, cap, dtp, device=dev)
                       * ((self.outer_d / 2) ** 2 - (self.inner_d / 2) ** 2)
                       + (self.inner_d / 2) ** 2)
        beta = prng.uniform(k2, cap, dtp, device=dev) * 2 * _PI
        e1 = self._c("disc_e1", self.frames[0, 0], dtp)
        e2 = self._c("disc_e2", self.frames[0, 1], dtp)
        offs = r[:, None] * (torch.cos(beta)[:, None] * e1 + torch.sin(beta)[:, None] * e2)
        cand = dict(cand)
        cand["x"] = cand["x"] + offs
        return st, cand


class NoInjection(InjectorBase):
    """NoInjection.H: a place-holder that injects nothing."""

    def __init__(self, name: str, d: FoamDict, dtype, device):
        super().__init__(name, 0.0, 0.0)
        self.dtype = dtype
        self.device = device

    def capacity_for_dt(self, dt_max: float) -> int:
        return 1

    def inject(self, st, key, t, dt, gas):
        kw = dict(dtype=self.dtype, device=self.device)
        cand = {
            "x": torch.zeros((1, 3), **kw),
            "U": torch.zeros((1, 3), **kw),
            "d": torch.full((1,), 1e-6, **kw),
            "cell": torch.zeros((1,), dtype=INT_DTYPE, device=self.device),
            "valid": torch.zeros((1,), dtype=torch.bool, device=self.device),
            "mass": torch.zeros((1,), **kw),
        }
        return st, cand


class InflationInjection(InjectorBase):
    """InflationInjection.H:33-47 (the subset used): parcels appear in the
    'generation' cellZone at the volume flow rate of the flowRate
    TimeFunction1, their diameters growing from dSeed toward the size
    distribution at growthRate. The reference seeds from EXISTING parcels;
    this keeps the injection-rate contract (volume accounting and
    growth-limited diameters), which is what the solver couples to."""

    def __init__(self, name: str, d: FoamDict, walk, case, geom, cell_zones, dtype, seed=13):
        super().__init__(name, d.get_scalar("SOI", 0.0), d.get_scalar("duration"))
        self.dtype = dtype
        self.device = walk.C.device
        zone_name = str(d.lookup("generationCellZone", d.lookup("cellZone", "")))
        zone = cell_zones.get(zone_name)
        if zone is None:
            raise ValueError(f"{name}: cellZone '{zone_name}' not found")
        zone = np.asarray(zone)
        self.zone = zone
        self.flow_rate = _constant_profile(d, "flowRate")  # m³/s
        self.growth_rate = _constant_profile(d, "growthRate")  # m/s
        self.d_seed = d.get_scalar("dSeed", 1e-4)
        self.pps = d.get_scalar("parcelsPerSecond", 1000.0)
        self.size_sampler = _make_size_sampler(d.get_dict("sizeDistribution"))
        rng = np.random.default_rng(seed)
        V = geom.V.double().cpu().numpy()[zone]
        n_prep = 4096
        pick = rng.choice(len(zone), size=n_prep, p=V / V.sum())
        C = geom.C.double().cpu().numpy()[zone[pick]]
        h = (V[pick] ** (1.0 / 3.0))[:, None]
        self.prep_pos = C + (rng.random((n_prep, 3)) - 0.5) * h * 0.98
        self.prep_cells = zone[pick]
        self.rho_ref = d.get_scalar("rhoInjection", 1000.0)

    def capacity_for_dt(self, dt_max: float) -> int:
        return max(1, int(math.ceil(self.pps * dt_max)) + 1)

    def inject(self, st: Dict, key, t, dt, gas) -> Tuple[Dict, Dict]:
        dtp, dev = self.dtype, self.device
        cap = self.max_per_step
        el0 = torch.clamp(t - self.soi, 0.0, self.duration)
        el1 = torch.clamp(t + dt - self.soi, 0.0, self.duration)
        want = torch.floor(el1 * self.pps).to(INT_DTYPE) - st["n_inj"]
        n_new = torch.clamp(want, 0, cap)
        vol_new = self.flow_rate * (el1 - el0)
        idx = torch.arange(cap, dtype=INT_DTYPE, device=dev)
        valid = idx < n_new
        row = (st["n_inj"] + idx) % self.prep_pos.shape[0]
        ks = prng.split(key, 2)
        d_tgt = self.size_sampler(ks[0], cap, dev).to(dtp)
        # growth-limited: d = min(dSeed + growthRate·age since SOI, d_target)
        dia = torch.minimum(self.d_seed + self.growth_rate * el1, d_tgt)
        owed = st["m_owed"] + vol_new * self.rho_ref
        mass_per = torch.where(n_new > 0, owed / torch.clamp(n_new, min=1), torch.zeros_like(owed))
        st = {
            "n_inj": st["n_inj"] + n_new,
            "m_owed": torch.where(n_new > 0, torch.zeros_like(owed), owed),
        }
        cand = {
            "x": self._c("prep_pos", self.prep_pos, dtp)[row],
            "U": torch.zeros((cap, 3), dtype=dtp, device=dev),
            "d": dia.to(dtp),
            "cell": self._c("prep_cells", self.prep_cells, INT_DTYPE)[row],
            "valid": valid,
            "mass": torch.where(valid, mass_per, torch.zeros_like(mass_per)),
        }
        return st, cand
