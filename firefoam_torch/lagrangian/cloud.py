"""Reacting spray cloud: fixed-capacity SoA parcels, eager tensor ops.

The port of firefoam_tpu/lagrangian/cloud.py (the reference's
KinematicCloud → ThermoCloud → ReactingCloud stack, packages/lagrangian/
intermediateNew/clouds/Templates/*). Instead of linked parcel lists with
per-parcel virtual calls, the cloud is one struct-of-arrays dict with a
static capacity and an alive mask. One `evolve(state, gas, dt)` performs
(KinematicCloud::solve/evolveCloud, KinematicCloud.C:91-245):

  1. injection (bounded candidate batches scattered into free slots),
  2. n_sub substeps of { ballistic move + containment walk + physics calc },
  3. source accumulation into per-cell arrays (rhoTrans/UTrans/hsTrans —
     KinematicCloud.H:467-515, ThermoCloud.H:362-388, ReactingCloud.H:
     245-260) by order-fixed segment sums (tracking.CellSum: a stable sort
     of the parcels by cell, then a segmented reduction — reproducible on
     the card, where an index_add_ adds with atomics).

Physics per substep (ReactingParcel.C:389-607 / ThermoParcel.C:137-255 /
KinematicParcel.C:96-226): the particle force list (sphere drag +
gravity/buoyancy, Euler or analytical), Ranz-Marshall heat transfer with
the Bird correction, liquid evaporation/boiling (LiquidEvaporationBoil,
per component for multi-liquid sprays), the spray's radiation
accumulators. Wall interaction happens inside the walk (tracking.py).

Random draws come from `st["rng"]` through `prng` (JAX's generator bit for
bit), split in the JAX package's order, so both packages inject and thin
the same parcels. Nothing here reads the card on the host except `info`
(and, partitioned, the migration's count of parcels in halo cells).

The surface-film handoff (surfaceFilmModel thermoSurfaceFilm): parcels
striking film faces are absorbed, or splash or bounce by the Bai-Gosman
regimes (interactionType splashBai), and their mass and enthalpy go to the
film through order-fixed parcel→face sums.

The stock submodels: the n-phase ledger with devolatilisation
(devolatilisation.py: `mv`/`mv0`/`ms` lanes, the devolatilised mass to each
volatile's own species through src["dvTrans"]), MPPIC's packing, damping
and isotropy at the step's end (mppic.py; its draw splits st["rng"] after
the substeps) and DEM pair collision (paircollision.py, `st["pc"]`; its
sub-cycles replace the ballistic pre-move). The volatile mass rides on top
of the liquid sphere that `_mass` counts, so it keeps a ledger of its own:
the sources log the volatiles injected, devolatilised and carried out by
parcels that leave the cloud.

Partitioned (`part`, a parallel.localize.PartInfo): `walk` is the
partition's WalkMesh over its [owned ‖ halo] cells and the injectors are
built over the GLOBAL walk (`inj_walk`): every rank draws the same parcels
with the same key and keeps those in cells it owns. A parcel whose walk
stops in a halo slot has left the partition: before the physics of each
substep it moves to the owning rank (parallel/parcels.exchange_parcels, the
reference's switchProcessor handoff), which finishes its walk, in as many
rounds as the crossings and the send capacity need; `info` reduces over the
ranks. The DEM pair collision keeps its records on one
partition: a partitioned cloud with it raises.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import INT_DTYPE, small
from ..io.foamdict import FoamDict
from . import prng
from .collector import make_collectors
from .cloudfunctions import make_cloud_functions
from .devolatilisation import Devolatilisation, PhaseLedger, parse_phases
from .forces import ParticleForces, _sphere_cdre
from .injection import make_injector
from .liquids import LiquidMixture, liquid_by_name
from .mppic import MPPIC
from .paircollision import PairCollision
from .tracking import (
    INTERACT_ESCAPE,
    INTERACT_FILM,
    INTERACT_REBOUND,
    INTERACT_STICK,
    CellSum,
    WalkMesh,
    cell_sum,
)

__all__ = ["ReactingCloud"]

_PI = math.pi
SIGMA_SB = 5.670367e-8


def _sphere_mass(rho_l, d):
    return rho_l * _PI / 6.0 * d**3


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """x^(1/3), taken in float64. A float32 power takes the exponent as
    float32(1/3) = 0.33333334, which shrinks a spray diameter (x about
    1e-12) by 2.6e-7 and the parcel's mass by three times that, in every
    substep; in float64 this is x ** (1/3) itself."""
    return (x.double() ** (1.0 / 3.0)).to(x.dtype)


@dataclass
class CloudConfig:
    active: bool
    coupled: bool
    capacity: int
    n_sub: int
    walk_steps: int
    # constantProperties
    rho0: float
    T0: float
    cp0: float
    T_min: float
    Tvap: float
    Tbp: float
    Pr: float
    eps0: float  # epsilon0 (radiative emissivity)
    f0: float  # scattering factor
    min_mass: float
    # submodel switches
    drag: bool
    gravity_on: bool
    heat_transfer: bool
    bird_correction: bool
    phase_change: bool
    # source relaxation (sourceTerms schemes <field> explicit <coeff>)
    relax_rho: float
    relax_U: float
    relax_Yi: float
    relax_h: float
    # radiation (ThermoCloud.C:59-130: radiation switch + constRad/diaBanded
    # particle radiative properties, coupledRadiation parcel heating)
    radiation: bool = False
    coupled_radiation: bool = True
    n_bands: int = 1
    # integrationSchemes (solution.integrationSchemes: per-quantity
    # Euler | analytical — IntegrationScheme/Euler.H, Analytical.H)
    scheme_U: str = "Euler"
    scheme_T: str = "analytical"


class ReactingCloud:
    """Host-side cloud model built from constant/<name>Properties."""

    def __init__(
        self,
        name: str,
        props: FoamDict,
        walk: WalkMesh,
        geom,
        case,
        gas,
        g_vec,
        dt_max: float,
        dtype=torch.float64,
        capacity: Optional[int] = None,
        cell_zones=None,
        part=None,
        inj_walk: Optional[WalkMesh] = None,
    ):
        self.name = name
        self.dtype = dtype
        self.device = geom.C.device
        self.walk = walk
        # partition identity (parallel.localize.PartInfo) or None
        self.part = part
        self.geom = geom
        self.gas = gas
        self._g_np = np.asarray(g_vec, np.float64)
        self.g = torch.as_tensor(self._g_np, dtype=dtype, device=self.device)
        self._small = small(dtype)

        sol = props.get_dict("solution")
        cp = props.get_dict("constantProperties")
        sub = props.get_dict("subModels")

        schemes = sol.get_dict("sourceTerms", FoamDict()).get_dict("schemes", FoamDict())

        def relax(key):
            v = schemes.lookup(key, None)
            if isinstance(v, list) and len(v) >= 2:
                return float(v[-1])
            return 1.0

        forces = sub.get_dict("particleForces", FoamDict())
        self.forces = ParticleForces.from_dict(forces)
        htm = sub.get_word("heatTransferModel", "none")
        pcm = sub.get_word("phaseChangeModel", "none")
        ht_coeffs = sub.get_dict("RanzMarshallCoeffs", None) or sub.get_dict(
            "ranzMarshallCoeffs", FoamDict()
        )

        # composition: singlePhaseMixture (one liquid) or the
        # SingleMixtureFraction liquid phase (several liquids with fixed
        # mass fractions — submodels/Reacting/CompositionModel)
        comp = sub.get_dict("singlePhaseMixtureCoeffs", None)
        if comp is None:
            comp = sub.get_dict("singleMixtureFractionCoeffs", FoamDict())
        ph_map = parse_phases(comp)
        liq_entries = list(ph_map.get("liquid", [])) or [("H2O", 1.0)]
        if len(liq_entries) == 1:
            self.liquid = liquid_by_name(liq_entries[0][0])
        else:
            self.liquid = LiquidMixture([n for n, _ in liq_entries], [f for _, f in liq_entries])
        # vapour destination species + fixed split of evaporated mass
        # (Raoult-weighted at T0; per-species YEqn sources use this split)
        self.vapour_names = [n for n, _ in liq_entries if n in gas.species]
        self.vapour_indices = tuple(gas.index(n) for n in self.vapour_names)
        if hasattr(self.liquid, "vapour_split") and len(self.vapour_indices) > 1:
            T0 = torch.tensor(float(cp.get_scalar("T0", 300.0)), dtype=torch.float64)
            split = self.liquid.vapour_split(T0).numpy().reshape(-1)
            self.vapour_fracs = tuple(float(x) for x in split)
        else:
            self.vapour_fracs = (1.0,) * len(self.vapour_indices)
        self.vapour_index = self.vapour_indices[0] if self.vapour_indices else gas.index("H2O")
        # per-parcel multi-component liquid evaporation (ReactingParcel's
        # per-parcel Y over the liquid phase + LiquidEvaporation's
        # per-component vapour pressures, ReactingParcel.C:389-607): active
        # when the mixture has >1 component and each maps to a carrier
        # species; parcels then carry a "Yl" lane and components deplete
        # at their own Raoult rates
        self.n_liq = len(getattr(self.liquid, "components", (None,)))
        self.multi_liq = self.n_liq > 1 and len(self.vapour_indices) == self.n_liq
        if self.multi_liq:
            self._Y0 = torch.as_tensor(np.asarray(self.liquid.Y, np.float64), dtype=dtype,
                                       device=self.device)[None, :]
            self._Wk = torch.tensor(self.liquid.comp_W(), dtype=dtype, device=self.device)

        # ---- n-phase ledger + devolatilisation (ReactingMultiphase) ----
        # (the reference's phaseProperties gas/liquid/solid bookkeeping and
        # DevolatilisationModel submodels; surfaceReactionModel ships only
        # NoSurfaceReaction in the reference, so 'none' is the whole surface)
        self.ledger = PhaseLedger.from_phases(ph_map)
        self.devol = Devolatilisation.from_dict(sub, cp, gas)
        self._liq_frac0 = float(self.ledger.liquid_frac) if self.ledger is not None else 1.0
        if self.devol is not None:
            # volatile fractions of the TOTAL particle mass, volatileData order
            fracs = dict(zip(self.ledger.gas_names, self.ledger.gas_fracs)) if self.ledger else {}
            self._vol_frac0 = np.asarray([float(fracs.get(n, 0.0)) for n in self.devol.names])

        self.cfg = CloudConfig(
            active=sol.get_bool("active", True),
            coupled=sol.get_bool("coupled", True),
            capacity=0,
            n_sub=4,
            walk_steps=5,
            rho0=cp.get_scalar("rho0", 1000.0),
            T0=cp.get_scalar("T0", 300.0),
            cp0=cp.get_scalar("Cp0", 4187.0),
            T_min=cp.get_scalar("TMin", 200.0),
            Tvap=cp.get_scalar("Tvap", 273.0),
            Tbp=cp.get_scalar("Tbp", 373.0),
            Pr=cp.get_scalar("Pr", 0.7),
            eps0=cp.get_scalar("epsilon0", 1.0),
            f0=cp.get_scalar("f0", 0.5),
            min_mass=cp.get_scalar("minParticleMass", 1e-15),
            drag=self.forces.drag_model is not None,
            gravity_on="gravity" in forces or forces.found("gravity"),
            heat_transfer=htm != "none",
            bird_correction=ht_coeffs.get_bool("BirdCorrection", False),
            phase_change=pcm != "none",
            relax_rho=relax("rho"),
            relax_U=relax("U"),
            relax_Yi=relax("Yi"),
            relax_h=relax("h"),
            radiation=sub.get_bool("radiation", False),
            coupled_radiation=sub.get_bool("coupledRadiation", True),
            n_bands=sub.get_int("nBands", 1),
            scheme_U=sol.get_dict("integrationSchemes", FoamDict()).get_word("U", "Euler"),
            scheme_T=sol.get_dict("integrationSchemes", FoamDict()).get_word("T", "analytical"),
        )

        # particle radiative properties (ThermoCloud.C:70-107): constRad =
        # diameter-independent efficiencies; diaBanded = per-diameter tables
        # of absorption/scattering efficiency + asymmetry factor per band
        self.rad_prop = sub.get_word("radiationProperty", "constRad")
        rpc = sub.get_dict(self.rad_prop + "Coeffs", FoamDict())
        nb = self.cfg.n_bands
        if self.cfg.radiation and self.rad_prop == "diaBanded":
            self.rad_dia = np.asarray([float(x) for x in rpc.get_list("diaList")])
            self.rad_qabs = np.asarray(_nested(rpc.lookup("absEfficiency", []), nb))  # [nDia, nB]
            self.rad_qsct = np.asarray(_nested(rpc.lookup("sctEfficiency", []), nb))
            self.rad_asy = np.asarray(_nested(rpc.lookup("asymmetryFactor", []), nb))
        else:
            self.rad_dia = None
            self.rad_qabs = np.full((1, nb), rpc.get_scalar("absEfficiency", 0.5))
            self.rad_qsct = np.full((1, nb), rpc.get_scalar("sctEfficiency", 0.5))
            self.rad_asy = np.zeros((1, nb))

        # injectors
        inj_dict = sub.get_dict("injectionModels", FoamDict())
        self.injectors = [
            make_injector(iname, idict, inj_walk or walk, case, self.dtype, geom=geom,
                          cell_zones=cell_zones)
            for iname, idict in inj_dict.subdicts()
        ]
        for inj in self.injectors:
            inj.max_per_step = inj.capacity_for_dt(dt_max)

        # Courant-derived track substeps (KinematicParcel.C:295 maxCo): the
        # counts are static, so the worst case is sized host-side from the
        # fastest injector and the smallest cell: a parcel must not cross
        # more than ~maxCo cells per physics substep, and the containment
        # walk needs enough hops to resolve every face crossing of one
        # ballistic move.
        max_co = sol.get_scalar("maxCo", 0.3)
        u_est = 0.0
        for inj in self.injectors:
            for attr in ("umag", "u_max", "U_max", "umax"):
                v = getattr(inj, attr, None)
                if v is not None:
                    try:
                        u_est = max(u_est, float(v))
                    except (TypeError, ValueError):
                        pass
        if u_est <= 0.0:
            u_est = 20.0  # sprinkler-class default when tables hide U
        v_min = geom.V.min()
        if part is not None:
            # every rank must size its substeps alike: the global minimum
            v_min = part.pmin(v_min)
        dx_min = float(v_min) ** (1.0 / 3.0)
        self.cfg.n_sub = int(np.clip(math.ceil(u_est * dt_max / (max_co * dx_min) / 8.0), 4, 64))
        self.cfg.walk_steps = int(np.clip(
            math.ceil(u_est * (dt_max / self.cfg.n_sub) / dx_min) + 3, 5, 24))

        # stochastic collision: SuppressionCollision gates combustion of
        # this cloud's parcels by another cloud's spray coverage
        if sub.get_word("stochasticCollisionModel", "none") == "SuppressionCollision":
            from .suppression import SuppressionCollision

            self.suppression = SuppressionCollision.from_dict(sub)
        else:
            self.suppression = None

        # deterministic DEM collisions (CollisionModel/PairCollision):
        # spring-slider-dashpot pair and wall forces, the parcels' omega and
        # records under st["pc"]
        self.pair_collision = PairCollision.from_dict(sub, cp, geom)
        if self.pair_collision is not None and part is not None:
            raise NotImplementedError(
                "partitioned cloud: the DEM pair collision's records are single-partition")

        # cloud function objects: ParticleCollectorFmg (lib/
        # additionalCloudFunctionObjects) and the stock family
        self.collectors = make_collectors(props)
        self.cloud_functions = make_cloud_functions(props, geom)
        # MPPIC dense-phase corrections (packing/damping/isotropy); None
        # unless the cloud dict selects at least one model
        self.mppic = MPPIC.from_dict(sub, self.cfg.rho0)

        # patch interaction (submodels/Kinematic/PatchInteractionModel):
        # the whole family compiles down to per-boundary-face interaction
        # codes + restitution, consumed by the tracking walk.
        #   standardWallInteraction: one type (+e) for every wall patch
        #     (StandardWallInteraction.C:94-150)
        #   localInteraction: per-patch {type, e} entries by patch name
        #   multiInteraction: ordered sub-models, first defined wins per
        #     patch (MultiInteraction.H:33-60 'oneInteractionOnly true')
        #   rebound: every patch rebounds with elasticity e (Rebound.C)
        #   none/noInteraction: parcel halts at the patch — mapped to stick
        b_code, b_e = self._parse_patch_interaction(sub, geom)
        # the surface-film handoff and the Bai-Gosman splash parameters
        # (thermoSurfaceFilmCoeffs, ThermoSurfaceFilmMeredith.C)
        self.film_patches: List[str] = []
        self.has_film_handoff = sub.get_word("surfaceFilmModel", "none") != "none"
        tsf = sub.get_dict("thermoSurfaceFilmCoeffs", FoamDict())
        self.splash_on = tsf.get_word("interactionType", "absorb").startswith("splash")
        self.splash_delta_wet = tsf.get_scalar("deltaWet", 2e-4)
        self.splash_Adry = tsf.get_scalar("Adry", 2630.0)
        self.splash_Awet = tsf.get_scalar("Awet", 1320.0)
        self.b_code = torch.as_tensor(b_code, dtype=INT_DTYPE, device=self.device)
        self.b_e = torch.as_tensor(b_e, dtype=self.dtype, device=self.device)  # rebound elasticity

        # capacity: generous default = what all injectors can make in ~2000 steps
        if capacity is None:
            per_step = sum(i.max_per_step for i in self.injectors) or 1
            capacity = int(min(max(4096, per_step * 2048), 262144))
        self.cfg.capacity = capacity

    # ------------------------------------------------------------------
    @staticmethod
    def _parse_patch_interaction(sub, geom):
        """PatchInteractionModel family → (b_code[int64], b_e[float]) per
        boundary face. See the comment at the call site."""
        code_of = {
            "escape": INTERACT_ESCAPE,
            "stick": INTERACT_STICK,
            "rebound": INTERACT_REBOUND,
            "none": INTERACT_STICK,
        }
        b_code = np.zeros(geom.n_boundary, np.int64)
        b_e = np.ones(geom.n_boundary, float)

        for p in geom.patches:
            if p.ptype in ("patch", "inlet", "outlet"):
                b_code[p.slice] = INTERACT_ESCAPE
            else:
                b_code[p.slice] = INTERACT_REBOUND

        def apply_model(pim, coeffs):
            if pim == "standardWallInteraction":
                it = coeffs.get_word("type", "rebound")
                e = coeffs.get_scalar("e", 1.0)
                for p in geom.patches:
                    if p.ptype in ("wall",):
                        b_code[p.slice] = code_of.get(it, INTERACT_REBOUND)
                        b_e[p.slice] = e
            elif pim in ("localInteraction", "LocalInteraction"):
                pd = coeffs.get_dict("patches", FoamDict())
                for pname, entry in pd.subdicts():
                    it = entry.get_word("type", "rebound")
                    e = entry.get_scalar("e", 1.0)
                    for p in geom.patches:
                        if p.name == pname or re.fullmatch(pname, p.name):
                            b_code[p.slice] = code_of.get(it, INTERACT_REBOUND)
                            b_e[p.slice] = e
            elif pim in ("rebound", "Rebound"):
                e = coeffs.get_scalar("e", 1.0)
                b_code[:] = INTERACT_REBOUND
                b_e[:] = e
            elif pim in ("none", "noInteraction", "NoInteraction"):
                b_code[:] = INTERACT_STICK

        pim = sub.get_word("patchInteractionModel", "standardWallInteraction")
        if pim in ("multiInteraction", "MultiInteraction"):
            mc = sub.get_dict("multiInteractionCoeffs", FoamDict())
            # first-listed model wins per patch ('oneInteractionOnly true'):
            # apply in reverse so earlier entries overwrite later ones
            for mname, entry in reversed(list(mc.subdicts())):
                inner = entry.get_word("patchInteractionModel", mname)
                apply_model(inner, entry.get_dict(inner + "Coeffs", entry))
        else:
            apply_model(pim, sub.get_dict(pim + "Coeffs", FoamDict()))
        return b_code, b_e

    # ------------------------------------------------------------------
    def set_film_patches(self, names: List[str]):
        """Mark film-covered patches: parcels striking them go to the film."""
        for n in names:
            p = self.geom.patch(n)
            self.set_film_faces(np.arange(p.start, p.start + p.n))
        self.film_patches = list(names)

    def set_film_faces(self, bidx):
        """Mark film-covered boundary faces (boundary-local ids)."""
        b_code = self.b_code.cpu().numpy().copy()
        b_code[np.asarray(bidx, np.int64)] = INTERACT_FILM
        self.b_code = torch.as_tensor(b_code, dtype=INT_DTYPE, device=self.device)

    # ------------------------------------------------------------------
    def initial_state(self, seed: int = 7) -> Dict:
        cap = self.cfg.capacity
        kw = dict(dtype=self.dtype, device=self.device)
        dev = self.device
        st = {
            "x": torch.zeros((cap, 3), **kw),
            "U": torch.zeros((cap, 3), **kw),
            "d": torch.full((cap,), 1e-4, **kw),
            "T": torch.full((cap,), self.cfg.T0, **kw),
            # per-parcel heat capacity (ThermoParcel::Cp_), seeded from
            # constantProperties Cp0
            "cp0": torch.full((cap,), self.cfg.cp0, **kw),
            "nP": torch.zeros((cap,), **kw),  # particles per parcel
            "cell": torch.zeros((cap,), dtype=INT_DTYPE, device=dev),
            "alive": torch.zeros((cap,), dtype=torch.bool, device=dev),
            "age": torch.zeros((cap,), **kw),
            # reacting-multiphase combustion gate (−1 = suppressed) and
            # parcel type id — consumed by SuppressionCollision
            "canCombust": torch.ones((cap,), dtype=torch.int32, device=dev),
            "typeId": torch.zeros((cap,), dtype=torch.int32, device=dev),
            # the random key stays on the host: its chain of splits does not
            # depend on the data, so splitting it launches nothing
            "rng": prng.PRNGKey(seed),
            "inj": [inj.init_state() for inj in self.injectors],
            "coll": [c.init_state(self.dtype, dev) for c in self.collectors],
            "cfo": [
                f.init_state(
                    cap,
                    self.geom.n_boundary if hasattr(f, "post_patch") else self.geom.n_cells,
                    self.dtype, dev,
                )
                for f in self.cloud_functions
            ],
        }
        if self.devol is not None:
            # the n-phase ledger lanes (per-PARTICLE volatile masses)
            st["mv"] = torch.zeros((cap, self.devol.n_vol), **kw)
            st["mv0"] = torch.zeros((cap, self.devol.n_vol), **kw)
        if self.ledger is not None:
            st["ms"] = torch.zeros((cap,), **kw)  # per-particle inert solid mass
        if self.multi_liq:
            # per-parcel liquid composition lanes (ReactingParcel Y_ over
            # the liquid phase — components deplete independently)
            st["Yl"] = self._Y0.expand(cap, -1).clone()
        if self.pair_collision is not None:
            st["pc"] = self.pair_collision.init_state(cap, self.dtype, dev)
        return st

    def _volatiles(self, st) -> torch.Tensor:
        """Per-parcel volatile mass nP·Σ mv [cap] (with devolatilisation)."""
        return st["nP"] * torch.sum(st["mv"], dim=1)

    # ------------------------------------------------------------------
    def _rho(self, T, Yl) -> torch.Tensor:
        """The liquid's density at the parcels' T (and composition)."""
        if self.multi_liq:
            return self.liquid.rho_Y(101325.0, T, Yl)
        return self.liquid.rho(101325.0, T)

    def _mass(self, st) -> torch.Tensor:
        rho_l = self._rho(st["T"], st.get("Yl"))
        return torch.where(st["alive"], st["nP"] * _sphere_mass(rho_l, st["d"]), 0.0)

    # ------------------------------------------------------------------
    def _inject(self, st: Dict, t, dt, gas, src: Optional[Dict] = None) -> Dict:
        if not self.injectors:
            return st
        st = dict(st)
        ks = prng.split(st["rng"], len(self.injectors) + 1)
        st["rng"] = ks[0]
        inj_states = []
        for inj, istate, k in zip(self.injectors, st["inj"], ks[1:]):
            istate, cand = inj.inject(istate, k, t, dt, gas)
            inj_states.append(istate)
            st = self._scatter_new(st, cand, src)
        st["inj"] = inj_states
        return st

    def _scatter_new(self, st: Dict, cand: Dict, src: Optional[Dict] = None) -> Dict:
        """Place candidate parcels into free slots (drop on overflow). With
        a ledger and `src`, src["volatileInjected"] gains the volatile mass
        of the parcels placed. Partitioned, the candidates' cell ids are
        GLOBAL (every rank draws the same parcels): a rank keeps those in
        the cells it owns, at their local ids."""
        if self.part is not None:
            cand = dict(cand)
            loc = self.part.cell_map[cand["cell"].to(INT_DTYPE)]
            cand["valid"] = cand["valid"] & (loc >= 0)
            cand["cell"] = torch.clamp(loc, min=0)
        m = cand["valid"].shape[0]
        # free slots first: a stable sort of alive puts the free lanes first
        free = torch.sort(st["alive"].to(torch.int32), stable=True).indices[:m]
        ok = cand["valid"] & ~st["alive"][free]
        tgt = free
        dtp = self.dtype

        # per-parcel injection temperature (the thermo lookup-table
        # injectors supply T per row); every other injector seeds T0
        T_new = cand.get("T")
        if T_new is None:
            T_new = torch.full((m,), self.cfg.T0, dtype=dtp, device=self.device)
        yl = None
        if self.multi_liq:
            # per-parcel liquid split (YLiquid of the multiphase lookup
            # injectors); other injectors seed the frozen mixture composition
            yl = cand.get("YLiquid")
            if yl is None:
                yl = self._Y0.expand(m, -1)
            else:
                K = self.n_liq
                if yl.shape[1] < K:
                    yl = torch.cat([yl, yl.new_zeros((m, K - yl.shape[1]))], 1)
                yl = yl[:, :K]
                yl = yl / torch.clamp(torch.sum(yl, 1, keepdim=True), min=self._small)
            rho_l = self.liquid.rho_Y(101325.0, T_new, yl)
        else:
            rho_l = self.liquid.rho(101325.0, T_new)
        nP = cand["mass"] / torch.clamp(_sphere_mass(rho_l, cand["d"]), min=self._small)

        def put(a, v, ok=ok):
            mask = ok[:, None] if v.ndim == 2 else ok
            a = a.clone()
            a[tgt] = torch.where(mask, v, a[tgt]).to(a.dtype)
            return a

        st = dict(st)
        st["x"] = put(st["x"], cand["x"])
        st["U"] = put(st["U"], cand["U"])
        st["d"] = put(st["d"], cand["d"])
        st["T"] = put(st["T"], T_new)
        cp_new = cand.get("cp")
        if cp_new is None:
            cp_new = torch.full((m,), self.cfg.cp0, dtype=dtp, device=self.device)
        st["cp0"] = put(st["cp0"], cp_new)
        if yl is not None:
            st["Yl"] = put(st["Yl"], yl)
        st["nP"] = put(st["nP"], nP)
        st["cell"] = put(st["cell"], cand["cell"].to(INT_DTYPE))
        st["alive"] = put(st["alive"], ok | st["alive"][tgt], ok=torch.ones_like(ok))
        st["age"] = put(st["age"], torch.zeros((m,), dtype=dtp, device=self.device))
        st["canCombust"] = put(st["canCombust"], torch.ones_like(st["canCombust"][tgt]))
        st["typeId"] = put(st["typeId"], torch.zeros_like(st["typeId"][tgt]))
        # n-phase ledger: split the seeded particle mass by the composition
        # phases' Y0 (the liquid core carries fraction _liq_frac0; volatile
        # and solid content ride on top, constantVolume bookkeeping)
        if self.devol is not None or self.ledger is not None:
            m1l = _sphere_mass(rho_l, cand["d"])
            lf = max(self._liq_frac0, 1e-12)
            mv_new = None
            # per-parcel phase split: the reacting lookup-table injectors
            # supply Yphase (phase-mixture fractions in the composition's
            # gas/liquid/solid order, reactingParcelInjectionData.H Y_) and
            # optionally YGas (the split within the gas phase); the lanes
            # carry volatile and solid mass RELATIVE to the liquid sphere
            yph = cand.get("Yphase")
            if yph is not None and self.ledger is not None:
                ng = len(self.ledger.gas_names)
                col_gas = 0 if ng else None
                col_liq = 1 if ng else 0
                col_sol = col_liq + 1
                W = yph.shape[1]
                zeros = torch.zeros(m, dtype=dtp, device=self.device)
                ygas = yph[:, col_gas] if (ng and W > col_gas) else zeros
                yliq = yph[:, col_liq] if W > col_liq else torch.ones_like(zeros)
                ysol = yph[:, col_sol] if W > col_sol else zeros
                yliq = torch.clamp(yliq, min=1e-12)
                if self.devol is not None:
                    within = cand.get("YGas")
                    if within is None:
                        gf = np.asarray(self.ledger.gas_fracs, float)
                        within = torch.as_tensor(gf / max(gf.sum(), 1e-300), dtype=dtp,
                                                 device=self.device)[None, :]
                    mv_new = m1l[:, None] * (ygas / yliq)[:, None] * within[:, : self.devol.n_vol]
                st["ms"] = put(st["ms"], m1l * ysol / yliq)
            else:
                if self.devol is not None:
                    mv_new = m1l[:, None] * self._ledger_tab("vol_frac", self._vol_frac0 / lf)
                if self.ledger is not None:
                    st["ms"] = put(st["ms"], m1l * (self.ledger.solid_frac / lf))
            if mv_new is not None:
                st["mv"] = put(st["mv"], mv_new)
                st["mv0"] = put(st["mv0"], mv_new)
                if src is not None:
                    src["volatileInjected"] = src["volatileInjected"] + torch.sum(torch.where(
                        ok, nP.to(dtp) * torch.sum(mv_new, dim=1), torch.zeros_like(nP, dtype=dtp)))
        # relocalise injected parcels from their seed cell (sprinkler offset)
        x, U, cell, alive, _, _ = self.walk.walk(
            st["x"], st["U"], st["cell"], st["alive"], self.b_code, self.b_e,
            n_steps=max(self.cfg.walk_steps, 8),
        )
        st.update(x=x, U=U, cell=cell, alive=alive)
        return st

    def _ledger_tab(self, name, a) -> torch.Tensor:
        """A [1, k] host table of the ledger on the cloud's device, made once."""
        cache = self.__dict__.setdefault("_ledger_tabs", {})
        if name not in cache:
            cache[name] = torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype,
                                          device=self.device)[None, :]
        return cache[name]

    # ------------------------------------------------------------------
    def _calc(self, st: Dict, gas: Dict, dt_sub, src: Dict) -> Tuple[Dict, Dict]:
        """One physics substep on all alive parcels + source accumulation."""
        cfg = self.cfg
        small_ = self._small
        mask = st["alive"]
        c = st["cell"]

        # carrier values at the parcel cell (interpolationSchemes 'cell')
        rho_c = gas["rho"][c]
        U_c = gas["U"][c]
        T_c = gas["T"][c]
        p_c = gas["p"][c]
        mu_c = gas["mu"][c]
        kappa_c = gas["kappa"][c]
        cp_c = gas["cp"][c]

        T_p = torch.clamp(st["T"], min=cfg.T_min)
        d = torch.clamp(st["d"], min=1e-9)
        # bulk liquid properties: per-parcel composition-weighted when the
        # mixture tracks per-parcel lanes (ReactingParcel.C composition
        # re-evaluation each calc)
        if self.multi_liq:
            rho_l = self.liquid.rho_Y(p_c, T_p, st["Yl"])
            cp_l = self.liquid.cp_Y(p_c, T_p, st["Yl"])
        else:
            rho_l = self.liquid.rho(p_c, T_p)
            cp_l = self.liquid.cp(p_c, T_p)
        m1 = _sphere_mass(rho_l, d)  # single-particle mass

        Urel = U_c - st["U"]
        magUr = torch.sqrt(torch.sum(Urel * Urel, dim=1))
        Re = torch.clamp(rho_c * magUr * d / mu_c, min=1e-6)
        Pr_c = torch.clamp(mu_c * cp_c / kappa_c, min=1e-6)

        # ---- phase change (LiquidEvaporationBoil behaviour) -------------
        dm1 = torch.zeros_like(d)  # evaporated mass per particle this substep
        dm_k = None  # per-component evaporated mass [N, K] (multi-liquid)
        hl_evap = torch.zeros_like(d)
        RR = 8314.47
        if cfg.phase_change and self.multi_liq:
            # per-component LiquidEvaporation(Boil): every liquid evaporates
            # against its OWN saturation pressure, diffusivity and latent
            # heat (LiquidEvaporation.C calculate loop over liquids) — the
            # parcel's Yl lane drifts as volatile components deplete first
            Yl = st["Yl"]
            Wk = self._Wk
            pvk = self.liquid.comp_pv(p_c, T_p)  # [N, K]
            Dk = self.liquid.comp_D(p_c, T_p)
            hlk = self.liquid.comp_hl(p_c, T_p)
            xk = self.liquid.x_Y(Yl)  # liquid mole fractions (Raoult)
            Ts = (T_p + 2.0 * T_c) / 3.0  # two-thirds film temperature
            Cs_k = xk * pvk / (RR * Ts)[:, None]
            YvC = gas["YvC"][c]  # [N, K] carrier vapour mass fractions
            W_mix = gas["W"][c]
            Xv_k = YvC * W_mix[:, None] / Wk[None, :]
            Cinf_k = Xv_k * (p_c / (RR * T_c))[:, None]
            Sc_k = mu_c[:, None] / torch.clamp(rho_c[:, None] * Dk, min=1e-30)
            Sh_k = 2.0 + 0.6 * torch.sqrt(Re)[:, None] * Sc_k ** (1.0 / 3.0)
            kc_k = Sh_k * Dk / d[:, None]
            dmdt_k = torch.clamp(
                _PI * (d**2)[:, None] * kc_k * (Cs_k - Cinf_k) * Wk[None, :], min=0.0
            )
            # boiling: heat-balance-limited TOTAL rate split over components
            # by Raoult volatility x·pv·W (the boil branch)
            wk = torch.clamp(xk * pvk * Wk[None, :], min=0.0)
            wk = wk / torch.clamp(torch.sum(wk, 1, keepdim=True), min=small_)
            hl_mix = torch.sum(wk * hlk, dim=1)
            Nu0 = 2.0 + 0.6 * torch.sqrt(Re) * Pr_c ** (1.0 / 3.0)
            htc0 = Nu0 * kappa_c / d
            dm_dt_boil = torch.clamp(htc0 * _PI * d**2 * (T_c - T_p), min=0.0) / torch.clamp(
                hl_mix, min=small_)
            boiling = T_p >= cfg.Tbp - 1e-6
            dmdt_tot = torch.sum(dmdt_k, dim=1)
            dmdt_k = torch.where(
                (boiling & (dm_dt_boil > dmdt_tot))[:, None], dm_dt_boil[:, None] * wk, dmdt_k
            )
            dmdt_k = torch.where((T_p > cfg.Tvap)[:, None], dmdt_k, 0.0)
            # per-component availability: a lane can't give more than the
            # component mass it holds
            dm_k = torch.minimum(torch.clamp(dmdt_k * dt_sub, min=0.0), Yl * m1[:, None])
            dm1 = torch.sum(dm_k, dim=1)
            # effective latent heat of what ACTUALLY evaporated
            hl_evap = torch.sum(dm_k * hlk, dim=1) / torch.clamp(dm1, min=small_)
            hl_evap = torch.where(dm1 > small_, hl_evap, hl_mix)
        elif cfg.phase_change:
            pv = self.liquid.pv(p_c, T_p)
            Dab = self.liquid.D(p_c, T_p)
            Sc = mu_c / torch.clamp(rho_c * Dab, min=1e-30)
            Sh = 2.0 + 0.6 * torch.sqrt(Re) * Sc ** (1.0 / 3.0)
            # molar concentration driving force (LiquidEvaporation):
            # Cs = pSat/(R Ts), Cinf = Xv p/(R Tc)
            Ts = (T_p + 2.0 * T_c) / 3.0  # two-thirds rule film temperature
            Cs = pv / (RR * Ts)
            Yv = gas["Yv"][c]
            W_mix = gas["W"][c]
            Xv = Yv * W_mix / self.liquid.W
            Cinf = Xv * p_c / (RR * T_c)
            kc = Sh * Dab / d
            dm_dt_evap = torch.clamp(_PI * d**2 * kc * (Cs - Cinf) * self.liquid.W, min=0.0)
            # boiling: heat-balance-limited (all convective heat → latent)
            hl = self.liquid.hl(p_c, T_p)
            Nu0 = 2.0 + 0.6 * torch.sqrt(Re) * Pr_c ** (1.0 / 3.0)
            htc0 = Nu0 * kappa_c / d
            dm_dt_boil = torch.clamp(htc0 * _PI * d**2 * (T_c - T_p), min=0.0) / hl
            boiling = T_p >= cfg.Tbp - 1e-6
            dm_dt = torch.where(boiling, torch.maximum(dm_dt_evap, dm_dt_boil), dm_dt_evap)
            dm_dt = torch.where(T_p > cfg.Tvap, dm_dt, 0.0)
            dm1 = torch.minimum(torch.clamp(dm_dt * dt_sub, min=0.0), m1)
            hl_evap = hl

        m1_new = torch.clamp(m1 - dm1, min=0.0)
        evap_all = m1_new * st["nP"] <= cfg.min_mass
        d_new = torch.clamp(_cbrt(6.0 * m1_new / (_PI * rho_l)), min=1e-9)

        # ---- devolatilisation (ReactingMultiphaseParcel calc chain) ------
        # the volatile ledger's mass evolves into the carrier; suppression's
        # canCombust == −1 inhibits it; all volatiles evolved flips the
        # parcel combustion-ready (canCombust = 1)
        dmv = None
        if self.devol is not None:
            gate = mask & (torch.sum(st["mv0"], dim=1) > 0.0)
            dmv, can_new = self.devol.calculate(dt_sub, T_p, st["mv"], st["mv0"],
                                                st["canCombust"], gate)
            dmv_tot = torch.sum(dmv, dim=1)

        # ---- particle radiative efficiencies + heating -------------------
        # (ThermoParcel::calcHeatTransfer radiation branch + ThermoCloud::
        # radCalc — s = kG/4 − σ·kEmm·T⁴ added to the analytic T solve)
        s_rad = torch.zeros_like(d)
        if cfg.radiation:
            QAbs, QSct, gAsy = self._rad_efficiencies(d)  # [N, nBands] each
            Gb = gas.get("G_bands")  # [nBands, nC] from fvDOM (stale)
            if Gb is not None and cfg.coupled_radiation:
                G_par = Gb[:, c].T  # [N, nBands]
                kG = torch.sum(QAbs * G_par, dim=1)
                # Kirchhoff emission: QEmm = QAbs with equal band fractions
                # (the reference's getQEmmFrac is an unimplemented stub —
                # ThermoCloudI.H:627-631 returns zeros; the energy-consistent
                # closure instead)
                kEmm = torch.sum(QAbs, dim=1) / max(cfg.n_bands, 1)
                s_rad = 0.25 * kG - SIGMA_SB * kEmm * T_p**4

        # ---- heat transfer (Ranz-Marshall, analytic T integration) ------
        T_new = T_p
        q_conv1 = torch.zeros_like(d)  # heat gained by one particle from gas
        if cfg.heat_transfer:
            Nu = 2.0 + 0.6 * torch.sqrt(Re) * Pr_c ** (1.0 / 3.0)
            htc = Nu * kappa_c / d
            if cfg.bird_correction and cfg.phase_change:
                # Bird et al. evaporative shielding: beta/(e^beta - 1)
                beta = torch.clamp(
                    (dm1 / torch.clamp(dt_sub, min=small_)) * cp_l
                    / torch.clamp(htc * _PI * d**2, min=1e-30),
                    0.0, 50.0,
                )
                corr = torch.where(beta > 1e-7, beta / torch.expm1(beta), 1.0)
                htc = htc * corr
            A = _PI * d**2
            # latent-heat sink of what evaporated (dm-weighted per
            # component under multi-liquid lanes)
            hl = hl_evap if cfg.phase_change else 0.0
            mcp = torch.clamp(m1_new * cp_l, min=1e-30)
            beta_T = htc * A / mcp
            # effective bath temperature incl. latent-heat sink and the
            # radiative surface flux s_rad (ThermoParcel.C:295-319 ap += s/htc)
            T_eff = (
                T_c
                - (dm1 / torch.clamp(dt_sub, min=small_)) * hl / torch.clamp(htc * A, min=1e-30)
                + s_rad / torch.clamp(htc, min=1e-30)
            )
            if cfg.scheme_T.lower().startswith("euler"):
                # IntegrationScheme/Euler.H: implicit single step
                T_new = (T_p + beta_T * dt_sub * T_eff) / (1.0 + beta_T * dt_sub)
            else:  # analytical (Analytical.H — exact exponential relaxation)
                T_new = T_eff + (T_p - T_eff) * torch.exp(-beta_T * dt_sub)
            T_new = torch.clamp(T_new, cfg.T_min, cfg.Tbp)
            # convective-only heat from the gas (the radiative part comes
            # from the radiation field, not the carrier enthalpy — dhsTrans
            # in the reference is Sph·(Tres.average − Tc), convective only)
            q_conv1 = m1_new * cp_l * (T_new - T_p) + dm1 * hl - s_rad * A * dt_sub
        if self.devol is not None and self.devol.L_devol != 0.0:
            # the latent heat of devolatilisation drawn from the particle
            # (Sh −= dMassTot·LDevol/dt, ReactingMultiphaseParcel.C:566)
            cp_here = cp_l if cfg.heat_transfer else st["cp0"]
            T_new = T_new - dmv_tot * self.devol.L_devol / torch.clamp(m1_new * cp_here,
                                                                      min=small_)
            T_new = torch.clamp(T_new, min=cfg.T_min)
        T_new = torch.where(mask, T_new, T_p)

        # ---- momentum (particle force list, drag-implicit Euler) --------
        # forceSuSp composition (ParticleForceList): implicit Σ Sp·(Uc−Up)
        # from the drag model, explicit Σ Su from lift/pressureGradient/
        # virtualMass, plus gravity-buoyancy. The default sphereDrag path
        # reduces to exactly the Schiller-Naumann update.
        U_new = st["U"]
        fr = self.forces
        buoy = (lambda: self.g[None, :] * (1.0 - rho_c / rho_l)[:, None])
        if cfg.drag:
            m1n = _sphere_mass(rho_l, d_new)
            if fr.drag_model in (None, "sphereDrag"):
                # unit-mass fast path (SphereDragForce.C)
                tau_inv = 0.75 * mu_c * _sphere_cdre(Re) / (rho_l * d_new**2)
            else:
                sp = fr.drag_sp(Re, mu_c, rho_l, d_new, m1n, alpha_c=gas.get("alphac"),
                                y=st.get("distort_y"))
                tau_inv = sp / torch.clamp(m1n, min=small_)
            g_eff = buoy() if cfg.gravity_on else 0.0
            su = torch.zeros_like(U_new)
            if fr.lift_model is not None and "curlU" in gas:
                su = su + fr.lift_su(st["U"], U_c, gas["curlU"][c], Re, mu_c, rho_c, rho_l,
                                     d_new, m1n, g=self._g_np)
            if (fr.pressure_gradient or fr.virtual_mass) and "DUDt" in gas:
                su = su + fr.pgrad_su(gas["DUDt"][c], rho_c, rho_l, m1n)
            if fr.has_body_forces():
                hdgh = gas["HdotGradH"][c] if "HdotGradH" in gas else None
                su = su + fr.body_su(st["x"], st["U"], m1n, rho_c, rho_l, hdgh)
            m_eff = m1n + fr.mass_add(m1n, rho_c, rho_l)
            if cfg.scheme_U.lower().startswith("anal"):
                # Analytical.H: exact relaxation toward the effective bath
                # U_eff = Uc + (Su/m + g)/τ⁻¹
                ti = torch.clamp(tau_inv, min=small_)
                U_eff = U_c + (su / torch.clamp(m_eff, min=small_)[:, None] + g_eff) / ti[:, None]
                U_new = U_eff + (st["U"] - U_eff) * torch.exp(-dt_sub * ti)[:, None]
            else:  # Euler (drag-implicit)
                U_new = (
                    st["U"]
                    + dt_sub * (tau_inv[:, None] * U_c
                                + su / torch.clamp(m_eff, min=small_)[:, None] + g_eff)
                ) / (1.0 + dt_sub * tau_inv)[:, None]
        elif cfg.gravity_on or fr.has_body_forces():
            acc = buoy() if cfg.gravity_on else 0.0
            if fr.has_body_forces():
                m1n = _sphere_mass(rho_l, d_new)
                hdgh = gas["HdotGradH"][c] if "HdotGradH" in gas else None
                acc = acc + fr.body_su(st["x"], st["U"], m1n, rho_c, rho_l, hdgh) / torch.clamp(
                    m1n, min=small_)[:, None]
            U_new = st["U"] + dt_sub * acc

        # ---- source accumulation (order-fixed per-cell sums) -------------
        nP = st["nP"]
        w = torch.where(mask, nP, 0.0)
        nC = self.geom.n_cells
        seg = CellSum(c, nC, keep=mask)
        dm = w * dm1  # mass to carrier
        src = dict(src)
        if cfg.coupled:
            # momentum: drag impulse on the gas = −m ΔU_drag; evaporated mass
            # carries its own momentum into the carrier
            dU = U_new - st["U"]
            g_eff_v = buoy() if cfg.gravity_on else torch.zeros_like(U_new)
            dU_drag = dU - dt_sub * g_eff_v
            mom = -(w * m1_new)[:, None] * dU_drag + dm[:, None] * st["U"]
            # energy: gas loses convective heat, gains vapour enthalpy
            hs_all = self.gas.hs_species(T_new)
            if dm_k is not None:
                # per-component: each lane's mass enters its OWN carrier
                # species with that species' enthalpy (YEEqn.H:52)
                dmw_k = w[:, None] * dm_k
                q = -w * q_conv1 + sum(
                    dmw_k[:, i] * hs_all[:, vi] for i, vi in enumerate(self.vapour_indices)
                )
                cols = [dm[:, None], mom, q[:, None], dmw_k]
            else:
                q = -w * q_conv1 + dm * hs_all[:, self.vapour_index]
                cols = [dm[:, None], mom, q[:, None]]
            n_pc = dm_k.shape[1] if dm_k is not None else 0
            if dmv is not None:
                # devolatilised mass → each volatile's carrier species, its
                # momentum at the parcel velocity, its enthalpy at Tp
                dv = w[:, None] * dmv  # parcel-level mass per volatile
                q_dv = sum(dv[:, i] * hs_all[:, si]
                           for i, si in enumerate(self.devol.gas_indices))
                cols += [dv, (w * dmv_tot)[:, None] * st["U"], q_dv[:, None]]
            tot = seg(torch.cat(cols, dim=1))
            src["rhoTrans"] = src["rhoTrans"] + tot[:, 0]
            src["UTrans"] = src["UTrans"] + tot[:, 1:4]
            src["hsTrans"] = src["hsTrans"] + tot[:, 4]
            if dm_k is not None:
                src["pcTrans"] = src["pcTrans"] + tot[:, 5:5 + n_pc].T
            if dmv is not None:
                nv, o = self.devol.n_vol, 5 + n_pc
                src["dvTrans"] = src["dvTrans"] + tot[:, o:o + nv].T
                src["UTrans"] = src["UTrans"] + tot[:, o + nv:o + nv + 3]
                src["hsTrans"] = src["hsTrans"] + tot[:, o + nv + 3]

        # ---- spray radiation accumulators (ThermoCloud::radCalc:
        # radAreaP/radAreaPSc/radAreaPT4/radAreaPScAsy per band) ----------
        if cfg.radiation:
            Ap = 0.25 * _PI * d_new**2  # projected area
            QAbs, QSct, gAsy = self._rad_efficiencies(d_new)
            wA = torch.where(mask, nP * Ap, 0.0) * dt_sub  # time-weighted
            nb = cfg.n_bands
            # emission ∝ particle SURFACE (4·Ap)·σ·QEmm·emFrac·T⁴, energy-
            # consistent with the parcel sink above (QEmm = QAbs, equal
            # band fractions)
            tot = seg(torch.cat([
                wA[:, None] * QAbs, wA[:, None] * QSct, wA[:, None] * QSct * gAsy,
                (4.0 * wA * T_new**4 / max(nb, 1))[:, None] * QAbs,
            ], dim=1)).T  # [4·nB, nC]
            src["radAp"] = src["radAp"] + tot[0:nb]
            src["radSigp"] = src["radSigp"] + tot[nb:2 * nb]
            src["radAsy"] = src["radAsy"] + tot[2 * nb:3 * nb]
            src["radEpT4"] = src["radEpT4"] + tot[3 * nb:]

        # ---- commit parcel updates --------------------------------------
        st = dict(st)
        if dmv is not None:
            st["mv"] = st["mv"] - dmv
            st["canCombust"] = can_new
        if dm_k is not None:
            # composition drift: remaining component masses renormalise;
            # fully evaporated parcels keep their last valid composition
            # (they die via evap_all — NaN-free masked math)
            mk_new = torch.clamp(st["Yl"] * m1[:, None] - dm_k, min=0.0)
            tot_k = torch.sum(mk_new, dim=1, keepdim=True)
            Yl_new = torch.where(tot_k > small_, mk_new / torch.clamp(tot_k, min=small_), st["Yl"])
            st["Yl"] = torch.where(mask[:, None], Yl_new, st["Yl"])
        st["T"] = torch.where(mask, T_new, st["T"])
        st["U"] = torch.where(mask[:, None], U_new, st["U"])
        st["d"] = torch.where(mask, d_new, st["d"])
        st["alive"] = st["alive"] & ~(mask & evap_all)
        st["age"] = st["age"] + torch.where(mask, dt_sub, 0.0)
        # mass bookkeeping (logged only): a parcel's mass is nP·ρ(T)·πd³/6
        # and d_new was sized at the old temperature's density, so heating
        # or cooling changes a surviving parcel's mass by
        # nP·(ρ(T_new) − ρ(T_p))·πd_new³/6; a parcel dropped at
        # minParticleMass takes its last nP·m1_new out of the cloud
        kept = mask & ~evap_all
        drho = self._rho(st["T"], st.get("Yl")) - rho_l
        src["expansionMass"] = src["expansionMass"] + torch.sum(
            torch.where(kept, nP * _sphere_mass(drho, d_new), 0.0))
        src["droppedMass"] = src["droppedMass"] + torch.sum(
            torch.where(mask & evap_all, nP * m1_new, 0.0))
        return st, src

    # ------------------------------------------------------------------
    def _rad_efficiencies(self, d):
        """Per-parcel per-band (QAbs, QSct, g): constRad constants or
        diaBanded linear interpolation in particle diameter with the end
        values held outside the table (ThermoCloud::getQAbsQSct,
        ThermoCloudI.H:647-720; jnp.interp's rule)."""
        dtp, dev = self.dtype, self.device
        if not hasattr(self, "_rad_tabs"):
            # device copies made once (a pageable host-to-device copy waits
            # for the card)
            self._rad_tabs = {
                k: torch.as_tensor(np.asarray(a, np.float64), dtype=dtp, device=dev)
                for k, a in (("qabs", self.rad_qabs), ("qsct", self.rad_qsct),
                             ("asy", self.rad_asy), ("dia", self.rad_dia if self.rad_dia
                                                     is not None else [0.0]))
            }
        tab = self._rad_tabs.__getitem__
        if self.rad_dia is None or len(self.rad_dia) == 1:
            one = torch.ones(d.shape + (1,), dtype=dtp, device=dev)
            return (one * tab("qabs")[0], one * tab("qsct")[0], one * tab("asy")[0])
        dia = tab("dia")
        n = dia.shape[0]
        j = torch.clamp(torch.searchsorted(dia, d, right=True), 1, n - 1)
        x0, x1 = dia[j - 1], dia[j]
        f = torch.clamp((d - x0) / (x1 - x0), 0.0, 1.0)[:, None]

        def interp(name):
            t = tab(name)  # [nDia, nB]
            return t[j - 1] + f * (t[j] - t[j - 1])

        return interp("qabs"), interp("qsct"), interp("asy")

    # ------------------------------------------------------------------
    def vDotSweep(self, st) -> torch.Tensor:
        """Per-cell swept volume rate Σ np·π/4·d²·|U| / V [1/s] — the
        suppression-probability driver (kinematicCloud::vDotSweep consumed
        by SuppressionCollision.C:collide)."""
        magU = torch.sqrt(torch.sum(st["U"] ** 2, dim=1))
        v = torch.where(st["alive"], st["nP"] * 0.25 * _PI * st["d"] ** 2 * magU, 0.0)
        return cell_sum(v, st["cell"], self.geom.n_cells, keep=st["alive"]) / self.geom.V

    def spray_volume(self, st) -> torch.Tensor:
        """Per-cell liquid volume Σ nP·π/6·d³ of the alive parcels [m³] (the
        order-fixed sum behind theta(), spray_rho and VFSpray)."""
        vol = st["nP"] * (_PI / 6.0) * st["d"] ** 3 * st["alive"].to(st["d"].dtype)
        return cell_sum(vol, st["cell"], self.geom.n_cells, keep=st["alive"])

    # ------------------------------------------------------------------
    def _film_interaction(self, st, src, code, hit, mass_before, film_delta_b):
        """Parcel → film handoff with Bai-Gosman splashing
        (ThermoSurfaceFilmMeredith.C:333-460 via ThermoSurfaceFilm):

          La = ρσd/μ²;  Wec = A·La^(−0.183)  (A = Adry dry, Awet wet)
          dry (δ < deltaWet): We < Wec → absorb, else splash
          wet: We < 1 absorb; 1 ≤ We < 20 bounce; 20 ≤ We < Wec absorb;
               ≥ Wec splash
          splash: mRatio of the mass goes on as one secondary parcel with a
          truncated-exponential diameter and the energy budget's speed
          (:529-575); the rest is absorbed by the film.

        The geometric reflection happened in the walk; the parcels' T is
        the one they struck with. The two draws come from st["rng"] in the
        JAX package's order. The mass and enthalpy handed to the film are
        summed per boundary face in a fixed order (CellSum over the parcels
        that hand over)."""
        if not self.has_film_handoff:
            return st, src
        hit_film = (code == INTERACT_FILM) & (hit >= 0) & st["alive"]
        nB = self.geom.n_boundary
        bidx = torch.clamp(hit, min=0)
        p_atm = 101325.0
        T_hit = st["T"]
        h_rel = self.liquid.cp(p_atm, T_hit) * (T_hit - 298.15)
        zero = torch.zeros_like(mass_before)

        if not self.splash_on or film_delta_b is None:
            m_abs = torch.where(hit_film, mass_before, zero)
            st = dict(st)
            st["alive"] = st["alive"] & ~hit_film
            fsum = CellSum(bidx, nB, keep=hit_film)
            src = dict(src)
            src["filmMass"] = src["filmMass"] + fsum(m_abs)
            src["filmEnthalpy"] = src["filmEnthalpy"] + fsum(m_abs * h_rel)
            return st, src

        tiny = self._small
        d = torch.clamp(st["d"], min=1e-9)
        rho_l = self.liquid.rho(p_atm, T_hit)
        sigma = torch.clamp(self.liquid.sigma(p_atm, T_hit), min=1e-6)
        mu_l = self.liquid.mu(p_atm, T_hit)
        magU = torch.sqrt(torch.sum(st["U"] ** 2, dim=1))
        We = rho_l * d * magU ** 2 / sigma
        La = rho_l * sigma * d / mu_l ** 2
        wet = film_delta_b[bidx] > self.splash_delta_wet
        A = torch.where(wet, torch.full_like(We, self.splash_Awet),
                        torch.full_like(We, self.splash_Adry))
        Wec = A * La ** (-0.183)

        splash = hit_film & (We >= Wec)
        bounce = hit_film & wet & (We >= 1.0) & (We < 20.0) & ~splash
        absorb = hit_film & ~splash & ~bounce

        # ---- the splash's secondary parcel ----
        ks = prng.split(st["rng"])
        y = prng.uniform(ks[1], (2,) + tuple(d.shape), self.dtype, device=self.device)
        y1, y2 = y[0], y[1]
        m_ratio = 0.2 + 0.6 * y1
        Ns = torch.clamp(5.0 * (We / torch.clamp(Wec, min=1e-6) - 1.0), min=1e-3)
        d_bar = (m_ratio / Ns) ** (1.0 / 3.0) * d / 6.0 ** (1.0 / 3.0) + 1e-12
        d_min, d_max = 8e-5, 1.6e-3
        K = torch.exp(-d_min / d_bar) - torch.exp(-d_max / d_bar)
        d_new = torch.clamp(-d_bar * torch.log(torch.clamp(torch.exp(-d_min / d_bar) - y2 * K,
                                                           min=1e-30)), min=d_min)
        m = mass_before
        m_splash = m_ratio * m
        # the energy budget → the splashed speed (parcelsPerSplash 1)
        np_old = st["nP"]
        ek_in = 0.5 * m * magU ** 2
        e_sig_in = np_old * sigma * _PI * d ** 2
        np_new = m_splash / torch.clamp(_sphere_mass(rho_l, d_new), min=tiny)
        e_sig_sec = np_new * sigma * _PI * d_new ** 2
        e_d = torch.maximum(0.8 * ek_in, 0.75 * Wec / 12.0 * _PI * sigma * d ** 2 * np_old)
        eks = ek_in + e_sig_in - e_sig_sec - e_d
        # EKs ≤ 0: all absorbed instead of a splash
        no_energy = splash & (eks <= 0.0)
        splash = splash & (eks > 0.0)
        absorb = absorb | no_energy
        u_mag_new = torch.sqrt(torch.clamp(eks, min=0.0) / torch.clamp(m_splash, min=tiny))
        u_dir = st["U"] / torch.clamp(magU, min=1e-12)[:, None]

        st = dict(st)
        st["alive"] = st["alive"] & ~absorb
        st["d"] = torch.where(splash, d_new, st["d"])
        st["nP"] = torch.where(splash, np_new, st["nP"])
        st["U"] = torch.where(splash[:, None], u_dir * u_mag_new[:, None], st["U"])
        st["rng"] = ks[0]
        # the film takes the absorbed mass and the splashes' remainder
        m_to_film = torch.where(absorb, m, zero) + torch.where(splash, m - m_splash, zero)
        fsum = CellSum(bidx, nB, keep=absorb | splash)
        src = dict(src)
        src["filmMass"] = src["filmMass"] + fsum(m_to_film)
        src["filmEnthalpy"] = src["filmEnthalpy"] + fsum(m_to_film * h_rel)
        return st, src

    # ------------------------------------------------------------------
    def evolve(self, st: Dict, gas: Dict, dt) -> Tuple[Dict, Dict]:
        """One gas-step evolution. `gas` holds per-cell carrier arrays:
        rho, U, T, p, mu, kappa, cp, Yv, W (and t). Returns (state, sources)."""
        nC = self.geom.n_cells
        kw = dict(dtype=self.dtype, device=self.device)
        src = {
            "rhoTrans": torch.zeros(nC, **kw),
            "UTrans": torch.zeros((nC, 3), **kw),
            "hsTrans": torch.zeros(nC, **kw),
            "filmMass": torch.zeros(self.geom.n_boundary, **kw),
            "filmEnthalpy": torch.zeros(self.geom.n_boundary, **kw),
            "escapedMass": torch.zeros((), **kw),
            "expansionMass": torch.zeros((), **kw),
            "droppedMass": torch.zeros((), **kw),
        }
        if self.devol is not None:
            # per-volatile devolatilised mass to the carrier [nVol, nC], and
            # the volatile ledger (logged only): injected, and carried out of
            # the cloud by parcels that leave it (escaped, dropped, caught)
            src["dvTrans"] = torch.zeros((self.devol.n_vol, nC), **kw)
            src["volatileInjected"] = torch.zeros((), **kw)
            src["volatileLost"] = torch.zeros((), **kw)
        if self.multi_liq:
            # per-component evaporated mass [nLiq, nC] — routed to each
            # component's own carrier species by the solver
            src["pcTrans"] = torch.zeros((self.n_liq, nC), **kw)
        if self.cfg.radiation:
            nb = self.cfg.n_bands
            for k in ("radAp", "radSigp", "radAsy", "radEpT4"):
                src[k] = torch.zeros((nb, nC), **kw)
        if self.part is not None:
            src["migrated"] = torch.zeros((), dtype=torch.int64, device=self.device)
            src["migrOverflow"] = torch.zeros((), dtype=torch.int64, device=self.device)
        if not self.cfg.active:
            return st, src

        st = dict(st)
        st["cell"] = st["cell"].to(INT_DTYPE)
        alive_ref = st["alive"]
        st = self._inject(st, gas["t"], dt, gas, src)
        if self.devol is not None:
            alive_ref = self._count_lost(st, alive_ref, src)

        # stochastic collision (KinematicCloud.C:205): SuppressionCollision
        # driven by the suppressing cloud's per-cell swept-volume rate
        if self.suppression is not None and gas.get("vDotSweep_sup") is not None:
            st = self.suppression.collide(st, gas["vDotSweep_sup"], dt)

        # cloud function object preEvolve (VoidFraction zeroes θ each step)
        if self.cloud_functions:
            st["cfo"] = [
                f.reset(fst) if hasattr(f, "reset") else fst
                for f, fst in zip(self.cloud_functions, st["cfo"])
            ]

        dt_sub = dt / self.cfg.n_sub
        for _ in range(self.cfg.n_sub):
            # ballistic move + containment walk (wall interactions inside)
            mass_before = self._mass(st)
            x_pre = st["x"]
            if self.pair_collision is not None:
                # DEM sub-cycled contact forces + motion (PairCollision::
                # collide); x advances inside the sub-cycles, which take the
                # place of the ballistic pre-move
                stc, pc = self.pair_collision.collide(st, st["pc"], self.cfg.rho0, dt_sub)
                st = dict(st)
                st.update(x=stc["x"], U=stc["U"], pc=pc)
                x = st["x"]
            else:
                x = st["x"] + torch.where(st["alive"][:, None], st["U"] * dt_sub, 0.0)
            x, U, cell, alive, hit, code = self.walk.walk(
                x, st["U"], st["cell"], st["alive"], self.b_code, self.b_e,
                n_steps=self.cfg.walk_steps,
            )
            died = st["alive"] & ~alive
            st = dict(st)
            st.update(x=x, U=U, cell=cell, alive=alive)
            # particle collectors: segment-crossing accumulation
            if self.collectors:
                cstates = []
                ks = prng.split(st["rng"], len(self.collectors) + 1)
                st["rng"] = ks[0]
                for c, cst, ck in zip(self.collectors, st["coll"], ks[1:]):
                    cst, caught = c.collect(
                        cst, x_pre, st["x"], mass_before, st["d"], st["U"],
                        st["alive"], dt_sub, key=ck,
                    )
                    if c.remove_collected or c.fixed_mass_remove or c.cont_mass_remove:
                        st["alive"] = st["alive"] & ~caught
                    cstates.append(cst)
                st["coll"] = cstates
            # escaped-mass bookkeeping
            esc = died & (code == INTERACT_ESCAPE)
            src["escapedMass"] = src["escapedMass"] + torch.sum(torch.where(esc, mass_before, 0.0))
            # cloud function objects: postPatch on wall strikes
            if self.cloud_functions:
                b_normal = self.geom.b_Sf / self.geom.b_magSf[:, None]
                hit_mask = hit >= 0
                hit_c = torch.clamp(hit, min=0)
                cfos = []
                for f, fst in zip(self.cloud_functions, st["cfo"]):
                    if hasattr(f, "post_patch"):
                        fst = f.post_patch(fst, st, hit_c, hit_mask, mass_before, U, b_normal)
                    cfos.append(fst)
                st["cfo"] = cfos
            # film interaction (absorb / Bai-Gosman splash)
            st, src = self._film_interaction(st, src, code, hit, mass_before, gas.get("film_delta_b"))
            if self.part is not None:
                st, src = self._migrate(st, src)
            # physics + gas-side sources
            st, src = self._calc(st, gas, dt_sub, src)
            # cloud function objects: postMove (void fraction, tracks, trap)
            if self.cloud_functions:
                cfos = []
                for f, fst in zip(self.cloud_functions, st["cfo"]):
                    if hasattr(f, "post_move"):
                        fst, st = f.post_move(fst, st, dt_sub, dt, gas, self.geom)
                    cfos.append(fst)
                st = dict(st)
                st["cfo"] = cfos
            if self.devol is not None:
                alive_ref = self._count_lost(st, alive_ref, src)

        # MPPIC dense-phase corrections at the step's end (MPPICCloud::motion:
        # damping → packing → isotropy on the settled positions); its key is
        # split from st["rng"] after the substeps'
        if self.mppic is not None:
            st = dict(st)
            st["rng"], sub_key = prng.split(st["rng"])
            st = self.mppic.apply(st, self.geom, dt, sub_key)

        if self.cfg.radiation:
            # time-averaged dispersed-phase radiation fields for the RTE
            # (ThermoCloud::ap/sigmap/Ep — ThermoCloudI.H:377-492: the dt
            # accumulation divides by the flow Δt; V division here)
            Vdt = self.geom.V[None, :] * torch.clamp(dt, min=self._small)
            src["cloud_rad"] = {
                "ap": src.pop("radAp") / Vdt,
                "sigmap": src.pop("radSigp") / Vdt,
                "asy": src.pop("radAsy") / Vdt,
                "Ep": SIGMA_SB * src.pop("radEpT4") / Vdt,
            }
        return st, src

    def _migrate(self, st: Dict, src: Dict) -> Tuple[Dict, Dict]:
        """The partitioned handoff (switchProcessor, KinematicParcel.C:
        330-333): the walk of a parcel that left this partition stopped in
        the halo cell it entered (the halo rows have no faces). Before the
        physics, so that the sources accumulate on owned cells only, each
        such parcel moves to the owner of that cell, which finishes the
        containment walk from there: the parcel ends in the cell the
        unpartitioned walk finds (a parcel that escapes on the way counts as
        escaped; its wall interactions there skip the film and the cloud
        functions). Rounds go on while the count of parcels in halo cells,
        summed over the ranks (one host read of a replicated value a round),
        is above 0: a parcel that crosses into a third partition on the way
        moves again, and one beyond the send capacity (pi.cap_send a round
        and target) keeps its halo cell and goes in a later round. So no
        parcel is left in a halo cell for the physics. src["migrated"]
        counts the parcels this rank sent, src["migrOverflow"] the parcels
        held back a round (summed over the ranks)."""
        from ..parallel.parcels import exchange_parcels

        pi = self.part
        keys = ("x", "U", "d", "T", "nP", "cell", "age", "canCombust", "typeId", "cp0") + tuple(
            k for k in ("mv", "mv0", "ms", "Yl") if k in st)
        st = dict(st)
        # a straight path crosses each RCB box or slab once, and a send
        # capacity holds a parcel back at most cap / cap_send rounds
        max_rounds = pi.n_parts - 1 + -(-st["alive"].shape[0] // pi.cap_send)
        for rnd in range(max_rounds + 1):
            in_halo = st["alive"] & (st["cell"] >= pi.n_own)
            if int(pi.preduce(torch.sum(in_halo))) == 0:
                break
            if rnd == max_rounds:
                raise RuntimeError(f"parcel migration: parcels still in halo cells after "
                                   f"{max_rounds} rounds")
            hslot = torch.clamp(st["cell"] - pi.n_own, min=0)
            dest = torch.where(in_halo, pi.halo_owner[hslot], torch.full_like(hslot, -1))
            soa = {k: st[k] for k in keys}
            soa["cell"] = torch.where(in_halo, pi.halo_local[hslot],
                                      st["cell"]).to(st["cell"].dtype)
            soa, alive, left, n_over = exchange_parcels(
                pi.comm, soa, st["alive"], dest, pi.n_parts, pi.cap_send)
            # a parcel held back stays in its slot with its halo cell (its
            # walk stops there at once)
            kept = alive & (left >= 0)
            soa["cell"] = torch.where(kept, st["cell"], soa["cell"])
            x, U, cell, alive2, _, code = self.walk.walk(
                soa["x"], soa["U"], soa["cell"], alive, self.b_code, self.b_e,
                n_steps=self.cfg.walk_steps)
            st.update(soa)
            esc = alive & ~alive2 & (code == INTERACT_ESCAPE)
            src["escapedMass"] = src["escapedMass"] + torch.sum(
                torch.where(esc, self._mass(st), 0.0))
            st.update(x=x, U=U, cell=cell, alive=alive2)
            src["migrOverflow"] = src["migrOverflow"] + n_over
            src["migrated"] = src["migrated"] + torch.sum(in_halo) - torch.sum(kept)
        return st, src

    def _count_lost(self, st, alive_ref, src):
        """src["volatileLost"] += the volatiles of the parcels alive in
        `alive_ref` and gone from st; returns st's alive mask."""
        gone = alive_ref & ~st["alive"]
        v = self._volatiles(st)
        src["volatileLost"] = src["volatileLost"] + torch.sum(torch.where(gone, v,
                                                                          torch.zeros_like(v)))
        return st["alive"]

    # ------------------------------------------------------------------
    def write_sprinkler_logs(self, st: Dict, out_dir: str):
        """Per-sprinkler master log files (DetailedSprinklerInjection.H:
        154-156 filePtr_, .C:469,567: each head logs its link temperature,
        activation time and flow): postProcessing/sprinklers/<injector>.dat
        with one row per head."""
        rows_written = False
        for inj, ist in zip(self.injectors, st["inj"]):
            if "Te" not in ist:
                continue  # not an RTI-linked sprinkler model
            d = os.path.join(out_dir, "sprinklers")
            os.makedirs(d, exist_ok=True)
            Te = ist["Te"].double().cpu().numpy()
            t_act = ist["t_act"].double().cpu().numpy()
            Q = getattr(inj, "Q", 0.0)
            pos = getattr(inj, "positions", np.zeros((Te.shape[0], 3)))
            with open(os.path.join(d, f"{inj.name}.dat"), "w") as f:
                f.write(f"# sprinkler injector {inj.name}\n")
                f.write("# head x y z Tlink[K] tAct[s] activated Q[m3/s]\n")
                for i in range(Te.shape[0]):
                    act = t_act[i] >= 0.0
                    f.write(
                        f"{i}\t{pos[i][0]:.6g}\t{pos[i][1]:.6g}\t"
                        f"{pos[i][2]:.6g}\t{Te[i]:.6g}\t"
                        f"{t_act[i] if act else -1:.6g}\t{int(act)}\t"
                        f"{(Q if act else 0.0):.6g}\n"
                    )
            rows_written = True
        return rows_written

    def write_collectors(self, st: Dict, out_dir: str):
        """Per-collector dat files: bin masses, mean velocity, dv50
        (ParticleCollectorFmg master-only log files)."""
        for c, cst in zip(self.collectors, st["coll"]):
            s = c.summarise(cst)
            d = os.path.join(out_dir, c.name)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "collector.dat"), "w") as f:
                f.write(f"# particleCollector {c.name} mode={c.mode}\n")
                f.write(f"# collection time {s['time']:.8g} s, dv50 {s['dv50']:.8g} m\n")
                f.write("# bin mass[kg] meanVel[m/s]\n")
                for i, (m, v) in enumerate(zip(s["mass"], s["velocity"])):
                    f.write(f"{i}\t{m:.8g}\t{v:.8g}\n")

    # ------------------------------------------------------------------
    def info(self, st: Dict) -> Dict:
        m = self._mass(st)
        alive = st["alive"]
        red = self.part.preduce if self.part is not None else (lambda v: v)
        mx = self.part.pmax if self.part is not None else (lambda v: v)
        return {
            "nParcels": red(torch.sum(alive.to(torch.int32))),
            "massInSystem": red(torch.sum(m)),
            "Dmax": mx(torch.max(torch.where(alive, st["d"], 0.0))),
            "D32": red(torch.sum(torch.where(alive, st["nP"] * st["d"] ** 3, 0.0)))
            / torch.clamp(red(torch.sum(torch.where(alive, st["nP"] * st["d"] ** 2, 0.0))),
                          min=self._small),
        }


def _nested(v, nb):
    """Parse a List<List<scalar>> dict entry into [nDia][nBands] floats."""
    rows = []
    for row in v if isinstance(v, list) else []:
        if isinstance(row, list):
            rows.append([float(x) for x in row])
        else:
            rows.append([float(row)] * nb)
    return rows or [[0.5] * nb]
