"""Per-partition solver localization: the explicitly partitioned step.

The PyTorch port of firefoam_tpu/parallel/localize.py. The reference runs
the WHOLE solver distributed: every fvMatrix solve, snGrad and interpolate
exchanges processor-patch halos and every gSum/gMin/gMax is an MPI
all-reduce (solver/pEqn.H:39). Here:

  * `ShardGeometry` — a SEG MeshGeometry over one partition's EXTENDED cell
    set [owned ‖ halo] whose face→cell sums end in a halo refresh and
    whose global reductions (rsum/rmax/...) are psum/pmax collectives of
    the rank's parallel.comm.Comm. Cell fields carry their halo values, so
    every POINTWISE op stays consistent for free; only the sums and the
    solve outputs need the refresh (which the overrides provide). Pad and
    halo slots may hold NaN, so the masks are `where`, never products.
  * `Localizer` — builds, for a global case, the partition and the scatter
    maps for cells / internal faces / boundary faces (patch-major, each
    patch padded to its largest count over the partitions, so every
    partition presents the SAME patch layout and every rank runs the same
    sequence of collectives).

Each partition's order-fixed tables (the SegSum face→cell tables, the
boundary groups and the cloud's tracking.CellSum) are built from its own
local arrays. A partition's faces keep the global face order and its
boundary faces the global patch order, so the sums into an owned cell add
the same terms in the same order as the global SEG geometry does.

parallel/spmd_step.SpmdFireFoam then builds one FireFoamSolver(local=ctx)
per rank over these geometries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import INT_DTYPE, default_device
from ..ops.geometry import MeshGeometry, PatchInfo, SegSum
from .partition import MeshPartition, lattice_from_graph, rcb_partition, slab_partition
from .sharded import halo_exchange, psum_reducers, rank_plan

__all__ = [
    "ShardGeometry",
    "Localizer",
    "LocalContext",
    "PartInfo",
    "colocate_coupled_patches",
    "localize_walkmesh",
    "make_part_info",
]


@dataclass
class ShardGeometry(MeshGeometry):
    """One partition's extended-local SEG geometry with collectives."""

    comm: object = None  # parallel.comm.Comm of this rank
    n_own_slots: int = 0  # halo starts here (== n_loc_max)
    halo_size: int = 0
    cell_w: Optional[torch.Tensor] = None  # [n_ext] 1 at owned real cells
    b_valid: Optional[torch.Tensor] = None  # [nB_loc]
    halo_plan: Tuple = ()  # ((send_idx, send_mask, recv_slot, perm), ...)

    # -------------------------------------------------------------- halo
    def sync(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.halo_size == 0:
            return x
        xd = x.movedim(dim, 0)
        own = xd[: self.n_own_slots]
        halo = halo_exchange(self.comm, own, self.halo_plan, self.halo_size)
        return torch.cat([own, halo], dim=0).movedim(0, dim)

    # --------------------------------------------------------- scatters
    def face_to_own_sum(self, fv):
        return self.sync(super().face_to_own_sum(fv))

    def face_to_nei_sum(self, fv):
        return self.sync(super().face_to_nei_sum(fv))

    def face_to_both_sum(self, fv_own, fv_nei):
        # ONE halo refresh for the own+nei pair: the refresh only copies
        # owner values into halo slots, so it is linear in the summed
        # values — sync(a) + sync(b) == sync(a + b)
        return self.sync(MeshGeometry.face_to_both_sum(self, fv_own, fv_nei))

    def boundary_to_cell_sum(self, bv):
        # where, not multiply: pad-slot BC coefficients may be NaN (they are
        # computed from sentinel geometry) and NaN*0 == NaN
        w = self.b_valid if bv.ndim == 1 else self.b_valid.reshape((-1,) + (1,) * (bv.ndim - 1))
        return self.sync(super().boundary_to_cell_sum(torch.where(w > 0, bv, torch.zeros_like(bv))))

    # ------------------------------------------------------- reductions
    def _wc(self, x):
        return self.cell_w if x.ndim == 1 else self.cell_w.reshape((-1,) + (1,) * (x.ndim - 1))

    def _big(self, x):
        return torch.finfo(x.dtype).max / 4

    def _masked(self, x):
        return torch.where(self._wc(x) > 0, x, torch.zeros_like(x))

    def rsum(self, x):
        return self.comm.psum(torch.sum(self._masked(x), dim=0))

    def rmax(self, x):
        m = torch.max(torch.where(self._wc(x) > 0, x, torch.full_like(x, -self._big(x))))
        return self.comm.pmax(m)

    def rmin(self, x):
        m = torch.min(torch.where(self._wc(x) > 0, x, torch.full_like(x, self._big(x))))
        return self.comm.pmin(m)

    def rmean(self, x):
        return self.rsum(x) / self.rcount()

    def rcount(self):
        return self.comm.psum(torch.sum(self.cell_w))

    def rminc(self, x):
        m = torch.amin(torch.where(self._wc(x) > 0, x, torch.full_like(x, self._big(x))), dim=0)
        return self.comm.pmin(m)

    def rmaxc(self, x):
        m = torch.amax(torch.where(self._wc(x) > 0, x, torch.full_like(x, -self._big(x))), dim=0)
        return self.comm.pmax(m)

    def rmeanc(self, x):
        return self.rsum(x) / self.rcount()

    def _bv(self, x, sl):
        v = self.b_valid[sl] if sl is not None else self.b_valid
        y = x[sl] if sl is not None else x
        return y, (v if y.ndim == 1 else v.reshape((-1,) + (1,) * (y.ndim - 1)))

    def bsum(self, x, sl=None):
        y, v = self._bv(x, sl)
        return self.comm.psum(torch.sum(torch.where(v > 0, y, torch.zeros_like(y)), dim=0))

    def bmax(self, x, sl=None):
        y, v = self._bv(x, sl)
        return self.comm.pmax(torch.max(torch.where(v > 0, y, torch.full_like(y, -self._big(y)))))

    def bmin(self, x, sl=None):
        y, v = self._bv(x, sl)
        return self.comm.pmin(torch.min(torch.where(v > 0, y, torch.full_like(y, self._big(y)))))

    def bmean(self, x, sl=None):
        y, v = self._bv(x, sl)
        s = self.comm.psum(torch.sum(torch.where(v > 0, y, torch.zeros_like(y)), dim=0))
        n = self.comm.psum(torch.sum(v if v.ndim == 1 else v.reshape(v.shape[0], -1)[:, 0]))
        return s / torch.clamp(n, min=1.0)

    def solver_reducers(self):
        return psum_reducers(self.comm, self.cell_w)


def _find_coupled(mesh) -> Dict[str, str]:
    """Baffle master/slave patch pairs by name convention (the JAX
    package's geometry._find_coupled; the port's geometry keeps no map)."""
    names = {p.name for p in mesh.patches}
    coupled = {}
    for n in names:
        if n.endswith("_master"):
            s = n[: -len("_master")] + "_slave"
            if s in names:
                coupled[n] = s
                coupled[s] = n
    return coupled


def colocate_coupled_patches(part: np.ndarray, geom, n_int: int, owner: np.ndarray,
                             coupled: Optional[Dict[str, str]] = None) -> np.ndarray:
    """Force owner cells of coupled (baffle) partner faces into the same
    partition as the primary side's owner, so thermalBaffle1D's partner-
    face gather (ops/bcs.py:_thermal_baffle_1d psi_b[nbr]) stays local.
    Applied in patch order; the master side wins."""
    part = part.copy()
    coupled = coupled or {}
    done = set()
    b_own = geom.b_own.cpu().numpy()
    b_cf = geom.b_Cf.double().cpu().numpy()
    for p in geom.patches:
        q = coupled.get(p.name)
        if q is None or p.name in done or q in done:
            continue
        done.add(p.name)
        done.add(q)
        pp, qq = p, geom.patch(q)
        my, th = b_cf[pp.slice], b_cf[qq.slice]
        d2 = ((my[:, None, :] - th[None, :, :]) ** 2).sum(-1)
        match = np.argmin(d2, axis=1)
        part[b_own[qq.start + match]] = part[b_own[pp.slice]]
    return part


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclass
class Localizer:
    """Scatter maps from the global mesh onto one MeshPartition."""

    mp: MeshPartition
    n_ext: int
    # boundary layout: patch-major, per-patch padded across partitions
    patches: Tuple[PatchInfo, ...]
    bmap: np.ndarray  # [P, nB_loc] global boundary slot (-1 pad)
    b_own_ext: np.ndarray  # [P, nB_loc] ext owner index (0 pad)
    halo_plan_perm: Tuple  # static perms per step
    # (nx, ny, nz) when the partition is a z-slab decomposition of a cuboid
    # lattice — the layout of the sharded lattice multigrid
    # (parallel/sharded_gmg.py, the reference's GAMG under decomposePar,
    # cases/steckler/system/fvSolution:63-71)
    slab_dims: Optional[Tuple[int, int, int]] = None

    # ------------------------------------------------------------ build
    @classmethod
    def build(cls, geom: MeshGeometry, cm, n_parts: int, method: str = "auto") -> "Localizer":
        """geom: the GLOBAL geometry in SEG layout; cm the global CaseMesh.

        method: "rcb" — recursive coordinate bisection (any mesh);
        "slab" — z-slab lattice decomposition (error if not a lattice);
        "auto" — slab when the mesh is a cuboid lattice whose nz divides
        n_parts AND no coupled-patch colocation constraint interferes,
        else rcb."""
        if method not in ("auto", "rcb", "slab"):
            raise ValueError(f"partition method {method!r}: 'auto', 'rcb' or 'slab'")
        mesh = cm.mesh
        n_int = mesh.n_internal_faces
        owner = np.asarray(mesh.owner)
        coupled = _find_coupled(mesh)
        slab_dims = None
        part = None
        if method in ("slab", "auto"):
            dims = lattice_from_graph(owner, np.asarray(mesh.neighbour), mesh.n_cells)
            sp = slab_partition(dims, n_parts) if dims is not None else None
            if sp is not None:
                adj = colocate_coupled_patches(sp, geom, n_int, owner, coupled)
                if (adj == sp).all():
                    part, slab_dims = sp, dims
            if part is None and method == "slab":
                raise ValueError(
                    "method='slab' needs a cuboid x-fastest lattice with "
                    f"nz divisible by {n_parts} and no coupled-patch "
                    "colocation constraints"
                )
        if part is None:
            part = colocate_coupled_patches(
                rcb_partition(np.asarray(mesh.C), n_parts), geom, n_int, owner, coupled)
        mp = MeshPartition.build(
            np.asarray(mesh.C), owner, np.asarray(mesh.neighbour),
            n_parts, b_own=owner[n_int:], part_of_cell=part,
        )
        P = n_parts
        n_ext = mp.n_loc_max + mp.h_max

        # boundary: patch-major, padded per patch to the max over parts
        b_owner_part = part[owner[n_int:]]
        pat_out: List[PatchInfo] = []
        bmap_cols = []
        start = 0
        for p in geom.patches:
            gsl = np.arange(p.start, p.start + p.n)
            per = [gsl[b_owner_part[gsl] == q] for q in range(P)]
            w = max((len(x) for x in per), default=0)
            w = max(w, 1) if p.n > 0 else 0
            block = np.full((P, w), -1, np.int64)
            for q in range(P):
                block[q, : len(per[q])] = per[q]
            bmap_cols.append(block)
            pat_out.append(PatchInfo(p.name, p.ptype, start, w))
            start += w
        bmap = np.concatenate(bmap_cols, axis=1) if bmap_cols else np.zeros((P, 0), np.int64)
        ok = bmap >= 0
        b_own_ext = np.zeros_like(bmap)
        gb = np.maximum(bmap, 0)
        b_own_ext[ok] = mp.g2l[owner[n_int:][gb[ok]]]

        perms = tuple(tuple((q, (q + st.offset) % P) for q in range(P)) for st in mp.steps)
        return cls(mp=mp, n_ext=n_ext, patches=tuple(pat_out), bmap=bmap,
                   b_own_ext=b_own_ext, halo_plan_perm=perms, slab_dims=slab_dims)

    # ---------------------------------------------------- slab face maps
    def slab_face_maps(self, p: int, owner: np.ndarray, neighbour: np.ndarray) -> dict:
        """For slab partitions: per-axis map [n_loc] from each owned cell's
        slab slot to the LOCAL face index of its +axis face (sentinel
        n_face_max where the face doesn't exist — lattice boundary, or a
        z-face owned by the previous slab, which arrives by ppermute).

        axis keys follow sharded_gmg's [z, y, x] view: 2 = +x (off 1),
        1 = +y (off nx), 0 = +z (off nx*ny). Both u and l coefficients of
        the face (c, c+off) live at cell c (sharded_gmg._matvec3_slab), so
        ONE map per axis serves upper and lower gathers."""
        assert self.slab_dims is not None
        nx, ny, nz = self.slab_dims
        mp = self.mp
        n_loc = mp.n_loc_max
        base = p * n_loc  # slab partitions are exact: slot i = base + i
        fg = mp.face_gid[p]
        valid = mp.face_valid[p] > 0
        own_g = np.asarray(owner)[fg]
        nei_g = np.asarray(neighbour)[fg]
        diff = nei_g - own_g
        mine = (own_g >= base) & (own_g < base + n_loc)
        maps = {}
        for ax, off in ((2, 1), (1, nx), (0, nx * ny)):
            idx = np.full(n_loc, mp.n_face_max, np.int64)
            sel = valid & mine & (diff == off)
            idx[own_g[sel] - base] = np.nonzero(sel)[0]
            maps[ax] = idx
        return maps

    # --------------------------------------------------------- scatters
    def cells(self, x: np.ndarray, pad=None, halo=True) -> np.ndarray:
        """Global cell array [nC(,k)] → [P, n_ext(,k)] with halo values
        filled from the owning cells (so pointwise consistency holds).
        Pad slots default to the first cell's value: physically-plausible
        padding keeps thermo/EOS evaluations on padding cells finite."""
        x = np.asarray(x)
        mp = self.mp
        if pad is None:
            pad = x[0] if x.ndim == 1 else None
        if pad is None:
            out = np.broadcast_to(x[0], (mp.n_parts, self.n_ext) + x.shape[1:]).copy()
        else:
            out = np.full((mp.n_parts, self.n_ext) + x.shape[1:], pad, x.dtype)
        ok = mp.l2g >= 0
        out[:, : mp.n_loc_max][ok] = x[mp.l2g[ok]]
        if halo and mp.h_max:
            hk = mp.halo_g >= 0
            out[:, mp.n_loc_max:][hk] = x[np.maximum(mp.halo_g, 0)[hk]]
        return out

    def gather_cells(self, xl: np.ndarray) -> np.ndarray:
        mp = self.mp
        out = np.zeros((mp.n_cells,) + xl.shape[2:], xl.dtype)
        ok = mp.l2g >= 0
        out[mp.l2g[ok]] = np.asarray(xl)[:, : mp.n_loc_max][ok]
        return out

    def ifaces(self, f: np.ndarray, pad=0.0) -> np.ndarray:
        """Global internal-face array [nI(,k)] → [P, nF_loc(,k)]."""
        f = np.asarray(f)
        mp = self.mp
        out = np.full((mp.n_parts, mp.n_face_max) + f.shape[1:], pad, f.dtype)
        v = mp.face_valid > 0
        out[v] = f[mp.face_gid[v]]
        return out

    def gather_ifaces(self, fl: np.ndarray, n_int: int) -> np.ndarray:
        mp = self.mp
        out = np.zeros((n_int,) + fl.shape[2:], np.asarray(fl).dtype)
        v = mp.face_valid > 0
        out[mp.face_gid[v]] = np.asarray(fl)[v]
        return out

    def bfaces(self, b: np.ndarray, pad=0.0) -> np.ndarray:
        """Global boundary array [nB(,k)] → [P, nB_loc(,k)]."""
        b = np.asarray(b)
        out = np.full((self.bmap.shape[0], self.bmap.shape[1]) + b.shape[1:], pad, b.dtype)
        ok = self.bmap >= 0
        out[ok] = b[self.bmap[ok]]
        return out

    def gather_bfaces(self, bl: np.ndarray, n_b: int) -> np.ndarray:
        out = np.zeros((n_b,) + np.asarray(bl).shape[2:], np.asarray(bl).dtype)
        ok = self.bmap >= 0
        out[self.bmap[ok]] = np.asarray(bl)[ok]
        return out

    # ------------------------------------------------------- geometry
    def make_geom(self, geom: MeshGeometry, p: int, comm=None, device=None) -> ShardGeometry:
        """Partition p's ShardGeometry from the GLOBAL geometry (SEG layout,
        so face arrays index real faces). Every array is scattered from the
        global geometry's own tensors, so each owned value is the global
        one bit for bit."""
        assert geom.layout == "seg", "localize from a SEG-layout geometry"
        mp = self.mp
        dt = geom.dtype
        dev = torch.device(device) if device is not None else geom.device

        def r(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        def ix(a):
            return torch.as_tensor(np.asarray(a, np.int64), dtype=INT_DTYPE, device=dev)

        def c(x, pad=0.0):
            return self.cells(_np(x), pad)[p]

        def f(x, pad=0.0):
            return self.ifaces(_np(x), pad)[p]

        def b(x, pad=0.0):
            return self.bfaces(_np(x), pad)[p]

        n_ext = self.n_ext
        fv = mp.face_valid[p]
        # pad faces point at cell 0 with zero coefficients
        own = np.where(fv > 0, mp.face_own[p], 0).astype(np.int64)
        nei = np.where(fv > 0, mp.face_nei[p], 0).astype(np.int64)
        cell_w = np.zeros(n_ext)
        cell_w[: mp.n_loc_max] = mp.cell_mask[p]
        bok = self.bmap[p] >= 0
        b_valid = bok.astype(np.float64)
        # pad boundary geometry: unit area/dc with off-domain centres so
        # baffle nearest-face matching never picks a pad slot
        nB = self.bmap.shape[1]
        b_cf_pad = np.zeros((nB, 3))
        b_cf_pad[:, 0] = 1e6 + np.arange(nB)
        b_cf = np.where(bok[:, None], b(geom.b_Cf), b_cf_pad)
        b_sf = np.where(bok[:, None], b(geom.b_Sf), np.array([1.0, 0.0, 0.0]))
        b_own = self.b_own_ext[p]
        # boundary groups: the valid faces ranked among their owner cell's
        # faces in local (= global patch) order; owners distinct per group
        bf = np.nonzero(bok)[0]
        bo = b_own[bf]
        order = np.argsort(bo, kind="stable")
        first = np.searchsorted(bo[order], bo[order], side="left")
        rank = np.empty(len(bf), np.int64)
        rank[order] = np.arange(len(bf)) - first
        b_groups = tuple(
            (ix(bf[rank == k]), ix(bo[rank == k])) for k in range(int(rank.max(initial=-1)) + 1))
        keep = fv > 0
        plan = rank_plan(mp, p, dev, dt)
        return ShardGeometry(
            n_cells=n_ext,
            n_internal=mp.n_face_max,
            n_boundary=nB,
            own=ix(own),
            nei=ix(nei),
            w=r(f(geom.w)),
            Sf=r(f(geom.Sf)),
            magSf=r(f(geom.magSf)),
            dc=r(f(geom.dc)),
            nodc=r(f(geom.nodc)),
            Cf=r(f(geom.Cf)),
            face_mask=r(fv),
            V=r(c(geom.V, pad=1.0)),
            C=r(c(geom.C)),
            b_own=ix(b_own),
            b_Sf=r(b_sf),
            b_magSf=r(b(geom.b_magSf, pad=1.0)),
            b_dc=r(b(geom.b_dc, pad=1.0)),
            b_nodc=r(b(geom.b_nodc, pad=1.0)),
            b_Cf=r(b_cf),
            b_groups=b_groups,
            patches=self.patches,
            offsets=(),
            face_perm=np.asarray(mp.face_gid[p]),
            layout="seg",
            C_own_f=r(f(geom.C_own_f)),
            C_nei_f=r(f(geom.C_nei_f)),
            d_face=r(f(geom.d_face)),
            # the reconstruct inverse is scattered from the global one
            recon_inv=r(self.cells(_np(geom.recon_inv))[p]),
            seg_own=SegSum(own, n_ext, dev, keep=keep),
            seg_nei=SegSum(nei, n_ext, dev, keep=keep),
            seg_both=SegSum(np.concatenate([own, nei]), n_ext, dev,
                            keep=np.concatenate([keep, keep])),
            comm=comm,
            n_own_slots=mp.n_loc_max,
            halo_size=mp.h_max,
            cell_w=r(cell_w),
            b_valid=r(b_valid),
            halo_plan=plan,
        )


@dataclass
class PartInfo:
    """Partition identity the Lagrangian cloud needs for partitioned
    tracking: the reference's switchProcessor/hitProcessorPatch handoff
    (KinematicParcel.C:330-333,402-412) becomes: walk stops in a halo slot
    -> dest = owning partition, cell rewritten to the owner-local id, ring
    all-to-all rounds (parallel/parcels.py)."""

    cell_map: torch.Tensor  # [nC_global] -> local ext id, -1 if not owned
    halo_owner: torch.Tensor  # [h_max] owning part of each halo slot
    halo_local: torch.Tensor  # [h_max] owner-local cell id of each halo slot
    n_own: int  # owned-slot count (halo starts here)
    n_parts: int
    comm: object = None
    cap_send: int = 512

    def preduce(self, v):
        return self.comm.psum(v)

    def pmax(self, v):
        return self.comm.pmax(v)

    def pmin(self, v):
        return self.comm.pmin(v)


@dataclass
class LocalContext:
    """Everything FireFoamSolver needs to build itself over one partition."""

    geom: ShardGeometry
    lz: Localizer
    p: int
    cm: object  # the global CaseMesh
    global_geom: MeshGeometry  # global SEG geometry (host) used for field reads
    walk_g: object = None  # global WalkMesh (cloud cases; host)
    comm: object = None
    cap_send: int = 512  # parcels a migration round sends to one partition

    def walk_local(self, dtype=None):
        return localize_walkmesh(self.walk_g, self.lz, self.p, dtype, self.geom.device)

    def part_info(self) -> PartInfo:
        return make_part_info(self.lz, self.p, self.geom.device, comm=self.comm,
                              cap_send=self.cap_send)

    def slab_info(self):
        """(dims, n_parts, {axis: face map}) when this partition is a
        z-slab of a lattice (see Localizer.slab_face_maps), else None —
        what FireFoamSolver needs to hand p_rgh to the sharded lattice
        multigrid."""
        if self.lz.slab_dims is None:
            return None
        mesh = self.cm.mesh
        maps = self.lz.slab_face_maps(
            self.p, np.asarray(mesh.owner[: mesh.n_internal_faces]), np.asarray(mesh.neighbour))
        return self.lz.slab_dims, self.lz.mp.n_parts, maps

    @classmethod
    def build_all(cls, cm, n_parts: int, dtype=torch.float64, device=None, comm=None,
                  with_walk: bool = False, method: str = "auto", parts=None):
        """One SEG global geometry (on the host) + localizer + the contexts
        of `parts` (default: all) with their geometry on `device` (default:
        the card; raises where there is none)."""
        device = torch.device(device) if device is not None else default_device()
        gg = MeshGeometry.from_polymesh(cm.mesh, dtype=dtype, device="cpu", layout="seg")
        lz = Localizer.build(gg, cm, n_parts, method=method)
        walk_g = None
        if with_walk:
            from ..lagrangian.tracking import WalkMesh

            walk_g = WalkMesh.from_polymesh(cm.mesh, dtype=dtype, device="cpu")
        parts = range(n_parts) if parts is None else parts
        return gg, lz, [
            cls(geom=lz.make_geom(gg, p, comm=comm, device=device), lz=lz, p=p, cm=cm,
                global_geom=gg, walk_g=walk_g, comm=comm)
            for p in parts
        ]


def localize_walkmesh(walk_g, lz: Localizer, p: int, dtype, device):
    """Partition p's WalkMesh over the extended cell set. Owned rows are
    the global rows with neighbour ids remapped to ext indices (halo slot
    for remote neighbours); halo/pad rows have zero normals so the
    containment walk STOPS there — arrival in a halo slot is the
    migration event."""
    from ..lagrangian.tracking import WalkMesh

    dtype = dtype or torch.float64
    mp = lz.mp
    F = walk_g.max_faces
    n_ext = lz.n_ext
    cf_Cf = np.zeros((n_ext, F, 3))
    cf_n = np.zeros((n_ext, F, 3))
    cf_nei = np.full((n_ext, F), -1, np.int64)
    cf_bidx = np.full((n_ext, F), -1, np.int64)
    tol = np.full(n_ext, 1.0)
    C = lz.cells(np.asarray(walk_g._h_C))[p]

    own_gids = mp.l2g[p][mp.l2g[p] >= 0]
    rows = np.arange(len(own_gids))
    cf_Cf[rows] = np.asarray(walk_g._h_cf_Cf)[own_gids]
    cf_n[rows] = np.asarray(walk_g._h_cf_n)[own_gids]
    tol[rows] = np.asarray(walk_g._h_tol)[own_gids]

    # neighbour remap: global cell -> ext id (own slot or halo slot)
    ext_of = np.full(mp.n_cells, -1, np.int64)
    ext_of[own_gids] = rows
    hg = mp.halo_g[p]
    hok = hg >= 0
    ext_of[hg[hok]] = mp.n_loc_max + np.nonzero(hok)[0]
    nei_g = np.asarray(walk_g._h_cf_nei)[own_gids]
    cf_nei[rows] = np.where(nei_g >= 0, ext_of[np.maximum(nei_g, 0)], -1)

    # boundary index remap: global boundary slot -> partition-local slot
    ok = lz.bmap[p] >= 0
    binv_full = np.full(int(lz.bmap.max()) + 2, -1, np.int64)
    binv_full[lz.bmap[p][ok]] = np.nonzero(ok)[0]
    bidx_g = _np(walk_g.cf_bidx)[own_gids]
    cf_bidx[rows] = np.where(bidx_g >= 0, binv_full[np.maximum(bidx_g, 0)], -1)

    def r(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def ix(a):
        return torch.as_tensor(a, dtype=INT_DTYPE, device=device)

    return WalkMesh(
        max_faces=F, cf_Cf=r(cf_Cf), cf_n=r(cf_n), cf_nei=ix(cf_nei), cf_bidx=ix(cf_bidx),
        tol=r(tol), C=r(C), _h_cf_Cf=cf_Cf, _h_cf_n=cf_n, _h_cf_nei=cf_nei, _h_tol=tol,
        _h_C=np.asarray(C),
    )


def make_part_info(lz: Localizer, p: int, device, comm=None, cap_send=512) -> PartInfo:
    mp = lz.mp
    cell_map = np.full(mp.n_cells, -1, np.int64)
    own_gids = mp.l2g[p][mp.l2g[p] >= 0]
    cell_map[own_gids] = np.arange(len(own_gids))

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64), dtype=INT_DTYPE, device=device)

    return PartInfo(
        cell_map=ix(cell_map),
        halo_owner=ix(mp.halo_owner_part()[p]),
        halo_local=ix(mp.halo_remote_local()[p]),
        n_own=mp.n_loc_max,
        n_parts=mp.n_parts,
        comm=comm,
        cap_send=cap_send,
    )
