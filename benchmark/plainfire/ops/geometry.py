"""Device-side mesh geometry for the port: tensors for the step.

Extracted once from the host-side PolyMesh, in one of the JAX package's
layouts `dia` (also as `banded`), `seg` and `hybrid` (its lattice-slab
boundary scatter is not ported):

  * DIA (offset stencil): internal faces live in a padded array of nO·nC
    slots; slot (o, c) holds the face from cell c to cell c + offsets[o]
    (zero coefficients where absent). blockMesh lattices are lexicographic,
    so they fit with 3 offsets (1, nx, nx·ny): face↔cell motion is a roll
    or a shift per offset plus elementwise math. With more offsets (up to
    16; up to 64 under `banded`, a castellated mesh in its own numbering or
    renumbered by mesh/renumber.py) it goes through the lanes' gathers
    (`lane_indices`): one gather, or one gather and one ordered sum, for
    any number of offsets.
  * SEG (any mesh, e.g. a snappyHexMesh castellation): internal faces in
    the mesh's own order, unpadded. Cell→face motion is a gather x[own] /
    x[nei]; face→cell sums go through tables the host sorted once
    (`SegSum`): row c lists the faces of cell c in ascending face order,
    padded with a slot that holds 0, and the device sums along the row.

Boundary↔cell motion is an index_add_ / an index_select over the owner
cells; the index_add_ runs in groups whose owner cells are distinct. So no
sum of either layout adds into colliding indices: on the card (where
index_add_ adds with atomics) every sum is bitwise reproducible, and on the
CPU the sums keep face order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import INT_DTYPE, default_device, real_dtype
from ..mesh.polymesh import PolyMesh

__all__ = ["PatchInfo", "MeshGeometry", "SegSum"]

_MAX_OFFSETS = 16
# the banded layout's offset budget (the JAX package's default
# FIREFOAM_TPU_BANDED_MAX_OFFSETS); K1-K3 take 1..64 offsets
_BANDED_MAX_OFFSETS = 64
# a lattice's offsets: DIA meshes with more move faces through the lanes'
# gathers instead of one roll or shift an offset
LATTICE_OFFSETS = 3
# the hybrid layout's lanes (the JAX package's rule): an offset earns a lane
# when it fills at least 1/LANE_FILL of one and holds LANE_MIN_FACES
# faces; at most _MAX_OFFSETS lanes, and only if they cover at least half
# of the faces
LANE_FILL = 256
LANE_MIN_FACES = 64


def lane_indices(offsets, n: int):
    """(pairs, shift) gather indices of DIA lanes on n cells. pairs, flat
    over [2K, n]: row 2k holds (c + o_k) mod n, the roll's source cell, and
    row 2k + 1 holds c − o_k (0 before the start), the shifted product's
    cell; the two terms each lane adds. shift, flat over the [K, n] lanes:
    k·(n + 1) + c − o_k where c ≥ o_k, else k·(n + 1) + n, a slot of the
    lanes padded to [K, n + 1] with a zero column."""
    c = np.arange(n, dtype=np.int64)
    pairs = [a for o in offsets for a in ((c + o) % n, np.maximum(c - o, 0))]
    shift = [k * (n + 1) + np.where(c >= o, c - o, n) for k, o in enumerate(offsets)]
    return (np.concatenate(pairs) if pairs else c[:0]), (np.concatenate(shift) if shift else c[:0])


def lane_terms(upper: torch.Tensor, lower: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """[..., K, n] upper and lower lanes → [..., 2K, n] coefficients of the
    `lane_indices` pairs' gathered x: row 2k upper_k, row 2k + 1 lower_k
    moved down by o_k (zero before the start)."""
    lo = shift_lanes(lower, shift)
    up, lo = torch.broadcast_tensors(upper, lo)
    return torch.stack([up, lo], dim=-2).flatten(-3, -2)


def shift_lanes(v: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """[..., K, n] lanes → [..., K, n] with lane k moved down by o_k cells
    (zero before the start): `lane_indices`' shift gather."""
    vp = torch.cat([v, v.new_zeros(v.shape[:-1] + (1,))], dim=-1)
    return vp.flatten(-2).index_select(-1, shift).unflatten(-1, v.shape[-2:])


def sum_in_order(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ along `dim` in index order, ((v0 + v1) + v2) + …: the order of a
    loop of additions, as the JAX package's lane loops add (a scan, which
    the CPU runs in that order)."""
    return v.cumsum(dim).select(dim, -1)


def hybrid_lanes(own: np.ndarray, nei: np.ndarray, n_cells: int):
    """(lane offsets ascending, is_top mask over the faces) of the hybrid
    layout, or None where the mesh has no dominant offsets."""
    d = np.asarray(nei, np.int64) - np.asarray(own, np.int64)
    if not len(d) or not (d > 0).all():
        return None
    uniq, cnt = np.unique(d, return_counts=True)
    order = np.argsort(-cnt)
    sel = [i for i in order if cnt[i] * LANE_FILL >= n_cells and cnt[i] >= LANE_MIN_FACES]
    sel = sel[:_MAX_OFFSETS]
    if not sel:
        return None
    top = np.sort(uniq[sel])
    is_top = np.isin(d, top)
    if is_top.mean() < 0.5:
        return None
    return top, is_top


@dataclass(frozen=True)
class PatchInfo:
    name: str
    ptype: str
    start: int  # offset into boundary-face arrays (0-based, boundary-local)
    n: int

    @property
    def slice(self) -> slice:
        return slice(self.start, self.start + self.n)


class SegSum:
    """Σ of sources into segments through a host-sorted table: row s lists
    the sources with segment id s in source order, padded with a slot that
    holds 0. `keep` restricts the sources that enter; segments ≥ n_seg are
    dropped. Called with several source arrays, their concatenation is the
    source list. No addition collides, so the sum is order-fixed on any
    device."""

    def __init__(self, seg_ids: np.ndarray, n_seg: int, device, keep=None):
        seg_ids = np.asarray(seg_ids, np.int64)
        srcs = np.arange(len(seg_ids)) if keep is None else np.nonzero(keep)[0]
        srcs = srcs[seg_ids[srcs] < n_seg]
        ids = seg_ids[srcs]
        order = np.argsort(ids, kind="stable")
        ids_s, srcs_s = ids[order], srcs[order]
        rank = np.arange(len(ids_s)) - np.searchsorted(ids_s, ids_s, side="left")
        deg = int(rank.max()) + 1 if len(rank) else 1
        table = np.full((n_seg, deg), len(seg_ids), np.int64)
        table[ids_s, rank] = srcs_s
        self.table = torch.as_tensor(table, device=device)

    def __call__(self, *parts: torch.Tensor) -> torch.Tensor:
        """[n_src(, d)] sources along the leading axis → [n_seg(, d)]."""
        v = parts[0]
        zero = v.new_zeros((1,) + tuple(v.shape[1:]))
        return torch.sum(torch.cat(parts + (zero,))[self.table], dim=1)

    def last(self, *parts: torch.Tensor) -> torch.Tensor:
        """[..., n_src] sources along the last axis → [..., n_seg]."""
        v = parts[0]
        zero = v.new_zeros(tuple(v.shape[:-1]) + (1,))
        return torch.sum(torch.cat(parts + (zero,), dim=-1)[..., self.table], dim=-1)


@dataclass
class MeshGeometry:
    """All arrays are tensors on one device; metadata is plain Python.

    DIA: the internal-face arrays are padded to n_internal = nO·n_cells
    slots and `face_mask` marks real faces. SEG: n_internal is the mesh's
    internal-face count, `face_mask` is all ones and `face_perm` the
    identity. hybrid: nO·n_cells lane slots as DIA, then the rest tail."""

    n_cells: int
    n_internal: int  # internal-face slots (DIA: padded)
    n_boundary: int

    own: torch.Tensor  # [nI] int64
    nei: torch.Tensor  # [nI] int64 (== own at pad slots)
    w: torch.Tensor  # [nI] linear interpolation weight of owner (0 at pads)
    Sf: torch.Tensor  # [nI,3] (0 at pads)
    magSf: torch.Tensor  # [nI] (0 at pads)
    dc: torch.Tensor  # [nI] deltaCoeffs (0 at pads)
    nodc: torch.Tensor  # [nI] non-orthogonal-stabilised deltaCoeffs
    Cf: torch.Tensor  # [nI,3]
    face_mask: torch.Tensor  # [nI] 1.0 at real faces

    V: torch.Tensor  # [nC]
    C: torch.Tensor  # [nC,3]

    b_own: torch.Tensor  # [nB] int64
    b_Sf: torch.Tensor  # [nB,3]
    b_magSf: torch.Tensor  # [nB]
    b_dc: torch.Tensor  # [nB]
    b_nodc: torch.Tensor  # [nB]
    b_Cf: torch.Tensor  # [nB,3]
    # boundary faces grouped by their rank among their owner cell's faces
    # (face order): ((faces, owners), ...), owners distinct within a group
    b_groups: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]

    patches: Tuple[PatchInfo, ...]
    offsets: Tuple[int, ...]
    face_perm: np.ndarray  # host map: original internal face -> slot
    layout: str = "dia"

    # static face-geometry gathers (owner/neighbour centres, C_N − C_P)
    C_own_f: Optional[torch.Tensor] = None
    C_nei_f: Optional[torch.Tensor] = None
    d_face: Optional[torch.Tensor] = None
    recon_inv: Optional[torch.Tensor] = None  # [nC,3,3]

    # SEG face→cell sums: owned faces, neighbouring faces, and both in one
    # table (the owned faces first, then the neighbouring ones); on hybrid
    # seg_own/seg_nei sum the rest tail's faces
    seg_own: Optional[SegSum] = None
    seg_nei: Optional[SegSum] = None
    seg_both: Optional[SegSum] = None
    # hybrid: the rest tail's owner and neighbour cells, in slot order
    own_r: Optional[torch.Tensor] = None
    nei_r: Optional[torch.Tensor] = None
    # hybrid, and DIA with more than LATTICE_OFFSETS offsets: every face
    # slot's neighbour cell as the lanes' rolls read it (wrapped at pad
    # slots), and the lanes' gathers (`lane_indices`; lane_pairs hybrid only)
    lane_nei: Optional[torch.Tensor] = None
    lane_pairs: Optional[torch.Tensor] = None
    lane_shift: Optional[torch.Tensor] = None

    # ---------------------------------------------------------------- build
    @classmethod
    def from_polymesh(cls, mesh: PolyMesh, dtype=None, device=None,
                      layout: Optional[str] = None) -> "MeshGeometry":
        """`layout`: None or "auto" takes DIA where the mesh fits (up to 16
        offsets) and SEG otherwise; "seg" forces SEG on any mesh; "dia",
        "banded" (DIA with up to 64 offsets, reported as "dia") and
        "hybrid" raise where the mesh does not fit them. (The JAX package's
        auto takes hybrid on its accelerator from 20,000 cells; on an H100 the 117k
        castellated fire's hybrid step keeps the card 1.5x as busy as its
        SEG step and is no faster (chip_smoke.py phase 11, PERF.md), so
        auto keeps SEG on either device.)"""
        device = torch.device(device) if device is not None else default_device()
        dtype = dtype or real_dtype(device)
        layout = layout or "auto"
        if layout not in ("auto", "dia", "banded", "seg", "hybrid"):
            raise ValueError(f"layout {layout!r}: 'auto', 'dia', 'banded', 'seg' or 'hybrid'")
        n_int = mesh.n_internal_faces
        nC = mesh.n_cells
        w = mesh.weights()
        dc_i, dc_b = mesh.delta_coeffs()
        nodc_i, nodc_b = mesh.non_orth_delta_coeffs()
        own = mesh.owner[:n_int]
        nei = mesh.neighbour

        patches = tuple(
            PatchInfo(p.name, p.ptype, p.start - n_int, p.n_faces)
            for p in mesh.patches
        )

        offs = ()
        use_dia = False
        max_offs = _BANDED_MAX_OFFSETS if layout == "banded" else _MAX_OFFSETS
        if layout in ("auto", "dia", "banded") and n_int > 0:
            d = nei - own
            uniq = np.unique(d)
            if (uniq > 0).all() and len(uniq) <= max_offs:
                o_idx = np.searchsorted(uniq, d)
                key = o_idx.astype(np.int64) * nC + own
                if len(np.unique(key)) == n_int:
                    use_dia = True
                    offs = tuple(int(o) for o in uniq)
        if layout in ("dia", "banded") and not use_dia:
            raise ValueError(
                "mesh is not DIA-compatible (offset stencil)"
                + (" — renumber first (mesh/renumber.py)" if layout == "banded" else ""))
        hybrid = None
        if layout == "hybrid" and n_int > 0:
            hybrid = hybrid_lanes(own, nei, nC)
        if layout == "hybrid" and hybrid is None:
            raise ValueError("mesh has no dominant-offset structure for the hybrid layout "
                             "(the top 16 offsets cover < 50% of the faces)")

        def r(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

        def ix(a):
            return torch.as_tensor(np.asarray(a, np.int64), dtype=INT_DTYPE, device=device)

        own_r = nei_r = None
        if use_dia:
            nO = len(offs)
            nIp = nO * nC
            slot = o_idx.astype(np.int64) * nC + own
            own_p = np.tile(np.arange(nC, dtype=np.int64), nO)
            nei_p = own_p.copy()
            nei_p[slot] = nei
        elif hybrid is not None:
            top, is_top = hybrid
            offs = tuple(int(o) for o in top)
            nTop = len(offs) * nC
            own_r = np.asarray(own[~is_top], np.int64)
            nei_r = np.asarray(nei[~is_top], np.int64)
            nIp = nTop + len(own_r)
            slot = np.empty(n_int, np.int64)
            slot[is_top] = np.searchsorted(top, (nei - own)[is_top]) * nC + own[is_top]
            slot[~is_top] = nTop + np.arange(len(own_r))
            own_p = np.concatenate([np.tile(np.arange(nC, dtype=np.int64), len(offs)), own_r])
            nei_p = own_p.copy()
            nei_p[slot] = nei
        else:
            nIp = n_int
            slot = np.arange(n_int, dtype=np.int64)
            own_p = np.asarray(own, np.int64)
            nei_p = np.asarray(nei, np.int64)

        def pack(a, pad=0.0):
            out = np.full((nIp,) + a.shape[1:], pad, dtype=np.float64)
            out[slot] = a
            return out

        mask = np.zeros(nIp)
        mask[slot] = 1.0
        cf_p = pack(mesh.Cf[:n_int])
        # pad Cf with the owner cell centre (finite, unused)
        cf_p[mask == 0.0] = mesh.C[own_p[mask == 0.0]]

        nB = mesh.n_boundary_faces
        b_own = mesh.owner[n_int:]
        C = np.asarray(mesh.C, np.float64)
        Sf_p = pack(mesh.Sf[:n_int])
        magSf_p = pack(mesh.magSf[:n_int])
        bSf = np.asarray(mesh.Sf[n_int:], np.float64)
        bmsf = np.asarray(mesh.magSf[n_int:], np.float64)

        # inv(Σ Sf⊗Sf/|Sf|) per cell for fvc::reconstruct, inverted once on
        # the host in float64 (pure geometry)
        msf = np.maximum(magSf_p, 1e-300)
        ii = Sf_p[:, :, None] * Sf_p[:, None, :] / msf[:, None, None]
        bb = bSf[:, :, None] * bSf[:, None, :] / bmsf[:, None, None]
        tens = np.zeros((nC, 3, 3))
        np.add.at(tens, own_p, ii * mask[:, None, None])
        np.add.at(tens, nei_p, ii * mask[:, None, None])
        np.add.at(tens, b_own, bb)
        recon = np.linalg.inv(tens)

        order = np.argsort(b_own, kind="stable")
        first = np.searchsorted(b_own[order], b_own[order], side="left")
        rank = np.empty(nB, np.int64)
        rank[order] = np.arange(nB) - first
        b_groups = tuple(
            (ix(f), ix(b_own[f]))
            for f in (np.nonzero(rank == k)[0] for k in range(int(rank.max(initial=-1)) + 1))
        )

        seg = {}
        if own_r is not None or len(offs) > LATTICE_OFFSETS:
            lane_pairs, lane_shift = lane_indices(offs, nC)
            lane_up = lane_pairs.reshape(len(offs), 2, nC)[:, 0].reshape(-1)
            seg = dict(lane_nei=ix(lane_up), lane_shift=ix(lane_shift))
        if own_r is not None:
            seg.update(
                own_r=ix(own_r),
                nei_r=ix(nei_r),
                lane_nei=ix(np.concatenate([lane_up, nei_r])),
                lane_pairs=ix(lane_pairs),
                seg_own=SegSum(own_r, nC, device),
                seg_nei=SegSum(nei_r, nC, device),
            )
        elif not use_dia:
            seg = dict(
                seg_own=SegSum(own_p, nC, device),
                seg_nei=SegSum(nei_p, nC, device),
                seg_both=SegSum(np.concatenate([own_p, nei_p]), nC, device),
            )
        return cls(
            n_cells=nC,
            n_internal=nIp,
            n_boundary=nB,
            own=ix(own_p),
            nei=ix(nei_p),
            w=r(pack(w)),
            Sf=r(Sf_p),
            magSf=r(magSf_p),
            dc=r(pack(dc_i)),
            nodc=r(pack(nodc_i)),
            Cf=r(cf_p),
            face_mask=r(mask),
            V=r(mesh.V),
            C=r(C),
            b_own=ix(b_own),
            b_Sf=r(bSf),
            b_magSf=r(bmsf),
            b_dc=r(dc_b),
            b_nodc=r(nodc_b),
            b_Cf=r(mesh.Cf[n_int:]),
            b_groups=b_groups,
            patches=patches,
            offsets=offs,
            face_perm=slot,
            layout="dia" if use_dia else "seg" if own_r is None else "hybrid",
            C_own_f=r(C[own_p]),
            C_nei_f=r(C[nei_p]),
            d_face=r(C[nei_p] - C[own_p]),
            recon_inv=r(recon),
            **seg,
        )

    def patch(self, name: str) -> PatchInfo:
        for p in self.patches:
            if p.name == name:
                return p
        raise KeyError(name)

    @property
    def dtype(self) -> torch.dtype:
        return self.V.dtype

    @property
    def device(self) -> torch.device:
        return self.V.device

    def kvec(self) -> torch.Tensor:
        """Non-orthogonal correction vectors k_f = n̂_f − Δ_f·nodc_f
        (surfaceInterpolation::makeNonOrthCorrectionVectors, consumed by the
        corrected/limited snGrad and laplacian schemes). Exactly zero on
        orthogonal meshes and at pad slots."""
        tiny = torch.finfo(self.dtype).tiny * 1e6
        nhat = self.Sf / torch.clamp(self.magSf, min=tiny)[:, None]
        k = nhat - self.d_face * self.nodc[:, None]
        return k * self.face_mask[:, None]

    # -------------------------------------------------- layout primitives
    def _shift_down(self, x: torch.Tensor, o: int) -> torch.Tensor:
        """y[c] = x[c−o] (zero before the start)."""
        pad = torch.zeros((o,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        return torch.cat([pad, x[:-o]], dim=0)

    def hybrid_rest_gathers(self, x: torch.Tensor):
        """(x[own], x[nei]) over the hybrid rest tail only."""
        return x.index_select(0, self.own_r), x.index_select(0, self.nei_r)

    def gather_own(self, x: torch.Tensor) -> torch.Tensor:
        """Face array of the owner-cell values of x ([nC(,d)] → [nI(,d)])."""
        if self.layout in ("seg", "hybrid"):
            return x.index_select(0, self.own)
        reps = (len(self.offsets),) + (1,) * (x.ndim - 1)
        return x.repeat(*reps)

    def gather_nei(self, x: torch.Tensor) -> torch.Tensor:
        """Face array of the neighbour-cell values of x. DIA (and hybrid
        lane) pad slots receive a wrapped (finite, in-range) cell value —
        consumers mask with the zeroed face coefficients."""
        if self.layout == "seg":
            return x.index_select(0, self.nei)
        if self.lane_nei is not None:
            return x.index_select(0, self.lane_nei)
        return torch.cat([torch.roll(x, -o, dims=0) for o in self.offsets], dim=0)

    def _lanes(self, fv: torch.Tensor) -> torch.Tensor:
        """The lane slots of a face array as [nO, nC(, d)]."""
        nTop = len(self.offsets) * self.n_cells
        return fv[:nTop].reshape((len(self.offsets), self.n_cells) + tuple(fv.shape[1:]))

    def face_to_own_sum(self, fv: torch.Tensor) -> torch.Tensor:
        """Σ over each cell's owned faces of fv ([nI(,d)] → [nC(,d)]).
        DIA pad-slot values must be zero."""
        if self.layout == "seg":
            return self.seg_own(fv)
        y = torch.sum(self._lanes(fv), dim=0)
        if self.layout == "hybrid":
            return y + self.seg_own(fv[len(self.offsets) * self.n_cells:])
        return y

    def face_to_nei_sum(self, fv: torch.Tensor) -> torch.Tensor:
        """Σ over each cell's neighbouring faces of fv."""
        if self.layout == "seg":
            return self.seg_nei(fv)
        parts = self._lanes(fv)
        if self.lane_shift is None:
            return sum(self._shift_down(parts[k], o) for k, o in enumerate(self.offsets))
        # the lanes' shifts in one gather (lanes and cells moved to the last
        # axes), added in lane order
        lanes = shift_lanes(parts.movedim((0, 1), (-2, -1)), self.lane_shift)
        y = sum_in_order(lanes.movedim((-2, -1), (0, 1)), 0)
        if self.layout == "hybrid":
            return y + self.seg_nei(fv[len(self.offsets) * self.n_cells:])
        return y

    def lane_product(self, upper: torch.Tensor, lower: torch.Tensor):
        """x ↦ Σ_owned upper·x[nei] + Σ_neighbouring lower·x[own] on the
        hybrid layout, cells along the last axis of x ([..., nC];
        upper/lower [nI] or [..., nI]): each lane's roll and shift added in
        turn, then the rest tail's sums (the JAX package's FvMatrix._H_off
        order). The lanes' coefficients are laid out once; a product is then
        one gather, one multiply and one ordered sum whatever the lane
        count, plus the rest tail's."""
        nC, K = self.n_cells, len(self.offsets)
        nTop = K * nC
        coef = lane_terms(upper[..., :nTop].unflatten(-1, (K, nC)),
                          lower[..., :nTop].unflatten(-1, (K, nC)), self.lane_shift)
        u_r, l_r = upper[..., nTop:], lower[..., nTop:]

        def off(x):
            xg = x.index_select(-1, self.lane_pairs).unflatten(-1, (2 * K, nC))
            y = sum_in_order(coef * xg, -2)
            y = y + self.seg_own.last(u_r * x.index_select(-1, self.nei_r))
            return y + self.seg_nei.last(l_r * x.index_select(-1, self.own_r))

        return off

    def boundary_to_cell_sum(self, bv: torch.Tensor) -> torch.Tensor:
        """Σ of boundary-face values into their owner cells, in face order
        (one index_add_ per group of `b_groups`: reproducible on the card)."""
        out = torch.zeros(
            (self.n_cells,) + tuple(bv.shape[1:]), dtype=bv.dtype, device=bv.device
        )
        for faces, owners in self.b_groups:
            out.index_add_(0, owners, bv.index_select(0, faces))
        return out

    def cell_to_boundary(self, x: torch.Tensor) -> torch.Tensor:
        """x[b_own] ([nC(,d)] → [nB(,d)])."""
        return x.index_select(0, self.b_own)

    # ------------------------------------------------------ scatter helpers
    def face_to_both_sum(self, fv_own: torch.Tensor, fv_nei: torch.Tensor):
        """Σ over owned faces of fv_own + Σ over neighbouring faces of
        fv_nei (SEG: one table over both)."""
        if self.layout == "seg":
            return self.seg_both(fv_own, fv_nei)
        return self.face_to_own_sum(fv_own) + self.face_to_nei_sum(fv_nei)

    def cell_sum_internal(self, face_vals: torch.Tensor) -> torch.Tensor:
        """Σ over internal faces, signed outward per cell (owner +, nei −)."""
        return self.face_to_both_sum(face_vals, -face_vals)

    def surface_sum(self, face_vals: torch.Tensor, bface_vals: torch.Tensor):
        return self.cell_sum_internal(face_vals) + self.boundary_to_cell_sum(bface_vals)

    def cell_sum_unsigned(self, face_vals: torch.Tensor, bface_vals: torch.Tensor):
        """Σ over all faces of each cell, unsigned (owner and neighbour +)."""
        return (
            self.face_to_both_sum(face_vals, face_vals)
            + self.boundary_to_cell_sum(bface_vals)
        )

    # ------------------------------------------------- global reductions
    def rsum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x, dim=0)

    def rmax(self, x: torch.Tensor) -> torch.Tensor:
        return torch.max(x)

    def rmin(self, x: torch.Tensor) -> torch.Tensor:
        return torch.min(x)

    def rmean(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mean(x, dim=0)

    def rminc(self, x: torch.Tensor) -> torch.Tensor:
        return torch.amin(x, dim=0)

    def rmaxc(self, x: torch.Tensor) -> torch.Tensor:
        return torch.amax(x, dim=0)

    def rmeanc(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mean(x, dim=0)

    def bsum(self, x: torch.Tensor, sl=None) -> torch.Tensor:
        return torch.sum(x if sl is None else x[sl], dim=0)

    def bmax(self, x: torch.Tensor, sl=None) -> torch.Tensor:
        return torch.max(x if sl is None else x[sl])

    def bmin(self, x: torch.Tensor, sl=None) -> torch.Tensor:
        return torch.min(x if sl is None else x[sl])

    def bmean(self, x: torch.Tensor, sl=None) -> torch.Tensor:
        return torch.mean(x if sl is None else x[sl], dim=0)

    def sync(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Refresh the halo slots of a cell array (cells along `dim`) after
        a non-pointwise update: the identity on the unpartitioned geometry;
        a partition's geometry (parallel/localize.ShardGeometry) exchanges
        them with its neighbours."""
        return x

    def solver_reducers(self):
        """(sum_fn, dot_fn, mean_fn) over the cell axis of [..., nC] vectors
        for the Krylov twins (a leading batch axis is kept): the twins' own
        defaults here; mask-aware psum collectives on a partition."""
        from ..solvers import linear

        return (linear._sum, linear._dot, linear._mean)
