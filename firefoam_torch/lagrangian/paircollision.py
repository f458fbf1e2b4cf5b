"""PairCollision — deterministic DEM parcel-parcel / parcel-wall collisions.

The port of firefoam_tpu/lagrangian/paircollision.py, the reference
collision model (packages/lagrangian/intermediateNew/submodels/Kinematic/
CollisionModel/PairCollision/) with its two force submodels:

- PairSpringSliderDashpot (PairSpringSliderDashpot.C:evaluatePair):
  Hertzian normal spring kN = 4/3·√R*·E* with dashpot ηN = α·√(M·kN)·δ^0.25,
  optional cohesion over the overlap area, and a tangential spring-slider
  kT = 8·√(R*·δ)·G* with Coulomb slip cap μ·|fN| (slip clears the
  accumulated tangential overlap), E* = E/(2(1−ν²)), G* = G/(2(2−ν)),
  G = E/(2(1+ν)).
- WallSpringSliderDashpot (WallSpringSliderDashpot.C:evaluateWall): the
  same law against wall sites with kN = 4/3·√(R*)·E* (R* = pREff) and the
  parcel's full mass; WallLocalSpringSliderDashpot
  (WallLocalSpringSliderDashpot.C:230-275): per-wall-patch properties from
  coeff subdicts keyed by patch name, as [nW] arrays gathered at the
  contact patch.

As in the JAX package, the candidate pairs are the dense alive × alive
matrix (its stated range: up to about 16k parcels; dense sprays are what
MPPIC is for), the per-pair tangential history is a K-slot table per parcel
(`rec_id` partner slot, `rec_t` tangential vector; K = nPairRecords,
default 2) matched by partner id over the current top-K overlapping
partners, a single wall record `wrec_t`, the angular velocity `omega`
(I = (2/5)·m·r²), and walls are the planar fits of the mesh's wall patches.

The port computes the pair terms in blocks of rows: each block holds
[rows, N] pair arrays, sized from the free memory on the card, so the
[N, N, 3] arrays of the dense form are never all alive at once. Every
row's result is that row's own arithmetic whatever the block size:
  * elementwise terms are computed per pair;
  * a row's sum over its N partners is a fixed halving tree of elementwise
    adds (not a library reduction, whose split of the row may change with
    the tensor's shape);
  * its K partners are K rounds of argmax (the first index among equal
    values), lower index first among ties as jax.lax.top_k gives them
    (torch.topk promises no order among ties);
  * dot and cross products are written out per component;
  * the partner columns are padded with dead parcels to a multiple of 64,
    so on the CPU every row lies in whole SIMD vectors (pow's vector and
    scalar paths differ in the last bit).
So the result is bitwise the same for any block size on the card (and on
the CPU with one thread: several split the rows elsewhere), and a run
repeats bitwise on the card. The `nSubCycles` sub-cycles are a Python loop
of tensor work with no host read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..io.foamdict import FoamDict

__all__ = ["PairCollision", "row_tree_sum"]

_PI = float(np.pi)
# bytes of pair arrays per (row, partner) held at once by one block: about
# 24 float arrays and 4 masks live at the peak of a block
_PAIR_BYTES = {torch.float32: 112, torch.float64: 216}
_PAD = 64  # partner columns are padded to a multiple of this


def row_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over dim 1 of [B, L] by a fixed halving tree of elementwise adds:
    the order depends on L alone, never on B or the device."""
    while x.shape[1] > 1:
        L = x.shape[1]
        h = L // 2
        y = x[:, :h] + x[:, h:2 * h]
        x = torch.cat([y, x[:, 2 * h:]], dim=1) if L % 2 else y
    return x[:, 0]


def _cross(a, b):
    """a × b per component; a, b: tuples of three tensors."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _overlap_area(rA, rB, dist):
    """Area of the circle of intersection of two spheres (the cohesion term,
    PairSpringSliderDashpot.H:overlapArea)."""
    d2 = torch.clamp(dist * dist, min=1e-30)
    num = 4.0 * d2 * rA * rA - (d2 - rB * rB + rA * rA) ** 2
    return _PI / 4.0 / d2 * torch.clamp(num, min=0.0)


@dataclass
class PairCollision:
    E_star: float
    G_star: float
    alpha: float
    b: float
    mu: float
    cohesion_density: float
    use_equivalent_size: bool
    volume_factor: float
    sub_cycles: int
    n_records: int
    # wall planes [nW, 3] point / normal (INTO the domain) and per-wall
    # properties [nW] (one value broadcast for wallSpringSliderDashpot, per
    # patch for wallLocalSpringSliderDashpot)
    wall_point: np.ndarray
    wall_normal: np.ndarray
    wall_E_star: np.ndarray
    wall_G_star: np.ndarray
    wall_alpha: np.ndarray
    wall_b: np.ndarray
    wall_mu: np.ndarray
    # rows of the pair matrix a block holds: None sizes it from the free
    # memory on the card (on the CPU: 2^20 pairs a block)
    block_rows: Optional[int] = None
    # a device counter the caller may set (to a zero tensor): collide then
    # adds the partner records held after each sub-cycle (a touching pair
    # counts once for each parcel that keeps it); None counts nothing
    contacts: Optional[torch.Tensor] = None

    @classmethod
    def from_dict(cls, sub: FoamDict, cp: FoamDict, geom) -> Optional["PairCollision"]:
        """sub = the cloud's subModels dict; cp = constantProperties
        (youngsModulus/poissonsRatio as the reference's constProps)."""
        name = sub.get_word("collisionModel", "none")
        if name in ("none", "noCollision"):
            return None
        c = sub.get_dict("pairCollisionCoeffs", FoamDict())
        pair = c.get_dict("pairModelCoeffs", None) or c.get_dict(
            "PairSpringSliderDashpotCoeffs", FoamDict())
        wall_model = c.get_word("wallModel", "wallSpringSliderDashpot")
        wall = (
            c.get_dict("wallModelCoeffs", None)
            or c.get_dict("WallSpringSliderDashpotCoeffs", None)
            or c.get_dict("wallSpringSliderDashpotCoeffs", None)
            or c.get_dict("WallLocalSpringSliderDashpotCoeffs", None)
            or c.get_dict("wallLocalSpringSliderDashpotCoeffs", None)
            or FoamDict()
        )
        nu = cp.get_scalar("poissonsRatio", 0.35)
        E = cp.get_scalar("youngsModulus", 1e8)
        E_star = E / (2.0 * (1.0 - nu * nu))
        G = E / (2.0 * (1.0 + nu))
        G_star = G / (2.0 * (2.0 - nu))

        def _star_pair(nu_w, E_w):
            """Combined parcel-wall moduli (WallSpringSliderDashpot.C:
            201-204): E* = 1/((1−νp²)/Ep + (1−νw²)/Ew),
            G* = 1/(2((2+νp−νp²)/Ep + (2+νw−νw²)/Ew))."""
            es = 1.0 / ((1.0 - nu * nu) / E + (1.0 - nu_w * nu_w) / E_w)
            gs = 1.0 / (2.0 * ((2.0 + nu - nu * nu) / E + (2.0 + nu_w - nu_w * nu_w) / E_w))
            return es, gs

        # planar wall fits per wall patch (+ per-patch properties), on the
        # host in float64 whatever the run's dtype
        wp, wn, wes, wgs, wal, wb, wmu = [], [], [], [], [], [], []
        local = "local" in wall_model.lower()
        for pch in getattr(geom, "patches", []):
            if "wall" not in (pch.ptype or "").lower():
                continue
            Sf = geom.b_Sf[pch.slice].double().cpu().numpy()
            Cf = geom.b_Cf[pch.slice].double().cpu().numpy()
            if Sf.shape[0] == 0:
                continue
            n = Sf.sum(0)
            n /= max(np.linalg.norm(n), 1e-30)
            wp.append(Cf.mean(0))
            wn.append(-n)  # b_Sf points OUT of the domain; DEM needs inward
            pd = wall.get_dict(pch.name, None) if local else None
            src = pd if pd is not None else wall
            if src.found("youngsModulus"):
                es, gs = _star_pair(src.get_scalar("poissonsRatio", nu),
                                    src.get_scalar("youngsModulus"))
            else:
                es = src.get_scalar("Estar", E_star)
                gs = src.get_scalar("Gstar", G_star)
            wes.append(es)
            wgs.append(gs)
            wal.append(src.get_scalar("alpha", 0.12))
            wb.append(src.get_scalar("b", 1.5))
            wmu.append(src.get_scalar("mu", 0.43))
        return cls(
            E_star=E_star,
            G_star=G_star,
            alpha=pair.get_scalar("alpha", 0.12),
            b=pair.get_scalar("b", 1.5),
            mu=pair.get_scalar("mu", 0.52),
            cohesion_density=pair.get_scalar("cohesionEnergyDensity", 0.0),
            use_equivalent_size=pair.get_bool("useEquivalentSize", False),
            volume_factor=pair.get_scalar("volumeFactor", 1.0),
            sub_cycles=int(c.get_scalar("nSubCycles", 1)),
            n_records=int(c.get_scalar("nPairRecords", 2)),
            wall_point=np.asarray(wp if wp else np.zeros((0, 3))),
            wall_normal=np.asarray(wn if wn else np.zeros((0, 3))),
            wall_E_star=np.asarray(wes, float),
            wall_G_star=np.asarray(wgs, float),
            wall_alpha=np.asarray(wal, float),
            wall_b=np.asarray(wb, float),
            wall_mu=np.asarray(wmu, float),
        )

    # ------------------------------------------------------------------
    def init_state(self, cap: int, dtype, device) -> Dict:
        K = self.n_records
        return {
            "omega": torch.zeros((cap, 3), dtype=dtype, device=device),
            "rec_id": torch.full((cap, K), -1, dtype=torch.int32, device=device),
            "rec_t": torch.zeros((cap, K, 3), dtype=dtype, device=device),
            "wrec_t": torch.zeros((cap, 3), dtype=dtype, device=device),
        }

    def rows_per_block(self, N: int, dtype, device) -> int:
        """Rows of the [rows, N] pair arrays one block holds."""
        if self.block_rows is not None:
            return max(1, min(int(self.block_rows), N))
        per_row = _PAIR_BYTES.get(dtype, 216) * max(N, 1)
        if torch.device(device).type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            budget = free // 2
        else:
            budget = per_row * max(1, (1 << 20) // max(N, 1))
        return int(max(1, min(N, budget // per_row)))

    def _tables(self, like: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The wall tables on the parcels' device, made once (a host-to-
        device copy from pageable memory waits for the card)."""
        cache = self.__dict__.setdefault("_dev", {})
        key = (like.dtype, like.device)
        if key not in cache:
            cache[key] = {k: torch.as_tensor(np.asarray(getattr(self, k), np.float64),
                                             dtype=like.dtype, device=like.device)
                          for k in ("wall_point", "wall_normal", "wall_E_star", "wall_G_star",
                                    "wall_alpha", "wall_b", "wall_mu")}
        return cache[key]

    # ------------------------------------------------------------------
    def _pair_block(self, r0, r1, P, rec_id, rec_t, dt_c):
        """The pair terms of rows r0:r1 against every parcel: (Σ fN + Σ fT
        [B, 3] as three tensors, the torque [B, 3] as three tensors, the new
        records: partner ids [B, K] and tangential vectors [B, K, 3]). P
        holds the parcels' x, U, r, dEff, m, alive and omega, padded with dead
        parcels to a multiple of _PAD columns."""
        x, U, r, dEff, m, alive, omega = P
        K = self.n_records
        N = x.shape[0]
        dev = x.device
        rows = torch.arange(r0, r1, device=dev)
        cols = torch.arange(N, device=dev)
        xi, Ui = x[r0:r1], U[r0:r1]
        ri, di, mi, ai = r[r0:r1], dEff[r0:r1], m[r0:r1], alive[r0:r1]
        # ---- normal forces over all N partners (pairs [B, N]) ----------
        dx = [xi[:, k:k + 1] - x[None, :, k] for k in range(3)]  # A − B
        dist = torch.sqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2] + 1e-30)
        overlap = ri[:, None] + r[None, :] - dist
        touch = ((overlap > 0.0) & ai[:, None] & alive[None, :]
                 & (rows[:, None] != cols[None, :]))
        nhat = [v / dist for v in dx]  # rHat_AB
        del dx
        Un = sum((Ui[:, k:k + 1] - U[None, :, k]) * nhat[k] for k in range(3))
        Rstar = 0.5 * di[:, None] * dEff[None, :] / torch.clamp(di[:, None] + dEff[None, :],
                                                                min=1e-30)
        Mstar = mi[:, None] * m[None, :] / torch.clamp(mi[:, None] + m[None, :], min=1e-30)
        ov = torch.clamp(overlap, min=0.0)
        kN = (4.0 / 3.0) * torch.sqrt(Rstar) * self.E_star
        del Rstar
        etaN = self.alpha * torch.sqrt(Mstar * kN) * ov ** 0.25
        del Mstar
        fN_mag = kN * ov ** self.b - etaN * Un
        del kN, Un
        coh = (self.cohesion_density * _overlap_area(ri[:, None], r[None, :], dist)
               if self.cohesion_density != 0.0 else None)
        zero = torch.zeros((), dtype=x.dtype, device=dev)
        f = []
        for k in range(3):
            fk = nhat[k] * fN_mag
            if coh is not None:
                fk = fk - coh * nhat[k]
            f.append(row_tree_sum(torch.where(touch, fk, zero)))
            del fk
        # ---- the K current partners: largest overlap first, lower index
        # first among ties (jax.lax.top_k) ----
        ov_sel = torch.where(touch, ov, torch.full_like(ov, -1.0))
        del ov, touch
        top_id, top_ov = [], []
        for _ in range(K):
            j = torch.argmax(ov_sel, dim=1)
            top_id.append(j)
            top_ov.append(torch.gather(ov_sel, 1, j[:, None])[:, 0])
            ov_sel.scatter_(1, j[:, None], float("-inf"))
        del ov_sel
        top_id = torch.stack(top_id, dim=1)  # [B, K]
        top_ov = torch.stack(top_ov, dim=1)
        valid = top_ov > 0.0
        etaT = torch.gather(etaN, 1, top_id)
        fN_sel = torch.gather(fN_mag, 1, top_id)
        del etaN, fN_mag
        nsel = [torch.gather(v, 1, top_id) for v in nhat]  # [B, K]
        del nhat
        # ---- tangential (slider with K-slot history) at the K partners ----
        j = top_id
        dU = [Ui[:, k:k + 1] - U[:, k][j] for k in range(3)]
        Uns = dU[0] * nsel[0] + dU[1] * nsel[1] + dU[2] * nsel[2]
        om_i = [omega[r0:r1, k:k + 1].expand_as(Uns) for k in range(3)]
        om_j = [omega[:, k][j] for k in range(3)]
        ri_ = ri[:, None].expand_as(Uns)
        rj = r[j]
        c1 = _cross(om_i, [-ri_ * v for v in nsel])
        c2 = _cross(om_j, [rj * v for v in nsel])
        gk = [dU[k] - Uns * nsel[k] + c1[k] - c2[k] for k in range(3)]
        # previous tangential vector for each current partner (0 if new)
        rid = rec_id[r0:r1]
        rt = rec_t[r0:r1]
        prev = [torch.zeros_like(Uns) for _ in range(3)]
        for o in range(rid.shape[1]):
            match = (rid[:, o:o + 1] == j).to(x.dtype)  # [B, K]
            for k in range(3):
                prev[k] = prev[k] + match * rt[:, o, k][:, None]
        new_t = [prev[k] + gk[k] * dt_c for k in range(3)]
        di_j = di[:, None].expand_as(Uns)
        dj = dEff[j]
        Rs = 0.5 * di_j * dj / torch.clamp(di_j + dj, min=1e-30)
        kT = 8.0 * torch.sqrt(Rs * torch.clamp(top_ov, min=0.0)) * self.G_star
        tmag = torch.sqrt(new_t[0] ** 2 + new_t[1] ** 2 + new_t[2] ** 2 + 1e-30)
        slipping = kT * tmag > self.mu * torch.abs(fN_sel)
        smag = torch.sqrt(gk[0] ** 2 + gk[1] ** 2 + gk[2] ** 2 + 1e-30)
        fT = []
        for k in range(3):
            slip_k = -self.mu * torch.abs(fN_sel) * gk[k] / smag
            stick_k = -kT * new_t[k] - etaT * gk[k]
            fT.append(torch.where(valid, torch.where(slipping, slip_k, stick_k), zero))
        reset = slipping | ~valid
        new_t = torch.stack([torch.where(reset, zero, v) for v in new_t], dim=2)  # [B, K, 3]
        # torque of the tangential forces: Σ_K (−r_i·n̂) × fT
        arm = [-(nsel[k] * ri_) for k in range(3)]
        tq = _cross(arm, fT)
        ftot, ttot = [], []
        for k in range(3):
            acc, tacc = fT[k][:, 0], tq[k][:, 0]
            for q in range(1, K):
                acc = acc + fT[k][:, q]
                tacc = tacc + tq[k][:, q]
            ftot.append(f[k] + acc)
            ttot.append(tacc)
        rec_id_new = torch.where(valid, top_id.to(torch.int32), torch.full_like(top_id, -1,
                                                                             dtype=torch.int32))
        return ftot, ttot, rec_id_new, new_t

    def _walls(self, x, U, omega, r, m, alive, wrec_t, dt_c):
        """Parcel-wall forces and torques [N] × 3 and the new wall record."""
        tb = self._tables(x)
        WP, WN = tb["wall_point"], tb["wall_normal"]
        X = [x[:, k] for k in range(3)]
        Uc = [U[:, k] for k in range(3)]
        off = WP[:, 0] * WN[:, 0] + WP[:, 1] * WN[:, 1] + WP[:, 2] * WN[:, 2]  # [nW]
        gap = (X[0][:, None] * WN[None, :, 0] + X[1][:, None] * WN[None, :, 1]
               + X[2][:, None] * WN[None, :, 2]) - off[None, :]
        ovw = torch.clamp(r[:, None] - gap, min=0.0)
        wsel = torch.argmax(ovw, dim=1)
        ovw1 = torch.gather(ovw, 1, wsel[:, None])[:, 0]
        nw = [WN[:, k][wsel] for k in range(3)]  # rHat_PW (plane → parcel)
        Ew, Gw = tb["wall_E_star"][wsel], tb["wall_G_star"][wsel]
        aw, bw, muw = tb["wall_alpha"][wsel], tb["wall_b"][wsel], tb["wall_mu"][wsel]
        kNw = (4.0 / 3.0) * torch.sqrt(r) * Ew
        etaNw = aw * torch.sqrt(m * kNw) * ovw1 ** 0.25
        Unw = Uc[0] * nw[0] + Uc[1] * nw[1] + Uc[2] * nw[2]
        fNw_mag = kNw * ovw1 ** bw - etaNw * Unw
        touch_w = (ovw1 > 0.0) & alive
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        om = [omega[:, k] for k in range(3)]
        cr = _cross(om, [-r * v for v in nw])
        slw = [Uc[k] - Unw * nw[k] + cr[k] for k in range(3)]
        wt = [torch.where(touch_w, wrec_t[:, k] + slw[k] * dt_c, zero) for k in range(3)]
        kTw = 8.0 * torch.sqrt(r * ovw1) * Gw
        wtmag = torch.sqrt(wt[0] ** 2 + wt[1] ** 2 + wt[2] ** 2 + 1e-30)
        wslip = kTw * wtmag > muw * torch.abs(fNw_mag)
        wsmag = torch.sqrt(slw[0] ** 2 + slw[1] ** 2 + slw[2] ** 2 + 1e-30)
        fNw = [torch.where(touch_w, nw[k] * fNw_mag, zero) for k in range(3)]
        fTw = [torch.where(touch_w, torch.where(
            wslip, -(muw * torch.abs(fNw_mag)) * slw[k] / wsmag,
            -kTw * wt[k] - etaNw * slw[k]), zero) for k in range(3)]
        wt_new = torch.stack([torch.where(wslip, zero, v) for v in wt], dim=1)
        fW = [fNw[k] + fTw[k] for k in range(3)]
        tqW = _cross([-r * v for v in nw], fTw)
        return fW, tqW, wt_new

    # ------------------------------------------------------------------
    def collide(self, st: Dict, cst: Dict, rho_p, dt):
        """One collision sub-cycled force/torque integration.

        st: the cloud SoA (x, U, d, nP, alive); cst: the collision state of
        init_state. Returns (st', cst') with x, U, omega and the records
        updated."""
        dt_c = dt / self.sub_cycles
        x, U = st["x"], st["U"]
        omega = cst["omega"]
        alive = st["alive"]
        d = st["d"]
        dEff = d * torch.pow(st["nP"] * self.volume_factor, 1.0 / 3.0) \
            if self.use_equivalent_size else d
        r = 0.5 * dEff
        m = torch.where(alive, rho_p * _PI / 6.0 * dEff ** 3, torch.ones_like(dEff))
        inv_I = 1.0 / torch.clamp(0.4 * m * r * r, min=1e-30)
        rec_id, rec_t, wrec_t = cst["rec_id"], cst["rec_t"], cst["wrec_t"]
        N = x.shape[0]
        B = self.rows_per_block(N, x.dtype, x.device)
        self.last_block_rows = B
        has_walls = self.wall_point.shape[0] > 0
        # the partner columns padded with dead parcels to a multiple of _PAD
        pad = -N % _PAD

        def padded(v, fill=0.0):
            return torch.cat([v, v.new_full((pad,) + tuple(v.shape[1:]), fill)]) if pad else v

        r_p, dEff_p, m_p = padded(r), padded(dEff), padded(m, 1.0)
        alive_p = padded(alive, False)
        for _ in range(self.sub_cycles):
            P = (padded(x), padded(U), r_p, dEff_p, m_p, alive_p, padded(omega))
            f = [[], [], []]
            tq = [[], [], []]
            ids, ts = [], []
            for r0 in range(0, N, B):
                fb, tb, ib, nb = self._pair_block(r0, min(N, r0 + B), P, rec_id, rec_t, dt_c)
                for k in range(3):
                    f[k].append(fb[k])
                    tq[k].append(tb[k])
                ids.append(ib)
                ts.append(nb)
            f = [torch.cat(v) for v in f]
            tq = [torch.cat(v) for v in tq]
            if has_walls:
                fW, tqW, wrec_t = self._walls(x, U, omega, r, m, alive, wrec_t, dt_c)
                f = [f[k] + fW[k] for k in range(3)]
                tq = [tq[k] + tqW[k] for k in range(3)]
            F = torch.stack(f, dim=1)
            TQ = torch.stack(tq, dim=1)
            U = U + dt_c * F / m[:, None]
            omega = omega + dt_c * TQ * inv_I[:, None]
            x = x + dt_c * torch.where(alive[:, None], U, torch.zeros_like(U))
            rec_id = torch.cat(ids)
            rec_t = torch.cat(ts)
            if self.contacts is not None:
                self.contacts = self.contacts + (rec_id >= 0).sum()
        st = dict(st)
        st["x"], st["U"] = x, U
        cst = dict(cst)
        cst.update(omega=omega, rec_id=rec_id, rec_t=rec_t, wrec_t=wrec_t)
        return st, cst
