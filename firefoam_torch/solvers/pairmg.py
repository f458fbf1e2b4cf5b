"""Index-pair (lane-preserving) multigrid — the GAMG role for unstructured
meshes on the hybrid layout.

The PyTorch counterpart of firefoam_tpu/solvers/pairmg.py. Level by level,
cells (c, c + op) merge along one primary lane offset `op` (cycling the
three most face-populated lanes — the z/y/x axes of a near-lattice
numbering):

    g(c) = (c // (2·op))·op + (c % (2·op)) % op .

Because g is affine on each residue class, a fine lane with offset `o` maps
onto the coarse graph as a few contiguous residue runs, each with one
constant coarse offset. So Galerkin coarsening of the current matrix values
is a static plan of strided slice-adds between [nb, 2·op] views of the fine
lanes and [nb, op] views of the coarse ones, plus a short list of entries
that leave their lane (into the coarse diagonal, another lane or the coarse
rest tail). The plan is built once on the host (numpy, copied from the JAX
package); the coarse operators are rebuilt from the matrix on every solve.
Lane coverage holds down the hierarchy, so every level's matvec is the
hybrid layout's rolls and shifts plus a short rest tail.

Every sum that adds into colliding indices goes through an order-fixed
`SegSum` table (ops/geometry.py), so a solve is bitwise repeatable on the
card. The smoother is Chebyshev-Jacobi on the lumped level operator (the
rest couplings' |w| moved into the diagonal; `lump=False` keeps them); the
coarsest level is inverted densely by Newton-Schulz, as the JAX package
does. Symmetric systems only (p_rgh). One V-cycle preconditions a CG with
OpenFOAM's convergence semantics, whose loop reads its stop test on the
host once per iteration.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.geometry import (LANE_FILL, LANE_MIN_FACES, SegSum, lane_indices, lane_terms,
                            shift_lanes, sum_in_order)
from .gmg import _inv_newton_schulz
from .linear import SolverResult, _dot, _mean, _norm_factor, _sum, tol_floor

__all__ = ["PairMG", "pairmg_pcg"]

_LANE_CAP = 16  # lanes a level keeps, as the hybrid layout's
PRE_DEGREE = 2  # Chebyshev degree of each smoothing pass
CHEBY_RATIO = 0.30  # the smoother's lower bound, as a share of the upper


# ------------------------------------------------------------------ static
class _Level:
    """Static structure of one level: lane offsets (ascending) and the
    irregular rest faces (own < nei), with the rest's gathers and sums on
    the device."""

    def __init__(self, n: int, lane_valid: Dict[int, np.ndarray], own_r, nei_r, device):
        self.n = int(n)
        self.offsets = tuple(sorted(int(o) for o in lane_valid))
        self.lane_valid = lane_valid  # offset -> the lane's real fine slots, ascending
        self.own_r = np.asarray(own_r, np.int64)
        self.nei_r = np.asarray(nei_r, np.int64)
        self.own_j = torch.as_tensor(self.own_r, device=device)
        self.nei_j = torch.as_tensor(self.nei_r, device=device)
        self.sum_own = SegSum(self.own_r, self.n, device)
        self.sum_nei = SegSum(self.nei_r, self.n, device)
        pairs, shift = lane_indices(self.offsets, self.n)
        # the cell itself (the diagonal's term), then the lanes' pairs
        self.mv_idx = torch.as_tensor(np.concatenate([np.arange(self.n), pairs]), device=device)
        self.lane_shift = torch.as_tensor(shift, device=device)


class _Transition:
    """Static Galerkin plan from a fine level to the coarse one. `pieces`:
    (lane, r0, r1, c0, target) — add the fine [nb, 2op] lane's columns
    [r0, r1) into the coarse [nb, op] columns from c0 of the diagonal
    (("d",), twice) or of coarse lane j (("l", j)). The extras vector (the
    fine rest values, then the `gathers` of lane entries that leave their
    lane) routes into the coarse diagonal (src_d → tgt_d, twice), a coarse
    lane (`lane_routes`) or the coarse rest (src_r → inv_r)."""

    def __init__(self, op, n, pieces, gathers, src_d, tgt_d, lane_routes, src_r, inv_r,
                 n_cr, device):
        P = 2 * op
        self.op, self.n = op, n
        self.nb = (n + P - 1) // P
        self.n_pad = self.nb * P
        self.nc = self.nb * op
        self.pieces = tuple(pieces)
        self.gathers = tuple((k, torch.as_tensor(pos, device=device)) for k, pos in gathers)
        self.src_d = torch.as_tensor(src_d, device=device)
        self.tgt_d = np.asarray(tgt_d, np.int64)
        self.lane_routes = tuple((torch.as_tensor(s, device=device), np.asarray(t, np.int64))
                                 for s, t in lane_routes)
        self.src_r = torch.as_tensor(src_r, device=device)
        self.inv_r = np.asarray(inv_r, np.int64)
        self.n_cr = int(n_cr)
        # the colliding adds, order-fixed
        self.sum_d = SegSum(self.tgt_d, self.nc, device)
        self.sum_lanes = tuple(SegSum(t, self.nc, device) for _, t in self.lane_routes)
        self.sum_r = SegSum(self.inv_r, self.n_cr, device)


def _g_of(c: np.ndarray, op: int) -> np.ndarray:
    P = 2 * op
    return (c // P) * op + (c % P) % op


def _build_transition(level: _Level, op: int, device, lane_cap: int = _LANE_CAP):
    """Host-side plan for one index-pair coarsening along offset op."""
    n = level.n
    P = 2 * op
    nb = (n + P - 1) // P
    nc = nb * op

    lane_off = list(level.offsets)
    # per-lane residue profile: coarse offset delta(r) and min-index col
    prof = {}
    for o in lane_off:
        r = np.arange(P)
        q, rp = np.divmod(r + o, P)
        delta = q * op + rp % op - r % op
        tcol = np.where(delta >= 0, r % op, rp % op)
        prof[o] = (delta.astype(np.int64), tcol.astype(np.int64))

    # candidate coarse offsets and their real-entry counts
    lane_valid = level.lane_valid
    cand: Dict[int, int] = {}
    for o in lane_off:
        delta, _ = prof[o]
        dl = np.abs(delta[lane_valid[o] % P])
        for dv, cnt in zip(*np.unique(dl[dl != 0], return_counts=True)):
            cand[int(dv)] = cand.get(int(dv), 0) + int(cnt)
    gro = _g_of(level.own_r, op)
    grn = _g_of(level.nei_r, op)
    dr = grn - gro
    for dv, cnt in zip(*np.unique(np.abs(dr[dr != 0]), return_counts=True)):
        cand[int(dv)] = cand.get(int(dv), 0) + int(cnt)
    keep = [d for d, c in cand.items() if d < nc and c >= max(32, nc // 256)]
    keep = sorted(sorted(keep, key=lambda d: -cand[d])[:lane_cap])
    kidx = {d: j for j, d in enumerate(keep)}

    pieces: List[Tuple] = []
    # extras vector = [rest values] + [demoted lane gathers]; routes below
    ex_min = [np.minimum(gro, grn)]
    ex_dabs = [np.abs(dr)]
    gathers: List[Tuple[int, np.ndarray]] = []
    cov: Dict[int, List[np.ndarray]] = {j: [] for j in range(len(keep))}
    for k, o in enumerate(lane_off):
        delta, tcol = prof[o]
        brk = [0]
        for r in range(1, P):
            if delta[r] != delta[r - 1] or tcol[r] != tcol[r - 1] + 1:
                brk.append(r)
        brk.append(P)
        vc = lane_valid[o]
        rmod = vc % P
        for r0, r1 in zip(brk[:-1], brk[1:]):
            dv = int(delta[r0])
            c0 = int(tcol[r0])
            if dv == 0:
                pieces.append((k, r0, r1, c0, ("d",)))
            elif abs(dv) in kidx:
                j = kidx[abs(dv)]
                pieces.append((k, r0, r1, c0, ("l", j)))
                sel = vc[(rmod >= r0) & (rmod < r1)]
                if len(sel):
                    cov[j].append((sel // P) * op + tcol[sel % P])
            else:
                sel = vc[(rmod >= r0) & (rmod < r1)]
                if len(sel):
                    gathers.append((k, np.asarray(sel, np.int64)))
                    gm = np.minimum(_g_of(sel, op), _g_of(sel + o, op))
                    ex_min.append(gm)
                    ex_dabs.append(np.full(len(sel), abs(dv), np.int64))

    ex_min = np.concatenate(ex_min) if ex_min else np.zeros(0, np.int64)
    ex_dabs = np.concatenate(ex_dabs) if ex_dabs else np.zeros(0, np.int64)
    pos = np.arange(len(ex_min))
    to_d = ex_dabs == 0
    src_d, tgt_d = pos[to_d], ex_min[to_d]
    routed = to_d.copy()
    rest_routes = {}
    for j, d in enumerate(keep):
        m = ex_dabs == d
        rest_routes[j] = (pos[m], ex_min[m])
        if m.any():
            cov[j].append(ex_min[m])
        routed |= m
    to_r = ~routed
    src_r = pos[to_r]
    pair_key = ex_min[to_r] * (2 * nc + 1) + ex_dabs[to_r]
    uniq, inv = np.unique(pair_key, return_inverse=True)
    own_c = (uniq // (2 * nc + 1)).astype(np.int64)
    nei_c = own_c + uniq % (2 * nc + 1)
    # np.unique sorts by key = own·(2nc+1) + d: the coarse rest ascends by own
    assert (np.diff(own_c) >= 0).all()

    # keep offsets with no real coverage anywhere carry only zero slots:
    # drop them and remap coarse lane indices to the surviving ascending
    # order (== the coarse level's offset order)
    survivors = [j for j in range(len(keep)) if cov[j]]
    jmap = {j: jn for jn, j in enumerate(survivors)}
    pieces = [
        p if p[4][0] == "d" else (p[0], p[1], p[2], p[3], ("l", jmap[p[4][1]]))
        for p in pieces
        if p[4][0] == "d" or p[4][1] in jmap
    ]
    lane_routes = [rest_routes[j] for j in survivors]
    tr = _Transition(op, n, pieces, gathers, src_d, tgt_d, lane_routes, src_r,
                     np.asarray(inv).reshape(-1), len(uniq), device)
    lane_valid_c = {keep[j]: np.unique(np.concatenate(cov[j])) for j in survivors}
    return tr, _Level(nc, lane_valid_c, own_c, nei_c, device)


# ------------------------------------------------------------- level algebra
def _mv_terms(level: _Level, d, W):
    """[2K + 1, n] coefficients of _lane_mv: d, then each lane's roll and
    shift terms (`lane_terms`)."""
    if W is None:
        return d[None]
    return torch.cat([d[None], lane_terms(W, W, level.lane_shift)])


def _lane_mv(level: _Level, terms, rest_w, x):
    """Symmetric matvec: y = d·x + Σ_o w_o·(x shifted ±o) + rest, added in
    the JAX package's order (d·x, then each lane's roll and its shift) by
    one gather, one product and one ordered sum; `terms` from _mv_terms.
    rest_w None: lanes only (the lumped smoother operator)."""
    n = level.n
    xg = x.index_select(0, level.mv_idx[: terms.shape[0] * n]).view(-1, n)
    y = sum_in_order(terms * xg, 0)
    if rest_w is not None and len(level.own_r):
        y = y + level.sum_own(rest_w * x.index_select(0, level.nei_j))
        y = y + level.sum_nei(rest_w * x.index_select(0, level.own_j))
    return y


def _stack(lanes_w):
    return torch.stack(list(lanes_w)) if len(lanes_w) else None


def _rowsum_lane(level: _Level, W, d):
    if W is None:
        return torch.zeros_like(d)
    aw = torch.abs(W)
    terms = torch.stack([aw, shift_lanes(aw, level.lane_shift)], 1).view(-1, level.n)
    return sum_in_order(torch.cat([torch.zeros_like(d)[None], terms]), 0)


def _rowsum_rest(level: _Level, rest_w, d):
    rs = torch.zeros_like(d)
    if len(level.own_r):
        ar = torch.abs(rest_w)
        rs = rs + level.sum_own(ar)
        rs = rs + level.sum_nei(ar)
    return rs


class _Cheby:
    """Chebyshev-Jacobi smoother (reduction-free; see gmg._Cheby). rest_w
    None: the lumped level operator (the rest couplings dropped, their |w|
    in the diagonal)."""

    def __init__(self, level, d, W, rest_w, lmax, degree=2, ratio=0.30):
        self.level, self.rest_w = level, rest_w
        self.terms = _mv_terms(level, d, W)
        # the recurrence's scalars depend on lmax alone: computed once here,
        # in the order the JAX package computes them on every call
        self.rD = 1.0 / d
        beta = 1.1 * lmax
        alpha = ratio * lmax
        self.theta = 0.5 * (beta + alpha)
        delta = 0.5 * (beta - alpha)
        sigma = self.theta / delta
        rho = 1.0 / sigma
        self.coefs = []
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            self.coefs.append((rho_new * rho, 2.0 * rho_new / delta))
            rho = rho_new

    def mv(self, v):
        return _lane_mv(self.level, self.terms, self.rest_w, v)

    def __call__(self, x, b):
        r = b - self.mv(x)
        z = self.rD * r / self.theta
        x = x + z
        for c_z, c_r in self.coefs:
            r = b - self.mv(x)
            z = c_z * z + c_r * (self.rD * r)
            x = x + z
        return x


# ------------------------------------------------------------------ PairMG
class PairMG:
    """Static index-pair hierarchy. The matrix-dependent pieces (Galerkin
    coarse operators, smoother bounds, the dense coarsest inverse) are built
    per solve in prepare() from the current matrix values. `lump`: the
    smoothers' level operators drop the rest couplings into the diagonal
    (the JAX package's FIREFOAM_TPU_PAIRMG_LUMP=1)."""

    def __init__(self, levels, transitions, n_cells, lump=True):
        self.levels = tuple(levels)
        self.transitions = tuple(transitions)
        self.n_cells = n_cells
        self.lump = lump

    # --------------------------------------------------------------- build
    @classmethod
    def from_graph(cls, own, nei, n_cells, offsets=None, n_coarsest: int = 512,
                   max_levels: int = 14, lump: bool = True,
                   device="cpu") -> Optional["PairMG"]:
        """Build from a raw symmetric face graph (own < nei). `offsets`
        fixes the level-0 lane set (it must match the value layout passed to
        prepare_parts); None selects as the hybrid layout does (at least
        nC/256 and 64 faces a lane, at most 16 lanes)."""
        own = np.asarray(own, np.int64)
        nei = np.asarray(nei, np.int64)
        d = nei - own
        if len(d) == 0 or (d <= 0).any():
            return None
        if offsets is None:
            uniq, cnt = np.unique(d, return_counts=True)
            order = np.argsort(-cnt)
            sel = [i for i in order
                   if cnt[i] * LANE_FILL >= n_cells and cnt[i] >= LANE_MIN_FACES][:_LANE_CAP]
            if not sel:
                return None
            offsets = tuple(int(o) for o in np.sort(uniq[sel]))
        offsets = tuple(int(o) for o in offsets)
        is_top = np.isin(d, np.asarray(offsets))
        lane_valid = {o: np.sort(own[d == o]) for o in offsets}
        lvl0 = _Level(n_cells, lane_valid, own[~is_top], nei[~is_top], device)
        return cls._build_from_level0(lvl0, n_coarsest, max_levels, lump, device)

    @classmethod
    def from_geom(cls, geom, n_coarsest: int = 512, max_levels: int = 14,
                  lump: bool = True) -> Optional["PairMG"]:
        """Build for a hybrid-layout MeshGeometry, on its device: level 0's
        lane order and rest order are the packed face arrays', so prepare()
        takes FvMatrix.upper as it is."""
        if geom.layout != "hybrid":
            return None
        nC, K = geom.n_cells, len(geom.offsets)
        mask = geom.face_mask[: K * nC].cpu().numpy().reshape(K, nC) > 0
        lane_valid = {int(o): np.flatnonzero(mask[k]) for k, o in enumerate(geom.offsets)}
        lvl0 = _Level(nC, lane_valid, geom.own_r.cpu().numpy(), geom.nei_r.cpu().numpy(),
                      geom.device)
        return cls._build_from_level0(lvl0, n_coarsest, max_levels, lump, geom.device)

    @classmethod
    def _build_from_level0(cls, lvl0, n_coarsest, max_levels, lump, device):
        levels = [lvl0]
        transitions = []
        lvl = lvl0
        k = 0
        while lvl.n > n_coarsest and len(transitions) < max_levels:
            if not lvl.offsets:
                break
            # primary pairing offsets: the 3 most face-populated lanes,
            # cycled largest-offset-first
            by_cnt = sorted(lvl.offsets, key=lambda o: -len(lvl.lane_valid[o]))[:3]
            prim = sorted(by_cnt, reverse=True)
            op = None
            for cand_i in range(len(prim)):
                o = prim[(k + cand_i) % len(prim)]
                if 2 * o <= max(2, lvl.n // 2):
                    op = o
                    break
            if op is None:
                break
            tr, coarse = _build_transition(lvl, op, device)
            transitions.append(tr)
            levels.append(coarse)
            lvl = coarse
            k += 1
        if not transitions or lvl.n > 4096:
            return None
        return cls(levels, transitions, lvl0.n, lump=lump)

    # -------------------------------------------------------------- device
    def prepare(self, diag, upper):
        """Unpack hybrid-packed face values and Galerkin-coarsen through
        every level. `upper` is the FvMatrix packed array ([K·nC lanes] +
        [rest]); symmetric systems only (lower == upper)."""
        K = len(self.levels[0].offsets)
        nC = self.n_cells
        lanes_w = [upper[k * nC:(k + 1) * nC] for k in range(K)]
        return self.prepare_parts(diag, lanes_w, upper[K * nC:])

    def prepare_parts(self, diag, lanes_w, rest_w):
        mats = [(diag, list(lanes_w), rest_w)]
        for i, tr in enumerate(self.transitions):
            mats.append(self._coarsen(tr, self.levels[i + 1], *mats[-1]))
        smooths = []
        for (d, lw, rw), lvl in zip(mats, self.levels):
            W = _stack(lw)
            rs_l = _rowsum_lane(lvl, W, d)
            rs_r = _rowsum_rest(lvl, rw, d)
            if self.lump:
                d_eff, rw_eff, rs = d + rs_r, None, rs_l
            else:
                d_eff, rw_eff, rs = d, rw, rs_l + rs_r
            lam = torch.clamp(torch.max(rs / d_eff) + 1.0, max=2.2)
            smooths.append(_Cheby(lvl, d_eff, W, rw_eff, lam, PRE_DEGREE, CHEBY_RATIO))
        return mats, smooths, self._coarsest_inv(mats[-1])

    def _coarsen(self, tr: _Transition, coarse: _Level, d, lanes_w, rest_w):
        pad = tr.n_pad - tr.n
        d_pad = torch.nn.functional.pad(d, (0, pad), value=1.0)
        dC = d_pad.reshape(tr.nb, 2, tr.op).sum(dim=1)
        P = 2 * tr.op
        Lk = [torch.nn.functional.pad(w, (0, pad)).reshape(tr.nb, P) for w in lanes_w]
        Cw = [d.new_zeros((tr.nb, tr.op)) for _ in coarse.offsets]
        for (k, r0, r1, c0, tgt) in tr.pieces:
            src = Lk[k][:, r0:r1]
            w = r1 - r0
            if tgt[0] == "d":
                dC[:, c0:c0 + w] += 2.0 * src
            else:
                Cw[tgt[1]][:, c0:c0 + w] += src
        ex = [rest_w] + [lanes_w[k].index_select(0, posn) for k, posn in tr.gathers]
        ex = [e for e in ex if e.shape[0]]
        ex = torch.cat(ex) if ex else d.new_zeros(0)
        dCf = dC.reshape(-1)
        if tr.src_d.shape[0]:
            dCf = dCf + tr.sum_d(2.0 * ex.index_select(0, tr.src_d))
        Cf = [w.reshape(-1) for w in Cw]
        for j, ((srcj, _), sj) in enumerate(zip(tr.lane_routes, tr.sum_lanes)):
            if srcj.shape[0]:
                Cf[j] = Cf[j] + sj(ex.index_select(0, srcj))
        if tr.n_cr:
            rw_c = tr.sum_r(ex.index_select(0, tr.src_r))
        else:
            rw_c = d.new_zeros(0)
        return dCf, Cf, rw_c

    def _coarsest_inv(self, mat):
        d, lanes_w, rest_w = mat
        lvl = self.levels[-1]
        A = torch.diag(d)
        for w, o in zip(lanes_w, lvl.offsets):
            E = torch.diag(w[: lvl.n - o], o)
            A = A + E + E.T
        if len(lvl.own_r):
            A = A.index_put((lvl.own_j, lvl.nei_j), rest_w, accumulate=True)
            A = A.index_put((lvl.nei_j, lvl.own_j), rest_w, accumulate=True)
        return _inv_newton_schulz(A)

    # -------------------------------------------------------------- cycle
    def _restrict(self, tr: _Transition, r):
        rp = torch.nn.functional.pad(r, (0, tr.n_pad - tr.n))
        return rp.reshape(tr.nb, 2, tr.op).sum(dim=1).reshape(-1)

    def _prolong(self, tr: _Transition, e):
        return e.reshape(tr.nb, 1, tr.op).expand(tr.nb, 2, tr.op).reshape(-1)[: tr.n]

    def vcycle(self, mats, smooths, A_inv, b):
        def level(i, b_i):
            if i == len(mats) - 1:
                return A_inv @ b_i
            sm = smooths[i]
            x = sm(torch.zeros_like(b_i), b_i)
            r = b_i - sm.mv(x)
            ec = level(i + 1, self._restrict(self.transitions[i], r))
            x = x + self._prolong(self.transitions[i], ec)
            return sm(x, b_i)

        return level(0, b)


def pairmg_pcg(mg: PairMG, matvec, diag, upper, b, x0, tol=1e-6, rel_tol=0.0,
               max_iter=200, sum_fn=_sum, dot_fn=_dot, mean_fn=_mean) -> SolverResult:
    """CG preconditioned with one index-pair-MG V-cycle per iteration, for
    one system ([nC] operands); OpenFOAM convergence semantics (normFactor,
    tol/relTol, the tolerance floored at 100·eps) identical to linear.pcg,
    so iteration counts are comparable. `matvec` is the exact fine operator
    (FvMatrix.matvec, or linear.ldu_matvec on the geometry); the
    preconditioner rebuilds its hierarchy from (diag, upper)."""
    mats, smooths, A_inv = mg.prepare(diag, upper)
    Ax0, norm = _norm_factor(matvec, x0, b, sum_fn, mean_fn)
    r = b - Ax0
    res0 = sum_fn(torch.abs(r)) / norm
    stop = torch.clamp(rel_tol * res0, min=tol_floor(tol, x0.dtype))
    x, p, rz_old, res, it = x0, None, None, res0, 0
    while it < max_iter and bool(res > stop):
        z = mg.vcycle(mats, smooths, A_inv, r)
        rz = dot_fn(r, z)
        p = z if it == 0 else z + (rz / rz_old) * p
        Ap = matvec(p)
        alpha = rz / dot_fn(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        res = sum_fn(torch.abs(r)) / norm
        rz_old = rz
        it += 1
    return SolverResult(x, res0, res, torch.tensor(it, dtype=torch.int32, device=x0.device))
