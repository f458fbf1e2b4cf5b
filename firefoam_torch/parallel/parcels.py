"""Fixed-capacity Lagrangian parcel migration between partitions.

The PyTorch port of firefoam_tpu/parallel/parcels.py. The reference hands
parcels across MPI ranks when tracking hits a processor patch
(KinematicParcel.C:330-333 `switchProcessor`, :402-412 hitProcessorPatch)
and rebuilds the receiving cloud's list. Here parcels live in per-partition
SoA arrays of static capacity with an alive mask; after tracking, parcels
whose cell now belongs to another partition carry a `dest` part id, and one
exchange round moves them with the ring-offset `ppermute` schedule of the
halo — a static all-to-all with a fixed send capacity per round. Overflow
parcels stay put (alive, dest intact) for the caller's next round (the
cloud's migration goes on until none is left); the overflow count is
reported so callers can size capacities.

Every rank makes the same P−1 rounds whatever its parcels, so the ranks
stay in lockstep. The merges write distinct slots (only the dump slot,
which is dropped, collides), so a round is bitwise repeatable on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["exchange_parcels"]


def _col(mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (v.ndim - 1))


def _pack(sel: torch.Tensor, val: torch.Tensor, cap_send: int) -> torch.Tensor:
    """Scatter the selected entries (in order) into a [cap_send] buffer."""
    pos = torch.where(sel, torch.cumsum(sel.to(torch.int64), 0) - 1,
                      torch.full_like(sel, cap_send, dtype=torch.int64))
    pos = torch.clamp(pos, max=cap_send)  # overflow → dump slot
    out = val.new_zeros((cap_send + 1,) + tuple(val.shape[1:]))
    out[pos] = torch.where(_col(sel, val), val, torch.zeros_like(val))
    return out[:cap_send]


def exchange_parcels(comm, soa: Dict[str, torch.Tensor], alive: torch.Tensor,
                     dest: torch.Tensor, n_parts: int,
                     cap_send: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """One migration round on this rank.

    soa:   dict of per-parcel arrays [cap(,k)].
    alive: [cap] bool.
    dest:  [cap] int — target part id, or −1 to stay.
    Returns (soa, alive, dest, n_overflow summed over the ranks): parcels
    with dest ≥ 0 move to their target partition's free slots (dead-first,
    stable order); a parcel beyond cap_send stays in its slot with its dest
    (dest ≥ 0 on a live slot marks it), every other live slot has dest −1.
    The payload of one round is one buffer per dtype (the
    SoA arrays of a dtype side by side) plus the sent mask."""
    me = comm.rank
    cap = alive.shape[0]
    dev = alive.device
    keys = list(soa.keys())
    groups: Dict[torch.dtype, list] = {}
    for k in keys:
        groups.setdefault(soa[k].dtype, []).append(k)
    soa = dict(soa)
    lane = torch.arange(cap_send, device=dev)

    n_over = torch.zeros((), dtype=torch.int64, device=dev)
    for d in range(1, n_parts):
        tgt = (me + d) % n_parts
        sel = alive & (dest == tgt)
        rank = torch.cumsum(sel.to(torch.int64), 0) - 1
        sendable = sel & (rank < cap_send)
        n_over = n_over + torch.sum(sel & ~sendable)

        perm = [(q, (q + d) % n_parts) for q in range(n_parts)]
        bufs = {}
        for dt, ks in groups.items():
            flat = torch.cat([soa[k].reshape(cap, -1) for k in ks], dim=1)
            got = comm.ppermute(_pack(sendable, flat, cap_send), perm)
            o = 0
            for k in ks:
                w = int(np.prod(soa[k].shape[1:], dtype=np.int64))
                bufs[k] = got[:, o:o + w].reshape((cap_send,) + tuple(soa[k].shape[1:]))
                o += w
        sent = _pack(sendable, torch.ones(cap, dtype=torch.float32, device=dev), cap_send)
        recv_mask = comm.ppermute(sent, perm) > 0.5

        # retire the sent parcels locally
        alive = alive & ~sendable
        dest = torch.where(sendable, torch.full_like(dest, -1), dest)

        # merge the received parcels into free slots (dead-first stable order)
        free_slots = torch.sort(alive.to(torch.int32), stable=True).indices
        slot = free_slots[lane % cap]
        # only place where the slot really is free AND a parcel arrived
        ok = recv_mask & ~alive[slot] & (lane < cap)
        tgt_slot = torch.where(ok, slot, torch.full_like(slot, cap))  # dump overflow
        n_over = n_over + torch.sum(recv_mask & ~ok)
        for k in keys:
            v = soa[k]
            ext = torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))])
            ext[tgt_slot] = torch.where(_col(ok, bufs[k]), bufs[k], torch.zeros_like(bufs[k]))
            soa[k] = ext[:cap]
        recv_at = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        recv_at[tgt_slot] = ok
        recv_at = recv_at[:cap]
        alive = alive | recv_at
        dest = torch.where(recv_at, torch.full_like(dest, -1), dest)
    return soa, alive, dest, comm.psum(n_over)


# ---------------------------------------------------------------------------
# rank function for parallel.comm.launch (the tests)
# ---------------------------------------------------------------------------
def rank_exchange(comm, soa, alive, dest, cap_send):
    """exchange_parcels on this rank's rows of [P, cap] arrays."""
    p = comm.rank

    def t(a):
        return torch.as_tensor(np.asarray(a)[p], device=comm.device)

    out, a, _, n_over = exchange_parcels(comm, {k: t(v) for k, v in soa.items()}, t(alive),
                                      t(dest), comm.n_parts, cap_send)
    return {k: v.cpu().numpy() for k, v in out.items()}, a.cpu().numpy(), int(n_over)
