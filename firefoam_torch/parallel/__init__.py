"""Multiple partitions over `torch.distributed` (the reference's MPI layer).

The PyTorch port of firefoam_tpu/parallel/. Host side:
`partition.MeshPartition` — RCB or z-slab cell decomposition, partition-
major renumbering, replicated-cross-face local face lists and the ring-
offset halo plan (the decomposePar role).

Rank side (one process per partition, `comm.launch`): `comm` — the ranks
and their counted collectives; `sharded` — the ppermute halo exchange,
per-partition SpMV and the psum-reduced CG; `sharded_gmg` — the z-slab
lattice multigrid; `parcels.exchange_parcels` — fixed-capacity parcel
migration (the `switchProcessor` role); `localize` and `spmd_step` — the
explicitly partitioned fire step.
"""

from . import comm
from .partition import MeshPartition, rcb_partition
from .sharded import (
    SpmvLocal,
    halo_exchange,
    make_sharded_solver,
    psum_reducers,
    sharded_pcg,
)
from .parcels import exchange_parcels

__all__ = [
    "comm",
    "MeshPartition",
    "rcb_partition",
    "SpmvLocal",
    "halo_exchange",
    "make_sharded_solver",
    "psum_reducers",
    "sharded_pcg",
    "exchange_parcels",
]
