"""Process-0 (master) gating for host-side I/O on multi-process runs.

The reference gates every probe/log/undecomposed-case write behind
Pstream::master() (rtis.C:292-309). In the port that role falls to rank 0
of an initialised torch.distributed process group; a run without one (every
single-card run and the tests) is always master.
"""

from __future__ import annotations

import torch.distributed as dist

__all__ = ["is_master"]


def is_master() -> bool:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True
