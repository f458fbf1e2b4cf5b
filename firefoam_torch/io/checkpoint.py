"""Checkpoint / resume of the whole solver state.

The port of firefoam_tpu/io/checkpoint.py. The reference checkpoints by
writing every AUTO_WRITE field to a time directory and resuming via
'startFrom latestTime'; here the whole state dict (gas fields, radiation
intensities, RTI probe and link states) goes into one compressed npz, so a
resumed run continues the trajectory bit for bit on the CPU.

The npz keys are the JAX package's: `jax.tree_util.keystr` of each leaf's
path, e.g. "['U'].i" for a field's cell values, "['rad']['G']" for a
nested entry and "['cloud']['inj'][0]['n_inj']" for a list element. Every
leaf keeps its dtype (the cloud's random key is a uint32 pair in both
packages), so a checkpoint written by either package loads into the other.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .master import is_master

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint", "checkpoint_path"]

_CKPT_RE = re.compile(r"^state_(.+)\.npz$")


def _is_field(x) -> bool:
    return isinstance(x, tuple) and getattr(x, "_fields", None) == ("i", "b")


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(key, leaf) pairs with the JAX package's key strings."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}[{k!r}]"
        if isinstance(v, (dict, list)):
            yield from _leaves(v, key)
        elif _is_field(v):
            yield f"{key}.i", v.i
            yield f"{key}.b", v.b
        else:
            yield key, v


def save_checkpoint(path: str, state: Dict) -> str:
    """Write the state to `path` (npz, master-only); returns the path."""
    if not is_master():
        return path
    arrays = {k: v.detach().cpu().numpy() for k, v in _leaves(state)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


def load_checkpoint(path: str, template: Dict) -> Dict:
    """Restore a state saved by save_checkpoint (of either package).

    `template` is a freshly built state of the same solver: it gives the
    structure, device and dtypes; the file gives every leaf it holds. A
    leaf the file lacks keeps the template's value; a shape mismatch is an
    error."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}

    def restore(tree, prefix=""):
        out = {} if isinstance(tree, dict) else [None] * len(tree)
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            key = f"{prefix}[{k!r}]"
            if isinstance(v, (dict, list)):
                out[k] = restore(v, key)
            elif _is_field(v):
                out[k] = type(v)(leaf(f"{key}.i", v.i), leaf(f"{key}.b", v.b))
            else:
                out[k] = leaf(key, v)
        return out

    def leaf(key, t):
        if key not in data:
            return t
        arr = data[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {arr.shape} != template "
                             f"{tuple(t.shape)}")
        return torch.as_tensor(arr, device=t.device).to(t.dtype)

    return restore(template)


def checkpoint_path(out_root: str, time_value: float) -> str:
    return os.path.join(out_root, "checkpoints", f"state_{time_value:.6g}.npz")


def latest_checkpoint(out_root: str) -> Optional[str]:
    """The newest checkpoint under <out_root>/checkpoints, by time value."""
    d = os.path.join(out_root, "checkpoints")
    if not os.path.isdir(d):
        return None
    best, best_t = None, None
    for name in os.listdir(d):
        m = _CKPT_RE.match(name)
        if not m:
            continue
        try:
            t = float(m.group(1))
        except ValueError:
            continue
        if best_t is None or t > best_t:
            best, best_t = os.path.join(d, name), t
    return best
