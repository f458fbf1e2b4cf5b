"""The checkpoint aliases of the JAX package's utils/checkpoint.py: the
implementation lives in io.checkpoint (path-keyed state archives; see that
module's docstring)."""

from ..io.checkpoint import (  # noqa: F401
    checkpoint_path,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["save_state", "load_state", "latest_checkpoint", "checkpoint_path"]

save_state = save_checkpoint
load_state = load_checkpoint
