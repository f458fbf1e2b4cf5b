"""What `--seed` draws, made by the benchmark and handed alike to the
program and to the reference: a perturbation of the initial velocity.
Every seed draws the same sizes, so seeds give different warm states of
the same case and the same work."""

from __future__ import annotations

import numpy as np
import torch


def draw_inputs(seed: int, n_cells: int, draws: dict) -> dict:
    """U: [n_cells, 3] uniform in ±`u_amplitude` m/s."""
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    return {"U": float(draws["u_amplitude"]) * rng.uniform(-1.0, 1.0, (n_cells, 3))}


def apply_inputs(state: dict, inputs: dict) -> dict:
    """The initial state with the perturbation added to U's interior."""
    st = dict(state)
    U = st["U"]
    st["U"] = type(U)(U.i + torch.as_tensor(inputs["U"], dtype=U.i.dtype, device=U.i.device), U.b)
    return st
