"""Lagrangian spray clouds: the port of firefoam_tpu/lagrangian (fixed-capacity
parcel SoA, containment-walk tracking, vectorised physics, order-fixed
parcel→cell sums, and the JAX package's random generator bit for bit)."""

from .cloud import ReactingCloud
from .liquids import H2O, Liquid, liquid_by_name
from .tracking import WalkMesh

__all__ = ["ReactingCloud", "WalkMesh", "Liquid", "H2O", "liquid_by_name"]
