"""Field containers.

A VolField is (internal[nCells(,3)], boundary[nBoundaryFaces(,3)]) — the
boundary part holds evaluated patch-face values, matching OpenFOAM's
GeometricField internalField/boundaryField split. A SurfaceField is
(internal[nInternalFaces(,3)], boundary[nB(,3)]).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["VolField", "SurfaceField"]


class VolField(NamedTuple):
    i: torch.Tensor  # internal (cell) values [nC(,3)]
    b: torch.Tensor  # boundary face values [nB(,3)]

    @property
    def is_vector(self) -> bool:
        return self.i.ndim == 2

    def __add__(self, o):
        return VolField(self.i + _i(o), self.b + _b(o))

    def __sub__(self, o):
        return VolField(self.i - _i(o), self.b - _b(o))

    def __mul__(self, o):
        return VolField(self.i * _i(o), self.b * _b(o))

    def __rmul__(self, o):
        return VolField(_i(o) * self.i, _b(o) * self.b)

    def __truediv__(self, o):
        return VolField(self.i / _i(o), self.b / _b(o))

    def __neg__(self):
        return VolField(-self.i, -self.b)


class SurfaceField(NamedTuple):
    i: torch.Tensor  # internal face values [nI(,3)]
    b: torch.Tensor  # boundary face values [nB(,3)]

    def __add__(self, o):
        return SurfaceField(self.i + _i(o), self.b + _b(o))

    def __sub__(self, o):
        return SurfaceField(self.i - _i(o), self.b - _b(o))

    def __mul__(self, o):
        return SurfaceField(self.i * _i(o), self.b * _b(o))

    def __rmul__(self, o):
        return SurfaceField(_i(o) * self.i, _b(o) * self.b)

    def __truediv__(self, o):
        return SurfaceField(self.i / _i(o), self.b / _b(o))

    def __neg__(self):
        return SurfaceField(-self.i, -self.b)


def _i(o):
    return o.i if isinstance(o, (VolField, SurfaceField)) else o


def _b(o):
    return o.b if isinstance(o, (VolField, SurfaceField)) else o
