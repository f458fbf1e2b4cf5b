"""Region models: 1-D pyrolysis and the surface film on extruded wall
regions (the port of firefoam_tpu/regionmodels)."""

from .film import ThermoSingleLayerFilm
from .oned import Region1D, tridiag_solve
from .pyrolysis import PyrolysisCollection, ReactingOneDim
from .solid import SolidChemistry, SolidThermo
from .surfmesh import FilmMesh

__all__ = [
    "Region1D",
    "tridiag_solve",
    "PyrolysisCollection",
    "ReactingOneDim",
    "SolidChemistry",
    "SolidThermo",
    "ThermoSingleLayerFilm",
    "FilmMesh",
]
