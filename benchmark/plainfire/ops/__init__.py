from .geometry import MeshGeometry, PatchInfo
from .fields import VolField, SurfaceField
from . import fvc, fvm, bcs
