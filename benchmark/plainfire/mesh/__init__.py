from .polymesh import PolyMesh, Patch
from .blockmesh import block_mesh
from .toposet import TopoSets, FaceZone, apply_topo_set_dict, apply_set_set_batch
from .meshedit import create_patch, create_baffles
from .case_mesh import CaseMesh, build_case_mesh
