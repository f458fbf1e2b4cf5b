"""The port's snappyHexMesh castellation (firefoam_torch/mesh/snappy.py and
the snappyHexMesh step of mesh/case_mesh.py) against the JAX package's, on
the castellated fire case of utils/synthcase.py: the same points, face
vertex lists, owner, neighbour, patches, sets and zones, exactly, for two
placements of the obstruction (the default one, whose refinement region
reaches the burner side, and one against the x = 0 wall)."""

import numpy as np
import pytest

from firefoam_tpu.mesh import build_case_mesh as j_build
from firefoam_tpu.mesh.snappy import snappy_castellated as j_snappy
from firefoam_tpu.io.foamdict import parse_file as j_parse
from firefoam_torch.io.foamdict import parse_file as t_parse
from firefoam_torch.mesh import build_case_mesh as t_build
from firefoam_torch.mesh.snappy import snappy_castellated as t_snappy
from firefoam_torch.utils.synthcase import write_castellated_fire_case

PLACEMENTS = {
    "centre": ((0.58, 0.30, 0.58), (0.82, 0.62, 0.82)),
    "wall": ((0.0, 0.45, 0.20), (0.26, 0.75, 0.45)),
}


@pytest.fixture(scope="module", params=list(PLACEMENTS))
def case(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(request.param))
    return write_castellated_fire_case(root, n=(10, 8, 10), obstacle=PLACEMENTS[request.param])


def _same_mesh(a, b):
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.face_verts, b.face_verts)
    np.testing.assert_array_equal(a.face_offsets, b.face_offsets)
    np.testing.assert_array_equal(a.owner, b.owner)
    np.testing.assert_array_equal(a.neighbour, b.neighbour)
    assert [(p.name, p.ptype, p.start, p.n_faces) for p in a.patches] == \
        [(p.name, p.ptype, p.start, p.n_faces) for p in b.patches]
    np.testing.assert_array_equal(a.V, b.V)
    np.testing.assert_array_equal(a.C, b.C)
    np.testing.assert_array_equal(a.Sf, b.Sf)


def test_castellation_matches(case):
    """snappy_castellated on the case's own dictionaries."""
    dicts = ("constant/polyMesh/blockMeshDict", "system/snappyHexMeshDict")
    t = t_snappy(*(t_parse(f"{case}/{d}", case_dir=case) for d in dicts))
    j = j_snappy(*(j_parse(f"{case}/{d}", case_dir=case) for d in dicts))
    _same_mesh(t, j)
    assert "box" in [p.name for p in t.patches]
    faces = np.bincount(t.owner, minlength=t.n_cells) + np.bincount(t.neighbour,
                                                                   minlength=t.n_cells)
    assert faces.max() > 6  # 2:1 hanging-node cells


def test_case_mesh_pipeline_matches(case):
    """build_case_mesh runs mesh.sh: blockMesh, snappyHexMesh, topoSet (the
    burner faceZone) and createPatch (the burner patch)."""
    t, j = t_build(case), j_build(case)
    _same_mesh(t.mesh, j.mesh)
    assert sorted(t.sets.cell_zones) == sorted(j.sets.cell_zones)
    assert sorted(t.face_zones) == sorted(j.face_zones)
    for name, fz in j.face_zones.items():
        np.testing.assert_array_equal(np.asarray(t.face_zones[name].faces), np.asarray(fz.faces))
    for name, cz in j.sets.cell_zones.items():
        np.testing.assert_array_equal(np.asarray(t.sets.cell_zones[name]), np.asarray(cz))
    assert [p.name for p in t.mesh.patches][-2:] == ["box", "burner"]
