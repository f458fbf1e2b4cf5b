"""The benchmark's case writer benchmark/cases/steckler_room.py: at the
steckler demo's own 0.2 m it writes the demo's mesh (9,000 cells over
[-2,4] x [0,3] x [-2,2] m, cell 0 at (-1.9 0.1 -1.9), a burner of 2 x 2
floor faces within 0.1524 m of the centre, the room's walls as baffles),
and at the configuration's 0.1 m the same room on a lattice twice as fine,
with its doorway open."""

import importlib.util
import os

import numpy as np
import pytest

from plainfire.mesh import build_case_mesh

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _writer():
    spec = importlib.util.spec_from_file_location(
        "steckler_room", os.path.join(BENCH, "cases", "steckler_room.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("h, cells, burner, walls", [(0.2, 9000, 4, 776),
                                                      (0.1, 72000, 16, 3104)])
def test_the_room_on_its_lattice(tmp_path, h, cells, burner, walls):
    m = build_case_mesh(_writer().write(str(tmp_path / "case"), h=h)).mesh
    names = {p.name: p.n_faces for p in m.patches}
    assert m.n_cells == cells and m.V.sum() == pytest.approx(72.0, rel=1e-12)
    assert np.allclose(m.C[0], [-2 + h / 2, h / 2, -2 + h / 2])
    assert names["burner"] == burner and names["walls_master"] == names["walls_slave"] == walls
    b = m.patch("burner")
    assert np.allclose(m.Cf[b.slice][:, 1], 0.0)
    assert np.all(np.abs(m.Cf[b.slice][:, [0, 2]]) < 0.1524)
    # the walls and ceiling: 4 walls of 2.8 x 2.2 m and 2.8 x 2.8 m of
    # ceiling, less the 0.8 x 1.8 m doorway
    w = m.patch("walls_master")
    assert np.linalg.norm(m.Sf[w.slice], axis=1).sum() == pytest.approx(
        4 * 2.8 * 2.2 + 2.8 * 2.8 - 0.8 * 1.8)
    assert np.allclose(m.Cf[w.slice], m.Cf[m.patch("walls_slave").slice])
    # the doorway's faces stay internal: x = 1.4, |z| < 0.4, y < 1.8
    n_int = m.n_internal_faces
    cf = m.Cf[:n_int]
    door = (np.abs(cf[:, 0] - 1.4) < 1e-9) & (np.abs(cf[:, 2]) < 0.4) & (cf[:, 1] < 1.8)
    assert door.sum() == round(0.8 / h) * round(1.8 / h)
    assert set(np.unique(m.neighbour - m.owner[:n_int])) == {1, round(6 / h), round(6 / h) * round(3 / h)}


def test_the_burner_feeds_62_9_kw(tmp_path):
    w = _writer()
    case = w.write(str(tmp_path / "case"), h=0.2)
    with open(os.path.join(case, "0", "U")) as f:
        text = f.read()
    mdot = float(text.split("massFlowRate constant")[1].split(";")[0])
    assert mdot * w.Q_FUEL == pytest.approx(62.9e3, rel=1e-8)
