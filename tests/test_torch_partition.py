"""The partitioner of the port (firefoam_torch/parallel/partition.py and
localize.py) against the JAX package's, on the CPU in float64.

Both packages partition the same meshes — the box fire's lattice
(write_box_fire_case at (10, 8, 12)) and the castellated fire
(write_castellated_fire_case at (8, 6, 8): cells with up to 9 faces, no
lattice) — into P = 2 and 4 parts, by RCB and (on the lattice) z-slabs.
Held bitwise equal: the MeshPartition (part of each cell, the local
numbering, the replicated-cross-face local face lists, the halo slots and
the ring schedule of the halo plan), the Localizer's boundary layout and
scatter maps, the slab face maps, and every array of each partition's
geometry. Also: lattice_from_graph and slab_partition, and RCB's balance
and cover (tests/test_parallel.py::test_rcb_balance_and_cover).
"""

import numpy as np
import pytest
import torch

from firefoam_torch.utils.synthcase import write_box_fire_case, write_castellated_fire_case

torch.set_num_threads(1)

CASES = {"box": (write_box_fire_case, (10, 8, 12)),
         "castellated": (write_castellated_fire_case, (8, 6, 8))}
# (case, n_parts, method)
SPLITS = [("box", 2, "rcb"), ("box", 4, "rcb"), ("box", 2, "slab"), ("box", 4, "auto"),
          ("castellated", 2, "rcb"), ("castellated", 4, "auto")]
MP_ARRAYS = ("part_of_cell", "l2g", "g2l", "n_own", "cell_mask", "face_own", "face_nei",
             "face_gid", "face_valid", "own_mine", "nei_mine", "halo_g", "bface_own",
             "bface_gid", "bface_valid")
GEOM_ARRAYS = ("own", "nei", "w", "Sf", "magSf", "dc", "nodc", "Cf", "face_mask", "V", "C",
               "b_own", "b_Sf", "b_magSf", "b_dc", "b_nodc", "b_Cf", "cell_w", "b_valid")


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    from firefoam_torch.mesh import build_case_mesh as t_build
    from firefoam_torch.ops.geometry import MeshGeometry as TGeom
    from firefoam_tpu.mesh import build_case_mesh as j_build
    from firefoam_tpu.ops.geometry import MeshGeometry as JGeom

    out = {}
    for name, (writer, n) in CASES.items():
        root = writer(str(tmp_path_factory.mktemp(name)), n=n)
        cm_t, cm_j = t_build(root), j_build(root)
        out[name] = (cm_t, TGeom.from_polymesh(cm_t.mesh, dtype=torch.float64, device="cpu",
                                               layout="seg"),
                     cm_j, JGeom.from_polymesh(cm_j.mesh, layout="seg"))
    return out


@pytest.fixture(scope="module")
def localizers(meshes):
    from firefoam_torch.parallel.localize import Localizer as TLoc
    from firefoam_tpu.parallel.localize import Localizer as JLoc

    out = {}
    for case, P, method in SPLITS:
        cm_t, gg_t, cm_j, gg_j = meshes[case]
        out[(case, P, method)] = (TLoc.build(gg_t, cm_t, P, method=method),
                                  JLoc.build(gg_j, cm_j, P, method=method))
    return out


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same(a, b, what):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.astype(a.dtype).tobytes() if a.dtype != b.dtype else \
        np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what


@pytest.mark.parametrize("split", SPLITS, ids=lambda s: "-".join(map(str, s)))
def test_mesh_partition_bitwise(localizers, split):
    t, j = localizers[split]
    mt, mj = t.mp, j.mp
    assert (mt.n_parts, mt.n_cells, mt.n_loc_max, mt.n_face_max, mt.h_max, mt.nb_max) == \
        (mj.n_parts, mj.n_cells, mj.n_loc_max, mj.n_face_max, mj.h_max, mj.nb_max)
    for k in MP_ARRAYS:
        _same(getattr(mt, k), getattr(mj, k), k)
    assert len(mt.steps) == len(mj.steps) > 0
    for st, sj in zip(mt.steps, mj.steps):
        assert st.offset == sj.offset
        for k in ("send_idx", "send_mask", "recv_slot"):
            _same(getattr(st, k), getattr(sj, k), k)
    _same(mt.halo_owner_part(), mj.halo_owner_part(), "halo_owner_part")
    _same(mt.halo_remote_local(), mj.halo_remote_local(), "halo_remote_local")


@pytest.mark.parametrize("split", SPLITS, ids=lambda s: "-".join(map(str, s)))
def test_localizer_maps_bitwise(localizers, meshes, split):
    t, j = localizers[split]
    assert t.n_ext == j.n_ext
    assert t.slab_dims == j.slab_dims
    assert [(p.name, p.ptype, p.start, p.n) for p in t.patches] == \
        [(p.name, p.ptype, p.start, p.n) for p in j.patches]
    _same(t.bmap, j.bmap, "bmap")
    _same(t.b_own_ext, j.b_own_ext, "b_own_ext")
    assert t.halo_plan_perm == j.halo_plan_perm
    # the scatter maps on random global arrays, and back
    cm = meshes[split[0]][0]
    rng = np.random.RandomState(5)
    nC, nI = cm.mesh.n_cells, cm.mesh.n_internal_faces
    nB = cm.mesh.n_faces - nI
    for x in (rng.randn(nC), rng.randn(nC, 3)):
        _same(t.cells(x), j.cells(x), "cells")
        _same(t.gather_cells(t.cells(x)), x, "gather_cells")
    for f in (rng.randn(nI), rng.randn(nI, 3)):
        _same(t.ifaces(f), j.ifaces(f), "ifaces")
        _same(t.gather_ifaces(t.ifaces(f), nI), f, "gather_ifaces")
    b = rng.randn(nB)
    _same(t.bfaces(b), j.bfaces(b), "bfaces")
    _same(t.gather_bfaces(t.bfaces(b), nB), b, "gather_bfaces")
    if t.slab_dims is not None:
        own = np.asarray(cm.mesh.owner[:nI])
        nei = np.asarray(cm.mesh.neighbour)
        for p in range(t.mp.n_parts):
            mt, mj = t.slab_face_maps(p, own, nei), j.slab_face_maps(p, own, nei)
            assert sorted(mt) == sorted(mj)
            for a in mt:
                _same(mt[a], mj[a], f"slab map {a}")


@pytest.mark.parametrize("split", SPLITS, ids=lambda s: "-".join(map(str, s)))
def test_partition_geometry_bitwise(localizers, meshes, split):
    """Each partition's ShardGeometry holds the JAX package's arrays bit for
    bit, and its halo plan the same rows."""
    t, j = localizers[split]
    _, gg_t, _, gg_j = meshes[split[0]]
    for p in range(t.mp.n_parts):
        gt, gj = t.make_geom(gg_t, p), j.make_geom(gg_j, p)
        assert (gt.n_cells, gt.n_internal, gt.n_boundary, gt.n_own_slots, gt.halo_size) == \
            (gj.n_cells, gj.n_internal, gj.n_boundary, gj.n_own_slots, gj.halo_size)
        for k in GEOM_ARRAYS:
            _same(getattr(gt, k), getattr(gj, k), k)
        _same(gt.recon_inv, gj.recon_inv, "recon_inv")
        assert len(gt.halo_plan) == len(gj.halo_plan)
        for (si, sm, rs, perm), (sij, smj, rsj, permj) in zip(gt.halo_plan, gj.halo_plan):
            _same(si, sij, "send_idx")
            _same(sm, smj, "send_mask")
            _same(rs, rsj, "recv_slot")
            assert tuple(perm) == tuple(permj)


@pytest.mark.parametrize("case", list(CASES))
def test_lattice_and_slab_bitwise(meshes, case):
    from firefoam_torch.parallel.partition import lattice_from_graph as t_lat
    from firefoam_torch.parallel.partition import slab_partition as t_slab
    from firefoam_tpu.parallel.partition import lattice_from_graph as j_lat
    from firefoam_tpu.parallel.partition import slab_partition as j_slab

    cm = meshes[case][0]
    nI = cm.mesh.n_internal_faces
    own, nei = np.asarray(cm.mesh.owner[:nI]), np.asarray(cm.mesh.neighbour)
    dims = t_lat(own, nei, cm.mesh.n_cells)
    assert dims == j_lat(own, nei, cm.mesh.n_cells)
    assert (dims is None) == (case == "castellated")
    if dims is not None:
        for P in (2, 3, 4, 5):
            a, b = t_slab(dims, P), j_slab(dims, P)
            assert (a is None) == (b is None)
            if a is not None:
                _same(a, b, "slab_partition")


def _box_graph(nx, ny, nz):
    idx = np.arange(nx * ny * nz).reshape(nz, ny, nx)
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    C = np.stack([i + 0.5, j + 0.5, k + 0.5], axis=-1).reshape(-1, 3).astype(np.float64)
    return C, idx


@pytest.mark.parametrize("n_parts", [3, 8])
def test_rcb_balance_and_cover(n_parts):
    from firefoam_torch.parallel.partition import rcb_partition
    from firefoam_tpu.parallel.partition import rcb_partition as j_rcb

    C, _ = _box_graph(10, 6, 4)
    part = rcb_partition(C, n_parts)
    counts = np.bincount(part, minlength=n_parts)
    assert counts.sum() == 240 and (counts > 0).all()
    assert counts.max() - counts.min() <= 1
    _same(part, j_rcb(C, n_parts), "rcb")
