"""The host side of the port's grid-wide Krylov kernels, on the CPU.

* `dia_krylov.grid_plan(B, nC, G)`: how B systems of nC cells are laid over
  G co-resident blocks. For the main path's cases (B = 1/3/4/16 at 100k and
  9k cells) and the edges (fewer cells than blocks, sizes that do not
  divide, B = G, B > G): every cell of every row is owned exactly once, a
  row's ranges are contiguous and in block order, no block is empty, the
  launch fits in G blocks, and the plan is a pure function of its arguments.
* The `extern "C"` entry points of csrc/dia_krylov.cu, parsed from the
  source (macros expanded), against the ctypes argtypes the wrapper sets: a
  mismatch would otherwise show only as a crash on the card.
"""

import ctypes
import os
import re

import pytest

from firefoam_torch.solvers import dia_krylov

G_H100 = 132  # blocks of 1024 threads co-resident on an H100 (one per SM)

CASES = [
    # the main path: p_rgh, U, Yi, h/k, the fvDOM rays, at 100k and 9k cells
    (1, 100_000, G_H100), (3, 100_000, G_H100), (4, 100_000, G_H100), (16, 100_000, G_H100),
    (1, 9_000, G_H100), (3, 9_000, G_H100), (4, 9_000, G_H100), (16, 9_000, G_H100),
    # edges
    (1, 50, G_H100),  # fewer cells than blocks
    (1, 5, G_H100),
    (2, 5, G_H100),
    (1, 100_003, G_H100),  # divides by nothing
    (7, 12_345, G_H100),
    (1, 500_000, G_H100),
    (G_H100, 9_000, G_H100),  # B = G: one block a row, still grid-wide
    (1, 9_000, 1),
    (5, 1_000, 4),  # B > G
    (200, 9_000, G_H100),
    (3, 100_000, 264),  # another card: two blocks per SM
]


@pytest.mark.parametrize("B,nC,G", CASES)
def test_grid_plan_owns_every_cell_once(B, nC, G):
    plan = dia_krylov.grid_plan(B, nC, G)
    assert plan.grid_wide == (B <= G)
    assert len(plan.ranges) == plan.blocks_per_row
    owned = [0] * nC
    end = 0
    for j, (c0, c1) in enumerate(plan.ranges):
        assert c0 == end and c1 > c0, (j, c0, c1)  # contiguous, ordered, not empty
        assert c0 == j * plan.cells_per_block  # what the kernel computes from (j, L)
        assert c1 - c0 <= plan.cells_per_block
        for c in range(c0, c1):
            owned[c] += 1
        end = c1
    assert end == nC and owned == [1] * nC
    if plan.grid_wide:
        assert B * plan.blocks_per_row <= G  # the cooperative launch fits
        assert plan.cells_per_block % 32 == 0
    else:
        assert plan.blocks_per_row == 1 and plan.ranges == ((0, nC),)


@pytest.mark.parametrize("B,nC,G", CASES)
def test_grid_plan_is_a_pure_function(B, nC, G):
    first = dia_krylov.grid_plan(B, nC, G)
    dia_krylov.grid_plan.cache_clear()
    assert dia_krylov.grid_plan(B, nC, G) == first
    assert dia_krylov.grid_plan(B, nC, G, dia_krylov.MIN_CELLS) == first


def test_grid_plan_spreads_one_system_over_the_card():
    """p_rgh at 100k cells takes (nearly) every block; more rows share them;
    small systems take fewer blocks of at least MIN_CELLS cells."""
    assert dia_krylov.grid_plan(1, 100_000, G_H100).blocks_per_row > G_H100 - 4
    assert dia_krylov.grid_plan(3, 100_000, G_H100).blocks_per_row == G_H100 // 3
    assert dia_krylov.grid_plan(16, 100_000, G_H100).blocks_per_row == G_H100 // 16
    small = dia_krylov.grid_plan(1, 9_000, G_H100)
    assert small.cells_per_block >= dia_krylov.MIN_CELLS
    assert small.blocks_per_row == -(-9_000 // small.cells_per_block)
    wide = dia_krylov.grid_plan(1, 9_000, G_H100, min_cells=128)
    assert wide.blocks_per_row > small.blocks_per_row


@pytest.mark.parametrize("B,nC,G", [(0, 10, 4), (1, 0, 4), (1, 10, 0)])
def test_grid_plan_rejects_nonsense(B, nC, G):
    with pytest.raises(ValueError):
        dia_krylov.grid_plan(B, nC, G)


# ------------------------------------------------- C signatures vs argtypes
def _ctype(decl: str):
    """The ctypes type the wrapper must declare for one C parameter."""
    decl = " ".join(decl.split())
    base = decl.rsplit(" ", 1)[0] if not decl.endswith("*") else decl
    if "*" in decl:
        # a host array of ints is passed as a ctypes array, device memory and
        # the stream as integers
        if re.fullmatch(r"(const )?int\*", base.replace(" *", "*")) and not decl.endswith(
                ("iters", "flags")):
            return ctypes.POINTER(ctypes.c_int)
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong, "double": ctypes.c_double}[base]


def _c_entry_points():
    """{name: [ctypes type, ...]} of every extern "C" function in the CUDA
    source, with the macros that define families of them expanded."""
    with open(os.path.join(os.path.dirname(dia_krylov.__file__), "..", "csrc",
                           "dia_krylov.cu")) as f:
        src = f.read()
    src = re.sub(r"//[^\n]*", "", src).replace("\\\n", " ")
    out = {}
    proto = r'extern "C" int (\S+?)\s*\(([^)]*)\)'
    for line in src.splitlines():
        m = re.match(r"#define (\w+)\(([^)]*)\)\s+" + proto, line)
        if m:
            macro, params, name, args = m.groups()
            params = [p.strip() for p in params.split(",")]
            for call in re.finditer(rf"^{macro}\(([^)]*)\)\s*$", src, re.M):
                sub = dict(zip(params, (v.strip() for v in call.group(1).split(","))))
                word = lambda t: re.sub(r"\b\w+\b", lambda w: sub.get(w.group(0), w.group(0)), t)
                out[word(name).replace("##", "")] = [word(a) for a in args.split(",")]
        elif not line.startswith("#define"):
            for name, args in re.findall(proto, line):
                out[name] = args.split(",")
    # a prototype outside the macros may span lines
    for name, args in re.findall(r'^extern "C" int (\w+)\s*\(([^)]*)\)', src, re.M | re.S):
        out.setdefault(name, args.split(","))
    return {name: [_ctype(a) for a in args] for name, args in out.items()}


def test_c_entry_points_match_the_wrappers_argtypes():
    parsed = _c_entry_points()
    declared = dia_krylov.signatures()
    assert set(parsed) == set(declared)
    assert len(parsed) == 12  # 3 kernels + 2 grid-wide, in f32 and f64; 2 helpers
    for name, argtypes in declared.items():
        assert parsed[name] == argtypes, name


def test_launch_arguments_match_the_signatures():
    """The tuples `_launch` builds have the length the entry points take: 21
    operands, the kernel's extras, the stream."""
    sig = dia_krylov.signatures()
    assert len(sig["ffk_pcg_f32"]) == 22
    assert len(sig["ffk_smooth_f64"]) == 24  # + omega, check_every
    assert len(sig["ffk_bicgstab_grid_f32"]) == 27  # + slots, flags, bpr, L, smem
    assert sig["ffk_pcg_grid_f64"] == sig["ffk_bicgstab_grid_f32"]
