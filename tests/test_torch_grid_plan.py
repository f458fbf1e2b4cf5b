"""The host side of the port's grid-wide Krylov kernels, on the CPU.

* `dia_krylov.grid_plan(B, nC, G)`: how B systems of nC cells are laid over
  G co-resident blocks. For the main path's cases (B = 1/3/4/16 at 100k and
  9k cells) and the edges (fewer cells than blocks, sizes that do not
  divide, B = G, B > G): every cell of every row is owned exactly once, a
  row's ranges are contiguous and in block order, no block is empty, the
  launch fits in G blocks, and the plan is a pure function of its arguments.
  K1's many-rows layout (B from ROWS_MIN to the row cap): the same for its
  ranges, which every row shares; the routing rule by B at the fvDOM's
  batch sizes, B = G, B = G + 68 and the cap.
* The `extern "C"` entry points of csrc/dia_krylov.cu, parsed from the
  source (macros expanded), against the ctypes argtypes the wrapper sets: a
  mismatch would otherwise show only as a crash on the card.
* `_launch` itself, with the library, the occupancy query and the stream
  replaced by recorders: which entry point each kernel's launch picks, and
  that the arguments it passes match that entry point's argtypes in number
  and kind (K3's damping and sweeps per check before the grid's extras;
  K1's many-rows kernel with its slots, blocks, cells and options), and the
  count by device kernel.
* The shared-memory rule of `_grid_launch_plan`: K3 keeps 3 + 2K vectors of
  a block's cells resident, and streams them when that is over the limit.
* K1-K3's residency split above 3 offsets (`dia_krylov.residency`, a pure
  function): never over its bytes, the parts in their order (window, Krylov
  slices, diagonal, pairs), the all-or-nothing rule kept at 1-3 offsets,
  full residency where it fitted before (K2 at 34 offsets on 100k cells),
  the window and the Krylov slices first on the shaft's 233,600 B and K1's
  239,616 B cases, W = 0 where no window fits, the `window` argument, and
  the split `_launch` hands the entry point (K3's too); K3's split on the
  blocks of phase 3's systems and the banded shaft's (one row and the Yi
  batch of 4) at 12, 34 and 62 offsets.
* The windows of K1's many-rows kernel above 8 offsets
  (`dia_krylov.rows_window`, a pure function of the offsets, B, the dtype
  and the block's shared bytes, with the rows' own bytes from a copy of
  the kernel's count): never over the block's limit at 5 to 1,024 rows in
  float32 and float64, the near band served (OFFS_34's 87, OFFS_62's 62),
  OFFS_12's far band left to L2, W = 0 where no window fits and at 1-8
  offsets, the `window` argument, the W `_launch` hands the entry point,
  and the wrapper's constants against the source's.
"""

import ctypes
import os
import re

import pytest
import torch

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
    # K1's many-rows layout: the fvDOM's ray (x band) batches, B = G + 68, the cap
    (128, 100_000, G_H100), (160, 100_000, G_H100), (G_H100 + 68, 100_000, G_H100),
    (dia_krylov.ROWS_MAX, 100_000, G_H100), (dia_krylov.ROWS_MAX + 1, 9_000, G_H100),
]


@pytest.mark.parametrize("B,nC,G", CASES)
def test_grid_plan_owns_every_cell_once(B, nC, G):
    plan = dia_krylov.grid_plan(B, nC, G)
    # K1's rule: the many-rows kernel from ROWS_MIN rows to its cap, else the
    # grid-wide kernel up to G rows (K2 and K3 keep B <= G)
    assert plan.rows == (dia_krylov.ROWS_MIN <= B <= dia_krylov.ROWS_MAX)
    assert plan.grid_wide == (plan.rows or B <= G)
    assert dia_krylov.grid_plan(B, nC, G, many_rows=False).grid_wide == (B <= G)
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
        # the cooperative launch fits: B groups of blocks, or (many rows)
        # one set of blocks that every row shares
        assert (1 if plan.rows else B) * plan.blocks_per_row <= G
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
    # 16 rows: K2/K3's grid-wide layout gives each 8 blocks; K1 takes its
    # many-rows layout, every block in every row
    assert dia_krylov.grid_plan(16, 100_000, G_H100, many_rows=False).blocks_per_row == (
        G_H100 // 16)
    assert dia_krylov.grid_plan(16, 100_000, G_H100).blocks_per_row == 131
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
    # 3 kernels + 3 grid-wide + K1's many-rows kernel, in f32 and f64; 3 helpers
    assert len(parsed) == 17
    for name, argtypes in declared.items():
        assert parsed[name] == argtypes, name


def test_launch_arguments_match_the_signatures():
    """The tuples `_launch` builds have the length the entry points take: 21
    operands, the kernel's extras, the stream."""
    sig = dia_krylov.signatures()
    assert len(sig["ffk_pcg_f32"]) == 22
    assert len(sig["ffk_smooth_f64"]) == 24  # + omega, check_every
    # + slots, flags, bpr, L, smem, then the split above 3 offsets: window,
    # Krylov slices, diagonal, pairs resident
    assert len(sig["ffk_bicgstab_grid_f32"]) == 31
    assert sig["ffk_bicgstab_grid_f32"][26:30] == [ctypes.c_int] * 4
    assert sig["ffk_pcg_grid_f64"] == sig["ffk_bicgstab_grid_f32"]
    # + omega, check_every, then the grid's five and the split's four
    assert len(sig["ffk_smooth_grid_f32"]) == 33
    assert sig["ffk_smooth_grid_f64"][:24] == sig["ffk_smooth_f64"][:-1] + [ctypes.c_void_p]
    assert sig["ffk_smooth_grid_f64"][24:] == sig["ffk_pcg_grid_f64"][22:]
    assert sig["ffk_smooth_grid_f64"][21:23] == [ctypes.c_double, ctypes.c_int]
    # + slots, blocks, cells per block, the window's W above 8 offsets
    assert len(sig["ffk_bicgstab_rows_f64"]) == 26
    assert sig["ffk_bicgstab_rows_f32"][:21] == sig["ffk_bicgstab_f32"][:21]
    assert sig["ffk_bicgstab_rows_f32"][21:] == [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_void_p]


# --------------------------------------------- K3's plan and shared memory
MAX_SMEM_H100 = 232_448 - 1_024  # the opt-in limit less a kernel's static 1 KB (f64)
LATTICE = (1, 50, 2000)  # a lattice's 3 offsets (the 100k box's)


class _FakeCard:
    """Stands in for the library, the occupancy query and the stream, so
    that `_launch` runs on CPU tensors and its call can be read."""

    def __init__(self, monkeypatch, G=G_H100, max_smem=MAX_SMEM_H100):
        self.calls = []
        self.G, self.max_smem = G, max_smem
        monkeypatch.setattr(dia_krylov, "_load", lambda: self)
        monkeypatch.setattr(dia_krylov, "_coop_blocks", self.coop_blocks)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: self)

    cuda_stream = 0

    def coop_blocks(self, name, dtype, smem):
        return (self.G if smem <= self.max_smem else 0), self.max_smem

    def ffk_rows_smem(self, B, is_f64):  # a stand-in for the kernel's own count
        return 64 * B if 1 <= B <= dia_krylov.ROWS_MAX else -1

    def __getattr__(self, fn_name):
        if not fn_name.startswith("ffk_"):
            raise AttributeError(fn_name)

        def fn(*args):
            self.calls.append((fn_name, args))
            return 0

        return fn


@pytest.mark.parametrize("B,nC,bpr,L", [
    (1, 100_000, 131, 768), (4, 100_000, 33, 3040),  # h or k, and the Yi batch
    (1, 9_000, 18, 512), (4, 9_000, 18, 512),
])
def test_smooth_plan_on_the_main_path(monkeypatch, B, nC, bpr, L):
    _FakeCard(monkeypatch)
    for dtype, esize in ((torch.float32, 4), (torch.float64, 8)):
        plan, split = dia_krylov._grid_launch_plan("smooth", dtype, B, nC, LATTICE, esize)
        assert plan.grid_wide and (plan.blocks_per_row, plan.cells_per_block) == (bpr, L)
        assert split.bytes == 9 * L * esize  # d, b, x and 2·3 off-diagonals, resident


def test_smooth_slices_are_streamed_when_they_do_not_fit(monkeypatch):
    """9 vectors of a block's cells over the limit: the same plan with 0
    dynamic shared bytes. K2 keeps 11 and K1 16 vectors, so at one L they
    give up residency sooner."""
    _FakeCard(monkeypatch)
    fits = dia_krylov._grid_launch_plan("smooth", torch.float64, 4, 100_000, LATTICE, 8)
    assert fits[1].bytes == 9 * 3040 * 8 <= MAX_SMEM_H100
    assert dia_krylov._grid_launch_plan("bicgstab", torch.float64, 4, 100_000, LATTICE,
                                        8)[1] == dia_krylov.NOTHING
    plan, split = dia_krylov._grid_launch_plan("smooth", torch.float64, 1, 500_000, LATTICE, 8)
    assert plan.grid_wide and plan.cells_per_block == 3808 and split.bytes == 0
    _FakeCard(monkeypatch, max_smem=200_000)
    plan, split = dia_krylov._grid_launch_plan("smooth", torch.float64, 4, 100_000, LATTICE, 8)
    assert plan == fits[0] and split.bytes == 0


def _cpu_system(B, nC, dtype):
    g = torch.Generator().manual_seed(5)
    r = lambda *shape: torch.rand(*shape, generator=g, dtype=dtype)
    return (4.0 + r(B, nC), -r(B, 3 * nC), -r(B, 3 * nC), r(B, nC), r(B, nC)), (1, 10, 100)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid_wide", [True, False])
@pytest.mark.parametrize("name", ["pcg", "bicgstab", "smooth"])
def test_launch_passes_what_the_entry_point_takes(monkeypatch, name, grid_wide, dtype):
    card = _FakeCard(monkeypatch)
    ops, offs = _cpu_system(2, 1000, dtype)
    extra = (0.8, 4) if name == "smooth" else ()
    before = dia_krylov.LAUNCHES[name]
    dia_krylov._launch(name, *ops, offs, 1e-6, 0.0, 50, extra=extra, grid_wide=grid_wide)
    assert dia_krylov.LAUNCHES[name] == before + 1
    (fn_name, args), = card.calls
    suf = "f32" if dtype == torch.float32 else "f64"
    assert fn_name == f"ffk_{name}_{'grid_' if grid_wide else ''}{suf}"
    argtypes = dia_krylov.signatures()[fn_name]
    assert len(args) == len(argtypes)
    for a, t in zip(args, argtypes):
        if t is ctypes.c_double:
            assert isinstance(a, float), (a, t)
        elif t in (ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p):
            assert isinstance(a, int) and not isinstance(a, bool), (a, t)
        else:
            assert isinstance(a, ctypes.Array), (a, t)  # the offsets
    if name == "smooth":
        assert args[21:23] == (0.8, 4)
    if grid_wide:
        split = args[-5:-1]  # window, Krylov, diagonal, pairs
        bpr, L, smem = args[-8:-5]
        assert (bpr, L) == (2, 512)
        assert smem == (dia_krylov._GRID[name][1] + 6) * L * ops[0].element_size()
        # 3 offsets: the lattice kernels' all-resident slices
        assert split == (0, dia_krylov._GRID[name][1] - 1, 1, 3)


def test_launch_takes_one_block_per_row_when_rows_outnumber_blocks(monkeypatch):
    card = _FakeCard(monkeypatch, G=3)
    ops, offs = _cpu_system(4, 1000, torch.float32)
    dia_krylov._launch("smooth", *ops, offs, 1e-6, 0.0, 50, extra=(0.8, 4))
    assert card.calls[0][0] == "ffk_smooth_f32" and len(card.calls[0][1]) == 24


# ------------------------------------------- K1's layouts by number of rows
@pytest.mark.parametrize("B,device_kernel", [
    (1, "bicgstab_grid"), (3, "bicgstab_grid"), (4, "bicgstab_grid"),  # p_rgh-like, U
    (5, "bicgstab_rows"),  # the wall fire's species with Fstar
    (16, "bicgstab_rows"), (32, "bicgstab_rows"), (64, "bicgstab_rows"),  # fvDOM rays
    (128, "bicgstab_rows"), (160, "bicgstab_rows"),  # rays x 4 and x 5 bands
    (G_H100, "bicgstab_rows"), (G_H100 + 68, "bicgstab_rows"),
    (dia_krylov.ROWS_MAX, "bicgstab_rows"), (dia_krylov.ROWS_MAX + 1, "bicgstab"),
])
def test_k1_routing_rule(B, device_kernel):
    """Which device kernel K1 takes by B on an H100 (G = 132) at 100k cells:
    a pure function of (B, nC, G); K2 and K3 keep the grid-wide rule."""
    plan = dia_krylov.grid_plan(B, 100_000, G_H100)
    got = ("bicgstab_rows" if plan.rows else "bicgstab_grid" if plan.grid_wide
           else "bicgstab")
    assert got == device_kernel
    assert dia_krylov.takes_rows(B) == plan.rows
    if plan.rows:  # the cells of one row over the card, shared by every row
        assert plan == dia_krylov.grid_plan(1, 100_000, G_H100, dia_krylov.ROWS_MIN_CELLS,
                                            False)._replace(rows=True)
        assert (plan.blocks_per_row, plan.cells_per_block) == (131, 768)
    # what K2's and K3's launches ask for
    assert dia_krylov.grid_plan(B, 100_000, G_H100, many_rows=False).grid_wide == (B <= G_H100)


def test_rows_layout_uses_every_block_at_small_sizes():
    """A row of 9k cells alone takes 18 blocks of 512 cells; laid out for
    many rows it takes blocks of at least ROWS_MIN_CELLS: 94 of 96."""
    one = dia_krylov.grid_plan(1, 9_000, G_H100)
    many = dia_krylov.grid_plan(200, 9_000, G_H100)
    assert (one.blocks_per_row, one.cells_per_block) == (18, 512)
    assert many.rows and (many.blocks_per_row, many.cells_per_block) == (94, 96)
    assert dia_krylov.grid_plan(1, 50, G_H100, dia_krylov.ROWS_MIN_CELLS, False).blocks_per_row == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,rows,expect", [
    (16, None, "rows"), (3, None, "grid"), (4, None, "grid"), (5, None, "rows"),  # the rule
    (3, True, "rows"), (16, False, "grid"),  # forced either way, for phase 3
    (200, False, ""), (200, None, "rows"),  # B > G: the old layout is one block a row
])
def test_launch_picks_the_many_rows_kernel(monkeypatch, dtype, B, rows, expect):
    card = _FakeCard(monkeypatch)
    ops, offs = _cpu_system(B, 200, dtype)
    dia_krylov.reset_counts()
    dia_krylov._launch("bicgstab", *ops, offs, 1e-6, 0.0, 50, rows=rows)
    assert dia_krylov.LAUNCHES["bicgstab"] == 1
    (fn_name, args), = card.calls
    suf = "f32" if dtype == torch.float32 else "f64"
    assert fn_name == f"ffk_bicgstab_{expect + '_' if expect else ''}{suf}"
    assert dia_krylov.DEVICE_LAUNCHES == {
        k: int(k == fn_name[4:-4]) for k in dia_krylov.DEVICE_LAUNCHES}
    argtypes = dia_krylov.signatures()[fn_name]
    assert len(args) == len(argtypes)
    for a, t in zip(args, argtypes):
        if t is ctypes.c_double:
            assert isinstance(a, float), (a, t)
        elif t in (ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p):
            assert isinstance(a, int) and not isinstance(a, bool), (a, t)
        else:
            assert isinstance(a, ctypes.Array), (a, t)
    if expect == "rows":
        nblk, L, W = args[-4:-1]
        plan = dia_krylov.grid_plan(1, 200, G_H100, dia_krylov.ROWS_MIN_CELLS, False)
        assert (nblk, L) == (plan.blocks_per_row, plan.cells_per_block) == (7, 32)
        assert W == 0  # 3 offsets: the registers' kernel, no window
        assert args[16] == B


def test_many_rows_kernel_is_k1_only_and_capped(monkeypatch):
    _FakeCard(monkeypatch)
    ops, offs = _cpu_system(2, 200, torch.float32)
    with pytest.raises(ValueError):
        dia_krylov._launch("pcg", *ops, offs, 1e-6, 0.0, 50, rows=True)
    with pytest.raises(ValueError):
        dia_krylov._grid_launch_plan("bicgstab", torch.float32, dia_krylov.ROWS_MAX + 1,
                                     200, LATTICE, 4, rows=True)


# ------------------------- K1/K2 above 3 offsets: the residency split
# the shapes of the main path's systems above 3 offsets: phase 3 of
# chip_smoke.py (OFFS_12, OFFS_34, OFFS_62 at 100k cells) and the banded
# shaft (34 offsets, 104,280 cells: 800 cells a block)
OFFS_12 = (1, 2, 49, 50, 51, 100, 1950, 1999, 2000, 2001, 2050, 4000)
OFFS_34 = (1, 2, 3, 4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 21, 64, 66, 68, 69, 71,
           72, 73, 74, 76, 77, 78, 79, 81, 82, 84, 86, 87)
OFFS_62 = tuple(range(1, 63))
F32_H100 = 232_448 - 512  # the opt-in limit less the kernels' static 512 B (f32)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slice_bytes(split, L, esize):
    return ((L + 2 * split.window if split.window else 0)
            + (split.krylov + split.diag + 2 * split.pairs) * L) * esize


@pytest.mark.parametrize("name", ["pcg", "bicgstab", "smooth"])
@pytest.mark.parametrize("offs", [(1, 50, 2000), OFFS_12, OFFS_34, OFFS_62, tuple(range(1, 65)),
                                  (2000, 4000, 6000, 8000)])
@pytest.mark.parametrize("L", [32, 96, 512, 768, 800, 2304, 3040, 12512])
@pytest.mark.parametrize("esize", [4, 8])
def test_residency_never_exceeds_its_bytes(name, offs, L, esize):
    """Over a range of budgets, from none to the card's: the split's bytes
    are what its parts take, never over the budget, and the parts come in
    their order (Krylov slices before the diagonal before the pairs)."""
    for max_bytes in (0, esize * L - 1, esize * (L + 2), 3 * esize * L, 10 * esize * L,
                      100_000, F32_H100, MAX_SMEM_H100):
        split = dia_krylov.residency(name, offs, L, esize, max_bytes)
        assert split.bytes == _slice_bytes(split, L, esize) <= max_bytes, (max_bytes, split)
        assert 0 <= split.pairs <= len(offs) and split.diag in (0, 1)
        assert split.krylov <= dia_krylov._GRID[name][1] - 1
        if split.diag:
            assert split.krylov == dia_krylov._GRID[name][1] - 1
        if split.pairs:
            assert split.diag
        if split.window:
            assert split.window in offs and 2 * split.window <= L
        assert dia_krylov.residency(name, offs, L, esize, max_bytes) == split


@pytest.mark.parametrize("name", ["pcg", "bicgstab", "smooth"])
@pytest.mark.parametrize("L,esize", [(768, 4), (768, 8), (2304, 4), (2304, 8), (3040, 8),
                                     (512, 8), (12512, 4)])
def test_residency_keeps_the_lattice_rule_at_3_offsets(name, L, esize):
    """At 1-3 offsets every slice is resident when d, the kernel's vectors
    and the 2K off-diagonals fit, else none; no window. Above 3 offsets
    every kernel, K3 too, takes the split: a window where one fits."""
    for offs in ((1,), (1, 50), (1, 50, 2000)):
        full = (dia_krylov._GRID[name][1] + 2 * len(offs)) * L * esize
        split = dia_krylov.residency(name, offs, L, esize, MAX_SMEM_H100)
        if full <= MAX_SMEM_H100:
            assert split == (0, dia_krylov._GRID[name][1] - 1, 1, len(offs), full)
        else:
            assert split == dia_krylov.NOTHING
    split = dia_krylov.residency(name, OFFS_34, L, esize, MAX_SMEM_H100)
    assert split.window == 87 and split.krylov >= 1


def test_residency_is_full_where_it_fitted_before():
    """K2 at 34 offsets on 100k cells (768 cells a block, float32) kept its
    5 + 2K slices resident: with the window in front it still does."""
    split = dia_krylov.residency("pcg", OFFS_34, 768, 4, F32_H100)
    assert (5 + 68) * 768 * 4 <= F32_H100
    assert split == (87, 4, 1, 34, (768 + 174 + 73 * 768) * 4)
    # and so does every system at 12 offsets on one block's 768 cells
    for name in ("pcg", "bicgstab"):
        for esize, budget in ((4, F32_H100), (8, MAX_SMEM_H100)):
            split = dia_krylov.residency(name, OFFS_12, 768, esize, budget)
            assert split.krylov == dia_krylov._GRID[name][1] - 1 and split.diag
            assert split.pairs == 12 and split.window == 100


@pytest.mark.parametrize("name,L,K,before", [
    ("pcg", 800, 34, 233_600),  # the banded shaft's p_rgh: 1,152 B over the limit
    ("bicgstab", 768, 34, 239_616),  # K1 at 34 offsets on 100k cells
])
def test_residency_keeps_window_and_krylov_first(name, L, K, before):
    """Where the lattice rule streamed every slice (5 + 2K or 10 + 2K of L
    over the limit), the split keeps the window and the Krylov slices, the
    diagonal and all the pairs but a few."""
    assert (dia_krylov._GRID[name][1] + 2 * K) * L * 4 == before > F32_H100
    assert dia_krylov.residency(name, OFFS_34[:K], L, 4, 10**9).bytes > before  # all fits there
    split = dia_krylov.residency(name, OFFS_34[:K], L, 4, F32_H100)
    kry = dia_krylov._GRID[name][1] - 1
    assert split.window == max(OFFS_34) == 87
    assert split.krylov == kry and split.diag == 1
    assert K - 4 <= split.pairs < K  # most of the slices resident
    assert split.bytes <= F32_H100 < split.bytes + 2 * L * 4
    # float64: the window and the Krylov slices still first, fewer pairs
    split64 = dia_krylov.residency(name, OFFS_34, L, 8, MAX_SMEM_H100)
    assert (split64.window, split64.krylov, split64.diag) == (87, kry, 1)
    assert 0 < split64.pairs < split.pairs


def test_residency_leaves_no_window_where_none_fits():
    """W = 0 where no offset's window fits the budget, or every offset is
    over half a block; a forced W that does not fit raises."""
    for name in ("pcg", "bicgstab", "smooth"):
        tight = dia_krylov.residency(name, OFFS_34, 768, 4, (768 + 1) * 4)
        assert tight.window == 0 and tight.krylov == 1 and tight.bytes == 768 * 4
        assert dia_krylov.residency(name, OFFS_34, 768, 4, 0) == dia_krylov.NOTHING
        far = dia_krylov.residency(name, (2000, 2001, 4000, 6000), 768, 4, F32_H100)
        assert far.window == 0 and far.pairs == 4
        # half a block is the reach: 9k cells' 512-cell blocks take 1-256
        assert dia_krylov.residency(name, (1, 2, 256, 257), 512, 4, F32_H100).window == 256
        with pytest.raises(ValueError):
            dia_krylov.residency(name, OFFS_34, 768, 4, 1_000, window=87)


def test_residency_window_argument():
    """`window` sets W for measurements: 0 reads every offset from L2 (and
    gives the freed bytes to the pairs), 4000 serves all of OFFS_12."""
    rule = dia_krylov.residency("bicgstab", OFFS_34, 768, 4, F32_H100)
    none = dia_krylov.residency("bicgstab", OFFS_34, 768, 4, F32_H100, window=0)
    assert none.window == 0 and none.krylov == rule.krylov and none.pairs >= rule.pairs
    wide = dia_krylov.residency("pcg", OFFS_12, 768, 8, MAX_SMEM_H100, window=4000)
    assert wide.window == 4000 and wide.bytes <= MAX_SMEM_H100 and wide.pairs < 12


# K3's split above 3 offsets on the main path's blocks: phase 3's 100k cells
# (768 cells a block for one row, 3,040 for the Yi batch of 4) and the banded
# shaft's 104,280 (800 and 3,168): (W, Krylov slices b and x, diagonal,
# pairs) in float32 and float64
K3_SPLITS = {
    (12, 768): ((100, 2, 1, 12), (100, 2, 1, 12)),
    (12, 800): ((100, 2, 1, 12), (100, 2, 1, 12)),
    (12, 3040): ((100, 2, 1, 7), (100, 2, 1, 2)),
    (12, 3168): ((100, 2, 1, 7), (100, 2, 1, 2)),
    (34, 768): ((87, 2, 1, 34), (87, 2, 1, 16)),  # float32: every slice resident
    (34, 800): ((87, 2, 1, 34), (87, 2, 1, 15)),
    (34, 3040): ((87, 2, 1, 7), (87, 2, 1, 2)),
    (34, 3168): ((87, 2, 1, 7), (87, 2, 1, 2)),
    (62, 768): ((62, 2, 1, 35), (62, 2, 1, 16)),
    (62, 800): ((62, 2, 1, 34), (62, 2, 1, 16)),
    (62, 3040): ((62, 2, 1, 7), (62, 2, 1, 2)),
    (62, 3168): ((62, 2, 1, 7), (62, 2, 1, 2)),
}
K3_OFFSETS = {12: OFFS_12, 34: OFFS_34, 62: OFFS_62}


@pytest.mark.parametrize("esize", [4, 8])
@pytest.mark.parametrize("K,L", sorted(K3_SPLITS))
def test_smooth_residency_splits_above_3_offsets(K, L, esize):
    """K3 above 3 offsets fills a block's bytes as K1 and K2 do: the window
    (the near band: 1-100 of OFFS_12, all of OFFS_34 and OFFS_62), b and x,
    the diagonal, then the pairs that still fit. Where the lattice rule
    kept every slice (34 offsets, float32, 768 cells) the split keeps them
    too; where it streamed every slice the split still keeps the window,
    b, x, d and some pairs. window=0 gives the window's bytes to the pairs;
    a window that does not fit raises."""
    offs = K3_OFFSETS[K]
    budget = F32_H100 if esize == 4 else MAX_SMEM_H100
    split = dia_krylov.residency("smooth", offs, L, esize, budget)
    assert split[:4] == K3_SPLITS[K, L][esize == 8]
    assert split.bytes == _slice_bytes(split, L, esize) <= budget
    assert split.bytes + 2 * L * esize > budget or split.pairs == K
    lattice_rule = (3 + 2 * K) * L * esize <= budget
    assert lattice_rule == ((K, L, esize) in ((12, 768, 4), (12, 768, 8), (12, 800, 4),
                                              (12, 800, 8), (34, 768, 4), (34, 800, 4)))
    if lattice_rule:
        assert split.pairs == K
    none = dia_krylov.residency("smooth", offs, L, esize, budget, window=0)
    assert none.window == 0 and none[1:3] == split[1:3] and none.pairs >= split.pairs
    with pytest.raises(ValueError):
        dia_krylov.residency("smooth", offs, L, esize, budget, window=budget // esize)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["pcg", "bicgstab", "smooth"])
@pytest.mark.parametrize("window", [None, 0, 3])
def test_launch_passes_the_split_above_3_offsets(monkeypatch, name, dtype, window):
    """K1-K3 on 34 offsets over 2 blocks of 512 cells: the entry point gets
    the plan's residency split (`window` as asked), its bytes as the dynamic
    shared memory; resident=False passes none."""
    card = _FakeCard(monkeypatch)
    g = torch.Generator().manual_seed(7)
    nC, K = 1000, 34
    r = lambda *shape: torch.rand(*shape, generator=g, dtype=dtype)
    ops = (4.0 + r(nC), -r(K * nC), -r(K * nC), r(nC), r(nC))
    for resident in (True, False):
        dia_krylov._launch(name, *ops, OFFS_34, 1e-6, 0.0, 50, window=window,
                           resident=resident, extra=(0.8, 4) if name == "smooth" else ())
        fn_name, args = card.calls.pop()
        assert fn_name == f"ffk_{name}_grid_{'f32' if dtype == torch.float32 else 'f64'}"
        assert len(args) == len(dia_krylov.signatures()[fn_name])
        bpr, L, smem = args[-8:-5]
        esize = ops[0].element_size()
        want = (dia_krylov.residency(name, OFFS_34, L, esize, MAX_SMEM_H100, window)
                if resident else dia_krylov.NOTHING)
        assert (bpr, L) == (2, 512)
        assert args[-5:-1] == want[:4] and smem == want.bytes
        if resident:
            assert want.window == (87 if window is None else window) and want.pairs > 0


# ------------------- K1's many-rows kernel above 8 offsets: its windows
# the opt-in limit: the many-rows kernels declare no static shared memory
ROWS_SMEM_H100 = 232_448
ROWS_BATCHES = (5, 16, 64, 128, 1024)


def _rows_smem_bytes(B, dtype):
    """csrc rows_smem_bytes: the row totals [3][B], the item partials
    [1024][3], the rows' scalars [B] (12 values and 2 ints, aligned to the
    value), the two row lists [B] and the scan's 33 ints, each part aligned
    to 16 bytes."""
    e = torch.finfo(dtype).bits // 8
    a16 = lambda b: -(-b // 16) * 16
    state = -(-(12 * e + 8) // e) * e
    return a16(3 * B * e) + a16(1024 * 3 * e) + a16(B * state) + a16(2 * B * 4) + a16(33 * 4)


@pytest.fixture
def rows_bytes(monkeypatch):
    monkeypatch.setattr(dia_krylov, "rows_smem", _rows_smem_bytes)


ROWS_OFFSETS = [OFFS_12, OFFS_34, OFFS_62, tuple(range(1, 65)), (9, 18, 27, 36, 45, 54, 63, 72, 81)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", ROWS_BATCHES)
def test_rows_window_never_exceeds_the_block(rows_bytes, B, dtype):
    """Over budgets from the card's down to less than the rows' own bytes:
    the windows and the rows' bytes fit the budget, W is an offset within
    reach (ROWS_CHUNK) or 0, and no larger offset within reach would fit."""
    e = torch.finfo(dtype).bits // 8
    own = _rows_smem_bytes(B, dtype)
    for offs in ROWS_OFFSETS:
        for budget in (ROWS_SMEM_H100, 200_000, 120_000, own + 40_000, own + 1, own - 1):
            W = dia_krylov.rows_window(offs, B, dtype, budget)
            assert W == 0 or (W in offs and W <= dia_krylov.ROWS_CHUNK)
            assert W == 0 or own + dia_krylov.rows_window_bytes(W, e) <= budget
            assert all(own + dia_krylov.rows_window_bytes(o, e) > budget
                       for o in offs if W < o <= dia_krylov.ROWS_CHUNK), (offs, budget, W)
            assert dia_krylov.rows_window(offs, B, dtype, budget) == W


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_window_serves_the_near_band(rows_bytes, dtype):
    """The banded shaft's 34 offsets lie within 87 cells and the renumbered
    box's 62 within 62: at the fvDOM's batches the windows serve all of
    them. At 1,024 rows in float64 (about 164 KB of rows' bytes) W is
    smaller: OFFS_34's 69 (20 of its 34 offsets), OFFS_62 still 62."""
    for B in (5, 16, 64, 128):
        assert dia_krylov.rows_window(OFFS_34, B, dtype, ROWS_SMEM_H100) == 87
        assert dia_krylov.rows_window(OFFS_62, B, dtype, ROWS_SMEM_H100) == 62
    # W = 87 takes 32 slices of 128 + 174 values
    assert dia_krylov.rows_window_bytes(87, 4) == 38_656
    assert dia_krylov.rows_window_bytes(87, 8) == 77_312
    w34 = dia_krylov.rows_window(OFFS_34, 1024, dtype, ROWS_SMEM_H100)
    w62 = dia_krylov.rows_window(OFFS_62, 1024, dtype, ROWS_SMEM_H100)
    assert (w34, w62) == ((87, 62) if dtype == torch.float32 else (69, 62))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_window_leaves_the_far_band_to_l2(rows_bytes, dtype):
    """OFFS_12: the window serves its near band 1-100 (6 of 12 offsets;
    1-51 at 1,024 rows in float64); the far band 1,950-4,000 is beyond
    reach, read from L2."""
    for B in ROWS_BATCHES:
        W = dia_krylov.rows_window(OFFS_12, B, dtype, ROWS_SMEM_H100)
        assert W == (51 if B == 1024 and dtype == torch.float64 else 100)
        assert W < min(o for o in OFFS_12 if o > 100)
    assert dia_krylov.rows_window((1950, 1999, 2000, 2001, 2050, 4000, 6000, 8000, 9000),
                                  16, dtype, ROWS_SMEM_H100) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_window_is_0_where_none_fits(rows_bytes, dtype):
    """W = 0 where not even the nearest offset's windows fit beside the rows'
    bytes, and at 1-8 offsets (the register kernels take none), whatever the
    `window` argument says there; window=0 forces none; a forced W that
    does not fit, or is beyond reach, raises."""
    e = torch.finfo(dtype).bits // 8
    for B in ROWS_BATCHES:
        own = _rows_smem_bytes(B, dtype)
        tight = own + dia_krylov.rows_window_bytes(1, e) - 1
        assert dia_krylov.rows_window(OFFS_34, B, dtype, tight) == 0
        assert dia_krylov.rows_window(OFFS_34, B, dtype, tight + 1) == 1
        assert dia_krylov.rows_window(OFFS_34, B, dtype, own - 1) == 0
        for offs in ((1, 50, 2000), OFFS_34[:8]):
            assert dia_krylov.rows_window(offs, B, dtype, ROWS_SMEM_H100) == 0
            assert dia_krylov.rows_window(offs, B, dtype, ROWS_SMEM_H100, window=5) == 0
        assert dia_krylov.rows_window(OFFS_34, B, dtype, ROWS_SMEM_H100, window=0) == 0
        assert dia_krylov.rows_window(OFFS_34, B, dtype, ROWS_SMEM_H100, window=40) == 40
        for bad in (-1, dia_krylov.ROWS_CHUNK + 1):
            with pytest.raises(ValueError):
                dia_krylov.rows_window(OFFS_34, B, dtype, ROWS_SMEM_H100, window=bad)
        with pytest.raises(ValueError):
            dia_krylov.rows_window(OFFS_34, B, dtype, tight, window=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("window,expect", [(None, 87), (0, 0), (5, 5)])
def test_launch_passes_the_rows_window(monkeypatch, rows_bytes, dtype, window, expect):
    """K1 on 16 rows at 34 offsets takes the many-rows kernel: its entry
    point gets the rule's W (or the `window` asked for) after the cells per
    block, and the Residency of the plan the bytes of rows and windows."""
    card = _FakeCard(monkeypatch, max_smem=ROWS_SMEM_H100)
    g = torch.Generator().manual_seed(9)
    B, nC, K = 16, 1000, 34
    r = lambda *shape: torch.rand(*shape, generator=g, dtype=dtype)
    ops = (4.0 + r(B, nC), -r(B, K * nC), -r(B, K * nC), r(B, nC), r(B, nC))
    dia_krylov._launch("bicgstab", *ops, OFFS_34, 1e-6, 0.0, 50, window=window)
    (fn_name, args), = card.calls
    assert fn_name == f"ffk_bicgstab_rows_{'f32' if dtype == torch.float32 else 'f64'}"
    assert len(args) == len(dia_krylov.signatures()[fn_name])
    assert args[-2] == expect and isinstance(args[-2], int)
    plan, split = dia_krylov._grid_launch_plan("bicgstab", dtype, B, nC, OFFS_34,
                                               ops[0].element_size(), window=window)
    assert plan.rows and split.window == expect
    assert split.bytes == (_rows_smem_bytes(B, dtype)
                           + dia_krylov.rows_window_bytes(expect, ops[0].element_size()))


def test_rows_constants_match_the_source():
    """The wrapper's constants of the many-rows kernel's windows are those
    of csrc/dia_krylov.cu (its window bytes and its reach are counted on
    both sides)."""
    with open(os.path.join(os.path.dirname(dia_krylov.__file__), "..", "csrc",
                           "dia_krylov.cu")) as f:
        src = f.read()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert const("kThreads") == "1024" and const("kWarps") == "kThreads / 32"
    assert dia_krylov.ROWS_WARPS == 1024 // 32
    assert const("kLaneCells") == "4" and const("kChunk") == "32 * kLaneCells"
    assert dia_krylov.ROWS_CHUNK == 32 * 4
    assert const("kRowsReach") == "kChunk"
    assert const("kRegOffsets") == str(dia_krylov.ROWS_REG_OFFSETS)
    cells = re.search(r"constexpr int kRowsMvCells = sizeof\(T\) == 4 \? (\d+) : (\d+);", src)
    assert {4: int(cells.group(1)), 8: int(cells.group(2))} == dia_krylov.ROWS_MV_CELLS
