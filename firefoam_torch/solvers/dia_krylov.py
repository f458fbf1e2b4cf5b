"""Whole-solve Krylov kernels for DIA-layout systems (CUDA, Hopper).

The port of the JAX package's Pallas kernels in
firefoam_tpu/solvers/pallas_cg.py:
  * K0 `_dia_matvec` + the normFactor prologue → `dia_row` device functions
    shared by both kernels (csrc/dia_krylov.cu);
  * K1 `_bicgstab_kernel` → `dia_bicgstab`;
  * K2 `_pcg_kernel`      → `dia_pcg`;
  * K3 `_smooth_kernel`   → `dia_smooth`.

Operands: diag, b, x0 are [nC] or [B, nC]; upper, lower are [K·nC] or
[B, K·nC] in the DIA face-slot layout of ops/geometry.py (slot k·nC + c is
the face from c to c + offsets[k]). Each batch row is one system; a shared
operand ([nC] / [K·nC]) is passed with batch stride 0. (tol, relTol) is one
runtime pair for the whole batch. Every row stops at its own rule (the
semantics of a jax.vmap over linear.py — the Pallas kernel instead keeps
updating every row until the last converges), and `n_iterations` is per
row; callers take the max where they want one count.

These are DIA systems only: a system whose off-diagonals are not K·nC
long (a SEG mesh's, for one) raises before anything is launched or solved.
solvers/linear.py's `solve_ldu` sends SEG systems to the twins instead.

A CUDA tensor goes to the kernel or raises; a CPU tensor runs the plain
twin of solvers/linear.py on the same operands. The kernels are compiled
with nvcc for sm_90a at first use, from the sources in csrc/, into
firefoam_torch/_build/ (named by a hash of every source), and loaded with
ctypes; each launch runs on the current PyTorch stream and adds one to
LAUNCHES[name].

K2 and K3 have two kernels each, K1 three. With G the number of blocks of
the kernel that are co-resident on the card (its occupancy times the SM
count, asked of the library once per kernel, dtype and shared-memory size),
`grid_plan(B, nC, G)` lays a batch of B rows out:
  * K1 with ROWS_MIN <= B <= ROWS_MAX rows: the many-rows kernel
    (`bicgstab_rows_kernel`), a cooperative launch in which every block owns
    one contiguous range of cells of EVERY row and works it for every row
    that still iterates (above ROWS_REG_OFFSETS offsets its matvecs read
    the exchanged vector through a window per warp, `rows_window`);
  * otherwise B <= G: the grid-wide kernel, a cooperative launch in which
    every row gets a group of blocks and every block a contiguous range of
    cells, kept in the block's shared memory when it fits (above 3
    offsets: operand by operand, with a window of the exchanged vector,
    as `residency` splits it);
  * B > G: the one-block-per-row kernel.
The choice follows from B, nC and G alone. DEVICE_LAUNCHES counts the
launches by device kernel ("bicgstab_rows", "bicgstab_grid", "bicgstab",
...); LAUNCHES by wrapper, as before.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple, Sequence

import torch

from ..config import TOL_FLOOR_EPS
from . import linear
from .linear import SolverResult

__all__ = [
    "LAUNCHES",
    "DEVICE_LAUNCHES",
    "dia_matvec",
    "dia_pcg",
    "dia_bicgstab",
    "dia_smooth",
    "grid_plan",
    "GridPlan",
    "residency",
    "Residency",
    "rows_window",
    "grid_sync_seconds",
    "plain",
    "build_seconds",
    "reset_counts",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_SRC = os.path.join(_CSRC, "dia_krylov.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
_MAX_OFFSETS = 64  # kMaxOffsets in csrc: every DIA mesh ops/geometry.py takes (banded: 64)
# scratch vectors per batch row (see the kernels' work layout)
_WORK = {"pcg": 3, "bicgstab": 8, "smooth": 1}

# the grid-wide kernels: index in csrc (ffk_coop_blocks' `which`) and the
# vectors of L cells a block keeps in shared memory besides the 2K
# off-diagonals (d, x and the kernel's Krylov vectors; K3: d, b and x)
_GRID = {"pcg": (0, 5), "bicgstab": (1, 10), "smooth": (2, 3)}
# K1-K3 above this many offsets take the split kernels (residency)
_SPLIT_ABOVE = 3
_SLOTS = 16  # partial sums per block (kSlots in csrc)
# A block (1024 threads) gets at least this many cells where the row has
# them. On an H100 the grid barrier costs the same for 9 or 132 blocks, and
# 512 measured best or tied among 128, 256, 512 and 1024 at 9k and 100k cells.
MIN_CELLS = 512
# K1's many-rows layout (bicgstab_rows_kernel): from ROWS_MIN rows up to its
# row cap (kMaxRows in csrc: one thread a row in its list scan). ROWS_MIN is
# chip_smoke.py phase 3's crossover on an H100 at 100k cells (PERF.md): at 3
# and 4 rows the two layouts part by 4-7 % either way, from 5 rows the
# many-rows kernel leads (by 14 % at 5, 40 % at 16 and 128 and, against the
# one-block-per-row kernel, 55 % at 160). Its cells are cut over the card
# as one row's are, with blocks of at least ROWS_MIN_CELLS cells: every
# block works its cells of every live row, so a block has work even where
# one row alone would give it little.
ROWS_MIN = 5
ROWS_MAX = 1024
ROWS_MIN_CELLS = 32
_ROWS_WHICH = 3  # ffk_coop_blocks' index of the many-rows kernel
# From this many rows the many-rows kernel sums its row totals in two
# stages, one more grid barrier each (csrc kRowsTwoStage; chip_smoke.py
# counts the barriers with it).
ROWS_TWO_STAGE = 64
# Above ROWS_REG_OFFSETS offsets (csrc kRegOffsets) the many-rows kernel's
# matvecs read the exchanged vector through a window per warp: each of its
# ROWS_WARPS warps (kWarps) copies the row's cells [cs − W, cs + ROWS_CHUNK
# + W) around the item's chunk of ROWS_CHUNK cells (kChunk) into its own
# slice of shared memory, for offsets up to W <= ROWS_CHUNK (kRowsReach).
# ROWS_MV_CELLS: the cells of a lane whose stencils run together there, by
# element size (kRowsMvCells).
ROWS_REG_OFFSETS = 8
ROWS_WARPS = 32
ROWS_CHUNK = 128
ROWS_MV_CELLS = {4: 4, 8: 2}

LAUNCHES = {"bicgstab": 0, "pcg": 0, "smooth": 0}
# launches by device kernel: the entry point's name without ffk_ and the dtype
DEVICE_LAUNCHES = {f"{name}{kind}": 0 for name in LAUNCHES for kind in ("", "_grid")}
DEVICE_LAUNCHES["bicgstab_rows"] = 0

_lib = None
_lib_lock = threading.Lock()


def reset_counts():
    for counts in (LAUNCHES, DEVICE_LAUNCHES):
        for k in counts:
            counts[k] = 0


# ------------------------------------------------------------------ K0 twin
def _check_dia(name, upper, lower, offsets, nC):
    """Raise unless upper and lower are DIA off-diagonals: K·nC long with
    K ≥ 1 offsets."""
    K = len(offsets)
    if K < 1 or upper.shape[-1] != K * nC or lower.shape[-1] != K * nC:
        raise ValueError(
            f"dia_{name}: not a DIA system ({K} offsets, nC={nC}, off-diagonals of "
            f"{upper.shape[-1]} and {lower.shape[-1]}; expected K·nC with K ≥ 1)")


def dia_matvec(diag, upper, lower, offsets: Sequence[int], x):
    """M·x on the DIA layout for x [B, nC] (the plain version of the
    kernels' `dia_row`): d·x + (Σ_k u_k·x[c+o_k] + Σ_k l_k[c−o_k]·x[c−o_k]),
    summed in FvMatrix.matvec's order."""
    nC = x.shape[-1]
    _check_dia("matvec", upper, lower, offsets, nC)
    K = len(offsets)
    up = upper.reshape(upper.shape[:-1] + (K, nC))
    lo = lower.reshape(lower.shape[:-1] + (K, nC))
    own = sum(up[..., k, :] * torch.roll(x, -o, dims=-1) for k, o in enumerate(offsets))
    nei = 0
    for k, o in enumerate(offsets):
        lx = lo[..., k, :] * x
        nei = nei + torch.cat([torch.zeros_like(lx[..., :o]), lx[..., :-o]], dim=-1)
    return diag * x + (own + nei)


# ------------------------------------------------------------------- build
def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a CUDA machine only")


def _build() -> str:
    """Compile csrc/dia_krylov.cu for sm_90a (once per content of csrc/:
    every source it compiles or includes) and return the library's path."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(_CSRC)):
        if name.endswith((".cu", ".cuh", ".h")):
            h.update(name.encode())
            with open(os.path.join(_CSRC, name), "rb") as f:
                h.update(f.read())
    tag = h.hexdigest()[:12]
    out = os.path.join(_BUILD_DIR, f"libdia_krylov_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    # -split-compile=0: the optimizer and ptxas work the kernels' template
    # instantiations on every host core at once (the SASS is the same as a
    # serial build's)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-split-compile=0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, _SRC,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    with open(os.path.join(_BUILD_DIR, f"ptxas_{tag}.log"), "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, out)
    return out


def signatures() -> dict:
    """argtypes of every C entry point of csrc/dia_krylov.cu, by name."""
    vp, ll, ci, cd = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
    ip = ctypes.POINTER(ci)
    common = [
        vp, ll, vp, ll, vp, ll,  # diag, upper, lower + batch strides
        vp, vp,  # b, x0
        vp, vp, vp, vp,  # x, res0, res, iters
        vp,  # work
        ip, ci,  # offsets (host), K
        ci, ci,  # nC, B
        cd, cd, cd, ci,  # tol, rel_tol, floor_eps, max_iter
    ]
    sig = {
        "ffk_coop_blocks": [ci, ci, ci, ip, ip],  # which, is_f64, smem; blocks, max smem
        "ffk_sync_bench": [ci, ci, vp],  # blocks, barriers, stream
        "ffk_rows_smem": [ci, ci],  # B, is_f64 -> the many-rows kernel's shared bytes
    }
    for suf in ("f32", "f64"):
        for name in LAUNCHES:
            extra = [cd, ci] if name == "smooth" else []  # omega, check_every
            sig[f"ffk_{name}_{suf}"] = common + extra + [vp]  # ..., stream
            # ..., slots, flags, blocks per row, cells per block, smem bytes,
            # window, Krylov slices, diagonal, pairs resident, stream
            sig[f"ffk_{name}_grid_{suf}"] = common + extra + [vp, vp, ci, ci, ci] + [ci] * 4 + [vp]
        # ..., slots, blocks, cells per block, window, stream
        sig[f"ffk_bicgstab_rows_{suf}"] = common + [vp, ci, ci, ci, vp]
    return sig


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            for name, argtypes in signatures().items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# ------------------------------------------------------------------- plan
class GridPlan(NamedTuple):
    grid_wide: bool  # False: one block per row (B > G), the other fields say so too
    blocks_per_row: int  # the many-rows layout: the launch's blocks, each in every row
    cells_per_block: int
    ranges: tuple  # (first cell, end) of each of a row's blocks, in block order
    rows: bool = False  # K1's many-rows layout (bicgstab_rows_kernel)


def takes_rows(B: int) -> bool:
    """Whether K1 lays B rows out with its many-rows kernel."""
    return ROWS_MIN <= B <= ROWS_MAX


@functools.lru_cache(maxsize=None)
def grid_plan(B: int, nC: int, G: int, min_cells: int = MIN_CELLS,
              many_rows: bool = True) -> GridPlan:
    """How B systems of nC cells are laid over G co-resident blocks: row i
    owns blocks [i·bpr, (i+1)·bpr), and block j of a row the cells
    [j·L, min((j+1)·L, nC)). bpr is at most G // B and at most what gives a
    block `min_cells` cells; L is a multiple of 32 (a warp's loads stay
    aligned) and no block is empty. More rows than blocks: one block per
    row, not grid-wide. `many_rows` (K1, which has the kernel for it) and
    `takes_rows(B)`: the many-rows layout, the blocks and ranges of ONE row
    of at least ROWS_MIN_CELLS cells a block, every block in every row."""
    if B < 1 or nC < 1 or G < 1:
        raise ValueError(f"grid_plan: B={B}, nC={nC}, G={G}")
    if many_rows and takes_rows(B):
        return _rows_plan(nC, G)
    if B > G:
        return GridPlan(False, 1, nC, ((0, nC),))
    bpr = max(1, min(G // B, -(-nC // min_cells)))
    L = -(-(-(-nC // bpr)) // 32) * 32
    bpr = -(-nC // L)
    return GridPlan(True, bpr, L, tuple((j * L, min((j + 1) * L, nC)) for j in range(bpr)))


def _rows_plan(nC: int, G: int) -> GridPlan:
    """The many-rows layout: one row's blocks and ranges, every row."""
    return grid_plan(1, nC, G, ROWS_MIN_CELLS, False)._replace(rows=True)


_coop = {}


def _coop_blocks(name: str, dtype, smem: int):
    """(co-resident blocks of the grid-wide kernel `name` with `smem` bytes
    of dynamic shared memory a block, the most such bytes a block may
    have), asked of the library once per argument."""
    key = (name, dtype, smem)
    if key not in _coop:
        blocks, max_smem = ctypes.c_int(0), ctypes.c_int(0)
        which = _ROWS_WHICH if name == "bicgstab_rows" else _GRID[name][0]
        err = _load().ffk_coop_blocks(which, int(dtype == torch.float64), smem,
                                      ctypes.byref(blocks), ctypes.byref(max_smem))
        if err != 0:
            raise RuntimeError(f"dia_{name}: no cooperative launch on this device "
                               f"(cudaError {err})")
        _coop[key] = (blocks.value, max_smem.value)
    return _coop[key]


@functools.lru_cache(maxsize=None)
def rows_smem(B: int, dtype) -> int:
    """The dynamic shared bytes a block of the many-rows kernel takes for B
    rows (its row scalars, row lists and partial sums; its windows come on
    top, rows_window_bytes), asked of the library."""
    smem = _load().ffk_rows_smem(int(B), int(dtype == torch.float64))
    if smem < 0:
        raise ValueError(f"dia_bicgstab: {B} rows, the many-rows kernel takes 1..{ROWS_MAX}")
    return smem


def rows_window_bytes(W: int, esize: int) -> int:
    """The shared bytes of the many-rows kernel's windows of W cells a side
    (csrc rows_window_bytes): ROWS_WARPS slices of ROWS_CHUNK + 2W values."""
    return ROWS_WARPS * (ROWS_CHUNK + 2 * W) * esize if W > 0 else 0


def rows_window(offsets: Sequence[int], B: int, dtype, max_bytes: int, window=None) -> int:
    """W of the many-rows kernel's windows for B rows on the stencil
    `offsets`, values of `dtype`, with `max_bytes` of dynamic shared memory
    a block: the largest offset o <= ROWS_CHUNK whose windows fit beside the
    rows' own bytes (rows_smem(B)), so the near band, where the offsets are
    dense (the banded shaft's 34 lie within 87 cells, the renumbered box's
    62 within 62), is read from shared memory by every cell of a chunk at
    each of its offsets, while a far band (OFFS_12's 1,950-4,000) would cost
    a halo of thousands of cells a side for a few offsets and stays in L2.
    A window spans the chunk and W on either side: at W = 87 its 32 slices
    take 38,656 B in float32 and 77,312 B in float64, so at many rows in
    float64 (about 164 KB of rows' bytes at 1,024) W is smaller, or 0. 0 at
    1 to ROWS_REG_OFFSETS offsets (the register kernels take no window) and
    where none fits. `window` (measurements and tests): W as given instead,
    0 for none; one that does not fit, or is over ROWS_CHUNK, raises."""
    if len(offsets) <= ROWS_REG_OFFSETS:
        return 0
    esize = torch.finfo(dtype).bits // 8
    left = max_bytes - rows_smem(B, dtype)
    if window is None:
        return max((int(o) for o in offsets
                    if o <= ROWS_CHUNK and rows_window_bytes(int(o), esize) <= left), default=0)
    if window < 0 or window > ROWS_CHUNK or rows_window_bytes(window, esize) > left:
        raise ValueError(f"dia_bicgstab: windows of {window} cells a side take "
                         f"{rows_window_bytes(window, esize)} bytes beside the rows' "
                         f"{rows_smem(B, dtype)}, over the {max_bytes} a block may have (or W "
                         f"over {ROWS_CHUNK})")
    return int(window)


class Residency(NamedTuple):
    """Where a block of a grid-wide kernel keeps its operands. `window`: a
    copy of the exchanged vector's cells [c0 − W, c0 + L + W) serves every
    offset up to W (0: none); the first `krylov` Krylov slices (in the
    kernel's order: K2 x, r, p, Ap; K1 x, r, rhat, p, v, p-hat, s, s-hat, t;
    K3 b, x), the diagonal's slice (`diag`) and the upper and lower slices of
    the first `pairs` offsets live in shared memory, the rest is read from
    global memory (L2); `bytes` is that shared memory a block."""
    window: int
    krylov: int
    diag: int
    pairs: int
    bytes: int


NOTHING = Residency(0, 0, 0, 0, 0)


def residency(name: str, offsets: Sequence[int], L: int, esize: int, max_bytes: int,
              window=None) -> Residency:
    """The residency split of a block of L cells of the grid-wide kernel
    `name` with `max_bytes` of shared memory, values of `esize` bytes.

    At 1-3 offsets (the lattice kernels) all or nothing: every slice
    resident if d, the kernel's vectors and the 2K off-diagonals fit, else
    none. Above 3 offsets K1-K3 fill the bytes in this order: the window,
    the Krylov slices (K3: b, then x), the diagonal, as many
    upper/lower pairs as still fit (one slice a Krylov vector or the
    diagonal, two a pair, L + 2W for the window). W is the largest offset
    whose halo is at most half a block (2·o <= L) and whose window fits:
    the near band, where the offsets are dense (the banded shaft's 34 lie
    within 87 cells, the renumbered box's 62 within 62), read into shared
    memory once a matvec and there by every cell at each of its offsets. A
    far, sparse band (OFFS_12's 1,950-4,000 at 768 cells a block) would
    cost a halo of thousands of cells a side for a few offsets and take the
    bytes of coefficient pairs, so its loads stay in L2. 0 when no window
    fits. `window` (measurements and tests; above 3 offsets): W as given
    instead, 0 for none; a window that does not fit raises."""
    K = len(offsets)
    vectors = _GRID[name][1]  # d and the Krylov slices
    kry = vectors - 1
    if K <= _SPLIT_ABOVE:
        full = (vectors + 2 * K) * L * esize
        return Residency(0, kry, 1, K, full) if full <= max_bytes else NOTHING
    slice_b = L * esize
    if window is None:
        window = max((o for o in offsets if 2 * o <= L and (L + 2 * o) * esize <= max_bytes),
                     default=0)
    win_b = (L + 2 * window) * esize if window else 0
    if window < 0 or win_b > max_bytes:
        raise ValueError(f"dia_{name}: a window of {window} cells a side over {L} cells "
                         f"takes {win_b} bytes, over the {max_bytes} a block may have")
    left = max_bytes - win_b
    krylov = min(kry, left // slice_b)
    left -= krylov * slice_b
    diag = int(krylov == kry and left >= slice_b)
    left -= diag * slice_b
    pairs = min(K, left // (2 * slice_b)) if diag else 0
    return Residency(window, krylov, diag, pairs,
                     win_b + (krylov + diag + 2 * pairs) * slice_b)


def _grid_launch_plan(name, dtype, B, nC, offsets, esize, min_cells=MIN_CELLS, rows=None,
                      window=None):
    """(plan, Residency) for a launch: the grid plan and, for a grid-wide
    plan, where a block's operands live (`residency` on the card's shared
    memory; NOTHING where its bytes would leave the launch not
    co-resident). The many-rows kernel's Residency holds its window's W
    (`rows_window`) and its bytes alone. `rows` (K1 only; for measurements
    and tests): None the rule, True the many-rows kernel at any B up to
    ROWS_MAX, False never it. `window`: see `residency` and `rows_window`."""
    G, max_smem = _coop_blocks(name, dtype, 0)
    if rows and (name != "bicgstab" or not 1 <= B <= ROWS_MAX):
        raise ValueError(f"dia_{name}: no many-rows kernel for {B} rows")
    if rows:
        plan = _rows_plan(nC, G)
    else:
        plan = grid_plan(B, nC, G, min_cells, many_rows=name == "bicgstab" and rows is None)
    if plan.rows:
        W = rows_window(offsets, B, dtype, _coop_blocks("bicgstab_rows", dtype, 0)[1], window)
        smem = rows_smem(B, dtype) + rows_window_bytes(W, esize)
        if _coop_blocks("bicgstab_rows", dtype, smem)[0] < plan.blocks_per_row:
            raise RuntimeError(f"dia_{name}: {plan.blocks_per_row} blocks of the many-rows "
                               f"kernel with {smem} shared bytes are not co-resident")
        return plan, NOTHING._replace(window=W, bytes=smem)
    if not plan.grid_wide:
        return plan, NOTHING
    L = plan.cells_per_block
    split = residency(name, offsets, L, esize, max_smem, window)
    if split.bytes and _coop_blocks(name, dtype, split.bytes)[0] < B * plan.blocks_per_row:
        split = residency(name, offsets, L, esize, 0, window)
    return plan, split


def grid_sync_seconds(blocks: int, n: int = 2000) -> float:
    """The time of one grid barrier over `blocks` blocks of 1024 threads on
    the current CUDA device: a cooperative kernel of n barriers, timed with
    events after a warm-up launch, over n (the launch is a few µs of it)."""
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = _load().ffk_sync_bench(int(blocks), int(n), stream)
        if err != 0:
            raise RuntimeError(f"grid_sync_seconds: launch failed: cudaError {err}")

    launch()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    launch()
    t1.record()
    torch.cuda.synchronize()
    return 1e-3 * t0.elapsed_time(t1) / n


# ---------------------------------------------------------------- launcher
def _launch(name, diag, upper, lower, b, x0, offsets, tol, rel_tol, max_iter, extra=(),
            resident=True, min_cells=MIN_CELLS, grid_wide=True, rows=None, window=None):
    """Check the operands and launch kernel `name` on them. `resident`,
    `min_cells`, `grid_wide`, `rows` and `window` exist for measurements and
    tests (a grid-wide kernel with its slices streamed from L2, with other
    block counts, against the one-block-per-row kernel on the same rows;
    K1's many-rows kernel forced on (True) or off (False); K1-K3 above 3
    offsets, and K1's many-rows kernel above ROWS_REG_OFFSETS, with the
    window's W set, 0: every offset read from L2 through the same unrolled
    stencil)."""
    dtype = x0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dia_{name}: dtype {dtype} not supported")
    dev = x0.device
    K = len(offsets)
    if K < 1 or K > _MAX_OFFSETS:
        raise ValueError(f"dia_{name}: {K} offsets (1..{_MAX_OFFSETS} supported)")
    squeeze = x0.ndim == 1 and b.ndim == 1
    nC = x0.shape[-1]
    B = max(v.shape[0] if v.ndim == 2 else 1 for v in (diag, upper, lower, b, x0))
    for nm, v, width in (("diag", diag, nC), ("upper", upper, K * nC),
                         ("lower", lower, K * nC), ("b", b, nC), ("x0", x0, nC)):
        if v.device != dev or v.dtype != dtype:
            raise TypeError(f"dia_{name}: {nm} is {v.dtype} on {v.device}, "
                            f"expected {dtype} on {dev}")
        if v.ndim not in (1, 2) or v.shape[-1] != width or (v.ndim == 2 and v.shape[0] != B):
            raise ValueError(f"dia_{name}: {nm} has shape {tuple(v.shape)}, "
                             f"expected [{width}] or [{B}, {width}]")
        if not v.is_contiguous():
            raise ValueError(f"dia_{name}: {nm} is not contiguous")
    if any(int(o) <= 0 or int(o) >= nC for o in offsets):
        raise ValueError(f"dia_{name}: offsets {tuple(offsets)} out of range for nC={nC}")

    def full(v):  # [B, nC] operands the kernel indexes with stride nC
        return v if v.ndim == 2 else v.expand(B, nC).contiguous()

    b2, x02 = full(b), full(x0)
    x = torch.empty((B, nC), dtype=dtype, device=dev)
    res0 = torch.empty((B,), dtype=dtype, device=dev)
    res = torch.empty((B,), dtype=dtype, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    work = torch.empty((B, _WORK[name], nC), dtype=dtype, device=dev)
    offs = (ctypes.c_int * K)(*[int(o) for o in offsets])
    suf = "f32" if dtype == torch.float32 else "f64"
    fn_name = f"ffk_{name}_{suf}"
    if grid_wide:
        plan, split = _grid_launch_plan(name, dtype, B, nC, offsets, x0.element_size(),
                                        min_cells, rows, window)
        if plan.rows:
            fn_name = f"ffk_{name}_rows_{suf}"
            nblk = plan.blocks_per_row
            # partials [16, B, nblk] and, behind them, the row totals [16, B]
            slots = torch.empty((_SLOTS * B * (nblk + 1),), dtype=dtype, device=dev)
            extra = (slots.data_ptr(), nblk, plan.cells_per_block, split.window)
        elif plan.grid_wide:
            fn_name = f"ffk_{name}_grid_{suf}"
            slots = torch.empty((_SLOTS, B * plan.blocks_per_row), dtype=dtype, device=dev)
            flags = torch.empty((B,), dtype=torch.int32, device=dev)
            if not resident:
                split = NOTHING
            extra = tuple(extra) + (slots.data_ptr(), flags.data_ptr(), plan.blocks_per_row,
                                    plan.cells_per_block, split.bytes, split.window,
                                    split.krylov, split.diag, split.pairs)
    fn = getattr(_load(), fn_name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        diag.data_ptr(), nC if diag.ndim == 2 else 0,
        upper.data_ptr(), K * nC if upper.ndim == 2 else 0,
        lower.data_ptr(), K * nC if lower.ndim == 2 else 0,
        b2.data_ptr(), x02.data_ptr(),
        x.data_ptr(), res0.data_ptr(), res.data_ptr(), iters.data_ptr(),
        work.data_ptr(), offs, K, nC, B,
        float(tol), float(rel_tol), TOL_FLOOR_EPS * torch.finfo(dtype).eps,
        int(max_iter), *extra, stream,
    )
    if err != 0:
        raise RuntimeError(f"dia_{name} kernel launch ({fn_name}) failed: cudaError {err}")
    LAUNCHES[name] += 1
    DEVICE_LAUNCHES[fn_name[4:-4]] += 1
    if squeeze:
        return SolverResult(x[0], res0[0], res[0], iters[0])
    return SolverResult(x, res0, res, iters)


def plain(fn, diag, upper, lower, b, x0, offsets, tol=1e-6, rel_tol=0.0, max_iter=1000,
          **kw):
    """The plain PyTorch version of a kernel, on any device: the twin `fn`
    (linear.pcg, linear.bicgstab or linear.jacobi_smooth, whose extra
    arguments pass through `kw`) with the DIA matvec."""

    def mv(v):
        return dia_matvec(diag, upper, lower, offsets, v)

    return fn(mv, x0, b, diag, tol=tol, rel_tol=rel_tol, max_iter=max_iter, **kw)


def plain_smooth(diag, upper, lower, b, x0, offsets, tol=1e-6, rel_tol=0.0, max_iter=1000,
                 omega=0.8, check_every=4):
    """K3's plain version: jacobi_smooth counts rounds of `check_every`
    sweeps and reports sweeps; the kernel's `max_iter` counts sweeps and
    starts a round while it < max_iter, i.e. ceil(max_iter/check_every)
    rounds."""
    return plain(linear.jacobi_smooth, diag, upper, lower, b, x0, offsets, tol, rel_tol,
                 -(-int(max_iter) // int(check_every)), n_sweeps=int(check_every),
                 damping=float(omega))


def _on_cpu(name, x0):
    if x0.device.type != "cpu":
        raise NotImplementedError(f"dia_{name}: no kernel for device {x0.device}")


def _dispatch(name, twin, diag, upper, lower, b, x0, offsets, tol, rel_tol, max_iter):
    _check_dia(name, upper, lower, offsets, x0.shape[-1])
    if x0.is_cuda:
        return _launch(name, diag, upper, lower, b, x0, offsets, tol, rel_tol, max_iter)
    _on_cpu(name, x0)
    return plain(twin, diag, upper, lower, b, x0, offsets, tol, rel_tol, max_iter)


def dia_pcg(diag, upper, lower, b, x0, offsets, tol=1e-6, rel_tol=0.0,
            max_iter=1000) -> SolverResult:
    """Whole-solve Jacobi-preconditioned CG (PCG/GAMG role); K2."""
    return _dispatch("pcg", linear.pcg, diag, upper, lower, b, x0, offsets,
                     tol, rel_tol, max_iter)


def dia_bicgstab(diag, upper, lower, b, x0, offsets, tol=1e-6, rel_tol=0.0,
                 max_iter=1000) -> SolverResult:
    """Whole-solve Jacobi-preconditioned BiCGStab (PBiCGStab role); K1."""
    return _dispatch("bicgstab", linear.bicgstab, diag, upper, lower, b, x0, offsets,
                     tol, rel_tol, max_iter)


def dia_smooth(diag, upper, lower, b, x0, offsets, tol=1e-6, rel_tol=0.0,
               max_iter=1000, omega=0.8, check_every=4) -> SolverResult:
    """Whole-solve damped-Jacobi smoother (smoothSolver role); K3.
    `max_iter` and `n_iterations` count sweeps, as in the Pallas kernel."""
    _check_dia("smooth", upper, lower, offsets, x0.shape[-1])
    if x0.is_cuda:
        return _launch("smooth", diag, upper, lower, b, x0, offsets, tol, rel_tol, max_iter,
                       extra=(float(omega), int(check_every)))
    _on_cpu("smooth", x0)
    return plain_smooth(diag, upper, lower, b, x0, offsets, tol, rel_tol, max_iter,
                        omega, check_every)


def build_seconds() -> float:
    """Build (or find) and load the kernels; returns the seconds taken."""
    t0 = time.perf_counter()
    _load()
    return time.perf_counter() - t0
