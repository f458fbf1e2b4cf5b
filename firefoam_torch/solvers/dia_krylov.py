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

A CUDA tensor goes to the kernel or raises; a CPU tensor runs the plain
twin of solvers/linear.py on the same operands. The kernels are compiled
with nvcc for sm_90a at first use, from the sources in csrc/, into
firefoam_torch/_build/ (named by a hash of every source), and loaded with
ctypes; each launch runs on the current PyTorch stream and adds one to
LAUNCHES[name].
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Sequence

import torch

from ..config import TOL_FLOOR_EPS
from . import linear
from .linear import SolverResult

__all__ = [
    "LAUNCHES",
    "dia_matvec",
    "dia_pcg",
    "dia_bicgstab",
    "dia_smooth",
    "plain",
    "build_seconds",
    "reset_counts",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_SRC = os.path.join(_CSRC, "dia_krylov.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
_MAX_OFFSETS = 8
# scratch vectors per batch row (see the kernels' work layout)
_WORK = {"pcg": 3, "bicgstab": 8, "smooth": 1}

LAUNCHES = {"bicgstab": 0, "pcg": 0, "smooth": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------ K0 twin
def dia_matvec(diag, upper, lower, offsets: Sequence[int], x):
    """M·x on the DIA layout for x [B, nC] (the plain version of the
    kernels' `dia_row`): d·x + (Σ_k u_k·x[c+o_k] + Σ_k l_k[c−o_k]·x[c−o_k]),
    summed in FvMatrix.matvec's order."""
    nC = x.shape[-1]
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
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, _SRC,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    with open(os.path.join(_BUILD_DIR, f"ptxas_{tag}.log"), "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            vp, ll, ci, cd = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
            common = [
                vp, ll, vp, ll, vp, ll,  # diag, upper, lower + batch strides
                vp, vp,  # b, x0
                vp, vp, vp, vp,  # x, res0, res, iters
                vp,  # work
                ctypes.POINTER(ci), ci,  # offsets (host), K
                ci, ci,  # nC, B
                cd, cd, cd, ci,  # tol, rel_tol, floor_eps, max_iter
            ]
            for name in LAUNCHES:
                extra = [cd, ci] if name == "smooth" else []  # omega, check_every
                for suf in ("f32", "f64"):
                    fn = getattr(lib, f"ffk_{name}_{suf}")
                    fn.argtypes = common + extra + [vp]  # ..., stream
                    fn.restype = ci
            _lib = lib
    return _lib


# ---------------------------------------------------------------- launcher
def _launch(name, diag, upper, lower, b, x0, offsets, tol, rel_tol, max_iter, extra=()):
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

    def rows(v):  # [B, nC] operands the kernel indexes with stride nC
        return v if v.ndim == 2 else v.expand(B, nC).contiguous()

    b2, x02 = rows(b), rows(x0)
    x = torch.empty((B, nC), dtype=dtype, device=dev)
    res0 = torch.empty((B,), dtype=dtype, device=dev)
    res = torch.empty((B,), dtype=dtype, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    work = torch.empty((B, _WORK[name], nC), dtype=dtype, device=dev)
    offs = (ctypes.c_int * K)(*[int(o) for o in offsets])
    suf = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(_load(), f"ffk_{name}_{suf}")
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
        raise RuntimeError(f"dia_{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
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
