// Whole-solve Krylov kernels for DIA-layout systems, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of firefoam_tpu/solvers/pallas_cg.py:
//   K0  _dia_matvec (pallas_cg.py:187) and the normFactor prologue
//       (:232-248)                       -> dia_row* / prologue* below
//   K1  _bicgstab_kernel (:281-374)      -> bicgstab_grid_kernel, bicgstab_rows_kernel,
//                                           bicgstab_kernel
//   K2  _pcg_kernel (:201-278)           -> pcg_grid_kernel, pcg_kernel
//   K3  _smooth_kernel (:377-456)        -> smooth_grid_kernel, smooth_kernel
// The Python wrappers and the plain PyTorch twins are in
// firefoam_torch/solvers/dia_krylov.py and solvers/linear.py.
//
// What bounds the three solvers on this card: with a few rows, not bytes. A
// 100k-cell row's working set (a few MB) sits in the 50 MB L2, and a Krylov
// iteration is a chain of dependent steps — a matvec, a dot product over the
// whole row, an update, another dot product — as a Jacobi sweep depends on
// the one before it, so a solve costs (iterations) x (synchronisations per
// iteration) x (the latency of one synchronisation plus one pass). With many
// rows (the fvDOM's ray x band batches) the rows' vectors leave the L2, and
// K1 streams them from HBM: bicgstab_rows_kernel below is laid out for that.
// No kernel here uses the tensor cores: a DIA stencil and its dot products
// have no matrix product in them.
//
// Design of the *_grid_kernel trio (K1, K2, K3): one system spread over the
// whole card. The launch is cooperative (cudaLaunchCooperativeKernel), so
// every block is resident and cooperative_groups' grid.sync() is a barrier
// over all of them. The wrapper's grid_plan gives each batch row a group of
// `bpr` consecutive blocks and each block one contiguous range of `L` cells;
// a thread owns the same cells in every pass, so only the vector whose
// neighbours other blocks read (p in CG; p-hat and s-hat in BiCGStab; x in
// the Jacobi smoother) is exchanged through global memory, read with ld.global.cg (L2, never the
// non-coherent path) after a grid barrier. Everything else a block needs —
// its slice of the diagonal, of the K upper and K lower diagonals (the
// lower one stored shifted, so slot i is the coefficient of x[c-o]), and of
// the Krylov vectors — lives in its dynamic shared memory when the slice
// fits (Params::resident), else it is streamed from L2 through the same
// code (the pointers then aim at global memory); above 3 offsets the three
// split that per operand (below).
//   Reductions: each block sums its cells (block_sum), writes the partial to
// its own slot, and after the grid barrier every block of the row adds the
// row's slots in one fixed order (row_sum). No float atomics: every block
// of a row holds bit-identical alpha, beta, res, rho and omega, so the loop
// tests and K1's retry branch are uniform over the row, and two launches of
// one solve give bit-equal results (the order depends on bpr and L alone).
//   One barrier serves all rows, so every block walks through the same
// barriers each trip of the loop whatever its row does: a row that stopped
// (or retries) does no work with x frozen, and the loop ends for the whole
// grid when no row's flag (written before, read after a barrier) is set.
//
// Above 3 offsets (the hybrid and banded layouts' 4-64) K1, K2 and K3 take
// their split kernels (Wide = true). What bounded the lattice design there:
// dia_row_s loops over a runtime K and each term waits for its loads before
// the next term issues its own, so a block of 768 cells, one a thread, pays
// one L2 round trip per offset and side (68 at 34 offsets) each matvec; and
// residency was all or nothing, so from 34 offsets at 100k cells (10 + 2K or
// 5 + 2K slices over the 227 KB a block may have; K3's 3 + 2K from 62, in
// float64 and for its Yi batch) every slice, the Krylov vectors too, came
// from L2. The split kernels change three things:
//   - the window: after the grid barrier that publishes p (K2), p-hat and
//     s-hat (K1, one buffer for both) or the iterate a Jacobi sweep wrote
//     (K3; and x0 before the first sweep), each block copies the vector's cells
//     [c0 − W, c0 + n + W) into shared memory in one coalesced pass, and the
//     stencil reads every offset up to W from there (the far ones from L2);
//   - residency by operand: the wrapper's split (solvers/dia_krylov.py
//     `residency`) fills shared memory with the window, then the Krylov
//     slices, the diagonal and as many upper/lower pairs as still fit; the
//     rest streams from L2;
//   - the unrolled stencil: the terms run in three runs of offsets whose
//     sources are known at compile time (both in shared memory, one, none),
//     kStencilChunk at a time, all the chunk's loads issued before it adds
//     any; absent neighbours read 0 from the zero-padded slices and window
//     or a predicated-off load, so no term branches. About 6 instructions a
//     term on sm_90a. The sources are fixed per run because choosing them
//     per term inside the chunk compiles to branches and 64-bit address
//     arithmetic, about 35 instructions a term: bound by instruction issue,
//     that was no faster than the loop.
// The sums add in dia_row_s's order, so x, the residuals and the counts are
// bit for bit those of the same kernel without the window (the wrapper's
// window=0). What remains is the iteration's fixed cost (its grid barriers
// and vector passes) and, at B = 3 or in float64, the pairs that do not fit
// and stream from L2.
//
// That layout fixes a row's blocks for the whole solve. With many rows it
// leaves one block (one SM) a row, which cannot stream a 100k-cell row near
// HBM's rate, and leaves the SMs of stopped rows idle while the slowest
// rows finish. K1's batches of many rows therefore go to
// bicgstab_rows_kernel (see there), where every block works its cells of
// every row that still iterates. K2 and K3 have no such batches on the
// port's paths: with more rows than co-resident blocks their
// one-block-per-row kernels (pcg_kernel, smooth_kernel: block barriers
// only) take the launch, as bicgstab_kernel does for K1 beyond the
// many-rows kernel's row cap.
//
// Batch semantics: every row stops at its own rule and reports its own
// iteration count, as a jax.vmap over firefoam_tpu/solvers/linear.py does.
// The Pallas kernel instead keeps updating every row until the last one
// converges (pallas_cg.py:250-252, 334-335); the max over rows is taken by
// the caller after the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxOffsets = 64;  // the banded layout's budget (ops/geometry.py)
// bicgstab_rows_kernel's offsets held in registers: K = 3 (a lattice) or up
// to kRegOffsets; from there to kMaxOffsets its matvecs read the exchanged
// vector through a window per warp and the stencil in unrolled runs
constexpr int kRegOffsets = 8;

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};

template <typename T>
struct Params {
  const T* diag; long long sd;   // batch strides: 0 = shared by every row
  const T* upper; long long su;
  const T* lower; long long sl;
  const T* b;                    // [B, nC]
  const T* x0;                   // [B, nC]
  T* x;                          // [B, nC] out
  T* res0;                       // [B] out
  T* res;                        // [B] out
  int* iters;                    // [B] out
  T* work;                       // [B, nwork, nC] scratch
  int off[kMaxOffsets];
  int K;
  int nC;
  double tol, rel_tol, floor_eps;
  int max_iter;
  double omega;                  // K3 only: Jacobi damping
  int check_every;               // K3 only: sweeps per residual check
  // grid-wide kernels only (the wrapper's grid_plan):
  int bpr;                       // blocks per batch row
  int L;                         // cells per block (the last of a row may own fewer)
  int resident;                  // 1: the block's slices live in dynamic shared memory
  // K1-K3 above 3 offsets (the wrapper's residency split) instead:
  int W;                         // the window serves offsets up to W (0: no window;
                                 // also bicgstab_rows_kernel's above kRegOffsets)
  int nkry;                      // Krylov slices resident, in the order the kernel takes them
  int dres;                      // 1: the diagonal's slice resident
  int npairs;                    // the first npairs offsets' upper and lower slices resident
  T* slots;                      // [kSlots, gridDim.x] per-block partial sums
  int* flags;                    // [B] row still iterating
  // bicgstab_rows_kernel only:
  int rows;                      // B
};

// nz(): guard a denominator against exact zero, keeping its sign
template <typename T>
__device__ __forceinline__ T nz(T v) {
  const T t6 = Lim<T>::tiny() * T(1e6);
  return fabs(v) < t6 ? (v >= T(0) ? t6 : -t6) : v;
}

// Sum N values over the block; every thread gets the totals. `sm` holds
// 32*N values. The leading barrier protects `sm` from the previous call.
template <typename T, int N>
__device__ __forceinline__ void block_sum(T (&v)[N], T* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i)
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_down_sync(0xffffffffu, v[i], o);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) sm[i * 32 + warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T s = lane < nw ? sm[i * 32 + lane] : T(0);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      if (lane == 0) sm[i * 32] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = sm[i * 32];
}

// K0: row c of M·x = d·x + (Σ_k u_k[c]·x[c+o_k] + Σ_k l_k[c−o_k]·x[c−o_k]),
// in FvMatrix.matvec's summation order; absent neighbours contribute 0.
template <typename T>
__device__ __forceinline__ T dia_row(const T* __restrict__ d, const T* __restrict__ up,
                                     const T* __restrict__ lo, const Params<T>& p,
                                     const T* __restrict__ x, int c) {
  T own = T(0), nei = T(0);
  for (int k = 0; k < p.K; ++k) {
    const int o = p.off[k];
    if (c + o < p.nC) own += up[(long long)k * p.nC + c] * x[c + o];
  }
  for (int k = 0; k < p.K; ++k) {
    const int o = p.off[k];
    if (c >= o) nei += lo[(long long)k * p.nC + c - o] * x[c - o];
  }
  return d[c] * x[c] + (own + nei);
}

// row c of M·(xr·1), for the normFactor reference A·x̄
template <typename T>
__device__ __forceinline__ T dia_row_const(const T* __restrict__ d, const T* __restrict__ up,
                                           const T* __restrict__ lo, const Params<T>& p,
                                           T xr, int c) {
  T own = T(0), nei = T(0);
  for (int k = 0; k < p.K; ++k) {
    const int o = p.off[k];
    if (c + o < p.nC) own += up[(long long)k * p.nC + c] * xr;
  }
  for (int k = 0; k < p.K; ++k) {
    const int o = p.off[k];
    if (c >= o) nei += lo[(long long)k * p.nC + c - o] * xr;
  }
  return d[c] * xr + (own + nei);
}

// Prologue shared by K1 and K2: x = x0, r = b − A·x0, the OpenFOAM
// normFactor Σ(|A·x0 − A·x̄| + |b − A·x̄|) + tiny·1e6 and res0 = Σ|r|/norm.
// Returns (norm, res0, Σ r², Σ r·rD·r).
template <typename T>
__device__ void prologue(const Params<T>& p, const T* d, const T* up, const T* lo,
                         const T* b, const T* x0, T* x, T* r, T* sm,
                         T& norm, T& res0, T& rr, T& rzr) {
  const int nC = p.nC;
  T s1[1] = {T(0)};
  for (int c = threadIdx.x; c < nC; c += blockDim.x) {
    x[c] = x0[c];
    s1[0] += x0[c];
  }
  block_sum<T, 1>(s1, sm);
  const T xref = s1[0] / T(nC);
  T s4[4] = {T(0), T(0), T(0), T(0)};
  for (int c = threadIdx.x; c < nC; c += blockDim.x) {
    const T ax = dia_row(d, up, lo, p, x0, c);
    const T ar = dia_row_const(d, up, lo, p, xref, c);
    const T rc = b[c] - ax;
    r[c] = rc;
    s4[0] += fabs(ax - ar) + fabs(b[c] - ar);
    s4[1] += fabs(rc);
    s4[2] += rc * rc;
    s4[3] += rc * ((T(1) / d[c]) * rc);
  }
  block_sum<T, 4>(s4, sm);
  norm = s4[0] + Lim<T>::tiny() * T(1e6);
  res0 = s4[1] / norm;
  rr = s4[2];
  rzr = s4[3];
}

template <typename T>
__device__ __forceinline__ T stop_at(const Params<T>& p, T res0) {
  const T tol = fmax(T(p.tol), T(p.floor_eps));
  return fmax(tol, T(p.rel_tol) * res0);
}

// K2: Jacobi-preconditioned CG (linear.py:pcg semantics; β = 0 at it = 0).
// work: r, p, Ap.
template <typename T>
__global__ void __launch_bounds__(kThreads) pcg_kernel(Params<T> p) {
  __shared__ T sm[32 * 4];
  const int row = blockIdx.x;
  const int nC = p.nC;
  const T* d = p.diag + row * p.sd;
  const T* up = p.upper + row * p.su;
  const T* lo = p.lower + row * p.sl;
  const T* b = p.b + (long long)row * nC;
  const T* x0 = p.x0 + (long long)row * nC;
  T* x = p.x + (long long)row * nC;
  T* w = p.work + (long long)row * 3 * nC;
  T* r = w;
  T* pv = w + nC;
  T* ap = w + 2 * (long long)nC;

  T norm, res0, rr, rz;
  prologue(p, d, up, lo, b, x0, x, r, sm, norm, res0, rr, rz);
  for (int c = threadIdx.x; c < nC; c += blockDim.x) pv[c] = T(0);
  const T stop = stop_at(p, res0);
  T res = res0, rz_old = T(1);
  int it = 0;
  while (res > stop && it < p.max_iter) {
    const T beta = it == 0 ? T(0) : rz / rz_old;
    for (int c = threadIdx.x; c < nC; c += blockDim.x)
      pv[c] = (T(1) / d[c]) * r[c] + beta * pv[c];
    __syncthreads();
    T s1[1] = {T(0)};
    for (int c = threadIdx.x; c < nC; c += blockDim.x) {
      const T a = dia_row(d, up, lo, p, pv, c);
      ap[c] = a;
      s1[0] += pv[c] * a;
    }
    block_sum<T, 1>(s1, sm);
    const T alpha = rz / s1[0];
    T s2[2] = {T(0), T(0)};
    for (int c = threadIdx.x; c < nC; c += blockDim.x) {
      x[c] = x[c] + alpha * pv[c];
      const T rc = r[c] - alpha * ap[c];
      r[c] = rc;
      s2[0] += fabs(rc);
      s2[1] += rc * ((T(1) / d[c]) * rc);
    }
    block_sum<T, 2>(s2, sm);
    res = s2[0] / norm;
    rz_old = rz;
    rz = s2[1];
    ++it;
  }
  if (threadIdx.x == 0) {
    p.res0[row] = res0;
    p.res[row] = res;
    p.iters[row] = it;
  }
}

// K1: Jacobi-preconditioned BiCGStab (linear.py:bicgstab semantics):
// restart with the current residual at it = 0, when |ρ| < tiny·1e3·(r·r),
// and wherever nz() would have to clamp a denominator — ρ_old or ω at the
// start of an iteration, or rhat·v after a step that did not restart (that
// step is dropped and retried as a restart, uncounted). Dividing by the
// clamped value instead overflows α or β to inf and then NaN; one fvDOM ray
// of the 100k-cell box fire reaches rhat·v = 0 exactly. A step whose α, ω,
// t·s or t·t is not finite fails the row: it returns x0 and res0 with the
// steps it took (in float32 a ray of the 500k-cell box fire's first fvDOM
// sweep can grow its residual until t·t overflows; the step would write NaN,
// and the row's last finite iterate is far from any solution).
// work: r, rhat, p, v, phat, s, shat, t.
template <typename T>
__global__ void __launch_bounds__(kThreads) bicgstab_kernel(Params<T> p) {
  __shared__ T sm[32 * 4];
  const int row = blockIdx.x;
  const int nC = p.nC;
  const long long n = nC;
  const T* d = p.diag + row * p.sd;
  const T* up = p.upper + row * p.su;
  const T* lo = p.lower + row * p.sl;
  const T* b = p.b + (long long)row * nC;
  const T* x0 = p.x0 + (long long)row * nC;
  T* x = p.x + (long long)row * nC;
  T* w = p.work + (long long)row * 8 * n;
  T* r = w;
  T* rhat = w + n;
  T* pv = w + 2 * n;
  T* v = w + 3 * n;
  T* phat = w + 4 * n;
  T* s = w + 5 * n;
  T* shat = w + 6 * n;
  T* t = w + 7 * n;

  T norm, res0, rr, unused;
  prologue(p, d, up, lo, b, x0, x, r, sm, norm, res0, rr, unused);
  for (int c = threadIdx.x; c < nC; c += blockDim.x) {
    rhat[c] = r[c];
    pv[c] = T(0);
    v[c] = T(0);
  }
  const T stop = stop_at(p, res0);
  const T small = Lim<T>::tiny() * T(1e3);
  const T t6 = Lim<T>::tiny() * T(1e6);
  T res = res0, rho_old = T(1), alpha = T(1), omega = T(1);
  T rhr = rr;  // Σ rhat·r, fused into the previous residual pass
  int it = 0;
  bool retry = false;
  while (res > stop && it < p.max_iter) {
    T rho = rhr;
    const bool restart = fabs(rho) < small * rr || it == 0 || retry ||
                         fabs(rho_old) < t6 || fabs(omega) < t6;
    if (restart) rho = rr;
    const T beta = restart ? T(0) : (rho / nz(rho_old)) * (alpha / nz(omega));
    for (int c = threadIdx.x; c < nC; c += blockDim.x) {
      if (restart) rhat[c] = r[c];
      const T pc = r[c] + beta * (pv[c] - omega * v[c]);
      pv[c] = pc;
      phat[c] = (T(1) / d[c]) * pc;
    }
    __syncthreads();
    T s1[1] = {T(0)};
    for (int c = threadIdx.x; c < nC; c += blockDim.x) {
      const T vc = dia_row(d, up, lo, p, phat, c);
      v[c] = vc;
      s1[0] += rhat[c] * vc;
    }
    block_sum<T, 1>(s1, sm);
    // s1 is block-uniform, so the whole block takes this branch together
    retry = !restart && fabs(s1[0]) < t6;
    if (retry) continue;
    alpha = rho / nz(s1[0]);
    for (int c = threadIdx.x; c < nC; c += blockDim.x) {
      const T sc = r[c] - alpha * v[c];
      s[c] = sc;
      shat[c] = (T(1) / d[c]) * sc;
    }
    __syncthreads();
    T s2[2] = {T(0), T(0)};
    for (int c = threadIdx.x; c < nC; c += blockDim.x) {
      const T tc = dia_row(d, up, lo, p, shat, c);
      t[c] = tc;
      s2[0] += tc * s[c];
      s2[1] += tc * tc;
    }
    block_sum<T, 2>(s2, sm);
    omega = s2[0] / nz(s2[1]);
    if (!(isfinite(alpha) && isfinite(omega) && isfinite(s2[0]) && isfinite(s2[1]))) {
      for (int c = threadIdx.x; c < nC; c += blockDim.x) x[c] = x0[c];
      res = res0;
      break;
    }
    T s3[3] = {T(0), T(0), T(0)};
    for (int c = threadIdx.x; c < nC; c += blockDim.x) {
      x[c] = x[c] + alpha * phat[c] + omega * shat[c];
      const T rc = s[c] - omega * t[c];
      r[c] = rc;
      s3[0] += fabs(rc);
      s3[1] += rhat[c] * rc;
      s3[2] += rc * rc;
    }
    block_sum<T, 3>(s3, sm);
    res = s3[0] / norm;
    rhr = s3[1];
    rr = s3[2];
    rho_old = rho;
    ++it;
  }
  if (threadIdx.x == 0) {
    p.res0[row] = res0;
    p.res[row] = res;
    p.iters[row] = it;
  }
}

// -------------------------------------------------------- grid-wide K1, K2, K3
constexpr int kSlots = 16;  // partial sums per block: K2 uses 8, K1 11, K3 6

// A block's place in the plan, and its view of its row's read-only operands:
// slot i is cell c0 + i. `l` is indexed k*ls + i - lsh*o (lsh = 0 when the
// shared-memory copy is already shifted by the offset).
template <typename T>
struct Slice {
  int row, first, c0, n;  // batch row, its first block, first cell, cells owned
  const T* d;
  const T* u;
  const T* l;
  long long us, ls;
  int lsh;
  // above 3 offsets (stage_split): u and l hold the resident pairs (stride
  // L, l shifted, both 0 where the neighbour is absent); gu and gl every
  // offset's slices in global memory at the block's first cell (stride nC,
  // gl not shifted); win the window, which serves the leading nwin offsets
  const T* gu;
  const T* gl;
  T* win;
  int nwin;
};

template <typename T>
__device__ __forceinline__ void place(const Params<T>& p, Slice<T>& s) {
  s.row = blockIdx.x / p.bpr;
  s.first = s.row * p.bpr;
  const long long at = (long long)(blockIdx.x - s.first) * p.L;
  s.c0 = at < p.nC ? (int)at : p.nC;
  s.n = min(p.L, p.nC - s.c0);
}

template <typename T>
__device__ __forceinline__ T* stage_operands(const Params<T>& p, T* sh, Slice<T>& s) {
  place(p, s);
  const T* gd = p.diag + s.row * p.sd + s.c0;
  const T* gu = p.upper + s.row * p.su + s.c0;
  const T* gl = p.lower + s.row * p.sl + s.c0;
  if (!p.resident) {
    s.d = gd; s.u = gu; s.l = gl;
    s.us = s.ls = p.nC;
    s.lsh = 1;
    return sh;
  }
  const int L = p.L;
  T* sd = sh;
  T* su = sd + L;
  T* sl = su + (long long)p.K * L;
  for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
    const int c = s.c0 + i;
    sd[i] = gd[i];
    for (int k = 0; k < p.K; ++k) {
      const int o = p.off[k];
      su[k * L + i] = gu[(long long)k * p.nC + i];
      sl[k * L + i] = c >= o ? gl[(long long)k * p.nC + i - o] : T(0);
    }
  }
  s.d = sd; s.u = su; s.l = sl;
  s.us = s.ls = L;
  s.lsh = 0;
  return sl + (long long)p.K * L;
}

// One Krylov vector's slice: shared memory while `left` slices may still be
// resident (all or none at 1-3 offsets, the first p.nkry above),
// else `global` (which already points at the block's first cell).
template <typename T>
__device__ __forceinline__ T* take(const Params<T>& p, T*& sh, int& left, T* global) {
  if (left <= 0) return global;
  --left;
  T* v = sh;
  sh += p.L;
  return v;
}

// K0 on a slice: row c = c0 + i of M·x. `xrow` is the whole row of a vector
// that other blocks write: read through L2 (ld.global.cg), after a grid
// barrier; `xc` is the block's own copy of x[c]. At 1-3 offsets: the loop
// over a runtime K waits for each term's loads before it issues the next
// term's, one L2 round trip per offset and side, which sets the pace from a
// few offsets up; above 3 offsets K1-K3 take dia_row_w instead (the window,
// the resident pairs and the unrolled chunk), which adds the same terms in
// the same order.
template <typename T>
__device__ __forceinline__ T dia_row_s(const Slice<T>& s, const Params<T>& p, const T* xrow,
                                       T xc, int i) {
  const int c = s.c0 + i;
  T own = T(0), nei = T(0);
  for (int k = 0; k < p.K; ++k) {
    const int o = p.off[k];
    if (c + o < p.nC) own += s.u[k * s.us + i] * __ldcg(xrow + c + o);
  }
  for (int k = 0; k < p.K; ++k) {
    const int o = p.off[k];
    if (c >= o) nei += s.l[k * s.ls + i - s.lsh * o] * __ldcg(xrow + c - o);
  }
  return s.d[i] * xc + (own + nei);
}

template <typename T>
__device__ __forceinline__ T dia_row_const_s(const Slice<T>& s, const Params<T>& p, T xr, int i) {
  const int c = s.c0 + i;
  T own = T(0), nei = T(0);
  for (int k = 0; k < p.K; ++k) {
    const int o = p.off[k];
    if (c + o < p.nC) own += s.u[k * s.us + i] * xr;
  }
  for (int k = 0; k < p.K; ++k) {
    const int o = p.off[k];
    if (c >= o) nei += s.l[k * s.ls + i - s.lsh * o] * xr;
  }
  return s.d[i] * xr + (own + nei);
}

// ---------------------------------------------- K1-K3 above 3 offsets
// Offsets a thread takes at once in dia_row_w: it issues the chunk's loads
// (a coefficient and a neighbour each) before it adds any of them.
constexpr int kStencilChunk = 8;

// The block's place and its read-only operands above 3 offsets, laid out as
// the wrapper's split says: the window (L + 2W values when W > 0), the
// diagonal's slice (p.dres), the first p.npairs offsets' upper slices and
// their lower slices (shifted as in stage_operands; both 0 where the
// neighbour is absent); the Krylov slices follow (take). Everything not
// resident is read from global memory.
template <typename T>
__device__ __forceinline__ T* stage_split(const Params<T>& p, T* sh, Slice<T>& s) {
  place(p, s);
  const int L = p.L;
  const T* gd = p.diag + s.row * p.sd + s.c0;
  s.gu = p.upper + s.row * p.su + s.c0;
  s.gl = p.lower + s.row * p.sl + s.c0;
  s.win = sh;
  s.nwin = 0;
  if (p.W > 0) {
    sh += L + 2 * p.W;
    while (s.nwin < p.K && p.off[s.nwin] <= p.W) ++s.nwin;
  }
  T* sd = sh;
  if (p.dres) sh += L;
  T* su = sh;
  T* sl = su + (long long)p.npairs * L;
  for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
    const int c = s.c0 + i;
    if (p.dres) sd[i] = gd[i];
    for (int k = 0; k < p.npairs; ++k) {
      const int o = p.off[k];
      su[k * L + i] = c + o < p.nC ? s.gu[(long long)k * p.nC + i] : T(0);
      sl[k * L + i] = c >= o ? s.gl[(long long)k * p.nC + i - o] : T(0);
    }
  }
  s.d = p.dres ? sd : gd;
  s.u = su;
  s.l = sl;
  return sl + (long long)p.npairs * L;
}

// Copy x[c0 − W, c0 + n + W) of the row `xrow` (0 outside the row) into the
// block's window in one coalesced pass, after the grid barrier that
// published it; the block barrier at the end makes it whole for every
// thread. Every block of a row calls it, or none.
template <typename T>
__device__ __forceinline__ void fill_window(const Slice<T>& s, const Params<T>& p,
                                            const T* xrow) {
  if (p.W == 0) return;
  const int first = s.c0 - p.W, len = s.n + 2 * p.W;
#pragma unroll 4
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const int c = first + j;
    s.win[j] = c >= 0 && c < p.nC ? __ldcg(xrow + c) : T(0);
  }
  __syncthreads();
}

// One term of a run: the coefficient `a` and the neighbour `v` of offset o
// (Up: u_k[c]·x[c+o]; else l_k[c−o]·x[c−o]). `pa` points at the term's
// coefficient (for the lower one in global memory, before the shift by o),
// `xs` at x[c] in the window (Win) or in the row in L2; Const: v = xc. An
// absent neighbour gives a = 0 or v = 0: the resident slices and the window
// hold 0 there, and a load from global memory is predicated off.
template <typename T, bool Res, bool Win, bool Up, bool Const>
__device__ __forceinline__ void stencil_term(T& a, T& v, int o, const T* pa, const T* xs, T xc,
                                             int c, int nC) {
  const bool in = Up ? c + o < nC : c >= o;
  a = T(0);
  v = Const ? xc : T(0);
  if (Res) a = *pa;
  else if (in) a = Up ? *pa : pa[-o];
  if (Const) return;
  if (Win) v = Up ? xs[o] : xs[-o];
  else if (in) v = __ldcg(Up ? xs + o : xs - o);
}

// The terms of offsets [kb, ke) added to `acc` in k order, kStencilChunk at
// a time: a chunk issues all its loads before it adds any of them, the
// run's last chunk too, whose terms past ke add 0. `coef` points at offset
// kb's coefficient of the cell, `cs` is the stride between offsets (L
// resident, nC in global memory). An absent term adds ±0, which leaves acc
// as it is (acc starts at +0 and an exact sum is never −0 when rounding to
// nearest), so the sum is bit for bit dia_row_s's, which skips the term.
template <typename T, bool Res, bool Win, bool Up, bool Const>
__device__ __forceinline__ void stencil_run(T& acc, const Params<T>& p, int kb, int ke,
                                            const T* coef, long long cs, const T* xs, T xc,
                                            int c) {
  constexpr int C = kStencilChunk;
  const T* pa = coef;
  int k = kb;
  auto chunk = [&](int n) {  // the next n <= C terms
    T a[C], v[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      a[j] = T(0);
      v[j] = T(0);
      if (j < n) stencil_term<T, Res, Win, Up, Const>(a[j], v[j], p.off[k + j], pa, xs, xc, c,
                                                      p.nC);
      pa += cs;
    }
#pragma unroll
    for (int j = 0; j < C; ++j) acc += a[j] * v[j];
  };
#pragma unroll 1
  for (; k + C <= ke; k += C) chunk(C);
  if (k < ke) chunk(ke - k);
}

// One side's sum (Up: own, else nei) over k = 0..K−1 as runs in k order.
// Win: the first min(np, nw) offsets with both operands in shared memory,
// then those with one of them there, then the rest from global memory (np:
// the resident pairs, nw: the leading offsets the window serves). Without a
// window (the prologue's x0 and A·x̄), the resident pairs, then the rest.
template <typename T, bool Up, bool Const, bool Win>
__device__ __forceinline__ T stencil_side(const Slice<T>& s, const Params<T>& p, int nw,
                                          const T* xw, const T* xg, T xc, int i, int c) {
  const int np = p.npairs, L = p.L;
  const long long nC = p.nC;
  const T* res = (Up ? s.u : s.l) + i;
  const T* glob = (Up ? s.gu : s.gl) + i;
  T acc = T(0);
  if constexpr (!Win) {
    stencil_run<T, true, false, Up, Const>(acc, p, 0, np, res, L, xg, xc, c);
    stencil_run<T, false, false, Up, Const>(acc, p, np, p.K, glob + np * nC, nC, xg, xc, c);
    return acc;
  }
  const int lo = min(np, nw), hi = max(np, nw);
  stencil_run<T, true, true, Up, Const>(acc, p, 0, lo, res, L, xw, xc, c);
  if (np > nw)
    stencil_run<T, true, false, Up, Const>(acc, p, lo, hi, res + (long long)lo * L, L, xg, xc, c);
  else
    stencil_run<T, false, true, Up, Const>(acc, p, lo, hi, glob + lo * nC, nC, xw, xc, c);
  stencil_run<T, false, false, Up, Const>(acc, p, hi, p.K, glob + hi * nC, nC, xg, xc, c);
  return acc;
}

// dia_row_s above 3 offsets: row c = c0 + i of M·x (Const: of M·(xc·1), the
// normFactor's A·x̄), the same terms added in the same order — own over
// k = 0..K−1, then nei over k, then d·x + (own + nei) — so bit for bit
// dia_row_s's result, whatever the operands' places: a coefficient from
// shared memory for the resident pairs, else from global memory; the
// neighbour x[c ± o] from the window for the leading `nw` offsets (those up
// to W, s.nwin), else from L2 (`xrow`, as dia_row_s). Win = false: no
// window (the prologue); nw = 0 reads every neighbour from L2 too (the
// wrapper's window=0).
template <typename T, bool Const, bool Win>
__device__ __forceinline__ T dia_row_w(const Slice<T>& s, const Params<T>& p, const T* xrow,
                                       int nw, T xc, int i) {
  const int c = s.c0 + i;
  const T* xw = s.win + p.W + i;  // xw[±o] = x[c ± o] for the window's offsets
  const T* xg = xrow + c;
  const T own = stencil_side<T, true, Const, Win>(s, p, nw, xw, xg, xc, i, c);
  const T nei = stencil_side<T, false, Const, Win>(s, p, nw, xw, xg, xc, i, c);
  return s.d[i] * xc + (own + nei);
}

// One matvec row on either path: dia_row_s at 1-3 offsets, dia_row_w above
// (nw: the offsets the window serves for this vector, 0 where none holds it).
template <typename T, bool Wide>
__device__ __forceinline__ T mv_row(const Slice<T>& s, const Params<T>& p, const T* xrow, int nw,
                                    T xc, int i) {
  if constexpr (Wide) return dia_row_w<T, false, true>(s, p, xrow, nw, xc, i);
  else return dia_row_s(s, p, xrow, xc, i);
}

// Sum N values over a batch row's blocks; one grid barrier. Every block —
// also of a row with work == false, which only passes the barrier — must
// call it. The block's partials go to slots [site, site + N) of its own
// column; after the barrier warp 0 adds the row's columns (lane j takes
// columns j, j + 32, ... in order, then a butterfly: an order fixed by bpr
// alone, equal in every block of the row). A site is written once per trip
// of a solver's loop and there is another barrier before its next write.
template <typename T, int N>
__device__ __forceinline__ void row_sum(cg::grid_group& grid, bool work, const Params<T>& p,
                                        const Slice<T>& s, int site, T (&v)[N], T* sm) {
  const int nblk = gridDim.x;
  if (work) {
    block_sum<T, N>(v, sm);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) __stcg(p.slots + (long long)(site + i) * nblk + blockIdx.x, v[i]);
    }
  }
  grid.sync();
  if (!work) return;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T* col = p.slots + (long long)(site + i) * nblk + s.first;
      T t = T(0);
      for (int j = threadIdx.x; j < p.bpr; j += 32) t += __ldcg(col + j);
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (threadIdx.x == 0) sm[i * 32] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = sm[i * 32];
}

// True while any row still iterates; one grid barrier. Every block of a row
// publishes the row's (uniform) `active` before the barrier and reads all
// rows' flags after it, so the answer is the same in every block of the
// grid. The solvers call it once per trip of their loops, with at least one
// more grid barrier before the next call overwrites the flags.
template <typename T>
__device__ __forceinline__ bool any_row_active(cg::grid_group& grid, const Params<T>& p,
                                               const Slice<T>& s, bool active) {
  if (threadIdx.x == 0) __stcg(p.flags + s.row, active ? 1 : 0);
  grid.sync();
  const int B = gridDim.x / p.bpr;
  int any = 0;
  for (int q = threadIdx.x; q < B; q += blockDim.x) any |= __ldcg(p.flags + q);
  return __syncthreads_or(any) != 0;
}

// The prologue of K1, K2 and K3 over a row's blocks (two grid barriers): as
// `prologue`, with x and r the block's slices. x0 is read-only for the
// launch, so its neighbours are read from it directly (Wide: through
// dia_row_w without a window).
template <typename T, bool Wide = false>
__device__ void prologue_grid(cg::grid_group& grid, const Params<T>& p, const Slice<T>& s,
                              T* x, T* r, T* sm, T& norm, T& res0, T& rr, T& rzr) {
  const T* b = p.b + (long long)s.row * p.nC + s.c0;
  const T* x0 = p.x0 + (long long)s.row * p.nC;
  T s1[1] = {T(0)};
  for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
    const T v = x0[s.c0 + i];
    x[i] = v;
    s1[0] += v;
  }
  row_sum<T, 1>(grid, true, p, s, 0, s1, sm);
  const T xref = s1[0] / T(p.nC);
  T s4[4] = {T(0), T(0), T(0), T(0)};
  for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
    T ax, ar;
    if constexpr (Wide) {
      ax = dia_row_w<T, false, false>(s, p, x0, 0, x[i], i);
      ar = dia_row_w<T, true, false>(s, p, x0, 0, xref, i);
    } else {
      ax = dia_row_s(s, p, x0, x[i], i);
      ar = dia_row_const_s(s, p, xref, i);
    }
    const T rc = b[i] - ax;
    r[i] = rc;
    s4[0] += fabs(ax - ar) + fabs(b[i] - ar);
    s4[1] += fabs(rc);
    s4[2] += rc * rc;
    s4[3] += rc * ((T(1) / s.d[i]) * rc);
  }
  row_sum<T, 4>(grid, true, p, s, 1, s4, sm);
  norm = s4[0] + Lim<T>::tiny() * T(1e6);
  res0 = s4[1] / norm;
  rr = s4[2];
  rzr = s4[3];
}

// x's slice back to p.x where it was resident, and the row's results.
template <typename T>
__device__ __forceinline__ void finish_grid(const Params<T>& p, const Slice<T>& s, const T* x,
                                            T res0, T res, int it) {
  T* xg = p.x + (long long)s.row * p.nC + s.c0;
  if (x != xg) {
    for (int i = threadIdx.x; i < s.n; i += blockDim.x) xg[i] = x[i];
  }
  if (blockIdx.x == s.first && threadIdx.x == 0) {
    p.res0[s.row] = res0;
    p.res[s.row] = res;
    p.iters[s.row] = it;
  }
}

extern __shared__ __align__(16) unsigned char ffk_dyn_smem[];

// The Krylov slices each grid-wide kernel takes (in this order): K2 x, r,
// p, Ap; K1 x, r, rhat, p, v, phat, s, shat, t; K3 b, x.
constexpr int kKrylovPcg = 4;
constexpr int kKrylovBicgstab = 9;
constexpr int kKrylovSmooth = 2;  // K3: b, x

// K2 over the grid: the arithmetic of pcg_kernel, three grid barriers per
// iteration (p published; p·Ap; Σ|r| and r·z). work: r, p, Ap as pcg_kernel.
// Wide = false (1-3 offsets): the slices d, K upper, K lower, x, r, p, Ap
// (5 + 2K vectors of L) all resident or all streamed. Wide (above 3): the
// split of stage_split, and p read through the window.
template <typename T, bool Wide>
__global__ void __launch_bounds__(kThreads) pcg_grid_kernel(Params<T> p) {
  __shared__ T sm[32 * 4];
  cg::grid_group grid = cg::this_grid();
  Slice<T> s;
  T* const dyn = reinterpret_cast<T*>(ffk_dyn_smem);
  T* sh = Wide ? stage_split(p, dyn, s) : stage_operands(p, dyn, s);
  int left = Wide ? p.nkry : (p.resident ? kKrylovPcg : 0);
  const long long n = p.nC;
  T* w = p.work + (long long)s.row * 3 * n;
  T* x = take(p, sh, left, p.x + (long long)s.row * n + s.c0);
  T* r = take(p, sh, left, w + s.c0);
  T* pg = w + n;  // the whole row's p, exchanged between blocks
  T* pv = take(p, sh, left, pg + s.c0);
  T* ap = take(p, sh, left, w + 2 * n + s.c0);

  T norm, res0, rr, rz;
  prologue_grid<T, Wide>(grid, p, s, x, r, sm, norm, res0, rr, rz);
  for (int i = threadIdx.x; i < s.n; i += blockDim.x) pv[i] = T(0);
  const T stop = stop_at(p, res0);
  T res = res0, rz_old = T(1);
  int it = 0;
  for (;;) {
    const bool active = res > stop && it < p.max_iter;
    if (active) {
      const T beta = it == 0 ? T(0) : rz / rz_old;
      for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
        const T pc = (T(1) / s.d[i]) * r[i] + beta * pv[i];
        pv[i] = pc;
        pg[s.c0 + i] = pc;
      }
    }
    if (!any_row_active(grid, p, s, active)) break;
    T s1[1] = {T(0)};
    if (active) {
      if constexpr (Wide) fill_window(s, p, pg);
      for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
        const T a = mv_row<T, Wide>(s, p, pg, s.nwin, pv[i], i);
        ap[i] = a;
        s1[0] += pv[i] * a;
      }
    }
    row_sum<T, 1>(grid, active, p, s, 5, s1, sm);
    T s2[2] = {T(0), T(0)};
    if (active) {
      const T alpha = rz / s1[0];
      for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
        x[i] = x[i] + alpha * pv[i];
        const T rc = r[i] - alpha * ap[i];
        r[i] = rc;
        s2[0] += fabs(rc);
        s2[1] += rc * ((T(1) / s.d[i]) * rc);
      }
    }
    row_sum<T, 2>(grid, active, p, s, 6, s2, sm);
    if (active) {
      res = s2[0] / norm;
      rz_old = rz;
      rz = s2[1];
      ++it;
    }
  }
  finish_grid(p, s, x, res0, res, it);
}

// K1 over the grid: the arithmetic and the restart/retry rules of
// bicgstab_kernel, five grid barriers per iteration (p-hat published;
// rhat·v; s-hat published; t·s and t·t; Σ|r|, rhat·r and r·r). A row that
// must retry (rhat·v ≈ 0 after a step that did not restart) drops the step
// as bicgstab_kernel's `continue` does, but walks on through the trip's
// remaining barriers doing nothing; a row whose step is not finite fails as
// bicgstab_kernel's does. work: as bicgstab_kernel.
// Wide = false (1-3 offsets): the slices d, K upper, K lower, x, r, rhat,
// p, v, phat, s, shat, t (10 + 2K vectors of L) all resident or all
// streamed. Wide (above 3): the split of stage_split; p-hat and s-hat are
// read through one window, filled anew for each matvec.
template <typename T, bool Wide>
__global__ void __launch_bounds__(kThreads) bicgstab_grid_kernel(Params<T> p) {
  __shared__ T sm[32 * 4];
  cg::grid_group grid = cg::this_grid();
  Slice<T> s;
  T* const dyn = reinterpret_cast<T*>(ffk_dyn_smem);
  T* sh = Wide ? stage_split(p, dyn, s) : stage_operands(p, dyn, s);
  int left = Wide ? p.nkry : (p.resident ? kKrylovBicgstab : 0);
  const long long n = p.nC;
  T* w = p.work + (long long)s.row * 8 * n;
  T* x = take(p, sh, left, p.x + (long long)s.row * n + s.c0);
  T* r = take(p, sh, left, w + s.c0);
  T* rhat = take(p, sh, left, w + n + s.c0);
  T* pv = take(p, sh, left, w + 2 * n + s.c0);
  T* v = take(p, sh, left, w + 3 * n + s.c0);
  T* phat_g = w + 4 * n;  // whole rows, exchanged between blocks
  T* shat_g = w + 6 * n;
  T* phat = take(p, sh, left, phat_g + s.c0);
  T* sv = take(p, sh, left, w + 5 * n + s.c0);
  T* shat = take(p, sh, left, shat_g + s.c0);
  T* t = take(p, sh, left, w + 7 * n + s.c0);

  T norm, res0, rr, unused;
  prologue_grid<T, Wide>(grid, p, s, x, r, sm, norm, res0, rr, unused);
  for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
    rhat[i] = r[i];
    pv[i] = T(0);
    v[i] = T(0);
  }
  const T stop = stop_at(p, res0);
  const T small = Lim<T>::tiny() * T(1e3);
  const T t6 = Lim<T>::tiny() * T(1e6);
  T res = res0, rho_old = T(1), alpha = T(1), omega = T(1);
  T rhr = rr;  // Σ rhat·r, fused into the previous residual pass
  int it = 0;
  bool retry = false, failed = false;
  for (;;) {
    const bool active = !failed && res > stop && it < p.max_iter;
    T rho = rhr;
    const bool restart = fabs(rho) < small * rr || it == 0 || retry ||
                         fabs(rho_old) < t6 || fabs(omega) < t6;
    if (restart) rho = rr;
    if (active) {
      const T beta = restart ? T(0) : (rho / nz(rho_old)) * (alpha / nz(omega));
      for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
        if (restart) rhat[i] = r[i];
        const T pc = r[i] + beta * (pv[i] - omega * v[i]);
        pv[i] = pc;
        const T ph = (T(1) / s.d[i]) * pc;
        phat[i] = ph;
        phat_g[s.c0 + i] = ph;
      }
    }
    if (!any_row_active(grid, p, s, active)) break;
    T s1[1] = {T(0)};
    if (active) {
      if constexpr (Wide) fill_window(s, p, phat_g);
      for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
        const T vc = mv_row<T, Wide>(s, p, phat_g, s.nwin, phat[i], i);
        v[i] = vc;
        s1[0] += rhat[i] * vc;
      }
    }
    row_sum<T, 1>(grid, active, p, s, 5, s1, sm);
    // s1 is uniform over the row's blocks, so they take this branch together
    retry = active && !restart && fabs(s1[0]) < t6;
    const bool work = active && !retry;
    if (work) {
      alpha = rho / nz(s1[0]);
      for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
        const T sc = r[i] - alpha * v[i];
        sv[i] = sc;
        const T sh_ = (T(1) / s.d[i]) * sc;
        shat[i] = sh_;
        shat_g[s.c0 + i] = sh_;
      }
    }
    grid.sync();
    T s2[2] = {T(0), T(0)};
    if (work) {
      if constexpr (Wide) fill_window(s, p, shat_g);
      for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
        const T tc = mv_row<T, Wide>(s, p, shat_g, s.nwin, shat[i], i);
        t[i] = tc;
        s2[0] += tc * sv[i];
        s2[1] += tc * tc;
      }
    }
    row_sum<T, 2>(grid, work, p, s, 6, s2, sm);
    T s3[3] = {T(0), T(0), T(0)};
    if (work) {
      omega = s2[0] / nz(s2[1]);
      failed = !(isfinite(alpha) && isfinite(omega) && isfinite(s2[0]) && isfinite(s2[1]));
    }
    const bool step = work && !failed;
    if (step) {
      for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
        x[i] = x[i] + alpha * phat[i] + omega * shat[i];
        const T rc = sv[i] - omega * t[i];
        r[i] = rc;
        s3[0] += fabs(rc);
        s3[1] += rhat[i] * rc;
        s3[2] += rc * rc;
      }
    }
    row_sum<T, 3>(grid, step, p, s, 8, s3, sm);
    if (step) {
      res = s3[0] / norm;
      rhr = s3[1];
      rr = s3[2];
      rho_old = rho;
      ++it;
    }
  }
  if (failed) {  // the row returns x0 and res0
    const T* x0 = p.x0 + (long long)s.row * n + s.c0;
    for (int i = threadIdx.x; i < s.n; i += blockDim.x) x[i] = x0[i];
    res = res0;
  }
  finish_grid(p, s, x, res0, res, it);
}

// ------------------------------------------------------- K1 for many rows
// bicgstab_rows_kernel: the arithmetic, the restart/retry rules and the
// per-row stops of bicgstab_grid_kernel, laid out for batches of many rows
// (the fvDOM's ray x band solves: 16, 128, 160 rows of 100k cells).
//
// What bounds it: bytes. A BiCGStab iteration streams 39 vectors of nC
// values a row (phase 3 of chip_smoke.py counts them), and 128 rows of 100k
// cells are 2 GB an iteration, forty times the L2: HBM's rate is the limit,
// and an SM reaches its share of it only with tens of kB of loads in flight.
// Each pass therefore issues all the loads of a batch of cells before it
// uses any (rows_pass); on an H100 that streams the 39 vectors at 68-76 % of
// HBM's rate from 16 rows up (PERF.md). Two other ways to feed HBM were
// built and measured on the same rows, and both lost (PERF.md): staging
// every operand through shared memory with bulk copies (cp.async.bulk into
// up to four stages, an mbarrier each, a producer warp issuing an item's
// 16-byte aligned windows, the x windows spanning c ± the near offsets) was
// 20-28 % slower at 16 to 160 rows of 100k cells and 3.6 times slower at
// 200 rows of 9k, where a block's slices are 96 cells; 16-byte loads of
// four consecutive cells a lane in the light passes were 15-20 % slower
// (a warp's stores of those cells then span four lines). The loads here
// are already whole 128-byte lines a warp, and nothing is reused from
// shared memory.
//
// The layout: one cooperative launch over `nblk` co-resident blocks, the
// lattice's cells cut into nblk contiguous ranges of L (a multiple of 32)
// as the wrapper's grid_plan cuts one row. Block j works its range of
// EVERY row that still iterates, so all SMs stay on the work until the last
// row stops; a stopped row costs its flag and nothing else.
//   Within a block a pass is a list of items (row, chunk): a chunk is
// kChunk consecutive cells of the block's range, a lane takes kLaneCells of
// them 32 apart (a warp's loads are whole 128-byte lines), and the 32 warps
// take the items in turn. So a block has loads of many rows in flight at
// once, whatever the number of live rows, and a warp never waits for a
// block barrier inside a pass.
//   The live-row lists: each block keeps every row's scalars (rho_old,
// alpha, omega, r·r, rhat·r, res, it, the retry and restart bits, the
// normFactor) in its shared memory, computed from the same totals in the
// same order in every block, so the lists of rows that iterate (`act`) and
// that do the whole trip (`wrk`: active and not retrying) are the same in
// every block without a flag exchange, and the loop ends in every block at
// once. A trip has the grid kernel's 5 grid barriers (p-hat published;
// rhat·v; s-hat published; t·s and t·t; Σ|r|, rhat·r and r·r), and a trip
// in which every live row retries (or stops on a step that is not finite)
// ends early.
//   Reductions without float atomics: a warp sums its lanes (butterfly),
// the block adds its chunks of a row in chunk order and writes the partial
// to slots[site][row][block]; after the grid barrier a row's total is its
// nblk partials added in one fixed order (row_total). Below kRowsTwoStage
// rows every block adds every live row's partials itself; from it the
// blocks share the rows out, publish the totals, and read them back after
// one more barrier (phase 3 on an H100: that costs 2-17 % below 64 rows and
// saves 0.3-1.6 % from 64). The orders depend on (B, nC, nblk) alone: two
// launches give bit-equal results, and the two schemes the same bits.
//   Loads: the read-only operands through the non-coherent path, the
// vectors written in the launch through L2 (ld.global.cg), the neighbours
// x[c±o] of p-hat and s-hat too. The passes after a publish (2 and 4) walk
// the rows backwards, so the rows written last, still in L2, are read
// first (0.7-3.4 % from 16 rows on an H100).
//   Above kRegOffsets offsets (9-64: the hybrid and banded layouts) a
// cell's matvec takes 2K coefficients, which stream from HBM, and 2K
// neighbours, which a loop over a runtime K read from L2 a few terms a
// round with a branch each (39 % of the streamed bound at 34 and 62
// offsets, B = 16, on an H100). Its matvec passes (A·x0 and A·x̄ in the
// prologue, v = A·p-hat, t = A·s-hat) change in three ways:
//   - a window per warp: the warp that takes an item copies the row's
//     vector over [cs − W, cs + kChunk + W) (cs: the chunk's first cell)
//     into its own slice of shared memory in one coalesced pass of
//     ld.global.cg, 0 outside the row, and the stencil reads every offset
//     up to W there, the far ones from L2; a warp still never waits for a
//     block barrier in a pass (RowsWindow, warp_window);
//   - the unrolled stencil: the terms run in runs whose source is fixed at
//     compile time (the window, L2), kRowsStencilChunk offsets at a time,
//     every load of a chunk issued before any of its terms is added
//     (rows_run);
//   - kRowsMvCells cells of a lane at once in the matvec passes, where the
//     loop took one.
// The sums add in off_sum's order (own over k, then nei over k, then
// d·x + (own + nei), each product fused or not as the loop compiled; see
// RowsWindow), so x, the residuals and the counts are bit for bit the
// loop's and those of the wrapper's window=0 (the same runs, every
// neighbour from L2). The coefficients are not staged (see above): only x
// is reused, 2K times a cell. W comes from the wrapper's rule
// (solvers/dia_krylov.py `rows_window`): the near band, where the 32
// windows fit beside the rows' own bytes (its times on an H100: PERF.md
// §6).
constexpr int kWarps = kThreads / 32;
constexpr int kLaneCells = 4;
constexpr int kChunk = 32 * kLaneCells;
constexpr int kGroupItems = 1024;  // items whose partials a block holds at once
constexpr int kMaxRows = kThreads;  // one thread a row in the list scan
// from this many rows the row totals are summed in two stages (rows_reduce)
constexpr int kRowsTwoStage = 64;
// the farthest offset a window of the many-rows kernel serves: a window
// spans at most three chunks
constexpr int kRowsReach = kChunk;
// offsets a lane takes at once in rows_run, and the cells of a lane whose
// stencils run together in the matvec passes above kRegOffsets offsets:
// the fastest of the pairs tools/rows_sweep.py timed at B = 16 per row on
// an H100 (PERF.md §6; ptxas caps the kernel at 64 registers)
constexpr int kRowsStencilChunk = 2;
template <typename T>
constexpr int kRowsMvCells = sizeof(T) == 4 ? 4 : 2;
enum : int { kActive = 1, kRestart = 2, kRetry = 4, kWork = 8, kFailed = 16 };

template <typename T>
struct RowState {
  T norm, stop, res0, res, rho_old, alpha, omega, rhr, rr, rho, beta, xref;
  int it, bits;
};

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// dynamic shared memory of bicgstab_rows_kernel for B rows: the row totals
// of the last reduction [3][B], the item partials [kGroupItems][3], the
// rows' scalars [B], the two row lists [B] each and the scan's 33 ints
template <typename T>
__host__ __device__ constexpr size_t rows_smem_bytes(int B) {
  return align16(3 * (size_t)B * sizeof(T)) + align16((size_t)kGroupItems * 3 * sizeof(T)) +
         align16((size_t)B * sizeof(RowState<T>)) + align16(2 * (size_t)B * sizeof(int)) +
         align16(33 * sizeof(int));
}

// and behind them, above kRegOffsets offsets with a window of W cells a
// side, the warps' windows [kWarps][kChunk + 2W]
template <typename T>
__host__ __device__ constexpr size_t rows_window_bytes(int W) {
  return W > 0 ? (size_t)kWarps * (kChunk + 2 * (size_t)W) * sizeof(T) : 0;
}

template <typename T>
struct Rows {
  int B, nblk, c0, n, nch;
  T* tot;
  T* part;
  RowState<T>* st;
  int* act;
  int* wrk;
  int* scan;
  T* win;  // this warp's window (p.W > 0)
};

template <typename T>
__device__ __forceinline__ Rows<T> rows_view(const Params<T>& p, unsigned char* smem) {
  Rows<T> rw;
  rw.B = p.rows;
  rw.nblk = gridDim.x;
  const long long at = (long long)blockIdx.x * p.L;
  rw.c0 = at < p.nC ? (int)at : p.nC;
  rw.n = min(p.L, p.nC - rw.c0);
  rw.nch = (p.L + kChunk - 1) / kChunk;
  unsigned char* m = smem;
  rw.tot = reinterpret_cast<T*>(m);
  m += align16(3 * (size_t)rw.B * sizeof(T));
  rw.part = reinterpret_cast<T*>(m);
  m += align16((size_t)kGroupItems * 3 * sizeof(T));
  rw.st = reinterpret_cast<RowState<T>*>(m);
  m += align16((size_t)rw.B * sizeof(RowState<T>));
  rw.act = reinterpret_cast<int*>(m);
  rw.wrk = rw.act + rw.B;
  m += align16(2 * (size_t)rw.B * sizeof(int));
  rw.scan = reinterpret_cast<int*>(m);
  m += align16(33 * sizeof(int));
  rw.win = reinterpret_cast<T*>(m) + (threadIdx.x >> 5) * (kChunk + 2 * p.W);
  return rw;
}

// The rows whose bits have `bit` set, in row order, into `list`; returns
// their number. Rows and threads one to one (B <= kThreads). Every thread
// has read the count before the closing barrier, so the next call may
// reuse `scan`.
template <typename T>
__device__ __forceinline__ int rows_list(const Rows<T>& rw, int bit, int* list) {
  const int q = threadIdx.x, lane = q & 31, warp = q >> 5;
  const bool f = q < rw.B && (rw.st[q].bits & bit);
  const unsigned m = __ballot_sync(0xffffffffu, f);
  if (lane == 0) rw.scan[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    const int c = rw.scan[lane];
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    __syncwarp();
    rw.scan[lane] = incl - c;
    if (lane == 31) rw.scan[32] = incl;
  }
  __syncthreads();
  if (f) list[rw.scan[warp] + __popc(m & ((1u << lane) - 1u))] = q;
  const int count = rw.scan[32];
  __syncthreads();
  return count;
}

// One pass over the items of the rows in `list` (see above). A lane takes
// its cells CB at a time: `load(row, c, ops)` reads every operand of cell c
// into registers, from addresses that are valid whether or not the cell
// (or its neighbour) exists, then `apply(row, c, ops, acc)` computes and
// stores the cells that exist and adds their N contributions to acc, in
// cell order. Loads first: program order would keep a cell's loads behind
// the stores of the cell before it, and a thread would wait a round trip
// to memory per cell and per dependent load instead of per batch. With
// N > 0 the block's partial of each row goes to slots[site + j][row][block]
// (the chunks added in chunk order); the block's threads then meet at two
// block barriers a group of kGroupItems items. `hooks` (the matvec passes
// above kRegOffsets offsets: RowsWindow): hooks.begin(row, cs), by the
// whole warp, before the lanes take the cells of the item's chunk (cs its
// first cell), and hooks.mid(ops, i) between a lane's loads and its
// applies (i: the first of the CB cells, c0 + i + 32·k the others).
struct NoHooks {
  __device__ __forceinline__ void begin(int, int) {}
  template <typename Ops, int CB>
  __device__ __forceinline__ void mid(Ops (&)[CB], int) {}
};

template <typename T, int N, int CB, typename Ops, typename Load, typename Apply,
          typename Hooks = NoHooks>
__device__ __forceinline__ void rows_pass(const Params<T>& p, const Rows<T>& rw, const int* list,
                                          int nlist, bool reverse, int site, Load load,
                                          Apply apply, Hooks hooks = Hooks()) {
  constexpr int M = N > 0 ? N : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = max(1, kGroupItems / rw.nch);
  for (int g0 = 0; g0 < nlist; g0 += per) {
    const int gn = min(per, nlist - g0);
    for (int item = warp; item < gn * rw.nch; item += kWarps) {
      const int q = g0 + item / rw.nch;
      const int row = list[reverse ? nlist - 1 - q : q];
      const int i0 = (item % rw.nch) * kChunk + lane;
      hooks.begin(row, rw.c0 + i0 - lane);
      T acc[M];
#pragma unroll
      for (int j = 0; j < M; ++j) acc[j] = T(0);
#pragma unroll
      for (int k0 = 0; k0 < kLaneCells; k0 += CB) {
        if (i0 + 32 * k0 >= rw.n) break;
        Ops ops[CB];
#pragma unroll
        for (int k = 0; k < CB; ++k)
          load(row, rw.c0 + min(i0 + 32 * (k0 + k), rw.n - 1), ops[k]);
        hooks.mid(ops, i0 + 32 * k0);
#pragma unroll
        for (int k = 0; k < CB; ++k) {
          const int i = i0 + 32 * (k0 + k);
          if (i < rw.n) apply(row, rw.c0 + i, ops[k], acc);
        }
      }
      if constexpr (N > 0) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          for (int o = 16; o > 0; o >>= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
          if (lane == 0) rw.part[item * N + j] = acc[j];
        }
      }
    }
    if constexpr (N > 0) {
      __syncthreads();
      const long long plane = (long long)rw.B * rw.nblk;
      for (int t = threadIdx.x; t < gn * N; t += kThreads) {
        const int qq = t / N, j = t % N;
        const int q = g0 + qq;
        const int row = list[reverse ? nlist - 1 - q : q];
        T s = T(0);
        for (int ch = 0; ch < rw.nch; ++ch) s += rw.part[(qq * rw.nch + ch) * N + j];
        __stcg(p.slots + (site + j) * plane + (long long)row * rw.nblk + blockIdx.x, s);
      }
      __syncthreads();
    }
  }
}

// A row's total: its nblk partials, lane j taking j, j + 32, ... in order,
// then a butterfly (every lane holds the same bits).
template <typename T>
__device__ __forceinline__ T row_total(const T* col, int nblk) {
  const int lane = threadIdx.x & 31;
  T t = T(0);
  for (int j = lane; j < nblk; j += 32) t += __ldcg(col + j);
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

// The totals of sites [site, site + N) of the rows in `list`, into
// rw.tot[j][row] of every block: one grid barrier, two from kRowsTwoStage
// rows (the totals then pass through slots' tail [kSlots][B]).
template <typename T, int N>
__device__ __forceinline__ void rows_reduce(cg::grid_group& grid, const Params<T>& p,
                                            const Rows<T>& rw, const int* list, int nlist,
                                            int site) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long plane = (long long)rw.B * rw.nblk;
  T* totals = p.slots + kSlots * plane;
  grid.sync();
  const int pairs = nlist * N;
  if (rw.B >= kRowsTwoStage) {
    for (int P = blockIdx.x * kWarps + warp; P < pairs; P += rw.nblk * kWarps) {
      const int row = list[P / N], j = P % N;
      const T t = row_total(p.slots + (site + j) * plane + (long long)row * rw.nblk, rw.nblk);
      if (lane == 0) __stcg(totals + (long long)(site + j) * rw.B + row, t);
    }
    grid.sync();
    for (int P = threadIdx.x; P < pairs; P += kThreads) {
      const int row = list[P / N], j = P % N;
      rw.tot[j * rw.B + row] = __ldcg(totals + (long long)(site + j) * rw.B + row);
    }
  } else {
    for (int P = warp; P < pairs; P += kWarps) {
      const int row = list[P / N], j = P % N;
      const T t = row_total(p.slots + (site + j) * plane + (long long)row * rw.nblk, rw.nblk);
      if (lane == 0) rw.tot[j * rw.B + row] = t;
    }
  }
  __syncthreads();
}

// One cell's operands of K0 (row c of M·x): d, x at c, and for each offset
// the upper coefficient with x[c+o] and the lower one with x[c−o]. KK is K
// (3 on a lattice) or kRegOffsets with offsets k >= K read as offset 0; an
// absent neighbour's pair is read at cell c itself. Both are left out of
// the sums, which add in dia_row's order. KK = kMaxOffsets (9-64 offsets):
// 4·K + 2 operands a cell spill already at K = 16, so the cell keeps d and
// x at c, and RowsWindow::mid leaves its row of M·x (and of M·x̄) in y (ar).
template <typename T, int KK>
struct Cell0 {
  T d, xc, u[KK], xu[KK], l[KK], xl[KK];
};

template <typename T, int KK>
__device__ __forceinline__ void load_cell(const Params<T>& p, const T* d, const T* up,
                                          const T* lo, const T* xrow, int c, Cell0<T, KK>& s) {
  s.d = __ldg(d + c);
  s.xc = __ldcg(xrow + c);
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const int kk = k < p.K ? k : 0;
    const int o = p.off[kk];
    const int cu = c + o < p.nC ? c + o : c;
    const int cl = c >= o ? c - o : c;
    s.u[k] = __ldg(up + (long long)kk * p.nC + c);
    s.xu[k] = __ldcg(xrow + cu);
    s.l[k] = __ldg(lo + (long long)kk * p.nC + cl);
    s.xl[k] = __ldcg(xrow + cl);
  }
}

// Σ u·x[c+o] + Σ l·x[c−o] over the neighbours that exist; `xr`: every
// neighbour's x replaced by xr (the normFactor's A·x̄)
template <typename T, int KK>
__device__ __forceinline__ T off_sum(const Params<T>& p, const Cell0<T, KK>& s, int c,
                                     bool constant, T xr) {
  T own = T(0), nei = T(0);
#pragma unroll
  for (int k = 0; k < KK; ++k)
    if (k < p.K && c + p.off[k] < p.nC) own += s.u[k] * (constant ? xr : s.xu[k]);
#pragma unroll
  for (int k = 0; k < KK; ++k)
    if (k < p.K && c >= p.off[k]) nei += s.l[k] * (constant ? xr : s.xl[k]);
  return own + nei;
}

// Row c of M·x (mv_y) and of M·x̄ (mv_ar, x̄ = xr) from a matvec pass's
// operands: computed here from the registers at 3 and up to kRegOffsets
// offsets; above, the pass's RowsWindow::mid has left them in the cell.
template <typename T, int KK>
__device__ __forceinline__ T mv_y(const Params<T>& p, const Cell0<T, KK>& s, int c) {
  return s.d * s.xc + off_sum(p, s, c, false, T(0));
}

template <typename T, int KK>
__device__ __forceinline__ T mv_ar(const Params<T>& p, const Cell0<T, KK>& s, int c, T xr) {
  return s.d * xr + off_sum(p, s, c, true, xr);
}

template <typename T>
struct Cell0<T, kMaxOffsets> {
  T d, xc, y, ar;
};

template <typename T>
__device__ __forceinline__ void load_cell(const Params<T>& p, const T* d, const T* up,
                                          const T* lo, const T* xrow, int c,
                                          Cell0<T, kMaxOffsets>& s) {
  s.d = __ldg(d + c);
  s.xc = __ldcg(xrow + c);
}

template <typename T>
__device__ __forceinline__ T mv_y(const Params<T>&, const Cell0<T, kMaxOffsets>& s, int) {
  return s.y;
}

template <typename T>
__device__ __forceinline__ T mv_ar(const Params<T>&, const Cell0<T, kMaxOffsets>& s, int, T) {
  return s.ar;
}

// Copy x[cs − W, cs + kChunk + W) of the row `x` (0 outside the row) into
// the warp's window `win` in one coalesced pass of ld.global.cg, every
// load before any store. The leading __syncwarp keeps the copy behind the
// lanes that still read the previous item's window, the closing one makes
// the window whole for every lane.
template <typename T>
__device__ __forceinline__ void warp_window(T* win, const T* x, int cs, int W, int nC) {
  constexpr int U = (kChunk + 2 * kRowsReach) / 32;
  const int lane = threadIdx.x & 31, len = kChunk + 2 * W, first = cs - W;
  T v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = lane + 32 * u, c = first + j;
    v[u] = j < len && c >= 0 && c < nC ? __ldcg(x + c) : T(0);
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (lane + 32 * u < len) win[lane + 32 * u] = v[u];
  __syncwarp();
}

// d·x rounded, then + s: not fused (see RowsWindow::mid)
__device__ __forceinline__ float rounded_product_plus(float d, float x, float s) {
  return __fadd_rn(__fmul_rn(d, x), s);
}
__device__ __forceinline__ double rounded_product_plus(double d, double x, double s) {
  return __dadd_rn(__dmul_rn(d, x), s);
}

// stencil_run's scheme for a lane's CB cells at once, every coefficient
// from global memory: the terms of offsets [kb, ke) of one side (Up:
// u_k[c]·x[c+o], else l_k[c−o]·x[c−o]) for the cells c + 32·q, added to
// acc[q] (Ref: u or l times xr to ref[q] too) in k order,
// kRowsStencilChunk offsets at a time: a chunk issues the loads of all its
// terms of every cell before it adds any, the run's last chunk too, whose
// terms past ke add 0. `coef`
// points at offset kb's coefficient of cell c in global memory (stride nC
// between offsets; the lower one before its shift by o), `xs` at x[c] in
// the window (Win: no load predicated, the window holds 0 outside the row)
// or in the row (L2). A term is there iff o < lim[q] (Up) or o <= lim[q]:
// the cells past the block's range have lim 0 or −1. An absent term adds
// ±0, which leaves acc as it is (see stencil_run), so each sum is bit for
// bit off_sum's, which skips the term.
template <typename T, int CB, bool Up, bool Win, bool Ref>
__device__ __forceinline__ void rows_run(T (&acc)[CB], T (&ref)[CB], const Params<T>& p, int kb,
                                         int ke, const T* coef, const T* xs,
                                         const int (&lim)[CB], T xr) {
  constexpr int C = kRowsStencilChunk;
  const long long nC = p.nC;
#pragma unroll 1
  for (int k = kb; k < ke; k += C, coef += C * nC) {
    T a[C][CB], v[C][CB];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const bool live = k + j < ke;
      const int o = live ? p.off[k + j] : 0;
      const T* pa = coef + j * nC - (Up ? 0 : o);
      const T* px = xs + (Up ? o : -o);
#pragma unroll
      for (int q = 0; q < CB; ++q) {
        const bool in = live && (Up ? o < lim[q] : o <= lim[q]);
        a[j][q] = in ? __ldg(pa + 32 * q) : T(0);
        if constexpr (Win) v[j][q] = live ? px[32 * q] : T(0);
        else v[j][q] = in ? __ldcg(px + 32 * q) : T(0);
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
#pragma unroll
      for (int q = 0; q < CB; ++q) {
        acc[q] += a[j][q] * v[j][q];
        if constexpr (Ref) ref[q] += a[j][q] * xr;
      }
    }
  }
}

// The matvec passes' hooks above kRegOffsets offsets (rows_pass): begin()
// takes the item's row and, with a window (p.W > 0), copies the row's
// vector around the item's chunk into the warp's window; mid() runs the
// stencil of a lane's CB cells — own over k (the leading nw offsets from
// the window, the rest from L2), then nei likewise — and leaves row c of
// M·x, d·x + (own + nei), in each cell's y (Ref, the prologue: row c of
// M·x̄ in ar too, x̄ its row's xref). The stencil's terms are fused
// multiply-adds, as in the loop (off_sum); d·x is fused into the sum in
// the prologue and rounded before it in the v and t passes, as the loop
// kernel compiles on sm_90a (there the product is taken before the
// stencil's loop and added after it), so that x, the residuals and the
// counts stay bit for bit the loop's.
template <typename T, bool Ref>
struct RowsWindow {
  const Params<T>& p;
  const Rows<T>& rw;
  const RowState<T>* st;
  const T* xb;   // the rows' vector: xb + row·xs
  long long xs;
  int nw;        // the leading offsets the window serves (those up to W; 0: none)
  // the item's
  const T* x;
  const T* up;
  const T* lo;
  int cs;
  T xr;

  __device__ __forceinline__ void begin(int row, int first) {
    x = xb + row * xs;
    up = p.upper + row * p.su;
    lo = p.lower + row * p.sl;
    cs = first;
    if constexpr (Ref) xr = st[row].xref;
    if (p.W > 0) warp_window(rw.win, x, cs, p.W, p.nC);
  }

  template <typename Ops, int CB>
  __device__ __forceinline__ void mid(Ops (&o)[CB], int i) {
    const int c = rw.c0 + i;
    int lu[CB], ll[CB];
#pragma unroll
    for (int q = 0; q < CB; ++q) {
      const bool cell = i + 32 * q < rw.n;
      lu[q] = cell ? p.nC - (c + 32 * q) : 0;
      ll[q] = cell ? c + 32 * q : -1;
    }
    const long long nC = p.nC;
    const T* xw = rw.win + p.W + (c - cs);  // xw[32·q ± o] = x[c + 32·q ± o], o <= W
    const T* xg = x + c;
    T own[CB], nei[CB], rown[CB], rnei[CB];
#pragma unroll
    for (int q = 0; q < CB; ++q) own[q] = nei[q] = rown[q] = rnei[q] = T(0);
    rows_run<T, CB, true, true, Ref>(own, rown, p, 0, nw, up + c, xw, lu, xr);
    rows_run<T, CB, true, false, Ref>(own, rown, p, nw, p.K, up + nw * nC + c, xg, lu, xr);
    rows_run<T, CB, false, true, Ref>(nei, rnei, p, 0, nw, lo + c, xw, ll, xr);
    rows_run<T, CB, false, false, Ref>(nei, rnei, p, nw, p.K, lo + nw * nC + c, xg, ll, xr);
#pragma unroll
    for (int q = 0; q < CB; ++q) {
      if constexpr (Ref) {
        o[q].m.y = o[q].m.d * o[q].m.xc + (own[q] + nei[q]);
        o[q].m.ar = o[q].m.d * xr + (rown[q] + rnei[q]);
      } else {
        o[q].m.y = rounded_product_plus(o[q].m.d, o[q].m.xc, own[q] + nei[q]);
      }
    }
  }
};

// The hooks of a matvec pass over the rows' vector xb + row·xs: a window
// and the unrolled stencil above kRegOffsets offsets, none below.
template <typename T, int KK, bool Ref>
__device__ __forceinline__ auto mv_hooks(const Params<T>& p, const Rows<T>& rw,
                                         const RowState<T>* st, const T* xb, long long xs,
                                         int nw) {
  if constexpr (KK == kMaxOffsets) {
    return RowsWindow<T, Ref>{p, rw, st, xb, xs, nw, nullptr, nullptr, nullptr, 0, T(0)};
  } else {
    return NoHooks();
  }
}

// work: as bicgstab_kernel (r, rhat, p, v, phat, s, shat, t); x is written
// in place in p.x. KK: see Cell0; above kRegOffsets offsets the matvec
// passes take their hooks (mv_hooks: the window, the unrolled stencil).
template <typename T, int KK>
__global__ void __launch_bounds__(kThreads) bicgstab_rows_kernel(Params<T> p) {
  constexpr int CB = sizeof(T) == 4 ? 4 : 2;  // cells a lane loads at once in the light passes
  constexpr int MCB = KK == kMaxOffsets ? kRowsMvCells<T> : 1;  // and in the matvec passes
  cg::grid_group grid = cg::this_grid();
  const Rows<T> rw = rows_view(p, ffk_dyn_smem);
  const long long n = p.nC;
  const int B = rw.B;
  RowState<T>* st = rw.st;
  auto D = [&](int row) { return p.diag + row * p.sd; };
  auto U = [&](int row) { return p.upper + row * p.su; };
  auto Lo = [&](int row) { return p.lower + row * p.sl; };
  auto W = [&](int row) { return p.work + (long long)row * 8 * n; };
  struct One { T a; };
  struct Three { T a, b, c; };
  struct Six { T a, b, c, d, e, f; };
  struct Mat { Cell0<T, KK> m; T a; };
  int nw = 0;  // the leading offsets the windows serve
  if (KK == kMaxOffsets && p.W > 0)
    while (nw < p.K && p.off[nw] <= p.W) ++nw;

  // prologue (prologue_grid's arithmetic): x = x0 and Σx0; then r = b − A·x0,
  // the normFactor, Σ|r| and r·r; rhat = r, p = v = 0
  for (int q = threadIdx.x; q < B; q += kThreads) rw.act[q] = q;
  __syncthreads();
  rows_pass<T, 1, CB, One>(
      p, rw, rw.act, B, false, 0,
      [&](int row, int c, One& o) { o.a = __ldg(p.x0 + row * n + c); },
      [&](int row, int c, const One& o, T(&a)[1]) {
        p.x[row * n + c] = o.a;
        a[0] += o.a;
      });
  rows_reduce<T, 1>(grid, p, rw, rw.act, B, 0);
  for (int q = threadIdx.x; q < B; q += kThreads) st[q].xref = rw.tot[q] / T(p.nC);
  __syncthreads();
  rows_pass<T, 3, MCB, Mat>(
      p, rw, rw.act, B, false, 1,
      [&](int row, int c, Mat& o) {
        load_cell(p, D(row), U(row), Lo(row), p.x0 + row * n, c, o.m);
        o.a = __ldg(p.b + row * n + c);
      },
      [&](int row, int c, const Mat& o, T(&a)[3]) {
        const T ax = mv_y(p, o.m, c);
        const T ar = mv_ar(p, o.m, c, st[row].xref);
        const T rc = o.a - ax;
        T* w = W(row);
        w[c] = rc;
        w[n + c] = rc;
        w[2 * n + c] = T(0);
        w[3 * n + c] = T(0);
        a[0] += fabs(ax - ar) + fabs(o.a - ar);
        a[1] += fabs(rc);
        a[2] += rc * rc;
      },
      mv_hooks<T, KK, true>(p, rw, st, p.x0, n, nw));
  rows_reduce<T, 3>(grid, p, rw, rw.act, B, 1);
  for (int q = threadIdx.x; q < B; q += kThreads) {
    RowState<T>& s = st[q];
    s.norm = rw.tot[q] + Lim<T>::tiny() * T(1e6);
    s.res0 = rw.tot[B + q] / s.norm;
    s.rr = rw.tot[2 * B + q];
    s.stop = stop_at(p, s.res0);
    s.res = s.res0;
    s.rho_old = s.alpha = s.omega = T(1);
    s.rhr = s.rr;  // Σ rhat·r, fused into the previous residual pass
    s.it = 0;
    s.bits = 0;
  }
  const T small = Lim<T>::tiny() * T(1e3);
  const T t6 = Lim<T>::tiny() * T(1e6);
  for (;;) {
    for (int q = threadIdx.x; q < B; q += kThreads) {
      RowState<T>& s = st[q];
      const bool active = !(s.bits & kFailed) && s.res > s.stop && s.it < p.max_iter;
      T rho = s.rhr;
      const bool restart = fabs(rho) < small * s.rr || s.it == 0 || (s.bits & kRetry) ||
                           fabs(s.rho_old) < t6 || fabs(s.omega) < t6;
      if (restart) rho = s.rr;
      s.rho = rho;
      if (active) s.beta = restart ? T(0) : (rho / nz(s.rho_old)) * (s.alpha / nz(s.omega));
      s.bits = (active ? kActive : 0) | (restart ? kRestart : 0) | (s.bits & (kRetry | kFailed));
    }
    const int nact = rows_list(rw, kActive, rw.act);
    if (nact == 0) break;
    // p = r + β(p − ωv), p-hat = p/d published (rhat = r on a restart)
    rows_pass<T, 0, CB, Six>(
        p, rw, rw.act, nact, false, 0,
        [&](int row, int c, Six& o) {
          const T* w = W(row);
          o.a = __ldcg(w + c);
          o.b = __ldcg(w + 2 * n + c);
          o.c = __ldcg(w + 3 * n + c);
          o.d = __ldg(D(row) + c);
        },
        [&](int row, int c, const Six& o, T(&)[1]) {
          const RowState<T>& s = st[row];
          T* w = W(row);
          if (s.bits & kRestart) w[n + c] = o.a;
          const T pc = o.a + s.beta * (o.b - s.omega * o.c);
          w[2 * n + c] = pc;
          w[4 * n + c] = (T(1) / o.d) * pc;
        });
    grid.sync();
    // v = A·p-hat, rhat·v
    rows_pass<T, 1, MCB, Mat>(
        p, rw, rw.act, nact, true, 5,
        [&](int row, int c, Mat& o) {
          const T* w = W(row);
          load_cell(p, D(row), U(row), Lo(row), w + 4 * n, c, o.m);
          o.a = __ldcg(w + n + c);
        },
        [&](int row, int c, const Mat& o, T(&a)[1]) {
          const T vc = mv_y(p, o.m, c);
          W(row)[3 * n + c] = vc;
          a[0] += o.a * vc;
        },
        mv_hooks<T, KK, false>(p, rw, st, p.work + 4 * n, 8 * n, nw));
    rows_reduce<T, 1>(grid, p, rw, rw.act, nact, 5);
    for (int q = threadIdx.x; q < B; q += kThreads) {
      RowState<T>& s = st[q];
      bool retry = false, work = false;
      if (s.bits & kActive) {
        const T s1 = rw.tot[q];
        retry = !(s.bits & kRestart) && fabs(s1) < t6;
        work = !retry;
        if (work) s.alpha = s.rho / nz(s1);
      }
      s.bits = (s.bits & (kActive | kRestart | kFailed)) | (retry ? kRetry : 0) |
               (work ? kWork : 0);
    }
    int nwrk = rows_list(rw, kWork, rw.wrk);
    if (nwrk == 0) continue;  // every live row retries: the trip is dropped
    // s = r − αv, s-hat = s/d published
    rows_pass<T, 0, CB, Three>(
        p, rw, rw.wrk, nwrk, false, 0,
        [&](int row, int c, Three& o) {
          const T* w = W(row);
          o.a = __ldcg(w + c);
          o.b = __ldcg(w + 3 * n + c);
          o.c = __ldg(D(row) + c);
        },
        [&](int row, int c, const Three& o, T(&)[1]) {
          T* w = W(row);
          const T sc = o.a - st[row].alpha * o.b;
          w[5 * n + c] = sc;
          w[6 * n + c] = (T(1) / o.c) * sc;
        });
    grid.sync();
    // t = A·s-hat, t·s and t·t
    rows_pass<T, 2, MCB, Mat>(
        p, rw, rw.wrk, nwrk, true, 6,
        [&](int row, int c, Mat& o) {
          const T* w = W(row);
          load_cell(p, D(row), U(row), Lo(row), w + 6 * n, c, o.m);
          o.a = __ldcg(w + 5 * n + c);
        },
        [&](int row, int c, const Mat& o, T(&a)[2]) {
          const T tc = mv_y(p, o.m, c);
          W(row)[7 * n + c] = tc;
          a[0] += tc * o.a;
          a[1] += tc * tc;
        },
        mv_hooks<T, KK, false>(p, rw, st, p.work + 6 * n, 8 * n, nw));
    rows_reduce<T, 2>(grid, p, rw, rw.wrk, nwrk, 6);
    for (int q = threadIdx.x; q < B; q += kThreads) {
      RowState<T>& s = st[q];
      if (s.bits & kWork) {
        const T ts = rw.tot[q], tt = rw.tot[B + q];
        s.omega = ts / nz(tt);
        // a step that is not finite fails the row (it returns x0 and res0)
        if (!(isfinite(s.alpha) && isfinite(s.omega) && isfinite(ts) && isfinite(tt)))
          s.bits = (s.bits & ~kWork) | kFailed;
      }
    }
    nwrk = rows_list(rw, kWork, rw.wrk);
    if (nwrk == 0) continue;
    // x += α p-hat + ω s-hat, r = s − ωt; Σ|r|, rhat·r, r·r
    rows_pass<T, 3, CB, Six>(
        p, rw, rw.wrk, nwrk, false, 8,
        [&](int row, int c, Six& o) {
          const T* w = W(row);
          o.a = __ldcg(p.x + row * n + c);
          o.b = __ldcg(w + 4 * n + c);
          o.c = __ldcg(w + 6 * n + c);
          o.d = __ldcg(w + 5 * n + c);
          o.e = __ldcg(w + 7 * n + c);
          o.f = __ldcg(w + n + c);
        },
        [&](int row, int c, const Six& o, T(&a)[3]) {
          const RowState<T>& s = st[row];
          p.x[row * n + c] = o.a + s.alpha * o.b + s.omega * o.c;
          const T rc = o.d - s.omega * o.e;
          W(row)[c] = rc;
          a[0] += fabs(rc);
          a[1] += o.f * rc;
          a[2] += rc * rc;
        });
    rows_reduce<T, 3>(grid, p, rw, rw.wrk, nwrk, 8);
    for (int q = threadIdx.x; q < B; q += kThreads) {
      RowState<T>& s = st[q];
      if (s.bits & kWork) {
        s.res = rw.tot[q] / s.norm;
        s.rhr = rw.tot[B + q];
        s.rr = rw.tot[2 * B + q];
        s.rho_old = s.rho;
        ++s.it;
      }
    }
  }
  // rows whose step was not finite return x0 and res0
  const int nfail = rows_list(rw, kFailed, rw.act);
  rows_pass<T, 0, CB, One>(
      p, rw, rw.act, nfail, false, 0,
      [&](int row, int c, One& o) { o.a = __ldg(p.x0 + row * n + c); },
      [&](int row, int c, const One& o, T(&)[1]) { p.x[row * n + c] = o.a; });
  if (blockIdx.x == 0) {
    for (int q = threadIdx.x; q < B; q += kThreads) {
      p.res0[q] = st[q].res0;
      p.res[q] = (st[q].bits & kFailed) ? st[q].res0 : st[q].res;
      p.iters[q] = st[q].it;
    }
  }
}

// N grid barriers and nothing else: the yardstick for the kernels above.
__global__ void __launch_bounds__(kThreads) sync_bench_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// K3: damped Jacobi smoother (linear.py:jacobi_smooth semantics), the
// smoothSolver role: rounds of `check_every` sweeps x ← x + ω(b − A·x)/d,
// each round followed by the L1 residual over the normFactor; a row goes on
// while res > stop, it < max_iter and the residual still drops by 1e-4
// relative (or it = 0). `it` counts sweeps, as in the Pallas kernel.
//
// A Jacobi sweep must read only the previous iterate, so the sweeps
// ping-pong between p.x and one scratch vector with a barrier between
// them; updating in place would make it Gauss-Seidel, which is not the
// twin. The scratch also holds r = b − A·x0 for the prologue.
//
// What bounds it: a sweep touches d, b, 6 off-diagonal vectors and x —
// about 10 vectors of nC values — none of which leaves the L2 at 100k
// cells, and each sweep waits for the one before it. With one block per row
// a single SM makes every load of a 100k-cell sweep (about 200 µs a sweep
// on an H100: neither HBM's rate nor the arithmetic, but one SM's loads),
// which is why rows that fit go to smooth_grid_kernel below and this kernel
// keeps the batches with more rows than co-resident blocks.
// work: the second x buffer.
template <typename T>
__global__ void __launch_bounds__(kThreads) smooth_kernel(Params<T> p) {
  __shared__ T sm[32 * 4];
  const int row = blockIdx.x;
  const int nC = p.nC;
  const T* d = p.diag + row * p.sd;
  const T* up = p.upper + row * p.su;
  const T* lo = p.lower + row * p.sl;
  const T* b = p.b + (long long)row * nC;
  const T* x0 = p.x0 + (long long)row * nC;
  T* x = p.x + (long long)row * nC;
  T* xs = p.work + (long long)row * nC;

  T norm, res0, unused1, unused2;
  prologue(p, d, up, lo, b, x0, x, xs, sm, norm, res0, unused1, unused2);
  const T stop = stop_at(p, res0);
  const T omega = T(p.omega);
  T res = res0;
  T res_prev = res0;  // not read before it > 0
  T* cur = x;
  T* nxt = xs;
  int it = 0;
  while (res > stop && it < p.max_iter && (res < res_prev * T(1.0 - 1e-4) || it == 0)) {
    for (int s = 0; s < p.check_every; ++s) {
      for (int c = threadIdx.x; c < nC; c += blockDim.x)
        nxt[c] = cur[c] + (omega / d[c]) * (b[c] - dia_row(d, up, lo, p, cur, c));
      __syncthreads();
      T* t = cur;
      cur = nxt;
      nxt = t;
    }
    T s1[1] = {T(0)};
    for (int c = threadIdx.x; c < nC; c += blockDim.x)
      s1[0] += fabs(b[c] - dia_row(d, up, lo, p, cur, c));
    block_sum<T, 1>(s1, sm);
    res_prev = res;
    res = s1[0] / norm;
    it += p.check_every;
  }
  if (cur != x) {
    for (int c = threadIdx.x; c < nC; c += blockDim.x) x[c] = cur[c];
  }
  if (threadIdx.x == 0) {
    p.res0[row] = res0;
    p.res[row] = res;
    p.iters[row] = it;
  }
}

// K3 over the grid: the arithmetic of smooth_kernel, one grid barrier per
// sweep and one per residual check. The iterate is the one exchanged vector:
// sweep n reads its neighbours from one whole-row buffer in global memory
// (x0 for the first sweep, then p.x and the scratch row in turns) and writes
// the next; the barrier after it is enough, because the buffer a sweep
// overwrites was last read before the previous barrier. The round's first
// barrier also carries the rows' "still iterating" flags (any_row_active),
// so a round of `check_every` sweeps costs check_every + 1 barriers. A
// stopped row keeps its buffers and passes the barriers. Every cell is
// computed with smooth_kernel's expression, so x after n sweeps is bit-equal
// to smooth_kernel's; only the residual sums, which steer the stop, add in
// another order. work: the second x buffer (and r of the prologue).
// Wide = false (1-3 offsets): the slices d, K upper, K lower, b, x (3 + 2K
// vectors of L) all resident or all streamed. Wide (above 3): the split of
// stage_split, then b and x (p.nkry of them, in that order); after the
// barrier that ends a sweep (and once for x0) each block copies the iterate
// the next sweep and the residual check read, `cur`, into its window, and
// the stencil is dia_row_w's, the same terms in the same order: x, the
// residuals and the sweep counts are bit for bit those of window=0, and x
// those of the lattice kernel's loop. At 34 offsets on 100k cells a block's
// 3 + 2K slices fit in float32, yet the loop read every neighbour from L2
// one term after another; the window and the unrolled runs are the change
// there, and the split where the slices do not all fit (62 offsets, float64,
// the Yi batch's blocks of some 3,200 cells).
template <typename T, bool Wide>
__global__ void __launch_bounds__(kThreads) smooth_grid_kernel(Params<T> p) {
  __shared__ T sm[32 * 4];
  cg::grid_group grid = cg::this_grid();
  Slice<T> s;
  T* const dyn = reinterpret_cast<T*>(ffk_dyn_smem);
  T* sh = Wide ? stage_split(p, dyn, s) : stage_operands(p, dyn, s);
  const long long n = p.nC;
  T* xa = p.x + (long long)s.row * n;     // whole rows, exchanged between blocks
  T* xb = p.work + (long long)s.row * n;
  const T* b = p.b + (long long)s.row * n + s.c0;
  int left = Wide ? p.nkry : 2 * p.resident;  // b, then x
  if (left > 0) {  // b is read in every sweep: its slice is staged as the matrix is
    T* bs = sh;
    sh += p.L;
    for (int i = threadIdx.x; i < s.n; i += blockDim.x) bs[i] = b[i];
    b = bs;
    --left;
  }
  T* x = take(p, sh, left, xa + s.c0);  // the block's own cells of the iterate
  const bool xres = x != xa + s.c0;

  T norm, res0, unused1, unused2;
  prologue_grid<T, Wide>(grid, p, s, x, xb + s.c0, sm, norm, res0, unused1, unused2);
  const T stop = stop_at(p, res0);
  const T omega = T(p.omega);
  T res = res0;
  T res_prev = res0;  // not read before it > 0
  const T* cur = p.x0 + (long long)s.row * n;
  T* nxt = xa;
  // the row's value at cell c0 + i of `cur`: the block's slice, its window
  // (Wide, which holds cur after every fill), or L2
  auto own = [&](int i) -> T {
    if (xres) return x[i];
    if (Wide && p.W > 0) return s.win[p.W + i];
    return __ldcg(cur + s.c0 + i);
  };
  auto row = [&](T xc, int i) -> T {
    if constexpr (Wide) return dia_row_w<T, false, true>(s, p, cur, s.nwin, xc, i);
    else return dia_row_s(s, p, cur, xc, i);
  };
  if constexpr (Wide) fill_window(s, p, cur);
  int it = 0;
  for (;;) {
    const bool active = res > stop && it < p.max_iter &&
                        (res < res_prev * T(1.0 - 1e-4) || it == 0);
    bool any = true;
    for (int k = 0; k < p.check_every && any; ++k) {
      if (active) {  // one sweep of the block's cells from `cur` into `nxt` (and the slice)
        for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
          const int c = s.c0 + i;
          const T xc = own(i);
          const T v = xc + (omega / s.d[i]) * (b[i] - row(xc, i));
          if (xres) x[i] = v;
          nxt[c] = v;
        }
        cur = nxt;
        nxt = nxt == xa ? xb : xa;
      }
      // the round's first barrier also carries the rows' flags
      if (k == 0) any = any_row_active(grid, p, s, active);
      else grid.sync();
      if constexpr (Wide) {
        if (active && any) fill_window(s, p, cur);
      }
    }
    if (!any) break;
    T s1[1] = {T(0)};
    if (active) {
      for (int i = threadIdx.x; i < s.n; i += blockDim.x) {
        const T xc = own(i);
        s1[0] += fabs(b[i] - row(xc, i));
      }
    }
    row_sum<T, 1>(grid, active, p, s, 5, s1, sm);
    if (active) {
      res_prev = res;
      res = s1[0] / norm;
      it += p.check_every;
    }
  }
  // streamed: x aims at p.x, which holds x0 (no sweep) or every other iterate
  if (!xres && cur == xb) {
    for (int i = threadIdx.x; i < s.n; i += blockDim.x) x[i] = __ldcg(xb + s.c0 + i);
  }
  finish_grid(p, s, x, res0, res, it);
}

// The cooperative kernels by index: 0 K2, 1 K1, 2 K3, 3-5 K1 for many rows
// (3, up to kRegOffsets and up to kMaxOffsets offsets), 6 K2, 7 K1 and 8 K3
// above 3 offsets.
template <typename T>
const void* grid_kernel(int which) {
  return which == 0   ? (const void*)pcg_grid_kernel<T, false>
         : which == 1 ? (const void*)bicgstab_grid_kernel<T, false>
         : which == 2 ? (const void*)smooth_grid_kernel<T, false>
         : which == 3 ? (const void*)bicgstab_rows_kernel<T, 3>
         : which == 4 ? (const void*)bicgstab_rows_kernel<T, kRegOffsets>
         : which == 5 ? (const void*)bicgstab_rows_kernel<T, kMaxOffsets>
         : which == 6 ? (const void*)pcg_grid_kernel<T, true>
         : which == 7 ? (const void*)bicgstab_grid_kernel<T, true>
                      : (const void*)smooth_grid_kernel<T, true>;
}

template <typename T>
Params<T> make_params(const T* diag, long long sd, const T* upper, long long su,
                      const T* lower, long long sl, const T* b, const T* x0, T* x,
                      T* res0, T* res, int* iters, T* work, const int* offs, int K,
                      int nC, double tol, double rel_tol, double floor_eps,
                      int max_iter) {
  Params<T> p;
  p.diag = diag; p.sd = sd;
  p.upper = upper; p.su = su;
  p.lower = lower; p.sl = sl;
  p.b = b; p.x0 = x0; p.x = x;
  p.res0 = res0; p.res = res; p.iters = iters; p.work = work;
  for (int k = 0; k < kMaxOffsets; ++k) p.off[k] = k < K ? offs[k] : 0;
  p.K = K; p.nC = nC;
  p.tol = tol; p.rel_tol = rel_tol; p.floor_eps = floor_eps;
  p.max_iter = max_iter;
  p.omega = 0.0;
  p.check_every = 0;
  p.bpr = 1; p.L = nC; p.resident = 0;
  p.W = 0; p.nkry = 0; p.dres = 0; p.npairs = 0;
  p.slots = nullptr; p.flags = nullptr;
  p.rows = 0;
  return p;
}

// The cooperative launch of a grid-wide kernel on the wrapper's plan: blocks
// per row, cells per block, the partial-sum slots [16, B*bpr], the row flags
// [B] and the dynamic shared bytes (0: stream the slices from L2). A launch
// that cannot be co-resident is refused with an error.
template <typename T>
int launch_grid(const void* kernel, Params<T> p, int B, T* slots, int* flags, int bpr, int L,
                int smem_bytes, void* stream) {
  if (bpr < 1 || L < 1 || (long long)bpr * L < p.nC || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  p.bpr = bpr; p.L = L; p.resident = smem_bytes > 0;
  p.slots = slots; p.flags = flags;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(B * bpr), dim3(kThreads), args,
                                          (size_t)smem_bytes, (cudaStream_t)stream);
}

// The grid-wide K1, K2 or K3 (which: 1, 0 or 2): at 1-3 offsets its
// lattice kernel, all slices resident when smem_bytes > 0; above 3 offsets
// the split kernel with the wrapper's split (window W, Krylov slices, the
// diagonal, pairs), refused unless it is a split of the kernel's slices
// that fits in smem_bytes.
template <typename T>
int launch_split(int which, int nkry_all, Params<T> p, int B, T* slots, int* flags, int bpr,
                 int L, int smem_bytes, int window, int nkry, int dres, int npairs,
                 void* stream) {
  if (p.K <= 3)
    return launch_grid<T>(grid_kernel<T>(which), p, B, slots, flags, bpr, L, smem_bytes, stream);
  if (window < 0 || nkry < 0 || nkry > nkry_all || dres < 0 || dres > 1 || npairs < 0 ||
      npairs > p.K || L < 1)
    return (int)cudaErrorInvalidValue;
  const long long values = (window > 0 ? (long long)L + 2LL * window : 0LL) +
                           (long long)(nkry + dres + 2 * npairs) * L;
  const long long need = values * (long long)sizeof(T);
  if (need > smem_bytes) return (int)cudaErrorInvalidValue;
  p.W = window; p.nkry = nkry; p.dres = dres; p.npairs = npairs;
  return launch_grid<T>(grid_kernel<T>(which + 6), p, B, slots, flags, bpr, L, smem_bytes,
                        stream);
}

// The cooperative launch of bicgstab_rows_kernel: `nblk` blocks of `L` cells
// (the wrapper's plan) and the partials and totals [kSlots, B, nblk + 1];
// above kRegOffsets offsets windows of `window` cells a side (0: none, every
// neighbour from L2; ignored at 1-kRegOffsets offsets). It sizes its own
// dynamic shared memory (rows_smem_bytes and rows_window_bytes); a launch
// whose bytes a block may not have is refused with an error.
template <typename T>
int launch_rows(Params<T> p, int B, T* slots, int nblk, int L, int window, void* stream) {
  if (B > kMaxRows || nblk < 1 || L < 1 || L > kGroupItems * kChunk ||
      (long long)nblk * L < p.nC || window < 0 || window > kRowsReach)
    return (int)cudaErrorInvalidValue;
  p.rows = B;
  p.bpr = nblk; p.L = L; p.slots = slots;
  p.W = p.K > kRegOffsets ? window : 0;
  const size_t smem = rows_smem_bytes<T>(B) + rows_window_bytes<T>(p.W);
  const void* f = grid_kernel<T>(p.K == 3 ? 3 : p.K <= kRegOffsets ? 4 : 5);
  cudaError_t e =
      cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(f, dim3(nblk), dim3(kThreads), args, smem,
                                          (cudaStream_t)stream);
}

}  // namespace

// C entry points, one per (kernel, dtype), loaded with ctypes. Each launches
// on `stream`, does not synchronise, and returns cudaGetLastError().
#define FFK_ENTRY(NAME, KERNEL, T, SUF)                                              \
  extern "C" int ffk_##NAME##_##SUF(                                                 \
      const T* diag, long long sd, const T* upper, long long su, const T* lower,     \
      long long sl, const T* b, const T* x0, T* x, T* res0, T* res, int* iters,      \
      T* work, const int* offs, int K, int nC, int B, double tol, double rel_tol,    \
      double floor_eps, int max_iter, void* stream) {                                \
    if (K < 1 || K > kMaxOffsets || nC < 1 || B < 1) return (int)cudaErrorInvalidValue; \
    Params<T> p = make_params<T>(diag, sd, upper, su, lower, sl, b, x0, x, res0,     \
                                 res, iters, work, offs, K, nC, tol, rel_tol,        \
                                 floor_eps, max_iter);                               \
    KERNEL<T><<<B, kThreads, 0, (cudaStream_t)stream>>>(p);                          \
    return (int)cudaGetLastError();                                                  \
  }

FFK_ENTRY(pcg, pcg_kernel, float, f32)
FFK_ENTRY(pcg, pcg_kernel, double, f64)
FFK_ENTRY(bicgstab, bicgstab_kernel, float, f32)
FFK_ENTRY(bicgstab, bicgstab_kernel, double, f64)

// The grid-wide K1 and K2: the same operands plus launch_grid's, then the
// split above 3 offsets (window W, Krylov slices, diagonal, pairs resident;
// ignored at 1-3 offsets).
#define FFK_GRID_ENTRY(NAME, WHICH, NKRY, T, SUF)                                    \
  extern "C" int ffk_##NAME##_grid_##SUF(                                            \
      const T* diag, long long sd, const T* upper, long long su, const T* lower,     \
      long long sl, const T* b, const T* x0, T* x, T* res0, T* res, int* iters,      \
      T* work, const int* offs, int K, int nC, int B, double tol, double rel_tol,    \
      double floor_eps, int max_iter, T* slots, int* flags, int bpr, int L,          \
      int smem_bytes, int window, int krylov, int diag_res, int pairs, void* stream) { \
    if (K < 1 || K > kMaxOffsets || nC < 1 || B < 1) return (int)cudaErrorInvalidValue; \
    Params<T> p = make_params<T>(diag, sd, upper, su, lower, sl, b, x0, x, res0,     \
                                 res, iters, work, offs, K, nC, tol, rel_tol,        \
                                 floor_eps, max_iter);                               \
    return launch_split<T>(WHICH, NKRY, p, B, slots, flags, bpr, L, smem_bytes,      \
                           window, krylov, diag_res, pairs, stream);                 \
  }

FFK_GRID_ENTRY(pcg, 0, kKrylovPcg, float, f32)
FFK_GRID_ENTRY(pcg, 0, kKrylovPcg, double, f64)
FFK_GRID_ENTRY(bicgstab, 1, kKrylovBicgstab, float, f32)
FFK_GRID_ENTRY(bicgstab, 1, kKrylovBicgstab, double, f64)

// K1 for many rows: the same operands, then the partial-sum slots, the
// blocks, the cells per block and the window's W above kRegOffsets offsets.
#define FFK_ROWS_ENTRY(T, SUF)                                                        \
  extern "C" int ffk_bicgstab_rows_##SUF(                                             \
      const T* diag, long long sd, const T* upper, long long su, const T* lower,     \
      long long sl, const T* b, const T* x0, T* x, T* res0, T* res, int* iters,      \
      T* work, const int* offs, int K, int nC, int B, double tol, double rel_tol,    \
      double floor_eps, int max_iter, T* slots, int nblk, int L, int window,         \
      void* stream) {                                                                \
    if (K < 1 || K > kMaxOffsets || nC < 1 || B < 1) return (int)cudaErrorInvalidValue; \
    Params<T> p = make_params<T>(diag, sd, upper, su, lower, sl, b, x0, x, res0,     \
                                 res, iters, work, offs, K, nC, tol, rel_tol,        \
                                 floor_eps, max_iter);                               \
    return launch_rows<T>(p, B, slots, nblk, L, window, stream);                     \
  }

FFK_ROWS_ENTRY(float, f32)
FFK_ROWS_ENTRY(double, f64)

// The dynamic shared bytes a block of bicgstab_rows_kernel takes for B rows
// (the rows' own: its windows come on top, rows_window_bytes).
extern "C" int ffk_rows_smem(int B, int is_f64) {
  if (B < 1 || B > kMaxRows) return -1;
  return (int)(is_f64 ? rows_smem_bytes<double>(B) : rows_smem_bytes<float>(B));
}

// How many blocks of a cooperative kernel (which: 0 pcg, 1 bicgstab, 2 smooth,
// 3 bicgstab for many rows; the least over its instantiations: by offsets
// for many rows, 1-3 and above 3 offsets for pcg, bicgstab and smooth) are
// co-resident on the current device with `smem_bytes` of dynamic shared
// memory each (0 when that is more than a block may have), and the most
// dynamic shared memory a block of it may have; the kernels are opted in to
// that much. Fails with cudaErrorNotSupported on a device without
// cooperative launch.
extern "C" int ffk_coop_blocks(int which, int is_f64, int smem_bytes, int* blocks,
                               int* max_smem_bytes) {
  int dev = 0, coop = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop || which < 0 || which > 3) return (int)cudaErrorNotSupported;
  const int kinds[4][3] = {{0, 6, -1}, {1, 7, -1}, {2, 8, -1}, {3, 4, 5}};
  int least_blocks = -1, least_dyn = optin;
  for (int q = 0; q < 3 && kinds[which][q] >= 0; ++q) {
    const int w = kinds[which][q];
    const void* f = is_f64 ? grid_kernel<double>(w) : grid_kernel<float>(w);
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, f);
    if (e != cudaSuccess) return (int)e;
    const int max_dyn = optin - (int)fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, max_dyn);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    if (smem_bytes <= max_dyn) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, kThreads,
                                                        (size_t)smem_bytes);
      if (e != cudaSuccess) return (int)e;
    }
    least_dyn = max_dyn < least_dyn ? max_dyn : least_dyn;
    least_blocks = least_blocks < 0 || per_sm * sms < least_blocks ? per_sm * sms : least_blocks;
  }
  *max_smem_bytes = least_dyn;
  *blocks = least_blocks;
  return 0;
}

// `n` grid barriers over `blocks` blocks of 1024 threads (cooperative).
extern "C" int ffk_sync_bench(int blocks, int n, void* stream) {
  if (blocks < 1 || n < 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&n};
  return (int)cudaLaunchCooperativeKernel((const void*)sync_bench_kernel, dim3(blocks),
                                          dim3(kThreads), args, 0, (cudaStream_t)stream);
}

// K3 takes the same operands plus the damping and the sweeps per check.
#define FFK_SMOOTH_ENTRY(T, SUF)                                                     \
  extern "C" int ffk_smooth_##SUF(                                                   \
      const T* diag, long long sd, const T* upper, long long su, const T* lower,     \
      long long sl, const T* b, const T* x0, T* x, T* res0, T* res, int* iters,      \
      T* work, const int* offs, int K, int nC, int B, double tol, double rel_tol,    \
      double floor_eps, int max_iter, double omega, int check_every, void* stream) { \
    if (K < 1 || K > kMaxOffsets || nC < 1 || B < 1 || check_every < 1)             \
      return (int)cudaErrorInvalidValue;                                             \
    Params<T> p = make_params<T>(diag, sd, upper, su, lower, sl, b, x0, x, res0,     \
                                 res, iters, work, offs, K, nC, tol, rel_tol,        \
                                 floor_eps, max_iter);                               \
    p.omega = omega;                                                                 \
    p.check_every = check_every;                                                     \
    smooth_kernel<T><<<B, kThreads, 0, (cudaStream_t)stream>>>(p);                   \
    return (int)cudaGetLastError();                                                  \
  }

FFK_SMOOTH_ENTRY(float, f32)
FFK_SMOOTH_ENTRY(double, f64)

// The grid-wide K3: K3's operands, then launch_grid's and the split above 3
// offsets (as the grid-wide K1 and K2).
#define FFK_SMOOTH_GRID_ENTRY(T, SUF)                                                \
  extern "C" int ffk_smooth_grid_##SUF(                                              \
      const T* diag, long long sd, const T* upper, long long su, const T* lower,     \
      long long sl, const T* b, const T* x0, T* x, T* res0, T* res, int* iters,      \
      T* work, const int* offs, int K, int nC, int B, double tol, double rel_tol,    \
      double floor_eps, int max_iter, double omega, int check_every, T* slots,       \
      int* flags, int bpr, int L, int smem_bytes, int window, int krylov,            \
      int diag_res, int pairs, void* stream) {                                       \
    if (K < 1 || K > kMaxOffsets || nC < 1 || B < 1 || check_every < 1)             \
      return (int)cudaErrorInvalidValue;                                             \
    Params<T> p = make_params<T>(diag, sd, upper, su, lower, sl, b, x0, x, res0,     \
                                 res, iters, work, offs, K, nC, tol, rel_tol,        \
                                 floor_eps, max_iter);                               \
    p.omega = omega;                                                                 \
    p.check_every = check_every;                                                     \
    return launch_split<T>(2, kKrylovSmooth, p, B, slots, flags, bpr, L, smem_bytes, \
                           window, krylov, diag_res, pairs, stream);                 \
  }

FFK_SMOOTH_GRID_ENTRY(float, f32)
FFK_SMOOTH_GRID_ENTRY(double, f64)
