// Whole-solve Krylov kernels for DIA-layout systems, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of firefoam_tpu/solvers/pallas_cg.py:
//   K0  _dia_matvec (pallas_cg.py:187) and the normFactor prologue
//       (:232-248)                       -> dia_row / dia_row_const below
//   K1  _bicgstab_kernel (:281-374)      -> bicgstab_kernel
//   K2  _pcg_kernel (:201-278)           -> pcg_kernel
//   K3  _smooth_kernel (:377-456)        -> smooth_kernel
// The Python wrappers and the plain PyTorch twins are in
// firefoam_torch/solvers/dia_krylov.py and solvers/linear.py.
//
// Design: one thread block per batch row runs that row's whole solve —
// matvec, Jacobi preconditioner, block-wide reductions (warp shuffles plus
// shared memory) and the stop test — in one launch, the analogue of the
// Pallas grid-over-batch mode. The Krylov work vectors live in device
// scratch that the wrapper allocates; neighbours are read with bounds
// checks (c + o < nC, c >= o), not wrapped shifts.
//
// What bounds it: one iteration streams about 20 vectors of nC values
// (3 coefficient diagonals up and down, diag, the iterate vectors), so at
// 100k cells and K = 3 it is memory-bandwidth bound, and one block per row
// uses one SM of 132 — a B = 1 p_rgh solve leaves the rest of the card
// idle. The working set of a 100k-cell row (~8 MB in f64) sits in the
// 50 MB L2 between iterations. Filling the card for B = 1 (a grid-wide
// solve) is later work.
//
// Batch semantics: every row stops at its own rule and reports its own
// iteration count, as a jax.vmap over firefoam_tpu/solvers/linear.py does.
// The Pallas kernel instead keeps updating every row until the last one
// converges (pallas_cg.py:250-252, 334-335); the max over rows is taken by
// the caller after the launch.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxOffsets = 8;

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
// of the 100k-cell box fire reaches rhat·v = 0 exactly.
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

// K3: damped Jacobi smoother (linear.py:jacobi_smooth semantics), the
// smoothSolver role: rounds of `check_every` sweeps x ← x + ω(b − A·x)/d,
// each round followed by the L1 residual over the normFactor; a row goes on
// while res > stop, it < max_iter and the residual still drops by 1e-4
// relative (or it = 0). `it` counts sweeps, as in the Pallas kernel.
//
// A Jacobi sweep must read only the previous iterate, so the sweeps
// ping-pong between p.x and one scratch vector with a block barrier between
// them; updating in place would make it Gauss-Seidel, which is not the
// twin. The scratch also holds r = b − A·x0 for the prologue.
//
// What bounds it: a sweep reads d, b, 6 off-diagonal vectors and x and
// writes x — about 10 vectors of nC values — and the solves of the fire
// step take tens to hundreds of sweeps, so it is memory-bound; one block per
// row keeps it on one SM per row (latency-bound there, as K1 and K2 are).
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
  return p;
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
